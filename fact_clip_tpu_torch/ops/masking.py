"""Training-time masking augmentations.

Counterpart of ``fact_clip_tpu/ops/masking.py``: ``time_mask`` zeroes random
temporal spans (the reference's SpecAugment-style mask), ``channel_mask``
zeroes whole feature channels per video (torch Dropout2d).  Every draw comes
from the explicit ``torch.Generator`` passed in, on the feature's device; the
draws differ from JAX's, so tests hold the two to their properties.
"""

from __future__ import annotations

import torch


def time_mask(generator: torch.Generator, feature, lengths, t_max: int, num_masks: int,
              p: float):
    """Zero ``num_masks`` random temporal spans per video.

    feature: (B, T, H); lengths: (B,) valid frame counts.  Span length
    ~ U{0, t_max-1} clamped to floor(p * length); start uniform in
    [0, length - span]."""
    B, T, _ = feature.shape
    dev = feature.device
    t_idx = torch.arange(T, device=dev)[None, :]
    lengths = lengths.to(device=dev, dtype=torch.int64)
    keep = torch.ones((B, T), dtype=feature.dtype, device=dev)
    for _ in range(num_masks):
        t = torch.randint(0, max(t_max, 1), (B,), generator=generator, device=dev)
        t = torch.minimum((p * lengths).to(torch.int64), t)
        hi = torch.clamp(lengths - t, min=1)
        t_zero = (torch.rand((B,), generator=generator, device=dev) * hi).to(torch.int64)
        span = (t_idx >= t_zero[:, None]) & (t_idx < (t_zero + t)[:, None])
        keep = keep * (1.0 - span.to(feature.dtype))
    return feature * keep[:, :, None]


def channel_mask(generator: torch.Generator, feature, rate: float):
    """Zero whole channels per video with probability ``rate``; survivors
    are scaled by 1/(1-rate)."""
    if rate <= 0.0:
        return feature
    B, _, H = feature.shape
    keep = torch.rand((B, 1, H), generator=generator, device=feature.device) < (1.0 - rate)
    return feature * keep.to(feature.dtype) / (1.0 - rate)


def dropout(generator: torch.Generator, x, rate: float):
    """Inverted dropout (flax ``nn.Dropout``) with an explicit generator."""
    if rate <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < (1.0 - rate)
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))
