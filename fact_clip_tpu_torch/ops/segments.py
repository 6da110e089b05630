"""Static-cap segment pooling for the TDU blocks, batched.

Counterpart of ``fact_clip_tpu/ops/segments.py:20-95`` (which works on one
video under ``jax.vmap``): segment ids are a cumulative sum of the
prediction-change mask, capped at ``s_max`` (frames past the cap merge into
the last slot), and pooling is a (T, S) one-hot assignment product.
"""

from __future__ import annotations

import torch


def segment_ids_from_pred(pred, mask, s_max: int):
    """pred (B, T) int, mask (B, T) bool (valid frames are a prefix).
    Returns (seg_id (B, T) int64 in [0, s_max), num_segs (B,) int64)."""
    B = pred.shape[0]
    first = torch.ones((B, 1), dtype=torch.bool, device=pred.device)
    prev_same = torch.cat([first, pred[:, 1:] == pred[:, :-1]], dim=1)
    prev_valid = torch.cat([~first, mask[:, :-1]], dim=1)
    change = ~prev_same & mask & prev_valid
    seg_id = torch.cumsum(change.long(), dim=1)
    last = (mask.sum(dim=1) - 1).clamp(min=0)
    num_segs = torch.where(mask.any(dim=1), seg_id.gather(1, last[:, None])[:, 0] + 1,
                           torch.zeros_like(last))
    return seg_id.clamp(max=s_max - 1), num_segs.clamp(max=s_max)


def assignment_matrix(seg_id, mask, s_max: int):
    """(B, T, S) one-hot frame -> segment assignment, zero rows at padded frames."""
    onehot = torch.nn.functional.one_hot(seg_id, s_max).to(torch.float32)
    return onehot * mask[..., None].to(torch.float32)


def segment_lengths(P):
    return P.sum(dim=1)


def pool_mean(P, frame_feature):
    """(B, T, H) -> (B, S, H) segment means; empty slots are zeros."""
    seg_sum = P.transpose(1, 2) @ frame_feature
    return seg_sum / segment_lengths(P).clamp(min=1.0)[..., None]


def segment_centers(P, s_max: int):
    """(B, S) center frame floor((start + end) / 2) of each segment; 0 when empty."""
    T = P.shape[1]
    t_idx = torch.arange(T, dtype=torch.float32, device=P.device)[None, :, None]
    occupied = P > 0
    starts = torch.where(occupied, t_idx, float(T + 1)).amin(dim=1)
    ends = torch.where(occupied, t_idx, -1.0).amax(dim=1)
    centers = torch.floor((starts + ends) / 2.0)
    centers = torch.where(segment_lengths(P) > 0, centers, torch.zeros_like(centers))
    return centers.long()
