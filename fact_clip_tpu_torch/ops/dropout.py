"""The counter-hash dropout mask shared by every kernel that drops out.

The TPU kernels draw their keep bits from the on-core PRNG, seeded per grid
cell (``fact_clip_tpu/ops/pallas/dilated_conv.py::_keep_mask`` and
``_seed_cell``; ``mha_attn.py:104``, ``sa_layer.py:138``), so each mask
depends on the kernel's tiling and a mask replay must use the same tiles
(``mha_attn.py::_pick_tile``).  The H100 has no such PRNG.  Here the keep bit
of element ``i`` of a mask of any shape, flattened row-major, is
``fmix32(i * 0x9E3779B9 ^ fmix32(seed + stream * 0x85EBCA77)) < (1 - rate) *
2^32`` (murmur3's finalizer, uint32 wraparound), and kept values are scaled
by 1 / (1 - rate).  The mask is a function of (seed, stream, logical index)
alone: no tiling couples the forward kernels that apply it to the backward
that needs it again.

``csrc/common.cuh::dropout_bits`` is the kernels' form, ``dropout_mask_reference``
the plain one (int64 torch ops, bit-equal); ``csrc/dropout.cu`` writes a whole
mask.  Its users key their masks as the JAX package draws them:

* K1 (``dilated_conv.py``): stream = layer index, shape (B, T, C), a seed per layer;
* K3 (``mha_attn.py``): stream 0, shape (B, H*M, X), rows h*M + m, a seed per call;
* K4 SA (``sa_layer.py``): stream 0 for the probabilities (B, H*M, M), stream
  1 for the output (B, M, E), one seed per call;
* K4 FFN: stream 0 for the hidden rows (B, M, F), stream 1 for the output
  (B, M, E), its own seed.

Seeds are (1,) int32 tensors on the device, drawn from the step's generator,
so no host synchronisation is needed to launch a kernel that drops out.
"""

from __future__ import annotations

import torch

from .. import _build

_M32 = 0xFFFFFFFF


def _mul32(a, b: int):
    """(a * b) mod 2^32 for int64 tensors a in [0, 2^32) without overflow."""
    return ((a & 0xFFFF) * b + ((((a >> 16) * b) & 0xFFFF) << 16)) & _M32


def _fmix32(h):
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def keep_threshold(rate: float) -> int:
    """Keep where bits < (1 - rate) * 2^32, as the TPU kernel's _keep_mask."""
    return min(int((1.0 - rate) * 2.0 ** 32), 2 ** 32 - 1)


def dropout_mask_reference(seed, stream: int, shape, rate: float):
    """Plain version of the keep mask: float32 of ``shape``, 1/(1-rate) where
    kept and 0 where dropped; bit-equal to the kernels'."""
    n = 1
    for s in shape:
        n *= int(s)
    s = seed.reshape(-1)[:1].to(torch.int64) & _M32
    key = _fmix32((s + ((int(stream) * 0x85EBCA77) & _M32)) & _M32)
    idx = torch.arange(n, device=seed.device, dtype=torch.int64) & _M32
    bits = _fmix32(_mul32(idx, 0x9E3779B9) ^ key)
    scale = torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32, device=seed.device)
    return torch.where(bits < keep_threshold(rate), scale, 0.0).view(*shape)


def dropout_args(seed, stream: int, rate: float):
    """(seed pointer, stream, threshold, scale) of a kernel's in-kernel dropout;
    a null seed pointer turns it off."""
    if rate <= 0.0:
        return None, 0, 0, 1.0
    return seed.data_ptr(), int(stream), keep_threshold(rate), 1.0 / (1.0 - rate)


def check_seed(name: str, seed, device) -> None:
    if seed is None or seed.dtype != torch.int32 or seed.numel() != 1 or seed.device != device:
        raise ValueError(f"{name}: dropout needs a (1,) int32 seed on {device}")


def launch_mask(seed, stream: int, shape, rate: float):
    """The keep mask written by ``csrc/dropout.cu`` (CUDA seed): the callers
    count their launches."""
    if seed.dtype != torch.int32:
        raise ValueError("dropout mask: the seed must be int32")
    out = torch.empty(tuple(int(s) for s in shape), device=seed.device, dtype=torch.float32)
    err = _build.lib().fk_dropout_mask(seed.data_ptr(), int(stream), keep_threshold(rate),
                                       1.0 / (1.0 - rate), out.data_ptr(), out.numel(),
                                       _build.stream_ptr(seed.device))
    _build.check("fk_dropout_mask", err)
    return out
