"""K3: multi-head cross-attention of the action queries over the frame memory.

Replaces ``fact_clip_tpu/ops/pallas/mha_attn.py::mha_cross_attention``
(``_mha_fwd_impl``, Pallas kernel ``_mha_kernel``): per key tile the K and V
projections of the raw memory, then masked per-head softmax attention.  The
TPU kernel's lane-masked row expansion (``_expand_rows``) is a workaround for
the 128-lane vector unit; the H100 kernel (``csrc/flash_attn.cu``, shared
with K2's flash form) works per head with hd = E / H directly.

q (B, M, E) arrives projected (the q projection and the out projection stay
outside, as in the JAX caller); the result (B, M, E) holds the heads'
outputs side by side, before the out projection.  Keys at or past
``x_len[b]`` get the logit -1e9.
"""

from __future__ import annotations

import math

import torch

from .. import _build
from .pos import add_pos
from .x2y_attn import proj_attn

_NEG = -1e9


def mha_cross_attention_reference(q, x_in, x_pos, wk, bk, wv, bv, x_len, *, num_heads: int):
    """Plain PyTorch version (the math of the JAX ``_mha_reference``)."""
    B, X, _ = x_in.shape
    M, E = q.shape[1], wk.shape[1]
    H = num_heads
    hd = E // H
    k = (add_pos(x_in, x_pos) @ wk + bk).view(B, X, H, hd)
    v = (x_in @ wv + bv).view(B, X, H, hd)
    qh = q.view(B, M, H, hd) * (1.0 / math.sqrt(hd))
    logits = torch.einsum("bmhd,bxhd->bhmx", qh, k)
    valid = torch.arange(X, device=x_in.device)[None, None, None, :] < x_len[:, None, None, None]
    p = torch.softmax(logits.masked_fill(~valid, _NEG), dim=-1)
    return torch.einsum("bhmx,bxhd->bmhd", p, v).reshape(B, M, E)


def mha_cross_fwd(q, x_in, x_pos, wk, bk, wv, bv, x_len, *, num_heads: int, rate: float = 0.0):
    """The kernel on CUDA tensors, the plain version on CPU tensors."""
    _build.forward_only("mha_cross_fwd", [rate], [q, x_in, x_pos, wk, bk, wv, bv])
    if x_in.device.type == "cpu":
        return mha_cross_attention_reference(q, x_in, x_pos, wk, bk, wv, bv, x_len,
                                             num_heads=num_heads)
    B, X, Cx = x_in.shape
    M, E = q.shape[1], wk.shape[1]
    if (q.shape != (B, M, E) or E % num_heads or wk.shape != (Cx, E) or wv.shape != (Cx, E)
            or bk.shape != (E,) or bv.shape != (E,)):
        raise ValueError("mha_cross_fwd: inconsistent shapes")
    if x_len.dtype != torch.int32 or x_len.shape != (B,):
        raise ValueError("mha_cross_fwd: x_len must be (B,) int32")
    _build.check_tensors("mha_cross_fwd", [q, x_in, wk, bk, wv, bv, x_len], x_in.device)
    out = torch.empty((B, M, E), device=x_in.device, dtype=torch.float32)
    proj_attn(x_in, x_pos, q, wk, bk, wv, bv, x_len, num_heads=num_heads, out=out)
    mha_cross_fwd.launches += 1
    return out


mha_cross_fwd.launches = 0
