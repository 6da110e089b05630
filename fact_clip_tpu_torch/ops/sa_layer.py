"""K4: the post-norm self-attention and FFN sublayers of the token decoders.

Replaces ``fact_clip_tpu/ops/pallas/sa_layer.py::sa_sublayer`` (``_sa_fwd_impl``,
Pallas kernel ``_sa_fwd_kernel``) and ``ffn_sublayer`` (``_ffn_fwd_impl``,
``_ffn_fwd_kernel``) with ``csrc/sa_layer.cu``, one block per video:

* ``sa_sublayer``:  y = LN(x + MHA(x + pos, x + pos, x) @ Wo + bo)
* ``ffn_sublayer``: y = LN(x + relu(x @ W1 + b1) @ W2 + b2)

LayerNorm eps is 1e-6 (flax's default, ``sa_layer.py:47``).  Weights are
(in, out); ``pos`` is ONE table shared by the batch, (M, P) or (1, M, P)
with P <= E, added to the leading channels of the query/key input.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import _build
from .pos import add_pos, kernel_pos

LN_EPS = 1e-6


def sa_sublayer_reference(x, pos, wq, bq, wk, bk, wv, bv, wo, bo, ln_scale, ln_bias, *,
                          num_heads: int, eps: float = LN_EPS):
    B, M, E = x.shape
    H = num_heads
    hd = E // H
    a = add_pos(x, pos)
    q = (a @ wq + bq).view(B, M, H, hd)
    k = (a @ wk + bk).view(B, M, H, hd)
    v = (x @ wv + bv).view(B, M, H, hd)
    p = torch.softmax(torch.einsum("bmhd,bnhd->bhmn", q, k) * (1.0 / math.sqrt(hd)), dim=-1)
    o = torch.einsum("bhmn,bnhd->bmhd", p, v).reshape(B, M, E)
    return F.layer_norm(x + o @ wo + bo, (E,), ln_scale, ln_bias, eps)


def ffn_sublayer_reference(x, w1, b1, w2, b2, ln_scale, ln_bias, *, eps: float = LN_EPS):
    E = x.shape[-1]
    return F.layer_norm(x + torch.relu(x @ w1 + b1) @ w2 + b2, (E,), ln_scale, ln_bias, eps)


def sa_sublayer(x, pos, wq, bq, wk, bk, wv, bv, wo, bo, ln_scale, ln_bias, *,
                num_heads: int, eps: float = LN_EPS, rate_attn: float = 0.0, rate: float = 0.0):
    weights = [wq, bq, wk, bk, wv, bv, wo, bo, ln_scale, ln_bias]
    _build.forward_only("sa_sublayer", [rate_attn, rate], [x, pos, *weights])
    if x.device.type == "cpu":
        return sa_sublayer_reference(x, pos, *weights, num_heads=num_heads, eps=eps)
    B, M, E = x.shape
    if E % num_heads or any(w.shape != (E, E) for w in (wq, wk, wv, wo)) \
            or any(b.shape != (E,) for b in (bq, bk, bv, bo, ln_scale, ln_bias)):
        raise ValueError("sa_sublayer: inconsistent shapes")
    pos_t, pos_stride, Pp = kernel_pos(pos, B, M, E)
    if pos_stride:
        raise ValueError("sa_sublayer: pos must be one table shared by the batch")
    _build.check_tensors("sa_sublayer", [x, pos_t, *weights], x.device)
    scratch = torch.empty((B, 4, M, E), device=x.device, dtype=torch.float32)
    y = torch.empty_like(x)
    ptrs = [w.data_ptr() for w in weights]
    err = _build.lib().fk_sa_sublayer(
        x.data_ptr(), pos_t.data_ptr() if pos_t is not None else None, 0, Pp, *ptrs,
        scratch.data_ptr(), y.data_ptr(), B, M, E, num_heads, float(eps),
        _build.stream_ptr(x.device))
    _build.check("fk_sa_sublayer", err)
    sa_sublayer.launches += 1
    return y


sa_sublayer.launches = 0


def ffn_sublayer(x, w1, b1, w2, b2, ln_scale, ln_bias, *, eps: float = LN_EPS,
                 rate: float = 0.0):
    weights = [w1, b1, w2, b2, ln_scale, ln_bias]
    _build.forward_only("ffn_sublayer", [rate], [x, *weights])
    if x.device.type == "cpu":
        return ffn_sublayer_reference(x, *weights, eps=eps)
    B, M, E = x.shape
    Fd = w1.shape[1]
    if w1.shape != (E, Fd) or b1.shape != (Fd,) or w2.shape != (Fd, E) \
            or any(b.shape != (E,) for b in (b2, ln_scale, ln_bias)):
        raise ValueError("ffn_sublayer: inconsistent shapes")
    _build.check_tensors("ffn_sublayer", [x, *weights], x.device)
    scratch = torch.empty((B, M, Fd), device=x.device, dtype=torch.float32)
    y = torch.empty_like(x)
    err = _build.lib().fk_ffn_sublayer(
        x.data_ptr(), *[w.data_ptr() for w in weights], scratch.data_ptr(), y.data_ptr(),
        B, M, E, Fd, float(eps), _build.stream_ptr(x.device))
    _build.check("fk_ffn_sublayer", err)
    ffn_sublayer.launches += 1
    return y


ffn_sublayer.launches = 0
