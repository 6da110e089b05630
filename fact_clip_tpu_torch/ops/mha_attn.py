"""K3: multi-head cross-attention of the action queries over the frame memory,
forward with probability dropout, and its backward.

Replaces ``fact_clip_tpu/ops/pallas/mha_attn.py::mha_cross_attention``: the
forward ``_mha_fwd_impl`` (Pallas kernel ``_mha_kernel``), the backward
``_mha_bwd`` (``_mha_bwd_kernel``) and the mask replay ``mha_dropout_mask``.
Per key tile the K and V projections of the raw memory, then masked
per-head softmax attention.  The TPU kernels' lane-masked row expansion
(``_expand_rows``) is a workaround for the 128-lane vector unit; the H100
kernels work per head with hd = E / H directly: the forward is
``csrc/flash_attn.cu`` (shared with K2's flash form), the backward
``csrc/mha_bwd.cu`` + ``csrc/grad.cu``, the mask ``csrc/dropout.cu``.  What
bounds them and what the design does about it is written at the top of the
CUDA sources.

q (B, M, E) arrives projected (the q projection and the out projection stay
outside, as in the JAX caller); the result (B, M, E) holds the heads'
outputs side by side, before the out projection.  Keys at or past
``x_len[b]`` get the logit -1e9.  Dropout (torch semantics) multiplies the
probabilities in the attend sum only, the softmax normaliser sums the
undropped ones: out = dropout(softmax(logits)) @ V.  Its keep mask is the
counter hash of ``ops/dropout.py``, stream 0 over (B, H*M, X) with rows
h*M + m, from a (1,) int32 seed per call.  The TPU seeds per grid cell and so
ties its forward and backward to one key tile; this mask is keyed by the
logical index (b, h, m, x), so no tiling couples the two passes.

``mha_cross_attention`` is the differentiable entry.  The forward saves each
(video, head, query) row's softmax stats (max, sum), the backward recovers the
probabilities from them, as JAX's does; the key positional term is a
constant (JAX's ``pos_grad=False``), and the entry refuses one that wants a
gradient.
"""

from __future__ import annotations

import math

import torch

from .. import _build
from . import _grad
from .dropout import check_seed, dropout_args, dropout_mask_reference, launch_mask
from .pos import add_pos, kernel_pos
from .x2y_attn import key_tile, proj_attn

_NEG = -1e9
BWD_KEY_TILES = (64, 32)  # keys per block of csrc/mha_bwd.cu, the largest that fits


def mha_cross_attention_reference(q, x_in, x_pos, wk, bk, wv, bv, x_len, *, num_heads: int,
                                  keep=None, with_stats: bool = False):
    """Plain PyTorch version (the math of the JAX ``_mha_reference``; ``keep``
    the scaled (B, H*M, X) keep mask or None).  With ``with_stats`` also each
    row's softmax (max, sum), (B, H*M, 2)."""
    B, X, _ = x_in.shape
    M, E = q.shape[1], wk.shape[1]
    H = num_heads
    hd = E // H
    k = (add_pos(x_in, x_pos) @ wk + bk).view(B, X, H, hd)
    v = (x_in @ wv + bv).view(B, X, H, hd)
    qh = q.view(B, M, H, hd) * (1.0 / math.sqrt(hd))
    logits = torch.einsum("bmhd,bxhd->bhmx", qh, k)
    valid = torch.arange(X, device=x_in.device)[None, None, None, :] < x_len[:, None, None, None]
    logits = logits.masked_fill(~valid, _NEG)
    p = torch.softmax(logits, dim=-1)
    if keep is not None:
        p = p * keep.view(B, H, M, X)
    out = torch.einsum("bhmx,bxhd->bmhd", p, v).reshape(B, M, E)
    if not with_stats:
        return out
    m = logits.amax(dim=-1, keepdim=True)
    l = torch.exp(logits - m).sum(dim=-1, keepdim=True)
    return out, torch.cat([m, l], dim=-1).reshape(B, H * M, 2)


def mha_dropout_mask(seed, shape, rate: float):
    """K3's (B, H*M, X) keep mask (replaces ``mha_attn.py::mha_dropout_mask``):
    the mask kernel (CUDA) or its plain version (CPU)."""
    if seed.device.type == "cpu":
        return dropout_mask_reference(seed, 0, shape, rate)
    out = launch_mask(seed, 0, shape, rate)
    mha_dropout_mask.launches += 1
    return out


mha_dropout_mask.launches = 0


def _check(name, q, x_in, wk, bk, wv, bv, x_len, num_heads):
    B, X, Cx = x_in.shape
    M, E = q.shape[1], wk.shape[1]
    if (q.shape != (B, M, E) or E % num_heads or wk.shape != (Cx, E) or wv.shape != (Cx, E)
            or bk.shape != (E,) or bv.shape != (E,)):
        raise ValueError(f"{name}: inconsistent shapes")
    if x_len.dtype != torch.int32 or x_len.shape != (B,):
        raise ValueError(f"{name}: x_len must be (B,) int32")
    _build.check_tensors(name, [q, x_in, wk, bk, wv, bv, x_len], x_in.device)


def has_forward(M: int, E: int, num_heads: int) -> bool:
    """The forward kernel's block (GEMM staging, one tile's K/V buffer and
    its H*M rows of weights) fits in shared memory at some key tile."""
    return key_tile(M, E, num_heads) is not None


def mha_cross_fwd(q, x_in, x_pos, wk, bk, wv, bv, x_len, *, num_heads: int, rate: float = 0.0,
                  seed=None, with_stats: bool = False):
    """The forward kernel on CUDA tensors, the plain version on CPU tensors;
    with ``with_stats`` it returns (out, stats) for the backward.  A shape
    whose block does not fit is refused before any launch."""
    _build.no_grad_inputs("mha_cross_fwd", [q, x_in, x_pos, wk, bk, wv, bv])
    B, X, _ = x_in.shape
    M, E = q.shape[1], wk.shape[1]
    if rate > 0.0:
        check_seed("mha_cross_fwd", seed, x_in.device)
    if x_in.device.type == "cpu":
        keep = mha_dropout_mask(seed, (B, num_heads * M, X), rate) if rate > 0.0 else None
        return mha_cross_attention_reference(q, x_in, x_pos, wk, bk, wv, bv, x_len,
                                             num_heads=num_heads, keep=keep,
                                             with_stats=with_stats)
    _check("mha_cross_fwd", q, x_in, wk, bk, wv, bv, x_len, num_heads)
    if not has_forward(M, E, num_heads):
        raise NotImplementedError(f"mha_cross_fwd: no forward kernel for M={M}, E={E}, "
                                  f"H={num_heads} (shared memory)")
    out = torch.empty((B, M, E), device=x_in.device, dtype=torch.float32)
    stats = (torch.empty((B, num_heads * M, 2), device=x_in.device, dtype=torch.float32)
             if with_stats else None)
    proj_attn(x_in, x_pos, q, wk, bk, wv, bv, x_len, num_heads=num_heads, out=out, stats=stats,
              drop=dropout_args(seed, 0, rate))
    mha_cross_fwd.launches += 1
    return (out, stats) if with_stats else out


mha_cross_fwd.launches = 0


def _row_term(g, out, num_heads: int):
    """D = rowsum(g * out) per (video, head, query), (B, H*M): the softmax
    backward's row term, exact under dropout (``out`` is the dropped output)."""
    B, M, E = g.shape
    return (g * out).view(B, M, num_heads, E // num_heads).sum(-1).transpose(1, 2).reshape(B, -1)


def mha_cross_bwd_reference(q, x_in, x_pos, wk, bk, wv, bv, x_len, stats, out, g, *,
                            num_heads: int, keep=None):
    """Explicit plain backward from the forward's saves (the softmax stats and
    the output): the cotangents of (q, x_in, x_pos, wk, bk, wv, bv), with
    None for the constant x_pos."""
    B, X, _ = x_in.shape
    M, E = q.shape[1], wk.shape[1]
    H = num_heads
    hd = E // H
    scale = 1.0 / math.sqrt(hd)
    xk_in = add_pos(x_in, x_pos)
    k = (xk_in @ wk + bk).view(B, X, H, hd)
    v = (x_in @ wv + bv).view(B, X, H, hd)
    qh = q.view(B, M, H, hd)
    gh = g.view(B, M, H, hd)
    valid = torch.arange(X, device=x_in.device)[None, None, None, :] < x_len[:, None, None, None]
    logits = (torch.einsum("bmhd,bxhd->bhmx", qh, k) * scale).masked_fill(~valid, _NEG)
    st = stats.view(B, H, M, 2)
    p = torch.exp(logits - st[..., :1]) / st[..., 1:].clamp_min(1e-30)
    dp = torch.einsum("bmhd,bxhd->bhmx", gh, v)
    D = _row_term(g, out, H).view(B, H, M, 1)
    kp = keep.view(B, H, M, X) if keep is not None else None
    pk = p * kp if kp is not None else p
    dl = torch.where(valid, p * ((dp * kp if kp is not None else dp) - D), 0.0) * scale
    dq = torch.einsum("bhmx,bxhd->bmhd", dl, k).reshape(B, M, E)
    dk = torch.einsum("bhmx,bmhd->bxhd", dl, qh).reshape(B, X, E)
    dv = torch.einsum("bhmx,bmhd->bxhd", pk, gh).reshape(B, X, E)
    return (dq, dk @ wk.t() + dv @ wv.t(), None, torch.einsum("bxc,bxe->ce", xk_in, dk),
            dk.sum(dim=(0, 1)), torch.einsum("bxc,bxe->ce", x_in, dv), dv.sum(dim=(0, 1)))


def bwd_key_tile(M: int, E: int, num_heads: int):
    """The key tile of the backward kernel: the largest of ``BWD_KEY_TILES``
    whose block (GEMM staging, the tile's K and V, one head's q and g rows and
    two (M, BK) panels) fits in shared memory, or None."""
    hd = E // num_heads
    for bk in BWD_KEY_TILES:
        floats = 2 * bk * (E + 1) + 2 * M * (hd + 1) + 2 * M * bk
        if _build.gemm_smem(bk) + 4 * floats <= _build.MAX_SMEM:
            return bk
    return None


def has_backward(M: int, E: int, num_heads: int) -> bool:
    return bwd_key_tile(M, E, num_heads) is not None


def mha_cross_bwd(q, x_in, x_pos, wk, bk, wv, bv, x_len, stats, out, g, *, num_heads: int,
                  keep=None):
    """The backward on the card (CUDA tensors) or its plain version (CPU),
    from the forward's saves; ``keep`` is the layer's regenerated mask."""
    if x_in.device.type == "cpu":
        return mha_cross_bwd_reference(q, x_in, x_pos, wk, bk, wv, bv, x_len, stats, out, g,
                                       num_heads=num_heads, keep=keep)
    B, X, Cx = x_in.shape
    M, E = q.shape[1], wk.shape[1]
    H = num_heads
    _check("mha_cross_bwd", q, x_in, wk, bk, wv, bv, x_len, H)
    tile = bwd_key_tile(M, E, H)
    if tile is None:
        raise NotImplementedError(f"mha_cross_bwd: no backward kernel for M={M}, E={E}")
    g = g.contiguous()
    xpos, pos_stride, Px = kernel_pos(x_pos, B, X, Cx)
    _build.check_tensors("mha_cross_bwd", [xpos, stats, out, g, keep], x_in.device)
    D = _row_term(g, out, H).contiguous()
    wkvt = torch.cat([wk.t(), wv.t()], dim=0).contiguous()
    n_t = -(-X // tile)
    f32 = dict(device=x_in.device, dtype=torch.float32)
    dk, dv = torch.empty((B, X, E), **f32), torch.empty((B, X, E), **f32)
    dx = torch.empty_like(x_in)
    part_dq = torch.empty((B, n_t, M, E), **f32)
    part_b = torch.empty((B * n_t, 2, E), **f32)
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    err = _build.lib().fk_mha_bwd(
        x_in.data_ptr(), ptr(xpos), pos_stride, Px, q.data_ptr(), g.data_ptr(), stats.data_ptr(),
        D.data_ptr(), ptr(keep), wk.data_ptr(), bk.data_ptr(), wv.data_ptr(), bv.data_ptr(),
        wkvt.data_ptr(), x_len.data_ptr(), dk.data_ptr(), dv.data_ptr(), dx.data_ptr(),
        part_dq.data_ptr(), part_b.data_ptr(), B, X, Cx, M, H, E // H, 1.0 / math.sqrt(E // H),
        tile, _build.stream_ptr(x_in.device))
    _build.check("fk_mha_bwd", err)
    ME = M * E
    dq = _grad.reduce(part_dq, G=B, P=n_t, pstride=ME, gstride=n_t * ME, rows=1, rstride=0,
                      cols=ME).view(B, M, E)
    d_wk = _grad.atb(x_in, dk, pos=xpos)[0]
    d_wv = _grad.atb(x_in, dv)[0]
    d_bk, d_bv = _grad.block_sums(part_b, 2, E)
    mha_cross_bwd.launches += 1
    return dq, dx, None, d_wk, d_bk, d_wv, d_bv


mha_cross_bwd.launches = 0


class _MHA(torch.autograd.Function):
    """K3 with the kernels' forward and backward on the card, the plain ones
    on the CPU; the forward saves its output and softmax stats."""

    @staticmethod
    def forward(ctx, q, x_in, x_pos, wk, bk, wv, bv, x_len, seed, cfg):
        num_heads, rate = cfg
        out, stats = mha_cross_fwd(q, x_in, x_pos, wk, bk, wv, bv, x_len, num_heads=num_heads,
                                   rate=rate, seed=seed, with_stats=True)
        ctx.cfg = cfg
        ctx.save_for_backward(q, x_in, x_pos, wk, bk, wv, bv, x_len, seed, stats, out)
        return out

    @staticmethod
    def backward(ctx, g):
        num_heads, rate = ctx.cfg
        q, x_in, x_pos, wk, bk, wv, bv, x_len, seed, stats, out = ctx.saved_tensors
        B, M = q.shape[:2]
        # the layer's keep mask, regenerated by the mask kernel (never stored)
        keep = (mha_dropout_mask(seed, (B, num_heads * M, x_in.shape[1]), rate)
                if rate > 0.0 else None)
        grads = mha_cross_bwd(q, x_in, x_pos, wk, bk, wv, bv, x_len, stats, out, g.contiguous(),
                              num_heads=num_heads, keep=keep)
        return (*grads, None, None, None)


def mha_cross_attention(q, x_in, x_pos, wk, bk, wv, bv, x_len, *, num_heads: int,
                        rate: float = 0.0, seed=None):
    """The K3 entry: the kernels on CUDA tensors, the plain versions on CPU
    ones; differentiable in every input but ``x_pos`` (a constant) and
    ``x_len``.  ``seed``: a (1,) int32 tensor on the device when rate > 0."""
    grad = torch.is_grad_enabled()
    if grad and x_pos is not None and x_pos.requires_grad:
        raise NotImplementedError("mha_cross_attention: the key positional term is a constant "
                                  "(no gradient), as JAX's pos_grad=False")
    args = (q.contiguous(), x_in.contiguous(), x_pos, wk, bk, wv, bv, x_len)
    if not (grad and any(t.requires_grad for t in (q, x_in, wk, bk, wv, bv))):
        return mha_cross_fwd(*args, num_heads=num_heads, rate=rate, seed=seed)
    if x_in.device.type != "cpu":
        _build.require_backward("mha_cross_attention", has_backward(q.shape[1], wk.shape[1],
                                                                    num_heads))
    return _MHA.apply(*args, seed, (int(num_heads), float(rate)))
