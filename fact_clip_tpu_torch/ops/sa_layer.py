"""K4: the post-norm self-attention and FFN sublayers of the token decoders,
forward with dropout and backward.

Replaces ``fact_clip_tpu/ops/pallas/sa_layer.py``: ``sa_sublayer``
(``_sa_fwd_impl`` / ``_sa_fwd_kernel``, backward ``_sa_bwd`` /
``_sa_bwd_kernel``), ``ffn_sublayer`` (``_ffn_fwd_impl`` / ``_ffn_fwd_kernel``,
``_ffn_bwd`` / ``_ffn_bwd_kernel``) and the mask replays ``sa_dropout_masks``
and ``ffn_dropout_masks``, with ``csrc/sa_layer.cu`` (the SA forward over
(row tile, video) and (query tile, head, video) blocks at any token count of
the zoo, its backward one library call over the batch's rows as one row
space on ``csrc/mstcn2.cu``'s 3xTF32 GEMM and weight products, the FFN
forward and backward over (32-row tile, column chunk, K slice) blocks of the
batch's rows) and ``csrc/dropout.cu``:

* ``sa_sublayer``:  y = LN(x + drop(MHA(x + pos, x + pos, x) @ Wo + bo)), the
  attention probabilities dropped at ``rate_attn``;
* ``ffn_sublayer``: y = LN(x + drop(drop(relu(x @ W1 + b1)) @ W2 + b2)).

LayerNorm eps is 1e-6 (flax's default, ``sa_layer.py:47``).  Weights are
(in, out); ``pos`` is ONE table shared by the batch, (M, P) or (1, M, P)
with P <= E, added to the leading channels of the query/key input; its
gradient is summed over the videos and shaped like ``pos``.  Dropout masks
are the counter hash of ``ops/dropout.py`` from a (1,) int32 seed per call:
SA stream 0 over (B, H*M, M) for the probabilities and stream 1 over
(B, M, E) for the output; FFN (its own seed) stream 0 over (B, M, F) for the
hidden rows and stream 1 over (B, M, E) for the output.  ``sa_sublayer`` and
``ffn_sublayer`` are the differentiable entries; ``*_fwd`` and ``*_bwd`` are
the kernels' wrappers beside their plain versions.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from .. import _build
from . import _grad
from .bf16 import BF16, mm, rnd
from .dropout import check_seed, dropout_args, dropout_mask_reference, launch_mask
from .pos import add_pos, kernel_pos, pos_grad

LN_EPS = 1e-6


def sa_sublayer_reference(x, pos, wq, bq, wk, bk, wv, bv, wo, bo, ln_scale, ln_bias, *,
                          num_heads: int, eps: float = LN_EPS, keep_attn=None, keep_out=None):
    B, M, E = x.shape
    H = num_heads
    hd = E // H
    a = add_pos(x, pos)
    q = (a @ wq + bq).view(B, M, H, hd)
    k = (a @ wk + bk).view(B, M, H, hd)
    v = (x @ wv + bv).view(B, M, H, hd)
    p = torch.softmax(torch.einsum("bmhd,bnhd->bhmn", q, k) * (1.0 / math.sqrt(hd)), dim=-1)
    if keep_attn is not None:
        p = p * keep_attn.view(B, H, M, M)
    o = torch.einsum("bhmn,bnhd->bmhd", p, v).reshape(B, M, E) @ wo + bo
    if keep_out is not None:
        o = o * keep_out
    return F.layer_norm(x + o, (E,), ln_scale, ln_bias, eps)


def ffn_sublayer_reference(x, w1, b1, w2, b2, ln_scale, ln_bias, *, eps: float = LN_EPS,
                           keep_hidden=None, keep_out=None):
    E = x.shape[-1]
    h = torch.relu(x @ w1 + b1)
    if keep_hidden is not None:
        h = h * keep_hidden
    o = h @ w2 + b2
    if keep_out is not None:
        o = o * keep_out
    return F.layer_norm(x + o, (E,), ln_scale, ln_bias, eps)


def _masks(fn, seed, shapes_rates):
    """The keep masks of one sublayer call, stream i for entry i (None where
    its rate is 0): the mask kernel (CUDA) or its plain version (CPU)."""
    out = []
    for stream, (shape, rate) in enumerate(shapes_rates):
        if rate <= 0.0:
            out.append(None)
        elif seed.device.type == "cpu":
            out.append(dropout_mask_reference(seed, stream, shape, rate))
        else:
            out.append(launch_mask(seed, stream, shape, rate))
            fn.launches += 1
    return tuple(out)


def sa_dropout_masks(seed, B: int, M: int, E: int, H: int, rate_attn: float, rate: float):
    """(keep_attn (B, H*M, M), keep_out (B, M, E)) of an SA call, as its
    forward kernel draws them (replaces ``sa_layer.py::sa_dropout_masks``).
    The backward's kernels hash the same bits, so the training path on the
    card makes no such mask; the CPU's plain backward takes it."""
    return _masks(sa_dropout_masks, seed, [((B, H * M, M), rate_attn), ((B, M, E), rate)])


sa_dropout_masks.launches = 0


def ffn_dropout_masks(seed, B: int, M: int, E: int, Fd: int, rate: float):
    """(keep_hidden (B, M, Fd), keep_out (B, M, E)) of an FFN call, as its
    forward kernels draw them (replaces ``sa_layer.py::ffn_dropout_masks``).
    The backward's kernels hash the same bits, so the training path on the
    card makes no such mask; the CPU's plain backward takes it."""
    return _masks(ffn_dropout_masks, seed, [((B, M, Fd), rate), ((B, M, E), rate)])


ffn_dropout_masks.launches = 0


def _check_sa(name, x, pos, wq, bq, wk, bk, wv, bv, wo, bo, ln_scale, ln_bias, num_heads,
              more=()):
    B, M, E = x.shape
    if E % num_heads or any(w.shape != (E, E) for w in (wq, wk, wv, wo)) \
            or any(b.shape != (E,) for b in (bq, bk, bv, bo, ln_scale, ln_bias)):
        raise ValueError(f"{name}: inconsistent shapes")
    pos_t, pos_stride, Pp = kernel_pos(pos, B, M, E)
    if pos_stride:
        raise ValueError(f"{name}: pos must be one table shared by the batch")
    _build.check_tensors(name, [x, pos_t, wq, bq, wk, bk, wv, bv, wo, bo, ln_scale, ln_bias,
                                *more], x.device)
    return pos_t, Pp


def _ptr(t):
    return t.data_ptr() if t is not None else None


def has_forward(M: int, E: int, num_heads: int) -> bool:
    """The SA forward's attention block (one head's k and v rows of every
    key, a 32-query tile, an M-long row per warp: ``sa_bwd_smem``, the
    backward's context kernel) fits in shared memory: up to M = 756 at
    hd = 32, at any head width."""
    return sa_bwd_smem(M, E, num_heads) <= _build.MAX_SMEM


def sa_sublayer_fwd(x, pos, wq, bq, wk, bk, wv, bv, wo, bo, ln_scale, ln_bias, *,
                    num_heads: int, eps: float = LN_EPS, rate_attn: float = 0.0,
                    rate: float = 0.0, seed=None):
    """The forward kernels on CUDA tensors, the plain version on CPU tensors."""
    weights = [wq, bq, wk, bk, wv, bv, wo, bo, ln_scale, ln_bias]
    _build.no_grad_inputs("sa_sublayer_fwd", [x, pos, *weights])
    if rate_attn > 0.0 or rate > 0.0:
        check_seed("sa_sublayer_fwd", seed, x.device)
    B, M, E = x.shape
    if x.device.type == "cpu":
        keep_attn, keep_out = sa_dropout_masks(seed, B, M, E, num_heads, rate_attn, rate)
        return sa_sublayer_reference(x, pos, *weights, num_heads=num_heads, eps=eps,
                                     keep_attn=keep_attn, keep_out=keep_out)
    y = _sa_fwd_card(x, pos, *weights, num_heads, eps, rate_attn, rate, seed)
    sa_sublayer_fwd.launches += 1
    return y


sa_sublayer_fwd.launches = 0


def _sa_fwd_card(x, pos, wq, bq, wk, bk, wv, bv, wo, bo, ln_scale, ln_bias, num_heads, eps,
                 rate_attn, rate, seed):
    """``sa_sublayer_fwd``'s launches (CPU tensors reach it only in the
    tests, which stand a model of the kernels' C interface in for the
    library): q, k and v per (32-row tile, video, projection) on the f32
    GEMM core (one launch: the towers' 3xTF32 GEMM, which needs packed
    weights and a positional-table GEMM a call, measured slower here,
    PERF.md §6), then the attention per (32-query tile, head, video) and the
    out projection with its dropout, the residual and the LayerNorm per
    32-row tile."""
    B, M, E = x.shape
    weights = [wq, bq, wk, bk, wv, bv, wo, bo, ln_scale, ln_bias]
    pos_t, Pp = _check_sa("sa_sublayer_fwd", x, pos, *weights, num_heads)
    if not has_forward(M, E, num_heads):
        raise NotImplementedError(f"sa_sublayer_fwd: no forward kernel for M={M}, E={E}, "
                                  f"H={num_heads} (its attention block needs "
                                  f"{sa_bwd_smem(M, E, num_heads)} bytes of shared memory, "
                                  f"{_build.MAX_SMEM} at most)")
    qkv = torch.empty((B, 3, M, E), device=x.device, dtype=torch.float32)
    err = _build.lib().fk_sa_qkv(x.data_ptr(), _ptr(pos_t), Pp, wq.data_ptr(), bq.data_ptr(),
                                 wk.data_ptr(), bk.data_ptr(), wv.data_ptr(), bv.data_ptr(),
                                 qkv.data_ptr(), B, M, E, _build.stream_ptr(x.device))
    _build.check("fk_sa_qkv", err)
    c = torch.empty_like(x)
    y = torch.empty_like(x)
    err = _build.lib().fk_sa_attn_out(
        qkv.data_ptr(), 3 * M * E, E, M * E, 2 * M * E, x.data_ptr(), wo.data_ptr(),
        bo.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(), c.data_ptr(), y.data_ptr(), B, M,
        E, num_heads, float(eps),
        *dropout_args(seed, 0, rate_attn), *dropout_args(seed, 1, rate),
        _build.stream_ptr(x.device))
    _build.check("fk_sa_attn_out", err)
    return y


def _ln_backward(res, g, ln_scale, eps):
    """(dres, dgamma, dbeta) of y = LN(res) * ln_scale + ln_bias."""
    mean = res.mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(((res - mean) ** 2).mean(dim=-1, keepdim=True) + eps)
    xhat = (res - mean) * rstd
    gg = g * ln_scale
    dres = (gg - gg.mean(dim=-1, keepdim=True)
            - xhat * (gg * xhat).mean(dim=-1, keepdim=True)) * rstd
    return dres, (g * xhat).sum(dim=(0, 1)), g.sum(dim=(0, 1))


def sa_sublayer_bwd_reference(x, pos, wq, bq, wk, bk, wv, bv, wo, bo, ln_scale, ln_bias, g, *,
                              num_heads: int, eps: float = LN_EPS, keep_attn=None, keep_out=None):
    """Explicit plain backward, recomputing the forward from x and pos with the
    call's masks, step for step as the kernel: the cotangents of (x, pos, wq,
    bq, wk, bk, wv, bv, wo, bo, ln_scale, ln_bias)."""
    B, M, E = x.shape
    H = num_heads
    hd = E // H
    scale = 1.0 / math.sqrt(hd)
    a = add_pos(x, pos)
    q = (a @ wq + bq).view(B, M, H, hd)
    k = (a @ wk + bk).view(B, M, H, hd)
    v = (x @ wv + bv).view(B, M, H, hd)
    p = torch.softmax(torch.einsum("bmhd,bnhd->bhmn", q, k) * scale, dim=-1)
    ka = keep_attn.view(B, H, M, M) if keep_attn is not None else None
    pd = p * ka if ka is not None else p
    c = torch.einsum("bhmn,bnhd->bmhd", pd, v).reshape(B, M, E)
    o = c @ wo + bo
    res = x + (o * keep_out if keep_out is not None else o)
    dres, dgamma, dbeta = _ln_backward(res, g, ln_scale, eps)
    dout = dres * keep_out if keep_out is not None else dres
    dc = (dout @ wo.t()).view(B, M, H, hd)
    dpd = torch.einsum("bmhd,bnhd->bhmn", dc, v)
    dv = torch.einsum("bhmn,bmhd->bnhd", pd, dc).reshape(B, M, E)
    dp = dpd * ka if ka is not None else dpd
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True)) * scale
    dq = torch.einsum("bhmn,bnhd->bmhd", ds, k).reshape(B, M, E)
    dk = torch.einsum("bhmn,bmhd->bnhd", ds, q).reshape(B, M, E)
    dxa = dq @ wq.t() + dk @ wk.t()
    wgrad = lambda A, Bm: torch.einsum("bmc,bme->ce", A, Bm)  # noqa: E731
    return (dres + dxa + dv @ wv.t(), pos_grad(dxa, pos), wgrad(a, dq), dq.sum(dim=(0, 1)),
            wgrad(a, dk), dk.sum(dim=(0, 1)), wgrad(x, dv), dv.sum(dim=(0, 1)), wgrad(c, dout),
            dout.sum(dim=(0, 1)), dgamma, dbeta)


# csrc/sa_layer.cu's attention tiling; change them together with the kernels
SA_TILE = 32  # query rows or keys of an attention block (QT)
SA_WARPS = 8  # warps of a block (fk::kWarps)


def sa_bwd_smem(M: int, E: int, num_heads: int) -> int:
    """Bytes of the SA forward's attention block (its context kernel): one
    head's rows of every key (k, v), the tile's two (``SA_TILE``, hd + 1)
    panels, and per warp one M-long row.  The backward's blocks, which hold
    one of k and v at a time, take fewer at every head width of 23 or more
    (``sa_bwd_rows_smem``)."""
    ldh = E // num_heads + 1
    return 4 * (2 * M * ldh + 2 * SA_TILE * ldh + SA_WARPS * M)


def sa_bwd_rows_smem(M: int, E: int, num_heads: int) -> int:
    """Bytes of the SA backward's blocks over query tiles
    (``csrc/sa_layer.cu::sa_bwd_rows_smem_floats``): one head's rows of
    one (M, E) panel (odd row stride), the tile's rows by dimension and a
    float4 of four rows' values a key."""
    hd = E // num_heads
    return 4 * (-(-M * (hd + 1) // 4) * 4 + SA_TILE * hd + SA_TILE * M)


def has_backward(M: int, E: int, num_heads: int) -> bool:
    """The SA backward takes the shape: the forward's attention block fits
    in shared memory (97,248 bytes at epic's M=300, E=256, H=8; up to M =
    756 at hd = 32 and M = 390 at hd = 64) and so do the backward's (fewer
    bytes but at narrow heads), a head is at most 64 wide and both E
    and the head width are multiples of 4 (the key-tile kernel's four
    dimensions a thread, the GEMMs' 16-byte rows), and the LayerNorm
    step's 16-row tile of res and g fits (E up to 1,816)."""
    hd = E // num_heads
    return (E % num_heads == 0 and hd <= 64 and hd % 4 == 0 and E % 4 == 0
            and max(sa_bwd_smem(M, E, num_heads), sa_bwd_rows_smem(M, E, num_heads))
            <= _build.MAX_SMEM and 2 * 16 * 4 * E <= _build.MAX_SMEM)


def sa_sublayer_bwd(x, pos, wq, bq, wk, bk, wv, bv, wo, bo, ln_scale, ln_bias, g, *,
                    num_heads: int, eps: float = LN_EPS, keep_attn=None, keep_out=None,
                    seed=None, rate_attn: float = 0.0, rate: float = 0.0):
    """The SA backward on the card (CUDA tensors) or its plain version (CPU).
    Its dropout: the forward's, from ``seed`` at ``rate_attn`` and ``rate``
    (the card's kernels hash the keep values inline, the plain version takes
    ``sa_dropout_masks``), or, where given, the replayed masks ``keep_attn``
    and ``keep_out`` (then ``seed`` is not read)."""
    weights = [wq, bq, wk, bk, wv, bv, wo, bo, ln_scale, ln_bias]
    B, M, E = x.shape
    hashed = keep_attn is None and keep_out is None and (rate_attn > 0.0 or rate > 0.0)
    if hashed:
        check_seed("sa_sublayer_bwd", seed, x.device)
    if x.device.type == "cpu":
        if hashed:
            keep_attn, keep_out = sa_dropout_masks(seed, B, M, E, num_heads, rate_attn, rate)
        return sa_sublayer_bwd_reference(x, pos, *weights, g, num_heads=num_heads, eps=eps,
                                         keep_attn=keep_attn, keep_out=keep_out)
    grads = _sa_bwd_card(x, pos, *weights, g, num_heads, eps, keep_attn, keep_out,
                         seed if hashed else None, rate_attn, rate)
    sa_sublayer_bwd.launches += 1
    return grads


def _aligned(t):
    """``t`` contiguous on 16 bytes: the backward kernels read its rows four
    floats at a time."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


_SCRATCH = {}  # (device, stream) -> the SA backward's workspace, the largest asked for


def _scratch(n: int, device, stream: int):
    """A workspace of at least n floats kept for one stream of one device:
    the calls on a stream run in its order, so each reuses the one before's
    (a fresh torch.empty a call costs host time; the results never live
    here).  Calls that share a stream from two threads at once would share
    it too; the port makes none."""
    ws = _SCRATCH.get((device, stream))
    if ws is None or ws.numel() < n:
        ws = _SCRATCH[(device, stream)] = torch.empty(n, device=device, dtype=torch.float32)
    return ws


def _sa_bwd_card(x, pos, wq, bq, wk, bk, wv, bv, wo, bo, ln_scale, ln_bias, g, num_heads, eps,
                 keep_attn, keep_out, seed, rate_attn, rate):
    """``sa_sublayer_bwd``'s launches (CPU tensors reach it only in the
    tests, which stand a model of the kernels' C interface in for the
    library): one library call, ``fk_sa_bwd``, through a workspace (kept
    for the stream, ``_scratch``) into a buffer of results, both laid out
    by the library (``fk_sa_bwd_workspace``), every result a view of the
    latter.  The keep values are read from ``keep_attn`` / ``keep_out``
    where given, else hashed from ``seed`` (None: no dropout)."""
    B, M, E = x.shape
    x, g = _aligned(x), _aligned(g)
    pos_t, Pp = _check_sa("sa_sublayer_bwd", x, pos, wq, bq, wk, bk, wv, bv, wo, bo, ln_scale,
                          ln_bias, num_heads, (g, keep_attn, keep_out))
    if not has_backward(M, E, num_heads):
        raise NotImplementedError(f"sa_sublayer_bwd: no backward kernel for M={M}, E={E}, "
                                  f"H={num_heads}")
    drops = ((*dropout_args(seed, 0, rate_attn), *dropout_args(seed, 1, rate)) if seed is not None
             else (None, 0, 0, 1.0) * 2)
    lib = _build.lib()
    # (workspace floats, result floats, then in the results: dx, d(pos), dWq
    # dWk dWv dWo and dbq dbk dbv dbo dgamma dbeta)
    n_ws, n_out, o_dx, o_pos, o_dw = _build.workspace(lib, "fk_sa_bwd_workspace", 5, B, M, E,
                                                      num_heads, Pp)
    stream = _build.stream_ptr(x.device)
    ws = _scratch(n_ws, x.device, stream)
    out = torch.empty(n_out, device=x.device, dtype=torch.float32)
    err = lib.fk_sa_bwd(
        x.data_ptr(), _ptr(pos_t), Pp, wq.data_ptr(), bq.data_ptr(), wk.data_ptr(), bk.data_ptr(),
        wv.data_ptr(), bv.data_ptr(), wo.data_ptr(), bo.data_ptr(), ln_scale.data_ptr(),
        _ptr(keep_attn), _ptr(keep_out), g.data_ptr(), ws.data_ptr(), out.data_ptr(), B, M, E,
        num_heads, float(eps), *drops, stream)
    _build.check("fk_sa_bwd", err)
    # a few views, unbound: on the card's host each tensor op costs microseconds
    dwq, dwk, dwv, dwo = out.as_strided((4, E, E), (E * E, E, 1), o_dw).unbind(0)
    dbq, dbk, dbv, dbo, dgamma, dbeta = out.as_strided((6, E), (E, 1), o_dw + 4 * E * E).unbind(0)
    dpos = (out.as_strided(pos.shape, (M * Pp, Pp, 1)[-pos.dim():], o_pos) if pos is not None
            else None)
    return (out.as_strided((B, M, E), (M * E, E, 1), o_dx), dpos, dwq, dbq, dwk, dbk, dwv, dbv,
            dwo, dbo, dgamma, dbeta)


sa_sublayer_bwd.launches = 0


class _SA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pos, seed, cfg, *weights):
        num_heads, eps, rate_attn, rate = cfg
        y = sa_sublayer_fwd(x, pos, *weights, num_heads=num_heads, eps=eps, rate_attn=rate_attn,
                            rate=rate, seed=seed)
        ctx.cfg = cfg
        ctx.save_for_backward(x, pos, seed, *weights)
        return y

    @staticmethod
    def backward(ctx, g):
        num_heads, eps, rate_attn, rate = ctx.cfg
        x, pos, seed, *weights = ctx.saved_tensors
        # the call's keep masks, hashed again from the forward's seed (never stored)
        dx, dpos, *dw = sa_sublayer_bwd(x, pos, *weights, g.contiguous(), num_heads=num_heads,
                                        eps=eps, seed=seed, rate_attn=rate_attn, rate=rate)
        return (dx, dpos, None, None, *dw)


def sa_sublayer(x, pos, wq, bq, wk, bk, wv, bv, wo, bo, ln_scale, ln_bias, *,
                num_heads: int, eps: float = LN_EPS, rate_attn: float = 0.0, rate: float = 0.0,
                seed=None):
    """The SA entry: the kernels on CUDA tensors, the plain versions on CPU
    ones; differentiable.  ``seed``: a (1,) int32 tensor on the device when a
    rate is above 0."""
    weights = [wq, bq, wk, bk, wv, bv, wo, bo, ln_scale, ln_bias]
    x = x.contiguous()
    if not (torch.is_grad_enabled()
            and any(t is not None and t.requires_grad for t in [x, pos, *weights])):
        return sa_sublayer_fwd(x, pos, *weights, num_heads=num_heads, eps=eps,
                               rate_attn=rate_attn, rate=rate, seed=seed)
    if x.device.type != "cpu":
        _build.require_backward("sa_sublayer", has_backward(x.shape[1], x.shape[2], num_heads))
    if rate_attn <= 0.0 and rate <= 0.0:
        seed = None
    cfg = (int(num_heads), float(eps), float(rate_attn), float(rate))
    return _SA.apply(x, pos, seed, cfg, *weights)


def _check_ffn(name, x, w1, b1, w2, b2, ln_scale, ln_bias):
    E = x.shape[2]
    Fd = w1.shape[1]
    if w1.shape != (E, Fd) or b1.shape != (Fd,) or w2.shape != (Fd, E) \
            or any(b.shape != (E,) for b in (b2, ln_scale, ln_bias)):
        raise ValueError(f"{name}: inconsistent shapes")
    _build.check_tensors(name, [x, w1, b1, w2, b2, ln_scale, ln_bias], x.device)


def ffn_sublayer_fwd(x, w1, b1, w2, b2, ln_scale, ln_bias, *, eps: float = LN_EPS,
                     rate: float = 0.0, seed=None):
    """The forward kernels on CUDA tensors, the plain version on CPU tensors."""
    weights = [w1, b1, w2, b2, ln_scale, ln_bias]
    _build.no_grad_inputs("ffn_sublayer_fwd", [x, *weights])
    if rate > 0.0:
        check_seed("ffn_sublayer_fwd", seed, x.device)
    if x.device.type == "cpu":
        B, M, E = x.shape
        keep_hidden, keep_out = ffn_dropout_masks(seed, B, M, E, w1.shape[1], rate)
        return ffn_sublayer_reference(x, *weights, eps=eps, keep_hidden=keep_hidden,
                                      keep_out=keep_out)
    y = _ffn_fwd_card(x, *weights, eps, rate, seed)
    ffn_sublayer_fwd.launches += 1
    return y


ffn_sublayer_fwd.launches = 0

def _ffn_fwd_card(x, w1, b1, w2, b2, ln_scale, ln_bias, eps, rate, seed):
    """The card's call (also run on CPU tensors against a model of the
    library in the tests): one library call of three launches, the products
    x W1 and hk W2 in K slices into a workspace the library lays out, the
    residual and the LayerNorm into y; both dropout masks hashed in the
    kernels (FFN streams 0 and 1), never stored."""
    weights = [w1, b1, w2, b2, ln_scale, ln_bias]
    B, M, E = x.shape
    Fd = w1.shape[1]
    _check_ffn("ffn_sublayer_fwd", x, *weights)
    lib = _build.lib()
    total, = _build.workspace(lib, "fk_ffn_fwd_workspace", 1, B, M, E, Fd)
    ws = torch.empty(total, device=x.device, dtype=torch.float32)
    y = torch.empty_like(x)
    err = lib.fk_ffn_fwd(
        x.data_ptr(), *[w.data_ptr() for w in weights], ws.data_ptr(), y.data_ptr(), B, M, E,
        Fd, float(eps), *dropout_args(seed, 0, rate), *dropout_args(seed, 1, rate),
        _build.stream_ptr(x.device))
    _build.check("fk_ffn_fwd", err)
    return y


def ffn_sublayer_bwd_reference(x, w1, b1, w2, b2, ln_scale, ln_bias, g, *,
                               eps: float = LN_EPS, keep_hidden=None, keep_out=None):
    """Explicit plain backward, recomputing the forward from x with the
    call's masks, step for step as the kernel: the cotangents of (x, w1, b1,
    w2, b2, ln_scale, ln_bias)."""
    E = x.shape[-1]
    Fd = w1.shape[1]
    z1 = x @ w1 + b1
    h = torch.relu(z1)
    hk = h * keep_hidden if keep_hidden is not None else h
    o = hk @ w2 + b2
    res = x + (o * keep_out if keep_out is not None else o)
    dres, dgamma, dbeta = _ln_backward(res, g, ln_scale, eps)
    dt2 = dres * keep_out if keep_out is not None else dres
    dh = dt2 @ w2.t()
    if keep_hidden is not None:
        dh = dh * keep_hidden
    dz1 = torch.where(z1 > 0, dh, 0.0)
    return _ffn_grads(x, dres + dz1 @ w1.t(), dz1, hk, dt2, dgamma, dbeta, E, Fd)


def _ffn_grads(x, dx, dz1, hk, dt2, dgamma, dbeta, E, Fd):
    """The weight gradients as two products over the B*M rows, outside the
    kernel as in the JAX wrapper (sa_layer.py:478-495)."""
    dz1, dt2 = dz1.reshape(-1, Fd), dt2.reshape(-1, E)
    return (dx, x.reshape(-1, E).t() @ dz1, dz1.sum(dim=0), hk.reshape(-1, Fd).t() @ dt2,
            dt2.sum(dim=0), dgamma, dbeta)


def ffn_sublayer_bwd(x, w1, b1, w2, b2, ln_scale, ln_bias, g, *, eps: float = LN_EPS,
                     keep_hidden=None, keep_out=None, seed=None, rate: float = 0.0):
    """The FFN backward on the card (CUDA tensors) or its plain version (CPU).
    Its dropout: the forward's, from ``seed`` at ``rate`` (the card's kernels
    hash both keep masks inline, the plain version takes
    ``ffn_dropout_masks``), or, where given, the replayed masks
    ``keep_hidden`` and ``keep_out`` (then ``seed`` is not read)."""
    weights = [w1, b1, w2, b2, ln_scale, ln_bias]
    hashed = keep_hidden is None and keep_out is None and rate > 0.0
    if hashed:
        check_seed("ffn_sublayer_bwd", seed, x.device)
    if x.device.type == "cpu":
        if hashed:
            B, M, E = x.shape
            keep_hidden, keep_out = ffn_dropout_masks(seed, B, M, E, w1.shape[1], rate)
        return ffn_sublayer_bwd_reference(x, *weights, g, eps=eps, keep_hidden=keep_hidden,
                                          keep_out=keep_out)
    grads = _ffn_bwd_card(x, *weights, g, eps, keep_hidden, keep_out,
                          seed if hashed else None, rate)
    ffn_sublayer_bwd.launches += 1
    return grads


def _ffn_bwd_card(x, w1, b1, w2, b2, ln_scale, ln_bias, g, eps, keep_hidden, keep_out,
                  seed=None, rate=0.0):
    """The card's call (also run on CPU tensors against a model of the
    library in the tests): one library call launches the split into one
    workspace, read back through strided views: on the card's host every
    tensor op costs a few microseconds, the call's floor at these shapes.
    The library leaves the weight products' operands with a column of ones
    each, lhs = [dz1 | 1], [h * keep_1 | 1] and rhs = [x | 1], [dt2 | 1],
    so that one batched product lhs^T rhs gives both weight gradients and
    both bias sums.  The keep values are read from ``keep_hidden`` /
    ``keep_out`` where given, else hashed from ``seed`` (None: no
    dropout)."""
    weights = [w1, b1, w2, b2, ln_scale, ln_bias]
    B, M, E = x.shape
    Fd = w1.shape[1]
    _check_ffn("ffn_sublayer_bwd", x, *weights)
    x, g = _aligned(x), _aligned(g)
    _build.check_tensors("ffn_sublayer_bwd", [g, keep_hidden, keep_out], x.device)
    drops = ((*dropout_args(seed, 0, rate), *dropout_args(seed, 1, rate)) if seed is not None
             else (None, 0, 0, 1.0) * 2)
    R, E1, F1 = B * M, E + 1, Fd + 1
    lib = _build.lib()
    # (floats, dx, lhs, ldl, rhs, ldr, dgamma | dbeta)
    total, o_dx, o_lhs, ldl, o_rhs, ldr, o_dgb = _build.workspace(
        lib, "fk_ffn_bwd_workspace", 7, B, M, E, Fd)
    ws = torch.empty(total, device=x.device, dtype=torch.float32)
    err = lib.fk_ffn_bwd(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        ln_scale.data_ptr(), _ptr(keep_hidden), _ptr(keep_out), g.data_ptr(), ws.data_ptr(),
        B, M, E, Fd, float(eps), *drops, _build.stream_ptr(x.device))
    _build.check("fk_ffn_bwd", err)
    # dW1 = x^T dz1, dW2 = (h * keep_1)^T dt2 and the bias sums, outside the
    # kernels as in JAX: [[dW1^T, db1], .] and [[dW2, .], [db2, .]]
    dw = torch.bmm(ws.as_strided((2, F1, R), (R * ldl, 1, ldl), o_lhs),
                   ws.as_strided((2, R, E1), (R * ldr, ldr, 1), o_rhs))
    return (ws.as_strided((B, M, E), (M * E, E, 1), o_dx), dw.as_strided((E, Fd), (1, E1)),
            dw.as_strided((Fd,), (E1,), E), dw.as_strided((Fd, E), (E1, 1), F1 * E1),
            dw.as_strided((E,), (1,), F1 * E1 + Fd * E1),
            *ws.as_strided((2, E), (E, 1), o_dgb).unbind(0))


ffn_sublayer_bwd.launches = 0


class _FFN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seed, cfg, *weights):
        eps, rate = cfg
        y = ffn_sublayer_fwd(x, *weights, eps=eps, rate=rate, seed=seed)
        ctx.cfg = cfg
        ctx.save_for_backward(x, seed, *weights)
        return y

    @staticmethod
    def backward(ctx, g):
        eps, rate = ctx.cfg
        x, seed, *weights = ctx.saved_tensors
        # the call's keep masks, hashed again from the forward's seed (never stored)
        grads = ffn_sublayer_bwd(x, *weights, g.contiguous(), eps=eps, seed=seed,
                                 rate=rate if seed is not None else 0.0)
        return (grads[0], None, None, *grads[1:])


def ffn_sublayer(x, w1, b1, w2, b2, ln_scale, ln_bias, *, eps: float = LN_EPS,
                 rate: float = 0.0, seed=None):
    """The FFN entry: the kernels on CUDA tensors, the plain versions on CPU
    ones; differentiable.  ``seed``: a (1,) int32 tensor when rate > 0."""
    weights = [w1, b1, w2, b2, ln_scale, ln_bias]
    x = x.contiguous()
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in [x, *weights])):
        return ffn_sublayer_fwd(x, *weights, eps=eps, rate=rate, seed=seed)
    return _FFN.apply(x, seed if rate > 0.0 else None, (float(eps), float(rate)), *weights)


# ---------------------------------------------------------------------------
# mixed precision: the bf16 forms of both forwards (serving)


def sa_sublayer16_reference(x, pos, wq, bq, wk, bk, wv, bv, wo, bo, ln_scale, ln_bias, *,
                            num_heads: int, eps: float = LN_EPS):
    """Plain version of JAX's SA sublayer with ``bf16=True``
    (``sa_layer.py:59-73``, ``_attn_core``, ``_sa_fwd_kernel``): a = bf16(x +
    pos); q, k = bf16(bf16(a W) + bf16(b)), v = bf16(bf16(bf16(x) Wv) +
    bf16(bv)); the logits f32 times 1/sqrt(hd), the softmax f32, the context
    bf16(P) v in f32; the out projection, residual and LayerNorm in f32 (Wo
    is not cast).  x, pos and the weights f32."""
    B, M, E = x.shape
    H = num_heads
    hd = E // H
    a = add_pos(x, pos).to(BF16)
    q, k = (rnd(rnd(mm(a, w)) + rnd(b)).view(B, M, H, hd) for w, b in ((wq, bq), (wk, bk)))
    v = rnd(rnd(mm(x, wv)) + rnd(bv)).view(B, M, H, hd)
    p = torch.softmax(torch.einsum("bmhd,bnhd->bhmn", q, k) * (1.0 / math.sqrt(hd)), dim=-1)
    o = torch.einsum("bhmn,bnhd->bmhd", rnd(p), v).reshape(B, M, E) @ wo + bo
    return F.layer_norm(x + o, (E,), ln_scale, ln_bias, eps)


def ffn_sublayer16_reference(x, w1, b1, w2, b2, ln_scale, ln_bias, *, eps: float = LN_EPS):
    """Plain version of JAX's FFN sublayer with ``bf16=True``
    (``_ffn_fwd_kernel``): z1 = bf16(bf16(bf16(x) W1) + bf16(b1)), then
    relu(z1) W2 + b2, the residual and the LayerNorm in f32 (W2 is not
    cast)."""
    E = x.shape[-1]
    z1 = rnd(rnd(mm(x, w1)) + rnd(b1))
    return F.layer_norm(x + torch.relu(z1) @ w2 + b2, (E,), ln_scale, ln_bias, eps)


def sa_b16_pack(wq, wk, wv):
    """The SA bf16 form's weights: Wq, Wk, Wv (E, E) rounded to bf16."""
    return tuple(w.to(BF16).contiguous() for w in (wq, wk, wv))


def sa_sublayer16_fwd(x, pos, wq, bq, wk, bk, wv, bv, wo, bo, ln_scale, ln_bias, *,
                      num_heads: int, eps: float = LN_EPS, packed=None):
    """The SA sublayer's bf16 form (serving): the kernels on CUDA tensors,
    the plain version on CPU tensors; ``packed`` is ``sa_b16_pack(wq, wk,
    wv)`` where the caller keeps it."""
    weights = [wq, bq, wk, bk, wv, bv, wo, bo, ln_scale, ln_bias]
    _build.no_grad_inputs("sa_sublayer16_fwd", [x, pos, *weights])
    if x.device.type == "cpu":
        return sa_sublayer16_reference(x, pos, *weights, num_heads=num_heads, eps=eps)
    y = _sa16_fwd_card(x, pos, *weights, num_heads, eps, packed)
    sa_sublayer16_fwd.launches += 1
    return y


sa_sublayer16_fwd.launches = 0


def _sa16_fwd_card(x, pos, wq, bq, wk, bk, wv, bv, wo, bo, ln_scale, ln_bias, num_heads, eps,
                   packed=None):
    """``sa_sublayer16_fwd``'s launches: q | k | v (B, 3, M, E) in bf16 per
    (32-row tile, video, projection) on the CUDA cores with bf16 weights
    (``fk_sa_qkv16``), then the attention with the probabilities rounded to
    bf16 for the context, the f32 out projection, the residual and the
    LayerNorm (``fk_sa_attn_out16``)."""
    B, M, E = x.shape
    w16 = sa_b16_pack(wq, wk, wv) if packed is None else packed
    pos_t, Pp = _check_sa("sa_sublayer16_fwd", x, pos, wq, bq, wk, bk, wv, bv, wo, bo,
                          ln_scale, ln_bias, num_heads)
    _build.check_tensors("sa_sublayer16_fwd", list(w16), x.device, bf16=True)
    if not has_forward(M, E, num_heads):
        raise NotImplementedError(f"sa_sublayer16_fwd: no forward kernel for M={M}, E={E}, "
                                  f"H={num_heads}")
    qkv = torch.empty((B, 3, M, E), device=x.device, dtype=BF16)
    st = _build.stream_ptr(x.device)
    err = _build.lib().fk_sa_qkv16(x.data_ptr(), _ptr(pos_t), Pp, w16[0].data_ptr(),
                                   bq.data_ptr(), w16[1].data_ptr(), bk.data_ptr(),
                                   w16[2].data_ptr(), bv.data_ptr(), qkv.data_ptr(), B, M, E, st)
    _build.check("fk_sa_qkv16", err)
    c = torch.empty_like(x)
    y = torch.empty_like(x)
    err = _build.lib().fk_sa_attn_out16(
        qkv.data_ptr(), 3 * M * E, E, M * E, 2 * M * E, x.data_ptr(), wo.data_ptr(),
        bo.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(), c.data_ptr(), y.data_ptr(), B, M,
        E, num_heads, float(eps), st)
    _build.check("fk_sa_attn_out16", err)
    return y


def ffn_sublayer16_fwd(x, w1, b1, w2, b2, ln_scale, ln_bias, *, eps: float = LN_EPS,
                       packed=None):
    """The FFN sublayer's bf16 form (serving): the kernels on CUDA tensors,
    the plain version on CPU tensors; ``packed`` is W1 in bf16 where the
    caller keeps it."""
    weights = [w1, b1, w2, b2, ln_scale, ln_bias]
    _build.no_grad_inputs("ffn_sublayer16_fwd", [x, *weights])
    if x.device.type == "cpu":
        return ffn_sublayer16_reference(x, *weights, eps=eps)
    y = _ffn16_fwd_card(x, *weights, eps, packed)
    ffn_sublayer16_fwd.launches += 1
    return y


ffn_sublayer16_fwd.launches = 0


def _ffn16_fwd_card(x, w1, b1, w2, b2, ln_scale, ln_bias, eps, packed=None):
    """``ffn_sublayer16_fwd``'s one library call (``fk_ffn_fwd16``): the f32
    form's three launches with x rounded to bf16 as it is staged, W1 read in
    bf16 and z1 = bf16(bf16(x W1) + bf16(b1)), then hk W2 in f32, the
    residual and the LayerNorm, in the f32 form's workspace."""
    B, M, E = x.shape
    Fd = w1.shape[1]
    w1h = w1.to(BF16).contiguous() if packed is None else packed
    _check_ffn("ffn_sublayer16_fwd", x, w1, b1, w2, b2, ln_scale, ln_bias)
    _build.check_tensors("ffn_sublayer16_fwd", [w1h], x.device, bf16=True)
    lib = _build.lib()
    total, = _build.workspace(lib, "fk_ffn_fwd_workspace", 1, B, M, E, Fd)
    ws = torch.empty(total, device=x.device, dtype=torch.float32)
    y = torch.empty_like(x)
    err = lib.fk_ffn_fwd16(x.data_ptr(), w1h.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                           b2.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(), ws.data_ptr(),
                           y.data_ptr(), B, M, E, Fd, float(eps), _build.stream_ptr(x.device))
    _build.check("fk_ffn_fwd16", err)
    return y


# ---------------------------------------------------------------------------
# mixed precision: the bf16 backward forms (training, rate 0)


def sa_sublayer16_bwd_reference(x, pos, wq, bq, wk, bk, wv, bv, wo, bo, ln_scale, ln_bias, g, *,
                                num_heads: int, eps: float = LN_EPS):
    """Plain version of JAX's SA backward with ``bf16=True`` (``_sa_bwd_kernel``,
    sa_layer.py:159-226, no dropout): the forward recomputed as
    ``sa_sublayer16_reference`` (a = bf16(x + pos), bf16 q, k, v, the f32
    softmax P, the context bf16(P) v), the out projection, residual and
    LayerNorm backward in f32; dO = dres Wo^T; dV = bf16(P)^T dO, dP = dO
    v^T, dS = P (dP - rowsum(P dP)) / sqrt(hd) rounded to bf16, dq = dS k, dk
    = dS^T q; dqk = [dq | dk] and dv rounded to bf16 for their products: dx =
    dres + bf16(dqk) [Wq | Wk]^T + bf16(dv) Wv^T (bf16 weights), dWqk = a^T
    bf16(dqk), dWv = bf16(x)^T bf16(dv); the bias sums of the unrounded
    cotangents.  Every gradient f32 (JAX's kernel accumulates them so): the
    cotangents of (x, pos, wq, bq, wk, bk, wv, bv, wo, bo, ln_scale,
    ln_bias)."""
    B, M, E = x.shape
    H = num_heads
    hd = E // H
    scale = 1.0 / math.sqrt(hd)
    a = rnd(add_pos(x, pos))
    wq16, wk16, wv16 = rnd(wq), rnd(wk), rnd(wv)
    q = rnd(rnd(a @ wq16) + rnd(bq)).view(B, M, H, hd)
    k = rnd(rnd(a @ wk16) + rnd(bk)).view(B, M, H, hd)
    v = rnd(rnd(rnd(x) @ wv16) + rnd(bv)).view(B, M, H, hd)
    s = torch.einsum("bmhd,bnhd->bhmn", q, k) * scale
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    p16 = rnd(p)
    c = torch.einsum("bhmn,bnhd->bmhd", p16, v).reshape(B, M, E)
    res = x + (c @ wo + bo)
    dres, dgamma, dbeta = _ln_backward(res, g, ln_scale, eps)
    dO = (dres @ wo.t()).view(B, M, H, hd)
    dv = torch.einsum("bhmn,bmhd->bnhd", p16, dO).reshape(B, M, E)
    dp = torch.einsum("bmhd,bnhd->bhmn", dO, v)
    ds = rnd(p * (dp - (p * dp).sum(dim=-1, keepdim=True)) * scale)
    dq = torch.einsum("bhmn,bnhd->bmhd", ds, k).reshape(B, M, E)
    dk = torch.einsum("bhmn,bmhd->bnhd", ds, q).reshape(B, M, E)
    dq16, dk16, dv16 = rnd(dq), rnd(dk), rnd(dv)
    dxa = dq16 @ wq16.t() + dk16 @ wk16.t()
    wgrad = lambda A, Bm: torch.einsum("bmc,bme->ce", A, Bm)  # noqa: E731
    return (dres + dxa + dv16 @ wv16.t(), pos_grad(dxa, pos), wgrad(a, dq16), dq.sum(dim=(0, 1)),
            wgrad(a, dk16), dk.sum(dim=(0, 1)), wgrad(rnd(x), dv16), dv.sum(dim=(0, 1)),
            wgrad(c, dres), dres.sum(dim=(0, 1)), dgamma, dbeta)


def sa_sublayer16_bwd(x, pos, wq, bq, wk, bk, wv, bv, wo, bo, ln_scale, ln_bias, g, *,
                      num_heads: int, eps: float = LN_EPS, packed=None):
    """The SA sublayer's bf16 backward on the card (the plain version is
    ``sa_sublayer16_bwd_reference``)."""
    grads = _sa16_bwd_card(x, pos, wq, bq, wk, bk, wv, bv, wo, bo, ln_scale, ln_bias, g,
                           num_heads, eps, packed)
    sa_sublayer16_bwd.launches += 1
    return grads


sa_sublayer16_bwd.launches = 0


def _sa16_bwd_card(x, pos, wq, bq, wk, bk, wv, bv, wo, bo, ln_scale, ln_bias, g, num_heads,
                   eps, packed=None):
    """``sa_sublayer16_bwd``'s one library call (``csrc/sa_layer.cu::
    fk_sa_bwd16``, nine launches: q | k | v and the context as the bf16
    forward's, c Wo, the LayerNorm backward, dres Wo^T, the attention's
    cotangents per (head, video), dxa and dx, the weight products), then
    the bias, LayerNorm and positional sums in a fixed order (``fk_reduce``)."""
    B, M, E = x.shape
    H = num_heads
    w16 = sa_b16_pack(wq, wk, wv) if packed is None else packed
    pos_t, Pp = _check_sa("sa_sublayer16_bwd", x, pos, wq, bq, wk, bk, wv, bv, wo, bo, ln_scale,
                          ln_bias, num_heads)
    if not has_forward(M, E, H) or 4 * (4 * M * (E // H + 1) + 2 * M * M) > _build.MAX_SMEM:
        raise NotImplementedError(f"sa_sublayer16_bwd: no kernel for M={M}, E={E}, H={H}")
    x, g = _aligned(x), _aligned(g)
    woT = wo.t().contiguous()
    wqkT = torch.cat([wq, wk], dim=1).t().to(BF16).contiguous()
    wvT = wv.t().to(BF16).contiguous()
    _build.check_tensors("sa_sublayer16_bwd", [g, woT, wqkT, wvT, *w16], x.device, bf16=True)
    R = B * M
    f32 = dict(device=x.device, dtype=torch.float32)
    qkv = torch.empty((B, 3, M, E), device=x.device, dtype=BF16)
    c, t, dres, dout, dO, dxa, dx = (torch.empty((R, E), **f32) for _ in range(7))
    grads, grads_r = torch.empty((R, 3 * E), **f32), torch.empty((R, 3 * E), **f32)
    tiles = -(-R // 16)
    part = torch.empty((tiles, 2, E), **f32)
    dw = torch.empty(4 * E * E, **f32)
    err = _build.lib().fk_sa_bwd16(
        x.data_ptr(), _ptr(pos_t), Pp, w16[0].data_ptr(), bq.data_ptr(), w16[1].data_ptr(),
        bk.data_ptr(), w16[2].data_ptr(), bv.data_ptr(), wo.data_ptr(), bo.data_ptr(),
        ln_scale.data_ptr(), woT.data_ptr(), wqkT.data_ptr(), wvT.data_ptr(), g.data_ptr(),
        qkv.data_ptr(), c.data_ptr(), t.data_ptr(), dres.data_ptr(), dout.data_ptr(),
        dO.data_ptr(), grads.data_ptr(), grads_r.data_ptr(), dxa.data_ptr(), part.data_ptr(),
        dx.data_ptr(), dw.data_ptr(), B, M, E, H, float(eps), _build.stream_ptr(x.device))
    _build.check("fk_sa_bwd16", err)
    sums = _grad.reduce(grads, G=1, P=R, pstride=3 * E, gstride=0, rows=1, rstride=0,
                        cols=3 * E)[0, 0]
    dbo = _grad.reduce(dres, G=1, P=R, pstride=E, gstride=0, rows=1, rstride=0, cols=E)[0, 0]
    ln = _grad.reduce(part, G=1, P=tiles, pstride=2 * E, gstride=0, rows=2, rstride=E,
                      cols=E)[0]
    dpos = None
    if pos is not None:
        dpos = pos_grad(_grad.batch_sum(dxa.view(B, M, E), Pp), pos)
    dwqk = dw[:2 * E * E].view(E, 2 * E)
    return (dx.view(B, M, E), dpos, dwqk[:, :E], sums[:E], dwqk[:, E:], sums[E:2 * E],
            dw[2 * E * E:3 * E * E].view(E, E), sums[2 * E:], dw[3 * E * E:].view(E, E), dbo,
            ln[0], ln[1])


def ffn_sublayer16_bwd_reference(x, w1, b1, w2, b2, ln_scale, ln_bias, g, *,
                                 eps: float = LN_EPS):
    """Plain version of JAX's FFN backward with ``bf16=True``
    (``_ffn_bwd_kernel`` and ``_ffn_bwd``, sa_layer.py:254-299, :449-495, no
    dropout): z1 = bf16(bf16(bf16(x) W1) + bf16(b1)) as the forward's, the
    rest of the forward and the LayerNorm backward in f32; dz1 = (dt2 W2^T) *
    (z1 > 0) in f32, dx = dres + bf16(dz1) bf16(W1)^T; dW1 = bf16(x)^T
    bf16(dz1) and dW2 = relu(z1)^T dt2 in f32, the bias sums of the unrounded
    cotangents: the cotangents of (x, w1, b1, w2, b2, ln_scale, ln_bias)."""
    E = x.shape[-1]
    Fd = w1.shape[1]
    w1r = rnd(w1)
    z1 = rnd(rnd(rnd(x) @ w1r) + rnd(b1))
    h = torch.relu(z1)
    res = x + (h @ w2 + b2)
    dres, dgamma, dbeta = _ln_backward(res, g, ln_scale, eps)
    dz1 = torch.where(z1 > 0, dres @ w2.t(), 0.0)
    dx = dres + rnd(dz1) @ w1r.t()
    return (dx, rnd(x).reshape(-1, E).t() @ rnd(dz1).reshape(-1, Fd), dz1.sum(dim=(0, 1)),
            h.reshape(-1, Fd).t() @ dres.reshape(-1, E), dres.sum(dim=(0, 1)), dgamma, dbeta)


def ffn_sublayer16_bwd(x, w1, b1, w2, b2, ln_scale, ln_bias, g, *, eps: float = LN_EPS,
                       packed=None):
    """The FFN sublayer's bf16 backward on the card (the plain version is
    ``ffn_sublayer16_bwd_reference``)."""
    grads = _ffn16_bwd_card(x, w1, b1, w2, b2, ln_scale, ln_bias, g, eps, packed)
    ffn_sublayer16_bwd.launches += 1
    return grads


ffn_sublayer16_bwd.launches = 0


def _ffn16_bwd_card(x, w1, b1, w2, b2, ln_scale, ln_bias, g, eps, packed=None):
    """``ffn_sublayer16_bwd``'s one library call (``fk_ffn_bwd16``: the f32
    form's six launches with the bf16 roundings), read back as
    ``_ffn_bwd_card`` reads its workspace; dW1 = bf16(x)^T bf16(dz1) and the
    other weight products outside the kernels, as JAX's wrapper computes
    them (sa_layer.py:478-495)."""
    weights = [w1, b1, w2, b2, ln_scale, ln_bias]
    B, M, E = x.shape
    Fd = w1.shape[1]
    _check_ffn("ffn_sublayer16_bwd", x, *weights)
    w1h = w1.to(BF16).contiguous() if packed is None else packed
    w1r = w1h.float()
    x, g = _aligned(x), _aligned(g)
    _build.check_tensors("ffn_sublayer16_bwd", [g, w1h, w1r], x.device, bf16=True)
    R, E1, F1 = B * M, E + 1, Fd + 1
    lib = _build.lib()
    total, o_dx, o_lhs, ldl, o_rhs, ldr, o_dgb = _build.workspace(
        lib, "fk_ffn_bwd_workspace", 7, B, M, E, Fd)
    ws = torch.empty(total, device=x.device, dtype=torch.float32)
    err = lib.fk_ffn_bwd16(x.data_ptr(), w1h.data_ptr(), w1r.data_ptr(), b1.data_ptr(),
                           w2.data_ptr(), b2.data_ptr(), ln_scale.data_ptr(), g.data_ptr(),
                           ws.data_ptr(), B, M, E, Fd, float(eps), _build.stream_ptr(x.device))
    _build.check("fk_ffn_bwd16", err)
    dw = torch.bmm(ws.as_strided((2, F1, R), (R * ldl, 1, ldl), o_lhs),
                   ws.as_strided((2, R, E1), (R * ldr, ldr, 1), o_rhs))
    dz1 = ws.as_strided((R, Fd), (ldl, 1), o_lhs)
    dw1 = rnd(x.view(R, E)).t() @ rnd(dz1)
    return (ws.as_strided((B, M, E), (M * E, E, 1), o_dx), dw1,
            dw.as_strided((Fd,), (E1,), E), dw.as_strided((Fd, E), (E1, 1), F1 * E1),
            dw.as_strided((E,), (1,), F1 * E1 + Fd * E1),
            *ws.as_strided((2, E), (E, 1), o_dgb).unbind(0))


class _SA16(torch.autograd.Function):
    """The SA sublayer's bf16 form for training (rate 0): the kernels on
    CUDA tensors, the plain versions on CPU ones or where ``plain``."""

    @staticmethod
    def forward(ctx, x, pos, cfg, *weights):
        num_heads, eps, plain, packed = cfg
        if plain or x.device.type == "cpu":
            y = sa_sublayer16_reference(x, pos, *weights, num_heads=num_heads, eps=eps)
        else:
            y = sa_sublayer16_fwd(x, pos, *weights, num_heads=num_heads, eps=eps, packed=packed)
        ctx.cfg = cfg
        ctx.save_for_backward(x, pos, *weights)
        return y

    @staticmethod
    def backward(ctx, g):
        num_heads, eps, plain, packed = ctx.cfg
        x, pos, *weights = ctx.saved_tensors
        if plain or g.device.type == "cpu":
            dx, dpos, *dw = sa_sublayer16_bwd_reference(x, pos, *weights, g.contiguous(),
                                                        num_heads=num_heads, eps=eps)
        else:
            dx, dpos, *dw = sa_sublayer16_bwd(x, pos, *weights, g.contiguous(),
                                              num_heads=num_heads, eps=eps, packed=packed)
        return (dx, dpos, None, *dw)


class _FFN16(torch.autograd.Function):
    """The FFN sublayer's bf16 form for training (rate 0), as ``_SA16``."""

    @staticmethod
    def forward(ctx, x, cfg, *weights):
        eps, plain, packed = cfg
        if plain or x.device.type == "cpu":
            y = ffn_sublayer16_reference(x, *weights, eps=eps)
        else:
            y = ffn_sublayer16_fwd(x, *weights, eps=eps, packed=packed)
        ctx.cfg = cfg
        ctx.save_for_backward(x, *weights)
        return y

    @staticmethod
    def backward(ctx, g):
        eps, plain, packed = ctx.cfg
        x, *weights = ctx.saved_tensors
        fn = (ffn_sublayer16_bwd_reference if plain or g.device.type == "cpu"
              else functools.partial(ffn_sublayer16_bwd, packed=packed))
        grads = fn(x, *weights, g.contiguous(), eps=eps)
        return (grads[0], None, *grads[1:])


def sa_sublayer16_train(x, pos, wq, bq, wk, bk, wv, bv, wo, bo, ln_scale, ln_bias, *,
                        num_heads: int, eps: float = LN_EPS, plain=False, packed=None):
    """The differentiable bf16 SA sublayer (rate 0)."""
    if x.device.type != "cpu" and not plain:
        _build.require_backward("sa_sublayer16", has_forward(x.shape[1], x.shape[2], num_heads))
    cfg = (int(num_heads), float(eps), bool(plain), packed)
    return _SA16.apply(x.contiguous(), pos, cfg, wq, bq, wk, bk, wv, bv, wo, bo, ln_scale,
                       ln_bias)


def ffn_sublayer16_train(x, w1, b1, w2, b2, ln_scale, ln_bias, *, eps: float = LN_EPS,
                         plain=False, packed=None):
    """The differentiable bf16 FFN sublayer (rate 0)."""
    return _FFN16.apply(x.contiguous(), (float(eps), bool(plain), packed), w1, b1, w2, b2,
                        ln_scale, ln_bias)
