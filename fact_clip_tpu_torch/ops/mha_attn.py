"""K3: multi-head cross-attention of the action queries over the frame memory,
forward with probability dropout, and its backward.

Replaces ``fact_clip_tpu/ops/pallas/mha_attn.py::mha_cross_attention``: the
forward ``_mha_fwd_impl`` (Pallas kernel ``_mha_kernel``), the backward
``_mha_bwd`` (``_mha_bwd_kernel``) and the mask replay ``mha_dropout_mask``.
On the card the forward is the K / V projection, one 3xTF32 GEMM on the
towers' tensor-core core (``csrc/tc_tower.cuh`` through ``fk_k6_gemm``,
epilogue kProj: the bias and the key's positional term), then per (key tile,
head, video) the masked softmax attention and a fixed-order combine
(``csrc/mha_attn.cu``).  The backward recomputes the projection, runs the
attention backward per (key tile, head, video), dx as one more GEMM of the
same core and the weight products on ``fk_k6_wgrad``.  The TPU kernels'
lane-masked row expansion (``_expand_rows``) is a workaround for the
128-lane vector unit; the H100 kernels work per head with hd = E / H.  Both
attention kernels hash the keep mask themselves, so the training path makes
no mask; ``mha_dropout_mask`` (``csrc/dropout.cu``) writes it where a caller
wants it whole.  What bounds them and what the design does about it is
written at the top of ``csrc/mha_attn.cu``.

q (B, M, E) arrives projected (the q projection and the out projection stay
outside, as in the JAX caller); the result (B, M, E) holds the heads'
outputs side by side, before the out projection.  Keys at or past
``x_len[b]`` get the logit -1e9; the kernels never read the frames there
(the projection writes zeros).  A video with no valid key (x_len = 0) gives
every key that logit, so it attends uniformly to all X frames, as JAX's
kernels and the plain version do: the projection, dx and the weight products
take all its frames (``attended_lengths``, on the device, no host sync).
Dropout (torch semantics)
multiplies the probabilities in the attend sum only, the softmax normaliser
sums the undropped ones: out = dropout(softmax(logits)) @ V.  Its keep mask
is the counter hash of ``ops/dropout.py``, stream 0 over (B, H*M, X) with
rows h*M + m, from a (1,) int32 seed per call.  The TPU seeds per grid cell
and so ties its forward and backward to one key tile; this mask is keyed by
the logical index (b, h, m, x), so no tiling couples the two passes.

``mha_cross_attention`` is the differentiable entry.  The forward saves each
(video, head, query) row's softmax stats (max, sum), the backward recovers the
probabilities from them, as JAX's does; the key positional term is a
constant (JAX's ``pos_grad=False``), and the entry refuses one that wants a
gradient.  ``packed`` (``k3_pack``) hands the projection's packed weights
to a forward without gradients; the SCA module caches them while serving,
as long as its weights do not change.
"""

from __future__ import annotations

import math

import torch

from .. import _build
from . import _grad
from .bf16 import BF16, add_pos16, mm, rnd
from .dilated_conv import (_MASKED, _ONE, _PROJ, B16_PROJ16, _k6_gemm, b16_add_pos, b16_gemm,
                           b16_pack, has_b16_kernels, k6_pack, wgrad)
from .dropout import check_seed, dropout_args, dropout_mask_reference, launch_mask
from .pos import add_pos, kernel_pos

_NEG = -1e9
FWD_KEY_TILE = 64  # keys per block of the forward attention (csrc/mha_attn.cu kFwdTile)
BWD_KEY_TILES = (64, 32)  # keys per block of the backward attention, the largest that fits
K3_SUM_GROUP = 16  # dq's tile shares and the bias sums, added a run at a time


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
    the mask kernel (CUDA) or its plain version (CPU).  The backward's kernel
    hashes the same bits, so the training path on the card makes no such
    mask; the CPU's plain backward takes it."""
    if seed.device.type == "cpu":
        return dropout_mask_reference(seed, 0, shape, rate)
    out = launch_mask(seed, 0, shape, rate)
    mha_dropout_mask.launches += 1
    return out


mha_dropout_mask.launches = 0


def _check(name, q, x_in, wk, bk, wv, bv, x_len, num_heads, bf16: bool = False):
    B, X, Cx = x_in.shape
    M, E = q.shape[1], wk.shape[1]
    if (q.shape != (B, M, E) or E % num_heads or wk.shape != (Cx, E) or wv.shape != (Cx, E)
            or bk.shape != (E,) or bv.shape != (E,)):
        raise ValueError(f"{name}: inconsistent shapes")
    if x_len.dtype != torch.int32 or x_len.shape != (B,):
        raise ValueError(f"{name}: x_len must be (B,) int32")
    _build.check_tensors(name, [q, x_in, wk, bk, wv, bv, x_len], x_in.device, bf16=bf16)


def _check_strides(name, Cx: int, E: int, P: int):
    """The projection GEMM's TMA row strides: 16 bytes (Cx, E and the
    positional term's P channels multiples of 4)."""
    if Cx % 4 or E % 4 or P % 4:
        raise NotImplementedError(f"{name}: no kernel for Cx={Cx}, E={E}, P={P} "
                                  "(each a multiple of 4)")


def attn_smem(M: int, hd: int) -> int:
    """Bytes of the forward attention's block: one head's q rows, the tile's
    K_h (odd row stride) and V_h, two rows of weights per warp."""
    bk = FWD_KEY_TILE
    return 4 * (M * hd + bk * (hd + 1) + bk * hd + 16 * bk)


def has_forward(M: int, E: int, num_heads: int) -> bool:
    """The forward attention's block fits in shared memory: up to M = 763
    at hd = 64, 1,654 at hd = 32."""
    return attn_smem(M, E // num_heads) <= _build.MAX_SMEM


def attended_lengths(x_len, X: int):
    """The frames a video's attention reads: x_len, or all X of a video
    with no valid key (its logits are all -1e9, so it attends to every
    frame).  The projection, dx and the weight products run over these."""
    return x_len.masked_fill(x_len <= 0, X)


def k3_pack(wk, bk, wv, bv):
    """The projection's weights as the GEMM reads them: [Wk | Wv]^T's TF32
    hi / lo parts (2, 2E, Cx), [bk | bv] (2E,) and Wk^T's (2, E, Cx) for the
    positional term pos @ Wk (``dilated_conv.k6_pack``)."""
    return k6_pack(torch.cat([wk, wv], dim=1), True), torch.cat([bk, bv]), k6_pack(wk, True)


def _project(x_in, x_pos, x_len, packed):
    """KV = x @ [Wk | Wv] + [bk | bv] + [pos @ Wk | 0], (B, X, 2E), zero at
    frames at or past ``x_len`` (the caller's ``attended_lengths``): the table
    pos @ Wk (1 or B, X, E) by one GEMM (kMasked), then the projection
    (kProj) adding it on the K columns."""
    B, X, Cx = x_in.shape
    wkv, bkv, wkp = packed
    E = wkp.shape[1]
    pos = kernel_pos(x_pos, B, X, Cx)[0]
    f32 = dict(device=x_in.device, dtype=torch.float32)
    tab = None
    if pos is not None:
        Bp = pos.shape[0]
        tab = torch.empty((Bp, X, E), **f32)
        lens = x_len if Bp == B else torch.full((Bp,), X, dtype=torch.int32, device=x_in.device)
        _k6_gemm(_MASKED, pos, _ONE, wkp, E, lens, tab)
    kv = torch.empty((B, X, 2 * E), **f32)
    _k6_gemm(_PROJ, x_in, _ONE, wkv, 2 * E, x_len, kv, bias=(bkv, None), res=tab, res_ld=E,
             res_bstride=X * E if tab is not None and tab.shape[0] == B > 1 else 0)
    return kv


def mha_cross_fwd(q, x_in, x_pos, wk, bk, wv, bv, x_len, *, num_heads: int, rate: float = 0.0,
                  seed=None, with_stats: bool = False, packed=None):
    """The forward kernels on CUDA tensors, the plain version on CPU tensors;
    with ``with_stats`` it returns (out, stats) for the backward.  A shape
    whose block does not fit is refused before any launch."""
    _build.no_grad_inputs("mha_cross_fwd", [q, x_in, x_pos, wk, bk, wv, bv])
    B, X, _ = x_in.shape
    M = q.shape[1]
    if rate > 0.0:
        check_seed("mha_cross_fwd", seed, x_in.device)
    if x_in.device.type == "cpu":
        keep = mha_dropout_mask(seed, (B, num_heads * M, X), rate) if rate > 0.0 else None
        return mha_cross_attention_reference(q, x_in, x_pos, wk, bk, wv, bv, x_len,
                                             num_heads=num_heads, keep=keep,
                                             with_stats=with_stats)
    out = _mha_fwd_card(q, x_in, x_pos, wk, bk, wv, bv, x_len, num_heads, rate, seed,
                        with_stats, packed)
    mha_cross_fwd.launches += 1
    return out


mha_cross_fwd.launches = 0


def _mha_fwd_card(q, x_in, x_pos, wk, bk, wv, bv, x_len, num_heads, rate, seed, with_stats,
                  packed):
    """``mha_cross_fwd``'s launches: the packs (unless ``packed``), the
    positional table and projection GEMMs, the attention and its combine
    (CPU tensors reach it only in the tests, which stand a model of the
    kernels' C interface in for the library)."""
    B, X, Cx = x_in.shape
    M, E = q.shape[1], wk.shape[1]
    H = num_heads
    hd = E // H
    _check("mha_cross_fwd", q, x_in, wk, bk, wv, bv, x_len, H)
    _check_strides("mha_cross_fwd", Cx, E, 0 if x_pos is None else x_pos.shape[-1])
    if not has_forward(M, E, H):
        raise NotImplementedError(f"mha_cross_fwd: no forward kernel for M={M}, E={E}, H={H} "
                                  f"(its block needs {attn_smem(M, hd)} bytes of shared memory, "
                                  f"{_build.MAX_SMEM} at most)")
    packed = k3_pack(wk, bk, wv, bv) if packed is None else packed
    _build.check_tensors("mha_cross_fwd", [*packed], x_in.device)
    kv = _project(x_in, x_pos, attended_lengths(x_len, X), packed)
    n_t = -(-X // FWD_KEY_TILE)
    f32 = dict(device=x_in.device, dtype=torch.float32)
    part_acc = torch.empty((B, n_t, H * M, hd), **f32)
    part_ml = torch.empty((B, n_t, H * M, 2), **f32)
    out = torch.empty((B, M, E), **f32)
    stats = torch.empty((B, H * M, 2), **f32) if with_stats else None
    err = _build.lib().fk_k3_attn(
        kv.data_ptr(), q.data_ptr(), x_len.data_ptr(), B, X, M, H, hd, 1.0 / math.sqrt(hd),
        part_acc.data_ptr(), part_ml.data_ptr(), out.data_ptr(),
        stats.data_ptr() if stats is not None else None, *dropout_args(seed, 0, rate),
        _build.stream_ptr(x_in.device))
    _build.check("fk_k3_attn", err)
    return (out, stats) if with_stats else out


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


def bwd_smem(M: int, hd: int, bk: int) -> int:
    """Bytes of the backward attention's block: one head's q and g rows, the
    tile's K_h and V_h (odd row stride) and two (M, BK) panels."""
    return 4 * (2 * M * hd + 2 * bk * (hd + 1) + 2 * M * bk)


def bwd_key_tile(M: int, E: int, num_heads: int):
    """The key tile of the backward attention: the largest of
    ``BWD_KEY_TILES`` whose block fits in shared memory, or None (past
    M = 437 at hd = 32, 281 at hd = 64)."""
    hd = E // num_heads
    for bk in BWD_KEY_TILES:
        if bwd_smem(M, hd, bk) <= _build.MAX_SMEM:
            return bk
    return None


def has_backward(M: int, E: int, num_heads: int) -> bool:
    return bwd_key_tile(M, E, num_heads) is not None


def mha_cross_bwd(q, x_in, x_pos, wk, bk, wv, bv, x_len, stats, out, g, *, num_heads: int,
                  keep=None, seed=None, rate: float = 0.0):
    """The backward on the card (CUDA tensors) or its plain version (CPU),
    from the forward's saves.  Its dropout: the forward's, from ``seed`` at
    ``rate`` (the card's kernel hashes the keep values inline, the plain
    version takes ``mha_dropout_mask``), or, where given, the replayed mask
    ``keep`` (then ``seed`` is not read)."""
    hashed = keep is None and rate > 0.0
    if hashed:
        check_seed("mha_cross_bwd", seed, x_in.device)
    if x_in.device.type == "cpu":
        if hashed:
            keep = mha_dropout_mask(seed, (x_in.shape[0], num_heads * q.shape[1], x_in.shape[1]),
                                    rate)
        return mha_cross_bwd_reference(q, x_in, x_pos, wk, bk, wv, bv, x_len, stats, out, g,
                                       num_heads=num_heads, keep=keep)
    grads = _mha_bwd_card(q, x_in, x_pos, wk, bk, wv, bv, x_len, stats, out, g, num_heads, keep,
                          seed if hashed else None, rate)
    mha_cross_bwd.launches += 1
    return grads


mha_cross_bwd.launches = 0


def _mha_bwd_card(q, x_in, x_pos, wk, bk, wv, bv, x_len, stats, out, g, num_heads, keep,
                  seed=None, rate: float = 0.0):
    """``mha_cross_bwd``'s launches (CPU tensors reach it only in the tests,
    as ``_mha_fwd_card``): the packs, the projection recomputed, the
    attention backward, dx, the weight products and the fixed-order sums.
    Nothing of the forward's packs is kept for it: a training step holds no
    more than the activations it saves.  The keep values are read from
    ``keep`` where given, else hashed from ``seed`` at ``rate`` (None: no
    dropout)."""
    B, X, Cx = x_in.shape
    M, E = q.shape[1], wk.shape[1]
    H = num_heads
    hd = E // H
    _check("mha_cross_bwd", q, x_in, wk, bk, wv, bv, x_len, H)
    pos, _, P = kernel_pos(x_pos, B, X, Cx)
    _check_strides("mha_cross_bwd", Cx, E, P)
    tile = bwd_key_tile(M, E, H)
    if tile is None:
        raise NotImplementedError(f"mha_cross_bwd: no backward kernel for M={M}, E={E}, H={H} "
                                  f"(its block needs {bwd_smem(M, hd, BWD_KEY_TILES[-1])} bytes "
                                  f"of shared memory, {_build.MAX_SMEM} at most)")
    g = g.contiguous()
    _build.check_tensors("mha_cross_bwd", [pos, stats, out, g, keep], x_in.device)
    D = _row_term(g, out, H).contiguous()
    lens = attended_lengths(x_len, X)
    kv = _project(x_in, x_pos, lens, k3_pack(wk, bk, wv, bv))  # recomputed, as JAX's does
    n_slots = -(-(-(-X // tile)) // K3_SUM_GROUP) * K3_SUM_GROUP
    f32 = dict(device=x_in.device, dtype=torch.float32)
    dkv = torch.empty((B, X, 2 * E), **f32)
    part_dq = torch.zeros((B, n_slots, M * E), **f32)
    part_b = torch.zeros((B, n_slots, 2 * E), **f32)
    err = _build.lib().fk_k3_attn_bwd(
        kv.data_ptr(), q.data_ptr(), g.data_ptr(), stats.data_ptr(), D.data_ptr(),
        keep.data_ptr() if keep is not None else None, x_len.data_ptr(), B, X, M, H, hd,
        1.0 / math.sqrt(hd), dkv.data_ptr(), part_dq.data_ptr(), part_b.data_ptr(), n_slots,
        tile, *(dropout_args(seed, 0, rate) if keep is None and seed is not None
                else (None, 0, 0, 1.0)), _build.stream_ptr(x_in.device))
    _build.check("fk_k3_attn_bwd", err)
    del kv
    dx = torch.empty_like(x_in)
    _k6_gemm(_MASKED, dkv, _ONE, k6_pack(torch.cat([wk, wv], dim=1)), Cx, lens, dx)
    dw = wgrad(x_in, 0, Cx, dkv, 0, 2 * E, lens)[0]  # [x^T dK | x^T dV]
    d_wk, d_wv = dw[:, :E], dw[:, E:]
    if pos is not None:  # dWk += pos^T dK, the batch's dK summed first where pos is shared
        if pos.shape[0] == 1:
            dk_p = _grad.batch_sum(dkv, E)
            pos_lens = torch.full((1,), X, dtype=torch.int32, device=x_in.device)
        else:
            dk_p, pos_lens = dkv, lens
        d_wk = d_wk.clone()
        d_wk[:P] += wgrad(pos, 0, P, dk_p, 0, E, pos_lens)[0]
    dq = _grad.sum_groups(part_dq, K3_SUM_GROUP).view(B, M, E)
    d_b = _grad.sum_groups(part_b.view(1, B * n_slots, 2 * E), K3_SUM_GROUP)[0]
    return dq, dx, None, d_wk, d_b[:E], d_wv, d_b[E:]


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
        # the layer's keep values, hashed again from the forward's seed (never stored)
        grads = mha_cross_bwd(q, x_in, x_pos, wk, bk, wv, bv, x_len, stats, out, g.contiguous(),
                              num_heads=num_heads, seed=seed, rate=rate)
        return (*grads, None, None, None)


def mha_cross_attention(q, x_in, x_pos, wk, bk, wv, bv, x_len, *, num_heads: int,
                        rate: float = 0.0, seed=None, packed=None):
    """The K3 entry: the kernels on CUDA tensors, the plain versions on CPU
    ones; differentiable in every input but ``x_pos`` (a constant) and
    ``x_len``.  ``seed``: a (1,) int32 tensor on the device when rate > 0;
    ``packed``: ``k3_pack(wk, bk, wv, bv)`` for a forward without gradients
    when the caller keeps it (the kernels pack the weights themselves
    otherwise, and a training forward and its backward always do)."""
    grad = torch.is_grad_enabled()
    if grad and x_pos is not None and x_pos.requires_grad:
        raise NotImplementedError("mha_cross_attention: the key positional term is a constant "
                                  "(no gradient), as JAX's pos_grad=False")
    args = (q.contiguous(), x_in.contiguous(), x_pos, wk, bk, wv, bv, x_len)
    if not (grad and any(t.requires_grad for t in (q, x_in, wk, bk, wv, bv))):
        return mha_cross_fwd(*args, num_heads=num_heads, rate=rate, seed=seed, packed=packed)
    if x_in.device.type != "cpu":
        _build.require_backward("mha_cross_attention", has_backward(q.shape[1], wk.shape[1],
                                                                    num_heads))
    return _MHA.apply(*args, seed, (int(num_heads), float(rate)))


# ---------------------------------------------------------------------------
# mixed precision: the bf16 form of the forward (serving)


def bf16_scale(hd: int) -> float:
    """JAX folds 1/sqrt(hd) into bf16 queries as a weak-typed scalar, so the
    scale itself is rounded to bf16 first (``mha_attn.py::_arrange_queries``)."""
    return float(torch.tensor(1.0 / math.sqrt(hd)).to(BF16))


def mha_cross16_reference(q, x_in, x_pos, wk, bk, wv, bv, x_len, *, num_heads: int,
                          with_stats: bool = False):
    """Plain version of JAX's K3 under mixed precision (``mha_attn.py:80-118``):
    q (B, M, E) and x (B, X, Cx) bf16, x_pos bf16 or None, the weights f32
    (cast here).  The queries bf16(q * bf16(1/sqrt(hd))); k = bf16((x +
    pos) Wk + bk) and v = bf16(x Wv + bv) with x + pos rounded to bf16 first;
    the logits f32; per key tile of FWD_KEY_TILE the weights exp(logit -
    the tile's max), their f32 sum and the attend sum over the weights
    rounded to bf16; the tiles merged by their maxima.  Returns (B, M, E) f32.
    JAX rounds each 512-key tile's weights against the running max; the
    kernel and this version against each 64-key tile's own max (the same to a
    bf16 rounding of each weight)."""
    B, X, _ = x_in.shape
    M, E = q.shape[1], wk.shape[1]
    H = num_heads
    hd = E // H
    qs = rnd(q.float() * bf16_scale(hd)).view(B, M, H, hd)
    k = rnd(mm(add_pos16(x_in, None if x_pos is None else x_pos.to(BF16)), wk) + bk)
    v = rnd(mm(x_in, wv) + bv)
    logits = torch.einsum("bmhd,bxhd->bhmx", qs, k.view(B, X, H, hd))
    valid = torch.arange(X, device=x_in.device)[None, None, None, :] < x_len[:, None, None, None]
    logits = logits.masked_fill(~valid, _NEG)
    n_t = -(-X // FWD_KEY_TILE)
    pad = n_t * FWD_KEY_TILE - X  # keys past X weigh 0
    lt = torch.nn.functional.pad(logits, (0, pad), value=float("-inf"))
    lt = lt.view(B, H, M, n_t, FWD_KEY_TILE)
    m_t = lt.amax(dim=-1, keepdim=True)
    p = torch.exp(lt - m_t)
    vt = torch.nn.functional.pad(v.view(B, X, H, hd), (0, 0, 0, 0, 0, pad))
    acc = torch.einsum("bhmtx,btxhd->bhmtd", rnd(p), vt.view(B, n_t, FWD_KEY_TILE, H, hd))
    m_g = m_t.amax(dim=-2, keepdim=True)
    w = torch.exp(m_t - m_g)  # (B, H, M, n_t, 1)
    l_g = (w[..., 0] * p.sum(dim=-1)).sum(dim=-1, keepdim=True)
    out = ((w * acc).sum(dim=-2) / l_g).permute(0, 2, 1, 3).reshape(B, M, E)
    if with_stats:  # the rows' softmax stats (B, H*M, 2): the max logit and the weights' sum
        return out, torch.cat([m_g[..., 0, 0, None], l_g], dim=-1).reshape(B, H * M, 2)
    return out


def k3_b16_pack(wk, wv):
    """K3's bf16 form's weights: Wk^T and Wv^T (E, Cx) in bf16, K-major
    (``dilated_conv.b16_pack``)."""
    return b16_pack(wk, True), b16_pack(wv, True)


def mha_cross16_fwd(q, x_in, x_pos, wk, bk, wv, bv, x_len, *, num_heads: int, packed=None):
    """K3's bf16 form (serving): the kernels on CUDA tensors, the plain
    version on CPU tensors; ``packed`` is ``k3_b16_pack(wk, wv)`` where the
    caller keeps it.  A shape whose block does not fit is refused before any
    launch."""
    _build.no_grad_inputs("mha_cross16_fwd", [q, x_in, x_pos, wk, bk, wv, bv])
    if x_in.device.type == "cpu":
        return mha_cross16_reference(q, x_in, x_pos, wk, bk, wv, bv, x_len, num_heads=num_heads)
    out = _mha16_fwd_card(q, x_in, x_pos, wk, bk, wv, bv, x_len, num_heads, packed)
    mha_cross16_fwd.launches += 1
    return out


mha_cross16_fwd.launches = 0


def _project16(x_in, x_pos, bk, bv, x_len, wkp, wvp):
    """K3's bf16 K and V, both directions': bf16(x + pos) (``fk_b16_add_pos``),
    then one (B, X, 2E) bf16 buffer on the bf16 GEMM (B16_PROJ16, zero past
    the attended length).  Returns (bf16(x + pos), kv, the attended lengths)."""
    B, X, _ = x_in.shape
    E = wkp.shape[0]
    xin = b16_add_pos(x_in, None if x_pos is None else x_pos.to(BF16))
    lens = attended_lengths(x_len, X)
    kv = torch.empty((B, X, 2 * E), device=x_in.device, dtype=BF16)
    b16_gemm(B16_PROJ16, xin, [0], wkp, E, lens, kv, ldo=2 * E, bias=bk)
    b16_gemm(B16_PROJ16, x_in, [0], wvp, E, lens, kv, ldo=2 * E, col_off=E, bias=bv)
    return xin, kv, lens


def _mha16_fwd_card(q, x_in, x_pos, wk, bk, wv, bv, x_len, num_heads, packed=None,
                    with_stats: bool = False):
    """``mha_cross16_fwd``'s launches: bf16(x + pos) (``fk_b16_add_pos``), K
    and V on the bf16 GEMM into one (B, X, 2E) bf16 buffer (B16_PROJ16, zero
    past the attended length), then the attention in f32 on the bf16 keys,
    values and scaled queries, and the fixed-order combine
    (``fk_k3_attn16``)."""
    B, X, Cx = x_in.shape
    M, E = q.shape[1], wk.shape[1]
    H = num_heads
    hd = E // H
    _check("mha_cross16_fwd", q, x_in, wk, bk, wv, bv, x_len, H, bf16=True)
    if q.dtype != BF16 or x_in.dtype != BF16:
        raise ValueError("mha_cross16_fwd: q and x must be bfloat16")
    if not has_b16_kernels(Cx, E):
        raise NotImplementedError(f"mha_cross16_fwd: no kernel for Cx={Cx}, E={E} (each a "
                                  "multiple of 8)")
    if not has_forward(M, E, H):
        raise NotImplementedError(f"mha_cross16_fwd: no forward kernel for M={M}, E={E}, H={H}")
    wkp, wvp = k3_b16_pack(wk, wv) if packed is None else packed
    _build.check_tensors("mha_cross16_fwd", [wkp, wvp], x_in.device, bf16=True)
    _, kv, _ = _project16(x_in, x_pos, bk, bv, x_len, wkp, wvp)
    qs = (q.float() * bf16_scale(hd)).to(BF16)
    n_t = -(-X // FWD_KEY_TILE)
    f32 = dict(device=x_in.device, dtype=torch.float32)
    part_acc = torch.empty((B, n_t, H * M, hd), **f32)
    part_ml = torch.empty((B, n_t, H * M, 2), **f32)
    out = torch.empty((B, M, E), **f32)
    stats = torch.empty((B, H * M, 2), **f32) if with_stats else None
    err = _build.lib().fk_k3_attn16(kv.data_ptr(), qs.data_ptr(), x_len.data_ptr(), B, X, M, H,
                                    hd, part_acc.data_ptr(), part_ml.data_ptr(), out.data_ptr(),
                                    stats.data_ptr() if stats is not None else None,
                                    _build.stream_ptr(x_in.device))
    _build.check("fk_k3_attn16", err)
    return (out, stats) if with_stats else out


# ---------------------------------------------------------------------------
# mixed precision: the bf16 backward form (training)


def mha_cross16_bwd_reference(q, x_in, x_pos, wk, bk, wv, bv, x_len, stats, out, g, *,
                              num_heads: int):
    """Plain version of K3's bf16 backward (JAX's ``_mha_bwd`` on bf16
    operands, mha_attn.py:386-525), from the training form's saves (the rows'
    stats and the f32 output): the queries bf16(q * bf16(1/sqrt(hd))), k and
    v recomputed as the forward's; p from the stats in f32; g rounded to
    bf16 for its products; D = rowsum(g * out) in f32; dl = p (dp - D) (0 at
    keys at or past x_len) rounded to bf16, as p is for dV; dq = bf16((dl k)
    / sqrt(hd)) with the f32 scale; dK and dV rounded to bf16, their sums (the
    bias gradients) f32; dx = bf16(dK Wk^T + dV Wv^T) and dWk = bf16(x +
    pos)^T dK, dWv = x^T dV rounded to bf16.  Returns the cotangents of (q,
    x_in, x_pos, wk, bk, wv, bv), None for the constant x_pos."""
    B, X, _ = x_in.shape
    M, E = q.shape[1], wk.shape[1]
    H = num_heads
    hd = E // H
    qs = rnd(q.float() * bf16_scale(hd)).view(B, M, H, hd)
    xin = add_pos16(x_in, None if x_pos is None else x_pos.to(BF16)).float()
    wk16, wv16 = rnd(wk), rnd(wv)
    k = rnd(xin @ wk16 + bk).view(B, X, H, hd)
    v = rnd(x_in.float() @ wv16 + bv).view(B, X, H, hd)
    valid = torch.arange(X, device=x_in.device)[None, None, None, :] < x_len[:, None, None, None]
    logits = torch.einsum("bmhd,bxhd->bhmx", qs, k).masked_fill(~valid, _NEG)
    st = stats.view(B, H, M, 2)
    p = torch.exp(logits - st[..., :1]) * (1.0 / st[..., 1:].clamp_min(1e-30))
    g16 = rnd(g).view(B, M, H, hd)
    dp = torch.einsum("bmhd,bxhd->bhmx", g16, v)
    D = _row_term(g, out, H).view(B, H, M, 1)
    dl = rnd(torch.where(valid, p * (dp - D), 0.0))
    dq = rnd(torch.einsum("bhmx,bxhd->bmhd", dl, k).reshape(B, M, E) * (1.0 / math.sqrt(hd)))
    dk = torch.einsum("bhmx,bmhd->bxhd", dl, qs).reshape(B, X, E)
    dv = torch.einsum("bhmx,bmhd->bxhd", rnd(p), g16).reshape(B, X, E)
    dk16, dv16 = rnd(dk), rnd(dv)
    dx = (dk16 @ wk16.t() + dv16 @ wv16.t()).to(BF16)
    return (dq.to(BF16), dx, None, rnd(torch.einsum("bxc,bxe->ce", xin, dk16)),
            dk.sum(dim=(0, 1)), rnd(torch.einsum("bxc,bxe->ce", x_in.float(), dv16)),
            dv.sum(dim=(0, 1)))


def mha_cross16_bwd(q, x_in, x_pos, wk, bk, wv, bv, x_len, stats, out, g, *, num_heads: int,
                    packed=None):
    """K3's bf16 backward on the card (the plain version is
    ``mha_cross16_bwd_reference``)."""
    grads = _mha16_bwd_card(q, x_in, x_pos, wk, bk, wv, bv, x_len, stats, out, g, num_heads,
                            packed)
    mha_cross16_bwd.launches += 1
    return grads


mha_cross16_bwd.launches = 0


def _mha16_bwd_card(q, x_in, x_pos, wk, bk, wv, bv, x_len, stats, out, g, num_heads,
                    packed=None):
    """``mha_cross16_bwd``'s launches: bf16(x + pos), K and V recomputed on
    the bf16 GEMM (B16_PROJ16, as the forward), the attention backward
    (``fk_k3_attn_bwd16``: K3's kernel on bf16 keys, values and scaled
    queries, with JAX's roundings, writing dKV in bf16), dx = bf16(dKV [Wk |
    Wv]^T) on the bf16 GEMM (B16_PROJ16, the weights packed untransposed),
    dWk and dWv on ``fk_b16_wgrad``, dq's tile shares and the bias sums in a
    fixed order."""
    B, X, Cx = x_in.shape
    M, E = q.shape[1], wk.shape[1]
    H = num_heads
    hd = E // H
    _check("mha_cross16_bwd", q, x_in, wk, bk, wv, bv, x_len, H, bf16=True)
    if not has_b16_kernels(Cx, E):
        raise NotImplementedError(f"mha_cross16_bwd: no kernel for Cx={Cx}, E={E}")
    tile = bwd_key_tile(M, E, H)
    if tile is None:
        raise NotImplementedError(f"mha_cross16_bwd: no backward kernel for M={M}, E={E}, H={H}")
    wkp, wvp = k3_b16_pack(wk, wv) if packed is None else packed
    g = g.contiguous()
    _build.check_tensors("mha_cross16_bwd", [stats, out, g, wkp, wvp], x_in.device, bf16=True)
    D = _row_term(g, out, H).contiguous()
    xin, kv, lens = _project16(x_in, x_pos, bk, bv, x_len, wkp, wvp)
    qs = (q.float() * bf16_scale(hd)).to(BF16)
    n_slots = -(-(-(-X // tile)) // K3_SUM_GROUP) * K3_SUM_GROUP
    f32 = dict(device=x_in.device, dtype=torch.float32)
    dkv = torch.empty((B, X, 2 * E), device=x_in.device, dtype=BF16)
    part_dq = torch.zeros((B, n_slots, M * E), **f32)
    part_b = torch.zeros((B, n_slots, 2 * E), **f32)
    err = _build.lib().fk_k3_attn_bwd16(
        kv.data_ptr(), qs.data_ptr(), g.data_ptr(), stats.data_ptr(), D.data_ptr(),
        x_len.data_ptr(), B, X, M, H, hd, dkv.data_ptr(), part_dq.data_ptr(), part_b.data_ptr(),
        n_slots, tile, _build.stream_ptr(x_in.device))
    _build.check("fk_k3_attn_bwd16", err)
    del kv
    dx = torch.empty_like(x_in)
    b16_gemm(B16_PROJ16, dkv, [0], b16_pack(torch.cat([wk, wv], dim=1)), Cx, lens, dx)
    d_wk = rnd(wgrad(xin, 0, Cx, dkv, 0, E, lens)[0])
    d_wv = rnd(wgrad(x_in, 0, Cx, dkv, E, E, lens)[0])
    dq = (_grad.sum_groups(part_dq, K3_SUM_GROUP).view(B, M, E)
          * (1.0 / math.sqrt(hd))).to(BF16)
    d_b = _grad.sum_groups(part_b.view(1, B * n_slots, 2 * E), K3_SUM_GROUP)[0]
    return dq, dx, None, d_wk, d_b[:E], d_wv, d_b[E:]


class _MHA16(torch.autograd.Function):
    """K3's bf16 form for training (rate 0): the forward saves its output and
    the rows' softmax stats; the kernels on CUDA tensors, the plain versions
    on CPU ones or where ``plain``."""

    @staticmethod
    def forward(ctx, q, x_in, x_pos, wk, bk, wv, bv, x_len, cfg):
        num_heads, plain, packed = cfg
        args = (q, x_in, x_pos, wk, bk, wv, bv, x_len)
        if plain or x_in.device.type == "cpu":
            out, stats = mha_cross16_reference(*args, num_heads=num_heads, with_stats=True)
        else:
            out, stats = _mha16_fwd_card(*args, num_heads, packed, with_stats=True)
            mha_cross16_fwd.launches += 1
        ctx.cfg = cfg
        ctx.save_for_backward(*args, stats, out)
        return out

    @staticmethod
    def backward(ctx, g):
        num_heads, plain, packed = ctx.cfg
        q, x_in, x_pos, wk, bk, wv, bv, x_len, stats, out = ctx.saved_tensors
        if plain or g.device.type == "cpu":
            grads = mha_cross16_bwd_reference(q, x_in, x_pos, wk, bk, wv, bv, x_len, stats, out,
                                              g.contiguous(), num_heads=num_heads)
        else:
            grads = mha_cross16_bwd(q, x_in, x_pos, wk, bk, wv, bv, x_len, stats, out,
                                    g.contiguous(), num_heads=num_heads, packed=packed)
        return (*grads, None, None)


def mha_cross16_train(q, x_in, x_pos, wk, bk, wv, bv, x_len, *, num_heads: int, plain=False,
                      packed=None):
    """The differentiable bf16 K3 (rate 0): q, x bf16, the key positional
    term a constant (JAX's pos_grad=False)."""
    if x_pos is not None and x_pos.requires_grad:
        raise NotImplementedError("mha_cross16_train: the key positional term is a constant")
    if x_in.device.type != "cpu" and not plain:
        _build.require_backward("mha_cross16", has_backward(q.shape[1], wk.shape[1], num_heads))
    return _MHA16.apply(q.contiguous(), x_in.contiguous(), x_pos, wk, bk, wv, bv, x_len,
                        (int(num_heads), bool(plain), packed))
