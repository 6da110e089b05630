"""K1 and K6: the fused MSTCN and MS-TCN++ towers (dilated residual layers +
out projection), forwards with in-kernel dropout, and their backwards.

Replaces ``fact_clip_tpu/ops/pallas/dilated_conv.py::dilated_residual_stack``
with ``out_params``: the forward per layer (``_stack_layer``, Pallas kernel
``_stack_kernel``) and the backward per layer (``_stack_bwd_layer``, kernels
``_stack_bwd_dc_kernel`` and ``_stack_bwd_dx_kernel``).  Kernels:
``csrc/mstcn.cu`` on the towers' GEMM (``csrc/tc_tower.cuh``: TF32 tensor
cores at f32 accuracy, 3xTF32, the weight operand packed by ``k6_pack`` once
a call): per forward layer two GEMMs (the conv3, the 1x1 with its dropout,
residual and write mask) and, with ``use_ln``, a LayerNorm row pass, then
one GEMM for the out projection; per backward layer the elementwise
``k1_dz`` (the LayerNorm backward and the keep mask re-hashed in place),
the dc and dx GEMMs and the weight-gradient products over time, whose
partials ``csrc/grad.cu`` sums in a fixed order (on the last layer also
g = g_logits Wo^T and the recomputed pre-LN output).  What bounds them on
the H100 and what the design does about it is written at the top of the
CUDA sources.  ``mstcn_dropout_mask`` (``csrc/dropout.cu``) writes one
layer's mask whole, as ``dilated_conv.py::dropout_mask`` does; the
single-layer K1's backward replays its mask with it.

Dropout (rate > 0, on the 1x1 conv's output, every layer): the keep mask is
the counter hash of ``ops/dropout.py`` with stream = layer over (B, T, C)
(``dropout_mask_reference``); the kernels and the plain version compute the
same bits.  ``seeds`` is an (L,) int32 tensor on the tower's device, one
seed per layer.

Layouts follow the JAX function: ``wd`` (3, C, C) as (tap, in, out), ``w1``
(C, C) and ``ow`` (C, O) as (in, out).  Frames at or past ``lengths[b]`` read
as zeros and are written as zeros between layers; the logits of padded frames
are the bias row.  ``mstcn_stack`` is the differentiable entry.

The single-layer K1, ``dilated_residual_layer``, replaces the JAX package's
function of that name (forward ``_forward``, Pallas kernel ``_kernel``;
custom VJP ``_dr_vjp``): one layer on every frame of [0, T), no length mask,
no out projection.  Its forward is K1's layer (``_k1_layer``) with every
length T and dropout stream 0; its backward is JAX's ``_bwd``, plain
recompute plus the regenerated mask (K1's mask kernel on the card).  No
model reaches it: the MSTCN towers run the stack, as in JAX.

K6, the MS-TCN++ tower of ``f: m2`` (two dilations a layer, d1 = 2^(L-1-i)
and d2 = 2^i), replaces ``dilated_residual2_stack`` with ``out_params``: the
forward per layer (``_stack2_layer``, kernel ``_stack2_kernel``) and the
backward per layer (``_stack2_bwd_layer``, kernels ``_stack2_bwd_dc_kernel``
and ``_stack2_bwd_dx_kernel``), in ``csrc/mstcn2.cu``: GEMMs on the TF32
tensor cores at f32 accuracy (3xTF32, the GEMM of ``csrc/tc_tower.cuh``) whose weight
operand ``k6_pack`` splits and lays out K-major once a call; two forward
launches per layer (the convs, the fuse with its epilogue) and one for the
out projection; per backward layer the dc and dx GEMMs, the elementwise
``k6_ds`` and the weight-gradient products over time, whose chunk partials
``csrc/grad.cu`` sums in a fixed order.  Without saves or dropout (serving)
the forward runs on weights folded by ``mstcn2_fold``: the fuse multiplied
into the six taps, one GEMM a layer.
Layers are (k1, b1, k2, b2, wt, wb, bf) in the JAX layout: k (3, C, C) as
(tap, in, out), the fuse weight split into its top and bottom (C, C) halves.
Per layer y = (drop(relu(c1 @ wt + c2 @ wb + bf)) + x) * mask with c1, c2
the two dilated conv3s of the masked input; its dropout is K1's mask (stream
= layer) and the caller runs the last layer at rate 0.  ``mstcn2_stack`` is
the differentiable entry.

Under mixed precision (``TPU.compute_dtype: bfloat16``) K1's and K6's bf16
forms run on the bf16 GEMM of ``csrc/tc_bf16.cu`` (``mstcn_stack16``,
``mstcn2_stack16``, with their backwards and training entries); K6's is not
folded, since JAX rounds c1 and c2 to bf16 before the fuse.  Grouped towers
under bf16 take JAX's computation outside the kernels (``mstcn_grouped16``,
``mstcn2_grouped16``).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .. import _build
from . import _grad
from .bf16 import rnd
from .dropout import check_seed, dropout_args, dropout_mask_reference, launch_mask
from .pos import kernel_pos


def mstcn_dropout_mask(seed, layer: int, shape, rate: float):
    """One layer's (B, T, C) keep mask (replaces ``dilated_conv.py::dropout_mask``):
    the mask kernel (CUDA) or its plain version (CPU)."""
    if seed.device.type == "cpu":
        return dropout_mask_reference(seed, layer, shape, rate)
    out = launch_mask(seed, layer, shape, rate)
    mstcn_dropout_mask.launches += 1
    return out


mstcn_dropout_mask.launches = 0


def _rate(rates, i) -> float:
    return float(rates[i]) if rates is not None else 0.0


def _frame_mask(x, lengths):
    T = x.shape[1]
    return (torch.arange(T, device=x.device)[None, :] < lengths[:, None]).to(x.dtype)[..., None]


def mstcn_stack_reference(x, lengths, layers, dilations, *, use_ln: bool, eps: float = 1e-5,
                          out_w, out_b, rates=None, seeds=None, save: bool = False):
    """Plain PyTorch version: x (B, T, C) -> f32 logits (B, T, O); with
    ``save`` also each layer's input stream and ReLU activations, as the
    kernel forward saves them for the backward.

    layers: sequence of (wd, bd, w1, b1, gamma, beta).  A grouped tower
    passes wd of shape (3, C/g, C)."""
    B, T, C = x.shape
    mask = _frame_mask(x, lengths)
    h = x * mask
    streams, acts = [x], []
    for i, ((wd, bd, w1, b1, gamma, beta), d) in enumerate(zip(layers, dilations)):
        groups = C // wd.shape[1]
        a = torch.relu(F.conv1d(h.transpose(1, 2), wd.permute(2, 1, 0), bd, padding=d,
                                dilation=d, groups=groups).transpose(1, 2))
        o = a @ w1 + b1
        if _rate(rates, i) > 0.0:
            o = o * dropout_mask_reference(seeds[i], i, (B, T, C), _rate(rates, i))
        z = o + h
        if use_ln:
            z = F.layer_norm(z, (C,), gamma, beta, eps)
        h = z * mask
        acts.append(a)
        streams.append(h)
    logits = h @ out_w + out_b
    if save:
        return logits, streams[:-1], acts
    return logits


def _shift(v, s: int):
    """v[:, t + s] with zeros outside [0, T)."""
    T = v.shape[1]
    if abs(s) >= T:
        return torch.zeros_like(v)
    if s >= 0:
        return F.pad(v[:, s:], (0, 0, 0, s))
    return F.pad(v[:, :T + s], (0, 0, -s, 0))


def mstcn_stack_bwd_reference(g, streams, acts, lengths, layers, dilations, *, use_ln: bool,
                              eps: float = 1e-5, out_w, out_b, rates=None, seeds=None):
    """Plain version of the tower's backward, step for step as the kernels,
    from the same saves (each layer's input stream and ReLU activations):
    g (B, T, O) logits cotangent -> (dx, [(dwd, dbd, dw1, db1, dgamma, dbeta)], dow, dob).
    Ungrouped towers only."""
    B, T, C = streams[0].shape
    valid = _frame_mask(streams[0], lengths)
    n = len(layers)

    def pieces(i):  # the layer's output before the write mask, and its keep mask
        wd, bd, w1, b1, gamma, beta = layers[i]
        km = (dropout_mask_reference(seeds[i], i, (B, T, C), _rate(rates, i))
              if _rate(rates, i) > 0.0 else None)
        o = acts[i] @ w1 + b1
        return (o * km if km is not None else o) + streams[i] * valid, km

    z_last, _ = pieces(n - 1)
    gamma, beta = layers[-1][4], layers[-1][5]
    y = (F.layer_norm(z_last, (C,), gamma, beta, eps) if use_ln else z_last) * valid
    dow = torch.einsum("btc,bto->co", y, g)
    dob = g.sum(dim=(0, 1))
    gy = g @ out_w.t()
    dlayers = [None] * n
    for i in reversed(range(n)):
        wd, bd, w1, b1, gamma, beta = layers[i]
        d, x_i, a = dilations[i], streams[i] * valid, acts[i]
        z, km = pieces(i)
        gz = gy * valid
        if use_ln:
            mean = z.mean(dim=-1, keepdim=True)
            rstd = torch.rsqrt(((z - mean) ** 2).mean(dim=-1, keepdim=True) + eps)
            xhat = (z - mean) * rstd
            dgamma = (gz * xhat).sum(dim=(0, 1))
            dbeta = gz.sum(dim=(0, 1))
            gg = gz * gamma
            dz = (gg - gg.mean(dim=-1, keepdim=True)
                  - xhat * (gg * xhat).mean(dim=-1, keepdim=True)) * rstd
        else:
            dz = gz
            dgamma = dbeta = torch.zeros_like(gamma)
        dh = dz * km if km is not None else dz
        dc = (dh @ w1.t()) * (a > 0)
        dx = sum(_shift(dc, (1 - k) * d) @ wd[k].t() for k in range(3)) + dz
        dwd = torch.stack([torch.einsum("btc,bto->co", _shift(x_i, (k - 1) * d), dc)
                           for k in range(3)])
        dlayers[i] = (dwd, dc.sum(dim=(0, 1)), torch.einsum("btc,bto->co", a, dh),
                      dh.sum(dim=(0, 1)), dgamma, dbeta)
        gy = dx * valid
    return gy, dlayers, dow, dob


def _check_layers(name, x, lengths, layers, out_w, out_b, seeds, rates):
    B, T, C = x.shape
    O = out_w.shape[1]
    if not has_tower_kernels(C, O):
        raise NotImplementedError(f"{name}: no kernel for C={C}, O={O} (C % 4, O % 4)")
    flat = [p for layer in layers for p in layer]
    _build.check_tensors(name, [x, lengths, out_w, out_b, seeds, *flat], x.device)
    if lengths.dtype != torch.int32 or lengths.shape != (B,):
        raise ValueError(f"{name}: lengths must be (B,) int32")
    for wd, bd, w1, b1, gamma, beta in layers:
        if (wd.shape != (3, C, C) or w1.shape != (C, C)
                or any(p.shape != (C,) for p in (bd, b1, gamma, beta))):
            raise ValueError(f"{name}: bad layer shapes for C={C} (ungrouped only)")
    if out_w.shape != (C, O) or out_b.shape != (O,):
        raise ValueError(f"{name}: bad out projection shapes")
    if any(_rate(rates, i) > 0.0 for i in range(len(layers))):
        if seeds is None or seeds.dtype != torch.int32 or seeds.shape != (len(layers),):
            raise ValueError(f"{name}: dropout needs (L,) int32 seeds")


def _drop(seeds, i: int, rates):
    """Layer i's in-kernel dropout arguments (stream = layer)."""
    r = _rate(rates, i)
    return dropout_args(seeds[i:i + 1] if r > 0.0 else None, i, r)


def k1_fwd_weights(layer):
    """The forward's packed weights: the conv taps (2, C, 3 Cp) (hi / lo, out,
    tap * Cp + in, Cp = k6_pad(C)) and the 1x1 (2, C, C) (hi / lo, out, in)."""
    wd, bd, w1, b1, gamma, beta = layer
    C = w1.shape[0]
    return k6_pack(wd.reshape(3 * C, C), True, segs=3), k6_pack(w1, True)


def k1_bwd_weights(layer):
    """The backward's packed weights: W1 for dc = dh W1^T (2, C, C) (hi / lo,
    in, out) and the taps for dx (2, C, 3 Cp) (hi / lo, in, tap * Cp + out)."""
    wd, bd, w1, b1, gamma, beta = layer
    return k6_pack(w1), k6_pack(torch.cat([wd[0], wd[1], wd[2]], dim=1), segs=3)


def _part(n_blocks: int, n_vec: int, C: int, device):
    """A (n, n_vec, C) buffer for per-block column sums, n = n_blocks rounded
    up to whole groups of K1_SUM_GROUP, the rows past n_blocks zero."""
    n = -(-n_blocks // K1_SUM_GROUP) * K1_SUM_GROUP
    part = torch.empty((n, n_vec, C), device=device, dtype=torch.float32)
    part[n_blocks:].zero_()
    return part


def _sums(part):
    """(n, n_vec, C) per-block column sums (``_part``) -> (n_vec, C) in two
    fixed-order stages (``_grad.sum_groups``): each group of K1_SUM_GROUP
    blocks, then the groups."""
    n, n_vec, C = part.shape
    return _grad.sum_groups(part.view(1, n, n_vec * C), K1_SUM_GROUP).view(n_vec, C)


def _k1_layer(src, lengths, layer, d: int, drop, use_ln: bool, eps: float, dst, h):
    """One layer on the tensor-core GEMM: h = relu(conv3_d(src) + bd) (zero
    past each video), dst = (h W1 + b1) * keep + src (zero past each video),
    then LayerNorm in place when ``use_ln``."""
    wd, bd, w1, b1, gamma, beta = layer
    B, T, C = src.shape
    conv, w1p = k1_fwd_weights(layer)
    _k6_gemm(_RELU, src, [[((k - 1) * d, 0) for k in range(3)]], conv, C, lengths, h,
             bias=(bd, None))
    _k6_gemm(_RESID, h, _ONE, w1p, C, lengths, dst, bias=(b1, None), res=src, drop=drop)
    if use_ln:
        err = _build.lib().fk_k1_ln(dst.data_ptr(), lengths.data_ptr(), gamma.data_ptr(),
                                    beta.data_ptr(), B, T, C, K1_LN_ROWS, float(eps),
                                    _build.stream_ptr(src.device))
        _build.check("fk_k1_ln", err)


def mstcn_stack_fwd(x, lengths, layers, dilations, *, use_ln: bool, eps: float = 1e-5,
                    out_w, out_b, rates=None, seeds=None, save: bool = False):
    """The tower on the card (CUDA tensors) or its plain version (CPU tensors).

    lengths: (B,) int32 valid-frame counts.  With ``save`` (for the backward)
    it also returns each layer's input stream and ReLU activations (zero
    past each video)."""
    flat = [p for layer in layers for p in layer]
    _build.no_grad_inputs("mstcn_stack_fwd", [x, out_w, out_b, *flat])
    if x.device.type == "cpu":
        return mstcn_stack_reference(x, lengths, layers, dilations, use_ln=use_ln, eps=eps,
                                     out_w=out_w, out_b=out_b, rates=rates, seeds=seeds,
                                     save=save)
    out = _mstcn_fwd_card(x, lengths, layers, dilations, use_ln, eps, out_w, out_b, rates, seeds,
                          save)
    mstcn_stack_fwd.launches += 1
    return out


mstcn_stack_fwd.launches = 0


def _mstcn_fwd_card(x, lengths, layers, dilations, use_ln, eps, out_w, out_b, rates, seeds,
                    save):
    """``mstcn_stack_fwd``'s launches: two GEMMs a layer (and the LN pass),
    then the out projection (CPU tensors reach it only in the tests, which
    stand a model of the kernels' C interface in for the library)."""
    B, T, C = x.shape
    O = out_w.shape[1]
    _check_layers("mstcn_stack_fwd", x, lengths, layers, out_w, out_b, seeds, rates)
    if not save:  # the stream ping-pongs; h is scratch
        bufs, h = (torch.empty_like(x), torch.empty_like(x)), torch.empty_like(x)
    logits = torch.empty((B, T, O), device=x.device, dtype=torch.float32)
    streams, acts = [x], []
    src = x
    for i, (layer, d) in enumerate(zip(layers, dilations)):
        if save:
            dst, h = torch.empty_like(x), torch.empty_like(x)
        else:
            dst = bufs[i % 2]
        _k1_layer(src, lengths, layer, int(d), _drop(seeds, i, rates), use_ln, eps, dst, h)
        if save:
            acts.append(h)
            if i < len(layers) - 1:
                streams.append(dst)
        src = dst
    _k6_gemm(_LOGITS, src, _ONE, k6_pack(out_w, True), O, lengths, logits, bias=(out_b, None))
    if save:
        return logits, streams, acts
    return logits


def mstcn_stack_bwd(g, streams, acts, lengths, layers, dilations, *, use_ln: bool,
                    eps: float = 1e-5, out_w, out_b, rates=None, seeds=None):
    """The tower's backward on the card, from the forward's saved streams and
    activations: (dx, [(dwd, dbd, dw1, db1, dgamma, dbeta)], dow, dob)."""
    out = _mstcn_bwd_card(g, streams, acts, lengths, layers, dilations, use_ln, eps, out_w, out_b,
                          rates, seeds)
    mstcn_stack_bwd.launches += 1
    return out


mstcn_stack_bwd.launches = 0


def _mstcn_bwd_card(g, streams, acts, lengths, layers, dilations, use_ln, eps, out_w, out_b,
                    rates, seeds):
    """``mstcn_stack_bwd``'s launches (CPU tensors reach it only in the
    tests, as ``_mstcn_fwd_card``)."""
    x = streams[0]
    B, T, C = x.shape
    O = out_w.shape[1]
    _check_layers("mstcn_stack_bwd", x, lengths, layers, out_w, out_b, seeds, rates)
    g = g.contiguous()
    _build.check_tensors("mstcn_stack_bwd", [g, *streams, *acts], x.device)
    lib = _build.lib()
    stream = _build.stream_ptr(x.device)
    n_dz = B * (-(-T // K6_DS_ROWS))  # k1_dz blocks
    n128 = B * (-(-T // 128))  # GEMM row tiles
    dlayers = [None] * len(layers)
    g_stream, dow, dob = None, None, None
    for i in reversed(range(len(layers))):
        wd, bd, w1, b1, gamma, beta = layers[i]
        d = int(dilations[i])
        last = i == len(layers) - 1
        x_i, h_i = streams[i], acts[i]
        drop = _drop(seeds, i, rates)
        if last:
            g_in = torch.empty_like(x)
            _k6_gemm(_MASKED, g, _ONE, k6_pack(out_w), C, lengths, g_in)
        else:
            g_in = g_stream
        z = None
        if use_ln or last:  # the layer's output before LN, as the forward formed it
            z = torch.empty_like(x)
            _k6_gemm(_RESID, h_i, _ONE, k6_pack(w1, True), C, lengths, z, bias=(b1, None),
                     res=x_i, drop=drop)
        dh = torch.empty_like(x)
        dz = torch.empty_like(x) if use_ln else None
        y_ln = torch.empty_like(x) if last and use_ln else None  # the LN'd output, for dWo
        part = _part(n_dz, 3 if use_ln else 1, C, x.device)
        part_o = _part(n_dz, 1, O, x.device) if last else None
        err = lib.fk_k1_dz(g_in.data_ptr(), _ptr(z), gamma.data_ptr(), beta.data_ptr(),
                           g.data_ptr() if last else None, lengths.data_ptr(), *drop, _ptr(dz),
                           dh.data_ptr(), _ptr(y_ln), part.data_ptr(), _ptr(part_o), B, T, C, O,
                           K6_DS_ROWS, int(use_ln), float(eps), stream)
        _build.check("fk_k1_dz", err)
        w1n, taps = k1_bwd_weights(layers[i])
        dc = torch.empty_like(x)
        part_c = torch.empty((n128, 1, C), device=x.device, dtype=torch.float32)
        _k6_gemm(_GATE, dh, _ONE, w1n, C, lengths, dc, res=h_i, part=part_c)
        dx = torch.empty_like(x)
        # tap k of the forward read x[t + (k-1)d], so its transpose reads dc[s - (k-1)d]
        _k6_gemm(_DX, dc, [[((1 - k) * d, 0) for k in range(3)]], taps, C, lengths, dx,
                 res=dz if use_ln else g_in)
        dwd = wgrad(x_i, 0, C, dc, 0, C, lengths, shifts=(-d, 0, d))
        dw1 = wgrad(h_i, 0, C, dh, 0, C, lengths)[0]
        sums = _sums(part)
        dgamma, dbeta = (sums[1], sums[2]) if use_ln else (torch.zeros_like(gamma),
                                                           torch.zeros_like(beta))
        if last:
            y = y_ln if use_ln else z  # the out projection's input
            dow = wgrad(y, 0, C, g, 0, O, lengths)[0]
            dob = _sums(part_o)[0]
        dlayers[i] = (dwd, _grad.block_sums(part_c, 1, C)[0], dw1, sums[0], dgamma, dbeta)
        g_stream = dx
    return g_stream, dlayers, dow, dob


class _MSTCNStack(torch.autograd.Function):
    """The tower with the kernels' forward and backward on the card, the
    plain ones on the CPU; both save each layer's input stream and ReLU
    activations."""

    @staticmethod
    def forward(ctx, x, lengths, out_w, out_b, seeds, cfg, *flat):
        dilations, use_ln, eps, rates = cfg
        layers = [tuple(flat[6 * i:6 * i + 6]) for i in range(len(dilations))]
        fwd = mstcn_stack_reference if x.device.type == "cpu" else mstcn_stack_fwd
        logits, streams, acts = fwd(x, lengths, layers, dilations, use_ln=use_ln, eps=eps,
                                    out_w=out_w, out_b=out_b, rates=rates, seeds=seeds,
                                    save=True)
        ctx.cfg = cfg
        ctx.save_for_backward(lengths, out_w, out_b, seeds, *flat, *streams, *acts)
        return logits

    @staticmethod
    def backward(ctx, g):
        dilations, use_ln, eps, rates = ctx.cfg
        L = len(dilations)
        lengths, out_w, out_b, seeds, *rest = ctx.saved_tensors
        flat, streams, acts = rest[:6 * L], rest[6 * L:7 * L], rest[7 * L:]
        layers = [tuple(flat[6 * i:6 * i + 6]) for i in range(L)]
        bwd = mstcn_stack_bwd_reference if g.device.type == "cpu" else mstcn_stack_bwd
        dx, dlayers, dow, dob = bwd(g.contiguous(), list(streams), list(acts), lengths, layers,
                                    dilations, use_ln=use_ln, eps=eps, out_w=out_w,
                                    out_b=out_b, rates=rates, seeds=seeds)
        return (dx, None, dow, dob, None, None, *[t for layer in dlayers for t in layer])


def mstcn_stack(x, lengths, layers, dilations, *, use_ln: bool, eps: float = 1e-5, out_w,
                out_b, rates=None, seeds=None):
    """The differentiable tower: kernels on CUDA tensors, plain on CPU ones."""
    flat = [p for layer in layers for p in layer]
    if not (torch.is_grad_enabled()
            and any(t.requires_grad for t in [x, out_w, out_b, *flat])):
        return mstcn_stack_fwd(x, lengths, layers, dilations, use_ln=use_ln, eps=eps,
                               out_w=out_w, out_b=out_b, rates=rates, seeds=seeds)
    cfg = (tuple(int(d) for d in dilations), bool(use_ln), float(eps),
           tuple(_rate(rates, i) for i in range(len(layers))))
    return _MSTCNStack.apply(x.contiguous(), lengths, out_w, out_b, seeds, cfg,
                             *[p.contiguous() for p in flat])


# ---------------------------------------------------------------------------
# the single-layer K1


def _ln_two_pass(z, gamma, beta, eps: float):
    """JAX's LayerNorm: mean, then the mean of squared deviations."""
    mean = z.mean(dim=-1, keepdim=True)
    var = ((z - mean) ** 2).mean(dim=-1, keepdim=True)
    return (z - mean) * torch.rsqrt(var + eps) * gamma + beta


def _layer_pieces(x, wd, bd, w1, b1, dilation: int):
    """(a, z_pre): the ReLU activations and the 1x1 output before dropout and
    the residual (``_reference_forward_pieces``)."""
    a = torch.relu(_conv3(x, wd, bd, dilation))
    return a, a @ w1 + b1


def dilated_residual_layer_reference(x, wd, bd, w1, b1, gamma, beta, *, dilation: int,
                                     use_ln: bool = True, eps: float = 1e-5, rate: float = 0.0,
                                     seed=None):
    """Plain PyTorch version of one layer: LN(x + drop(W1 relu(conv3_d(x)) +
    b1)) on every frame of [0, T), the taps zero outside; x masked by the
    caller; the keep mask K1's of stream 0 over (B, T, C)."""
    _, z = _layer_pieces(x, wd, bd, w1, b1, dilation)
    if rate > 0.0:
        z = z * dropout_mask_reference(seed, 0, x.shape, rate)
    z = z + x
    return _ln_two_pass(z, gamma, beta, eps) if use_ln else z


def dilated_residual_layer_fwd(x, wd, bd, w1, b1, gamma, beta, *, dilation: int,
                               use_ln: bool = True, eps: float = 1e-5, rate: float = 0.0,
                               seed=None):
    """The layer's forward: K1's layer on the tensor-core GEMM on CUDA
    tensors (every frame valid, no out projection, dropout stream 0), the
    plain version on CPU tensors."""
    _build.no_grad_inputs("dilated_residual_layer_fwd", [x, wd, bd, w1, b1, gamma, beta])
    if x.device.type == "cpu":
        return dilated_residual_layer_reference(x, wd, bd, w1, b1, gamma, beta,
                                                dilation=dilation, use_ln=use_ln, eps=eps,
                                                rate=rate, seed=seed)
    y = _dr_layer_fwd_card(x, wd, bd, w1, b1, gamma, beta, dilation, use_ln, eps, rate, seed)
    dilated_residual_layer_fwd.launches += 1
    return y


def _dr_layer_fwd_card(x, wd, bd, w1, b1, gamma, beta, dilation, use_ln, eps, rate, seed):
    """``dilated_residual_layer_fwd``'s launches (CPU tensors reach it only
    in the tests)."""
    B, T, C = x.shape
    if not has_tower_kernels(C):
        raise NotImplementedError(f"dilated_residual_layer_fwd: no kernel for C={C} (C % 4)")
    if rate > 0.0:
        check_seed("dilated_residual_layer_fwd", seed, x.device)
    _build.check_tensors("dilated_residual_layer_fwd", [x, wd, bd, w1, b1, gamma, beta],
                         x.device)
    if (wd.shape != (3, C, C) or w1.shape != (C, C)
            or any(p.shape != (C,) for p in (bd, b1, gamma, beta))):
        raise ValueError(f"dilated_residual_layer_fwd: bad layer shapes for C={C}")
    lengths = torch.full((B,), T, dtype=torch.int32, device=x.device)
    y, h = torch.empty_like(x), torch.empty_like(x)
    _k1_layer(x, lengths, (wd, bd, w1, b1, gamma, beta), int(dilation),
              dropout_args(seed, 0, rate), use_ln, eps, y, h)
    return y


dilated_residual_layer_fwd.launches = 0


def dilated_residual_layer_bwd(g, x, wd, bd, w1, b1, gamma, beta, *, dilation: int,
                               use_ln: bool, eps: float, rate: float, seed):
    """JAX's ``_bwd``: a and z_pre recomputed in plain PyTorch from x, the
    forward's keep mask regenerated (the mask kernel on the card), then the
    LayerNorm, 1x1 and conv backwards: (dx, dwd, dbd, dw1, db1, dgamma,
    dbeta)."""
    a, z_pre = _layer_pieces(x, wd, bd, w1, b1, dilation)
    m = mstcn_dropout_mask(seed, 0, x.shape, rate) if rate > 0.0 else None
    z = (z_pre * m if m is not None else z_pre) + x
    if use_ln:
        mean = z.mean(dim=-1, keepdim=True)
        rstd = torch.rsqrt(((z - mean) ** 2).mean(dim=-1, keepdim=True) + eps)
        xhat = (z - mean) * rstd
        dgamma, dbeta = (g * xhat).sum(dim=(0, 1)), g.sum(dim=(0, 1))
        gg = g * gamma
        dz = (gg - gg.mean(dim=-1, keepdim=True)
              - xhat * (gg * xhat).mean(dim=-1, keepdim=True)) * rstd
    else:
        dgamma, dbeta, dz = torch.zeros_like(gamma), torch.zeros_like(beta), g
    dz_pre = dz * m if m is not None else dz
    dc = (dz_pre @ w1.t()) * (a > 0)
    d = int(dilation)
    dx = dz + sum(_shift(dc, (1 - k) * d) @ wd[k].t() for k in range(3))
    dwd = torch.stack([torch.einsum("btc,bto->co", _shift(x, (k - 1) * d), dc) for k in range(3)])
    return (dx, dwd, dc.sum(dim=(0, 1)), torch.einsum("btc,bto->co", a, dz_pre),
            dz_pre.sum(dim=(0, 1)), dgamma, dbeta)


class _DilatedResidualLayer(torch.autograd.Function):
    """The layer with its kernel forward on the card (the plain one on the
    CPU) and JAX's recompute backward."""

    @staticmethod
    def forward(ctx, x, wd, bd, w1, b1, gamma, beta, seed, cfg):
        dilation, use_ln, eps, rate = cfg
        ctx.cfg = cfg
        ctx.save_for_backward(x, wd, bd, w1, b1, gamma, beta, seed)
        return dilated_residual_layer_fwd(x, wd, bd, w1, b1, gamma, beta, dilation=dilation,
                                          use_ln=use_ln, eps=eps, rate=rate,
                                          seed=seed if rate > 0.0 else None)

    @staticmethod
    def backward(ctx, g):
        dilation, use_ln, eps, rate = ctx.cfg
        x, wd, bd, w1, b1, gamma, beta, seed = ctx.saved_tensors
        grads = dilated_residual_layer_bwd(g.contiguous(), x, wd, bd, w1, b1, gamma, beta,
                                           dilation=dilation, use_ln=use_ln, eps=eps, rate=rate,
                                           seed=seed)
        return (*grads, None, None)


def dilated_residual_layer(x, wd, bd, w1, b1, gamma, beta, *, dilation: int, use_ln: bool = True,
                           eps: float = 1e-5, rate: float = 0.0, seed=None):
    """One differentiable dilated residual layer (replaces
    ``dilated_conv.py::dilated_residual_layer``, forward ``_forward``, VJP
    ``_dr_vjp``): x (B, T, C) already masked by the caller, wd (3, C, C) as
    (tap, in, out), w1 (C, C) as (in, out), gamma / beta (C,), seed a (1,)
    int32 tensor when rate > 0.  Returns LN(x + drop(W1 relu(conv3_d(x)) +
    b1)) (B, T, C) on every frame."""
    if seed is None:
        seed = torch.zeros((1,), dtype=torch.int32, device=x.device)
    params = [p.contiguous() for p in (wd, bd, w1, b1, gamma, beta)]
    return _DilatedResidualLayer.apply(x.contiguous(), *params, seed,
                                       (int(dilation), bool(use_ln), float(eps), float(rate)))


# ---------------------------------------------------------------------------
# K6: the MS-TCN++ tower


def _conv3(x, k, b, d: int):
    """SAME dilated conv3 of (B, T, C) with k (3, C/g, C) as (tap, in, out)."""
    return F.conv1d(x.transpose(1, 2), k.permute(2, 1, 0), b, padding=d, dilation=d,
                    groups=x.shape[2] // k.shape[1]).transpose(1, 2)


def mstcn2_stack_reference(x, lengths, layers, dil_pairs, *, out_w, out_b, rates=None,
                           seeds=None, save: bool = False):
    """Plain PyTorch version: x (B, T, C) -> f32 logits (B, T, O); with
    ``save`` also each layer's input stream, [c1 | c2] (B, T, 2C) and ReLU
    output before dropout, as the kernel forward saves them.  A grouped
    tower passes k of shape (3, C/g, C)."""
    B, T, C = x.shape
    mask = _frame_mask(x, lengths)
    y = x
    streams, cs, hs = [x], [], []
    for i, ((k1, b1, k2, b2, wt, wb, bf), (d1, d2)) in enumerate(zip(layers, dil_pairs)):
        xm = y * mask
        c1, c2 = _conv3(xm, k1, b1, d1), _conv3(xm, k2, b2, d2)
        h = torch.relu(c1 @ wt + c2 @ wb + bf)
        o = h * dropout_mask_reference(seeds[i], i, (B, T, C), _rate(rates, i)) \
            if _rate(rates, i) > 0.0 else h
        y = (o + xm) * mask
        cs.append(torch.cat([c1, c2], dim=-1))
        hs.append(h)
        streams.append(y)
    logits = y @ out_w + out_b
    if save:
        return logits, streams[:-1], cs, hs
    return logits


def mstcn2_stack_bwd_reference(g, streams, cs, hs, lengths, layers, dil_pairs, *, out_w,
                               out_b, rates=None, seeds=None):
    """Plain version of the tower's backward, step for step as the kernels,
    from the same saves: g (B, T, O) logits cotangent ->
    (dx, [(dk1, db1, dk2, db2, dwt, dwb, dbf)], dow, dob)."""
    B, T, C = streams[0].shape
    valid = _frame_mask(streams[0], lengths)
    n = len(layers)

    def keep(i):
        r = _rate(rates, i)
        return dropout_mask_reference(seeds[i], i, (B, T, C), r) if r > 0.0 else None

    km = keep(n - 1)
    y = ((hs[-1] * km if km is not None else hs[-1]) + streams[-1] * valid) * valid
    dow = torch.einsum("btc,bto->co", y, g)
    dob = g.sum(dim=(0, 1))
    gy = g @ out_w.t()
    dlayers = [None] * n
    for i in reversed(range(n)):
        k1, b1, k2, b2, wt, wb, bf = layers[i]
        d1, d2 = dil_pairs[i]
        x_i = streams[i] * valid
        gz = gy * valid
        km = keep(i)
        ds = (gz * km if km is not None else gz) * (hs[i] > 0)
        dc1, dc2 = ds @ wt.t(), ds @ wb.t()
        dx = gz + sum(_shift(dc, (1 - k) * d) @ kw[k].t()
                      for dc, kw, d in ((dc1, k1, d1), (dc2, k2, d2)) for k in range(3))
        dk1, dk2 = (torch.stack([torch.einsum("btc,bto->co", _shift(x_i, (k - 1) * d), dc)
                                 for k in range(3)]) for dc, d in ((dc1, d1), (dc2, d2)))
        c1, c2 = cs[i][..., :C], cs[i][..., C:]
        dlayers[i] = (dk1, dc1.sum(dim=(0, 1)), dk2, dc2.sum(dim=(0, 1)),
                      torch.einsum("btc,bto->co", c1, ds), torch.einsum("btc,bto->co", c2, ds),
                      ds.sum(dim=(0, 1)))
        gy = dx * valid
    return gy, dlayers, dow, dob


# The tensor-core design (csrc/mstcn2.cu on csrc/tc_gemm.cuh): 128 x 128
# output tiles, K in steps of 32 floats through three TMA stages; the
# weight-gradient products (both towers') sum chunks of K6_CHUNK frames of one
# video per partial.  768 against 512, four runs each in one call (H100 80GB
# HBM3, 700 W): K1's flagship backward 5.066-5.110 ms (a fourth run 6.459)
# against 5.323-5.889, Breakfast's K6 backward 16.495-16.560 against
# 16.771-16.911, epic's 9.588-9.685 against 10.264-10.310.
K6_STEP = 32
K6_CHUNK = 768
K6_DS_ROWS = 16  # frames per block of the elementwise k6_ds and k1_dz
K1_LN_ROWS = 32  # frames per block of K1's LayerNorm pass
K1_SUM_GROUP = 64  # per-block column sums added a group at a time (_sums)
# the GEMM's epilogues (csrc/tc_tower.cuh::Mode): K6's, then K1's, K3's and K2's own
_MASKED, _FUSE, _FOLDED, _LOGITS, _DX, _RELU, _RESID, _GATE, _PROJ, _PROJ32 = range(10)
_ONE = [[(0, 0)]]  # one problem, one segment, no shift


def has_tower_kernels(C: int, O=None) -> bool:
    """K1's and K6's forward and backward kernels (the GEMM of
    ``csrc/tc_tower.cuh``) take this width (and out width): TMA row strides
    of 16 bytes (C % 4, O % 4).  A tap's K segment is padded to whole
    32-float steps in the pack (``k6_pack``'s ``segs``), so any such C runs;
    their shared memory is fixed by the tiles, not by C.  A width outside
    raises before any launch."""
    return C % 4 == 0 and (O is None or O % 4 == 0)


def tf32_rna(x):
    """Plain version of ``cvt.rna.tf32.f32``: x rounded to TF32's 10-bit
    mantissa, to nearest with ties away from zero, the low 13 bits zero."""
    i = x.contiguous().view(torch.int32).to(torch.int64)
    r = (((i & 0x7FFFFFFF) + 0x1000) & ~0x1FFF) | (i & 0x80000000)
    r = torch.where(r >= 2 ** 31, r - 2 ** 32, r)
    return r.to(torch.int32).view(torch.float32).view(x.shape)


def tf32_split(w):
    """The 3xTF32 split (hi, lo): hi = tf32(w), lo = tf32(w - hi)."""
    hi = tf32_rna(w)
    return hi, tf32_rna(w - hi)


def k6_pad(C: int) -> int:
    """The K values a segment of C channels takes in a packed weight of
    several segments: C rounded up to whole 32-float K steps."""
    return -(-C // K6_STEP) * K6_STEP


def k6_pack(w, transpose: bool = False, out=None, segs: int = 1):
    """(2, N, Kd): the TF32 hi and lo parts of w (N, K), or of w^T (N = w's
    columns), K-major, as the towers' GEMM reads its weight operand.  With
    ``segs`` > 1, K is that many segments (a conv's taps) and each is padded
    with zeros to ``k6_pad`` of its width, Kd = segs * k6_pad(K / segs).  The
    pack kernel on CUDA tensors, its plain version on CPU ones."""
    R, S = w.shape
    N, K = (S, R) if transpose else (R, S)
    kseg = K // segs
    kpad = k6_pad(kseg) if segs > 1 else kseg
    if out is None:
        out = torch.empty((2, N, segs * kpad), device=w.device, dtype=torch.float32)
    if w.device.type == "cpu":
        parts = tf32_split(w.t() if transpose else w)
        for o, part in zip(out, parts):
            o.view(N, segs, kpad)[:, :, kseg:].zero_()
            o.view(N, segs, kpad)[:, :, :kseg].copy_(part.reshape(N, segs, kseg))
        return out
    w = w.contiguous()
    _build.check_tensors("k6_pack", [w, out], w.device)
    err = _build.lib().fk_k6_pack(w.data_ptr(), out.data_ptr(), R, S, int(transpose), kseg, kpad,
                                  _build.stream_ptr(w.device))
    _build.check("fk_k6_pack", err)
    return out


def k6_fwd_weights(layer):
    """The training form's packed weights: the convs (2, 2, C, 3 Cp) (conv,
    hi / lo, out, tap * Cp + in, Cp = k6_pad(C)) and the fuse (2, C, 2C)
    (hi / lo, out, [c1 | c2] channel)."""
    k1, b1, k2, b2, wt, wb, bf = layer
    C = wt.shape[0]
    conv = torch.empty((2, 2, C, 3 * k6_pad(C)), device=wt.device, dtype=torch.float32)
    k6_pack(k1.reshape(3 * C, C), True, out=conv[0], segs=3)
    k6_pack(k2.reshape(3 * C, C), True, out=conv[1], segs=3)
    return conv, k6_pack(torch.cat([wt, wb]), True)


def k6_bwd_weights(layer):
    """The backward's packed weights: Wf for [dc1 | dc2] = ds Wf^T (2, 2C, C)
    and the six taps for dx (2, C, 6 Cp) (hi / lo, in, tap-major out)."""
    k1, b1, k2, b2, wt, wb, bf = layer
    taps = torch.cat([k1[0], k1[1], k1[2], k2[0], k2[1], k2[2]], dim=1)
    return k6_pack(torch.cat([wt, wb])), k6_pack(taps, segs=6)


def _ptr(t):
    return t.data_ptr() if t is not None else None


def _k6_gemm(mode, a, segs, wpack, N, lengths, out, *, ldo=None, col_step=0,
             bias=(None, None), res=None, res_ld=None, res_bstride=None, out2=None, part=None,
             drop=(None, 0, 0, 1.0)):
    """One launch of the towers' GEMM (``csrc/tc_tower.cuh``, K6's, K1's and
    K3's) through its entry ``fk_k6_gemm``: per problem z,
    out[:, :, z * col_step + n] = epilogue(sum over the segments (shift, c0)
    of A[b, t + shift, c0 : c0 + kseg] @ W_z's rows of the segment), kseg the
    packed segment's width (``k6_pack``).  ``res`` sits at
    res[b * res_bstride + t * res_ld + n] (default: (B, T, N))."""
    B, T, a_ch = a.shape
    flat = [v for prob in segs for seg in prob for v in seg]
    arr = (ctypes.c_int * len(flat))(*flat)
    res_ld = N if res_ld is None else res_ld
    res_bstride = T * res_ld if res_bstride is None else res_bstride
    err = _build.lib().fk_k6_gemm(
        mode, a.data_ptr(), a_ch, len(segs), len(segs[0]), ctypes.addressof(arr),
        wpack.shape[-1] // len(segs[0]), wpack.data_ptr(), N, wpack.shape[-1], B, T,
        lengths.data_ptr(), out.data_ptr(), ldo or N, col_step, _ptr(bias[0]), _ptr(bias[1]),
        _ptr(res), res_ld, res_bstride, _ptr(out2), _ptr(part), *drop,
        _build.stream_ptr(a.device))
    _build.check("fk_k6_gemm", err)


def wgrad(A, a_c0, Ca, Bm, b_c0, Cb, lengths, shifts=(0,), *, per_video=False, chunk=K6_CHUNK):
    """sum_t A[b, t + s, a_c0 : a_c0 + Ca]^T Bm[b, t, b_c0 : b_c0 + Cb] per
    shift s (rows outside [0, lengths[b]) zero), f32: the partials over
    ``chunk`` frames of one video each (``fk_k6_wgrad`` on f32 operands,
    ``fk_b16_wgrad`` on bf16 ones) summed in a fixed order, over the batch
    -> (len(shifts), Ca, Cb), or with ``per_video`` per video -> (len(shifts),
    B, Ca, Cb)."""
    B, T, a_ch = A.shape
    n_taps = len(shifts)
    step = shifts[1] - shifts[0] if n_taps > 1 else 0
    per = -(-T // chunk)
    if Bm.dtype != A.dtype:
        raise ValueError(f"wgrad: operands of two dtypes ({A.dtype}, {Bm.dtype})")
    entry = "fk_b16_wgrad" if A.dtype == torch.bfloat16 else "fk_k6_wgrad"
    _build.check_tensors(entry, [A, Bm, lengths], A.device, bf16=A.dtype == torch.bfloat16)
    part = torch.empty((n_taps, B * per, Ca, Cb), device=A.device, dtype=torch.float32)
    err = getattr(_build.lib(), entry)(A.data_ptr(), a_ch, a_c0, Ca, Bm.data_ptr(), Bm.shape[2],
                                       b_c0, Cb, lengths.data_ptr(), shifts[0], step, n_taps,
                                       part.data_ptr(), B, T, chunk, _build.stream_ptr(A.device))
    _build.check(entry, err)
    n = Ca * Cb
    G, P = (n_taps * B, per) if per_video else (n_taps, B * per)
    out = _grad.reduce(part, G=G, P=P, pstride=n, gstride=P * n, rows=1, rstride=0, cols=n)
    return out.view(n_taps, B, Ca, Cb) if per_video else out.view(n_taps, Ca, Cb)


def _check_layers2(name, x, lengths, layers, out_w, out_b, seeds, rates):
    B, T, C = x.shape
    O = out_w.shape[1]
    flat = [p for layer in layers for p in layer]
    _build.check_tensors(name, [x, lengths, out_w, out_b, seeds, *flat], x.device)
    if lengths.dtype != torch.int32 or lengths.shape != (B,):
        raise ValueError(f"{name}: lengths must be (B,) int32")
    for k1, b1, k2, b2, wt, wb, bf in layers:
        if (k1.shape != (3, C, C) or k2.shape != (3, C, C) or wt.shape != (C, C)
                or wb.shape != (C, C) or any(p.shape != (C,) for p in (b1, b2, bf))):
            raise ValueError(f"{name}: bad layer shapes for C={C} (ungrouped only)")
    if out_w.shape != (C, O) or out_b.shape != (O,):
        raise ValueError(f"{name}: bad out projection shapes")
    if any(_rate(rates, i) > 0.0 for i in range(len(layers))):
        if seeds is None or seeds.dtype != torch.int32 or seeds.shape != (len(layers),):
            raise ValueError(f"{name}: dropout needs (L,) int32 seeds")


def mstcn2_fold_reference(layers):
    """Plain version of the fold: per layer (W6 (6C, C), bias) with W6 =
    [k1[0] wt; k1[1] wt; k1[2] wt; k2[0] wb; k2[1] wb; k2[2] wb] and bias =
    b1 wt + b2 wb + bf."""
    out = []
    for k1, b1, k2, b2, wt, wb, bf in layers:
        w6 = torch.cat([k1 @ wt, k2 @ wb]).reshape(-1, wt.shape[1])
        out.append((w6, b1 @ wt + b2 @ wb + bf))
    return out


def mstcn2_fold(layers):
    """The weights of K6's serving form, per layer: (W6 packed, bias), W6 =
    ``mstcn2_fold_reference``'s (6C, C) fold packed by ``k6_pack`` as the
    serving GEMM reads it (2, C, 6 k6_pad(C)), so that relu(c1 wt + c2 wb +
    bf) is one GEMM of the six taps.  The fold's products run on ``csrc/grad.cu`` on
    the card, the plain version on the CPU."""
    if layers[0][0].device.type == "cpu":
        return [(k6_pack(w6, True, segs=6), bias) for w6, bias in mstcn2_fold_reference(layers)]
    out = []
    for k1, b1, k2, b2, wt, wb, bf in layers:
        C = wt.shape[0]
        taps = torch.cat([k1, k2]).transpose(1, 2).contiguous()  # (6, mid, in)
        fuse = torch.stack([wt, wt, wt, wb, wb, wb])  # (6, mid, out)
        w6 = _grad.atb(taps, fuse, per_video=True).view(6 * C, C)
        bias = _grad.atb(torch.cat([b1, b2]).view(1, 2 * C, 1), torch.cat([wt, wb])[None])
        out.append((k6_pack(w6, True, segs=6), bias.view(C) + bf))
    return out


def mstcn2_stack_fwd(x, lengths, layers, dil_pairs, *, out_w, out_b, rates=None, seeds=None,
                     save: bool = False, folded=None):
    """The MS-TCN++ tower on the card (CUDA tensors) or its plain version (CPU
    tensors).  With ``save`` (for the backward) it also returns each layer's
    input stream, [c1 | c2] and ReLU output before dropout.  Without saves
    or dropout the card runs the serving form on ``folded``
    (``mstcn2_fold(layers)``, computed here when not given); a forward with
    dropout runs the training form."""
    flat = [p for layer in layers for p in layer]
    _build.no_grad_inputs("mstcn2_stack_fwd", [x, out_w, out_b, *flat])
    if x.device.type == "cpu":
        return mstcn2_stack_reference(x, lengths, layers, dil_pairs, out_w=out_w, out_b=out_b,
                                      rates=rates, seeds=seeds, save=save)
    out = _mstcn2_fwd_card(x, lengths, layers, dil_pairs, out_w, out_b, rates, seeds, save,
                           folded)
    mstcn2_stack_fwd.launches += 1
    return out


mstcn2_stack_fwd.launches = 0


def _mstcn2_fwd_card(x, lengths, layers, dil_pairs, out_w, out_b, rates, seeds, save, folded):
    """``mstcn2_stack_fwd``'s launches (CPU tensors reach it only in the
    tests, which stand a model of the kernels' C interface in for the
    library)."""
    B, T, C = x.shape
    O = out_w.shape[1]
    if not has_tower_kernels(C, O):
        raise NotImplementedError(f"mstcn2_stack_fwd: no forward kernel for C={C}, O={O}")
    _check_layers2("mstcn2_stack_fwd", x, lengths, layers, out_w, out_b, seeds, rates)

    serving = not save and all(_rate(rates, i) == 0.0 for i in range(len(layers)))
    if serving:
        folded = mstcn2_fold(layers) if folded is None else folded
        _build.check_tensors("mstcn2_stack_fwd", [t for f in folded for t in f], x.device)
    if not save:
        bufs = (torch.empty_like(x), torch.empty_like(x))
    proj = k6_pack(out_w, True)  # (2, O, C)
    logits = torch.empty((B, T, O), device=x.device, dtype=torch.float32)
    streams, cs, hs = [x], [], []
    src = x
    for i, ((k1, b1, k2, b2, wt, wb, bf), (d1, d2)) in enumerate(zip(layers, dil_pairs)):
        d1, d2 = int(d1), int(d2)
        dst = torch.empty_like(x) if save else bufs[i % 2]
        if serving:  # the folded form: the six taps of x, one GEMM
            w6p, bias = folded[i]
            segs = [[((k - 1) * d, 0) for d in (d1, d2) for k in range(3)]]
            _k6_gemm(_FOLDED, src, segs, w6p, C, lengths, dst, bias=(bias, None), res=src)
        else:
            conv, fuse = k6_fwd_weights(layers[i])
            r = _rate(rates, i)
            c_out = torch.empty((B, T, 2 * C), device=x.device, dtype=torch.float32)
            h_out = torch.empty_like(x) if save else None
            segs = [[((k - 1) * d, 0) for k in range(3)] for d in (d1, d2)]
            _k6_gemm(_MASKED, src, segs, conv, C, lengths, c_out, ldo=2 * C, col_step=C,
                     bias=(b1, b2))
            _k6_gemm(_FUSE, c_out, _ONE, fuse, C, lengths, dst, bias=(bf, None), res=src,
                     out2=h_out, drop=dropout_args(seeds[i:i + 1] if r > 0.0 else None, i, r))
            if save:
                cs.append(c_out)
                hs.append(h_out)
                if i < len(layers) - 1:
                    streams.append(dst)
        if i == len(layers) - 1:
            _k6_gemm(_LOGITS, dst, _ONE, proj, O, lengths, logits, bias=(out_b, None))
        src = dst
    if save:
        return logits, streams, cs, hs
    return logits


def mstcn2_stack_bwd(g, streams, cs, hs, lengths, layers, dil_pairs, *, out_w, out_b,
                     rates=None, seeds=None):
    """The MS-TCN++ tower's backward on the card, from the forward's saves:
    (dx, [(dk1, db1, dk2, db2, dwt, dwb, dbf)], dow, dob)."""
    out = _mstcn2_bwd_card(g, streams, cs, hs, lengths, layers, dil_pairs, out_w, out_b, rates,
                           seeds)
    mstcn2_stack_bwd.launches += 1
    return out


mstcn2_stack_bwd.launches = 0


def _mstcn2_bwd_card(g, streams, cs, hs, lengths, layers, dil_pairs, out_w, out_b, rates, seeds):
    """``mstcn2_stack_bwd``'s launches (CPU tensors reach it only in the
    tests, as ``_mstcn2_fwd_card``)."""
    x = streams[0]
    B, T, C = x.shape
    O = out_w.shape[1]
    if not has_tower_kernels(C, O):
        raise NotImplementedError(f"mstcn2_stack_bwd: no backward kernel for C={C}, O={O}")
    _check_layers2("mstcn2_stack_bwd", x, lengths, layers, out_w, out_b, seeds, rates)
    g = g.contiguous()
    _build.check_tensors("mstcn2_stack_bwd", [g, *streams, *cs, *hs], x.device)
    lib = _build.lib()
    stream = _build.stream_ptr(x.device)
    n_ds = B * (-(-T // K6_DS_ROWS))  # k6_ds blocks
    n128 = B * (-(-T // 128))  # GEMM row tiles
    gw = k6_pack(out_w)  # (2, C, O): g = g_logits Wo^T
    f32 = dict(device=x.device, dtype=torch.float32)
    dlayers = [None] * len(layers)
    g_stream, dow, dob = None, None, None
    for i in reversed(range(len(layers))):
        d1, d2 = (int(d) for d in dil_pairs[i])
        last = i == len(layers) - 1
        x_i = streams[i]
        if last:
            g_in = torch.empty_like(x)
            _k6_gemm(_MASKED, g, _ONE, gw, C, lengths, g_in)
        else:
            g_in = g_stream
        ds = torch.empty_like(x)
        y_out = torch.empty_like(x) if last else None
        part_f = torch.empty((n_ds, 1, C), **f32)
        part_o = torch.empty((n_ds, 1, O), **f32) if last else None
        seed, li, thresh, scale = dropout_args(seeds[i:i + 1] if _rate(rates, i) > 0.0 else None,
                                               i, _rate(rates, i))
        err = lib.fk_k6_ds(g_in.data_ptr(), hs[i].data_ptr(), x_i.data_ptr(),
                           g.data_ptr() if last else None, lengths.data_ptr(), seed, li, thresh,
                           scale, ds.data_ptr(), _ptr(y_out), part_f.data_ptr(), _ptr(part_o),
                           B, T, C, O, K6_DS_ROWS, stream)
        _build.check("fk_k6_ds", err)
        dcw, dxw = k6_bwd_weights(layers[i])
        dc = torch.empty((B, T, 2 * C), **f32)  # [dc1 | dc2]
        part_c = torch.empty((n128, 1, 2 * C), **f32)
        _k6_gemm(_MASKED, ds, _ONE, dcw, 2 * C, lengths, dc, part=part_c)
        dx = torch.empty_like(x)
        # tap k of the forward read x[t + (k-1)d], so its transpose reads dc[s - (k-1)d]
        segs = [[((1 - k) * d, c0) for d, c0 in ((d1, 0), (d2, C)) for k in range(3)]]
        _k6_gemm(_DX, dc, segs, dxw, C, lengths, dx, res=g_in)
        dk1 = wgrad(x_i, 0, C, dc, 0, C, lengths, shifts=(-d1, 0, d1))
        dk2 = wgrad(x_i, 0, C, dc, C, C, lengths, shifts=(-d2, 0, d2))
        dwf = wgrad(cs[i], 0, 2 * C, ds, 0, C, lengths)[0]
        dbf = _grad.block_sums(part_f, 1, C)[0]
        db = _grad.block_sums(part_c, 1, 2 * C)[0]
        if last:
            dow = wgrad(y_out, 0, C, g, 0, O, lengths)[0]
            dob = _grad.block_sums(part_o, 1, O)[0]
        dlayers[i] = (dk1, db[:C], dk2, db[C:], dwf[:C], dwf[C:], dbf)
        g_stream = dx
    return g_stream, dlayers, dow, dob


class _MSTCN2Stack(torch.autograd.Function):
    """The MS-TCN++ tower with the kernels' forward and backward on the card,
    the plain ones on the CPU; both save each layer's input stream, [c1 | c2]
    and ReLU output."""

    @staticmethod
    def forward(ctx, x, lengths, out_w, out_b, seeds, cfg, *flat):
        dil_pairs, rates = cfg
        layers = [tuple(flat[7 * i:7 * i + 7]) for i in range(len(dil_pairs))]
        fwd = mstcn2_stack_reference if x.device.type == "cpu" else mstcn2_stack_fwd
        logits, streams, cs, hs = fwd(x, lengths, layers, dil_pairs, out_w=out_w, out_b=out_b,
                                      rates=rates, seeds=seeds, save=True)
        ctx.cfg = cfg
        ctx.save_for_backward(lengths, out_w, out_b, seeds, *flat, *streams, *cs, *hs)
        return logits

    @staticmethod
    def backward(ctx, g):
        dil_pairs, rates = ctx.cfg
        L = len(dil_pairs)
        lengths, out_w, out_b, seeds, *rest = ctx.saved_tensors
        flat, saves = rest[:7 * L], rest[7 * L:]
        layers = [tuple(flat[7 * i:7 * i + 7]) for i in range(L)]
        streams, cs, hs = saves[:L], saves[L:2 * L], saves[2 * L:]
        bwd = mstcn2_stack_bwd_reference if g.device.type == "cpu" else mstcn2_stack_bwd
        dx, dlayers, dow, dob = bwd(g.contiguous(), list(streams), list(cs), list(hs), lengths,
                                    layers, dil_pairs, out_w=out_w, out_b=out_b, rates=rates,
                                    seeds=seeds)
        return (dx, None, dow, dob, None, None, *[t for layer in dlayers for t in layer])


def mstcn2_stack(x, lengths, layers, dil_pairs, *, out_w, out_b, rates=None, seeds=None,
                 folded=None):
    """The differentiable MS-TCN++ tower: kernels on CUDA tensors, plain on CPU
    ones; without gradients, the card's serving form on ``folded``."""
    flat = [p for layer in layers for p in layer]
    if not (torch.is_grad_enabled()
            and any(t.requires_grad for t in [x, out_w, out_b, *flat])):
        return mstcn2_stack_fwd(x, lengths, layers, dil_pairs, out_w=out_w, out_b=out_b,
                                rates=rates, seeds=seeds, folded=folded)
    if x.device.type != "cpu":
        _build.require_backward("mstcn2_stack", has_tower_kernels(x.shape[2], out_w.shape[1]))
    cfg = (tuple((int(a), int(b)) for a, b in dil_pairs),
           tuple(_rate(rates, i) for i in range(len(layers))))
    return _MSTCN2Stack.apply(x.contiguous(), lengths, out_w, out_b, seeds, cfg,
                              *[p.contiguous() for p in flat])


# ---------------------------------------------------------------------------
# mixed precision: the bf16 GEMM (csrc/tc_bf16.cu) and K1's bf16 form

# The bf16 GEMM's epilogues (csrc/tc_bf16.cu::Mode): K1's conv (bf16 out) and
# 1x1 with the residual (bf16 out), the logits (f32 out, every frame), the
# projections with an f32 result (K2's flash), with the product rounded to
# bf16 before the bias (K2's small-X) and with a bf16 result (K3, K6's
# convs), and K6's fuse (ReLU, then the residual; bf16 out)
B16_RELU, B16_RESID, B16_LOGITS, B16_PROJ, B16_PROJ_RND, B16_PROJ16, B16_FUSE = range(7)
B16_STEP = 64  # bf16 K values of one GEMM stage (a 128-byte row)


def b16_pad(C: int) -> int:
    """The K values a segment of C channels takes in a packed bf16 weight of
    several segments: C rounded up to whole 64-value K steps."""
    return -(-C // B16_STEP) * B16_STEP


def b16_pack(w, transpose: bool = False, segs: int = 1):
    """(N, Kd) bf16: w (N, K), or w^T (N = w's columns), rounded to bf16 and
    K-major, as the bf16 GEMM reads its weight operand; with ``segs`` > 1, K
    is that many segments (a conv's taps), each padded with zeros to
    ``b16_pad`` of its width.  A layout pass of PyTorch ops, made once and
    kept by the modules (``KernelLayout``)."""
    wt = w.t() if transpose else w
    N, K = wt.shape
    kseg = K // segs
    kpad = b16_pad(kseg) if segs > 1 else kseg
    out = torch.zeros((N, segs, kpad), device=w.device, dtype=torch.bfloat16)
    out[:, :, :kseg] = wt.reshape(N, segs, kseg).to(torch.bfloat16)
    return out.view(N, segs * kpad)


def has_b16_kernels(C: int, N=None) -> bool:
    """The bf16 GEMM takes this K width (and N): TMA row strides of 16 bytes
    (C % 8) and column pairs in the epilogue (N % 8)."""
    return C % 8 == 0 and (N is None or N % 8 == 0)


def b16_gemm(mode, a, shifts, wpack, N, lengths, out, *, kseg=None, ldo=None, col_off=0,
             bias=None, res=None, c0s=None, out2=None):
    """One launch of the bf16 GEMM (``csrc/tc_bf16.cu::fk_b16_gemm``): out[b,
    t, col_off + n] = epilogue(sum over the segments s of A[b, t + shifts[s],
    c0s[s]:] @ W's rows s * kseg : (s + 1) * kseg), A (B, T, C) bf16, W
    packed by ``b16_pack`` (kseg: its segment width, all of it by default;
    c0s: each segment's first channel of A, 0 by default); rows at or past
    ``lengths[b]`` read as zeros and are written as zeros (the logits: the
    bias row); ``res`` (B, T, N) bf16 is the residual of B16_RESID and
    B16_FUSE, ``out2`` (B, T, N) bf16 B16_FUSE's ReLU output (or None)."""
    B, T, a_ch = a.shape
    kseg = wpack.shape[-1] // len(shifts) if kseg is None else kseg
    arr = (ctypes.c_int * len(shifts))(*shifts)
    c0 = (ctypes.c_int * len(shifts))(*c0s) if c0s is not None else None
    err = _build.lib().fk_b16_gemm(
        mode, a.data_ptr(), a_ch, len(shifts), ctypes.addressof(arr),
        ctypes.addressof(c0) if c0 is not None else None, kseg, wpack.data_ptr(), N,
        wpack.shape[-1], B, T, lengths.data_ptr(), out.data_ptr(), ldo or N, col_off, _ptr(bias),
        _ptr(res), _ptr(out2), _build.stream_ptr(a.device))
    _build.check("fk_b16_gemm", err)


def b16_add_pos(x, pos):
    """bf16(x + pos) on the leading P channels (``ops/bf16.py::add_pos16``) by
    the elementwise kernel ``fk_b16_add_pos``: x (B, N, C) bf16, pos (1 or B,
    N, P) bf16; x itself where pos is None."""
    if pos is None:
        return x
    B, N, C = x.shape
    pos, pstride, P = kernel_pos(pos, B, N, C)
    out = torch.empty_like(x)
    err = _build.lib().fk_b16_add_pos(x.data_ptr(), pos.data_ptr(), pstride, P, B, N, C,
                                      out.data_ptr(), _build.stream_ptr(x.device))
    _build.check("fk_b16_add_pos", err)
    return out


def mstcn_b16_pack(layers, out_w):
    """K1's bf16 form's packed weights: per layer the conv taps (C, 3 Cp) and
    the 1x1 (C, C), then the out projection (O, C) (``b16_pack``)."""
    return ([(b16_pack(wd.reshape(-1, wd.shape[-1]), True, segs=3), b16_pack(w1, True))
             for wd, bd, w1, b1, gamma, beta in layers], b16_pack(out_w, True))


def mstcn_stack16_reference(x, lengths, layers, dilations, *, out_w, out_b, save=False):
    """Plain bf16 version of K1's tower (JAX's ``_stack_kernel`` under
    mixed precision, ``dilated_conv.py:266-308``): x (B, T, C) bf16, the
    stream bf16 between layers, per layer h = bf16(relu(conv3_d(x) + bd))
    with the three taps' f32 products added left, centre, right, then
    bf16(((h W1 + b1) + x) * mask); f32 logits bf16(stream) Wo + bo.  No
    dropout or LayerNorm (``configs.bf16_refusal``).  With ``save`` (the
    training form) also the streams, the masked input and every layer's
    output (L + 1, bf16), and each layer's bf16 ReLU output, as JAX's
    ``_stack_proj_fwd`` keeps them."""
    mask = _frame_mask(x, lengths)
    h = x * mask
    streams, acts = [h], []
    for (wd, bd, w1, b1, gamma, beta), d in zip(layers, dilations):
        hf = h.float()
        taps = wd.to(torch.bfloat16).float()
        acc = _shift(hf, -d) @ taps[0] + hf @ taps[1]
        acc = acc + _shift(hf, d) @ taps[2]
        a = torch.relu(acc + bd).to(torch.bfloat16)
        z = a.float() @ w1.to(torch.bfloat16).float() + b1 + hf
        h = (z * mask.float()).to(torch.bfloat16)
        streams.append(h)
        acts.append(a)
    logits = h.float() @ out_w.to(torch.bfloat16).float() + out_b
    return (logits, streams, acts) if save else logits


def mstcn_stack16_bwd_reference(g, streams, acts, lengths, layers, dilations, *, out_w, out_b):
    """Plain version of K1's bf16 backward (JAX's ``_stack_proj_bwd`` and
    ``_stack_bwd_layer`` on bf16 streams, ``dilated_conv.py:540-845``), from
    the training form's saves: g (B, T, O) the logits' cotangent, rounded to
    bf16 as JAX's caller rounds it; the last layer's stream cotangent dz = (g
    Wo^T) * mask in f32 (its sum db1, rounded to bf16 for the products);
    every layer dc = (dh W1^T) * (a > 0) (its f32 sum dbd, bf16 for the
    products), dx = bf16((sum_k dc[t + (1 - k) d] Wd[k]^T + dz) * mask), the
    next layer's cotangent; the weight products of bf16 operands in f32,
    rounded to bf16 (the weights were cast to bf16 before JAX's call), the
    biases f32.  Returns (dx bf16, [(dwd, dbd, dw1, db1, dgamma, dbeta)],
    dow, dob), every weight gradient f32 holding its bf16 value."""
    x0 = streams[0]
    valid = _frame_mask(x0, lengths).float()
    n = len(layers)
    glg = rnd(g)
    y = streams[n].float()
    dow = rnd(torch.einsum("btc,bto->co", y, glg))
    dob = glg.sum(dim=(0, 1))
    dz = (glg @ rnd(out_w).t()) * valid
    dh, db1, gsrc = rnd(dz), dz.sum(dim=(0, 1)), rnd(dz)
    dlayers = [None] * n
    for i in reversed(range(n)):
        wd, bd, w1, b1, gamma, beta = layers[i]
        d = int(dilations[i])
        if i < n - 1:
            dh = gsrc = g_in.float() * valid
            db1 = dh.sum(dim=(0, 1))
        a = acts[i].float()
        dc = (dh @ rnd(w1).t()) * (a > 0)
        dc16 = rnd(dc)
        taps = rnd(wd)
        dx = sum(_shift(dc16, (1 - k) * d) @ taps[k].t() for k in range(3)) + gsrc
        g_in = (dx * valid).to(torch.bfloat16)
        xi = streams[i].float() * valid
        dwd = torch.stack([torch.einsum("btc,bto->co", _shift(xi, (k - 1) * d), dc16)
                           for k in range(3)])
        dlayers[i] = (rnd(dwd), dc.sum(dim=(0, 1)), rnd(torch.einsum("btc,bto->co", a, dh)), db1,
                      torch.zeros_like(gamma), torch.zeros_like(beta))
    return g_in, dlayers, dow, dob


def mstcn_stack16(x, lengths, layers, dilations, *, out_w, out_b, packed=None, save=False):
    """K1's bf16 form: the tower on the card (CUDA tensors) or its plain
    version (CPU tensors).  x (B, T, C) bf16, lengths (B,) int32, the layers
    in JAX's layout (f32, cast here: ``packed`` is ``mstcn_b16_pack(layers,
    out_w)`` where the caller keeps it) -> f32 logits (B, T, O); with
    ``save`` (the training form) also the streams and ReLU outputs that the
    backward reads (``mstcn_stack16_reference``'s)."""
    flat = [p for layer in layers for p in layer]
    _build.no_grad_inputs("mstcn_stack16", [x, out_w, out_b, *flat])
    if x.device.type == "cpu":
        return mstcn_stack16_reference(x, lengths, layers, dilations, out_w=out_w, out_b=out_b,
                                       save=save)
    out = _mstcn16_fwd_card(x, lengths, layers, dilations, out_w, out_b, packed, save)
    mstcn_stack16.launches += 1
    return out


mstcn_stack16.launches = 0


def _mstcn16_fwd_card(x, lengths, layers, dilations, out_w, out_b, packed=None, save=False):
    """``mstcn_stack16``'s launches: per layer the conv3 (B16_RELU, three
    segments at shifts -d, 0, d) and the 1x1 with its residual (B16_RESID),
    then the logits (B16_LOGITS), the stream ping-ponging in bf16 (CPU
    tensors reach it only in the tests, which stand a model of the kernels'
    C interface in for the library)."""
    B, T, C = x.shape
    O = out_w.shape[1]
    if x.dtype != torch.bfloat16:
        raise ValueError("mstcn_stack16: x must be bfloat16")
    if not has_b16_kernels(C, O):
        raise NotImplementedError(f"mstcn_stack16: no kernel for C={C}, O={O} (C % 8, O % 8)")
    if lengths.dtype != torch.int32 or lengths.shape != (B,):
        raise ValueError("mstcn_stack16: lengths must be (B,) int32")
    for wd, bd, w1, b1, gamma, beta in layers:
        if wd.shape != (3, C, C) or w1.shape != (C, C):
            raise ValueError(f"mstcn_stack16: bad layer shapes for C={C} (ungrouped only)")
    packs, owp = mstcn_b16_pack(layers, out_w) if packed is None else packed
    _build.check_tensors("mstcn_stack16", [x, lengths, out_w, out_b, owp,
                                           *[p for layer in layers for p in layer[1::2]],
                                           *[w for pk in packs for w in pk]], x.device, bf16=True)
    bufs, h = (torch.empty_like(x), torch.empty_like(x)), torch.empty_like(x)
    src = x
    streams, acts = [], []
    if save:  # the backward's first stream is the masked input, as JAX's (b16_round masks)
        src = b16_round(x, lengths)[0]
        streams.append(src)
    for i, ((wd, bd, w1, b1, gamma, beta), d, (conv, w1p)) in enumerate(
            zip(layers, dilations, packs)):
        if save:
            dst, h = torch.empty_like(x), torch.empty_like(x)
        else:
            dst = bufs[i % 2]
        b16_gemm(B16_RELU, src, [-int(d), 0, int(d)], conv, C, lengths, h, kseg=b16_pad(C),
                 bias=bd)
        b16_gemm(B16_RESID, h, [0], w1p, C, lengths, dst, bias=b1, res=src)
        if save:
            streams.append(dst)
            acts.append(h)
        src = dst
    logits = torch.empty((B, T, O), device=x.device, dtype=torch.float32)
    b16_gemm(B16_LOGITS, src, [0], owp, O, lengths, logits, bias=out_b)
    return (logits, streams, acts) if save else logits


# ---------------------------------------------------------------------------
# the bf16 backward forms' shared launches (csrc/tc_bf16.cu)

B16_ROUND_ROWS = 16  # frames a block of fk_b16_round (its column sums' blocks)


def b16_round(src, lengths, *, gate=None, out: bool = True, sums: bool = False):
    """One launch of ``fk_b16_round``: (bf16(src * (gate > 0)) with zeros at
    frames at or past ``lengths`` (B, T, C), or None without ``out``; the
    column sums (C,) of those f32 values, before the rounding, in a fixed
    order (``_sums``), or None without ``sums``).  src (B, T, C) f32 or
    bf16, gate (B, T, C) bf16 or None."""
    B, T, C = src.shape
    o = torch.empty(src.shape, device=src.device, dtype=torch.bfloat16) if out else None
    part = _part(B * (-(-T // B16_ROUND_ROWS)), 1, C, src.device) if sums else None
    _build.check_tensors("b16_round", [src, gate, lengths], src.device, bf16=True)
    err = _build.lib().fk_b16_round(src.data_ptr(), int(src.dtype == torch.bfloat16), _ptr(gate),
                                    lengths.data_ptr(), B, T, C, B16_ROUND_ROWS, _ptr(o),
                                    _ptr(part), _build.stream_ptr(src.device))
    _build.check("fk_b16_round", err)
    return o, (_sums(part)[0] if sums else None)


def _r16(w):
    """A weight gradient rounded to bf16 (the dtype of the weight JAX's call
    took), held in f32 as the parameter's gradient."""
    return w.to(torch.bfloat16).float()


def mstcn_stack16_bwd(g, streams, acts, lengths, layers, dilations, *, out_w, out_b):
    """K1's bf16 backward on the card, from the training form's saves (the
    plain version is ``mstcn_stack16_bwd_reference``)."""
    out = _mstcn16_bwd_card(g, streams, acts, lengths, layers, dilations, out_w, out_b)
    mstcn_stack16_bwd.launches += 1
    return out


mstcn_stack16_bwd.launches = 0


def _mstcn16_bwd_card(g, streams, acts, lengths, layers, dilations, out_w, out_b):
    """``mstcn_stack16_bwd``'s launches: the logits' cotangent rounded to
    bf16, dz = g Wo^T on the bf16 GEMM (B16_PROJ, f32, zero past each video),
    then per layer from the last: dz or the incoming cotangent rounded with
    its f32 column sums (db1, ``fk_b16_round``), da = dh W1^T (B16_PROJ), dc
    = bf16(da * (a > 0)) with dbd's sums (``fk_b16_round`` gated), dx =
    bf16(sum of dc's three shifted taps Wd^T + dz) (B16_RESID, the weights
    packed untransposed), the weight products dWd (three taps), dW1 and dWo
    on ``fk_b16_wgrad`` (CPU tensors reach it only in the tests)."""
    x = streams[0]
    B, T, C = x.shape
    O = out_w.shape[1]
    if x.dtype != torch.bfloat16 or not has_b16_kernels(C, O):
        raise NotImplementedError(f"mstcn_stack16_bwd: no kernel for C={C}, O={O}")
    _build.check_tensors("mstcn_stack16_bwd", [g, *streams, *acts, lengths], x.device, bf16=True)
    n = len(layers)
    glg = g.to(torch.bfloat16).contiguous()  # JAX's caller: g.astype(x.dtype)
    full = torch.full_like(lengths, T)  # dob sums every frame's row, as JAX's kernel
    _, dob = b16_round(glg, full, out=False, sums=True)
    dow = _r16(wgrad(streams[n], 0, C, glg, 0, O, lengths)[0])
    dy = torch.empty((B, T, C), device=x.device, dtype=torch.float32)
    b16_gemm(B16_PROJ, glg, [0], b16_pack(out_w), C, lengths, dy)
    dh, db1 = b16_round(dy, lengths, sums=True)
    gsrc = dh
    dlayers = [None] * n
    for i in reversed(range(n)):
        wd, bd, w1, b1, gamma, beta = layers[i]
        d = int(dilations[i])
        if i < n - 1:
            dh = gsrc = g_in
            _, db1 = b16_round(g_in, lengths, out=False, sums=True)
        da = torch.empty((B, T, C), device=x.device, dtype=torch.float32)
        b16_gemm(B16_PROJ, dh, [0], b16_pack(w1), C, lengths, da)
        dc, dbd = b16_round(da, lengths, gate=acts[i], sums=True)
        del da
        g_in = torch.empty_like(x)
        # tap k of the forward read x[t + (k-1)d], so its transpose reads dc[s + (1-k)d]
        b16_gemm(B16_RESID, dc, [d, 0, -d], b16_pack(torch.cat([wd[0], wd[1], wd[2]], dim=1),
                                                     segs=3),
                 C, lengths, g_in, kseg=b16_pad(C), res=gsrc)
        dwd = _r16(wgrad(streams[i], 0, C, dc, 0, C, lengths, shifts=(-d, 0, d)))
        dw1 = _r16(wgrad(acts[i], 0, C, dh, 0, C, lengths)[0])
        dlayers[i] = (dwd, dbd, dw1, db1, torch.zeros_like(gamma), torch.zeros_like(beta))
    return g_in, dlayers, dow, dob


class _MSTCNStack16(torch.autograd.Function):
    """K1's bf16 form for training: the training forward (its saves) and the
    backward, the kernels' on CUDA tensors, the plain versions on CPU ones or
    where ``plain`` (the card's plain path)."""

    @staticmethod
    def forward(ctx, x, lengths, out_w, out_b, cfg, *flat):
        dilations, plain, packed = cfg
        layers = [tuple(flat[6 * i:6 * i + 6]) for i in range(len(dilations))]
        if plain or x.device.type == "cpu":
            out = mstcn_stack16_reference(x, lengths, layers, dilations, out_w=out_w,
                                          out_b=out_b, save=True)
        else:
            out = mstcn_stack16(x, lengths, layers, dilations, out_w=out_w, out_b=out_b,
                                packed=packed, save=True)
        logits, streams, acts = out
        ctx.cfg = (dilations, plain)
        ctx.save_for_backward(lengths, out_w, out_b, *flat, *streams, *acts)
        return logits

    @staticmethod
    def backward(ctx, g):
        dilations, plain = ctx.cfg
        L = len(dilations)
        lengths, out_w, out_b, *rest = ctx.saved_tensors
        flat, streams, acts = rest[:6 * L], rest[6 * L:7 * L + 1], rest[7 * L + 1:]
        layers = [tuple(flat[6 * i:6 * i + 6]) for i in range(L)]
        bwd = (mstcn_stack16_bwd_reference if plain or g.device.type == "cpu"
               else mstcn_stack16_bwd)
        dx, dlayers, dow, dob = bwd(g.contiguous(), list(streams), list(acts), lengths, layers,
                                    dilations, out_w=out_w, out_b=out_b)
        return (dx, None, dow, dob, None, *[t for layer in dlayers for t in layer])


def mstcn_stack16_train(x, lengths, layers, dilations, *, out_w, out_b, plain=False,
                        packed=None):
    """The differentiable bf16 tower (rate 0): the kernels on CUDA tensors,
    the plain versions on CPU ones or where ``plain``."""
    flat = [p for layer in layers for p in layer]
    cfg = (tuple(int(d) for d in dilations), bool(plain), packed)
    return _MSTCNStack16.apply(x.contiguous(), lengths, out_w, out_b, cfg,
                               *[p.contiguous() for p in flat])


# ---------------------------------------------------------------------------
# K6's bf16 form: the MS-TCN++ tower under mixed precision (csrc/tc_bf16.cu)


def mstcn2_b16_pack(layers, out_w):
    """K6's bf16 form's packed weights (``b16_pack``): per layer the two
    convs' taps (C, 3 Cp) each (Cp = ``b16_pad(C)``) and the fuse [Wt ; Wb]
    (C, 2C), then the out projection (O, C).  Nothing is folded: JAX rounds
    c1 and c2 to bf16 before the fuse."""
    return ([(b16_pack(k1.reshape(-1, k1.shape[-1]), True, segs=3),
              b16_pack(k2.reshape(-1, k2.shape[-1]), True, segs=3),
              b16_pack(torch.cat([wt, wb]), True))
             for k1, b1, k2, b2, wt, wb, bf in layers], b16_pack(out_w, True))


def mstcn2_stack16_reference(x, lengths, layers, dil_pairs, *, out_w, out_b, save=False):
    """Plain bf16 version of K6's tower (JAX's ``_stack2_kernel`` under mixed
    precision, ``dilated_conv.py:930-973``): x (B, T, C) bf16, masked; per
    layer c1 and c2 the two dilated conv3s of the bf16 stream (each tap's f32
    products added left, centre, right, then the f32 bias), each rounded to
    bf16; s = c1 Wt + c2 Wb + bf in f32 (Wt, Wb rounded to bf16); the stream
    bf16((relu(s) + x) * mask); f32 logits bf16(stream) Wo + bo.  Rate 0:
    bf16 trains without dropout (``configs.bf16_refusal``, ROADMAP M7 item
    5).  With ``save`` (the training form) also the streams (the masked
    input and every layer's output, L + 1), [c1 | c2] and bf16(relu(s)), all
    bf16 and zero past each video, the values that JAX's backward recomputes
    (``_stack2_bwd_dc_kernel``)."""
    mask = _frame_mask(x, lengths)
    maskf = mask.float()
    h = x * mask
    streams, cs, hs = [h], [], []
    for (k1, b1, k2, b2, wt, wb, bf), (d1, d2) in zip(layers, dil_pairs):
        hf = h.float()

        def conv(k, b, d):
            taps = k.to(torch.bfloat16).float()
            acc = _shift(hf, -d) @ taps[0] + hf @ taps[1]
            return ((acc + _shift(hf, d) @ taps[2]) + b).to(torch.bfloat16)

        c1, c2 = conv(k1, b1, int(d1)), conv(k2, b2, int(d2))
        s = c1.float() @ wt.to(torch.bfloat16).float() + c2.float() @ wb.to(torch.bfloat16).float()
        r = torch.relu(s + bf)
        h = ((r + hf) * maskf).to(torch.bfloat16)
        streams.append(h)
        cs.append(torch.cat([c1, c2], dim=-1) * mask)
        hs.append((r * maskf).to(torch.bfloat16))
    logits = h.float() @ out_w.to(torch.bfloat16).float() + out_b
    return (logits, streams, cs, hs) if save else logits


def mstcn2_stack16_bwd_reference(g, streams, cs, hs, lengths, layers, dil_pairs, *, out_w,
                                 out_b):
    """Plain version of K6's bf16 backward (JAX's ``_stack2_proj_bwd`` with
    ``_stack2_bwd_dc_kernel`` and ``_stack2_bwd_dx_kernel`` on bf16 streams,
    ``dilated_conv.py:1118-1265``, 1405-1455), from the training form's
    saves: g (B, T, O) the logits' cotangent rounded to bf16 (JAX's caller);
    the last layer's dy = (g Wo^T) * mask in f32, its rounding the residual's
    cotangent; per layer ds = g * (s > 0) (f32 on the last layer, its
    rounding for the products; the bf16 stream cotangent on the others), dbf
    its f32 sum; [dc1 | dc2] = ds [Wt ; Wb]^T in f32 (db1, db2 its f32
    sums), rounded; dx = bf16((g + the six taps of [dc1 | dc2]) * mask) (each
    conv's taps added right, centre, left), the next layer's cotangent; the
    weight products of bf16 operands in f32, rounded to bf16 (JAX's call took
    the weights in bf16), the biases f32.  Returns (dx bf16, [(dk1, db1, dk2,
    db2, dwt, dwb, dbf)], dow, dob), every weight gradient f32 holding its
    bf16 value."""
    B, T, C = streams[0].shape
    valid = _frame_mask(streams[0], lengths).float()
    n = len(layers)
    glg = rnd(g)
    dow = rnd(torch.einsum("btc,bto->co", streams[n].float(), glg))
    dob = glg.sum(dim=(0, 1))
    dy = (glg @ rnd(out_w).t()) * valid
    dlayers = [None] * n
    for i in reversed(range(n)):
        k1, b1, k2, b2, wt, wb, bf = layers[i]
        d1, d2 = (int(d) for d in dil_pairs[i])
        gate = hs[i].float() > 0
        if i == n - 1:
            gsrc, ds = rnd(dy), dy * gate
        else:
            gsrc = g_in.float() * valid
            ds = gsrc * gate
        dbf, ds16 = ds.sum(dim=(0, 1)), rnd(ds)
        dc = ds16 @ rnd(torch.cat([wt, wb])).t()
        dc16 = rnd(dc)
        dx = gsrc
        for dci, k, d in ((dc16[..., :C], rnd(k1), d1), (dc16[..., C:], rnd(k2), d2)):
            dx = dx + _shift(dci, d) @ k[0].t()
            dx = dx + dci @ k[1].t()
            dx = dx + _shift(dci, -d) @ k[2].t()
        g_in = (dx * valid).to(torch.bfloat16)
        xi = streams[i].float() * valid
        dk1, dk2 = (rnd(torch.stack([torch.einsum("btc,bto->co", _shift(xi, (k - 1) * d), dci)
                                     for k in range(3)]))
                    for dci, d in ((dc16[..., :C], d1), (dc16[..., C:], d2)))
        c = cs[i].float()
        dlayers[i] = (dk1, dc[..., :C].sum(dim=(0, 1)), dk2, dc[..., C:].sum(dim=(0, 1)),
                      rnd(torch.einsum("btc,bto->co", c[..., :C], ds16)),
                      rnd(torch.einsum("btc,bto->co", c[..., C:], ds16)), dbf)
    return g_in, dlayers, dow, dob


def mstcn2_stack16(x, lengths, layers, dil_pairs, *, out_w, out_b, packed=None, save=False):
    """K6's bf16 form: the MS-TCN++ tower on the card (CUDA tensors) or its
    plain version (CPU tensors).  x (B, T, C) bf16, lengths (B,) int32, the
    layers in JAX's layout (f32, cast here: ``packed`` is
    ``mstcn2_b16_pack(layers, out_w)`` where the caller keeps it) -> f32
    logits (B, T, O); with ``save`` (the training form) also the streams,
    [c1 | c2] and ReLU outputs that the backward reads
    (``mstcn2_stack16_reference``'s)."""
    flat = [p for layer in layers for p in layer]
    _build.no_grad_inputs("mstcn2_stack16", [x, out_w, out_b, *flat])
    if x.device.type == "cpu":
        return mstcn2_stack16_reference(x, lengths, layers, dil_pairs, out_w=out_w, out_b=out_b,
                                        save=save)
    out = _mstcn2_16_fwd_card(x, lengths, layers, dil_pairs, out_w, out_b, packed, save)
    mstcn2_stack16.launches += 1
    return out


mstcn2_stack16.launches = 0


def _mstcn2_16_fwd_card(x, lengths, layers, dil_pairs, out_w, out_b, packed=None, save=False):
    """``mstcn2_stack16``'s launches: per layer c1 and c2 (B16_PROJ16, three
    segments at shifts -d, 0, d each, into the halves of one (B, T, 2C) bf16
    buffer), the fuse with its ReLU, residual and write mask (B16_FUSE, the
    ReLU output saved where ``save``), then the logits (B16_LOGITS), the
    stream ping-ponging in bf16 (CPU tensors reach it only in the tests,
    which stand a model of the kernels' C interface in for the library)."""
    B, T, C = x.shape
    O = out_w.shape[1]
    if x.dtype != torch.bfloat16:
        raise ValueError("mstcn2_stack16: x must be bfloat16")
    if not has_b16_kernels(C, O):
        raise NotImplementedError(f"mstcn2_stack16: no kernel for C={C}, O={O} (C % 8, O % 8)")
    if lengths.dtype != torch.int32 or lengths.shape != (B,):
        raise ValueError("mstcn2_stack16: lengths must be (B,) int32")
    for k1, b1, k2, b2, wt, wb, bf in layers:
        if (k1.shape != (3, C, C) or k2.shape != (3, C, C) or wt.shape != (C, C)
                or wb.shape != (C, C)):
            raise ValueError(f"mstcn2_stack16: bad layer shapes for C={C} (ungrouped only)")
    packs, owp = mstcn2_b16_pack(layers, out_w) if packed is None else packed
    _build.check_tensors("mstcn2_stack16", [x, lengths, out_w, out_b, owp,
                                            *[p for layer in layers for p in layer[1::2]],
                                            *[w for pk in packs for w in pk]], x.device, bf16=True)
    kseg = b16_pad(C)
    bufs = (torch.empty_like(x), torch.empty_like(x))
    c = torch.empty((B, T, 2 * C), device=x.device, dtype=torch.bfloat16)
    src, h = x, None
    streams, cs, hs = [], [], []
    if save:  # the backward's first stream is the masked input, as JAX's (b16_round masks)
        src = b16_round(x, lengths)[0]
        streams.append(src)
    for i, ((k1, b1, k2, b2, wt, wb, bf), (d1, d2), (w1p, w2p, wfp)) in enumerate(
            zip(layers, dil_pairs, packs)):
        d1, d2 = int(d1), int(d2)
        if save:
            dst, h = torch.empty_like(x), torch.empty_like(x)
            c = torch.empty((B, T, 2 * C), device=x.device, dtype=torch.bfloat16)
        else:
            dst = bufs[i % 2]
        b16_gemm(B16_PROJ16, src, [-d1, 0, d1], w1p, C, lengths, c, kseg=kseg, ldo=2 * C,
                 bias=b1)
        b16_gemm(B16_PROJ16, src, [-d2, 0, d2], w2p, C, lengths, c, kseg=kseg, ldo=2 * C,
                 col_off=C, bias=b2)
        b16_gemm(B16_FUSE, c, [0], wfp, C, lengths, dst, bias=bf, res=src, out2=h)
        if save:
            streams.append(dst)
            cs.append(c)
            hs.append(h)
        src = dst
    logits = torch.empty((B, T, O), device=x.device, dtype=torch.float32)
    b16_gemm(B16_LOGITS, src, [0], owp, O, lengths, logits, bias=out_b)
    return (logits, streams, cs, hs) if save else logits


def mstcn2_stack16_bwd(g, streams, cs, hs, lengths, layers, dil_pairs, *, out_w, out_b):
    """K6's bf16 backward on the card, from the training form's saves (the
    plain version is ``mstcn2_stack16_bwd_reference``)."""
    out = _mstcn2_16_bwd_card(g, streams, cs, hs, lengths, layers, dil_pairs, out_w, out_b)
    mstcn2_stack16_bwd.launches += 1
    return out


mstcn2_stack16_bwd.launches = 0


def _mstcn2_16_bwd_card(g, streams, cs, hs, lengths, layers, dil_pairs, out_w, out_b):
    """``mstcn2_stack16_bwd``'s launches: the logits' cotangent rounded to
    bf16 (dob's sums over every frame), dWo on ``fk_b16_wgrad``, dy = g Wo^T
    (B16_PROJ, f32, zero past each video) rounded to the residual's
    cotangent; then per layer from the last: ds = dy or the incoming
    cotangent gated by the saved ReLU output and rounded, with dbf's f32
    sums (``fk_b16_round``), [dc1 | dc2] = ds [Wt ; Wb]^T (B16_PROJ, one
    launch of N = 2C) rounded with db1's and db2's sums, dx = bf16(the six
    taps of [dc1 | dc2] + the residual's cotangent) (B16_RESID, six segments
    at their shifts and first channels), the weight products dk1, dk2 (three
    taps each) and [dWt ; dWb] on ``fk_b16_wgrad`` (CPU tensors reach it
    only in the tests)."""
    x = streams[0]
    B, T, C = x.shape
    O = out_w.shape[1]
    if x.dtype != torch.bfloat16 or not has_b16_kernels(C, O):
        raise NotImplementedError(f"mstcn2_stack16_bwd: no kernel for C={C}, O={O}")
    _build.check_tensors("mstcn2_stack16_bwd", [g, *streams, *cs, *hs, lengths], x.device,
                         bf16=True)
    n = len(layers)
    f32 = dict(device=x.device, dtype=torch.float32)
    glg = g.to(torch.bfloat16).contiguous()  # JAX's caller: g.astype(x.dtype)
    full = torch.full_like(lengths, T)  # dob sums every frame's row, as JAX's kernel
    _, dob = b16_round(glg, full, out=False, sums=True)
    dow = _r16(wgrad(streams[n], 0, C, glg, 0, O, lengths)[0])
    dy = torch.empty((B, T, C), **f32)
    b16_gemm(B16_PROJ, glg, [0], b16_pack(out_w), C, lengths, dy)
    gsrc = b16_round(dy, lengths)[0]  # the last layer's residual: bf16(dy) (JAX's dz)
    ds, dbf = b16_round(dy, lengths, gate=hs[n - 1], sums=True)
    del dy
    kseg = b16_pad(C)
    dlayers = [None] * n
    for i in reversed(range(n)):
        k1, b1, k2, b2, wt, wb, bf = layers[i]
        d1, d2 = (int(d) for d in dil_pairs[i])
        if i < n - 1:
            gsrc = g_in
            ds, dbf = b16_round(g_in, lengths, gate=hs[i], sums=True)
        dc32 = torch.empty((B, T, 2 * C), **f32)
        b16_gemm(B16_PROJ, ds, [0], b16_pack(torch.cat([wt, wb])), 2 * C, lengths, dc32)
        dc, db = b16_round(dc32, lengths, sums=True)
        del dc32
        g_in = torch.empty_like(x)
        # tap k of the forward read x[t + (k-1)d], so its transpose reads dc[s + (1-k)d]
        taps = b16_pack(torch.cat([k1[0], k1[1], k1[2], k2[0], k2[1], k2[2]], dim=1), segs=6)
        b16_gemm(B16_RESID, dc, [d1, 0, -d1, d2, 0, -d2], taps, C, lengths, g_in, kseg=kseg,
                 res=gsrc, c0s=[0, 0, 0, C, C, C])
        dk1 = _r16(wgrad(streams[i], 0, C, dc, 0, C, lengths, shifts=(-d1, 0, d1)))
        dk2 = _r16(wgrad(streams[i], 0, C, dc, C, C, lengths, shifts=(-d2, 0, d2)))
        dwf = _r16(wgrad(cs[i], 0, 2 * C, ds, 0, C, lengths)[0])
        dlayers[i] = (dk1, db[:C], dk2, db[C:], dwf[:C], dwf[C:], dbf)
    return g_in, dlayers, dow, dob


class _MSTCN2Stack16(torch.autograd.Function):
    """K6's bf16 form for training: the training forward (its saves) and the
    backward, the kernels' on CUDA tensors, the plain versions on CPU ones or
    where ``plain`` (the card's plain path)."""

    @staticmethod
    def forward(ctx, x, lengths, out_w, out_b, cfg, *flat):
        dil_pairs, plain, packed = cfg
        layers = [tuple(flat[7 * i:7 * i + 7]) for i in range(len(dil_pairs))]
        fwd = (mstcn2_stack16_reference if plain or x.device.type == "cpu"
               else functools.partial(mstcn2_stack16, packed=packed))
        logits, streams, cs, hs = fwd(x, lengths, layers, dil_pairs, out_w=out_w, out_b=out_b,
                                      save=True)
        ctx.cfg = (dil_pairs, plain)
        ctx.save_for_backward(lengths, out_w, out_b, *flat, *streams, *cs, *hs)
        return logits

    @staticmethod
    def backward(ctx, g):
        dil_pairs, plain = ctx.cfg
        L = len(dil_pairs)
        lengths, out_w, out_b, *rest = ctx.saved_tensors
        flat, saves = rest[:7 * L], rest[7 * L:]
        layers = [tuple(flat[7 * i:7 * i + 7]) for i in range(L)]
        streams, cs, hs = saves[:L + 1], saves[L + 1:2 * L + 1], saves[2 * L + 1:]
        bwd = (mstcn2_stack16_bwd_reference if plain or g.device.type == "cpu"
               else mstcn2_stack16_bwd)
        dx, dlayers, dow, dob = bwd(g.contiguous(), list(streams), list(cs), list(hs), lengths,
                                    layers, dil_pairs, out_w=out_w, out_b=out_b)
        return (dx, None, dow, dob, None, *[t for layer in dlayers for t in layer])


def mstcn2_stack16_train(x, lengths, layers, dil_pairs, *, out_w, out_b, plain=False,
                         packed=None):
    """The differentiable bf16 MS-TCN++ tower (rate 0): the kernels on CUDA
    tensors, the plain versions on CPU ones or where ``plain``."""
    flat = [p for layer in layers for p in layer]
    cfg = (tuple((int(a), int(b)) for a, b in dil_pairs), bool(plain), packed)
    return _MSTCN2Stack16.apply(x.contiguous(), lengths, out_w, out_b, cfg,
                                *[p.contiguous() for p in flat])


# ---------------------------------------------------------------------------
# grouped towers under mixed precision: JAX computes them outside any kernel


def mstcn_grouped16(x, lengths, layers, dilations, *, out_w, out_b):
    """JAX's MSTCN tower of unfused layers under mixed precision (the
    grouped towers, ``layers.py:290-331`` and 413-421; no LayerNorm:
    ``configs.bf16_refusal``): per layer xm = x * mask (bf16), a =
    relu(bf16(conv3_d(xm)) + bd) (XLA's bf16 convolution, rounded, then the
    f32 bias), z = bf16(bf16(a) W1) + b1, x = bf16(xm + z); f32 logits
    bf16(x) Wo + bo.  Differentiable PyTorch operations: autograd rounds the
    cotangents of the bf16 tensors, as JAX's."""
    mask = _frame_mask(x, lengths)
    h = x
    for (wd, bd, w1, b1, gamma, beta), d in zip(layers, dilations):
        xm = h * mask
        a = torch.relu(rnd(_conv3(xm.float(), rnd(wd), None, int(d))) + bd)
        z = rnd(rnd(a) @ rnd(w1)) + b1
        h = (xm.float() + z).to(torch.bfloat16)
    return h.float() @ rnd(out_w) + out_b


def mstcn2_grouped16(x, lengths, layers, dil_pairs, *, out_w, out_b):
    """JAX's MS-TCN++ tower outside the kernel under mixed precision (the
    grouped towers, ``layers.py:494-513``): per layer fm = f * mask (bf16),
    c = bf16([bf16(conv3_d1(fm)) + b1 | bf16(conv3_d2(fm)) + b2]) (XLA's
    bf16 convolutions, rounded before the f32 biases), h = relu(bf16(c Wf) +
    bf), f = bf16(bf16(h) + f) (no write mask); f32 logits f Wo + bo, Wo
    rounded to bf16.  Differentiable PyTorch operations, as
    ``mstcn_grouped16``."""
    mask = _frame_mask(x, lengths)
    f = x
    for (k1, b1, k2, b2, wt, wb, bf), (d1, d2) in zip(layers, dil_pairs):
        fm = (f * mask).float()
        c = torch.cat([rnd(_conv3(fm, rnd(k1), None, int(d1))) + b1,
                       rnd(_conv3(fm, rnd(k2), None, int(d2))) + b2], dim=-1)
        h = torch.relu(rnd(rnd(c) @ rnd(torch.cat([wt, wb]))) + bf)
        f = (rnd(h) + f.float()).to(torch.bfloat16)
    return f.float() @ rnd(out_w) + out_b
