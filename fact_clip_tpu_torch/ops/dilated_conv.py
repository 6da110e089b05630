"""K1: the fused MSTCN tower (dilated residual layers + out projection),
forward with in-kernel dropout, and its backward.

Replaces ``fact_clip_tpu/ops/pallas/dilated_conv.py::dilated_residual_stack``
with ``out_params``: the forward per layer (``_stack_layer``, Pallas kernel
``_stack_kernel``), the backward per layer (``_stack_bwd_layer``, kernels
``_stack_bwd_dc_kernel`` and ``_stack_bwd_dx_kernel``) and the dropout mask
replay (``dropout_mask``).  Kernels: ``csrc/mstcn.cu`` (one forward launch
per layer, the out projection fused into the last one; two backward
launches per layer) and ``csrc/grad.cu`` (the weight-gradient sums).  What
bounds them on the H100 and what the design does about it is written at the
top of the CUDA sources.

Dropout (rate > 0, on the 1x1 conv's output, every layer): the keep mask is
a counter hash of (seed, layer, b, t, c) (``dropout_mask_reference``); the
kernels and the plain version compute the same bits.  ``seeds`` is an (L,)
int32 tensor on the tower's device, one seed per layer.

Layouts follow the JAX function: ``wd`` (3, C, C) as (tap, in, out), ``w1``
(C, C) and ``ow`` (C, O) as (in, out).  Frames at or past ``lengths[b]`` read
as zeros and are written as zeros between layers; the logits of padded frames
are the bias row.  ``mstcn_stack`` is the differentiable entry.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import _build
from . import _grad

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


def dropout_mask_reference(seed, layer: int, shape, rate: float):
    """Plain version of the keep mask: (B, T, C) float32, 1/(1-rate) where
    kept, 0 where dropped; bit-equal to ``csrc/mstcn.cu``'s."""
    B, T, C = shape
    s = seed.reshape(-1)[:1].to(torch.int64) & _M32
    key = _fmix32((s + ((layer * 0x85EBCA77) & _M32)) & _M32)
    idx = torch.arange(B * T * C, device=seed.device, dtype=torch.int64) & _M32
    bits = _fmix32(_mul32(idx, 0x9E3779B9) ^ key)
    scale = torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32, device=seed.device)
    return torch.where(bits < keep_threshold(rate), scale, 0.0).view(B, T, C)


def mstcn_dropout_mask(seed, layer: int, shape, rate: float):
    """The keep mask from the kernel (CUDA) or its plain version (CPU)."""
    if seed.device.type == "cpu":
        return dropout_mask_reference(seed, layer, shape, rate)
    B, T, C = shape
    if seed.dtype != torch.int32:
        raise ValueError("mstcn_dropout_mask: seed must be int32")
    out = torch.empty((B, T, C), device=seed.device, dtype=torch.float32)
    err = _build.lib().fk_mstcn_dropout_mask(seed.data_ptr(), int(layer), keep_threshold(rate),
                                             1.0 / (1.0 - rate), out.data_ptr(), B, T, C,
                                             _build.stream_ptr(seed.device))
    _build.check("fk_mstcn_dropout_mask", err)
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


def has_backward(C: int) -> bool:
    """The largest shared-memory block of the K1 kernels (bwd_dc: GEMM
    staging + two (64, C + 4) tiles + 64 floats) fits; wider towers have no
    backward here."""
    return _build.GEMM_SMEM + 4 * (2 * 64 * (C + 4) + 64) <= _build.MAX_SMEM


def _check_layers(name, x, lengths, layers, out_w, out_b, seeds, rates):
    B, T, C = x.shape
    O = out_w.shape[1]
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


def _dropout_args(rates, seeds, i):
    """(seed pointer, layer, threshold, scale) of the forward kernel's dropout."""
    r = _rate(rates, i)
    if r <= 0.0:
        return None, 0, 0, 1.0
    return seeds[i:i + 1].data_ptr(), i, keep_threshold(r), 1.0 / (1.0 - r)


def mstcn_stack_fwd(x, lengths, layers, dilations, *, use_ln: bool, eps: float = 1e-5,
                    out_w, out_b, rates=None, seeds=None, save: bool = False):
    """The tower on the card (CUDA tensors) or its plain version (CPU tensors).

    lengths: (B,) int32 valid-frame counts.  With ``save`` (for the backward)
    it also returns each layer's input stream and ReLU activations."""
    flat = [p for layer in layers for p in layer]
    _build.no_grad_inputs("mstcn_stack_fwd", [x, out_w, out_b, *flat])
    if x.device.type == "cpu":
        return mstcn_stack_reference(x, lengths, layers, dilations, use_ln=use_ln, eps=eps,
                                     out_w=out_w, out_b=out_b, rates=rates, seeds=seeds,
                                     save=save)
    B, T, C = x.shape
    O = out_w.shape[1]
    _check_layers("mstcn_stack_fwd", x, lengths, layers, out_w, out_b, seeds, rates)

    fn = _build.lib().fk_mstcn_layer
    stream = _build.stream_ptr(x.device)
    bufs = (torch.empty_like(x), torch.empty_like(x))
    logits = torch.empty((B, T, O), device=x.device, dtype=torch.float32)
    streams, acts = [x], []
    src = x
    for i, ((wd, bd, w1, b1, gamma, beta), d) in enumerate(zip(layers, dilations)):
        last = i == len(layers) - 1
        dst = torch.empty_like(x) if save else bufs[i % 2]
        a_out = torch.empty_like(x) if save else None
        seed, li, thresh, scale = _dropout_args(rates, seeds, i)
        err = fn(src.data_ptr(), dst.data_ptr(), lengths.data_ptr(), wd.data_ptr(),
                 bd.data_ptr(), w1.data_ptr(), b1.data_ptr(), gamma.data_ptr(),
                 beta.data_ptr(), out_w.data_ptr() if last else None,
                 out_b.data_ptr() if last else None, logits.data_ptr() if last else None,
                 a_out.data_ptr() if save else None, seed, li, thresh, scale,
                 B, T, C, O, int(d), int(use_ln), float(eps), stream)
        _build.check("fk_mstcn_layer", err)
        if save:
            acts.append(a_out)
            if not last:
                streams.append(dst)
        src = dst
    mstcn_stack_fwd.launches += 1
    if save:
        return logits, streams, acts
    return logits


mstcn_stack_fwd.launches = 0


def mstcn_stack_bwd(g, streams, acts, lengths, layers, dilations, *, use_ln: bool,
                    eps: float = 1e-5, out_w, out_b, rates=None, seeds=None):
    """The tower's backward on the card, from the forward's saved streams and
    activations: (dx, [(dwd, dbd, dw1, db1, dgamma, dbeta)], dow, dob)."""
    x = streams[0]
    B, T, C = x.shape
    O = out_w.shape[1]
    _check_layers("mstcn_stack_bwd", x, lengths, layers, out_w, out_b, seeds, rates)
    if not has_backward(C):
        raise NotImplementedError(f"mstcn_stack_bwd: no backward kernel for C={C}")
    g = g.contiguous()
    _build.check_tensors("mstcn_stack_bwd", [g, *streams, *acts], x.device)
    lib = _build.lib()
    stream = _build.stream_ptr(x.device)
    nblk = B * (-(-T // 64))
    owt = out_w.t().contiguous()
    dlayers = [None] * len(layers)
    g_stream, dow, dob = None, None, None
    for i in reversed(range(len(layers))):
        wd, bd, w1, b1, gamma, beta = layers[i]
        d = int(dilations[i])
        last = i == len(layers) - 1
        dc, dh, dx = torch.empty_like(x), torch.empty_like(x), torch.empty_like(x)
        dz = torch.empty_like(x) if (use_ln or last) else None
        y_out = torch.empty_like(x) if last else None
        part_c = torch.empty((nblk, 4, C), device=x.device, dtype=torch.float32)
        part_o = torch.empty((nblk, 1, O), device=x.device, dtype=torch.float32) if last else None
        # the layer's keep mask, regenerated by the mask kernel (never stored)
        keep = (mstcn_dropout_mask(seeds[i:i + 1], i, (B, T, C), _rate(rates, i))
                if _rate(rates, i) > 0.0 else None)
        w1t = w1.t().contiguous()
        wdt = wd.transpose(1, 2).contiguous()  # (tap, out, in): the taps' transposes
        ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
        err = lib.fk_mstcn_bwd_dc(
            streams[i].data_ptr(), acts[i].data_ptr(), ptr(g_stream),
            g.data_ptr() if last else None, lengths.data_ptr(), w1.data_ptr(), w1t.data_ptr(), b1.data_ptr(),
            gamma.data_ptr(), beta.data_ptr(), owt.data_ptr(), ptr(keep), dc.data_ptr(),
            ptr(dz), dh.data_ptr(), ptr(y_out), part_c.data_ptr(), ptr(part_o),
            B, T, C, O, int(use_ln), float(eps), stream)
        _build.check("fk_mstcn_bwd_dc", err)
        gsrc = dz if dz is not None else g_stream
        err = lib.fk_mstcn_bwd_dx(dc.data_ptr(), gsrc.data_ptr(), lengths.data_ptr(),
                                  wdt.data_ptr(), dx.data_ptr(), B, T, C, d, stream)
        _build.check("fk_mstcn_bwd_dx", err)
        dwd = _grad.atb(streams[i], dc, lengths=lengths, shifts=(-d, 0, d))
        dw1 = _grad.atb(acts[i], dh)[0]
        db1, dbd, dgamma, dbeta = _grad.block_sums(part_c, 4, C)
        if last:
            dow = _grad.atb(y_out, g)[0]
            dob = _grad.block_sums(part_o, 1, O)[0]
        dlayers[i] = (dwd, dbd, dw1, db1, dgamma, dbeta)
        g_stream = dx
    mstcn_stack_bwd.launches += 1
    return g_stream, dlayers, dow, dob


mstcn_stack_bwd.launches = 0


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
    if x.device.type != "cpu":
        _build.require_backward("mstcn_stack", has_backward(x.shape[2]))
    cfg = (tuple(int(d) for d in dilations), bool(use_ln), float(eps),
           tuple(_rate(rates, i) for i in range(len(layers))))
    return _MSTCNStack.apply(x.contiguous(), lengths, out_w, out_b, seeds, cfg,
                             *[p.contiguous() for p in flat])
