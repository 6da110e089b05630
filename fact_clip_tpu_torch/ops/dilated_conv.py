"""K1: the fused MSTCN tower forward (dilated residual layers + out projection).

Replaces ``fact_clip_tpu/ops/pallas/dilated_conv.py::dilated_residual_stack``
with ``out_params`` (per-layer ``_stack_layer``, Pallas kernel
``_stack_kernel``).  Kernel: ``csrc/mstcn.cu``, one launch per layer, the out
projection fused into the last one.  What bounds it on the H100 and what the
design does about it is written at the top of the CUDA source.

Layouts follow the JAX function: ``wd`` (3, C, C) as (tap, in, out), ``w1``
(C, C) and ``ow`` (C, O) as (in, out).  Frames at or past ``lengths[b]`` read
as zeros and are written as zeros between layers; the logits of padded frames
are the bias row.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import _build


def mstcn_stack_reference(x, lengths, layers, dilations, *, use_ln: bool, eps: float = 1e-5,
                          out_w, out_b):
    """Plain PyTorch version: x (B, T, C) -> f32 logits (B, T, O).

    layers: sequence of (wd, bd, w1, b1, gamma, beta).  A grouped tower
    passes wd of shape (3, C/g, C)."""
    B, T, C = x.shape
    mask = (torch.arange(T, device=x.device)[None, :] < lengths[:, None]).to(x.dtype)[..., None]
    h = x * mask
    for (wd, bd, w1, b1, gamma, beta), d in zip(layers, dilations):
        groups = C // wd.shape[1]
        conv = F.conv1d(h.transpose(1, 2), wd.permute(2, 1, 0), bd, padding=d, dilation=d,
                        groups=groups).transpose(1, 2)
        z = torch.relu(conv) @ w1 + b1 + h
        if use_ln:
            z = F.layer_norm(z, (C,), gamma, beta, eps)
        h = z * mask
    return h @ out_w + out_b


def mstcn_stack_fwd(x, lengths, layers, dilations, *, use_ln: bool, eps: float = 1e-5,
                    out_w, out_b, rate: float = 0.0):
    """The tower on the card (CUDA tensors) or its plain version (CPU tensors).

    lengths: (B,) int32 valid-frame counts."""
    flat = [p for layer in layers for p in layer]
    _build.forward_only("mstcn_stack_fwd", [rate], [x, out_w, out_b, *flat])
    if x.device.type == "cpu":
        return mstcn_stack_reference(x, lengths, layers, dilations, use_ln=use_ln, eps=eps,
                                     out_w=out_w, out_b=out_b)
    B, T, C = x.shape
    O = out_w.shape[1]
    _build.check_tensors("mstcn_stack_fwd", [x, lengths, out_w, out_b, *flat], x.device)
    if lengths.dtype != torch.int32 or lengths.shape != (B,):
        raise ValueError("mstcn_stack_fwd: lengths must be (B,) int32")
    for wd, bd, w1, b1, gamma, beta in layers:
        if (wd.shape != (3, C, C) or w1.shape != (C, C)
                or any(p.shape != (C,) for p in (bd, b1, gamma, beta))):
            raise ValueError(f"mstcn_stack_fwd: bad layer shapes for C={C} (ungrouped only)")
    if out_w.shape != (C, O) or out_b.shape != (O,):
        raise ValueError("mstcn_stack_fwd: bad out projection shapes")

    fn = _build.lib().fk_mstcn_layer
    stream = _build.stream_ptr(x.device)
    bufs = (torch.empty_like(x), torch.empty_like(x))
    logits = torch.empty((B, T, O), device=x.device, dtype=torch.float32)
    src = x
    for i, ((wd, bd, w1, b1, gamma, beta), d) in enumerate(zip(layers, dilations)):
        dst = bufs[i % 2]
        last = i == len(layers) - 1
        err = fn(src.data_ptr(), dst.data_ptr(), lengths.data_ptr(), wd.data_ptr(),
                 bd.data_ptr(), w1.data_ptr(), b1.data_ptr(), gamma.data_ptr(),
                 beta.data_ptr(), out_w.data_ptr() if last else None,
                 out_b.data_ptr() if last else None, logits.data_ptr() if last else None,
                 B, T, C, O, int(d), int(use_ln), float(eps), stream)
        _build.check("fk_mstcn_layer", err)
        src = dst
    mstcn_stack_fwd.launches += 1
    return logits


mstcn_stack_fwd.launches = 0
