"""K5: the fused frame loss, class-weighted CE + clipped smoothing sums.

Replaces ``fact_clip_tpu/ops/pallas/frame_loss.py::fused_ce_smooth_sums`` and
``fused_smooth_sum``: the forward (``_fwd_impl``, Pallas ``_fwd_kernel``)
returns per video the unnormalized sums

    ce[b] = sum_t CE(x[b, t], labels[b, t]) * cweight[labels[b, t]] * mask[b, t]
    sl[b] = sum_{t, c} clip((ls[t+1] - ls[t])^2, 0, 16) * mask[b, t] * mask[b, t+1]

with ls the log-softmax over classes, and the backward (``_loss_bwd``,
``_bwd_kernel``) writes dlogits.  Kernels: ``csrc/frame_loss.cu``, the
forward over (64-row chunk, video) blocks with a second launch that adds
each video's chunk partials in chunk order, the backward one launch over
(64-row chunk, video) blocks that stage the chunk's rows and their two
neighbours in shared memory and take each staged row's log-softmax once.  The
class weights, labels and mask get no gradient (the JAX wrapper
stop-gradients the weights).  The caller normalizes (models/losses.py).
"""

from __future__ import annotations

import torch

from .. import _build

MAX_CLASSES = 512  # csrc/frame_loss.cu: 16 classes per lane


def _onehot(labels, C: int):
    return labels.long()[..., None] == torch.arange(C, device=labels.device)


def frame_loss_reference(x, labels, maskf, cweight):
    """Plain forward: (ce_sum (B,) or None when ``labels`` is None, sl_sum (B,))."""
    ls = torch.log_softmax(x, dim=-1)
    d = ((ls[:, 1:] - ls[:, :-1]) ** 2).clamp(0.0, 16.0)
    sl = (d * (maskf[:, 1:] * maskf[:, :-1])[..., None]).sum(dim=(1, 2))
    if labels is None:
        return None, sl
    onehot = _onehot(labels, x.shape[-1])
    ce = -(ls * onehot).sum(dim=-1)
    w = (onehot * cweight).sum(dim=-1)
    return (ce * w * maskf).sum(dim=1), sl


def frame_loss_bwd_reference(x, labels, maskf, cweight, g_ce, g_sl):
    """Plain backward, the arithmetic of the TPU ``_bwd_kernel``: dlogits."""
    ls = torch.log_softmax(x, dim=-1)
    diff = ls[:, 1:] - ls[:, :-1]
    pm = (maskf[:, 1:] * maskf[:, :-1])[..., None]
    g_pair = torch.where(diff * diff <= 16.0, 2.0 * g_sl[:, None, None] * diff * pm, 0.0)
    dls = torch.zeros_like(x)
    dls[:, :-1] -= g_pair
    dls[:, 1:] += g_pair
    if labels is not None and g_ce is not None:
        onehot = _onehot(labels, x.shape[-1])
        w = (onehot * cweight).sum(dim=-1)
        dls = dls - (g_ce[:, None] * w * maskf)[..., None] * onehot
    return dls - torch.exp(ls) * dls.sum(dim=-1, keepdim=True)


def _ptr(t):
    return t.data_ptr() if t is not None else None


def _check(name, x, labels, maskf, cweight):
    B, T, C = x.shape
    if C > MAX_CLASSES:
        raise ValueError(f"{name}: at most {MAX_CLASSES} classes")
    if maskf.shape != (B, T) or (labels is not None and (labels.shape != (B, T)
                                                          or labels.dtype != torch.int32)):
        raise ValueError(f"{name}: mask (B, T) float32 and labels (B, T) int32")
    _build.check_tensors(name, [x, labels, maskf, cweight], x.device)


def frame_loss_fwd(x, labels, maskf, cweight):
    """The forward kernels on CUDA tensors, the plain version on CPU ones."""
    if x.device.type == "cpu":
        return frame_loss_reference(x, labels, maskf, cweight)
    out = _frame_loss_fwd_card(x, labels, maskf, cweight)
    frame_loss_fwd.launches += 1
    return out


frame_loss_fwd.launches = 0


def _frame_loss_fwd_card(x, labels, maskf, cweight):
    """The card's call (also run on CPU tensors against a model of the
    library in the tests): one library call into one workspace that holds
    ce, sl and the partials of the per-chunk blocks."""
    _check("frame_loss_fwd", x, labels, maskf, cweight)
    B, T, C = x.shape
    lib = _build.lib()
    total, = _build.workspace(lib, "fk_frame_loss_fwd_workspace", 1, B, T)
    buf = torch.empty((total,), device=x.device, dtype=torch.float32)
    err = lib.fk_frame_loss_fwd(x.data_ptr(), _ptr(labels), maskf.data_ptr(), _ptr(cweight),
                                buf.data_ptr(), B, T, C, _build.stream_ptr(x.device))
    _build.check("fk_frame_loss_fwd", err)
    return (buf[:B] if labels is not None else None), buf[B:2 * B]


def frame_loss_bwd(x, labels, maskf, cweight, g_ce, g_sl):
    """The backward kernel on CUDA tensors, the plain version on CPU ones."""
    if x.device.type == "cpu":
        return frame_loss_bwd_reference(x, labels, maskf, cweight, g_ce, g_sl)
    dx = _frame_loss_bwd_card(x, labels, maskf, cweight, g_ce, g_sl)
    frame_loss_bwd.launches += 1
    return dx


def _frame_loss_bwd_card(x, labels, maskf, cweight, g_ce, g_sl):
    """The card's call (also run on CPU tensors against a model of the
    library in the tests): one library call, one launch over (64-row chunk,
    video) blocks, into dx."""
    _check("frame_loss_bwd", x, labels, maskf, cweight)
    B, T, C = x.shape
    g_ce = g_ce.contiguous() if (g_ce is not None and labels is not None) else None
    g_sl = g_sl.contiguous()
    dx = torch.empty_like(x)
    err = _build.lib().fk_frame_loss_bwd(x.data_ptr(), _ptr(labels), maskf.data_ptr(),
                                         _ptr(cweight), _ptr(g_ce), g_sl.data_ptr(),
                                         dx.data_ptr(), B, T, C, _build.stream_ptr(x.device))
    _build.check("fk_frame_loss_bwd", err)
    return dx


frame_loss_bwd.launches = 0


class _FrameLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, labels, maskf, cweight):
        ctx.set_materialize_grads(False)
        ce, sl = frame_loss_fwd(x, labels, maskf, cweight)
        ctx.save_for_backward(x, labels, maskf, cweight)
        return (ce if ce is not None else torch.zeros_like(sl)), sl

    @staticmethod
    def backward(ctx, g_ce, g_sl):
        x, labels, maskf, cweight = ctx.saved_tensors
        if g_sl is None:
            g_sl = torch.zeros((x.shape[0],), device=x.device, dtype=x.dtype)
        return frame_loss_bwd(x, labels, maskf, cweight, g_ce, g_sl), None, None, None


def fused_ce_smooth_sums(clogit, labels, frame_mask, cweight):
    """(ce_sum, smooth_sum) per video in one pass; cweight (>= C,)."""
    C = clogit.shape[-1]
    return _FrameLoss.apply(clogit.float().contiguous(), labels.to(torch.int32).contiguous(),
                            frame_mask.float().contiguous(),
                            cweight[:C].detach().float().contiguous())


def fused_smooth_sum(logits, frame_mask):
    """The smoothing sum alone (no CE term)."""
    return _FrameLoss.apply(logits.float().contiguous(), None,
                            frame_mask.float().contiguous(), None)[1]
