"""K2: single-head X2Y cross-attention with exposed probabilities and logits,
forward and backward.

Replaces ``fact_clip_tpu/ops/pallas/x2y_attn.py::x2y_attention`` and its two
Pallas forms, chosen at the same threshold (``X > 1024``):

* small X (keys are action tokens or segments): ``_x2y_small_x_fwd_impl``
  -> ``csrc/x2y_attn.cu``, backward ``_x2y_small_x_bwd_impl`` ->
  ``csrc/x2y_bwd.cu``.  The key/value projections and their gradients stay
  outside the kernels, as in the JAX caller; the q projection, logits,
  softmax and attend (and their backward) run inside.
* large X (keys are frames): ``_x2y_flash_fwd_impl`` ->
  ``csrc/flash_attn.cu``, backward ``_x2y_flash_bwd_impl`` ->
  ``csrc/x2y_bwd.cu``.  The q projection and its gradient stay outside, as
  in the JAX caller; the per-tile k/v projections, logits, softmax and
  attend run inside, and so does the probability pass that JAX leaves to
  XLA.

Both return (attn (B, Y, d), probs (B, Y, X), logits (B, Y, X)) in float32,
with -1e9 at keys at or past ``x_len`` in the logits; gradients into those
entries are zero.  Layouts follow the JAX function: weights (in, out);
positional terms (1 or B, N, P) added to the leading P channels of the key /
query projection inputs.  ``x2y_attention`` is the differentiable entry.
Its backward dispatches as JAX's does: the kernel when the
positional table it reduces is shared by the batch (``y_pos`` for small X,
``x_pos`` for flash), else the explicit plain backward
(``x2y_bwd_reference``, the math of ``_small_x_bwd_xla`` /
``_flash_bwd_xla``), whose launches on the card are counted apart.
"""

from __future__ import annotations

import math

import torch

from .. import _build
from . import _grad
from .pos import add_pos, kernel_pos

FLASH_MIN_KEYS = 1025  # X > 1024 takes the flash form (x2y_attn.py:704-708)
KEY_TILE = 64  # keys per block of csrc/flash_attn.cu (its BK)
_NEG = -1e9


def x2y_attention_reference(y_in, y_pos, x_in, x_pos, wk, bk, wv, bv, wq, bq, x_len):
    """Plain PyTorch version of both forms."""
    d = wq.shape[1]
    xk = add_pos(x_in, x_pos) @ wk + bk
    xv = x_in @ wv + bv
    yq = add_pos(y_in, y_pos) @ wq + bq
    logits = (yq @ xk.transpose(1, 2)) * (1.0 / math.sqrt(d))
    X = x_in.shape[1]
    valid = torch.arange(X, device=x_in.device)[None, None, :] < x_len[:, None, None]
    logits = logits.masked_fill(~valid, _NEG)
    probs = torch.softmax(logits, dim=-1)
    return probs @ xv, probs, logits


def _x2y_forward(y_in, y_pos, x_in, x_pos, wk, bk, wv, bv, wq, bq, x_len):
    """The forward kernels, dispatched on the key count as the JAX entry does."""
    fn = x2y_flash_fwd if x_in.shape[1] >= FLASH_MIN_KEYS else x2y_small_x_fwd
    return fn(y_in, y_pos, x_in, x_pos, wk, bk, wv, bv, wq, bq, x_len)


def _prologue(name, rate, y_in, y_pos, x_in, x_pos, wk, bk, wv, bv, wq, bq, x_len):
    _build.forward_only(name, [rate], [y_in, y_pos, x_in, x_pos, wk, bk, wv, bv, wq, bq])
    if x_in.device.type == "cpu":
        return True
    B, Y, Cy = y_in.shape
    _, X, Cx = x_in.shape
    d = wq.shape[1]
    if (x_in.shape[0] != B or wk.shape != (Cx, d) or wv.shape != (Cx, d) or wq.shape != (Cy, d)
            or bk.shape != (d,) or bv.shape != (d,) or bq.shape != (d,)):
        raise ValueError(f"{name}: inconsistent shapes")
    if x_len.dtype != torch.int32 or x_len.shape != (B,):
        raise ValueError(f"{name}: x_len must be (B,) int32")
    _build.check_tensors(name, [y_in, x_in, wk, bk, wv, bv, wq, bq, x_len], x_in.device)
    return False


def x2y_small_x_fwd(y_in, y_pos, x_in, x_pos, wk, bk, wv, bv, wq, bq, x_len, *,
                    rate: float = 0.0):
    """Small-X form: every query row's softmax over all X keys in one block."""
    if _prologue("x2y_small_x_fwd", rate, y_in, y_pos, x_in, x_pos, wk, bk, wv, bv, wq, bq,
                 x_len):
        return x2y_attention_reference(y_in, y_pos, x_in, x_pos, wk, bk, wv, bv, wq, bq, x_len)
    B, Y, Cy = y_in.shape
    X, d = x_in.shape[1], wq.shape[1]
    # the key/value projections run outside the kernel, as in the JAX caller;
    # the keys go in transposed, (B, d, X)
    xkt = (add_pos(x_in, x_pos) @ wk + bk).transpose(1, 2).contiguous()
    xv = (x_in @ wv + bv).contiguous()
    ypos, ypos_stride, Py = kernel_pos(y_pos, B, Y, Cy)
    _build.check_tensors("x2y_small_x_fwd", [ypos], x_in.device)
    attn = torch.empty((B, Y, d), device=x_in.device, dtype=torch.float32)
    probs = torch.empty((B, Y, X), device=x_in.device, dtype=torch.float32)
    logits = torch.empty((B, Y, X), device=x_in.device, dtype=torch.float32)
    err = _build.lib().fk_x2y_small_x(
        y_in.data_ptr(), ypos.data_ptr() if ypos is not None else None, ypos_stride, Py,
        xkt.data_ptr(), xv.data_ptr(), wq.data_ptr(), bq.data_ptr(), x_len.data_ptr(),
        attn.data_ptr(), probs.data_ptr(), logits.data_ptr(), B, Y, X, Cy, d,
        1.0 / math.sqrt(d), _build.stream_ptr(x_in.device))
    _build.check("fk_x2y_small_x", err)
    x2y_small_x_fwd.launches += 1
    return attn, probs, logits


x2y_small_x_fwd.launches = 0


def x2y_flash_fwd(y_in, y_pos, x_in, x_pos, wk, bk, wv, bv, wq, bq, x_len, *,
                  rate: float = 0.0):
    """Flash form: key tiles projected and attended in parallel, then merged."""
    if _prologue("x2y_flash_fwd", rate, y_in, y_pos, x_in, x_pos, wk, bk, wv, bv, wq, bq,
                 x_len):
        return x2y_attention_reference(y_in, y_pos, x_in, x_pos, wk, bk, wv, bv, wq, bq, x_len)
    B, M, _ = y_in.shape
    X, Cx = x_in.shape[1], x_in.shape[2]
    d = wq.shape[1]
    # the q projection runs outside the kernel, as in the JAX caller
    yq = (add_pos(y_in, y_pos) @ wq + bq).contiguous()
    logits = torch.empty((B, M, X), device=x_in.device, dtype=torch.float32)
    probs = torch.empty_like(logits)
    attn = torch.empty((B, M, d), device=x_in.device, dtype=torch.float32)
    proj_attn(x_in, x_pos, yq, wk, bk, wv, bv, x_len, num_heads=1, out=attn, logits=logits,
              probs=probs)
    x2y_flash_fwd.launches += 1
    return attn, probs, logits


x2y_flash_fwd.launches = 0


def proj_attn(x_in, x_pos, q, wk, bk, wv, bv, x_len, *, num_heads: int, out,
              logits=None, probs=None):
    """Launch csrc/flash_attn.cu (shared by K2's flash form and K3): q (B, M, E)
    attends over K = (x + pos) @ wk + bk, V = x @ wv + bv with E = num_heads * hd."""
    B, X, Cx = x_in.shape
    M, E = q.shape[1], q.shape[2]
    H = num_heads
    hd = E // H
    pos, pos_stride, Px = kernel_pos(x_pos, B, X, Cx)
    _build.check_tensors("fk_proj_attn", [q, pos, out, logits, probs], x_in.device)
    n_t = -(-X // KEY_TILE)
    part_acc = torch.empty((B, n_t, H * M, hd), device=x_in.device, dtype=torch.float32)
    part_ml = torch.empty((B, n_t, H * M, 2), device=x_in.device, dtype=torch.float32)
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    err = _build.lib().fk_proj_attn(
        x_in.data_ptr(), ptr(pos), pos_stride, Px, q.data_ptr(), wk.data_ptr(), bk.data_ptr(),
        wv.data_ptr(), bv.data_ptr(), x_len.data_ptr(), B, X, Cx, M, H, hd,
        1.0 / math.sqrt(hd), ptr(logits), ptr(probs), out.data_ptr(), part_acc.data_ptr(),
        part_ml.data_ptr(), _build.stream_ptr(x_in.device))
    _build.check("fk_proj_attn", err)


# ---------------------------------------------------------------------------
# backward

FLASH_MAX_QUERIES = 64  # csrc/x2y_bwd.cu kMaxM


def has_backward(M: int, X: int, d: int) -> bool:
    """Whether the card has a backward kernel at this shape."""
    if X >= FLASH_MIN_KEYS:
        tiles = 4 * 64 * (d + M)
        return M <= FLASH_MAX_QUERIES and _build.GEMM_SMEM + tiles <= _build.MAX_SMEM
    return _build.GEMM_SMEM + 4 * 64 * d <= _build.MAX_SMEM


def _shared(pos) -> bool:
    return pos is None or pos.dim() == 2 or pos.shape[0] == 1


def _pos_grad(d_in, pos):
    """The cotangent of a positional term from that of the stream it shifts."""
    if pos is None:
        return None
    g = d_in[..., :pos.shape[-1]]
    if pos.dim() == 2:
        return g.sum(dim=0)
    if pos.shape[0] == 1 and g.shape[0] != 1:
        return g.sum(dim=0, keepdim=True)
    return g


def x2y_bwd_reference(y_in, y_pos, x_in, x_pos, wk, bk, wv, bv, wq, bq, x_len, probs, g_attn,
                      g_probs=None, g_logits=None):
    """Explicit plain backward of both forms (the math of JAX's
    ``_small_x_bwd_xla`` and ``_flash_bwd_xla``).  Returns the cotangents of
    (y_in, y_pos, x_in, x_pos, wk, bk, wv, bv, wq, bq)."""
    d = wq.shape[1]
    xk_in = add_pos(x_in, x_pos)
    xk = xk_in @ wk + bk
    xv = x_in @ wv + bv
    yq_in = add_pos(y_in, y_pos)
    yq = yq_in @ wq + bq
    d_xv = torch.einsum("byx,byd->bxd", probs, g_attn)
    d_probs = g_attn @ xv.transpose(1, 2)
    if g_probs is not None:
        d_probs = d_probs + g_probs
    d_logits = probs * (d_probs - (d_probs * probs).sum(dim=-1, keepdim=True))
    if g_logits is not None:
        d_logits = d_logits + g_logits
    X = x_in.shape[1]
    valid = torch.arange(X, device=x_in.device)[None, None, :] < x_len[:, None, None]
    d_logits = torch.where(valid, d_logits, 0.0) * (1.0 / math.sqrt(d))
    d_yq = d_logits @ xk
    d_xk = d_logits.transpose(1, 2) @ yq
    d_yq_in = d_yq @ wq.t()
    d_xk_in = d_xk @ wk.t()
    if x_in.device.type != "cpu":
        x2y_bwd_reference.launches += 1
    return (d_yq_in, _pos_grad(d_yq_in, y_pos), d_xk_in + d_xv @ wv.t(), _pos_grad(d_xk_in, x_pos),
            torch.einsum("bxc,bxd->cd", xk_in, d_xk), d_xk.sum(dim=(0, 1)),
            torch.einsum("bxc,bxd->cd", x_in, d_xv), d_xv.sum(dim=(0, 1)),
            torch.einsum("byc,byd->cd", yq_in, d_yq), d_yq.sum(dim=(0, 1)))


x2y_bwd_reference.launches = 0  # plain backwards dispatched on the card (per-batch pos)


def _pos_like(g, pos):
    return g.view(pos.shape) if pos is not None else None


def x2y_small_x_bwd(y_in, y_pos, x_in, x_pos, wk, bk, wv, bv, wq, bq, x_len, probs, g_attn,
                    g_probs=None, g_logits=None):
    """Small-X backward: the kernel on CUDA tensors (y_pos shared by the
    batch), the plain version on CPU tensors."""
    if x_in.device.type == "cpu":
        return x2y_bwd_reference(y_in, y_pos, x_in, x_pos, wk, bk, wv, bv, wq, bq, x_len, probs,
                                 g_attn, g_probs, g_logits)
    B, Y, Cy = y_in.shape
    X, d = x_in.shape[1], wq.shape[1]
    ypos, pos_stride, Py = kernel_pos(y_pos, B, Y, Cy)
    if pos_stride or not has_backward(Y, X, d):
        raise ValueError("x2y_small_x_bwd: needs a shared y_pos and d <= 746")
    g_attn = g_attn.contiguous()
    g_probs = g_probs.contiguous() if g_probs is not None else None
    g_logits = g_logits.contiguous() if g_logits is not None else None
    _build.check_tensors("x2y_small_x_bwd", [y_in, ypos, probs, g_probs, g_logits, g_attn, wq, bq,
                                             x_len], x_in.device)
    xk_in = add_pos(x_in, x_pos)
    xk = (xk_in @ wk + bk).contiguous()
    xvt = (x_in @ wv + bv).transpose(1, 2).contiguous()
    wqt = wq.t().contiguous()
    nblk = B * (-(-Y // 64))
    dlog = torch.empty((B, Y, X), device=x_in.device, dtype=torch.float32)
    yq, dyq = (torch.empty((B, Y, d), device=x_in.device, dtype=torch.float32) for _ in range(2))
    dy = torch.empty_like(y_in)
    part = torch.empty((nblk, 1, d), device=x_in.device, dtype=torch.float32)
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    err = _build.lib().fk_x2y_sx_bwd(
        y_in.data_ptr(), ptr(ypos), pos_stride, Py, probs.data_ptr(), ptr(g_probs),
        ptr(g_logits), g_attn.data_ptr(), xk.data_ptr(), xvt.data_ptr(), wq.data_ptr(),
        wqt.data_ptr(), bq.data_ptr(), x_len.data_ptr(), dlog.data_ptr(), yq.data_ptr(),
        dyq.data_ptr(), dy.data_ptr(), part.data_ptr(), B, Y, X, Cy, d, 1.0 / math.sqrt(d),
        _build.stream_ptr(x_in.device))
    _build.check("fk_x2y_sx_bwd", err)
    d_xk = _grad.atb(dlog, yq, per_video=True)
    d_xv = _grad.atb(probs, g_attn, per_video=True)
    d_wq = _grad.atb(y_in, dyq, pos=ypos)[0]
    d_bq = _grad.block_sums(part, 1, d)[0]
    d_ypos = _pos_like(_grad.batch_sum(dy, Py), y_pos) if ypos is not None else None
    # the X side stays plain matmuls, as in the JAX caller (X is tokens or segments)
    d_xk_in = d_xk @ wk.t()
    x2y_small_x_bwd.launches += 1
    return (dy, d_ypos, d_xk_in + d_xv @ wv.t(), _pos_grad(d_xk_in, x_pos),
            torch.einsum("bxc,bxd->cd", xk_in, d_xk), d_xk.sum(dim=(0, 1)),
            torch.einsum("bxc,bxd->cd", x_in, d_xv), d_xv.sum(dim=(0, 1)), d_wq, d_bq)


x2y_small_x_bwd.launches = 0


def x2y_flash_bwd(y_in, y_pos, x_in, x_pos, wk, bk, wv, bv, wq, bq, x_len, probs, attn, g_attn,
                  g_probs=None, g_logits=None, *, need_xpos_grad: bool = True):
    """Flash backward: the kernel on CUDA tensors (x_pos shared by the
    batch), the plain version on CPU tensors."""
    if x_in.device.type == "cpu":
        return x2y_bwd_reference(y_in, y_pos, x_in, x_pos, wk, bk, wv, bv, wq, bq, x_len, probs,
                                 g_attn, g_probs, g_logits)
    B, M, _ = y_in.shape
    X, Cx = x_in.shape[1], x_in.shape[2]
    d = wq.shape[1]
    xpos, pos_stride, Px = kernel_pos(x_pos, B, X, Cx)
    if pos_stride or not has_backward(M, X, d):
        raise ValueError("x2y_flash_bwd: needs a shared x_pos, M <= 64 and d <= 640")
    g_attn = g_attn.contiguous()
    g_probs = g_probs.contiguous() if g_probs is not None else None
    g_logits = g_logits.contiguous() if g_logits is not None else None
    _build.check_tensors("x2y_flash_bwd", [x_in, xpos, probs, g_probs, g_logits, g_attn, wk, bk,
                                           wv, bv, x_len], x_in.device)
    yq_in = add_pos(y_in, y_pos)
    yq = (yq_in @ wq + bq).contiguous()
    # the softmax row term over all X, outside the kernel as in the JAX caller
    D = (g_attn * attn).sum(dim=-1)
    if g_probs is not None:
        D = D + (probs * g_probs).sum(dim=-1)
    D = D.contiguous()
    gattnt = g_attn.transpose(1, 2).contiguous()
    wkvt = torch.cat([wk.t(), wv.t()], dim=0).contiguous()
    nblk = B * (-(-X // 64))
    f32 = dict(device=x_in.device, dtype=torch.float32)
    xk, dxk, dxv = (torch.empty((B, X, d), **f32) for _ in range(3))
    dlogt = torch.empty((B, X, M), **f32)
    dx = torch.empty_like(x_in)
    part = torch.empty((nblk, 2, d), **f32)
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    err = _build.lib().fk_x2y_flash_bwd(
        x_in.data_ptr(), ptr(xpos), pos_stride, Px, probs.data_ptr(), ptr(g_probs),
        ptr(g_logits), g_attn.data_ptr(), gattnt.data_ptr(), yq.data_ptr(), D.data_ptr(),
        wk.data_ptr(), bk.data_ptr(), wv.data_ptr(), bv.data_ptr(), wkvt.data_ptr(),
        x_len.data_ptr(), xk.data_ptr(), dlogt.data_ptr(), dxk.data_ptr(), dxv.data_ptr(),
        dx.data_ptr(), part.data_ptr(), B, X, Cx, M, d, 1.0 / math.sqrt(d),
        _build.stream_ptr(x_in.device))
    _build.check("fk_x2y_flash_bwd", err)
    d_yq = _grad.atb(dlogt, xk, per_video=True)
    d_wk = _grad.atb(x_in, dxk, pos=xpos)[0]
    d_wv = _grad.atb(x_in, dxv)[0]
    d_bk, d_bv = _grad.block_sums(part, 2, d)
    d_xpos = None
    if x_pos is not None and need_xpos_grad:
        # sum_b dxk_in[b] = (sum_b dxk[b]) @ Wk^T: one product of the batch sum
        d_xpos = _pos_like((_grad.batch_sum(dxk, d) @ wk.t())[..., :Px], x_pos)
    # the q side stays plain matmuls, as in the JAX caller (M is the token axis)
    d_yq_in = d_yq @ wq.t()
    x2y_flash_bwd.launches += 1
    return (d_yq_in, _pos_grad(d_yq_in, y_pos), dx, d_xpos, d_wk, d_bk, d_wv, d_bv,
            torch.einsum("bmc,bmd->cd", yq_in, d_yq), d_yq.sum(dim=(0, 1)))


x2y_flash_bwd.launches = 0


class _X2Y(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y_in, y_pos, x_in, x_pos, wk, bk, wv, bv, wq, bq, x_len):
        ctx.set_materialize_grads(False)
        args = (y_in, y_pos, x_in, x_pos, wk, bk, wv, bv, wq, bq, x_len)
        fwd = x2y_attention_reference if x_in.device.type == "cpu" else _x2y_forward
        attn, probs, logits = fwd(*args)
        ctx.save_for_backward(*args, probs, attn)
        return attn, probs, logits

    @staticmethod
    def backward(ctx, g_attn, g_probs, g_logits):
        *args, probs, attn = ctx.saved_tensors
        y_in, y_pos, x_in, x_pos = args[:4]
        if g_attn is None:
            g_attn = torch.zeros_like(attn)
        flash = x_in.shape[1] >= FLASH_MIN_KEYS
        if x_in.device.type == "cpu":
            grads = x2y_bwd_reference(*args, probs, g_attn, g_probs, g_logits)
        elif flash and _shared(x_pos):
            grads = x2y_flash_bwd(*args, probs, attn, g_attn, g_probs, g_logits,
                                  need_xpos_grad=ctx.needs_input_grad[3])
        elif not flash and _shared(y_pos):
            grads = x2y_small_x_bwd(*args, probs, g_attn, g_probs, g_logits)
        else:  # per-batch positional table: JAX's own plain backward (_*_bwd_xla)
            grads = x2y_bwd_reference(*args, probs, g_attn, g_probs, g_logits)
        return (*grads, None)


def x2y_attention(y_in, y_pos, x_in, x_pos, wk, bk, wv, bv, wq, bq, x_len):
    """The X2Y entry: the kernels on CUDA tensors, the plain version on CPU
    ones, both forms chosen at the JAX threshold; differentiable."""
    args = (y_in.contiguous(), y_pos, x_in.contiguous(), x_pos, wk, bk, wv, bv, wq, bq, x_len)
    if not (torch.is_grad_enabled()
            and any(t is not None and t.requires_grad for t in args[:10])):
        if x_in.device.type == "cpu":
            return x2y_attention_reference(*args)
        return _x2y_forward(*args)
    if x_in.device.type != "cpu":
        _build.require_backward("x2y_attention", has_backward(y_in.shape[1], x_in.shape[1],
                                                              wq.shape[1]))
    return _X2Y.apply(*args)
