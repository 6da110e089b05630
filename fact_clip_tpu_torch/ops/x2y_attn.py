"""K2: single-head X2Y cross-attention with exposed probabilities and logits.

Replaces ``fact_clip_tpu/ops/pallas/x2y_attn.py::x2y_attention`` and its two
Pallas forms, chosen at the same threshold (``X > 1024``):

* small X (keys are action tokens or segments): ``_x2y_small_x_fwd_impl``
  -> ``csrc/x2y_attn.cu``.  The key/value projections stay outside the
  kernel, as in the JAX caller; the q projection, logits, softmax and attend
  run inside.
* large X (keys are frames): ``_x2y_flash_fwd_impl`` ->
  ``csrc/flash_attn.cu``.  The q projection stays outside, as in the JAX
  caller; the per-tile k/v projections, logits, softmax and attend run
  inside, and so does the probability pass that JAX leaves to XLA.

Both return (attn (B, Y, d), probs (B, Y, X), logits (B, Y, X)) in float32,
with -1e9 at keys at or past ``x_len`` in the logits.  Layouts follow the
JAX function: weights (in, out); positional terms (1 or B, N, P) added to
the leading P channels of the key / query projection inputs.
"""

from __future__ import annotations

import math

import torch

from .. import _build
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


def x2y_attention(y_in, y_pos, x_in, x_pos, wk, bk, wv, bv, wq, bq, x_len, *, rate: float = 0.0):
    """Dispatch on the key count exactly as the JAX entry does."""
    fn = x2y_flash_fwd if x_in.shape[1] >= FLASH_MIN_KEYS else x2y_small_x_fwd
    return fn(y_in, y_pos, x_in, x_pos, wk, bk, wv, bv, wq, bq, x_len, rate=rate)


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
