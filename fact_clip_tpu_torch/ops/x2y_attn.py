"""K2: single-head X2Y cross-attention with exposed probabilities and logits,
forward and backward.

Replaces ``fact_clip_tpu/ops/pallas/x2y_attn.py::x2y_attention`` and its two
Pallas forms, chosen at the same threshold (``X > 1024``):

* small X (keys are action tokens or segments): ``_x2y_small_x_fwd_impl``
  -> one library call (``csrc/x2y_attn.cu::fk_x2y_sx_fwd``): y + y_pos and
  [x + x_pos | x] by an elementwise pass, yq = (y + y_pos) Wq + bq and the
  key/value projection [xk | xv] (outside the TPU kernel, in its caller) on
  the towers' 3xTF32 GEMM (``csrc/sx_attn.cuh``), then the logits, softmax
  and attend per (tile of 8-32 query rows, video) in f32; backward
  ``_x2y_small_x_bwd_impl`` -> one call (``csrc/x2y_bwd.cu::fk_x2y_sx_bwd``):
  yq and [xk | xv] recomputed, the attention terms per tile (dlogits, dyq,
  dbq's shares), dy, dWq, dxk and dxv on the same core.  The X side's
  gradients stay plain matmuls, as in the JAX caller.
* large X (keys are frames): ``_x2y_flash_fwd_impl`` -> K3's split at one
  head, one library call (``csrc/flash_attn.cu::fk_x2y_flash_fwd``): the
  key's positional table and [xk | xv] on the towers' 3xTF32 GEMM (epilogue
  kProj), then the logits, softmax partials and attend per (group of query
  rows, 64-key tile, video) in f32 and the fixed-order combine, which also
  writes the probabilities that JAX leaves to XLA; backward
  ``_x2y_flash_bwd_impl`` -> the projection [xk | xv] recomputed on the same
  GEMM (``mha_attn._project``), the attention terms per 64-key tile
  (``csrc/x2y_bwd.cu``), dx and the weight products on the same core.  The
  q projection and its gradient stay outside, as in the JAX caller.

Both return (attn (B, Y, d), probs (B, Y, X), logits (B, Y, X)) in float32,
with -1e9 at keys at or past ``x_len`` in the logits; gradients into those
entries are zero.  A video with no valid key (x_len = 0) attends uniformly to
every frame, as JAX's does.  Layouts follow the JAX function: weights (in, out);
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
from .bf16 import BF16, add_pos16, mm, rnd
from .dilated_conv import (_MASKED, _ONE, B16_PROJ, B16_PROJ16, B16_PROJ_RND, K6_CHUNK, _k6_gemm,
                           b16_add_pos, b16_gemm, b16_pack, b16_round, has_b16_kernels, k6_pack,
                           wgrad)
from .mha_attn import _check_strides, _project, attended_lengths, k3_pack
from .pos import add_pos, kernel_pos, pos_grad

FLASH_MIN_KEYS = 1025  # X > 1024 takes the flash form (x2y_attn.py:704-708)
FLASH_ROW_GROUP = 32  # query rows at most per block of the flash forward's attention
# keys per block of the flash attention kernels, both directions
# (csrc/flash_attn.cu kFlashKeys, csrc/x2y_bwd.cu kFT)
FLASH_KEY_TILE = 64
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
    """Small-X form: the projections on the tensor cores, then every query
    row's softmax over all X keys in one block of its tile."""
    if _prologue("x2y_small_x_fwd", rate, y_in, y_pos, x_in, x_pos, wk, bk, wv, bv, wq, bq,
                 x_len):
        return x2y_attention_reference(y_in, y_pos, x_in, x_pos, wk, bk, wv, bv, wq, bq, x_len)
    out = _x2y_small_x_fwd_card(y_in, y_pos, x_in, x_pos, wk, bk, wv, bv, wq, bq, x_len)
    x2y_small_x_fwd.launches += 1
    return out


x2y_small_x_fwd.launches = 0


def _x2y_small_x_fwd_card(y_in, y_pos, x_in, x_pos, wk, bk, wv, bv, wq, bq, x_len,
                          inspect=None):
    """``x2y_small_x_fwd``'s launches, one library call (CPU tensors reach it
    only in the tests, which stand a model of the kernels' C interface in for
    the library): the prep, the packs, yq and [xk | xv] on the GEMM, the
    attention (``csrc/x2y_attn.cu::fk_x2y_sx_fwd``).  Given a dict
    ``inspect``, its "yq" receives the projected queries (B, Y, d), a view of
    the call's workspace (for accuracy checks)."""
    B, Y, Cy = y_in.shape
    X, Cx = x_in.shape[1], x_in.shape[2]
    d = wq.shape[1]
    _check_small_x("x2y_small_x_fwd", y_in, y_pos, x_in, x_pos, d)
    ypos, ystride, Py = kernel_pos(y_pos, B, Y, Cy)
    xpos, xstride, Px = kernel_pos(x_pos, B, X, Cx)
    _build.check_tensors("x2y_small_x_fwd", [ypos, xpos], x_in.device)
    work, w = _workspace(x_in.device, _proj_buffers(B, Y, X, Cy, Cx, d, ypos is not None,
                                                    xpos is not None))
    f32 = dict(device=x_in.device, dtype=torch.float32)
    attn = torch.empty((B, Y, d), **f32)  # separate tensors: the autograd entry's outputs
    probs = torch.empty((B, Y, X), **f32)
    logits = torch.empty((B, Y, X), **f32)
    err = _build.lib().fk_x2y_sx_fwd(
        *_proj_args(y_in, ypos, ystride, Py, x_in, xpos, xstride, Px, wq, bq, wk, bk, wv, bv,
                    x_len), B, Y, X, Cy, Cx, d, 1.0 / math.sqrt(d), w["lens"], w["yin"],
        w["xin"], w["wqp"], w["wkvp"], w["yq"], w["kv"], logits.data_ptr(), probs.data_ptr(),
        attn.data_ptr(), sx_rows(B, Y, X, d), _build.stream_ptr(x_in.device))
    _build.check("fk_x2y_sx_fwd", err)
    if inspect is not None:
        inspect["yq"] = _view(work, w["yq"], (B, Y, d))
    return attn, probs, logits


SX_ROWS = (32, 16, 8)  # query rows per block of the small-X attention (csrc/sx_attn.cuh)
SX_SMS = 132  # the H100's SMs
SX_SUM_GROUP = 16  # dbq's tile shares, added a run at a time
# floats of the attention's staging panel by tile height (csrc/sx_attn.cuh::SxPanels)
SX_PANEL = {8: max(64 * 132, 64 * 260), 16: max(64 * 68, 32 * 260), 32: max(64 * 68, 16 * 260)}
SX_PARTIALS = 16  # the weight products' partials a call aims at (sx_chunk)
_ALIGN = 64  # floats: every workspace buffer starts on a 256-byte boundary (TMA takes 16)


def sx_rows(B: int, Y: int, X: int, d: int) -> int:
    """Query rows per block of the small-X attention kernels, both
    directions: the tallest tile of ``SX_ROWS`` that fits in shared memory
    and gives two blocks an SM (32 at the flagship's and Breakfast's a2f),
    else the tallest that gives one, else 8 (epic's B = 1-2 and Y = 256-300,
    the TDU's Y = 40: short blocks, more of them in flight).  An 8-row block
    fits wherever a 16-row one does (``_check_small_x``)."""
    fits = [r for r in SX_ROWS if sx_smem(X, d, r) <= _build.MAX_SMEM]
    for per_sm in (2, 1):
        for rows in fits:
            if B * -(-Y // rows) >= per_sm * SX_SMS:
                return rows
    return SX_ROWS[-1]


def sx_chunk(B: int, T: int) -> int:
    """Rows of one video per partial of the backward's weight products:
    K6_CHUNK where the batch gives SX_PARTIALS partials or more, else shorter
    chunks (a multiple of 32) so that about that many blocks share the sum
    (epic's one video of 300 frames: 10 chunks of 32)."""
    per = -(-SX_PARTIALS // B)
    return min(K6_CHUNK, max(32, -(-T // per + 31) // 32 * 32))


def sx_smem(X: int, d: int, rows: int = 16) -> int:
    """Bytes of a small-X attention block (``csrc/sx_attn.cuh::sx_smem_floats``):
    the tile's (rows, d) operand, its (rows, X) logits and the panel."""
    return 4 * (rows * (d + 4) + rows * (-(-X // 4) * 4) + SX_PANEL[rows])


def _check_small_x(name, y_in, y_pos, x_in, x_pos, d):
    """The small-X kernels' limits, before any launch: the GEMMs' TMA row
    strides (Cy, Cx, d and the positional widths multiples of 4) and the
    attention's block of 16 rows in shared memory (d up to 2,084 at
    X = 1024)."""
    Cy, (X, Cx) = y_in.shape[2], x_in.shape[1:]
    py = kernel_pos(y_pos, y_in.shape[0], y_in.shape[1], Cy)[2]
    _check_strides(name, Cx, d, 0 if x_pos is None else x_pos.shape[-1])
    _check_strides(name, Cy, d, py)
    if sx_smem(X, d) > _build.MAX_SMEM:
        raise NotImplementedError(f"{name}: no kernel for X={X}, d={d} (its block needs "
                                  f"{sx_smem(X, d)} bytes of shared memory, "
                                  f"{_build.MAX_SMEM} at most)")


def _offsets(sizes):
    """Offsets in floats of the named buffers (a size of None: absent), each
    on an _ALIGN boundary, and the total."""
    offsets, total = {}, 0
    for name, n in sizes.items():
        offsets[name] = None if n is None else total
        total += 0 if n is None else -(-n // _ALIGN) * _ALIGN
    return offsets, max(total, 1)


def _workspace(device, sizes):
    """One float32 tensor holding the named buffers and each buffer's
    address in it, or None."""
    offsets, total = _offsets(sizes)
    work = torch.empty((total,), device=device, dtype=torch.float32)
    base = work.data_ptr()
    return work, {k: None if o is None else base + 4 * o for k, o in offsets.items()}


def _view(work, address, shape):
    """The buffer at ``address`` in ``work`` as a tensor of ``shape``."""
    o = (address - work.data_ptr()) // 4
    return work[o:o + math.prod(shape)].view(shape)


def _carve(device, shapes):
    """One float32 tensor and views of it of the given shapes (None: absent):
    a call's outputs from one allocation."""
    sizes = {i: None if s is None else math.prod(s) for i, s in enumerate(shapes)}
    offsets, total = _offsets(sizes)
    buf = torch.empty((total,), device=device, dtype=torch.float32)
    return buf, [None if s is None else buf[offsets[i]:offsets[i] + sizes[i]].view(s)
                 for i, s in enumerate(shapes)]


def _proj_buffers(B, Y, X, Cy, Cx, d, with_yin, with_xin):
    """The projections' workspace (``csrc/sx_attn.cuh::SxProj``): the
    lengths, y + y_pos, [x + x_pos | x], the packed Wq^T, Wk^T and Wv^T, yq
    and kv = [xk | xv]."""
    return dict(lens=2 * B + 1, yin=B * Y * Cy if with_yin else None,
                xin=B * X * 2 * Cx if with_xin else None, wqp=2 * d * Cy, wkvp=4 * d * Cx,
                yq=B * Y * d, kv=B * X * 2 * d)


def _proj_args(y_in, ypos, ystride, Py, x_in, xpos, xstride, Px, wq, bq, wk, bk, wv, bv, x_len):
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    return (y_in.data_ptr(), ptr(ypos), ystride, Py, x_in.data_ptr(), ptr(xpos), xstride, Px,
            wq.data_ptr(), bq.data_ptr(), wk.data_ptr(), bk.data_ptr(), wv.data_ptr(),
            bv.data_ptr(), x_len.data_ptr())


def x2y_flash_fwd(y_in, y_pos, x_in, x_pos, wk, bk, wv, bv, wq, bq, x_len, *,
                  rate: float = 0.0):
    """Flash form: the keys projected on the tensor cores, then the key tiles
    attended in parallel and merged."""
    if _prologue("x2y_flash_fwd", rate, y_in, y_pos, x_in, x_pos, wk, bk, wv, bv, wq, bq,
                 x_len):
        return x2y_attention_reference(y_in, y_pos, x_in, x_pos, wk, bk, wv, bv, wq, bq, x_len)
    out = _x2y_flash_fwd_card(y_in, y_pos, x_in, x_pos, wk, bk, wv, bv, wq, bq, x_len)
    x2y_flash_fwd.launches += 1
    return out


x2y_flash_fwd.launches = 0


def flash_rows(M: int) -> int:
    """Query rows per block of the flash forward's attention: the M rows in
    the fewest groups of at most FLASH_ROW_GROUP, each a multiple of 4 (a
    thread row holds a quarter): 20 at the flagship's M=40, 32 at
    Breakfast's 60, 12 at 11."""
    groups = -(-M // FLASH_ROW_GROUP)
    return -(-(-(-M // groups)) // 4) * 4


def _x2y_flash_fwd_card(y_in, y_pos, x_in, x_pos, wk, bk, wv, bv, wq, bq, x_len, inspect=None):
    """``x2y_flash_fwd``'s one library call (CPU tensors reach it only in the
    tests, which stand a model of the kernels' C interface in for the
    library): the lengths, the packs, the positional table and [xk | xv] on
    the GEMM, the attention partials and the combine
    (``csrc/flash_attn.cu::fk_x2y_flash_fwd``), into one workspace.  Given a
    dict ``inspect``, its "kv" receives [xk | xv] (B, X, 2d), a view of the
    call's workspace (for accuracy checks)."""
    B, M, _ = y_in.shape
    X, Cx = x_in.shape[1], x_in.shape[2]
    d = wq.shape[1]
    pos, pos_stride, Px = kernel_pos(x_pos, B, X, Cx)
    _check_strides("x2y_flash_fwd", Cx, d, Px)
    _build.check_tensors("x2y_flash_fwd", [pos], x_in.device)
    # the q projection runs outside the kernel, as in the JAX caller
    yq = (add_pos(y_in, y_pos) @ wq + bq).contiguous()
    n_t = -(-X // FLASH_KEY_TILE)
    work, w = _workspace(x_in.device, dict(
        lens=2 * B + 1, wkvp=4 * d * Cx, tab=pos.shape[0] * X * d if pos is not None else None,
        kv=B * X * 2 * d, part_acc=B * n_t * M * d, part_ml=B * n_t * M * 2))
    f32 = dict(device=x_in.device, dtype=torch.float32)
    attn = torch.empty((B, M, d), **f32)  # separate tensors: the autograd entry's outputs
    probs = torch.empty((B, M, X), **f32)
    logits = torch.empty((B, M, X), **f32)
    err = _build.lib().fk_x2y_flash_fwd(
        x_in.data_ptr(), pos.data_ptr() if pos is not None else None, pos_stride, Px,
        yq.data_ptr(), wk.data_ptr(), bk.data_ptr(), wv.data_ptr(), bv.data_ptr(),
        x_len.data_ptr(), B, X, Cx, M, d, 1.0 / math.sqrt(d), w["lens"], w["wkvp"], w["tab"],
        w["kv"], w["part_acc"], w["part_ml"], logits.data_ptr(), probs.data_ptr(),
        attn.data_ptr(), flash_rows(M), _build.stream_ptr(x_in.device))
    _build.check("fk_x2y_flash_fwd", err)
    if inspect is not None:
        inspect["kv"] = _view(work, w["kv"], (B, X, 2 * d))
    return attn, probs, logits


# ---------------------------------------------------------------------------
# backward

FLASH_MAX_QUERIES = 64  # csrc/x2y_bwd.cu kMaxM
FLASH_SUM_GROUP = 16  # dyq's tile shares and the bias sums, added a run at a time


def has_backward(M: int, X: int, d: int) -> bool:
    """Whether one backward call takes this shape: the flash form holds M
    query rows in its 64-wide panels (any d, in column chunks), the small-X
    form a (16, d) tile of g_attn and a (16, X) tile of dlogits beside its
    panel (``sx_smem``).  ``_X2Y`` runs the flash backward on
    FLASH_MAX_QUERIES query rows at a time (``takes_grad``)."""
    if X >= FLASH_MIN_KEYS:
        return M <= FLASH_MAX_QUERIES
    return sx_smem(X, d) <= _build.MAX_SMEM


def takes_grad(M: int, X: int, d: int) -> bool:
    """Whether the card has a backward at this shape: the flash form at any
    M, its query rows in chunks of FLASH_MAX_QUERIES (``_flash_bwd_rows``;
    the holdout recipes' 75 tokens in two), the small-X form where
    ``has_backward`` holds."""
    return has_backward(min(M, FLASH_MAX_QUERIES), X, d)


def _flash_bwd_rows(y_in, y_pos, x_in, x_pos, wk, bk, wv, bv, wq, bq, x_len, probs, attn,
                    g_attn, g_probs, g_logits, need_xpos_grad):
    """``x2y_flash_bwd`` on FLASH_MAX_QUERIES query rows at a time.  Each
    query row attends on its own, so the chunks' cotangents of the query
    side (y, y_pos) join along the rows and the others (x, x_pos and every
    weight) add, in chunk order.  One call where M <= FLASH_MAX_QUERIES."""
    M = y_in.shape[1]
    parts = []
    for m0 in range(0, M, FLASH_MAX_QUERIES):
        r = slice(m0, m0 + FLASH_MAX_QUERIES)
        rows = lambda t: None if t is None else t[:, r]  # noqa: E731
        parts.append(x2y_flash_bwd(
            y_in[:, r], rows(y_pos), x_in, x_pos, wk, bk, wv, bv, wq, bq, x_len,
            probs[:, r].contiguous(), attn[:, r], g_attn[:, r], rows(g_probs), rows(g_logits),
            need_xpos_grad=need_xpos_grad))
    if len(parts) == 1:
        return parts[0]
    joined = (0, 1)  # d_y, d_ypos: one row each
    return tuple(None if p[0] is None
                 else torch.cat(p, dim=1) if i in joined else torch.stack(p).sum(dim=0)
                 for i, p in enumerate(zip(*parts)))


def _shared(pos) -> bool:
    return pos is None or pos.dim() == 2 or pos.shape[0] == 1


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
    return (d_yq_in, pos_grad(d_yq_in, y_pos), d_xk_in + d_xv @ wv.t(), pos_grad(d_xk_in, x_pos),
            torch.einsum("bxc,bxd->cd", xk_in, d_xk), d_xk.sum(dim=(0, 1)),
            torch.einsum("bxc,bxd->cd", x_in, d_xv), d_xv.sum(dim=(0, 1)),
            torch.einsum("byc,byd->cd", yq_in, d_yq), d_yq.sum(dim=(0, 1)))


x2y_bwd_reference.launches = 0  # plain backwards dispatched on the card (per-batch pos)


def _pos_like(g, pos):
    return g.view(pos.shape) if pos is not None else None


def x2y_small_x_bwd(y_in, y_pos, x_in, x_pos, wk, bk, wv, bv, wq, bq, x_len, probs, g_attn,
                    g_probs=None, g_logits=None, *, need_ypos_grad: bool = True,
                    need_xpos_grad: bool = True):
    """Small-X backward: the kernels on CUDA tensors (y_pos shared by the
    batch), the plain version on CPU tensors."""
    if x_in.device.type == "cpu":
        return x2y_bwd_reference(y_in, y_pos, x_in, x_pos, wk, bk, wv, bv, wq, bq, x_len, probs,
                                 g_attn, g_probs, g_logits)
    grads = _x2y_small_x_bwd_card(y_in, y_pos, x_in, x_pos, wk, bk, wv, bv, wq, bq, x_len, probs,
                                  g_attn, g_probs, g_logits, need_ypos_grad, need_xpos_grad)
    x2y_small_x_bwd.launches += 1
    return grads


x2y_small_x_bwd.launches = 0


def _x2y_small_x_bwd_card(y_in, y_pos, x_in, x_pos, wk, bk, wv, bv, wq, bq, x_len, probs, g_attn,
                          g_probs, g_logits, need_ypos_grad=True, need_xpos_grad=True,
                          inspect=None):
    """``x2y_small_x_bwd``'s launches, one library call (CPU tensors reach it
    only in the tests, as ``_x2y_small_x_fwd_card``): yq and [xk | xv]
    recomputed, the attention terms, dy, the weight products, the X side and
    the fixed-order sums (``csrc/x2y_bwd.cu::fk_x2y_sx_bwd``).  Returns the
    cotangents of (y_in, y_pos, x_in, x_pos, wk, bk, wv, bv, wq, bq), a
    positional one None where its table is absent or not wanted.  Given a
    dict ``inspect``, its "dkv" receives [dxk | dxv] (B, X, 2d), the per-video
    products the call computed, a view of its workspace (for accuracy
    checks)."""
    B, Y, Cy = y_in.shape
    X, Cx = x_in.shape[1], x_in.shape[2]
    d = wq.shape[1]
    ypos, ystride, Py = kernel_pos(y_pos, B, Y, Cy)
    if ystride or not has_backward(Y, X, d):
        raise ValueError("x2y_small_x_bwd: needs a shared y_pos and a (16, d) tile that fits")
    _check_small_x("x2y_small_x_bwd", y_in, y_pos, x_in, x_pos, d)
    xpos, xstride, Px = kernel_pos(x_pos, B, X, Cx)
    g_attn = g_attn.contiguous()
    g_probs = g_probs.contiguous() if g_probs is not None else None
    g_logits = g_logits.contiguous() if g_logits is not None else None
    _build.check_tensors("x2y_small_x_bwd", [y_in, ypos, x_in, xpos, probs, g_probs, g_logits,
                                             g_attn, wk, bk, wv, bv, wq, bq, x_len],
                         x_in.device)
    rows = sx_rows(B, Y, X, d)
    n_slots = -(-B * -(-Y // rows) // SX_SUM_GROUP) * SX_SUM_GROUP
    xp = -(-X // 4) * 4  # dlogits' and the padded probs' rows: 16 bytes (TMA row strides)
    kc_y, kc_x = sx_chunk(B, Y), sx_chunk(B, X)
    per_y, per_x = -(-Y // kc_y), -(-X // kc_x)
    want_ypos, want_xpos = need_ypos_grad and ypos is not None, need_xpos_grad and xpos is not None
    Bx = B if xstride else 1  # d_xpos's batch
    work, w = _workspace(x_in.device, dict(
        _proj_buffers(B, Y, X, Cy, Cx, d, ypos is not None, xpos is not None),
        probs_p=B * Y * xp if xp != X else None, wqn=2 * Cy * d, wkvn=4 * Cx * d, dlog=B * Y * xp,
        dyq=B * Y * d, part_bq=n_slots * d, stage=n_slots // SX_SUM_GROUP * d,
        part=max(B * per_y * max(Cy, X), B * per_x * Cx) * d,
        dkv=-(-B * X // SX_SUM_GROUP) * SX_SUM_GROUP * 2 * d,
        dk=Bx * X * d if want_xpos else None))
    dy = torch.empty_like(y_in)
    # the small cotangents from one allocation, each in its final shape (d_xpos
    # over all Cx channels where x_pos is narrower: the leading Px are taken)
    _, (d_ypos, d_wq, d_bq, dx, d_xpos, d_wk, d_bk, d_wv, d_bv) = _carve(x_in.device, [
        y_pos.shape if want_ypos else None, (Cy, d), (d,), (B, X, Cx),
        (x_pos.shape if Px == Cx else (Bx, X, Cx)) if want_xpos else None, (Cx, d), (d,),
        (Cx, d), (d,)])
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    err = _build.lib().fk_x2y_sx_bwd(
        *_proj_args(y_in, ypos, ystride, Py, x_in, xpos, xstride, Px, wq, bq, wk, bk, wv, bv,
                    x_len), probs.data_ptr(), ptr(g_probs), ptr(g_logits), g_attn.data_ptr(), B,
        Y, X, Cy, Cx, d, 1.0 / math.sqrt(d), w["lens"], w["yin"], w["xin"], w["probs_p"],
        w["wqp"], w["wqn"], w["wkvp"], w["wkvn"], w["yq"], w["kv"], w["dlog"], w["dyq"],
        w["part_bq"], n_slots, w["stage"], w["part"], w["dkv"], w["dk"], dy.data_ptr(),
        ptr(d_ypos), d_wq.data_ptr(), d_bq.data_ptr(), dx.data_ptr(), ptr(d_xpos),
        d_wk.data_ptr(), d_wv.data_ptr(), d_bk.data_ptr(), d_bv.data_ptr(), rows,
        SX_SUM_GROUP, kc_y, kc_x, _build.stream_ptr(x_in.device))
    _build.check("fk_x2y_sx_bwd", err)
    if d_xpos is not None and Px < Cx:
        d_xpos = d_xpos[..., :Px].reshape(x_pos.shape)
    if inspect is not None:
        inspect["dkv"] = _view(work, w["dkv"], (B, X, 2 * d))
    return dy, d_ypos, dx, d_xpos, d_wk, d_bk, d_wv, d_bv, d_wq, d_bq


def x2y_flash_bwd(y_in, y_pos, x_in, x_pos, wk, bk, wv, bv, wq, bq, x_len, probs, attn, g_attn,
                  g_probs=None, g_logits=None, *, need_xpos_grad: bool = True):
    """Flash backward: the kernels on CUDA tensors (x_pos shared by the
    batch), the plain version on CPU tensors."""
    if x_in.device.type == "cpu":
        return x2y_bwd_reference(y_in, y_pos, x_in, x_pos, wk, bk, wv, bv, wq, bq, x_len, probs,
                                 g_attn, g_probs, g_logits)
    grads = _x2y_flash_bwd_card(y_in, y_pos, x_in, x_pos, wk, bk, wv, bv, wq, bq, x_len, probs,
                                attn, g_attn, g_probs, g_logits, need_xpos_grad)
    x2y_flash_bwd.launches += 1
    return grads


x2y_flash_bwd.launches = 0


def _x2y_flash_bwd_card(y_in, y_pos, x_in, x_pos, wk, bk, wv, bv, wq, bq, x_len, probs, attn,
                        g_attn, g_probs, g_logits, need_xpos_grad):
    """``x2y_flash_bwd``'s launches (CPU tensors reach it only in the tests,
    which stand a model of the kernels' C interface in for the library): the
    projection recomputed, the attention terms, dx, the weight products and
    the fixed-order sums."""
    B, M, _ = y_in.shape
    X, Cx = x_in.shape[1], x_in.shape[2]
    d = wq.shape[1]
    xpos, pos_stride, Px = kernel_pos(x_pos, B, X, Cx)
    if pos_stride or not has_backward(M, X, d):
        raise ValueError("x2y_flash_bwd: needs a shared x_pos and M <= 64")
    _check_strides("x2y_flash_bwd", Cx, d, Px)
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
    lens = attended_lengths(x_len, X)
    kv = _project(x_in, x_pos, lens, k3_pack(wk, bk, wv, bv))  # [xk | xv], recomputed as JAX's
    n_t = -(-X // FLASH_KEY_TILE)
    n_slots = -(-n_t // FLASH_SUM_GROUP) * FLASH_SUM_GROUP
    f32 = dict(device=x_in.device, dtype=torch.float32)
    dkv = torch.empty((B, X, 2 * d), **f32)
    part_dyq = torch.zeros((B, n_slots, M * d), **f32)
    part_b = torch.zeros((B, n_slots, 2 * d), **f32)
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    err = _build.lib().fk_x2y_flash_attn_bwd(
        kv.data_ptr(), probs.data_ptr(), ptr(g_probs), ptr(g_logits), g_attn.data_ptr(),
        yq.data_ptr(), D.data_ptr(), x_len.data_ptr(), B, X, M, d, 1.0 / math.sqrt(d),
        dkv.data_ptr(), part_dyq.data_ptr(), part_b.data_ptr(), n_slots,
        _build.stream_ptr(x_in.device))
    _build.check("fk_x2y_flash_attn_bwd", err)
    del kv
    dx = torch.empty_like(x_in)
    _k6_gemm(_MASKED, dkv, _ONE, k6_pack(torch.cat([wk, wv], dim=1)), Cx, lens, dx)
    dw = wgrad(x_in, 0, Cx, dkv, 0, 2 * d, lens)[0]  # [x^T dxk | x^T dxv]
    d_wk, d_wv = dw[:, :d], dw[:, d:]
    d_xpos = None
    if xpos is not None:  # shared by the batch: dWk += x_pos^T (sum_b dxk)
        dk_sum = _grad.batch_sum(dkv, d)
        full = torch.full((1,), X, dtype=torch.int32, device=x_in.device)
        d_wk = d_wk.clone()
        d_wk[:Px] += wgrad(xpos, 0, Px, dk_sum, 0, d, full)[0]
        if need_xpos_grad:
            # sum_b dxk_in[b] = (sum_b dxk[b]) @ Wk^T: one product of the batch sum
            d_xpos = _pos_like((dk_sum @ wk.t())[..., :Px], x_pos)
    d_yq = _grad.sum_groups(part_dyq, FLASH_SUM_GROUP).view(B, M, d)
    d_b = _grad.sum_groups(part_b.view(1, B * n_slots, 2 * d), FLASH_SUM_GROUP)[0]
    # the q side stays plain matmuls, as in the JAX caller (M is the token axis)
    d_yq_in = d_yq @ wq.t()
    return (d_yq_in, pos_grad(d_yq_in, y_pos), dx, d_xpos, d_wk, d_b[:d], d_wv, d_b[d:],
            torch.einsum("bmc,bmd->cd", yq_in, d_yq), d_yq.sum(dim=(0, 1)))


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
            grads = _flash_bwd_rows(*args, probs, attn, g_attn, g_probs, g_logits,
                                    need_xpos_grad=ctx.needs_input_grad[3])
        elif not flash and _shared(y_pos):
            grads = x2y_small_x_bwd(*args, probs, g_attn, g_probs, g_logits,
                                    need_ypos_grad=ctx.needs_input_grad[1],
                                    need_xpos_grad=ctx.needs_input_grad[3])
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
        _build.require_backward("x2y_attention", takes_grad(y_in.shape[1], x_in.shape[1],
                                                            wq.shape[1]))
    return _X2Y.apply(*args)


# ---------------------------------------------------------------------------
# mixed precision: the bf16 forms of both forwards (serving)


def _pos16(pos):
    return None if pos is None else pos.to(BF16)


def x2y_attention16_reference(y_in, y_pos, x_in, x_pos, wk, bk, wv, bv, wq, bq, x_len):
    """Plain version of both of JAX's forms under mixed precision: y and x
    bf16, the positional terms cast to bf16 (JAX's ``_poslike``) and added
    with one rounding, the weights f32 (cast here).  Small X
    (``_small_x_vjp``, ``_small_x_kernel``): xk = bf16((x + x_pos) Wk) + bk
    and xv = bf16(x Wv) + bv, the bf16 products rounded before the f32 bias
    (XLA's bf16 einsum outside the kernel), yq = (y + y_pos) Wq + bq in f32.
    Flash (``_flash_vjp``, ``_flash_kernel``): yq = bf16((y + y_pos) Wq) +
    bq outside the kernel, xk and xv with f32 results.  Then both in f32:
    the logits, the softmax and the attend sum.  Returns f32 (attn, probs,
    logits)."""
    d = wq.shape[1]
    yin, xin = add_pos16(y_in, _pos16(y_pos)), add_pos16(x_in, _pos16(x_pos))
    if x_in.shape[1] >= FLASH_MIN_KEYS:
        yq, xk, xv = rnd(mm(yin, wq)) + bq, mm(xin, wk) + bk, mm(x_in, wv) + bv
    else:
        yq, xk, xv = mm(yin, wq) + bq, rnd(mm(xin, wk)) + bk, rnd(mm(x_in, wv)) + bv
    logits = (yq @ xk.transpose(1, 2)) * (1.0 / math.sqrt(d))
    X = x_in.shape[1]
    valid = torch.arange(X, device=x_in.device)[None, None, :] < x_len[:, None, None]
    logits = logits.masked_fill(~valid, _NEG)
    probs = torch.softmax(logits, dim=-1)
    return probs @ xv, probs, logits


def x2y_b16_pack(wk, wv, wq):
    """K2's bf16 forms' weights: Wk^T, Wv^T (d, Cx) and Wq^T (d, Cy) in bf16,
    K-major (``dilated_conv.b16_pack``)."""
    return b16_pack(wk, True), b16_pack(wv, True), b16_pack(wq, True)


def x2y_attention16(y_in, y_pos, x_in, x_pos, wk, bk, wv, bv, wq, bq, x_len, packed=None):
    """K2's bf16 forms (serving), dispatched on the key count as the f32
    entry: the kernels on CUDA tensors, the plain version on CPU tensors;
    ``packed`` is ``x2y_b16_pack(wk, wv, wq)`` where the caller keeps it."""
    _build.no_grad_inputs("x2y_attention16", [y_in, y_pos, x_in, x_pos, wk, bk, wv, bv, wq, bq])
    if x_in.device.type == "cpu":
        return x2y_attention16_reference(y_in, y_pos, x_in, x_pos, wk, bk, wv, bv, wq, bq, x_len)
    flash = x_in.shape[1] >= FLASH_MIN_KEYS
    fn = x2y_flash16_fwd if flash else x2y_small_x16_fwd
    return fn(y_in, y_pos, x_in, x_pos, wk, bk, wv, bv, wq, bq, x_len, packed)


def x2y_small_x16_fwd(y_in, y_pos, x_in, x_pos, wk, bk, wv, bv, wq, bq, x_len, packed=None):
    """The small-X bf16 form on the card (``x2y_attention16`` dispatches)."""
    out = _x2y_small_x16_card(y_in, y_pos, x_in, x_pos, wk, bk, wv, bv, wq, bq, x_len, packed)
    x2y_small_x16_fwd.launches += 1
    return out


x2y_small_x16_fwd.launches = 0


def x2y_flash16_fwd(y_in, y_pos, x_in, x_pos, wk, bk, wv, bv, wq, bq, x_len, packed=None):
    """The flash bf16 form on the card (``x2y_attention16`` dispatches)."""
    out = _x2y_flash16_card(y_in, y_pos, x_in, x_pos, wk, bk, wv, bv, wq, bq, x_len, packed)
    x2y_flash16_fwd.launches += 1
    return out


x2y_flash16_fwd.launches = 0


def _check16(name, y_in, x_in, wk, bk, wv, bv, wq, bq, x_len, packed):
    B, Y, Cy = y_in.shape
    _, X, Cx = x_in.shape
    d = wq.shape[1]
    if (x_in.shape[0] != B or wk.shape != (Cx, d) or wv.shape != (Cx, d) or wq.shape != (Cy, d)
            or bk.shape != (d,) or bv.shape != (d,) or bq.shape != (d,)):
        raise ValueError(f"{name}: inconsistent shapes")
    if y_in.dtype != BF16 or x_in.dtype != BF16:
        raise ValueError(f"{name}: y and x must be bfloat16")
    if x_len.dtype != torch.int32 or x_len.shape != (B,):
        raise ValueError(f"{name}: x_len must be (B,) int32")
    if not (has_b16_kernels(Cx, d) and has_b16_kernels(Cy, d)):
        raise NotImplementedError(f"{name}: no kernel for Cy={Cy}, Cx={Cx}, d={d} (each a "
                                  "multiple of 8)")
    packed = x2y_b16_pack(wk, wv, wq) if packed is None else packed
    _build.check_tensors(name, [y_in, x_in, bk, bv, bq, x_len, *packed], x_in.device, bf16=True)
    return packed


def _sx16_project(y_in, y_pos, x_in, x_pos, bk, bv, bq, x_len, wkp, wvp, wqp):
    """The small-X bf16 form's projections, both directions': y + y_pos and
    x + x_pos rounded to bf16 (``fk_b16_add_pos``), yq (B16_PROJ, f32) and
    [xk | xv] (B16_PROJ_RND: the product rounded to bf16, then the f32
    bias; zero past the attended length) on the bf16 GEMM.  Returns (bf16(y
    + y_pos), bf16(x + x_pos), yq, kv, the attended lengths)."""
    B, Y, _ = y_in.shape
    X = x_in.shape[1]
    d = wqp.shape[0]
    f32 = dict(device=x_in.device, dtype=torch.float32)
    yin, xin = b16_add_pos(y_in, _pos16(y_pos)), b16_add_pos(x_in, _pos16(x_pos))
    yq = torch.empty((B, Y, d), **f32)
    kv = torch.empty((B, X, 2 * d), **f32)
    lens = attended_lengths(x_len, X)
    b16_gemm(B16_PROJ, yin, [0], wqp, d, torch.full_like(x_len, Y), yq, bias=bq)
    b16_gemm(B16_PROJ_RND, xin, [0], wkp, d, lens, kv, ldo=2 * d, bias=bk)
    b16_gemm(B16_PROJ_RND, x_in, [0], wvp, d, lens, kv, ldo=2 * d, col_off=d, bias=bv)
    return yin, xin, yq, kv, lens


def _flash16_project(x_in, x_pos, bk, bv, x_len, wkp, wvp):
    """The flash bf16 form's [xk | xv], both directions': x + x_pos rounded
    to bf16 (``fk_b16_add_pos``), then f32 results on the bf16 GEMM
    (B16_PROJ, zero past the attended length).  Returns (bf16(x + x_pos),
    kv, the attended lengths)."""
    B, X, _ = x_in.shape
    d = wkp.shape[0]
    xin = b16_add_pos(x_in, _pos16(x_pos))
    lens = attended_lengths(x_len, X)
    kv = torch.empty((B, X, 2 * d), device=x_in.device, dtype=torch.float32)
    b16_gemm(B16_PROJ, xin, [0], wkp, d, lens, kv, ldo=2 * d, bias=bk)
    b16_gemm(B16_PROJ, x_in, [0], wvp, d, lens, kv, ldo=2 * d, col_off=d, bias=bv)
    return xin, kv, lens


def _x2y_small_x16_card(y_in, y_pos, x_in, x_pos, wk, bk, wv, bv, wq, bq, x_len, packed=None):
    """``x2y_small_x16_fwd``'s launches (CPU tensors reach it only in the
    tests, which stand a model of the kernels' C interface in for the
    library): y + y_pos and x + x_pos rounded to bf16 (``fk_b16_add_pos``),
    yq (B16_PROJ, f32) and [xk | xv] (B16_PROJ_RND: the product rounded to
    bf16, then the f32 bias; zero past the attended length) on the bf16
    GEMM, then the f32 form's attention (``fk_x2y_sx_attn``): JAX's small-X
    kernel takes f32 keys and values under mixed precision, so its logits,
    softmax and attend sum are f32."""
    B, Y, Cy = y_in.shape
    X = x_in.shape[1]
    d = wq.shape[1]
    wkp, wvp, wqp = _check16("x2y_small_x16_fwd", y_in, x_in, wk, bk, wv, bv, wq, bq, x_len,
                             packed)
    if sx_smem(X, d) > _build.MAX_SMEM:
        raise NotImplementedError(f"x2y_small_x16_fwd: no kernel for X={X}, d={d}")
    f32 = dict(device=x_in.device, dtype=torch.float32)
    _, _, yq, kv, _ = _sx16_project(y_in, y_pos, x_in, x_pos, bk, bv, bq, x_len, wkp, wvp, wqp)
    attn = torch.empty((B, Y, d), **f32)
    probs = torch.empty((B, Y, X), **f32)
    logits = torch.empty((B, Y, X), **f32)
    err = _build.lib().fk_x2y_sx_attn(yq.data_ptr(), kv.data_ptr(), x_len.data_ptr(), B, Y, X,
                                      d, 1.0 / math.sqrt(d), logits.data_ptr(), probs.data_ptr(),
                                      attn.data_ptr(), sx_rows(B, Y, X, d),
                                      _build.stream_ptr(x_in.device))
    _build.check("fk_x2y_sx_attn", err)
    return attn, probs, logits


def _x2y_flash16_card(y_in, y_pos, x_in, x_pos, wk, bk, wv, bv, wq, bq, x_len, packed=None):
    """``x2y_flash16_fwd``'s launches: yq = bf16((y + y_pos) Wq) + bq outside
    the kernels (as JAX's caller computes it), x + x_pos rounded to bf16
    (``fk_b16_add_pos``), [xk | xv] with f32 results on the bf16 GEMM
    (B16_PROJ, zero past the attended length), then the f32 form's attention
    partials and combine (``fk_x2y_flash_attend``): JAX's flash kernel keeps
    xk and xv f32 under mixed precision, so its attention is f32."""
    B, M, _ = y_in.shape
    X = x_in.shape[1]
    d = wq.shape[1]
    wkp, wvp, _ = _check16("x2y_flash16_fwd", y_in, x_in, wk, bk, wv, bv, wq, bq, x_len, packed)
    yq = (rnd(mm(add_pos16(y_in, _pos16(y_pos)), wq)) + bq).contiguous()
    _, kv, _ = _flash16_project(x_in, x_pos, bk, bv, x_len, wkp, wvp)
    f32 = dict(device=x_in.device, dtype=torch.float32)
    n_t = -(-X // FLASH_KEY_TILE)
    part_acc = torch.empty((B, n_t, M, d), **f32)
    part_ml = torch.empty((B, n_t, M, 2), **f32)
    attn = torch.empty((B, M, d), **f32)
    probs = torch.empty((B, M, X), **f32)
    logits = torch.empty((B, M, X), **f32)
    err = _build.lib().fk_x2y_flash_attend(
        yq.data_ptr(), kv.data_ptr(), x_len.data_ptr(), B, X, M, d, 1.0 / math.sqrt(d),
        part_acc.data_ptr(), part_ml.data_ptr(), logits.data_ptr(), probs.data_ptr(),
        attn.data_ptr(), flash_rows(M), _build.stream_ptr(x_in.device))
    _build.check("fk_x2y_flash_attend", err)
    return attn, probs, logits


# ---------------------------------------------------------------------------
# mixed precision: the bf16 backward forms (training)


def _softmax_bwd(probs, d_probs):
    return probs * (d_probs - (d_probs * probs).sum(dim=-1, keepdim=True))


def x2y16_bwd_reference(y_in, y_pos, x_in, x_pos, wk, bk, wv, bv, wq, bq, x_len, probs, attn,
                        g_attn, g_probs=None, g_logits=None):
    """Plain version of K2's backward under mixed precision, each branch of
    JAX's dispatch with its own rounding points (y and x bf16, the
    positional terms rounded to bf16 as the forward takes them, the weights
    cast here).  Small X with y_pos shared (``_small_x_bwd``'s kernel branch,
    x2y_attn.py:512-543 and ``_small_x_bwd_kernel``): yq = bf16(y + y_pos)
    Wq + bq in f32, the keys and values as the forward's; d_y =
    bf16(bf16(d_yq) Wq^T), dWq = (y + y_pos in f32)^T d_yq; the X side in f32
    products (d_xk Wk^T, bf16(x + x_pos)^T d_xk).  Flash with x_pos shared
    (``_flash_bwd`` and ``_flash_bwd_kernel``): yq = bf16(bf16(y + y_pos) Wq) +
    bq, the keys and values f32 from bf16(x + x_pos in f32) and x; dx =
    bf16(bf16(dxk) Wk^T + bf16(dxv) Wv^T), dWk = bf16(x + x_pos)^T bf16(dxk),
    dWv = x^T bf16(dxv), d_xpos from the unrounded dxk Wk^T; the query side in
    f32 products.  Otherwise (a per-video table: ``_small_x_bwd_xla`` /
    ``_flash_bwd_xla``): every projection rounded to bf16 before its bias,
    the products of the cotangents in f32.  Returns the cotangents of (y_in,
    y_pos, x_in, x_pos, wk, bk, wv, bv, wq, bq): y and x bf16, the weights f32
    holding their bf16 values, the biases and positional terms f32."""
    d = wq.shape[1]
    scale = 1.0 / math.sqrt(d)
    flash = x_in.shape[1] >= FLASH_MIN_KEYS
    kernel = _shared(x_pos) if flash else _shared(y_pos)
    yp, xp = _pos16(y_pos), _pos16(x_pos)
    wq16, wk16, wv16 = rnd(wq), rnd(wk), rnd(wv)
    yin, xin = add_pos16(y_in, yp).float(), add_pos16(x_in, xp).float()
    x = x_in.float()
    xk_in = xin
    if not kernel:
        yq, xk, xv = rnd(yin @ wq16) + bq, rnd(xin @ wk16) + bk, rnd(x @ wv16) + bv
    elif flash:
        xk_in = add_pos(x, None if xp is None else xp.float())
        yq, xk, xv = rnd(yin @ wq16) + bq, rnd(xk_in) @ wk16 + bk, x @ wv16 + bv
    else:
        yq, xk, xv = yin @ wq16 + bq, rnd(xin @ wk16) + bk, rnd(x @ wv16) + bv
    d_xv = torch.einsum("byx,byd->bxd", probs, g_attn)
    d_probs = g_attn @ xv.transpose(1, 2)
    if g_probs is not None:
        d_probs = d_probs + g_probs
    d_logits = _softmax_bwd(probs, d_probs)
    if g_logits is not None:
        d_logits = d_logits + g_logits
    X = x_in.shape[1]
    valid = torch.arange(X, device=x_in.device)[None, None, :] < x_len[:, None, None]
    d_logits = torch.where(valid, d_logits, 0.0) * scale
    d_yq = d_logits @ xk
    d_xk = d_logits.transpose(1, 2) @ yq
    if kernel and flash:
        dk16, dv16 = rnd(d_xk), rnd(d_xv)
        d_xk_in = dk16 @ wk16.t()
        dx = d_xk_in + dv16 @ wv16.t()
        d_wk = torch.einsum("bxc,bxd->cd", rnd(xk_in), dk16)
        d_wv = torch.einsum("bxc,bxd->cd", x, dv16)
        d_yq_in = d_yq @ wq16.t()
        d_wq = torch.einsum("byc,byd->cd", yin, d_yq)
    else:
        d_xk_in = d_xk @ wk16.t()
        dx = d_xk_in + d_xv @ wv16.t()
        d_wk = torch.einsum("bxc,bxd->cd", xin, d_xk)
        d_wv = torch.einsum("bxc,bxd->cd", x, d_xv)
        if kernel:  # small X
            d_yq_in = rnd(d_yq) @ wq16.t()
            yq_in = add_pos(y_in.float(), None if yp is None else yp.float())
            d_wq = torch.einsum("byc,byd->cd", yq_in, d_yq)
        else:
            d_yq_in = d_yq @ wq16.t()
            d_wq = torch.einsum("byc,byd->cd", yin, d_yq)
    return (d_yq_in.to(BF16), pos_grad(d_yq_in, y_pos), dx.to(BF16), pos_grad(d_xk_in, x_pos),
            rnd(d_wk), d_xk.sum(dim=(0, 1)), rnd(d_wv), d_xv.sum(dim=(0, 1)), rnd(d_wq),
            d_yq.sum(dim=(0, 1)))


def x2y_small_x16_bwd(y_in, y_pos, x_in, x_pos, wk, bk, wv, bv, wq, bq, x_len, probs, g_attn,
                      g_probs=None, g_logits=None, packed=None):
    """The small-X bf16 backward on the card (y_pos shared by the batch)."""
    out = _x2y_small_x16_bwd_card(y_in, y_pos, x_in, x_pos, wk, bk, wv, bv, wq, bq, x_len, probs,
                                  g_attn, g_probs, g_logits, packed)
    x2y_small_x16_bwd.launches += 1
    return out


x2y_small_x16_bwd.launches = 0


def _x2y_small_x16_bwd_card(y_in, y_pos, x_in, x_pos, wk, bk, wv, bv, wq, bq, x_len, probs,
                            g_attn, g_probs, g_logits, packed=None):
    """``x2y_small_x16_bwd``'s launches: the bf16 forward's projections
    again (yq f32, [xk | xv] with the products rounded), the f32 form's
    attention terms (``fk_x2y_sx_attn_bwd``: JAX's kernel computes them in
    f32), d_yq rounded to bf16 and d_y = bf16(d_yq Wq^T) on the bf16 GEMM,
    dWq = (y + y_pos)^T d_yq and per video dxk = dlogits^T yq, dxv = probs^T
    g_attn in f32 (``fk_k6_wgrad``), the bias sums in a fixed order; the X
    side is plain products, as JAX's caller computes it."""
    B, Y, Cy = y_in.shape
    X, Cx = x_in.shape[1], x_in.shape[2]
    d = wq.shape[1]
    wkp, wvp, wqp = _check16("x2y_small_x16_bwd", y_in, x_in, wk, bk, wv, bv, wq, bq, x_len,
                             packed)
    if not _shared(y_pos) or sx_smem(X, d) > _build.MAX_SMEM:
        raise ValueError("x2y_small_x16_bwd: needs a shared y_pos and a (16, d) tile that fits")
    f32 = dict(device=x_in.device, dtype=torch.float32)
    g_attn = g_attn.contiguous()
    g_probs = g_probs.contiguous() if g_probs is not None else None
    g_logits = g_logits.contiguous() if g_logits is not None else None
    _build.check_tensors("x2y_small_x16_bwd", [probs, g_attn, g_probs, g_logits], x_in.device)
    yp = _pos16(y_pos)
    full = torch.full_like(x_len, Y)
    _, xin, yq, kv, _ = _sx16_project(y_in, y_pos, x_in, x_pos, bk, bv, bq, x_len, wkp, wvp, wqp)
    rows = sx_rows(B, Y, X, d)
    n_slots = -(-B * -(-Y // rows) // SX_SUM_GROUP) * SX_SUM_GROUP
    xpad = -(-X // 4) * 4
    dlog = torch.empty((B, Y, xpad), **f32)
    dyq = torch.empty((B, Y, d), **f32)
    part_bq = torch.empty((n_slots, d), **f32)
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    err = _build.lib().fk_x2y_sx_attn_bwd(
        kv.data_ptr(), probs.data_ptr(), ptr(g_probs), ptr(g_logits), g_attn.data_ptr(),
        x_len.data_ptr(), B, Y, X, d, 1.0 / math.sqrt(d), dlog.data_ptr(), dyq.data_ptr(),
        part_bq.data_ptr(), n_slots, rows, _build.stream_ptr(x_in.device))
    _build.check("fk_x2y_sx_attn_bwd", err)
    dyq16, _ = b16_round(dyq, full)
    want_ypos = y_pos is not None and y_pos.requires_grad
    dy32 = torch.empty((B, Y, Cy), **f32) if want_ypos else None
    dy = torch.empty_like(y_in)
    b16_gemm(B16_PROJ if want_ypos else B16_PROJ16, dyq16, [0], b16_pack(wq), Cy, full,
             dy32 if want_ypos else dy)
    if want_ypos:
        dy = dy32.to(BF16)
    yq_in = add_pos(y_in.float(), None if yp is None else yp.float()).contiguous()
    d_wq = rnd(wgrad(yq_in, 0, Cy, dyq, 0, d, full)[0])
    d_bq = _grad.sum_groups(part_bq[None], SX_SUM_GROUP)[0]
    Kc = sx_chunk(B, Y)
    probs_p = probs if xpad == X else torch.nn.functional.pad(probs, (0, xpad - X)).contiguous()
    dxk = wgrad(dlog, 0, X, yq, 0, d, full, per_video=True, chunk=Kc)[0]
    dxv = wgrad(probs_p, 0, X, g_attn, 0, d, full, per_video=True, chunk=Kc)[0]
    # the X side: plain products, as JAX's caller (x2y_attn.py:528-535)
    d_xk_in = dxk @ rnd(wk).t()
    dx = (d_xk_in + dxv @ rnd(wv).t()).to(BF16)
    d_wk = rnd(torch.einsum("bxc,bxd->cd", xin.float(), dxk))
    d_wv = rnd(torch.einsum("bxc,bxd->cd", x_in.float(), dxv))
    return (dy, pos_grad(dy32, y_pos) if want_ypos else None, dx, pos_grad(d_xk_in, x_pos),
            d_wk, dxk.sum(dim=(0, 1)), d_wv, dxv.sum(dim=(0, 1)), d_wq, d_bq)


def x2y_flash16_bwd(y_in, y_pos, x_in, x_pos, wk, bk, wv, bv, wq, bq, x_len, probs, attn,
                    g_attn, g_probs=None, g_logits=None, packed=None):
    """The flash bf16 backward on the card (x_pos shared by the batch)."""
    out = _x2y_flash16_bwd_card(y_in, y_pos, x_in, x_pos, wk, bk, wv, bv, wq, bq, x_len, probs,
                                attn, g_attn, g_probs, g_logits, packed)
    x2y_flash16_bwd.launches += 1
    return out


x2y_flash16_bwd.launches = 0


def _x2y_flash16_bwd_card(y_in, y_pos, x_in, x_pos, wk, bk, wv, bv, wq, bq, x_len, probs, attn,
                          g_attn, g_probs, g_logits, packed=None):
    """``x2y_flash16_bwd``'s launches: yq = bf16(bf16(y + y_pos) Wq) + bq
    outside the kernels (as JAX's caller), [xk | xv] from bf16(x + x_pos)
    and x on the bf16 GEMM with f32 results (B16_PROJ, as the forward), the
    f32 form's attention terms (``fk_x2y_flash_attn_bwd``: JAX's kernel
    attends in f32), [dxk | dxv] rounded to bf16, dx = bf16([dxk | dxv] [Wk |
    Wv]^T) on the bf16 GEMM (B16_PROJ16, the weights packed untransposed),
    dWk, dWv on ``fk_b16_wgrad``, the bias sums and d_yq in a fixed order;
    the query side's products stay plain, as in JAX's caller."""
    B, M, _ = y_in.shape
    X, Cx = x_in.shape[1], x_in.shape[2]
    d = wq.shape[1]
    wkp, wvp, _ = _check16("x2y_flash16_bwd", y_in, x_in, wk, bk, wv, bv, wq, bq, x_len, packed)
    if not _shared(x_pos) or not has_backward(M, X, d):
        raise ValueError("x2y_flash16_bwd: needs a shared x_pos and M <= 64")
    g_attn = g_attn.contiguous()
    g_probs = g_probs.contiguous() if g_probs is not None else None
    g_logits = g_logits.contiguous() if g_logits is not None else None
    _build.check_tensors("x2y_flash16_bwd", [probs, attn, g_attn, g_probs, g_logits],
                         x_in.device)
    yin16 = add_pos16(y_in, _pos16(y_pos))
    yq = (rnd(mm(yin16, wq)) + bq).contiguous()
    D = (g_attn * attn).sum(dim=-1)
    if g_probs is not None:
        D = D + (probs * g_probs).sum(dim=-1)
    D = D.contiguous()
    xin, kv, lens = _flash16_project(x_in, x_pos, bk, bv, x_len, wkp, wvp)
    f32 = dict(device=x_in.device, dtype=torch.float32)
    n_t = -(-X // FLASH_KEY_TILE)
    n_slots = -(-n_t // FLASH_SUM_GROUP) * FLASH_SUM_GROUP
    dkv = torch.empty((B, X, 2 * d), **f32)
    part_dyq = torch.zeros((B, n_slots, M * d), **f32)
    part_b = torch.zeros((B, n_slots, 2 * d), **f32)
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    err = _build.lib().fk_x2y_flash_attn_bwd(
        kv.data_ptr(), probs.data_ptr(), ptr(g_probs), ptr(g_logits), g_attn.data_ptr(),
        yq.data_ptr(), D.data_ptr(), x_len.data_ptr(), B, X, M, d, 1.0 / math.sqrt(d),
        dkv.data_ptr(), part_dyq.data_ptr(), part_b.data_ptr(), n_slots,
        _build.stream_ptr(x_in.device))
    _build.check("fk_x2y_flash_attn_bwd", err)
    del kv
    dkv16, _ = b16_round(dkv, lens)
    dx = torch.empty_like(x_in)
    b16_gemm(B16_PROJ16, dkv16, [0], b16_pack(torch.cat([wk, wv], dim=1)), Cx, lens, dx)
    d_wk = rnd(wgrad(xin, 0, Cx, dkv16, 0, d, lens)[0])
    d_wv = rnd(wgrad(x_in, 0, Cx, dkv16, d, d, lens)[0])
    d_xpos = None
    if x_pos is not None and x_pos.requires_grad:  # sum_b dxk_in, from the unrounded sums
        dk_sum = _grad.batch_sum(dkv16.float().contiguous(), d)
        Px = x_pos.shape[-1]
        d_xpos = _pos_like((dk_sum @ rnd(wk).t())[..., :Px], x_pos)
    d_yq = _grad.sum_groups(part_dyq, FLASH_SUM_GROUP).view(B, M, d)
    d_b = _grad.sum_groups(part_b.view(1, B * n_slots, 2 * d), FLASH_SUM_GROUP)[0]
    d_yq_in = d_yq @ rnd(wq).t()
    return (d_yq_in.to(BF16), pos_grad(d_yq_in, y_pos), dx, d_xpos, d_wk, d_b[:d], d_wv,
            d_b[d:], rnd(torch.einsum("bmc,bmd->cd", yin16.float(), d_yq)),
            d_yq.sum(dim=(0, 1)))


class _X2Y16(torch.autograd.Function):
    """K2's bf16 forms for training: the forward saves probs and attn, the
    backward dispatches as JAX's (the kernels with the shared table, else
    the plain backward, counted apart on the card), the plain versions on CPU
    tensors or where ``plain``."""

    @staticmethod
    def forward(ctx, y_in, y_pos, x_in, x_pos, wk, bk, wv, bv, wq, bq, x_len, cfg):
        plain, packed = cfg
        ctx.set_materialize_grads(False)
        args = (y_in, y_pos, x_in, x_pos, wk, bk, wv, bv, wq, bq, x_len)
        if plain or x_in.device.type == "cpu":
            attn, probs, logits = x2y_attention16_reference(*args)
        else:
            fn = x2y_flash16_fwd if x_in.shape[1] >= FLASH_MIN_KEYS else x2y_small_x16_fwd
            attn, probs, logits = fn(*args, packed)
        ctx.plain, ctx.packed = plain, packed
        ctx.save_for_backward(*args, probs, attn)
        return attn, probs, logits

    @staticmethod
    def backward(ctx, g_attn, g_probs, g_logits):
        *args, probs, attn = ctx.saved_tensors
        y_pos, x_in, x_pos = args[1], args[2], args[3]
        if g_attn is None:
            g_attn = torch.zeros_like(attn)
        flash = x_in.shape[1] >= FLASH_MIN_KEYS
        if ctx.plain or x_in.device.type == "cpu":
            grads = x2y16_bwd_reference(*args, probs, attn, g_attn, g_probs, g_logits)
        elif flash and _shared(x_pos):
            grads = x2y_flash16_bwd(*args, probs, attn, g_attn, g_probs, g_logits, ctx.packed)
        elif not flash and _shared(y_pos):
            grads = x2y_small_x16_bwd(*args, probs, g_attn, g_probs, g_logits, ctx.packed)
        else:  # a per-video positional table: JAX's own plain backward (_*_bwd_xla)
            grads = x2y16_bwd_reference(*args, probs, attn, g_attn, g_probs, g_logits)
            x2y_bwd_reference.launches += 1
        return (*grads, None, None)


def x2y_attention16_train(y_in, y_pos, x_in, x_pos, wk, bk, wv, bv, wq, bq, x_len, plain=False,
                          packed=None):
    """The differentiable bf16 X2Y entry (both forms, chosen at JAX's
    threshold): the kernels on CUDA tensors, the plain versions on CPU ones
    or where ``plain``."""
    if x_in.device.type != "cpu" and not plain:
        _build.require_backward("x2y_attention16", has_backward(y_in.shape[1], x_in.shape[1],
                                                                wq.shape[1]))
    return _X2Y16.apply(y_in.contiguous(), y_pos, x_in.contiguous(), x_pos, wk, bk, wv, bv, wq,
                        bq, x_len, (bool(plain), packed))
