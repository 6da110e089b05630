"""Fixed-order sums of the backward kernels (``csrc/grad.cu``), CUDA only.

A weight gradient is a sum over the B*T rows of two streams.  The TPU
kernels accumulate it across their sequential grid; on the H100 ``atb``
writes one partial product per (64 rows of the result, chunk of rows of one
video, tap) and ``reduce`` adds the partials in a fixed order, so a result
never wanders from run to run (no float atomics).
"""

from __future__ import annotations

import torch

from .. import _build
from .pos import kernel_pos

CHUNK = 512  # rows of one video per partial product


def _ptr(t):
    return t.data_ptr() if t is not None else None


def reduce(src, *, G: int, P: int, pstride: int, gstride: int, rows: int, rstride: int,
           cols: int):
    """out[g, r, c] = sum_{p < P} src.flat[g*gstride + p*pstride + r*rstride + c], p in order."""
    out = torch.empty((G, rows, cols), device=src.device, dtype=torch.float32)
    err = _build.lib().fk_reduce(src.data_ptr(), G, P, pstride, gstride, rows, rstride, cols,
                                 out.data_ptr(), _build.stream_ptr(src.device))
    _build.check("fk_reduce", err)
    return out


def atb(A, Bm, *, pos=None, lengths=None, shifts=(0,), per_video: bool = False):
    """sum_t A[b, t + s]^T @ Bm[b, t] for each shift s (rows of A outside
    [0, lengths[b]) read as zero; ``pos`` (1 or B, T, P) adds to A's leading
    channels).  Returns (len(shifts), Ca, Cb), or (B, Ca, Cb) per video."""
    Bt, T, Ca = A.shape
    Cb = Bm.shape[2]
    n_taps = len(shifts)
    step = shifts[1] - shifts[0] if n_taps > 1 else 0
    if any(s != shifts[0] + i * step for i, s in enumerate(shifts)) or (per_video and n_taps > 1):
        raise ValueError("atb: shifts must be evenly spaced (and single per video)")
    pos_t, pos_stride, P = kernel_pos(pos, Bt, T, Ca)
    _build.check_tensors("fk_atb", [A, Bm, pos_t, lengths], A.device)
    per = -(-T // CHUNK)
    n_chunks = Bt * per
    part = torch.empty((n_taps, n_chunks, Ca, Cb), device=A.device, dtype=torch.float32)
    err = _build.lib().fk_atb(A.data_ptr(), _ptr(pos_t), pos_stride, P, _ptr(lengths),
                              shifts[0], step, Bm.data_ptr(), part.data_ptr(), Bt, T, Ca, Cb,
                              CHUNK, n_taps, _build.stream_ptr(A.device))
    _build.check("fk_atb", err)
    n = Ca * Cb
    if per_video:
        return reduce(part, G=Bt, P=per, pstride=n, gstride=per * n, rows=1, rstride=0,
                      cols=n).view(Bt, Ca, Cb)
    return reduce(part, G=n_taps, P=n_chunks, pstride=n, gstride=n_chunks * n, rows=1,
                  rstride=0, cols=n).view(n_taps, Ca, Cb)


def batch_sum(x, cols: int):
    """(B, N, C) -> (1, N, cols): the batch sum of the leading ``cols`` channels."""
    B, N, C = x.shape
    return reduce(x, G=1, P=B, pstride=N * C, gstride=0, rows=N, rstride=C, cols=cols)


def block_sums(part, n_vec: int, C: int):
    """(n_blocks, n_vec, C) per-block column sums -> (n_vec, C)."""
    return reduce(part, G=1, P=part.shape[0], pstride=n_vec * C, gstride=0, rows=n_vec,
                  rstride=C, cols=C)[0]


def sum_groups(part, group: int):
    """(G, n, cols) partials -> (G, cols): each row's sum over n in two
    fixed-order stages, every run of ``group`` partials in order, then the
    runs in order (n a multiple of ``group``).  One stage over many partials
    is a long chain of dependent adds per element: K1's column sums over
    1,536 blocks took 1.23-1.31 ms of the card so, 0.33 in two stages (H100
    80GB HBM3, 700 W)."""
    G, n, cols = part.shape
    runs = n // group
    out = reduce(part, G=G * runs, P=group, pstride=cols, gstride=group * cols, rows=1,
                 rstride=0, cols=cols)
    return reduce(out, G=G, P=runs, pstride=cols, gstride=runs * cols, rows=1, rstride=0,
                  cols=cols).view(G, cols)

