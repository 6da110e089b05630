"""K2's small-X forward and backward on the port's tensor-core GEMM, on the CPU.

On the card each direction is one library call.  The forward
(``fk_x2y_sx_fwd``, ``csrc/x2y_attn.cu`` on ``csrc/sx_attn.cuh``) preps y +
y_pos and [x + x_pos | x], packs Wq^T, Wk^T and Wv^T, projects yq = (y +
y_pos) Wq + bq and [xk | xv] on the towers' 3xTF32 GEMM (``fk_k6_gemm``,
epilogue kProj32; x_len = 0 projects every key), then runs the logits,
softmax and attend per (tile of 8-32 query rows, video).  The backward
(``fk_x2y_sx_bwd``, ``csrc/x2y_bwd.cu``) recomputes the projections, runs
the attention terms per tile (dlogits in 16-byte rows, dyq, dbq's tile
shares), dy as one more GEMM, dWq, dxk and dxv per video on
``fk_k6_wgrad``, the X side (dx, dWk, dWv, the bias sums, d_xpos where
wanted) and the two-stage fixed-order sums.  Here, without a card,
``FakeK2SxLib`` (``FakeK2Lib`` of ``test_torch_port_k2_tc.py`` and models of
the pack, the strided sum and the two entries, step for step on the raw
memory of CPU tensors, with the kernels' tiles, skips and partial layouts)
stands in for the library; the port's wrappers (``_x2y_small_x_fwd_card``,
``_x2y_small_x_bwd_card``) are held against JAX's ``x2y_attention`` in
interpret mode at X <= 1024 (its ``_small_x_vjp``) and ``jax.vjp`` of it
(the fused Pallas backward where y_pos is shared), and against the f32
plain versions: Y = 1, 37, 100 and 128 (ragged last query tiles), X = 1,
40, 128 and 300, ragged x_len with a video at x_len = 0, no, shared and
per-video positional tables (narrow ones against the plain versions),
g_probs and g_logits non-zero; Cy = 40, Cx = d = 48.

Tolerance: 2e-5 of max(1, the reference's largest value), as in K2's and
K3's files: the split keeps ~2^-22 of each product, f32 sums in another
order.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from test_torch_port_k2_tc import FakeK2Lib
from test_torch_port_k6_tc import _ints, _view

from fact_clip_tpu.ops.pallas.x2y_attn import x2y_attention
from fact_clip_tpu_torch import _build
from fact_clip_tpu_torch.ops import dilated_conv as dc
from fact_clip_tpu_torch.ops import x2y_attn as xa

torch.set_num_threads(2)
TOL = 2e-5
CX = D = 48  # one and a half 32-float K steps
CY = 40


class FakeK2SxLib(FakeK2Lib):
    """``FakeK2Lib``, the pack and strided-sum entries and the two small-X
    entries, step for step as ``csrc/sx_attn.cuh::sx_project`` and the two
    entries launch them: the prep (the lengths, y + y_pos, [x + x_pos | x],
    the padded probs), the packs, the projection GEMMs, then per (tile of
    `tile` query rows, video)
    the logits, probs and attn, or dlogits (rows padded to 16 bytes), dyq and
    dbq's tile share, then dy, the weight products, the X side and the
    fixed-order sums.  Keys at or past x_len compute nothing; a video with
    x_len = 0 attends to every key in the forward and has no dlogit in the
    backward."""

    def fk_k6_pack(self, src, dst, R, S, transpose, kseg, kpad, stream):
        self.calls.append(("pack", transpose))
        assert kseg == kpad == (R if transpose else S)  # one segment, no padding
        w = _view(src, R * S).view(R, S)
        w = w.t().contiguous() if transpose else w
        hi, lo = dc.tf32_split(w)
        out = _view(dst, 2 * w.numel()).view(2, *w.shape)
        out[0], out[1] = hi, lo
        return 0

    def fk_reduce_to(self, src, G, P, pstride, gstride, rows, rstride, cols, out, out_gstride,
                     out_rstride, stream):
        S = _view(src, (G - 1) * gstride + (P - 1) * pstride + (rows - 1) * rstride + cols)
        O = _view(out, (G - 1) * out_gstride + (rows - 1) * out_rstride + cols)
        idx = torch.arange(rows)[:, None] * rstride + torch.arange(cols)[None]
        oidx = torch.arange(rows)[:, None] * out_rstride + torch.arange(cols)[None]
        for g in range(G):
            acc = torch.zeros(rows, cols)
            for p in range(P):
                acc += S[g * gstride + p * pstride + idx]
            O[g * out_gstride + oidx] = acc
        return 0

    def _project(self, y, ypos, ystride, Py, x, xpos, xstride, Px, wq, bq, wk, bk, wv, bv, xlen,
                 B, Y_, X_, Cy, Cx, d, lens, yin, xin, wqp, wkvp, yq, kv, probs=None,
                 probs_p=None):
        self.calls.append(("sx_prep",))
        L, xl = _ints(lens, 2 * B + 1), _ints(xlen, B)
        L[:B], L[2 * B] = Y_, X_
        L[B:2 * B] = torch.where(xl > 0, xl.clamp(max=X_), X_)
        if yin is not None:
            Yi = _view(y, B * Y_ * Cy).view(B, Y_, Cy).clone()
            Yi[..., :Py] += _view(ypos, (B if ystride else 1) * Y_ * Py).view(-1, Y_, Py)
            _view(yin, B * Y_ * Cy)[:] = Yi.flatten()
        if xin is not None:
            Xv = _view(x, B * X_ * Cx).view(B, X_, Cx)
            Xk = Xv.clone()
            Xk[..., :Px] += _view(xpos, (B if xstride else 1) * X_ * Px).view(-1, X_, Px)
            _view(xin, B * X_ * 2 * Cx)[:] = torch.cat([Xk, Xv], -1).flatten()
        if probs_p is not None:
            xp = -(-X_ // 4) * 4
            P = F.pad(_view(probs, B * Y_ * X_).view(B, Y_, X_), (0, xp - X_))
            _view(probs_p, B * Y_ * xp)[:] = P.flatten()
        self.fk_k6_pack(wq, wqp, Cy, d, 1, Cy, Cy, 0)
        self.fk_k6_pack(wk, wkvp, Cx, d, 1, Cx, Cx, 0)
        self.fk_k6_pack(wv, wkvp + 4 * 2 * d * Cx, Cx, d, 1, Cx, Cx, 0)
        one = ctypes.addressof(ONE)
        self.fk_k6_gemm(dc._PROJ32, yin or y, Cy, 1, 1, one, Cy, wqp, d, Cy, B, Y_, lens, yq, d,
                        0, bq, None, None, 0, 0, None, None, None, 0, 0, 1.0, 0)
        two = (ctypes.c_int * 4)(0, 0, 0, Cx if xin is not None else 0)
        self.fk_k6_gemm(dc._PROJ32, xin or x, 2 * Cx if xin is not None else Cx, 2, 1,
                        ctypes.addressof(two), Cx, wkvp, d, Cx, B, X_, lens + 4 * B, kv, 2 * d,
                        d, bk, bv, None, 0, 0, None, None, None, 0, 0, 1.0, 0)

    def fk_x2y_sx_fwd(self, y, ypos, ystride, Py, x, xpos, xstride, Px, wq, bq, wk, bk, wv, bv,
                      xlen, B, Y_, X_, Cy, Cx, d, scale, lens, yin, xin, wqp, wkvp, yq, kv,
                      logits, probs, attn, tile, stream):
        assert all(c % 4 == 0 for c in (d, Cy, Cx, Py, Px)) and 1 <= X_ <= 1024
        assert tile in xa.SX_ROWS and (ypos is None) == (yin is None)
        self._project(y, ypos, ystride, Py, x, xpos, xstride, Px, wq, bq, wk, bk, wv, bv, xlen,
                      B, Y_, X_, Cy, Cx, d, lens, yin, xin, wqp, wkvp, yq, kv)
        self.calls.append(("x2y_sx_attn", tile))
        YQ = _view(yq, B * Y_ * d).view(B, Y_, d)
        KV = _view(kv, B * X_ * 2 * d).view(B, X_, 2 * d)
        LG, PR = (_view(p, B * Y_ * X_).view(B, Y_, X_) for p in (logits, probs))
        AT = _view(attn, B * Y_ * d).view(B, Y_, d)
        xls = _ints(xlen, B)
        keys = torch.arange(X_)
        for b in range(B):
            xl = min(int(xls[b]), X_)
            xk, xv = KV[b, :, :d], KV[b, :, d:]
            nk = xl if xl > 0 else X_
            for y0 in range(0, Y_, tile):
                rows = slice(y0, min(y0 + tile, Y_))
                lg = torch.where(keys < xl, (YQ[b, rows] @ xk.t()) * scale, -1e9)
                p = torch.softmax(lg, -1)
                LG[b, rows], PR[b, rows] = lg, p
                AT[b, rows] = p[:, :nk] @ xv[:nk]
        return 0

    def fk_x2y_sx_bwd(self, y, ypos, ystride, Py, x, xpos, xstride, Px, wq, bq, wk, bk, wv, bv,
                      xlen, probs, gprobs, glogits, gattn, B, Y_, X_, Cy, Cx, d, scale, lens,
                      yin, xin, probs_p, wqp, wqn, wkvp, wkvn, yq, kv, dlog, dyq, part_bq,
                      n_slots, stage, part, dkv, dk, dy, dypos, dwq, dbq, dx, dxpos, dwk, dwv,
                      dbk, dbv, tile, group, kc_y, kc_x, stream):
        xp, n_t = -(-X_ // 4) * 4, -(-Y_ // tile)
        assert all(c % 4 == 0 for c in (d, Cy, Cx, Py, Px)) and 1 <= X_ <= 1024
        assert tile in xa.SX_ROWS and (probs_p is None) == (xp == X_)
        assert n_slots % group == 0 and n_slots >= B * n_t and kc_y % 32 == kc_x % 32 == 0
        self._project(y, ypos, ystride, Py, x, xpos, xstride, Px, wq, bq, wk, bk, wv, bv, xlen,
                      B, Y_, X_, Cy, Cx, d, lens, yin, xin, wqp, wkvp, yq, kv, probs, probs_p)
        self.calls.append(("x2y_sx_attn_bwd", tile))
        KV = _view(kv, B * X_ * 2 * d).view(B, X_, 2 * d)
        P = _view(probs, B * Y_ * X_).view(B, Y_, X_)
        zeros = torch.zeros(B, Y_, X_)
        GP = _view(gprobs, B * Y_ * X_).view(B, Y_, X_) if gprobs is not None else zeros
        GL = _view(glogits, B * Y_ * X_).view(B, Y_, X_) if glogits is not None else zeros
        GA = _view(gattn, B * Y_ * d).view(B, Y_, d)
        DL = _view(dlog, B * Y_ * xp).view(B, Y_, xp)
        DQ = _view(dyq, B * Y_ * d).view(B, Y_, d)
        PB = _view(part_bq, n_slots * d).view(n_slots, d)
        PB[B * n_t:] = 0.0
        xls = _ints(xlen, B)
        keys = torch.arange(X_)
        for b in range(B):
            xl = min(int(xls[b]), X_)
            xk, xv = KV[b, :, :d], KV[b, :, d:]
            for t in range(n_t):
                rows = slice(t * tile, min((t + 1) * tile, Y_))
                if xl <= 0:  # every dlogit 0
                    DL[b, rows], DQ[b, rows], PB[b * n_t + t] = 0.0, 0.0, 0.0
                    continue
                p = P[b, rows]
                dp = GA[b, rows] @ xv.t() + GP[b, rows]
                D = (p * dp)[:, :xl].sum(-1, keepdim=True)
                dl = torch.where(keys < xl, (p * (dp - D) + GL[b, rows]) * scale, 0.0)
                DL[b, rows] = F.pad(dl, (0, xp - X_))
                dq = dl[:, :xl] @ xk[:xl]
                DQ[b, rows], PB[b * n_t + t] = dq, dq.sum(0)
        one = ctypes.addressof(ONE)
        per_y, per_x = -(-Y_ // kc_y), -(-X_ // kc_x)
        xd, lx = X_ * d, lens + 4 * B
        self.fk_k6_pack(wq, wqn, Cy, d, 0, d, d, 0)
        self.fk_k6_gemm(dc._MASKED, dyq, d, 1, 1, one, d, wqn, Cy, d, B, Y_, lens, dy, Cy, 0,
                        None, None, None, 0, 0, None, None, None, 0, 0, 1.0, 0)
        self.fk_k6_wgrad(yin or y, Cy, 0, Cy, dyq, d, 0, d, lens, 0, 0, 1, part, B, Y_, kc_y, 0)
        self.fk_reduce(part, 1, B * per_y, Cy * d, 0, 1, 0, Cy * d, dwq, 0)
        if dypos is not None:
            self.fk_reduce(dy, 1, B, Y_ * Cy, 0, Y_, Cy, Py, dypos, 0)
        self.fk_reduce(part_bq, n_slots // group, group, d, group * d, 1, 0, d, stage, 0)
        self.fk_reduce(stage, 1, n_slots // group, d, 0, 1, 0, d, dbq, 0)
        for c0, (a, bm) in enumerate(((dlog, yq), (probs_p or probs, gattn))):
            self.fk_k6_wgrad(a, xp, 0, X_, bm, d, 0, d, lens, 0, 0, 1, part, B, Y_, kc_y, 0)
            self.fk_reduce_to(part, B, per_y, xd, per_y * xd, X_, d, d, dkv + 4 * c0 * d,
                              2 * xd, 2 * d, 0)
        # the X side
        self.calls.append(("pack_kv",))
        w = torch.cat([_view(wk, Cx * d).view(Cx, d), _view(wv, Cx * d).view(Cx, d)], 1)
        _view(wkvn, 4 * Cx * d).view(2, Cx, 2 * d)[:] = torch.stack(dc.tf32_split(w))
        xa_, xa_ch = (xin, 2 * Cx) if xin is not None else (x, Cx)
        self.fk_k6_gemm(dc._MASKED, dkv, 2 * d, 1, 1, one, 2 * d, wkvn, Cx, 2 * d, B, X_, lx, dx,
                        Cx, 0, None, None, None, 0, 0, None, None, None, 0, 0, 1.0, 0)
        for a_c0, b_c0, out in ((0, 0, dwk), (Cx if xin is not None else 0, d, dwv)):
            self.fk_k6_wgrad(xa_, xa_ch, a_c0, Cx, dkv, 2 * d, b_c0, d, lx, 0, 0, 1, part, B, X_,
                             kc_x, 0)
            self.fk_reduce(part, 1, B * per_x, Cx * d, 0, 1, 0, Cx * d, out, 0)
        runs = -(-B * X_ // group)
        _view(dkv, runs * group * 2 * d)[B * X_ * 2 * d:] = 0.0
        self.fk_reduce(dkv, runs, group, 2 * d, group * 2 * d, 1, 0, 2 * d, part, 0)
        self.fk_reduce(part, 1, runs, 2 * d, 0, 1, 0, d, dbk, 0)
        self.fk_reduce(part + 4 * d, 1, runs, 2 * d, 0, 1, 0, d, dbv, 0)
        if dxpos is not None:
            Bx = B if xstride else 1
            self.fk_reduce_to(dkv, Bx, B if Bx == 1 else 1, 2 * xd, 2 * xd, X_, 2 * d, d, dk, xd,
                              d, 0)
            self.fk_k6_gemm(dc._MASKED, dk, d, 1, 1, one, d, wkvn, Cx, 2 * d, Bx, X_,
                            lens + 8 * B if Bx == 1 else lx, dxpos, Cx, 0, None, None, None, 0,
                            0, None, None, None, 0, 0, 1.0, 0)
        return 0


ONE = (ctypes.c_int * 2)(0, 0)  # one segment, no shift, channel 0


@pytest.fixture
def fake(monkeypatch):
    lib = FakeK2SxLib()
    monkeypatch.setattr(_build, "lib", lambda: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    return lib


def _pair(rng, shape, scale=1.0):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _inputs(seed, Y, X, xlen, y_pos, x_pos, Py=CY, Px=CX):
    """(jax list, torch list) of x2y_attention's arguments: y (B, Y, CY) with
    y_pos "none" (JAX: zeros), "shared" or "per_video" on its Py leading
    channels, x (B, X, CX) with x_pos False (JAX: zeros), True (shared) or
    "per_video" on its Px leading channels."""
    rng = np.random.default_rng(seed)
    B = len(xlen)
    y, x = _pair(rng, (B, Y, CY)), _pair(rng, (B, X, CX))
    yp = None if y_pos == "none" else _pair(rng, (B if y_pos == "per_video" else 1, Y, Py), 0.5)
    xp = _pair(rng, (B if x_pos == "per_video" else 1, X, Px), 0.5) if x_pos else None
    w = [_pair(rng, (CX, D), 0.15), _pair(rng, (D,), 0.05), _pair(rng, (CX, D), 0.15),
         _pair(rng, (D,), 0.05), _pair(rng, (CY, D), 0.15), _pair(rng, (D,), 0.05)]
    xl = np.array(xlen, np.int32)
    j = [y[0], jnp.zeros((1, Y, CY), jnp.float32) if yp is None else yp[0], x[0],
         jnp.zeros((1, X, CX), jnp.float32) if xp is None else xp[0], *[a[0] for a in w],
         jnp.asarray(xl)]
    t = [y[1], None if yp is None else yp[1], x[1], None if xp is None else xp[1],
         *[a[1] for a in w], torch.from_numpy(xl)]
    return j, t


def _close(got, ref, tol=TOL, what=""):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max()))
    assert float(np.abs(got - ref).max()) <= tol * scale, (what, float(np.abs(got - ref).max()))


PROJECT = [("sx_prep",), ("pack", 1), ("pack", 1), ("pack", 1), ("gemm", dc._PROJ32),
           ("gemm", dc._PROJ32)]  # sx_project: the prep, Wq^T, Wk^T, Wv^T, yq, [xk | xv]


def _rows(monkeypatch, rows):
    """Tiles of ``rows`` query rows (the card takes 32 or 16 from 264 blocks up)."""
    monkeypatch.setattr(xa, "sx_rows", lambda *shape: rows)


FWD_CASES = [  # Y, X, x_len, y_pos, x_pos, query rows per tile
    (1, 40, [40, 17], "shared", True, 8),
    (37, 300, [300, 0, 123], "per_video", False, 8),
    (100, 1, [1, 0], "none", True, 16),
    (100, 40, [40, 0, 7], "per_video", True, 32),
]


@pytest.mark.parametrize("Y,X,xlen,y_pos,x_pos,rows", FWD_CASES)
def test_emulated_small_x_forward_matches_jax(fake, monkeypatch, Y, X, xlen, y_pos, x_pos, rows):
    """The forward's launches against JAX's ``x2y_attention`` in interpret
    mode (``_small_x_vjp``) and the plain version: attn, probs, logits (the
    masked logits exactly -1e9; a video with x_len = 0 attends uniformly)."""
    _rows(monkeypatch, rows)
    j, t = _inputs(1, Y, X, xlen, y_pos, x_pos)
    ref = x2y_attention(*j, interpret=True)
    got = xa._x2y_small_x_fwd_card(*t)
    assert fake.calls == PROJECT + [("x2y_sx_attn", rows)]
    plain = xa.x2y_attention_reference(*t)
    for name, g, r, p in zip(("attn", "probs", "logits"), got, ref, plain):
        _close(g.numpy(), r, what=name)
        _close(g.numpy(), p.numpy(), what=name)
    logits = got[2].numpy()
    for b, xl in enumerate(xlen):
        assert (logits[b, :, xl:] == -1e9).all()
        if xl == 0:
            np.testing.assert_allclose(got[1][b].numpy(), 1.0 / X, rtol=1e-6)


GRADS = ("d_y", "d_ypos", "d_x", "d_xpos", "d_wk", "d_bk", "d_wv", "d_bv", "d_wq", "d_bq")
BWD_CASES = [  # Y, X, x_len, y_pos, x_pos, query rows per tile
    (1, 40, [40, 17], "shared", True, 8),
    (37, 300, [300, 0, 123], "shared", False, 8),
    (100, 1, [1, 0], "none", True, 16),
    (100, 40, [40, 0, 7], "shared", True, 32),
    (37, 128, [128, 90], "shared", "per_video", 8),  # the TDU's per-video segment positions
]


def _vjp(j, rng):
    """JAX's forward (interpret mode) and the cotangents of all ten float
    inputs for seeded (g_attn, g_probs, g_logits)."""
    def f(*a):
        return x2y_attention(*a, j[10], interpret=True)

    outs, vjp = jax.vjp(f, *j[:10])
    g = [(rng.standard_normal(o.shape) * s).astype(np.float32)
         for o, s in zip(outs, (1.0, 0.1, 0.1))]
    return [np.array(o) for o in outs], g, vjp(tuple(jnp.asarray(a) for a in g))


def _run_bwd(t, outs, g):
    probs = torch.from_numpy(outs[1])
    gt = [torch.from_numpy(a) for a in g]
    return xa._x2y_small_x_bwd_card(*t, probs, *gt), (probs, gt)


def _bwd_calls(rows, x_pos):
    """The backward's launches but the sums: the projections, the attention
    terms, Wq's pack, dy, dWq, dxk and dxv on the weight-product kernel, then
    the X side: [Wk | Wv]'s pack, dx, dWk, dWv (and d_xpos's product)."""
    return (PROJECT + [("x2y_sx_attn_bwd", rows), ("pack", 0), ("gemm", dc._MASKED)]
            + [("wgrad", 1)] * 3 + [("pack_kv",), ("gemm", dc._MASKED)] + [("wgrad", 1)] * 2
            + [("gemm", dc._MASKED)] * bool(x_pos))


@pytest.mark.parametrize("Y,X,xlen,y_pos,x_pos,rows", BWD_CASES)
def test_emulated_small_x_backward_matches_jax_vjp(fake, monkeypatch, Y, X, xlen, y_pos, x_pos,
                                                   rows):
    """The backward's launches from JAX's forward saves against ``jax.vjp``
    of JAX's small-X form in interpret mode (its fused Pallas backward, y_pos
    shared or zeros) and against the plain backward: every cotangent (d_ypos
    and d_xpos None where the port has no table, as the entry returns)."""
    _rows(monkeypatch, rows)
    j, t = _inputs(2, Y, X, xlen, y_pos, x_pos)
    outs, g, refs = _vjp(j, np.random.default_rng(3))
    got, (probs, gt) = _run_bwd(t, outs, g)
    assert [c for c in fake.calls if c[0] != "reduce"] == _bwd_calls(rows, x_pos)
    plain = xa.x2y_bwd_reference(*t, probs, *gt)
    for i, name in enumerate(GRADS):
        if (name, y_pos) == ("d_ypos", "none") or (name, x_pos) == ("d_xpos", False):
            assert got[i] is None and plain[i] is None
            continue
        _close(got[i].numpy(), refs[i], what=name)
        _close(got[i].numpy(), plain[i].numpy(), what=name)
    for b, xl in enumerate(xlen):
        if xl == 0:  # no gradient through the constant -1e9 logits, but dxv takes every key
            assert float(np.abs(got[2][b].numpy()).max()) > 1e-3


def test_emulated_small_x_with_narrow_positional_tables_matches_plain(fake):
    """A y_pos over the leading 24 of the 40 query channels (epic's tables
    are 256 wide on a 512-wide stream) and a per-video x_pos over 24 of the
    48 key channels: the forward's y + y_pos and [x + x_pos | x], the
    backward's dWq, d_ypos, dWk and d_xpos against the plain versions; and
    without the positional cotangents where they are not wanted."""
    j, t = _inputs(4, 37, 40, [40, 9], "shared", "per_video", Py=24, Px=24)
    got = xa._x2y_small_x_fwd_card(*t)
    plain = xa.x2y_attention_reference(*t)
    for name, g, p in zip(("attn", "probs", "logits"), got, plain):
        _close(g.numpy(), p.numpy(), what=name)
    rng = np.random.default_rng(5)
    g = [torch.from_numpy((rng.standard_normal(o.shape) * s).astype(np.float32))
         for o, s in zip(plain, (1.0, 0.1, 0.1))]
    grads = xa._x2y_small_x_bwd_card(*t, plain[1], *g)
    ref = xa.x2y_bwd_reference(*t, plain[1], *g)
    for name, a, r in zip(GRADS, grads, ref):
        assert a.shape == r.shape, name
        _close(a.numpy(), r.numpy(), what=name)
    fake.calls.clear()
    unwanted = xa._x2y_small_x_bwd_card(*t, plain[1], *g, False, False)
    assert unwanted[1] is None and unwanted[3] is None
    assert fake.calls.count(("gemm", dc._MASKED)) == 2  # dy and dx: no d_xpos product
    for i in (0, 2, 4, 5, 6, 7, 8, 9):
        assert torch.equal(unwanted[i], grads[i]), GRADS[i]


def test_emulated_small_x_backward_gives_the_same_bits_twice(fake, monkeypatch):
    """dbq's tile shares go through two fixed-order stages (runs of
    SX_SUM_GROUP slots, then the runs), dWq, dxk and dxv through fk_reduce's
    fixed order: two runs on the same inputs give the same bits."""
    _rows(monkeypatch, 16)
    j, t = _inputs(6, 100, 40, [40, 0, 7], "shared", True)
    outs, g, _ = _vjp(j, np.random.default_rng(7))
    seen = []
    reduce = fake.fk_reduce

    def spy(src, G, P, *rest):
        seen.append((G, P))
        return reduce(src, G, P, *rest)

    fake.fk_reduce = spy
    first, _ = _run_bwd(t, outs, g)
    # 3 videos x 7 tiles of 16 rows = 21 shares in 32 slots: runs of 16, then 2 runs
    assert (2, xa.SX_SUM_GROUP) in seen and (1, 2) in seen
    second, _ = _run_bwd(t, outs, g)
    for name, a, b in zip(GRADS, first, second):
        assert torch.equal(a, b), name


def test_small_x_tiles_and_limits():
    """32-row tiles where they fit and give two blocks an SM (the flagship's
    8 x 3072, Breakfast's 4 x 4096), else the tallest that gives one, else 8
    (epic's B = 1-2 and Y = 256-300, the TDU's 8 x 40), in both directions;
    an 8-row block fits wherever a 16-row one does; a block of 16 rows
    holds a (16, d) tile and (16, X) logits: d up to 2,084 at X = 1024."""
    assert xa.sx_rows(8, 3072, 40, 512) == 32 and xa.sx_rows(4, 4096, 60, 512) == 32
    assert xa.sx_rows(8, 1000, 40, 512) == 16 and xa.sx_rows(8, 3072, 1024, 746) == 16
    assert xa.sx_rows(1, 2200, 40, 512) == 8 and xa.sx_rows(2, 700, 40, 512) == 8
    assert xa.sx_rows(2, 300, 256, 512) == 8 and xa.sx_rows(1, 256, 300, 512) == 8
    assert xa.sx_rows(8, 40, 128, 512) == 8
    for X in (1, 40, 300, 1024):
        for d in (48, 512, 2084):
            if xa.sx_smem(X, d, 16) <= _build.MAX_SMEM:
                assert xa.sx_smem(X, d, 8) <= _build.MAX_SMEM, (X, d)
    assert xa.has_backward(3072, 1024, 2084) and not xa.has_backward(3072, 1024, 2088)
    assert xa.sx_smem(1024, 746) <= _build.MAX_SMEM  # the widest d served before the redesign


def test_emulated_small_x_refuses_before_any_launch(monkeypatch):
    """A per-video y_pos in the backward (JAX's plain backward runs there)
    raises ValueError, and a width the GEMMs' 16-byte rows cannot take or a
    block too large for shared memory NotImplementedError, before the
    library is asked for (meta tensors for the card's)."""
    def no_lib():
        raise AssertionError("the kernel library was asked for")

    monkeypatch.setattr(_build, "lib", no_lib)
    meta = lambda *s: torch.empty(s, device="meta")  # noqa: E731
    x_len = torch.empty((2,), dtype=torch.int32, device="meta")

    def args(Y, X, Cy, Cx, d, y_pos, bwd=False):
        a = (meta(2, Y, Cy), y_pos, meta(2, X, Cx), None, meta(Cx, d), meta(d), meta(Cx, d),
             meta(d), meta(Cy, d), meta(d), x_len)
        return a + (meta(2, Y, X), meta(2, Y, d)) if bwd else a  # + probs, g_attn

    with pytest.raises(ValueError, match="x2y_small_x_bwd"):
        xa.x2y_small_x_bwd(*args(37, 40, CY, CX, D, meta(2, 37, CY), True))
    for fn, a in ((xa.x2y_small_x_fwd, args(37, 40, CY, CX, 50, None)),
                  (xa.x2y_small_x_fwd, args(37, 40, 42, CX, D, None)),
                  (xa.x2y_small_x_fwd, args(37, 1024, CY, CX, 4096, None)),
                  (xa.x2y_small_x_bwd, args(37, 40, CY, CX, 50, None, True))):
        with pytest.raises(NotImplementedError):
            fn(*a)
