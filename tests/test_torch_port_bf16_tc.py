"""The bf16 forms' launch sequences (K1-K4 under ``TPU.compute_dtype:
bfloat16``) on a model of their C entries, on the CPU.

The kernels run only on the card.  ``FakeB16Lib`` models each new entry on the
raw memory of CPU tensors, as the other fake libraries do: the bf16 GEMM
(``csrc/tc_bf16.cu::fk_b16_gemm``: bf16 operands, exact products summed in
f32 segment by segment, each segment from its own time shift and first
channel, the rows of A outside [0, len) zero, each epilogue's rounding), ``fk_b16_add_pos``, the f32 attention stages that K2's bf16 forms
reuse (``fk_x2y_sx_attn``, ``fk_x2y_flash_attend``), K3's bf16 attention
(``fk_k3_attn16``: per 64-key tile the weights against the tile's max,
rounded to bf16 for the attend sum, then the combine), and K4's bf16 entries
(``fk_sa_qkv16``, ``fk_sa_attn_out16``, ``fk_ffn_fwd16`` with its K slices of
128).  The port's launch sequences (``_mstcn16_fwd_card``,
``_x2y_small_x16_card``, ``_x2y_flash16_card``, ``_mha16_fwd_card``,
``_sa16_fwd_card``, ``_ffn16_fwd_card``) run on it and are held against the
plain bf16 versions: bf16 outputs within 2 bf16 ulps, f32 outputs within
1e-4 of their scale (the same roundings, sums in another order; K3's weights
rounded against each tile's max instead of the row's: 1e-3), a whole tower's
logits within 1e-2 of scale (one-ulp flips compound over layers).
"""

import ctypes
import math

import numpy as np
import pytest
import torch
from test_torch_port_k4_ffn_fwd import FakeFFNFwdLib
from test_torch_port_k6_tc import _ints, _view

from fact_clip_tpu_torch import _build
from fact_clip_tpu_torch.ops import dilated_conv as dc
from fact_clip_tpu_torch.ops import mha_attn as ma
from fact_clip_tpu_torch.ops import sa_layer as sl
from fact_clip_tpu_torch.ops import x2y_attn as xa

torch.set_num_threads(2)
BF = torch.bfloat16
F32_TOL = 1e-4
K3_TOL = 1e-3
TOWER_TOL = 1e-2


def _v16(ptr, n):
    return torch.frombuffer((ctypes.c_uint16 * n).from_address(ptr), dtype=BF)


def _rnd(t):
    return t.to(BF).float()


class FakeB16Lib(FakeFFNFwdLib):
    """The bf16 forms' entries (and the FFN forward's workspace entry,
    inherited), on the memory behind the pointers; ``calls`` lists them."""

    def fk_b16_gemm(self, mode, a, a_ch, nseg, shifts, c0s, kseg, w, N, Kd, B, T, lengths, out,
                    ldo, col_off, bias, res, out2, stream):
        self.calls.append(("b16_gemm", mode))
        assert nseg * kseg <= Kd and (nseg == 1 or kseg % 64 == 0) and a_ch % 8 == 0
        assert 1 <= nseg <= 6 and (res is not None or mode not in (dc.B16_RESID, dc.B16_FUSE))
        A = _v16(a, B * T * a_ch).view(B, T, a_ch).float()
        lens = _ints(lengths, B).clone().clamp(max=T)
        valid = (torch.arange(T)[None, :] < lens[:, None])[..., None]
        A = A * valid  # rows outside [0, len) (TMA's fill) read as zeros
        W = _v16(w, N * Kd).view(N, Kd).float()
        sh = _ints(shifts, nseg).tolist()
        c0 = _ints(c0s, nseg).tolist() if c0s is not None else [0] * nseg
        # f32 sums in the plain versions' order, so that K6's launches give
        # their bits: the residual first (JAX's dx kernel), then the segments
        # in order, each over the channels it has (past a_ch TMA reads zeros);
        # the fuse's product as its two halves, c1 Wt + c2 Wb
        acc = _v16(res, B * T * N).view(B, T, N).float() if mode == dc.B16_RESID else None
        if mode == dc.B16_FUSE:
            assert nseg == 1 and a_ch % 2 == 0
            h = a_ch // 2
            acc = A[..., :h] @ W[:, :h].t() + A[..., h:] @ W[:, h:a_ch].t()
            sh = c0 = []
        for s, (d, c) in enumerate(zip(sh, c0)):
            assert c % 8 == 0 and 0 <= c < a_ch
            k = min(kseg, a_ch - c)
            term = dc._shift(A[..., c:c + k], d) @ W[:, s * kseg:s * kseg + k].t()
            acc = term if acc is None else acc + term
        b = _view(bias, N) if bias is not None else torch.zeros(N)
        v = acc + b
        if mode in (dc.B16_RELU, dc.B16_RESID):
            y = torch.relu(v) if mode == dc.B16_RELU else v
        elif mode == dc.B16_FUSE:
            y = torch.relu(v) + _v16(res, B * T * N).view(B, T, N).float()
            if out2 is not None:
                _v16(out2, B * T * N).view(B, T, N)[:] = (torch.relu(v) * valid).to(BF)
        elif mode == dc.B16_PROJ_RND:
            y = _rnd(acc) + b
        else:
            y = v
        if mode != dc.B16_LOGITS:
            y = y * valid
        if mode in (dc.B16_RELU, dc.B16_RESID, dc.B16_PROJ16, dc.B16_FUSE):
            o = _v16(out, B * T * ldo).view(B, T, ldo)
        else:
            o = _view(out, B * T * ldo).view(B, T, ldo)
        o[..., col_off:col_off + N] = y.to(o.dtype)
        return 0

    def fk_b16_add_pos(self, x, pos, pstride, P, B, N, C, out, stream):
        self.calls.append(("b16_add_pos",))
        X = _v16(x, B * N * C).view(B, N, C).float()
        Bp = B if pstride else 1
        Pt = _v16(pos, Bp * N * P).view(Bp, N, P).float()
        X[..., :P] += Pt
        _v16(out, B * N * C).view(B, N, C)[:] = X.to(BF)
        return 0

    @staticmethod
    def _attend(yq, kv, xl, d, scale):
        X = kv.shape[1]
        logits = (yq @ kv[..., :d].transpose(1, 2)) * scale
        valid = torch.arange(X)[None, None, :] < xl[:, None, None]
        logits = logits.masked_fill(~valid, -1e9)
        probs = torch.softmax(logits, dim=-1)
        return probs @ kv[..., d:], probs, logits

    def fk_x2y_sx_attn(self, yq, kv, xlen, B, Y, X, d, scale, logits, probs, attn, tile, stream):
        self.calls.append(("x2y_sx_attn",))
        assert tile in (8, 16, 32)
        out = self._attend(_view(yq, B * Y * d).view(B, Y, d),
                           _view(kv, B * X * 2 * d).view(B, X, 2 * d), _ints(xlen, B), d, scale)
        for ptr, shape, v in zip((attn, probs, logits), ((B, Y, d), (B, Y, X), (B, Y, X)), out):
            _view(ptr, math.prod(shape)).view(shape)[:] = v
        return 0

    def fk_x2y_flash_attend(self, yq, kv, xlen, B, X, M, d, scale, part_acc, part_ml, logits,
                            probs, attn, rows, stream):
        self.calls.append(("x2y_flash_attend",))
        assert rows % 4 == 0 and 4 <= rows <= 32
        out = self._attend(_view(yq, B * M * d).view(B, M, d),
                           _view(kv, B * X * 2 * d).view(B, X, 2 * d), _ints(xlen, B), d, scale)
        for ptr, shape, v in zip((attn, probs, logits), ((B, M, d), (B, M, X), (B, M, X)), out):
            _view(ptr, math.prod(shape)).view(shape)[:] = v
        return 0

    def fk_k3_attn16(self, kv, q, xlen, B, X, M, H, hd, part_acc, part_ml, out, stats, stream):
        """Per 64-key tile: m_t the tile's max, p = exp(logit - m_t), l_t its
        sum, acc_t = bf16(p) v; a tile wholly past x_len (> 0) m = -1e9, l =
        its keys, acc = 0; then the combine, and where stats is given the
        rows' max logit and weights' sum over the whole row."""
        self.calls.append(("k3_attn16",))
        E = H * hd
        KV = _v16(kv, B * X * 2 * E).view(B, X, 2, H, hd).float()
        Q = _v16(q, B * M * E).view(B, M, H, hd).float()
        xl = _ints(xlen, B).clamp(max=X)
        logits = torch.einsum("bmhd,bxhd->bhmx", Q, KV[:, :, 0])
        valid = torch.arange(X)[None, None, None, :] < xl[:, None, None, None]
        logits = logits.masked_fill(~valid, -1e9)
        ms, ls, accs = [], [], []
        for x0 in range(0, X, 64):
            lg = logits[..., x0:x0 + 64]
            m = lg.amax(dim=-1, keepdim=True)
            p = torch.exp(lg - m)
            acc = torch.einsum("bhmx,bxhd->bhmd", _rnd(p), KV[:, x0:x0 + 64, 1])
            past = ((xl > 0) & (x0 >= xl))[:, None, None, None]
            ms.append(torch.where(past, -1e9, m))
            ls.append(torch.where(past, float(lg.shape[-1]), p.sum(dim=-1, keepdim=True)))
            accs.append(torch.where(past, 0.0, acc))
        m_all = torch.stack(ms).amax(dim=0)
        w = [torch.exp(m - m_all) for m in ms]
        o = sum(wi * a for wi, a in zip(w, accs)) / sum(wi * li for wi, li in zip(w, ls))
        _view(out, B * M * E).view(B, M, H, hd)[:] = o.permute(0, 2, 1, 3)
        if stats:
            m = logits.amax(dim=-1, keepdim=True)
            l_ = torch.exp(logits - m).sum(dim=-1, keepdim=True)
            _view(stats, B * H * M * 2).view(B, H, M, 2)[:] = torch.cat([m, l_], -1)
        return 0

    def fk_sa_qkv16(self, x, pos, Pp, wq, bq, wk, bk, wv, bv, qkv, B, M, E, stream):
        self.calls.append(("sa_qkv16",))
        X = _view(x, B * M * E).view(B, M, E)
        a = X.clone()
        if pos is not None:
            a[..., :Pp] += _view(pos, M * Pp).view(1, M, Pp)
        out = _v16(qkv, B * 3 * M * E).view(B, 3, M, E)
        for i, (src, w, b) in enumerate(zip((a, a, X), (wq, wk, wv), (bq, bk, bv))):
            W = _v16(w, E * E).view(E, E).float()
            out[:, i] = (_rnd(_rnd(src) @ W) + _rnd(_view(b, E))).to(BF)
        return 0

    def fk_sa_attn_out16(self, qkv, bstride, ld, koff, voff, x, wo, bo, gamma, beta, c, y, B, M,
                         E, H, eps, stream):
        self.calls.append(("sa_attn_out16",))
        flat = _v16(qkv, B * bstride).float()
        q, k, v = (torch.as_strided(flat, (B, M, E), (bstride, ld, 1), off)
                   for off in (0, koff, voff))
        hd = E // H
        s = torch.einsum("bmhd,bnhd->bhmn", q.reshape(B, M, H, hd), k.reshape(B, M, H, hd))
        p = _rnd(torch.softmax(s * (1.0 / math.sqrt(hd)), dim=-1))
        C = torch.einsum("bhmn,bnhd->bmhd", p, v.reshape(B, M, H, hd)).reshape(B, M, E)
        _view(c, B * M * E).view(B, M, E)[:] = C
        X = _view(x, B * M * E).view(B, M, E)
        o = C @ _view(wo, E * E).view(E, E) + _view(bo, E)
        _view(y, B * M * E).view(B, M, E)[:] = torch.nn.functional.layer_norm(
            X + o, (E,), _view(gamma, E), _view(beta, E), eps)
        return 0

    def fk_ffn_fwd16(self, x, w1, b1, w2, b2, gamma, beta, ws, y, B, M, E, F, eps, stream):
        self.calls.append(("ffn_fwd16",))
        R = B * M
        off, _, _, total = self._layout(B, M, E, F, backward=False)
        WS = _view(ws, total)
        X, Y = (_view(p, R * E).view(R, E) for p in (x, y))
        W1 = _v16(w1, E * F).view(E, F).float()
        W2 = _view(w2, F * E).view(F, E)
        z1 = _rnd(_rnd(self._sliced(_rnd(X), W1, WS[off["sa"]:])) + _rnd(_view(b1, F)))
        t2 = self._sliced(torch.relu(z1), W2, WS[off["sb"]:])
        gam, bet = _view(gamma, E), _view(beta, E)
        for r in self._ln_tiles(R):
            v = t2[r] + _view(b2, E) + X[r]
            mean, rstd = self._ln_stats(v, eps)
            Y[r] = (v - mean) * rstd * gam + bet
        return 0


@pytest.fixture
def fake(monkeypatch):
    lib = FakeB16Lib()
    monkeypatch.setattr(_build, "lib", lambda: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    return lib


def _ulps(got, ref):
    got, ref = got.float().numpy(), ref.float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 2.0 ** -126))) - 7)
    return float(np.max(np.abs(got - ref) / ulp))


def _rel(got, ref):
    return float((got.float() - ref.float()).abs().max() / ref.float().abs().max().clamp(min=1e-30))


def _bf(rng, shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(BF)


def _f(rng, shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))


def _layers(rng, C, L):
    return [(_f(rng, (3, C, C), (3 * C) ** -0.5), _f(rng, (C,), 0.1), _f(rng, (C, C), C ** -0.5),
             _f(rng, (C,), 0.1), torch.ones(C), torch.zeros(C)) for _ in range(L)]


def test_b16_pack_layout():
    """``b16_pack``: W^T K-major in bf16, each conv tap's segment padded to
    64 values with zeros."""
    rng = np.random.default_rng(0)
    wd = _f(rng, (3, 24, 24))
    p = dc.b16_pack(wd.reshape(72, 24), True, segs=3)
    assert p.shape == (24, 192) and p.dtype == BF
    back = p.view(24, 3, 64)
    assert not back[:, :, 24:].float().any()
    assert torch.equal(back[:, :, :24].float(), _rnd(wd.permute(2, 0, 1)))
    w1 = _f(rng, (40, 16))
    assert torch.equal(dc.b16_pack(w1, True).float(), _rnd(w1.t()))


@pytest.mark.parametrize("C,L,ragged", [(32, 1, False), (24, 3, True), (64, 10, True)])
def test_emulated_k1_tower16(fake, C, L, ragged):
    """K1's bf16 launches (conv3, 1x1 with the residual per layer, then the
    logits) against the plain bf16 tower: one layer's logits within 1e-4 of
    scale, L layers' within 1e-2; padded frames the bias row."""
    rng = np.random.default_rng(C + L)
    B, T, O = 3, 200, 16
    x = _bf(rng, (B, T, C))
    lengths = torch.tensor([T, 133, 0] if ragged else [T] * B, dtype=torch.int32)
    layers = _layers(rng, C, L)
    ow, ob = _f(rng, (C, O), C ** -0.5), _f(rng, (O,), 0.1)
    dil = [2 ** i for i in range(L)]
    got = dc._mstcn16_fwd_card(x, lengths, layers, dil, ow, ob)
    ref = dc.mstcn_stack16_reference(x, lengths, layers, dil, out_w=ow, out_b=ob)
    assert fake.calls == [("b16_gemm", dc.B16_RELU), ("b16_gemm", dc.B16_RESID)] * L + \
        [("b16_gemm", dc.B16_LOGITS)]
    assert _rel(got, ref) <= (F32_TOL if L == 1 else TOWER_TOL), _rel(got, ref)
    if ragged:
        assert torch.equal(got[2], ob.expand(T, O)) and torch.equal(got[1, 133:],
                                                                       ob.expand(T - 133, O))
    # one layer's bf16 stream through an identity out projection (exact)
    one = dc._mstcn16_fwd_card(x, lengths, layers[:1], dil[:1], torch.eye(C), torch.zeros(C))
    ref1 = dc.mstcn_stack16_reference(x, lengths, layers[:1], dil[:1], out_w=torch.eye(C),
                                      out_b=torch.zeros(C))
    assert _ulps(one, ref1) <= 2


@pytest.mark.parametrize("C,L,ragged", [(32, 1, False), (24, 3, True), (64, 10, True)])
def test_emulated_k6_tower16(fake, C, L, ragged):
    """K6's bf16 launches (per layer c1 and c2 into the halves of one
    [c1 | c2] buffer, the fuse with its ReLU and residual, then the logits)
    against the plain bf16 tower, bit for bit (the model of the C entry sums
    in the plain version's order; the training form's saves are held in
    ``test_torch_port_bf16_bwd_tc.py``); padded frames' logits the bias
    row."""
    rng = np.random.default_rng(C + L)
    B, T, O = 3, 200, 16
    x = _bf(rng, (B, T, C))
    lengths = torch.tensor([T, 133, 0] if ragged else [T] * B, dtype=torch.int32)
    layers = [(_f(rng, (3, C, C), (3 * C) ** -0.5), _f(rng, (C,), 0.1),
               _f(rng, (3, C, C), (3 * C) ** -0.5), _f(rng, (C,), 0.1),
               _f(rng, (C, C), (2 * C) ** -0.5), _f(rng, (C, C), (2 * C) ** -0.5),
               _f(rng, (C,), 0.1)) for _ in range(L)]
    ow, ob = _f(rng, (C, O), C ** -0.5), _f(rng, (O,), 0.1)
    dil = [(2 ** (L - 1 - i), 2 ** i) for i in range(L)]
    got = dc._mstcn2_16_fwd_card(x, lengths, layers, dil, ow, ob)
    ref = dc.mstcn2_stack16_reference(x, lengths, layers, dil, out_w=ow, out_b=ob)
    assert fake.calls == ([("b16_gemm", dc.B16_PROJ16)] * 2 + [("b16_gemm", dc.B16_FUSE)]) * L \
        + [("b16_gemm", dc.B16_LOGITS)]
    assert torch.equal(got, ref)
    if ragged:
        assert torch.equal(got[2], ob.expand(T, O))


@pytest.mark.parametrize("X,Y,batched", [(40, 96, False), (11, 130, True), (1100, 40, False),
                                         (3072, 11, False)])
def test_emulated_k2_forms16(fake, X, Y, batched):
    """K2's bf16 forms: y + y_pos and x + x_pos rounded, the projections on
    the bf16 GEMM (small X: yq f32, [xk | xv] rounded before the bias; flash:
    [xk | xv] f32, yq outside), then the f32 attention: attn, probs and
    logits within 1e-4 of scale of the plain bf16 version (x_len 0 too)."""
    rng = np.random.default_rng(X)
    B, C, d = 3, 32, 32
    y, x = _bf(rng, (B, Y, C)), _bf(rng, (B, X, C))
    yp, xp = _bf(rng, (B if batched else 1, Y, C), 0.5), _bf(rng, (1, X, C), 0.5)
    w = [_f(rng, (C, d), 0.2), _f(rng, (d,), 0.1), _f(rng, (C, d), 0.2), _f(rng, (d,), 0.1),
         _f(rng, (C, d), 0.2), _f(rng, (d,), 0.1)]
    x_len = torch.tensor([X, X // 2 + 1, 0], dtype=torch.int32)
    flash = X >= xa.FLASH_MIN_KEYS
    card = xa._x2y_flash16_card if flash else xa._x2y_small_x16_card
    got = card(y, yp, x, xp, *w, x_len)
    ref = xa.x2y_attention16_reference(y, yp, x, xp, *w, x_len)
    gemms = [("b16_gemm", dc.B16_PROJ)] * 2 if flash else \
        [("b16_gemm", dc.B16_PROJ)] + [("b16_gemm", dc.B16_PROJ_RND)] * 2
    attn = [("x2y_flash_attend",)] if flash else [("x2y_sx_attn",)]
    adds = [("b16_add_pos",)] * (1 if flash else 2)
    assert fake.calls == adds + gemms + attn
    for g, r, name in zip(got, ref, ("attn", "probs", "logits")):
        assert _rel(g, r) <= F32_TOL, (name, _rel(g, r))


@pytest.mark.parametrize("M,X,hd", [(40, 3072, 32), (11, 300, 64), (200, 1100, 32)])
def test_emulated_k3_16(fake, M, X, hd):
    """K3's bf16 form: x + pos rounded, k and v bf16 on the GEMM, the
    attention over 64-key tiles on the scaled bf16 queries: the f32 output
    within 1e-3 of scale of the plain version (x_len 0 too)."""
    rng = np.random.default_rng(M)
    B, Cx, H = 3, 64, 2
    E = H * hd
    q, x, pos = _bf(rng, (B, M, E)), _bf(rng, (B, X, Cx)), _bf(rng, (1, X, Cx), 0.5)
    wk, bk, wv, bv = _f(rng, (Cx, E), 0.15), _f(rng, (E,), 0.1), _f(rng, (Cx, E), 0.15), \
        _f(rng, (E,), 0.1)
    x_len = torch.tensor([X, X // 3, 0], dtype=torch.int32)
    got = ma._mha16_fwd_card(q, x, pos, wk, bk, wv, bv, x_len, H)
    ref = ma.mha_cross16_reference(q, x, pos, wk, bk, wv, bv, x_len, num_heads=H)
    assert fake.calls == [("b16_add_pos",), ("b16_gemm", dc.B16_PROJ16),
                          ("b16_gemm", dc.B16_PROJ16), ("k3_attn16",)]
    assert _rel(got, ref) <= K3_TOL, _rel(got, ref)


def test_k3_bf16_scale_is_jaxs():
    """JAX multiplies bf16 queries by a weak-typed 1/sqrt(hd): bf16 itself."""
    assert ma.bf16_scale(32) == float(torch.tensor(32 ** -0.5).to(BF))
    assert ma.bf16_scale(32) != 32 ** -0.5


@pytest.mark.parametrize("B,M,E,H", [(3, 11, 64, 2), (8, 40, 256, 8), (1, 300, 128, 4)])
def test_emulated_k4_16(fake, B, M, E, H):
    """K4's bf16 SA (q | k | v in bf16, the attention and out projection) and
    FFN (x W1 in K slices, z1 rounded, hk W2 f32) launches against their
    plain bf16 versions: within 1e-4 of scale."""
    rng = np.random.default_rng(B * M)
    x, pos = _f(rng, (B, M, E)), _f(rng, (1, M, E), 0.5)
    ws = [_f(rng, (E, E), E ** -0.5) if i % 2 == 0 else _f(rng, (E,), 0.05) for i in range(8)]
    g, b = _f(rng, (E,), 0.1) + 1.0, _f(rng, (E,), 0.1)
    got = sl._sa16_fwd_card(x, pos, *ws, g, b, H, sl.LN_EPS)
    ref = sl.sa_sublayer16_reference(x, pos, *ws, g, b, num_heads=H)
    assert _rel(got, ref) <= F32_TOL, _rel(got, ref)
    Fd = 2 * E
    w1, b1, w2, b2 = _f(rng, (E, Fd), E ** -0.5), _f(rng, (Fd,), 0.1), \
        _f(rng, (Fd, E), Fd ** -0.5), _f(rng, (E,), 0.1)
    got = sl._ffn16_fwd_card(x, w1, b1, w2, b2, g, b, sl.LN_EPS)
    ref = sl.ffn_sublayer16_reference(x, w1, b1, w2, b2, g, b)
    assert _rel(got, ref) <= F32_TOL, _rel(got, ref)
    assert fake.calls == [("sa_qkv16",), ("sa_attn_out16",), ("ffn_fwd16",)]


def test_bf16_forms_refuse_before_any_launch(monkeypatch):
    """Off the CPU, a width the bf16 GEMM does not take (C % 8) or a stream
    that is not bf16 raises before the library is asked for."""
    def no_lib():
        raise AssertionError("the kernel library was asked for")

    monkeypatch.setattr(_build, "lib", no_lib)
    meta = lambda *s, dt=BF: torch.empty(s, device="meta", dtype=dt)  # noqa: E731
    layer = (meta(3, 20, 20, dt=torch.float32), meta(20, dt=torch.float32),
             meta(20, 20, dt=torch.float32), meta(20, dt=torch.float32),
             meta(20, dt=torch.float32), meta(20, dt=torch.float32))
    lens = torch.empty(2, device="meta", dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="C=20"):
        dc.mstcn_stack16(meta(2, 64, 20), lens, [layer], [1],
                         out_w=meta(20, 8, dt=torch.float32), out_b=meta(8, dt=torch.float32))
    with pytest.raises(ValueError, match="bfloat16"):
        dc.mstcn_stack16(meta(2, 64, 24, dt=torch.float32), lens, [layer], [1],
                         out_w=meta(24, 8, dt=torch.float32), out_b=meta(8, dt=torch.float32))
