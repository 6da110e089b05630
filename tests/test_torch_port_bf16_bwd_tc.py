"""The bf16 backward forms' launch sequences (bf16 training) on a model of
their C entries, on the CPU.

The kernels run only on the card.  ``FakeB16BwdLib`` is ``FakeB16Lib`` (the
bf16 forwards' entries, ``tests/test_torch_port_bf16_tc.py``) with the f32
entries the backward forms reuse (``FakeK2Lib``'s: the towers' GEMM, the
weight products, the fixed-order reduce, K2's flash attention backward) and
a model of each new entry on the raw memory of CPU tensors:
``fk_b16_wgrad`` (per tap and chunk of one video's frames, products of bf16
values summed in f32), ``fk_b16_round`` (the frame mask, the ReLU gate, the
rounding, per-block column sums), ``fk_k3_attn_bwd16`` (per key tile,
JAX's roundings of g, dl, p and dK / dV), ``fk_x2y_sx_attn_bwd`` (the small-X attention
terms), ``fk_ffn_bwd16`` (``fk_ffn_bwd``'s steps with z1 and bf16(dz1)
rounded) and ``fk_sa_bwd16`` (the SA backward's nine launches).  The port's
launch sequences (``_mstcn16_fwd_card(save=True)``, ``_mstcn16_bwd_card``,
K6's ``_mstcn2_16_fwd_card(save=True)`` and ``_mstcn2_16_bwd_card``,
``_x2y_small_x16_bwd_card``, ``_x2y_flash16_bwd_card``, ``_mha16_bwd_card``,
``_sa16_bwd_card``, ``_ffn16_bwd_card``) run on it and are held against the
plain versions: each cotangent within 2^-7 of its scale (the same roundings
of f32 sums formed in another order: a rounding may land one bf16 ulp
apart), a sum that cancels to about 0 (dbk) against a neighbour's scale.
"""

import math

import numpy as np
import pytest
import torch
from test_torch_port_bf16_tc import FakeB16Lib, _rnd, _v16
from test_torch_port_k2_tc import FakeK2Lib
from test_torch_port_k6_tc import _ints, _view

from fact_clip_tpu_torch import _build
from fact_clip_tpu_torch.ops import dilated_conv as dc
from fact_clip_tpu_torch.ops import mha_attn as ma
from fact_clip_tpu_torch.ops import sa_layer as sl
from fact_clip_tpu_torch.ops import x2y_attn as xa

torch.set_num_threads(2)
BF = torch.bfloat16
TOL = 2.0 ** -7


class FakeB16BwdLib(FakeB16Lib, FakeK2Lib):
    """The bf16 backward forms' entries, beside the forwards' and the f32
    ones they reuse; ``calls`` lists them."""

    def __init__(self):
        FakeB16Lib.__init__(self)
        self.bwd_keeps = []

    def fk_b16_wgrad(self, A, a_ch, a_c0, Ca, Bm, b_ch, b_c0, Cb, lengths, shift0, step, n_taps,
                     part, B, T, Kc, stream):
        self.calls.append(("b16_wgrad", n_taps))
        assert a_ch % 8 == 0 and b_ch % 8 == 0 and Kc % 64 == 0
        Av = _v16(A, B * T * a_ch).view(B, T, a_ch).float()
        Bv = _v16(Bm, B * T * b_ch).view(B, T, b_ch).float()
        lens = _ints(lengths, B)
        per = -(-T // Kc)
        P = _view(part, n_taps * B * per * Ca * Cb).view(n_taps, B * per, Ca, Cb)
        for tap in range(n_taps):
            shift = shift0 + tap * step
            for b in range(B):
                L = min(int(lens[b]), T)
                for c in range(per):
                    t = torch.arange(c * Kc, min((c + 1) * Kc, T))
                    ok = (t < L) & (t + shift >= 0) & (t + shift < L)
                    a = torch.zeros(len(t), Ca)
                    bm = torch.zeros(len(t), Cb)
                    a[ok] = Av[b, t[ok] + shift, a_c0:a_c0 + Ca]
                    bm[ok] = Bv[b, t[ok], b_c0:b_c0 + Cb]
                    P[tap, b * per + c] = a.t() @ bm
        return 0

    def fk_b16_round(self, src, in16, gate, lengths, B, T, C, R, out, part, stream):
        self.calls.append(("b16_round", gate is not None))
        n = B * T * C
        v = (_v16(src, n) if in16 else _view(src, n)).view(B, T, C).float()
        lens = _ints(lengths, B).clamp(max=T)
        v = v * (torch.arange(T)[None, :] < lens[:, None])[..., None]
        if gate is not None:
            v = torch.where(_v16(gate, n).view(B, T, C).float() > 0, v, 0.0)
        if out is not None:
            _v16(out, n).view(B, T, C)[:] = v.to(BF)
        if part is not None:
            nb = -(-T // R)
            P = _view(part, B * nb * C).view(B, nb, C)
            for i in range(nb):
                P[:, i] = v[:, i * R:(i + 1) * R].sum(dim=1)
        return 0

    def fk_k3_attn_bwd16(self, kv, q, g, stats, Dr, xlen, B, X, M, H, hd, dkv, part_dq, part_b,
                         n_slots, key_tile, stream):
        self.calls.append(("k3_attn_bwd16", key_tile))
        E, BK = H * hd, key_tile
        n_t = -(-X // BK)
        assert n_slots >= n_t
        KV = _v16(kv, B * X * 2 * E).view(B, X, 2 * E).float()
        Q = _v16(q, B * M * E).view(B, M, H, hd).float()
        G = _rnd(_view(g, B * M * E).view(B, M, H, hd))
        ST = _view(stats, B * H * M * 2).view(B, H, M, 2)
        DR = _view(Dr, B * H * M).view(B, H, M)
        DKV = _v16(dkv, B * X * 2 * E).view(B, X, 2 * E)
        PQ = _view(part_dq, B * n_slots * M * E).view(B, n_slots, M, E)
        PB = _view(part_b, B * n_slots * 2 * E).view(B, n_slots, 2 * E)
        lens = _ints(xlen, B)
        for b in range(B):
            xl = min(int(lens[b]), X)
            for t in range(n_t):
                keys = torch.arange(t * BK, min((t + 1) * BK, X))
                if xl > 0 and t * BK >= xl:
                    PQ[b, t] = 0.0
                    DKV[b, keys] = 0.0
                    PB[b, t] = 0.0
                    continue
                K = KV[b, keys, :E].view(-1, H, hd)
                V = KV[b, keys, E:].view(-1, H, hd)
                valid = keys < xl
                lg = torch.einsum("mhd,jhd->hmj", Q[b], K).masked_fill(~valid, -1e9)
                p = torch.exp(lg - ST[b, ..., :1]) * (1.0 / ST[b, ..., 1:].clamp_min(1e-30))
                dp = torch.einsum("mhd,jhd->hmj", G[b], V)
                dl = _rnd(torch.where(valid, p * (dp - DR[b][..., None]), 0.0))
                PQ[b, t] = torch.einsum("hmj,jhd->mhd", dl, K).reshape(M, E)
                dk = torch.einsum("hmj,mhd->jhd", dl, Q[b]).reshape(-1, E)
                dv = torch.einsum("hmj,mhd->jhd", _rnd(p), G[b]).reshape(-1, E)
                DKV[b, keys] = torch.cat([dk, dv], 1).to(BF)
                PB[b, t] = torch.cat([dk.sum(0), dv.sum(0)])
        return 0

    def fk_x2y_sx_attn_bwd(self, kv, probs, gprobs, glogits, gattn, xlen, B, Y, X, d, scale,
                           dlog, dyq, part_bq, n_slots, tile, stream):
        self.calls.append(("x2y_sx_attn_bwd", tile))
        n_blk = B * -(-Y // tile)
        assert tile in (8, 16, 32) and n_slots >= n_blk
        KV = _view(kv, B * X * 2 * d).view(B, X, 2 * d)
        P = _view(probs, B * Y * X).view(B, Y, X)
        zeros = torch.zeros(B, Y, X)
        GP = _view(gprobs, B * Y * X).view(B, Y, X) if gprobs is not None else zeros
        GL = _view(glogits, B * Y * X).view(B, Y, X) if glogits is not None else zeros
        GA = _view(gattn, B * Y * d).view(B, Y, d)
        dprobs = GP + GA @ KV[..., d:].transpose(1, 2)
        dl = P * (dprobs - (P * dprobs).sum(dim=-1, keepdim=True)) + GL
        valid = torch.arange(X)[None, None, :] < _ints(xlen, B)[:, None, None]
        dl = torch.where(valid, dl * scale, 0.0)
        xp = -(-X // 4) * 4
        DL = _view(dlog, B * Y * xp).view(B, Y, xp)
        DL[:] = 0.0
        DL[..., :X] = dl
        DQ = _view(dyq, B * Y * d).view(B, Y, d)
        DQ[:] = dl @ KV[..., :d]
        PB = _view(part_bq, n_slots * d).view(n_slots, d)
        PB[:] = 0.0
        nt = -(-Y // tile)
        for b in range(B):
            for t in range(nt):
                PB[b * nt + t] = DQ[b, t * tile:(t + 1) * tile].sum(0)
        return 0

    def fk_ffn_bwd16(self, x, w1, w1r, b1, w2, b2, gamma, g, ws, B, M, E, F, eps, stream):
        self.calls.append(("ffn_bwd16",))
        R = B * M
        off, ldl, ldr, total = self._layout(B, M, E, F)
        WS = _view(ws, total)

        def region(name, *shape):
            n = int(np.prod(shape))
            return WS[off[name]:off[name] + n].view(*shape)

        X, G = (_view(p, R * E).view(R, E) for p in (x, g))
        W1 = _v16(w1, E * F).view(E, F).float()
        W1r, W2 = _view(w1r, E * F).view(E, F), _view(w2, F * E).view(F, E)
        assert torch.equal(W1r, W1)
        bias1, bias2, gam = _view(b1, F), _view(b2, E), _view(gamma, E)
        WT = region("wt", 2 * E * F)
        W1T, W2T = WT[:E * F].view(F, E), WT[E * F:].view(E, F)
        RS, DX, Z = region("res", R, E), region("dx", R, E), region("z1", R, F)
        LHS, RHS = region("lhs", 2, R, ldl), region("rhs", 2, R, ldr)
        DZ, HK, DT2 = LHS[0, :, :F], LHS[1, :, :F], RHS[1, :, :E]
        ln_rows = self._ln_tiles(R)
        PART = region("part", len(ln_rows), 2, E)
        SA = region("sa", -(-E // self.SLICE) * R * F)
        SB = region("sb", -(-F // self.SLICE) * R * E)
        W1T[:], W2T[:] = W1r.t(), W2.t()
        RHS[0, :, :E] = X
        LHS[:, :, F] = 1.0
        RHS[:, :, E] = 1.0
        Z[:] = _rnd(_rnd(self._sliced(_rnd(X), W1, SA)) + _rnd(bias1))
        HK[:] = torch.relu(Z)
        t2 = self._sliced(HK, W2, SB)
        for i, r in enumerate(ln_rows):
            v = (t2[r] + bias2) + X[r]
            mean, rstd = self._ln_stats(v, eps)
            xhat = (v - mean) * rstd
            gg = G[r] * gam
            PART[i, 0], PART[i, 1] = (G[r] * xhat).sum(dim=0), G[r].sum(dim=0)
            d = rstd * (gg - gg.mean(dim=-1, keepdim=True)
                        - xhat * (gg * xhat).mean(dim=-1, keepdim=True))
            RS[r] = d
            DT2[r] = d
        DZ[:] = torch.where(Z > 0, self._sliced(DT2, W2T, SA), 0.0)
        DX[:] = self._sliced(_rnd(DZ), W1T, SB) + RS
        out = region("dgb", 2, E)
        out[:] = 0.0
        for i in range(len(ln_rows)):
            out += PART[i]
        return 0

    def fk_sa_bwd16(self, x, pos, Pp, wq, bq, wk, bk, wv, bv, wo, bo, gamma, woT, wqkT, wvT, g,
                    qkv, c, t, dres, dout, dO, grads, grads_r, dxa, part, dx, dw, B, M, E, H, eps,
                    stream):
        self.calls.append(("sa_bwd16",))
        R, hd = B * M, E // H
        X = _view(x, R * E).view(B, M, E)
        P16 = _view(pos, M * Pp).view(1, M, Pp) if pos is not None else None
        assert torch.equal(_view(woT, E * E).view(E, E), _view(wo, E * E).view(E, E).t())
        a = X.clone()
        if P16 is not None:
            a[..., :Pp] += P16
        a = _rnd(a)
        Wq, Wk, Wv = (_v16(w, E * E).view(E, E).float() for w in (wq, wk, wv))
        assert torch.equal(_v16(wqkT, 2 * E * E).view(2 * E, E).float(), torch.cat([Wq, Wk], 1).t())
        assert torch.equal(_v16(wvT, E * E).view(E, E).float(), Wv.t())
        q = _rnd(_rnd(a @ Wq) + _rnd(_view(bq, E))).view(B, M, H, hd)
        k = _rnd(_rnd(a @ Wk) + _rnd(_view(bk, E))).view(B, M, H, hd)
        v = _rnd(_rnd(_rnd(X) @ Wv) + _rnd(_view(bv, E))).view(B, M, H, hd)
        s = torch.einsum("bmhd,bnhd->bhmn", q, k) * (1.0 / math.sqrt(hd))
        e = torch.exp(s - s.amax(-1, keepdim=True))
        p = e / e.sum(-1, keepdim=True)
        C = torch.einsum("bhmn,bnhd->bmhd", _rnd(p), v).reshape(R, E)
        _view(c, R * E).view(R, E)[:] = C
        Wo = _view(wo, E * E).view(E, E)
        T_ = C @ Wo
        _view(t, R * E).view(R, E)[:] = T_
        G = _view(g, R * E).view(R, E)
        Xr = X.reshape(R, E)
        gam = _view(gamma, E)
        DR = _view(dres, R * E).view(R, E)
        tiles = -(-R // 16)
        PART = _view(part, tiles * 2 * E).view(tiles, 2, E)
        for i in range(tiles):
            r = slice(16 * i, min(R, 16 * (i + 1)))
            vv = T_[r] + _view(bo, E) + Xr[r]
            mean, rstd = self._ln_stats(vv, eps)
            xhat = (vv - mean) * rstd
            gg = G[r] * gam
            PART[i, 0], PART[i, 1] = (G[r] * xhat).sum(0), G[r].sum(0)
            DR[r] = rstd * (gg - gg.mean(-1, keepdim=True)
                            - xhat * (gg * xhat).mean(-1, keepdim=True))
        _view(dout, R * E).view(R, E)[:] = DR
        DO = DR @ Wo.t()
        _view(dO, R * E).view(R, E)[:] = DO
        do = DO.view(B, M, H, hd)
        dv = torch.einsum("bhmn,bmhd->bnhd", _rnd(p), do).reshape(R, E)
        dp = torch.einsum("bmhd,bnhd->bhmn", do, v)
        ds = _rnd(p * (dp - (p * dp).sum(-1, keepdim=True)) * (1.0 / math.sqrt(hd)))
        dq = torch.einsum("bhmn,bnhd->bmhd", ds, k).reshape(R, E)
        dk = torch.einsum("bhmn,bmhd->bnhd", ds, q).reshape(R, E)
        GR = _view(grads, R * 3 * E).view(R, 3 * E)
        GR[:] = torch.cat([dq, dk, dv], 1)
        GRR = _view(grads_r, R * 3 * E).view(R, 3 * E)
        GRR[:] = _rnd(GR)
        DXA = _view(dxa, R * E).view(R, E)
        DXA[:] = GRR[:, :2 * E] @ torch.cat([Wq, Wk], 1).t()
        _view(dx, R * E).view(R, E)[:] = (DR + DXA) + GRR[:, 2 * E:] @ Wv.t()
        DW = _view(dw, 4 * E * E)
        DW[:2 * E * E] = (a.reshape(R, E).t() @ GRR[:, :2 * E]).reshape(-1)
        DW[2 * E * E:3 * E * E] = (_rnd(Xr).t() @ GRR[:, 2 * E:]).reshape(-1)
        DW[3 * E * E:] = (C.t() @ DR).reshape(-1)
        return 0


@pytest.fixture
def fake(monkeypatch):
    lib = FakeB16BwdLib()
    monkeypatch.setattr(_build, "lib", lambda: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    return lib


def _bf(rng, shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(BF)


def _f(rng, shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))


def _check(names, got, ref, scales=None):
    for name, g, r in zip(names, got, ref):
        if r is None or g is None:
            assert g is None or r is None, name
            continue
        s = dict(zip(names, ref))[scales[name]] if scales and name in scales else r
        err = float((g.float() - r.float()).abs().max() / s.float().abs().max().clamp(min=1e-30))
        assert err <= TOL, (name, err)


@pytest.mark.parametrize("C,L", [(32, 3), (64, 1)])
def test_emulated_k1_bwd16(fake, C, L):
    """K1's training form (the masked input and every layer's stream and
    ReLU output saved) and its backward's launches (per layer the rounding
    with db1's sums, da, the gated rounding with dbd's, dx, the weight
    products) against the plain versions, lengths ragged with 0."""
    rng = np.random.default_rng(C + L)
    B, T, O = 3, 200, 16
    x = _bf(rng, (B, T, C))
    lens = torch.tensor([T, 133, 0], dtype=torch.int32)
    layers = [(_f(rng, (3, C, C), (3 * C) ** -0.5), _f(rng, (C,), 0.1), _f(rng, (C, C), C ** -0.5),
               _f(rng, (C,), 0.1), torch.ones(C), torch.zeros(C)) for _ in range(L)]
    ow, ob = _f(rng, (C, O), C ** -0.5), _f(rng, (O,), 0.1)
    dil = [2 ** i for i in range(L)]
    _, sk, ak = dc._mstcn16_fwd_card(x, lens, layers, dil, ow, ob, save=True)
    _, sp, ap = dc.mstcn_stack16_reference(x, lens, layers, dil, out_w=ow, out_b=ob, save=True)
    valid = (torch.arange(T)[None, :] < lens[:, None])[..., None]
    for s_k, s_p in zip(sk, sp):
        assert (s_k.float() - s_p.float()).abs().max() <= TOL * s_p.float().abs().max()
    for a_k, a_p in zip(ak, ap):  # the card writes 0 past each video; the plain relu(bd) there
        assert torch.equal(a_k.float() * valid, a_k.float())
        assert (a_k.float() - a_p.float() * valid).abs().max() <= TOL * a_p.float().abs().max()
    g = _f(rng, (B, T, O))
    fake.calls.clear()
    got = dc._mstcn16_bwd_card(g, sp, ap, lens, layers, dil, ow, ob)
    ref = dc.mstcn_stack16_bwd_reference(g, sp, ap, lens, layers, dil, out_w=ow, out_b=ob)
    assert got[0].dtype == BF and not got[0].float()[~valid[..., 0]].any()
    _check(["dx", "dow", "dob"], [got[0], got[2], got[3]], [ref[0], ref[2], ref[3]])
    for i in range(L):
        _check(["dwd", "dbd", "dw1", "db1"], got[1][i][:4], ref[1][i][:4])
    wgrads = [c for c in fake.calls if c[0] == "b16_wgrad"]
    assert wgrads == [("b16_wgrad", 1)] + [("b16_wgrad", 3), ("b16_wgrad", 1)] * L
    assert ("b16_round", True) in fake.calls


@pytest.mark.parametrize("C,L", [(32, 3), (64, 1), (24, 2)])
def test_emulated_k6_bwd16(fake, C, L):
    """K6's training form (the masked input, every layer's stream, [c1 | c2]
    and ReLU output saved) and its backward's launches (dy, its rounding and
    the gated one with dbf's sums, [dc1 | dc2] in one product of N = 2C and
    its rounding with db1's and db2's sums, dx over the six taps at their
    shifts and first channels, the weight products) against the plain
    versions, lengths ragged with 0: the saves and dx bit for bit (the model
    of the C entries sums in the plain versions' order), the weight and bias
    sums, which the card forms in its own fixed chunks, within K1's limits."""
    rng = np.random.default_rng(C + L)
    B, T, O = 3, 200, 16
    x = _bf(rng, (B, T, C))
    lens = torch.tensor([T, 133, 0], dtype=torch.int32)
    layers = [(_f(rng, (3, C, C), (3 * C) ** -0.5), _f(rng, (C,), 0.1),
               _f(rng, (3, C, C), (3 * C) ** -0.5), _f(rng, (C,), 0.1),
               _f(rng, (C, C), (2 * C) ** -0.5), _f(rng, (C, C), (2 * C) ** -0.5),
               _f(rng, (C,), 0.1)) for _ in range(L)]
    ow, ob = _f(rng, (C, O), C ** -0.5), _f(rng, (O,), 0.1)
    dil = [(2 ** (L - 1 - i), 2 ** i) for i in range(L)]
    _, sk, ck, hk = dc._mstcn2_16_fwd_card(x, lens, layers, dil, ow, ob, save=True)
    _, sp, cp, hp = dc.mstcn2_stack16_reference(x, lens, layers, dil, out_w=ow, out_b=ob,
                                                save=True)
    assert fake.calls[0] == ("b16_round", False) and len(sk) == L + 1
    assert ("b16_gemm", dc.B16_FUSE) in fake.calls
    for a, p in zip(sk + ck + hk, sp + cp + hp):  # the card's saves: the plain ones
        assert a.dtype == BF and torch.equal(a, p)
    g = _f(rng, (B, T, O))
    fake.calls.clear()
    got = dc._mstcn2_16_bwd_card(g, sp, cp, hp, lens, layers, dil, ow, ob)
    ref = dc.mstcn2_stack16_bwd_reference(g, sp, cp, hp, lens, layers, dil, out_w=ow, out_b=ob)
    valid = torch.arange(T)[None, :] < lens[:, None]
    assert got[0].dtype == BF and not got[0].float()[~valid].any()
    assert torch.equal(got[0], ref[0])
    _check(["dow", "dob"], [got[2], got[3]], [ref[2], ref[3]])
    for i in range(L):
        _check(["dk1", "db1", "dk2", "db2", "dwt", "dwb", "dbf"], got[1][i], ref[1][i])
    wgrads = [c for c in fake.calls if c[0] == "b16_wgrad"]
    assert wgrads == [("b16_wgrad", 1)] + [("b16_wgrad", 3), ("b16_wgrad", 3),
                                           ("b16_wgrad", 1)] * L
    assert [c for c in fake.calls if c[0] == "b16_gemm"] == \
        [("b16_gemm", dc.B16_PROJ)] + [("b16_gemm", dc.B16_PROJ), ("b16_gemm", dc.B16_RESID)] * L
    assert fake.calls.count(("b16_round", True)) == L


@pytest.mark.parametrize("X,Y", [(40, 96), (11, 130)])
def test_emulated_k2_small_x_bwd16(fake, X, Y):
    """K2's small-X bf16 backward: the forward's projections again, the f32
    attention terms (``fk_x2y_sx_attn_bwd``), d_yq rounded and d_y on the
    bf16 GEMM, dWq and dxk / dxv per video on ``fk_k6_wgrad``, the X side
    plain; against the plain version (y_pos shared, x_len 0 too)."""
    rng = np.random.default_rng(X)
    B, C, d = 3, 32, 32
    y, x = _bf(rng, (B, Y, C)), _bf(rng, (B, X, C))
    yp, xp = _bf(rng, (1, Y, C), 0.5), _bf(rng, (1, X, C), 0.5)
    w = [_f(rng, (C, d), 0.2), _f(rng, (d,), 0.1), _f(rng, (C, d), 0.2), _f(rng, (d,), 0.1),
         _f(rng, (C, d), 0.2), _f(rng, (d,), 0.1)]
    xl = torch.tensor([X, X // 2 + 1, 0], dtype=torch.int32)
    ga, gp, gl = _f(rng, (B, Y, d)), _f(rng, (B, Y, X), 0.1), _f(rng, (B, Y, X), 0.1)
    attn, probs, _ = xa.x2y_attention16_reference(y, yp, x, xp, *w, xl)
    got = xa._x2y_small_x16_bwd_card(y, yp, x, xp, *w, xl, probs, ga, gp, gl)
    ref = xa.x2y16_bwd_reference(y, yp, x, xp, *w, xl, probs, attn, ga, gp, gl)
    assert got[1] is None  # y_pos wants no gradient here
    _check(["dy", "dyp", "dx", "dxp", "dwk", "dbk", "dwv", "dbv", "dwq", "dbq"],
           got, [r if i != 1 else None for i, r in enumerate(ref)], scales={"dbk": "dbv"})
    assert ("x2y_sx_attn_bwd", xa.sx_rows(B, Y, X, d)) in fake.calls


def test_emulated_k2_flash_bwd16(fake):
    """K2's flash bf16 backward: the projection on the bf16 GEMM, the f32
    attention backward, dkv rounded, dx on the bf16 GEMM, dWk and dWv on
    ``fk_b16_wgrad``; against the plain version (x_pos shared)."""
    rng = np.random.default_rng(11)
    B, M, X, C, d = 2, 40, 1100, 32, 32
    y, x = _bf(rng, (B, M, C)), _bf(rng, (B, X, C))
    yp, xp = _bf(rng, (1, M, C), 0.5), _bf(rng, (1, X, C), 0.5)
    w = [_f(rng, (C, d), 0.2), _f(rng, (d,), 0.1), _f(rng, (C, d), 0.2), _f(rng, (d,), 0.1),
         _f(rng, (C, d), 0.2), _f(rng, (d,), 0.1)]
    xl = torch.tensor([X, 300], dtype=torch.int32)
    ga, gp, gl = _f(rng, (B, M, d)), _f(rng, (B, M, X), 0.1), _f(rng, (B, M, X), 0.1)
    attn, probs, _ = xa.x2y_attention16_reference(y, yp, x, xp, *w, xl)
    got = xa._x2y_flash16_bwd_card(y, yp, x, xp, *w, xl, probs, attn, ga, gp, gl)
    ref = xa.x2y16_bwd_reference(y, yp, x, xp, *w, xl, probs, attn, ga, gp, gl)
    _check(["dy", "dyp", "dx", "dxp", "dwk", "dbk", "dwv", "dbv", "dwq", "dbq"],
           got, [r if i != 3 else None for i, r in enumerate(ref)], scales={"dbk": "dbv"})
    assert [c for c in fake.calls if c[0] == "b16_wgrad"] == [("b16_wgrad", 1)] * 2


@pytest.mark.parametrize("M,X,hd", [(11, 300, 32), (40, 1100, 64)])
def test_emulated_k3_bwd16(fake, M, X, hd):
    """K3's bf16 training forward (the rows' stats) and backward (K and V
    recomputed, the attention backward with JAX's roundings, dx on the bf16
    GEMM, dWk and dWv on ``fk_b16_wgrad``) against the plain versions, x_len
    0 too."""
    rng = np.random.default_rng(M)
    B, Cx, H = 3, 64, 2
    E = H * hd
    q, x, pos = _bf(rng, (B, M, E)), _bf(rng, (B, X, Cx)), _bf(rng, (1, X, Cx), 0.5)
    wk, bk, wv, bv = _f(rng, (Cx, E), 0.15), _f(rng, (E,), 0.1), _f(rng, (Cx, E), 0.15), \
        _f(rng, (E,), 0.1)
    xl = torch.tensor([X, X // 3, 0], dtype=torch.int32)
    out_k, st_k = ma._mha16_fwd_card(q, x, pos, wk, bk, wv, bv, xl, H, with_stats=True)
    out, st = ma.mha_cross16_reference(q, x, pos, wk, bk, wv, bv, xl, num_heads=H,
                                       with_stats=True)
    assert ("k3_attn16",) in fake.calls
    assert (st_k - st).abs().max() <= 1e-5 * st.abs().max()
    g = _f(rng, (B, M, E))
    got = ma._mha16_bwd_card(q, x, pos, wk, bk, wv, bv, xl, st, out, g, H)
    ref = ma.mha_cross16_bwd_reference(q, x, pos, wk, bk, wv, bv, xl, st, out, g, num_heads=H)
    _check(["dq", "dx", "dpos", "dwk", "dbk", "dwv", "dbv"], got, ref, scales={"dbk": "dbv"})
    assert ("k3_attn_bwd16", ma.bwd_key_tile(M, E, H)) in fake.calls


@pytest.mark.parametrize("B,M,E,H", [(3, 11, 64, 2), (2, 40, 128, 4)])
def test_emulated_k4_bwd16(fake, B, M, E, H):
    """K4's bf16 SA backward (one call of nine launches, then the bias,
    LayerNorm and positional sums) and FFN backward (``fk_ffn_bwd16``, dW1 from
    bf16(x) and bf16(dz1) outside) against the plain versions."""
    rng = np.random.default_rng(B * M)
    x, pos = _f(rng, (B, M, E)), _f(rng, (1, M, E), 0.5)
    ws = [_f(rng, (E, E), E ** -0.5) if i % 2 == 0 else _f(rng, (E,), 0.05) for i in range(8)]
    gam, bet = _f(rng, (E,), 0.1) + 1.0, _f(rng, (E,), 0.1)
    g = _f(rng, (B, M, E))
    got = sl._sa16_bwd_card(x, pos, *ws, gam, bet, g, H, sl.LN_EPS)
    ref = sl.sa_sublayer16_bwd_reference(x, pos, *ws, gam, bet, g, num_heads=H)
    _check(["dx", "dpos", "dwq", "dbq", "dwk", "dbk", "dwv", "dbv", "dwo", "dbo", "dls", "dlb"],
           got, ref, scales={"dbk": "dbq"})
    Fd = 2 * E
    w1, b1, w2, b2 = _f(rng, (E, Fd), E ** -0.5), _f(rng, (Fd,), 0.1), \
        _f(rng, (Fd, E), Fd ** -0.5), _f(rng, (E,), 0.1)
    got = sl._ffn16_bwd_card(x, w1, b1, w2, b2, gam, bet, g, sl.LN_EPS)
    ref = sl.ffn_sublayer16_bwd_reference(x, w1, b1, w2, b2, gam, bet, g)
    _check(["dx", "dw1", "db1", "dw2", "db2", "dls", "dlb"], got, ref)
    assert fake.calls == [("sa_bwd16",), ("ffn_bwd16",)]


def test_bf16_backward_refuses_before_any_launch(monkeypatch):
    """Off the CPU, a width the bf16 GEMM does not take (C % 8) raises
    before the library is asked for."""
    def no_lib():
        raise AssertionError("the kernel library was asked for")

    monkeypatch.setattr(_build, "lib", no_lib)
    meta = lambda *s, dt=BF: torch.empty(s, device="meta", dtype=dt)  # noqa: E731
    f32 = torch.float32
    layer = (meta(3, 20, 20, dt=f32), meta(20, dt=f32), meta(20, 20, dt=f32), meta(20, dt=f32),
             meta(20, dt=f32), meta(20, dt=f32))
    lens = torch.empty(2, device="meta", dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="C=20"):
        dc.mstcn_stack16_bwd(meta(2, 64, 8, dt=f32), [meta(2, 64, 20)] * 2, [meta(2, 64, 20)],
                             lens, [layer], [1], out_w=meta(20, 8, dt=f32),
                             out_b=meta(8, dt=f32))
