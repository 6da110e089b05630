"""K6's tensor-core design (``csrc/mstcn2.cu`` on ``csrc/tc_gemm.cuh``) checked on the CPU.

The kernels multiply f32 operands on the TF32 tensor cores by the 3xTF32
split: a = hi + lo, hi = tf32_rna(a), lo = tf32_rna(a - hi), and
a.b ~ hi.hi + hi.lo + lo.hi.  Here, without a card:

* the plain version of the split (``dilated_conv.tf32_split``) rounds like
  ``cvt.rna.tf32.f32``, held against an independent float64 rounding;
* every packed weight operand (``k6_pack``: TF32 hi / lo, K-major) unpacks
  back to the JAX layout of the weights it came from;
* ``FakeK6Lib`` models the C interface of the K6 kernels (``fk_k6_gemm``,
  the towers' one GEMM entry with K1's epilogues too, ``fk_k6_wgrad``,
  ``fk_k6_ds``), of K1's row passes (``fk_k1_ln``, ``fk_k1_dz``; K1's tests
  are in ``test_torch_port_k1_tc.py``) and of ``grad.cu``'s ``fk_reduce`` on the
  raw memory the wrappers hand them, with the kernels' 3xTF32 arithmetic,
  their tile skips and their epilogues; the port's own launch sequence
  (``_mstcn2_fwd_card``, ``_mstcn2_bwd_card``) runs on it and is held
  against JAX's ``dilated_residual2_stack`` in interpret mode and the f32
  plain versions.

Tolerances: 1e-5 absolute on forward values O(1) and 1e-5 of each
gradient's largest value: the split keeps ~2^-22 of each product, f32 sums
in another order.  The kernels themselves run only on the card, where
``chip_smoke.py`` holds them against the same plain versions.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fact_clip_tpu.ops.pallas.dilated_conv import dilated_residual2_stack
from fact_clip_tpu_torch import _build
from fact_clip_tpu_torch.ops import dilated_conv as dc
from fact_clip_tpu_torch.ops.dropout import dropout_mask_reference, keep_threshold

torch.set_num_threads(2)
C, O = 64, 24


def _rna(v):
    """cvt.rna.tf32.f32 in float64 arithmetic: to 10 mantissa bits (the
    exponent floored at f32's -126), nearest, ties away from zero."""
    v = np.asarray(v, np.float64)
    a = np.abs(v)
    e = np.floor(np.log2(np.where(a > 0, a, 1.0)))
    ulp = 2.0 ** (np.maximum(e, -126) - 10)
    q = a / ulp
    f = np.floor(q)
    return np.copysign(np.where(q - f >= 0.5, f + 1, f) * ulp, v).astype(np.float32)


def _split(x):
    """The kernels' split of a float32 tensor, by the float64 rounding above."""
    hi = torch.from_numpy(_rna(x.numpy()))
    return hi, torch.from_numpy(_rna((x - hi).numpy()))


def _mm3(a, b):
    """a @ b as the kernels form it: hi.hi + hi.lo + lo.hi of the TF32 parts."""
    ah, al = _split(a)
    bh, bl = _split(b)
    return al @ bh + ah @ bl + ah @ bh


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def test_tf32_split_rounds_like_cvt_rna():
    rng = np.random.default_rng(0)
    vals = [rng.standard_normal(4000) * 10.0 ** rng.integers(-6, 6, 4000)]
    # exact ties (low 13 bits 0x1000), just below and above, the carry into
    # the exponent, subnormals, zeros; both signs
    base = rng.integers(0x3F000000 >> 13, 0x41000000 >> 13, 64).astype(np.int64) << 13
    for low in (0x1000, 0x0FFF, 0x1001, 0x1FFF):
        vals.append((base | low).astype(np.int32).view(np.float32))
    vals.append(np.array([0x3F7FF000, 0x3FFFFFFF, 0x00001000, 0x00003000, 0x00002FFF, 0x007FFFFF,
                          0x00000001, 0], np.int32).view(np.float32))
    w = np.concatenate([v.astype(np.float32) for v in vals])
    w = np.concatenate([w, -w])
    hi, lo = dc.tf32_split(torch.from_numpy(w))
    hi, lo = hi.numpy(), lo.numpy()
    np.testing.assert_array_equal(_bits(hi), _bits(_rna(w)))
    np.testing.assert_array_equal(_bits(lo), _bits(_rna(w - hi)))
    assert not (_bits(hi) & 0x1FFF).any() and not (_bits(lo) & 0x1FFF).any()
    err = np.abs(hi.astype(np.float64) + lo - w)
    # 2^-22 relative; below the normal range, half of TF32's last step there (2^-137)
    assert (err <= np.maximum(2.0 ** -22 * np.abs(w), 2.0 ** -137)).all()
    normal = np.abs(w) >= 2.0 ** -126
    assert (err[normal] <= 2.0 ** -22 * np.abs(w[normal])).all()
    # a tie rounds away from zero: 1 + 2^-11 -> 1 + 2^-10
    t = np.float32(1.0 + 2.0 ** -11)
    assert dc.tf32_rna(torch.tensor([t, -t])).tolist() == [1.0 + 2.0 ** -10, -1.0 - 2.0 ** -10]


def _layer(rng, scale=0.1):
    def r(*s):
        return torch.from_numpy((rng.standard_normal(s) * scale).astype(np.float32))

    return (r(3, C, C), r(C), r(3, C, C), r(C), r(C, C), r(C, C), r(C))


def _unpack(p, transpose=False):
    """hi + lo of a packed (2, N, K) operand, in the layout ``k6_pack`` took."""
    w = p[0] + p[1]
    return w.t() if transpose else w


def _close_split(packed, w, transpose=False):
    """The packed operand's hi part is tf32_rna of w's layout (or its
    transpose), element for element, and hi + lo gives w back."""
    want = w.t() if transpose else w
    np.testing.assert_array_equal(_bits(packed[0].numpy()), _bits(_rna(want.numpy())))
    back = _unpack(packed, transpose)
    assert back.shape == w.shape
    assert float((back - w).abs().max()) <= 2.0 ** -22 * float(w.abs().max())


@pytest.mark.parametrize("role", ["conv", "fuse", "out_proj", "dc", "dx", "g_logits", "fold"])
def test_packed_operands_unpack_to_the_jax_layout(role):
    rng = np.random.default_rng(1)
    k1, b1, k2, b2, wt, wb, bf = layer = _layer(rng)
    ow = torch.from_numpy(rng.standard_normal((C, O)).astype(np.float32))
    tol = 2.0 ** -22 * 0.6  # |weights| < 0.6
    if role == "conv":  # (conv, hi / lo, out, tap * C + in)
        conv = dc.k6_fwd_weights(layer)[0]
        assert conv.shape == (2, 2, C, 3 * C)
        for z, k in enumerate((k1, k2)):
            _close_split(conv[z], k.reshape(3 * C, C), transpose=True)
            back = _unpack(conv[z], True).reshape(3, C, C)  # (tap, in, out)
            assert float((back - k).abs().max()) <= tol
            assert abs(float(conv[z, 0, 5, 2 * C + 7] - k[2, 7, 5])) <= 2.0 ** -11 * 0.6
    elif role == "fuse":  # (hi / lo, out, [c1 | c2] channel)
        fuse = dc.k6_fwd_weights(layer)[1]
        assert fuse.shape == (2, C, 2 * C)
        _close_split(fuse, torch.cat([wt, wb]), transpose=True)
    elif role == "out_proj":
        _close_split(dc.k6_pack(ow, True), ow, transpose=True)
    elif role == "dc":  # [dc1 | dc2] = ds Wf^T: the rows of Wf are the GEMM's columns
        dcw = dc.k6_bwd_weights(layer)[0]
        assert dcw.shape == (2, 2 * C, C)
        _close_split(dcw, torch.cat([wt, wb]))
    elif role == "dx":  # dx = sum_k dc[s - (k-1)d] K[k]^T: (hi / lo, in, tap-major out)
        dxw = dc.k6_bwd_weights(layer)[1]
        assert dxw.shape == (2, C, 6 * C)
        back = _unpack(dxw).reshape(C, 6, C).permute(1, 0, 2)
        assert float((back - torch.cat([k1, k2])).abs().max()) <= tol
        _close_split(dxw, torch.cat([k1[0], k1[1], k1[2], k2[0], k2[1], k2[2]], dim=1))
    elif role == "g_logits":  # g = g_logits Wo^T
        _close_split(dc.k6_pack(ow), ow)
    else:  # the serving fold, (hi / lo, out, tap-major in)
        (w6p, bias), = dc.mstcn2_fold([layer])
        assert w6p.shape == (2, C, 6 * C)
        w6 = _unpack(w6p, True).reshape(6, C, C)
        ref = torch.cat([k1 @ wt, k2 @ wb])  # (6, in, out)
        assert float((w6 - ref).abs().max()) <= 1e-6
        np.testing.assert_allclose(bias.numpy(), (b1 @ wt + b2 @ wb + bf).numpy(), atol=1e-6)


# ---------------------------------------------------------------------------
# a model of the K6 kernels' C interface, on the raw memory of CPU tensors


def _view(ptr, n, ctype=ctypes.c_float, dtype=torch.float32):
    return torch.frombuffer((ctype * n).from_address(ptr), dtype=dtype)


def _ints(ptr, n):
    return _view(ptr, n, ctypes.c_int, torch.int32)


class FakeK6Lib:
    """The kernels' arithmetic (3xTF32 products, f32 epilogues) and their
    skips, written with torch on the memory behind the pointers."""

    def __init__(self):
        self.calls = []

    def _keep(self, seed, layer, thresh, scale, shape):
        if seed is None:
            return torch.ones(shape)
        rate = 1.0 - 1.0 / scale
        assert keep_threshold(rate) == thresh
        return dropout_mask_reference(_ints(seed, 1).clone(), layer, shape, rate)

    def fk_k6_gemm(self, mode, a, a_ch, nprob, nseg, segs, kseg, wpack, N, K, B, T, lengths, out,
                   ldo, col_step, bias0, bias1, res, res_ld, res_bstride, out2, part, seed, layer,
                   thresh, scale, stream):
        self.calls.append(("gemm", mode))
        # K is the packed rows' length; a product may use their first nseg * kseg
        assert K >= nseg * kseg and (nseg == 1 or kseg % 32 == 0)
        # TMA reads zeros past the activations' channels
        A = torch.nn.functional.pad(_view(a, B * T * a_ch).view(B, T, a_ch), (0, kseg))
        W = _view(wpack, nprob * 2 * N * K).view(nprob, 2, N, K)
        lens = _ints(lengths, B)
        sg = _ints(segs, nprob * nseg * 2).view(nprob, nseg, 2)
        cols = ldo if mode in (dc._MASKED, dc._LOGITS, dc._GATE, dc._PROJ, dc._PROJ32) else N
        Y = _view(out, B * T * cols).view(B, T, cols)

        def res_rows(b):  # res + b * res_bstride + t * res_ld
            return _view(res + 4 * b * res_bstride, T * res_ld).view(T, res_ld)

        t = torch.arange(T)
        ntile = -(-T // 128)
        for z in range(nprob):
            bias = bias1 if z else bias0
            bv = _view(bias, N) if bias is not None else torch.zeros(N)
            c_off = z * col_step
            for b in range(B):
                L = min(int(lens[b]), T)
                acc = torch.zeros(T, N)
                for s in range(nseg):
                    shift, c0 = int(sg[z, s, 0]), int(sg[z, s, 1])
                    src = t + shift
                    ok = (src >= 0) & (src < L)
                    a_s = torch.zeros(T, kseg)
                    a_s[ok] = A[b, src[ok], c0:c0 + kseg]
                    ah, al = _split(a_s)
                    wh = W[z, 0][:, s * kseg:(s + 1) * kseg]
                    wl = W[z, 1][:, s * kseg:(s + 1) * kseg]
                    acc += al @ wh.t() + ah @ wl.t() + ah @ wh.t()
                acc[(t // 128) * 128 >= L] = 0.0  # a tile past the video runs no GEMM
                valid = (t < L)[:, None]
                if mode in (dc._MASKED, dc._GATE):
                    if mode == dc._GATE:  # acc where the ReLU output h > 0
                        v = torch.where(valid & (res_rows(b) > 0), acc, 0.0)
                    else:
                        v = torch.where(valid, acc + bv, 0.0)
                    Y[b, :, c_off:c_off + N] = v
                    if part is not None:
                        P = _view(part, B * ntile * ldo).view(B, ntile, ldo)
                        for i in range(ntile):
                            P[b, i, c_off:c_off + N] = v[i * 128:(i + 1) * 128].sum(0)
                elif mode == dc._LOGITS:
                    Y[b] = acc + bv
                elif mode in (dc._PROJ, dc._PROJ32):  # + the positional term on res_ld columns
                    tab = torch.zeros(T, N)
                    if res is not None and z == 0:  # of problem 0
                        tab[:, :res_ld] = res_rows(b)
                    Y[b, :, c_off:c_off + N] = torch.where(valid, acc + bv + tab, 0.0)
                elif mode == dc._RELU:
                    Y[b] = torch.where(valid, torch.relu(acc + bv), 0.0)
                else:
                    X = res_rows(b)
                    if mode == dc._FUSE:
                        h = torch.relu(acc + bv)
                        keep = self._keep(seed, layer, thresh, scale, (B, T, N))[b]
                        Y[b] = torch.where(valid, h * keep + X, 0.0)
                        if out2 is not None:
                            _view(out2, B * T * N).view(B, T, N)[b] = torch.where(valid, h, 0.0)
                    elif mode == dc._RESID:
                        keep = self._keep(seed, layer, thresh, scale, (B, T, N))[b]
                        Y[b] = torch.where(valid, (acc + bv) * keep + X, 0.0)
                    elif mode == dc._FOLDED:
                        Y[b] = torch.where(valid, torch.relu(acc + bv) + X, 0.0)
                    else:
                        assert mode == dc._DX
                        Y[b] = torch.where(valid, acc + X, 0.0)
        return 0

    def fk_k6_wgrad(self, A, a_ch, a_c0, Ca, Bm, b_ch, b_c0, Cb, lengths, shift0, step, n_taps,
                    part, B, T, Kc, stream):
        self.calls.append(("wgrad", n_taps))
        Av = _view(A, B * T * a_ch).view(B, T, a_ch)
        Bv = _view(Bm, B * T * b_ch).view(B, T, b_ch)
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
                    P[tap, b * per + c] = _mm3(a.t().contiguous(), bm)
        return 0

    def fk_k6_ds(self, g, h, x, glg, lengths, seed, layer, thresh, scale, ds, y_out, part,
                 part_o, B, T, C_, O_, R, stream):
        self.calls.append(("ds", y_out is not None))
        n = B * T * C_
        G, H, X = (_view(p, n).view(B, T, C_) for p in (g, h, x))
        valid = (torch.arange(T)[None, :] < _ints(lengths, B)[:, None].clamp(max=T))[..., None]
        keep = self._keep(seed, layer, thresh, scale, (B, T, C_))
        D = torch.where(valid & (H > 0), G * keep, 0.0)
        _view(ds, n).view(B, T, C_)[:] = D
        if y_out is not None:
            _view(y_out, n).view(B, T, C_)[:] = torch.where(valid, H * keep + X, 0.0)
        nb = -(-T // R)
        Pf = _view(part, B * nb * C_).view(B, nb, C_)
        for i in range(nb):
            Pf[:, i] = D[:, i * R:(i + 1) * R].sum(1)
        if part_o is not None:
            GL = _view(glg, B * T * O_).view(B, T, O_)
            Po = _view(part_o, B * nb * O_).view(B, nb, O_)
            for i in range(nb):
                Po[:, i] = GL[:, i * R:(i + 1) * R].sum(1)
        return 0

    def fk_k1_ln(self, y, lengths, gamma, beta, B, T, C_, R, eps, stream):
        self.calls.append(("ln",))
        Y = _view(y, B * T * C_).view(B, T, C_)
        valid = (torch.arange(T)[None, :] < _ints(lengths, B)[:, None].clamp(max=T))[..., None]
        mean = Y.mean(-1, keepdim=True)
        var = ((Y - mean) ** 2).mean(-1, keepdim=True)
        out = (Y - mean) * torch.rsqrt(var + eps) * _view(gamma, C_) + _view(beta, C_)
        Y[:] = torch.where(valid, out, 0.0)
        return 0

    def fk_k1_dz(self, g, z, gamma, beta, glg, lengths, seed, layer, thresh, scale, dz, dh,
                 y_out, part, part_o, B, T, C_, O_, R, use_ln, eps, stream):
        self.calls.append(("dz", y_out is not None))
        n = B * T * C_
        G = _view(g, n).view(B, T, C_)
        valid = (torch.arange(T)[None, :] < _ints(lengths, B)[:, None].clamp(max=T))[..., None]
        keep = self._keep(seed, layer, thresh, scale, (B, T, C_))
        gz = torch.where(valid, G, 0.0)
        nb = -(-T // R)
        P = _view(part, B * nb * (3 if use_ln else 1) * C_).view(B, nb, -1, C_)
        if use_ln:
            Z = _view(z, n).view(B, T, C_)
            ga, be = _view(gamma, C_), _view(beta, C_)
            mean = Z.mean(-1, keepdim=True)
            rstd = torch.rsqrt(((Z - mean) ** 2).mean(-1, keepdim=True) + eps)
            xh = (Z - mean) * rstd
            gg = gz * ga
            D = (gg - gg.mean(-1, keepdim=True) - xh * (gg * xh).mean(-1, keepdim=True)) * rstd
            D = torch.where(valid, D, 0.0)
            _view(dz, n).view(B, T, C_)[:] = D
            if y_out is not None:
                _view(y_out, n).view(B, T, C_)[:] = torch.where(valid, xh * ga + be, 0.0)
        else:
            D = gz
        H = D * keep
        _view(dh, n).view(B, T, C_)[:] = H
        for i in range(nb):
            rows = slice(i * R, (i + 1) * R)
            P[:, i, 0] = H[:, rows].sum(1)
            if use_ln:
                P[:, i, 1] = torch.where(valid, gz * xh, 0.0)[:, rows].sum(1)
                P[:, i, 2] = gz[:, rows].sum(1)
        if part_o is not None:
            GL = _view(glg, B * T * O_).view(B, T, O_)
            Po = _view(part_o, B * nb * O_).view(B, nb, O_)
            for i in range(nb):
                Po[:, i] = GL[:, i * R:(i + 1) * R].sum(1)
        return 0

    def fk_reduce(self, src, G, P, pstride, gstride, rows, rstride, cols, out, stream):
        size = (G - 1) * gstride + (P - 1) * pstride + (rows - 1) * rstride + cols
        S = _view(src, size)
        Y = _view(out, G * rows * cols).view(G, rows, cols)
        idx = torch.arange(rows)[:, None] * rstride + torch.arange(cols)[None]
        for g in range(G):
            acc = torch.zeros(rows, cols)
            for p in range(P):
                acc += S[g * gstride + p * pstride + idx]
            Y[g] = acc
        return 0


@pytest.fixture
def fake(monkeypatch):
    lib = FakeK6Lib()
    monkeypatch.setattr(_build, "lib", lambda: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    return lib


def _case(seed, T, lengths, n_layers=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((len(lengths), T, C)).astype(np.float32)  # non-zero past each video
    layers = [_layer(rng) for _ in range(n_layers)]
    ow = (rng.standard_normal((C, O)) * 0.2).astype(np.float32)
    ob = (rng.standard_normal(O) * 0.1).astype(np.float32)
    return x, layers, ow, ob


RAGGED = {70: [70, 41, 3], 300: [300, 100, 129]}  # T=300: tiles wholly past two videos


@pytest.mark.parametrize("form", ["serving", "training"])
@pytest.mark.parametrize("T", [70, 300])
def test_emulated_layer_matches_jax_interpret(fake, form, T):
    """One narrow K6 layer (C=64, dilations (4, 1)) with its out projection:
    the port's launches on the kernels' 3xTF32 arithmetic against JAX's
    kernel in interpret mode and the f32 plain version."""
    lengths = RAGGED[T]
    x, layers, ow, ob = _case(3, T, lengths)
    dil = [(4, 1)]
    mask = jnp.asarray(np.arange(T)[None] < np.array(lengths)[:, None])
    ref_j = np.asarray(dilated_residual2_stack(
        jnp.asarray(x), mask, [tuple(jnp.asarray(p.numpy()) for p in layers[0])], dil, tile=32,
        interpret=True, out_params=(jnp.asarray(ow), jnp.asarray(ob))))
    lens = torch.tensor(lengths, dtype=torch.int32)
    args = (torch.from_numpy(x), lens, layers, dil, torch.from_numpy(ow), torch.from_numpy(ob))
    got = dc._mstcn2_fwd_card(*args, None, None, form == "training", None)
    ref = dc.mstcn2_stack_reference(*args[:4], out_w=args[4], out_b=args[5],
                                    save=form == "training")
    if form == "training":
        valid = dc._frame_mask(args[0], lens)
        np.testing.assert_allclose((got[2][0] * valid).numpy(), (ref[2][0] * valid).numpy(),
                                   atol=1e-5)
        np.testing.assert_allclose((got[3][0] * valid).numpy(), (ref[3][0] * valid).numpy(),
                                   atol=1e-5)
        got, ref = got[0], ref[0]
        assert [c for c in fake.calls] == [("gemm", dc._MASKED), ("gemm", dc._FUSE),
                                           ("gemm", dc._LOGITS)]
    else:
        assert fake.calls == [("gemm", dc._FOLDED), ("gemm", dc._LOGITS)]
    v = np.asarray(mask)
    np.testing.assert_allclose(got.numpy()[v], ref_j[v], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.numpy()[v], ref.numpy()[v], atol=1e-5, rtol=0)
    # padded frames carry the bias row
    np.testing.assert_allclose(got.numpy()[~v], np.broadcast_to(ob, (int((~v).sum()), O)),
                               atol=1e-6)


def test_emulated_training_form_with_dropout(fake):
    """Two layers, dropout 0.3 on the first (the hash in the fuse epilogue):
    the logits and every save against the plain version on the same seeds."""
    T, lengths = 300, RAGGED[300]
    x, layers, ow, ob = _case(4, T, lengths, 2)
    lens = torch.tensor(lengths, dtype=torch.int32)
    seeds = torch.tensor([123457, 99], dtype=torch.int32)
    args = (torch.from_numpy(x), lens, layers, [(2, 1), (1, 2)], torch.from_numpy(ow),
            torch.from_numpy(ob))
    got = dc._mstcn2_fwd_card(*args, (0.3, 0.0), seeds, True, None)
    ref = dc.mstcn2_stack_reference(*args[:4], out_w=args[4], out_b=args[5], rates=(0.3, 0.0),
                                    seeds=seeds, save=True)
    valid = dc._frame_mask(args[0], lens)
    np.testing.assert_allclose((got[0] * valid).numpy(), (ref[0] * valid).numpy(), atol=1e-5)
    for g_list, r_list in zip(got[1:], ref[1:]):
        for g_, r_ in zip(g_list, r_list):
            np.testing.assert_allclose((g_ * valid).numpy(), (r_ * valid).numpy(), atol=1e-5)


def test_emulated_backward_matches_plain(fake):
    """Two layers (the last layer's g = g_logits Wo^T and dWo, and a middle
    layer), dropout 0.3 on the first: dx and every weight gradient from the
    same saves against ``mstcn2_stack_bwd_reference``."""
    T, lengths = 300, RAGGED[300]
    x, layers, ow, ob = _case(5, T, lengths, 2)
    lens = torch.tensor(lengths, dtype=torch.int32)
    seeds = torch.tensor([7, 11], dtype=torch.int32)
    dil = [(2, 1), (1, 2)]
    xt, owt, obt = torch.from_numpy(x), torch.from_numpy(ow), torch.from_numpy(ob)
    kw = dict(out_w=owt, out_b=obt, rates=(0.3, 0.0), seeds=seeds)
    _, streams, cs, hs = dc.mstcn2_stack_reference(xt, lens, layers, dil, save=True, **kw)
    g = torch.from_numpy(np.random.default_rng(6).standard_normal((3, T, O)).astype(np.float32))
    got = dc._mstcn2_bwd_card(g, streams, cs, hs, lens, layers, dil, owt, obt, (0.3, 0.0), seeds)
    ref = dc.mstcn2_stack_bwd_reference(g, streams, cs, hs, lens, layers, dil, **kw)

    def flat(r):
        dx, dlayers, dow, dob = r
        return [dx, *[t for d in dlayers for t in d], dow, dob]

    for i, (a, b) in enumerate(zip(flat(got), flat(ref))):
        assert a.shape == b.shape, i
        scale = max(float(b.abs().max()), 1e-6)
        assert float((a - b).abs().max()) <= 1e-5 * scale, (i, float((a - b).abs().max()) / scale)
    assert ("ds", True) in fake.calls and ("ds", False) in fake.calls
