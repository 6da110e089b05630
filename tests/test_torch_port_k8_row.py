"""The int8 towers' row form (``act_scale="row"``: K8a and K8e with one
activation scale per frame and one weight scale per conv tap) checked on the
CPU.

JAX's ``dilated_residual_stack_q8`` and ``dilated_residual2_stack_q8`` take
``act_scale="row"`` (the ``else:`` branches of ``_stack_kernel_q8`` and
``_stack2_kernel_q8``); no configuration sets it, and JAX's own int8 eval
test binds the towers to it.  Here:

* the plain row versions (``mstcn_stack_q8_reference`` and
  ``mstcn2_stack_q8_reference`` with ``act_scale="row"``, through the
  entries on CPU tensors)
  against JAX's in interpret mode: bit for bit over the whole tower without
  the LayerNorm, one LayerNorm'd layer within LN_RTOL (JAX normalizes with
  its own sum order and rsqrt);
* ``FakeK8RowLib``, a model of the row entries' C interface
  (``fk_q8_tower_row_layer``, ``fk_q8_tower2_row_layer``: passes R, A, Q,
  F / B and N of ``csrc/quant2.cu``) on the raw memory of CPU tensors, item
  for item: the row buffer with its halos, the taps as row offsets into it,
  each tap's own accumulator dequantized in JAX's order, the items past a
  video skipped, the rows' maxima over every column; the port's launch
  sequences (``_mstcn_q8_row_card``, ``_mstcn2_q8_row_card``) on it are held
  bit-equal to the plain versions, output and integer scales;
* ``quantize_tower(..., "row")`` / ``quantize_tower2(..., "row")`` against
  JAX's per-tap ``quantize_weight``;
* a narrow int8 ``iuUU`` with MSTCN (``f: m``) and MS-TCN++ (``f: m2``)
  towers in the row form against JAX's eval with its towers bound to
  ``act_scale="row"``, as ``tests/test_quantized_eval.py`` binds them;
* the refusals.

Cases: a video ending inside a tile (tile 32), a dilation past the tile,
T < tile, a ragged batch whose padded frames stay 0, C = 24, 32 and 40.
"""

import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_k6_tc import _ints, _view
from test_torch_port_k8a_tc import LN_RTOL, _lane_tree
from test_torch_port_k8e_tc import _bytes
from test_torch_port_quant import B as NB
from test_torch_port_quant import C as NC
from test_torch_port_quant import D as ND
from test_torch_port_quant import S_CAP as NS
from test_torch_port_quant import T as NT
from test_torch_port_quant import _narrow, _rel

from __graft_entry__ import _make_cfg
from fact_clip_tpu.models import blocks as jblocks
from fact_clip_tpu.models import decode as jdecode
from fact_clip_tpu.ops.pallas import quant_conv as jqc
from fact_clip_tpu_torch import _build, kernel_counters
from fact_clip_tpu_torch.configs import small_cfg
from fact_clip_tpu_torch.engine.steps import make_eval_step
from fact_clip_tpu_torch.models.blocks import build_fact
from fact_clip_tpu_torch.models.layers import MSTCN, MSTCN2
from fact_clip_tpu_torch.ops import quant_conv as qc
from fact_clip_tpu_torch.utils.bridge import load_jax_params

torch.set_num_threads(2)


def _idot(a, w):  # the int32 sum of int8 rows by int8 weight rows, exact
    return torch.matmul(a.double(), w.double().t()).float()


def _fma(a, b, c):
    return (a.double() * b.double() + c.double()).float()


class FakeK8RowLib:
    """The row entries' arithmetic and data flow on the memory behind the
    pointers; ``calls`` lists the entries run."""

    BM = 128  # rows of a block of passes A and F / B

    def __init__(self):
        self.calls = []

    @staticmethod
    def _rows(X, lens, QR, SR, B, C, H, T_pad):
        """Pass R: each valid row quantized with its own absmax at row H + t."""
        for b in range(B):
            for t in range(T_pad):
                if t < lens[b]:
                    s = X[b, t].abs().max().clamp_min(1e-12)
                    QR[b, H + t, :C] = torch.round(X[b, t] * qc._div(127.0, s.view(1))).to(
                        torch.int8)
                    QR[b, H + t, C:] = 0
                else:
                    s = torch.tensor(1e-12)
                    QR[b, H + t] = 0
                SR[b, H + t] = s

    def _conv(self, QR, SR, lens, KP, sk, bias, d, relu, Cb, RM, B, C, kseg, H, tile, n_tiles,
              T_pad):
        """Pass A: per (128 rows of a tile, conv, video), each tap's product in
        its own accumulator, dequantized into the f32 sum in JAX's order."""
        BM = self.BM

        def padk(r):  # int8 rows as the K steps read them: kseg wide, zeros past Cw
            return torch.nn.functional.pad(r, (0, max(0, kseg - r.shape[1])))[:, :kseg]

        for z in range(len(d)):
            wz = [KP[z, :, k * kseg:(k + 1) * kseg] for k in range(3)]
            for b in range(B):
                for t in range(n_tiles):
                    for j in range(-(-tile // BM)):
                        r0 = t * tile + j * BM
                        if r0 >= min(lens[b], T_pad):
                            continue  # every row past the video: skipped
                        rows = t * tile + torch.arange(j * BM, min(tile, j * BM + BM))
                        p = []
                        for k in range(3):
                            src = H + rows + (k - 1) * d[z]
                            p.append(_idot(padk(QR[b, src]), wz[k]) * SR[b, src][:, None])
                        f = _fma(p[0], sk[z][0], p[1] * sk[z][1])
                        v = _fma(p[2], sk[z][2], f) + bias[z]
                        if relu:
                            v = torch.relu(v)
                        Cb[z, b, rows, :C] = v
                        RM[z, b, rows] = torch.maximum(RM[z, b, rows], v.abs().amax(dim=-1))

    @staticmethod
    def _quant(Cb, RM, QC, C):
        """Pass Q: each row of c quantized with its own max."""
        s = RM.clamp_min(1e-12)[..., None]
        q = torch.zeros_like(QC)
        q[..., :C] = torch.round(torch.nan_to_num(Cb[..., :C]) * qc._div(127.0, s)).clamp(
            -128, 127).to(torch.int8)
        QC[:] = q

    def _out(self, QC, RM, FP, lens, X, Y, out_fn, B, T, C, kseg, tile, n_tiles):
        """Pass F / B: per (128 rows of a tile, video); rows past the video 0."""
        BM = self.BM
        for b in range(B):
            for t in range(n_tiles):
                for j in range(-(-tile // BM)):
                    r0 = t * tile + j * BM
                    rows = torch.arange(r0, t * tile + min(tile, j * BM + BM))
                    rows = rows[rows < T]
                    if len(rows) == 0:
                        continue
                    out = torch.zeros(len(rows), C)
                    if r0 < lens[b]:
                        hs = [_idot(torch.nn.functional.pad(QC[z, b, rows], (0, max(
                            0, kseg - QC.shape[-1])))[:, :kseg], FP[z, :, :kseg])
                              * RM[z, b, rows].clamp_min(1e-12)[:, None]
                              for z in range(FP.shape[0])]
                        out = out_fn(hs) + X[b, rows]
                        out[rows >= lens[b]] = 0.0
                    Y[b, rows] = out

    def _buffers(self, x, lengths, qrow, srow, c, qc_, rmax, y, B, T, C, Cw, H, T_pad, nconv):
        Tw = T_pad + 2 * H
        return (_view(x, B * T * C).view(B, T, C), [min(int(v), T) for v in _ints(lengths, B)],
                _bytes(qrow, B * Tw * Cw).view(B, Tw, Cw), _view(srow, B * Tw).view(B, Tw),
                _view(c, nconv * B * T_pad * Cw).view(nconv, B, T_pad, Cw),
                _bytes(qc_, nconv * B * T_pad * Cw).view(nconv, B, T_pad, Cw),
                _view(rmax, nconv * B * T_pad).view(nconv, B, T_pad),
                _view(y, B * T * C).view(B, T, C))

    def fk_q8_tower2_row_layer(self, x, lengths, kpack, Kc, sk1, b1, sk2, b2, fpack, Kf, swt,
                               swb, bf, qrow, srow, c, qc_, rmax, y, B, T, C, Cw, d1, d2, H, tile,
                               n_tiles, T_pad, stream):
        self.calls.append("tower2_row_layer")
        kseg = -(-C // 32) * 32
        assert Cw >= C and Cw % 16 == 0 and Kc >= 3 * kseg and Kf >= kseg
        assert H >= max(d1, d2) and H % 8 == 0 and T_pad == n_tiles * tile
        X, lens, QR, SR, Cb, QC, RM, Y = self._buffers(x, lengths, qrow, srow, c, qc_, rmax, y,
                                                        B, T, C, Cw, H, T_pad, 2)
        assert not QR[:, :H].any() and not QR[:, H + T_pad:].any() and not SR[:, :H].any()
        self._rows(X, lens, QR, SR, B, C, H, T_pad)
        sk = [_view(s, 3 * C).view(3, C) for s in (sk1, sk2)]
        self._conv(QR, SR, lens, _bytes(kpack, 2 * C * Kc).view(2, C, Kc), sk,
                   [_view(b1, C), _view(b2, C)], [d1, d2], False, Cb, RM, B, C, kseg, H, tile,
                   n_tiles, T_pad)
        self._quant(Cb, RM, QC, C)
        swt_, swb_, bf_ = _view(swt, C), _view(swb, C), _view(bf, C)

        def fuse(hs):  # h = fma(h1 s1, swt, (h2 s2) swb); relu(h + bf)
            return torch.relu(_fma(hs[0], swt_, hs[1] * swb_) + bf_)

        self._out(QC, RM, _bytes(fpack, 2 * C * Kf).view(2, C, Kf), lens, X, Y, fuse, B, T, C,
                  kseg, tile, n_tiles)
        return 0

    def fk_q8_tower_row_layer(self, x, lengths, kpack, Kc, swd, bd, wpack, Kw, sw1, b1, gamma,
                              beta, use_ln, eps, qrow, srow, a, qa, rmax, y, B, T, C, Cw, d, H,
                              tile, n_tiles, T_pad, stream):
        self.calls.append("tower_row_layer")
        kseg = -(-C // 32) * 32
        assert Cw >= C and Cw % 16 == 0 and Kc >= 3 * kseg and Kw >= kseg
        assert H >= d and H % 8 == 0 and T_pad == n_tiles * tile
        X, lens, QR, SR, A, QA, RM, Y = self._buffers(x, lengths, qrow, srow, a, qa, rmax, y, B,
                                                       T, C, Cw, H, T_pad, 1)
        self._rows(X, lens, QR, SR, B, C, H, T_pad)
        self._conv(QR, SR, lens, _bytes(kpack, C * Kc).view(1, C, Kc),
                   [_view(swd, 3 * C).view(3, C)], [_view(bd, C)], [d], True, A, RM, B, C, kseg,
                   H, tile, n_tiles, T_pad)
        self._quant(A, RM, QA, C)
        sw1_, b1_ = _view(sw1, C), _view(b1, C)
        self._out(QA, RM, _bytes(wpack, C * Kw).view(1, C, Kw), lens, X, Y,
                  lambda hs: _fma(hs[0], sw1_, b1_), B, T, C, kseg, tile, n_tiles)
        if use_ln:  # pass N: a warp a row, in place
            g_, be_ = _view(gamma, C), _view(beta, C)
            for b in range(B):
                if lens[b] == 0:
                    continue
                o = Y[b, :lens[b]]
                mean = qc._over(_lane_tree(o), float(C))
                dv = o - mean
                var = qc._over(_lane_tree(dv * dv), float(C))
                inv = qc._div(1.0, torch.sqrt(var + torch.tensor(eps, dtype=torch.float32)))
                Y[b, :lens[b]] = _fma(dv * inv, g_, be_)
        return 0


@pytest.fixture
def fake(monkeypatch):
    lib = FakeK8RowLib()
    monkeypatch.setattr(_build, "lib", lambda: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    return lib


def _pair(rng, shape, scale, shift=0.0):
    v = (rng.standard_normal(shape) * scale + shift).astype(np.float32)
    return jnp.asarray(v), torch.from_numpy(v)


def _k8a_inputs(rng, B, T, C, dilations, lengths):
    x_j, x_t = _pair(rng, (B, T, C), 1.0)
    lj, lt = [], []
    for _ in dilations:
        parts = [_pair(rng, (3, C, C), 0.08), _pair(rng, (C,), 0.05), _pair(rng, (C, C), 0.08),
                 _pair(rng, (C,), 0.05), _pair(rng, (C,), 0.2, 1.0), _pair(rng, (C,), 0.2)]
        lj.append(tuple(p[0] for p in parts))
        lt.append(tuple(p[1] for p in parts))
    return x_j, x_t, lj, lt, np.array(lengths, np.int32)


def _k8e_inputs(rng, B, T, C, pairs, lengths):
    x_j, x_t = _pair(rng, (B, T, C), 1.0)
    lj, lt = [], []
    for _ in pairs:
        parts = [_pair(rng, s, sc) for s, sc in [((3, C, C), 0.08), ((C,), 0.3), ((3, C, C), 0.08),
                                                 ((C,), 0.3), ((C, C), 0.1), ((C, C), 0.1),
                                                 ((C,), 0.05)]]
        lj.append(tuple(p[0] for p in parts))
        lt.append(tuple(p[1] for p in parts))
    return x_j, x_t, lj, lt, np.array(lengths, np.int32)


def _mask(T, lengths):
    return jnp.asarray(np.arange(T)[None] < lengths[:, None])


# (B, T, C, tile, dilations, lengths):
#   "ends_inside": tile 32 of 70 frames, video 1 ending at 50 inside the
#   second tile, d = 64 past the tile;
#   "short": T = 200 < 512, so tile = ceil8(T) = 200 and d = 256 > tile;
#   "ragged24": C = 24, T = 600 in two tiles of 512, 600 / 517 / 90 frames,
#   d = 512 past the short video;
#   "c40": C = 40, a width of no multiple of 32
K8A_CASES = {"ends_inside": (2, 70, 32, 32, (64, 8, 1), (70, 50)),
             "short": (2, 200, 32, 512, (256, 1), (200, 123)),
             "ragged24": (3, 600, 24, 512, (512, 16, 1), (600, 517, 90)),
             "c40": (2, 300, 40, 32, (128, 2), (300, 131))}
# (B, T, C, tile, dilation pairs, lengths)
K8E_CASES = {"ends_inside": (2, 70, 32, 32, ((64, 1), (8, 2), (1, 64)), (70, 50)),
             "short": (2, 200, 32, 512, ((256, 1), (1, 256)), (200, 123)),
             "ragged24": (3, 600, 24, 512, ((512, 1), (16, 32), (1, 512)), (600, 517, 90)),
             "c40": (2, 300, 40, 32, ((128, 1), (2, 64)), (300, 131))}


@pytest.mark.parametrize("use_ln", [False, True], ids=["plain", "ln"])
@pytest.mark.parametrize("case", list(K8A_CASES))
def test_plain_k8a_row_equals_jax(case, use_ln):
    """The plain row form on CPU tensors against JAX's row form in interpret
    mode: the whole tower bit for bit without the LayerNorm, one layer within
    LN_RTOL with it; padded frames stay 0."""
    B, T, C, tile, dil, lens = K8A_CASES[case]
    x_j, x_t, lj, lt, lengths = _k8a_inputs(np.random.default_rng(21), B, T, C, dil, lens)
    ql = qc.quantize_tower(lt, "row")
    n = len(dil) if not use_ln else 1
    got = qc.mstcn_stack_q8(x_t, torch.from_numpy(lengths), ql[:n], dil[:n], use_ln=use_ln,
                            tile=tile, act_scale="row").numpy()
    ref = np.asarray(jqc.dilated_residual_stack_q8(x_j, _mask(T, lengths), lj[:n], dil[:n],
                                                   use_ln=use_ln, tile=tile, interpret=True,
                                                   act_scale="row"))
    if use_ln:
        np.testing.assert_allclose(got, ref, rtol=LN_RTOL, atol=LN_RTOL * np.abs(ref).max())
    else:
        np.testing.assert_array_equal(got, ref)
    assert np.abs(got).max() > 0 and not got[1, lens[1]:].any()


@pytest.mark.parametrize("case", list(K8E_CASES))
def test_plain_k8e_row_equals_jax(case):
    B, T, C, tile, dil, lens = K8E_CASES[case]
    x_j, x_t, lj, lt, lengths = _k8e_inputs(np.random.default_rng(22), B, T, C, dil, lens)
    ql = qc.quantize_tower2(lt, "row")
    got = qc.mstcn2_stack_q8(x_t, torch.from_numpy(lengths), ql, dil, tile=tile,
                             act_scale="row").numpy()
    ref = np.asarray(jqc.dilated_residual2_stack_q8(x_j, _mask(T, lengths), lj, dil, tile=tile,
                                                    interpret=True, act_scale="row"))
    np.testing.assert_array_equal(got, ref)
    assert np.abs(got).max() > 0 and not got[1, lens[1]:].any()


@pytest.mark.parametrize("use_ln", [False, True], ids=["plain", "ln"])
@pytest.mark.parametrize("case", ["ends_inside", "ragged24", "c40"])
def test_emulated_k8a_row_equals_plain(fake, case, use_ln):
    """The card's launch sequence on the model of the library gives the plain
    row version's bits: the output, every layer's row scales and rows'
    maxima on valid frames; one library call a layer."""
    B, T, C, tile, dil, lens = K8A_CASES[case]
    _, x_t, _, lt, lengths = _k8a_inputs(np.random.default_rng(23), B, T, C, dil, lens)
    ql = qc.quantize_tower(lt, "row")
    lens_t = torch.from_numpy(lengths)
    got = qc._mstcn_q8_row_card(x_t, lens_t, ql, dil, use_ln, 1e-5, tile, True)
    assert fake.calls == ["tower_row_layer"] * len(dil)
    ref = qc.mstcn_stack_q8_reference(x_t, lens_t, ql, dil, use_ln=use_ln, tile=tile,
                                      scales=True, act_scale="row")
    for g, r in zip(got, ref):
        assert g.shape == r.shape and torch.equal(g, r)
    assert torch.all(got[0][2 if B > 2 else 1, lengths[-1]:] == 0)


@pytest.mark.parametrize("case", ["ends_inside", "ragged24", "c40"])
def test_emulated_k8e_row_equals_plain(fake, case):
    B, T, C, tile, dil, lens = K8E_CASES[case]
    _, x_t, _, lt, lengths = _k8e_inputs(np.random.default_rng(24), B, T, C, dil, lens)
    ql = qc.quantize_tower2(lt, "row")
    lens_t = torch.from_numpy(lengths)
    got = qc._mstcn2_q8_row_card(x_t, lens_t, ql, dil, tile, True)
    assert fake.calls == ["tower2_row_layer"] * len(dil)
    ref = qc.mstcn2_stack_q8_reference(x_t, lens_t, ql, dil, tile=tile, scales=True,
                                       act_scale="row")
    for g, r in zip(got, ref):
        assert g.shape == r.shape and torch.equal(g, r)
    assert float(got[2].max()) > 0 and torch.all(got[0][-1, lengths[-1]:] == 0)


def test_quantize_tower_row_is_jax_per_tap_quantize_weight():
    """The row form's conv weights: JAX's ``quantize_weight`` of each tap
    (int8 values equal, scales bit-equal), in the tile form's packs; the fuse
    halves and the 1x1 as in the tile form."""
    rng = np.random.default_rng(25)
    _, _, lj, lt, _ = _k8a_inputs(rng, 1, 8, 40, (1,), (8,))
    ql, = qc.quantize_tower(lt, "row")
    qj, sj = jqc.quantize_weight(lj[0][0])
    np.testing.assert_array_equal(ql.qwdt.numpy(),
                                  np.asarray(qj).transpose(2, 0, 1).reshape(40, 120))
    np.testing.assert_array_equal(ql.swd.numpy(), np.asarray(sj))
    assert ql.swd.shape == (3, 40) and ql.kpack.shape == (40, 192)
    for k in range(3):
        assert torch.equal(ql.kpack[:, 64 * k:64 * k + 40], ql.qwdt[:, 40 * k:40 * k + 40])
    tile, = qc.quantize_tower(lt)
    assert torch.equal(tile.qw1t, ql.qw1t) and torch.equal(tile.sw1, ql.sw1)
    assert not torch.equal(tile.qwdt, ql.qwdt)
    _, _, lj2, lt2, _ = _k8e_inputs(rng, 1, 8, 24, ((1, 1),), (8,))
    ql2, = qc.quantize_tower2(lt2, "row")
    for got_q, got_s, w in ((ql2.qk1t, ql2.sk1, lj2[0][0]), (ql2.qk2t, ql2.sk2, lj2[0][2])):
        qj, sj = jqc.quantize_weight(w)
        np.testing.assert_array_equal(got_q.numpy(),
                                      np.asarray(qj).transpose(2, 0, 1).reshape(24, 72))
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(sj))
    assert ql2.kpack.shape == (2, 24, 128) and ql2.fpack.shape == (2, 24, 128)


@pytest.mark.parametrize("case", ["grad", "act_scale", "wrong_form", "lengths"])
def test_row_refusals(case, monkeypatch):
    """Inputs that want a gradient, an unknown form, weights quantized for the
    other form, and lengths of another dtype are refused before any launch."""
    def no_lib():
        raise AssertionError("the kernel library was asked for")

    monkeypatch.setattr(_build, "lib", no_lib)
    rng = np.random.default_rng(26)
    _, x, _, lt, _ = _k8a_inputs(rng, 1, 8, 16, (1,), (8,))
    _, _, _, lt2, _ = _k8e_inputs(rng, 1, 8, 16, ((1, 1),), (8,))
    n = torch.tensor([8], dtype=torch.int32)
    row, row2 = qc.quantize_tower(lt, "row"), qc.quantize_tower2(lt2, "row")
    if case == "grad":
        x = x.clone().requires_grad_(True)
        with pytest.raises(NotImplementedError):
            qc.mstcn_stack_q8(x, n, row, [1], use_ln=False, act_scale="row")
        with pytest.raises(NotImplementedError):
            qc.mstcn2_stack_q8(x, n, row2, [(1, 1)], act_scale="row")
    elif case == "act_scale":
        with pytest.raises(ValueError, match="act_scale"):
            qc.quantize_tower(lt, "col")
        with pytest.raises(ValueError, match="act_scale"):
            qc.mstcn2_stack_q8(x, n, row2, [(1, 1)], act_scale="frame")
    elif case == "wrong_form":
        with pytest.raises(ValueError, match="act_scale='tile'"):
            qc.mstcn_stack_q8(x, n, row, [1], use_ln=False)
        with pytest.raises(ValueError, match="act_scale='row'"):
            qc.mstcn2_stack_q8(x, n, qc.quantize_tower2(lt2), [(1, 1)], act_scale="row")
    else:
        with pytest.raises(ValueError, match="int32"):
            qc._mstcn_q8_row_card(x, n.long(), row, [1], False, 1e-5, 512, False)
        with pytest.raises(ValueError, match="int32"):
            qc._mstcn2_q8_row_card(x, n.long(), row2, [(1, 1)], 512, False)


# ---------------------------------------------------------------------------
# the slice: a narrow int8 iuUU with row towers against JAX's


def _bind(fn, act_scale):
    def f(*a, **kw):
        return fn(*a, **dict(kw, interpret=True, act_scale=act_scale))
    return f


def _interp(fn):
    def f(*a, **kw):
        return fn(*a, **dict(kw, interpret=True))
    return f


@pytest.fixture(scope="module", params=["m", "m2"])
def row_run(request):
    """The JAX model in interpret mode with its towers bound to the row
    form, MSTCN (K8a) or MS-TCN++ (K8e)."""
    f = request.param
    jcfg = _make_cfg(small=True)
    for k, v in _narrow(small_cfg(), f)["Bi"].items():
        setattr(jcfg.Bi, k, v)
    jcfg.TPU.quantize_infer = "int8"
    jcfg.TPU.pallas_sa = False
    rng = np.random.default_rng(27)
    feats = rng.standard_normal((NB, NT, ND)).astype(np.float32)
    lengths = np.array([NT, 1100], np.int32)
    mask = np.arange(NT)[None] < lengths[:, None]
    feats[~mask] = 0.0
    args = (jnp.asarray(feats), jnp.asarray(mask), jnp.asarray(lengths))
    with mock.patch.object(jblocks, "_PALLAS_PLATFORM_OVERRIDE", "tpu"), \
            mock.patch.object(jqc, "dilated_residual_stack_q8",
                              _bind(jqc.dilated_residual_stack_q8, "row")), \
            mock.patch.object(jqc, "dilated_residual2_stack_q8",
                              _bind(jqc.dilated_residual2_stack_q8, "row")), \
            mock.patch.object(jqc, "x2y_attention_q8", _interp(jqc.x2y_attention_q8)), \
            mock.patch.object(jqc, "mha_cross_attention_q8",
                              _interp(jqc.mha_cross_attention_q8)):
        model = jblocks.build_fact(jcfg, ND, NC, s_pred_cap=NS)
        params = model.init({"params": jax.random.PRNGKey(1)}, *args, train=False)
        saves, _ = model.apply(params, *args, train=False)
    last = saves[-1]
    pred = jdecode.decode_two_branch(last["action_clogit"], last["a2f_attn"],
                                     last["frame_clogit"], float(jcfg.FACT.mwt),
                                     jnp.ones(last["action_clogit"].shape[:2], bool))
    return dict(f=f, params=jax.tree_util.tree_map(np.asarray, params["params"]), feats=feats,
                mask=mask, lengths=lengths, frame_clogit=np.asarray(saves[0]["frame_clogit"]),
                pred=np.asarray(pred))


def test_int8_row_towers_match_jax(row_run):
    """The port's int8 eval with every tower's ``act_scale`` set to "row"
    against JAX's with its towers bound to the row form: block-0 frame logits
    within a relative L2 error of 1e-3 and >= 99 % of the predictions equal
    (the other int8 layers as in ``test_int8_slice_matches_jax``).  The tile
    and row forms keep their quantized weights in separate caches."""
    cfg = _narrow(small_cfg(), row_run["f"])
    model = build_fact(cfg, ND, NC, NS, device="cpu")
    load_jax_params(model, row_run["params"])
    towers = [m for m in model.modules() if isinstance(m, (MSTCN, MSTCN2))]
    assert towers and {m.quantize for m in towers} == {"int8"}
    x = [torch.from_numpy(row_run[k]) for k in ("feats", "mask", "lengths")]
    mask = row_run["mask"]
    with torch.no_grad():
        model(*x)  # the tile form first: its cache must not serve the row form
    for m in towers:
        m.act_scale = "row"
    before = kernel_counters()
    with torch.no_grad():
        saves, _ = model(*x)
    assert kernel_counters() == before  # CPU tensors: plain versions, no launch
    for m in towers:
        tile_w, row_w = m.__dict__["_cached_q8_tile"][1], m.__dict__["_cached_q8_row"][1]
        assert tile_w[0][1].dim() == 1 and row_w[0][1].dim() == 2
    got, ref = saves[0]["frame_clogit"].numpy()[mask], row_run["frame_clogit"][mask]
    assert _rel(got, ref) <= 1e-3, _rel(got, ref)
    pred = make_eval_step(model, 0.1)(*x).numpy()
    agree = float(np.mean(pred[mask] == row_run["pred"][mask]))
    assert agree >= 0.99, agree
