"""K8e's int8 wgmma design (``csrc/quant2.cu`` on ``csrc/tc_int8.cuh``) checked on the CPU.

A layer of the int8 MS-TCN++ tower is four launches on the card: each JAX
tile's window of the layer input quantized once as int8 (pass W), both
convs as shifted-row int32 products of that window with their f32
epilogue and the tile maxima of |c| (pass A), c quantized with those
maxima (pass Q), and the two fuse products with the residual, the mask
and the next layer's group maxima (pass F), every A and F item inside one
JAX tile.  Here, without a card, ``FakeK8eLib`` models the library's C
entries (``fk_q8_group_max``, ``fk_q8_tower2_layer``) on the raw memory of
CPU tensors, item for item in that data flow: the window slabs the
wrapper lays out, the taps as row offsets into them, the K segments padded
to whole 32-byte steps, the skips of items past a video, and the
epilogues in the kernels' order.  The port's launch sequence
(``_mstcn2_q8_card``) runs on it and is held bit-equal, output and
integer scales, to the plain version ``mstcn2_stack_q8_reference``, and
to JAX's ``_stack2_layer_q8`` in interpret mode.  Cases: a video that ends
inside a tile, T < 512 (tile = ceil8(T)), dilations past the tile, and C =
24 and 40 (widths that are no multiple of 32).
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_k6_tc import _ints, _view

from fact_clip_tpu.ops.pallas import quant_conv as jqc
from fact_clip_tpu_torch import _build
from fact_clip_tpu_torch.ops import quant_conv as qc

torch.set_num_threads(2)


def _bytes(ptr, n):
    return _view(ptr, n, ctypes.c_int8, torch.int8)


class FakeK8eLib:
    """The K8e kernels' arithmetic and data flow on the memory behind the
    pointers; ``calls`` lists the entries run."""

    BM = 128  # rows of a block of passes A and F

    def __init__(self):
        self.calls = []

    def fk_q8_group_max(self, x, lengths, gmax, B, T, T_pad, C, stream):
        self.calls.append("group_max")
        X = _view(x, B * T * C).view(B, T, C)
        lens = _ints(lengths, B)
        rows = torch.zeros(B, T_pad)
        for b in range(B):
            n = min(int(lens[b]), T)
            rows[b, :n] = X[b, :n].abs().amax(dim=-1)
        _view(gmax, B * T_pad // 8).view(B, -1)[:] = rows.view(B, -1, 8).amax(dim=-1)
        return 0

    def fk_q8_tower2_layer(self, x, lengths, gmax_in, kpack, Kc, sk1, b1, sk2, b2, fpack, Kf,
                           swt, swb, bf, qwin, sx, c, qc_, smax, y, gmax_out, B, T, C, Cw, d1,
                           d2, halo, tile, n_tiles, T_pad, stream):
        self.calls.append("tower2_layer")
        kseg = -(-C // 32) * 32
        assert Cw >= C and Cw % 16 == 0 and Kc >= 3 * kseg and Kf >= kseg
        assert halo >= max(d1, d2) and halo % 8 == 0 and T_pad == n_tiles * tile
        G, wrows, BM = T_pad // 8, tile + 2 * halo, self.BM
        X = _view(x, B * T * C).view(B, T, C)
        lens = [min(int(v), T) for v in _ints(lengths, B)]
        gin = _view(gmax_in, B * G).view(B, G)
        W = _bytes(qwin, B * n_tiles * wrows * Cw).view(B, n_tiles, wrows, Cw)
        SX = _view(sx, B * n_tiles).view(B, n_tiles)
        Cb = _view(c, 2 * B * T_pad * Cw).view(2, B, T_pad, Cw)
        QC = _bytes(qc_, 2 * B * T_pad * Cw).view(2, B, T_pad, Cw)
        SMf = _view(smax, 2 * B * n_tiles).view(2, B, n_tiles)  # the int bits of |c| maxima
        Y = _view(y, B * T * C).view(B, T, C)
        GO = _view(gmax_out, B * G).view(B, G)
        KP = _bytes(kpack, 2 * C * Kc).view(2, C, Kc)
        FP = _bytes(fpack, 2 * C * Kf).view(2, C, Kf)
        sk = [_view(sk1, C), _view(sk2, C)]
        bias = [_view(b1, C), _view(b2, C)]
        d = [d1, d2]

        def idot(a, w):  # the int32 sum of int8 rows by int8 weight rows, exact
            return torch.matmul(a.double(), w.double().t()).float()

        def fma(a, b, c_):
            return (a.double() * b.double() + c_.double()).float()

        # pass W: each tile's window, quantized once with its s_x
        for b in range(B):
            for t in range(n_tiles):
                lo, hi = max(0, t * tile - halo) // 8, min(T_pad, t * tile + tile + halo) // 8
                s = gin[b, lo:hi].max().clamp_min(1e-12)
                SX[b, t] = s
                inv = qc._div(127.0, s.view(1))
                rows = torch.arange(wrows) + t * tile - halo
                ok = (rows >= 0) & (rows < lens[b])
                win = torch.zeros(wrows, Cw, dtype=torch.int8)
                win[ok, :C] = torch.round(X[b, rows[ok]] * inv).to(torch.int8)
                W[b, t] = win
        # pass A: per (128 rows of a tile, conv, video); K = 3 taps x kseg
        jt = -(-tile // BM)
        for z in range(2):
            wz = torch.stack([KP[z, :, k * kseg:(k + 1) * kseg] for k in range(3)])
            for b in range(B):
                for t in range(n_tiles):
                    slab = torch.nn.functional.pad(W[b, t], (0, max(0, kseg - Cw)))[:, :kseg]
                    for j in range(jt):
                        r0 = t * tile + j * BM
                        rt = torch.arange(j * BM, min(tile, j * BM + BM))  # rows of the tile
                        if r0 >= min(lens[b], T_pad) + d[z]:
                            acc = torch.zeros(len(rt), C)  # every tap past the video
                        else:
                            acc = sum(idot(slab[halo + rt + (k - 1) * d[z]], wz[k])
                                      for k in range(3))
                        v = fma(acc, SX[b, t] * sk[z], bias[z])
                        Cb[z, b, t * tile + rt, :C] = v
                        SMf[z, b, t] = max(float(v.abs().max()), float(SMf[z, b, t]))
        # pass Q: c quantized with its tile's s1, s2
        tile_of = torch.arange(T_pad) // tile
        for z in range(2):
            for b in range(B):
                s = SMf[z, b].clamp_min(1e-12)[tile_of][:, None]
                q = torch.zeros(T_pad, Cw, dtype=torch.int8)
                q[:, :C] = torch.round(Cb[z, b, :, :C] * qc._div(127.0, s)).to(torch.int8)
                QC[z, b] = q
        # pass F: per (128 rows of a tile, video); h1 and h2 in two accumulators
        for b in range(B):
            for t in range(n_tiles):
                s1, s2 = (SMf[z, b, t].clamp_min(1e-12) for z in range(2))
                for j in range(jt):
                    r0 = t * tile + j * BM
                    rows = torch.arange(r0, t * tile + min(tile, j * BM + BM))
                    rows = rows[rows < T]
                    if len(rows) == 0:
                        continue
                    out = torch.zeros(len(rows), C)
                    if r0 < lens[b]:
                        a = [torch.nn.functional.pad(QC[z, b, rows], (0, max(0, kseg - Cw)))
                             [:, :kseg] for z in range(2)]
                        h1, h2 = (idot(a[z], FP[z, :, :kseg]) for z in range(2))
                        h = fma(h1, s1 * _view(swt, C), h2 * (s2 * _view(swb, C)))
                        out = torch.relu(h + _view(bf, C)) + X[b, rows]
                        out[rows >= lens[b]] = 0.0
                    Y[b, rows] = out
                    grp = out.abs().amax(dim=-1)
                    for g in range(len(rows) // 8 + (len(rows) % 8 > 0)):
                        gi = int(rows[8 * g]) // 8
                        GO[b, gi] = max(float(GO[b, gi]), float(grp[8 * g:8 * g + 8].max()))
        return 0


@pytest.fixture
def fake(monkeypatch):
    lib = FakeK8eLib()
    monkeypatch.setattr(_build, "lib", lambda: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    return lib


def _inputs(rng, B, T, C, dil_pairs, lengths):
    def pair(shape, scale):
        a = (rng.standard_normal(shape) * scale).astype(np.float32)
        return jnp.asarray(a), torch.from_numpy(a)

    x_j, x_t = pair((B, T, C), 1.0)
    lj, lt = [], []
    for _ in dil_pairs:
        parts = [pair(s, sc) for s, sc in [((3, C, C), 0.08), ((C,), 0.3), ((3, C, C), 0.08),
                                           ((C,), 0.3), ((C, C), 0.1), ((C, C), 0.1),
                                           ((C,), 0.05)]]
        lj.append(tuple(p[0] for p in parts))
        lt.append(tuple(p[1] for p in parts))
    lengths = np.array(lengths, np.int32)
    return x_j, x_t, lj, lt, lengths


# (B, T, C, tile, dilation pairs, lengths):
#   "ends_inside": tile 32 of 70 frames, video 1 ending at 50 inside the second tile;
#   "short": T = 200 < 512, so tile = ceil8(T) = 200 and d = 256 > tile;
#   "c24" / "c40": the widths of no multiple of 32, T = 600 in two tiles of
#   512 (both windows reach across), d = 512 past the short video
CASES = {"ends_inside": (2, 70, 32, 32, ((64, 1), (8, 2), (1, 64)), (70, 50)),
         "short": (2, 200, 32, 512, ((256, 1), (1, 256)), (200, 123)),
         "c24": (3, 600, 24, 512, ((512, 1), (16, 32), (1, 512)), (600, 517, 90)),
         "c40": (2, 600, 40, 512, ((512, 1), (2, 256)), (600, 300))}


@pytest.mark.parametrize("case", list(CASES))
def test_emulated_k8e_equals_plain_and_jax_bit_for_bit(fake, case):
    """The card's data flow gives the plain version's bits: the output, every
    layer's group maxima and tile maxima; and one layer of it gives JAX's
    ``_stack2_layer_q8`` (interpret mode) bit for bit."""
    B, T, C, tile, dil, lens = CASES[case]
    rng = np.random.default_rng(11)
    x_j, x_t, lj, lt, lengths = _inputs(rng, B, T, C, dil, lens)
    ql = qc.quantize_tower2(lt)
    lens_t = torch.from_numpy(lengths)
    got = qc._mstcn2_q8_card(x_t, lens_t, ql, dil, tile, True)
    assert fake.calls == ["group_max"] + ["tower2_layer"] * len(dil)
    ref = qc.mstcn2_stack_q8_reference(x_t, lens_t, ql, dil, tile=tile, scales=True)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and torch.equal(g, r)
    assert float(got[0].abs().max()) > 0 and torch.all(got[0][1, lens[1]:] == 0)
    # JAX's one layer on the tower's input and layer 0, through its padded layout
    _, tile_j, n_tiles = qc._tiling(T, tile, 1)
    one = jqc.dilated_residual2_stack_q8(x_j, jnp.asarray(np.arange(T)[None] < lengths[:, None]),
                                         lj[:1], dil[:1], tile=tile, interpret=True)
    mine = qc._mstcn2_q8_card(x_t, lens_t, ql[:1], dil[:1], tile, False)
    np.testing.assert_array_equal(mine.numpy(), np.asarray(one))


def test_k8e_layout_pads_any_width():
    """``k8e_layout`` and the packs of ``quantize_tower2``: a tap's K segment
    in whole 32-byte steps, every pack and buffer row at least one 128-byte
    box, and the packs hold the plain layout's weights with zeros past C."""
    assert qc.k8e_layout(512) == (512, 1536, 512, 512)
    assert qc.k8e_layout(24) == (32, 128, 128, 128)
    assert qc.k8e_layout(40) == (64, 192, 128, 128)
    rng = np.random.default_rng(3)
    _, _, _, lt, _ = _inputs(rng, 1, 8, 40, ((1, 1),), (8,))
    ql, = qc.quantize_tower2(lt)
    assert ql.kpack.shape == (2, 40, 192) and ql.fpack.shape == (2, 40, 128)
    for z, qkt in enumerate((ql.qk1t, ql.qk2t)):
        for k in range(3):
            assert torch.equal(ql.kpack[z, :, 64 * k:64 * k + 40], qkt[:, 40 * k:40 * k + 40])
            assert not ql.kpack[z, :, 64 * k + 40:64 * k + 64].any()
    assert torch.equal(ql.fpack[0, :, :40], ql.qwtt) and torch.equal(ql.fpack[1, :, :40], ql.qwbt)
    assert not ql.fpack[:, :, 40:].any()
