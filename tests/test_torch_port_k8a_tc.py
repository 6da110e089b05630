"""K8a's int8 wgmma design (``csrc/quant2.cu`` on ``csrc/tc_int8.cuh``) checked on the CPU.

A layer of the int8 MSTCN tower is K8e's passes with one conv on the card:
each JAX tile's window of the layer input quantized once (pass W), the
dilated conv as shifted-row int32 products of that window with the ReLU in
its epilogue and the tiles' maxima of a (pass A), a quantized with those
maxima (pass Q), the 1x1 product with the residual, the mask and the next
layer's group maxima (pass B), and with the LayerNorm a fifth pass that
normalizes each row in place (a warp a row) and takes the group maxima.
Here, without a card, ``FakeK8aLib`` models the library's C entries
(``fk_q8_group_max``, ``fk_q8_tower_layer``) on the raw memory of CPU
tensors, item for item in that data flow: the window slabs, the taps as row
offsets into them, the K segments padded to whole 32-byte steps, the skips
of items past a video, the LayerNorm's lane sums, and the epilogues in the
kernels' order.  The port's launch sequence (``_mstcn_q8_card``) runs on it
and is held bit-equal, output and integer scales, to the plain version
``mstcn_stack_q8_reference``, and one layer of it to JAX's
``dilated_residual_stack_q8`` in interpret mode: bit for bit without the
LayerNorm, within 2e-6 relative with it (JAX normalizes with its own sum
order and rsqrt).  Cases: a video that ends inside a tile, T < 512 (tile =
ceil8(T)) with a dilation past the tile, C = 24 and 40 (widths that are no
multiple of 32) and C = 256 (pass B's two column items), each with and
without the LayerNorm.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_k6_tc import _ints, _view
from test_torch_port_k8e_tc import FakeK8eLib, _bytes

from fact_clip_tpu.ops.pallas import quant_conv as jqc
from fact_clip_tpu_torch import _build
from fact_clip_tpu_torch.ops import quant_conv as qc

torch.set_num_threads(2)
LN_RTOL = 2e-6  # one LayerNorm'd layer against JAX's: its mean and variance sums in another order


def _lane_tree(v):
    """The kernel's row sum: lane l adds channels l, l + 32, ... from 0, then
    the xor-shuffle tree over the 32 lanes."""
    lanes = torch.zeros(v.shape[0], 32)
    for c in range(v.shape[1]):
        lanes[:, c % 32] = lanes[:, c % 32] + v[:, c]
    idx = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, idx ^ o]
    return lanes[:, :1]


class FakeK8aLib(FakeK8eLib):
    """K8e's model (its group maxima) and K8a's layer entry on the memory
    behind the pointers."""

    def fk_q8_tower_layer(self, x, lengths, gmax_in, kpack, Kc, swd, bd, wpack, Kw, sw1, b1,
                          gamma, beta, use_ln, eps, qwin, sx, a, qa, smax, y, gmax_out, B, T, C,
                          Cw, d, halo, tile, n_tiles, T_pad, stream):
        self.calls.append("tower_layer")
        kseg = -(-C // 32) * 32
        assert Cw >= C and Cw % 16 == 0 and Kc >= 3 * kseg and Kw >= kseg
        assert halo >= d and halo % 8 == 0 and T_pad == n_tiles * tile
        G, wrows, BM = T_pad // 8, tile + 2 * halo, self.BM
        X = _view(x, B * T * C).view(B, T, C)
        lens = [min(int(v), T) for v in _ints(lengths, B)]
        gin = _view(gmax_in, B * G).view(B, G)
        W = _bytes(qwin, B * n_tiles * wrows * Cw).view(B, n_tiles, wrows, Cw)
        SX = _view(sx, B * n_tiles).view(B, n_tiles)
        A = _view(a, B * T_pad * Cw).view(B, T_pad, Cw)
        QA = _bytes(qa, B * T_pad * Cw).view(B, T_pad, Cw)
        SMf = _view(smax, B * n_tiles).view(B, n_tiles)  # the int bits of a's maxima
        Y = _view(y, B * T * C).view(B, T, C)
        GO = _view(gmax_out, B * G).view(B, G)
        KP = _bytes(kpack, C * Kc).view(C, Kc)
        WP = _bytes(wpack, C * Kw).view(C, Kw)
        swd_, bd_, sw1_, b1_ = (_view(p, C) for p in (swd, bd, sw1, b1))

        def idot(u, w):  # the int32 sum of int8 rows by int8 weight rows, exact
            return torch.matmul(u.double(), w.double().t()).float()

        def fma(u, v, w):
            return (u.double() * v.double() + w.double()).float()

        def padk(rows):  # int8 rows as the K steps read them: kseg wide, zeros past Cw
            return torch.nn.functional.pad(rows, (0, max(0, kseg - Cw)))[:, :kseg]

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
        # pass A: per (128 rows of a tile, video); K = 3 taps x kseg, one accumulator
        jt = -(-tile // BM)
        wk = torch.stack([KP[:, k * kseg:(k + 1) * kseg] for k in range(3)])
        for b in range(B):
            for t in range(n_tiles):
                slab = padk(W[b, t])
                for j in range(jt):
                    r0 = t * tile + j * BM
                    rt = torch.arange(j * BM, min(tile, j * BM + BM))  # rows of the tile
                    if r0 >= min(lens[b], T_pad) + d:
                        acc = torch.zeros(len(rt), C)  # every tap past the video
                    else:
                        acc = sum(idot(slab[halo + rt + (k - 1) * d], wk[k]) for k in range(3))
                    v = torch.relu(fma(acc, SX[b, t] * swd_, bd_))
                    A[b, t * tile + rt, :C] = v
                    SMf[b, t] = max(float(v.max()), float(SMf[b, t]))
        # pass Q: a quantized with its tile's s_a
        tile_of = torch.arange(T_pad) // tile
        for b in range(B):
            s = SMf[b].clamp_min(1e-12)[tile_of][:, None]
            q = torch.zeros(T_pad, Cw, dtype=torch.int8)
            q[:, :C] = torch.round(A[b, :, :C] * qc._div(127.0, s)).to(torch.int8)
            QA[b] = q
        # pass B: per (128 rows of a tile, video)
        for b in range(B):
            for t in range(n_tiles):
                s_a = SMf[b, t].clamp_min(1e-12)
                for j in range(jt):
                    r0 = t * tile + j * BM
                    rows = torch.arange(r0, t * tile + min(tile, j * BM + BM))
                    rows = rows[rows < T]
                    if len(rows) == 0:
                        continue
                    out = torch.zeros(len(rows), C)
                    if r0 < lens[b]:
                        acc = idot(padk(QA[b, rows]), WP[:, :kseg])
                        out = fma(acc, s_a * sw1_, b1_) + X[b, rows]
                        out[rows >= lens[b]] = 0.0
                    Y[b, rows] = out
                    if use_ln:
                        continue  # pass N takes the group maxima
                    grp = out.abs().amax(dim=-1)
                    for g in range(len(rows) // 8 + (len(rows) % 8 > 0)):
                        gi = int(rows[8 * g]) // 8
                        GO[b, gi] = max(float(GO[b, gi]), float(grp[8 * g:8 * g + 8].max()))
        # pass N: a warp a row, 8 rows a block, in place
        if use_ln:
            g_, be_ = _view(gamma, C), _view(beta, C)
            for b in range(B):
                for gi in range(-(-T // 8)):
                    rows = torch.arange(8 * gi, max(8 * gi, min(8 * gi + 8, lens[b])))
                    if len(rows) == 0:
                        GO[b, gi] = 0.0
                        continue
                    o = Y[b, rows]
                    mean = qc._over(_lane_tree(o), float(C))
                    dv = o - mean
                    var = qc._over(_lane_tree(dv * dv), float(C))
                    inv = qc._div(1.0, torch.sqrt(var + torch.tensor(eps, dtype=torch.float32)))
                    o = fma(dv * inv, g_, be_)
                    Y[b, rows] = o
                    GO[b, gi] = float(o.abs().max())
        return 0


@pytest.fixture
def fake(monkeypatch):
    lib = FakeK8aLib()
    monkeypatch.setattr(_build, "lib", lambda: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    return lib


def _inputs(rng, B, T, C, dilations, lengths):
    def pair(shape, scale, shift=0.0):
        v = (rng.standard_normal(shape) * scale + shift).astype(np.float32)
        return jnp.asarray(v), torch.from_numpy(v)

    x_j, x_t = pair((B, T, C), 1.0)
    lj, lt = [], []
    for _ in dilations:
        parts = [pair((3, C, C), 0.08), pair((C,), 0.05), pair((C, C), 0.08), pair((C,), 0.05),
                 pair((C,), 0.2, 1.0), pair((C,), 0.2)]
        lj.append(tuple(p[0] for p in parts))
        lt.append(tuple(p[1] for p in parts))
    return x_j, x_t, lj, lt, np.array(lengths, np.int32)


# (B, T, C, tile, dilations, lengths):
#   "ends_inside": tile 32 of 70 frames, video 1 ending at 50 inside the second tile,
#   d = 64 past the tile;
#   "short": T = 200 < 512, so tile = ceil8(T) = 200 and d = 256 > tile;
#   "c24" / "c40": widths of no multiple of 32, T = 600 in two tiles of 512 (both
#   windows reach across), d = 512 past the short video;
#   "c256": the flagship's width, pass B in two column items
CASES = {"ends_inside": (2, 70, 32, 32, (64, 8, 1), (70, 50)),
         "short": (2, 200, 32, 512, (256, 1), (200, 123)),
         "c24": (3, 600, 24, 512, (512, 16, 1), (600, 517, 90)),
         "c40": (2, 600, 40, 512, (512, 2), (600, 300)),
         "c256": (2, 300, 256, 128, (1, 64), (300, 190))}


@pytest.mark.parametrize("use_ln", [False, True], ids=["plain", "ln"])
@pytest.mark.parametrize("case", list(CASES))
def test_emulated_k8a_equals_plain_and_jax(fake, case, use_ln):
    """The card's data flow gives the plain version's bits: the output, every
    layer's group maxima and tile maxima; and one layer of it gives JAX's
    ``dilated_residual_stack_q8`` (interpret mode): bit for bit without the
    LayerNorm, within LN_RTOL with it."""
    B, T, C, tile, dil, lens = CASES[case]
    rng = np.random.default_rng(12)
    x_j, x_t, lj, lt, lengths = _inputs(rng, B, T, C, dil, lens)
    ql = qc.quantize_tower(lt)
    lens_t = torch.from_numpy(lengths)
    got = qc._mstcn_q8_card(x_t, lens_t, ql, dil, use_ln, 1e-5, tile, True)
    assert fake.calls == ["group_max"] + ["tower_layer"] * len(dil)
    ref = qc.mstcn_stack_q8_reference(x_t, lens_t, ql, dil, use_ln=use_ln, tile=tile,
                                      scales=True)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and torch.equal(g, r)
    assert float(got[0].abs().max()) > 0 and torch.all(got[0][1, lens[1]:] == 0)
    mask = jnp.asarray(np.arange(T)[None] < lengths[:, None])
    one = np.asarray(jqc.dilated_residual_stack_q8(x_j, mask, lj[:1], dil[:1], use_ln=use_ln,
                                                   tile=tile, interpret=True))
    mine = qc._mstcn_q8_card(x_t, lens_t, ql[:1], dil[:1], use_ln, 1e-5, tile, False).numpy()
    if use_ln:
        np.testing.assert_allclose(mine, one, rtol=LN_RTOL, atol=LN_RTOL * np.abs(one).max())
    else:
        np.testing.assert_array_equal(mine, one)


def test_k8a_packs_pad_any_width():
    """``quantize_tower``'s packs: a tap's K segment in whole 32-byte steps
    (``k8e_layout``), each pack row at least one 128-byte box, holding the
    plain layout's weights with zeros past C."""
    rng = np.random.default_rng(3)
    _, _, _, lt, _ = _inputs(rng, 1, 8, 40, (1,), (8,))
    ql, = qc.quantize_tower(lt)
    assert ql.kpack.shape == (40, 192) and ql.wpack.shape == (40, 128)
    for k in range(3):
        assert torch.equal(ql.kpack[:, 64 * k:64 * k + 40], ql.qwdt[:, 40 * k:40 * k + 40])
        assert not ql.kpack[:, 64 * k + 40:64 * k + 64].any()
    assert torch.equal(ql.wpack[:, :40], ql.qw1t) and not ql.wpack[:, 40:].any()
    ql24, = qc.quantize_tower(_inputs(rng, 1, 8, 24, (1,), (8,))[3])
    assert ql24.kpack.shape == (24, 128) and ql24.wpack.shape == (24, 128)
