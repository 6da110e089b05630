"""K8b's redesign, K2's small-X split with an int8 q projection, on the CPU.

On the card K8b is one library call, ``fk_x2y_sx_q8_fwd``
(``csrc/x2y_attn.cu``), of these launches into one workspace: the key side
as K2's small-X forward runs it (``sx_attn.cuh``'s prep of the lengths and
[x + x_pos | x], the packs of Wk^T and Wv^T, [xk | xv] on the 3xTF32 GEMM,
epilogue kProj32, zeros past x_len), on a second stream; the query side on
``csrc/q8_proj.cu``'s int8 core: the rows q(y + y_pos) with their absmax
scales (the row quantizer's one-output form, zeros past Cy up to
``k8d_layout``'s Cw) and yq = fma(idot(q(y + y_pos), qWq) * s_y, swq, bq) as
one persistent launch of one problem over 128-row items; then the attention
per (tile of 8-32 query rows, video).  Here, without a card,
``FakeK8bLib`` (``FakeK2SxLib`` of ``test_torch_port_k2_sx.py`` and the
entry, step for step on the raw memory of CPU tensors) stands in for the
library.  The port's launch sequence (``_x2y_sx_q8_card``) is held against
JAX's ``quant_conv.py::x2y_attention_q8`` in interpret mode (its small-X
form) and the plain version; its quantized rows and yq are bit-equal to the
plain quantizer and ``_proj_q8``.  Cases: Y not a multiple of the query
tile, X = 1, 37 and 300, Cy = 24 and 48 (no multiple of 32: Wq's pack and
the rows padded), ragged x_len and x_len = 0, no, shared and per-video
positional tables; Cx = d = 48.

Tolerance: 2e-5 of max(1, the reference's largest value), as the K8d file:
the key side's split keeps ~2^-22 of each product, f32 sums in another
order.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_k2_sx import FakeK2SxLib, _close
from test_torch_port_k6_tc import _ints, _view
from test_torch_port_k8e_tc import _bytes

from fact_clip_tpu.ops.pallas import quant_conv as jqc
from fact_clip_tpu_torch import _build
from fact_clip_tpu_torch.ops import dilated_conv as dc
from fact_clip_tpu_torch.ops import quant_conv as qc
from fact_clip_tpu_torch.ops import x2y_attn as xa
from fact_clip_tpu_torch.ops.pos import add_pos

torch.set_num_threads(2)
CX = D = 48


class FakeK8bLib(FakeK2SxLib):
    """``FakeK2SxLib`` (the packs, the GEMM) and K8b's entry: the key side's
    prep, packs and projection, the row quantizer, the int8 projection over
    128-row items, then per (tile of `tile` query rows, video) the logits,
    probs and attn.  Keys at or past x_len compute nothing; a video with
    x_len = 0 attends to every key."""

    BM = 128  # query rows of a projection item

    def fk_x2y_sx_q8_fwd(self, y, ypos, ystride, Py, x, xpos, xstride, Px, wqpack, Kw, swq, bq,
                         wk, bk, wv, bv, xlen, B, Y_, X_, Cy, Cx, Cw, d, scale, lens, xin, wkvp,
                         kv, qy, sy, yq, logits, probs, attn, tile, stream):
        kseg = -(-Cy // 32) * 32
        assert d % 4 == 0 and Cx % 4 == 0 and Px % 4 == 0 and 1 <= X_ <= 1024
        assert tile in xa.SX_ROWS and (xpos is None) == (xin is None)
        assert Cw >= max(Cy, 128) and Cw % 16 == 0 and Kw >= max(kseg, 128) and Kw % 16 == 0
        # the key side: the lengths and [x + x_pos | x], Wk^T, Wv^T and kv
        self.calls.append(("sx_prep",))
        L, xl = _ints(lens, 2 * B + 1), _ints(xlen, B)
        L[:B], L[2 * B] = Y_, X_
        L[B:2 * B] = torch.where(xl > 0, xl.clamp(max=X_), X_)
        if xin is not None:
            Xv = _view(x, B * X_ * Cx).view(B, X_, Cx)
            Xk = Xv.clone()
            Xk[..., :Px] += _view(xpos, (B if xstride else 1) * X_ * Px).view(-1, X_, Px)
            _view(xin, B * X_ * 2 * Cx)[:] = torch.cat([Xk, Xv], -1).flatten()
        self.fk_k6_pack(wk, wkvp, Cx, d, 1, Cx, Cx, 0)
        self.fk_k6_pack(wv, wkvp + 4 * 2 * d * Cx, Cx, d, 1, Cx, Cx, 0)
        two = (ctypes.c_int * 4)(0, 0, 0, Cx if xin is not None else 0)
        self.fk_k6_gemm(dc._PROJ32, xin or x, 2 * Cx if xin is not None else Cx, 2, 1,
                        ctypes.addressof(two), Cx, wkvp, d, Cx, B, X_, lens + 4 * B, kv, 2 * d,
                        d, bk, bv, None, 0, 0, None, None, None, 0, 0, 1.0, 0)
        # the query side: q(y + y_pos) and its scales, zeros past Cy
        self.calls.append(("rows_q",))
        yv = _view(y, B * Y_ * Cy).view(B, Y_, Cy).clone()
        if ypos is not None:
            yv[..., :Py] += _view(ypos, (B if ystride else 1) * Y_ * Py).view(-1, Y_, Py)
        s = yv.abs().amax(dim=-1).clamp_min(1e-12)
        QY = _bytes(qy, B * Y_ * Cw).view(B, Y_, Cw)
        QY[:] = 0
        QY[..., :Cy] = torch.round(yv * qc._div(127.0, s[..., None])).to(torch.int8)
        SY = _view(sy, B * Y_).view(B, Y_)
        SY[:] = s
        # the projection, per (128 rows, video): fma(idot * s_row, sw, b), every row
        self.calls.append(("q_proj",))
        WP = _bytes(wqpack, d * Kw).view(d, Kw)
        YQ = _view(yq, B * Y_ * d).view(B, Y_, d)
        sw, bias = _view(swq, d), _view(bq, d)
        for b in range(B):
            for r0 in range(0, Y_, self.BM):
                rows = slice(r0, min(r0 + self.BM, Y_))
                a = torch.nn.functional.pad(QY[b, rows], (0, max(0, kseg - Cw)))[:, :kseg]
                acc = torch.matmul(a.double(), WP[:, :kseg].double().t()).float()
                YQ[b, rows] = ((acc * SY[b, rows][:, None]).double() * sw.double()
                               + bias.double()).float()
        # the attention, as K2's small-X form's
        self.calls.append(("x2y_sx_attn", tile))
        KV = _view(kv, B * X_ * 2 * d).view(B, X_, 2 * d)
        LG, PR = (_view(p, B * Y_ * X_).view(B, Y_, X_) for p in (logits, probs))
        AT = _view(attn, B * Y_ * d).view(B, Y_, d)
        keys = torch.arange(X_)
        for b in range(B):
            l_b = min(int(xl[b]), X_)
            xk, xv = KV[b, :, :d], KV[b, :, d:]
            nk = l_b if l_b > 0 else X_
            for y0 in range(0, Y_, tile):
                rows = slice(y0, min(y0 + tile, Y_))
                lg = torch.where(keys < l_b, (YQ[b, rows] @ xk.t()) * scale, -1e9)
                p = torch.softmax(lg, -1)
                LG[b, rows], PR[b, rows] = lg, p
                AT[b, rows] = p[:, :nk] @ xv[:nk]
        return 0


@pytest.fixture
def fake(monkeypatch):
    lib = FakeK8bLib()
    monkeypatch.setattr(_build, "lib", lambda: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    return lib


def _pair(rng, shape, scale=1.0):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _inputs(seed, Y, X, Cy, xlen, y_pos, x_pos):
    """(jax list, torch list) of x2y_attention_q8's arguments: y (B, Y, Cy)
    with y_pos "none" (JAX: zeros), "shared" or "per_video", x (B, X, CX)
    with x_pos "none", "shared" or "per_video"."""
    rng = np.random.default_rng(seed)
    B = len(xlen)
    y, x = _pair(rng, (B, Y, Cy)), _pair(rng, (B, X, CX))
    yp = None if y_pos == "none" else _pair(rng, (B if y_pos == "per_video" else 1, Y, Cy), 0.5)
    xp = None if x_pos == "none" else _pair(rng, (B if x_pos == "per_video" else 1, X, CX), 0.5)
    w = [_pair(rng, (CX, D), 0.15), _pair(rng, (D,), 0.05), _pair(rng, (CX, D), 0.15),
         _pair(rng, (D,), 0.05), _pair(rng, (Cy, D), 0.15), _pair(rng, (D,), 0.05)]
    xl = np.array(xlen, np.int32)
    j = [y[0], jnp.zeros((1, Y, Cy), jnp.float32) if yp is None else yp[0], x[0],
         jnp.zeros((1, X, CX), jnp.float32) if xp is None else xp[0], *[a[0] for a in w],
         jnp.asarray(xl)]
    t = [y[1], None if yp is None else yp[1], x[1], None if xp is None else xp[1],
         *[a[1] for a in w], torch.from_numpy(xl)]
    return j, t


def _rows(monkeypatch, rows):
    """Tiles of ``rows`` query rows (the card takes 32 or 16 from 264 blocks up)."""
    monkeypatch.setattr(qc, "sx_rows", lambda *shape: rows)


CASES = [  # Y, X, Cy, x_len, y_pos, x_pos, query rows per tile
    (37, 37, 24, [37, 0, 20], "shared", "shared", 8),
    (100, 300, 48, [300, 123], "per_video", "per_video", 32),
    (70, 1, 48, [1, 0], "none", "none", 16),
    (130, 300, 24, [0, 300, 17], "shared", "none", 16),
]


@pytest.mark.parametrize("Y,X,Cy,xlen,y_pos,x_pos,rows", CASES)
def test_emulated_k8b_matches_jax_interpret_and_plain(fake, monkeypatch, Y, X, Cy, xlen, y_pos,
                                                      x_pos, rows):
    """The launches against JAX's ``x2y_attention_q8`` in interpret mode and
    the plain version: attn, probs, logits (the masked logits exactly -1e9;
    a video with x_len = 0 attends uniformly); the quantized rows, their
    scales and yq bit for bit the plain quantizer's and ``_proj_q8``'s."""
    _rows(monkeypatch, rows)
    j, t = _inputs(1, Y, X, Cy, xlen, y_pos, x_pos)
    ref = jqc.x2y_attention_q8(*j, interpret=True)
    qw = tuple(qc.quantize_proj(w) for w in t[4:10:2])
    seen = {}
    got = qc._x2y_sx_q8_card(*t, qw, inspect=seen)
    assert fake.calls == [("sx_prep",), ("pack", 1), ("pack", 1), ("gemm", dc._PROJ32),
                          ("rows_q",), ("q_proj",), ("x2y_sx_attn", rows)]
    plain = qc.x2y_attention_q8_reference(*t, qweights=qw)
    for name, g, r, p in zip(("attn", "probs", "logits"), got, ref, plain):
        _close(g.numpy(), np.asarray(r), what=name)
        _close(g.numpy(), p.numpy(), what=name)
    for b, xl in enumerate(xlen):
        assert (got[2][b, :, xl:].numpy() == -1e9).all()
        if xl == 0:
            np.testing.assert_allclose(got[1][b].numpy(), 1.0 / X, rtol=1e-6)
    yin = add_pos(t[0], t[1])
    q, s = qc._quantize_rows(yin)
    assert torch.equal(seen["qy"][..., :Cy], q) and not seen["qy"][..., Cy:].any()
    assert torch.equal(seen["sy"], s[..., 0])
    assert torch.equal(seen["yq"], qc._proj_q8(yin, qw[2], t[9]))


def test_k8b_weight_pack_any_width(fake, monkeypatch):
    """Wq's int8 pack as the projection reads it: qWq^T (d, Cy) padded with
    zeros to ``k8d_layout(Cy)``'s Kw (128 at Cy = 24), the quantized rows to
    its Cw; at Cy = 512 the pack is qWq^T itself."""
    seen = []
    entry = fake.fk_x2y_sx_q8_fwd

    def spy(*a):
        seen.append((_bytes(a[8], D * a[9]).view(D, a[9]).clone(), a[9], a[22]))
        return entry(*a)

    fake.fk_x2y_sx_q8_fwd = spy
    _rows(monkeypatch, 8)
    _, t = _inputs(4, 37, 40, 24, [40, 9], "shared", "none")
    qw = tuple(qc.quantize_proj(w) for w in t[4:10:2])
    qc._x2y_sx_q8_card(*t, qw)
    pack, Kw, Cw = seen[0]
    assert (Kw, Cw) == (128, 128) and qc.k8d_layout(512) == (512, 512, 512)
    assert torch.equal(pack[:, :24], qw[2].qt) and not pack[:, 24:].any()


def test_emulated_k8b_gives_the_same_bits_twice(fake, monkeypatch):
    """Two runs on the same inputs give the same bits: the int8 sums are
    exact and every f32 sum runs in one order."""
    _rows(monkeypatch, 16)
    _, t = _inputs(5, 100, 40, 48, [40, 0, 7], "shared", "shared")
    qw = tuple(qc.quantize_proj(w) for w in t[4:10:2])
    first = qc._x2y_sx_q8_card(*t, qw)
    second = qc._x2y_sx_q8_card(*t, qw)
    for name, a, b in zip(("attn", "probs", "logits"), first, second):
        assert torch.equal(a, b), name


def test_emulated_k8b_refuses_before_any_launch(monkeypatch):
    """A key-side width the GEMM's 16-byte rows cannot take (Cx, d or the
    key positional table's width not a multiple of 4), X past the small-X
    form's 1024 keys, or an attention block too large for shared memory
    raise NotImplementedError before the library is asked for (meta tensors
    for the card's); any Cy runs."""
    def no_lib():
        raise AssertionError("the kernel library was asked for")

    monkeypatch.setattr(_build, "lib", no_lib)
    meta = lambda *s: torch.empty(s, device="meta")  # noqa: E731
    x_len = torch.empty((2,), dtype=torch.int32, device="meta")

    def args(X, Cy, Cx, d, Px=None):
        qw = tuple(qc.QWeight(torch.empty((d, c), dtype=torch.int8, device="meta"), meta(d))
                   for c in (Cx, Cx, Cy))
        return (meta(2, 37, Cy), None, meta(2, X, Cx), meta(1, X, Px) if Px else None,
                meta(Cx, d), meta(d), meta(Cx, d), meta(d), meta(Cy, d), meta(d), x_len, qw)

    for a in (args(40, 24, 42, 48), args(40, 24, 48, 50), args(40, 24, 48, 48, 22),
              args(1100, 24, 48, 48), args(1024, 24, 48, 4096)):
        with pytest.raises(NotImplementedError):
            qc._x2y_sx_q8_card(*a)
    with pytest.raises(AssertionError, match="library was asked for"):
        qc._x2y_sx_q8_card(*args(40, 21, 48, 48))  # Cy = 21 passes every check
