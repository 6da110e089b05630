"""K8c's redesign, K8d's int8 projection feeding K2's flash attention, on the CPU.

On the card K8c is one library call, ``fk_x2y_flash_q8_fwd``
(``csrc/flash_attn.cu``), of four launches into one workspace: the frame
rows quantized once into q(x + x_pos) and q(x) with their absmax scales
(zeros past Cx up to ``k8d_layout``'s Cw), [xk | xv] = fma(idot(q(.), qW) *
s_row, sw, b) as one persistent int8 wgmma launch of two problems, zero at
frames past the attended length (``csrc/q8_proj.cu``'s
``fk::q8_rows_kv_proj``, K8d's pair at one head), then the logits, softmax
partials and attend per (group of <= 32 query rows, 64-key tile, video) in
f32 and the fixed-order combine, which writes attn and probs.  The q
projection stays an f32 matmul outside, as in JAX.  Here, without a card,
``FakeK8cLib`` (``FakeK8dLib``'s rows and projection and
``FakeK2FlashLib``'s attention and combine, launch for launch on the raw
memory of CPU tensors) stands in for the library.  The port's launch
sequence (``_x2y_flash_q8_card``) is held against JAX's
``quant_conv.py::x2y_attention_q8`` in interpret mode (its flash form, X >
1024) and the plain version; its quantized rows, their scales and [xk | xv]
are bit-equal to the plain quantizer and ``_proj_q8``.  Cases: X = 1100,
2000 and 2048, M = 11, 40 and 60 (query groups of 12, 20 and 32 rows),
ragged x_len and x_len = 0, no, shared and per-video positional tables, Cx =
40 (no multiple of 16: the parent refused it) and 48, d = 48.  JAX's kernel
also weighs its zero-padded key rows at x_len = 0 where X is not a multiple
of its key tile (min(512, ceil128(X)): 1100 pads to 1536): that case is held
against the plain version only.

Tolerance: 2e-5 of max(1, the reference's largest value), as the K8b and
K8d files: f32 sums in another order; the integer parts exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_k2_flash_fwd import FakeK2FlashLib
from test_torch_port_k2_sx import _close
from test_torch_port_k8d_tc import FakeK8dLib

from fact_clip_tpu.ops.pallas import quant_conv as jqc
from fact_clip_tpu_torch import _build
from fact_clip_tpu_torch.models.layers import X2YMap
from fact_clip_tpu_torch.ops import quant_conv as qc
from fact_clip_tpu_torch.ops import x2y_attn as xa
from fact_clip_tpu_torch.ops.mha_attn import attended_lengths
from fact_clip_tpu_torch.ops.pos import add_pos

torch.set_num_threads(2)
CY = D = 48


class FakeK8cLib(FakeK8dLib):
    """``FakeK8dLib`` (K8d's rows and [K | V] projection over 128-frame
    items) and K8c's entry: those two launches at one head, then
    ``FakeK2FlashLib``'s partials per (query group, 64-key tile, video) and
    its combine in tile order."""

    _flash_attend = FakeK2FlashLib._flash_attend

    def fk_x2y_flash_q8_fwd(self, x, xpos, xstride, Px, wpack, Kw, swk, bk, swv, bv, yq, xlen, B,
                            X_, Cx, Cw, M, d, scale, qx, sx, kv, part_acc, part_ml, logits, probs,
                            attn, rows, stream):
        assert d % 4 == 0 and rows % 4 == 0 and 4 <= rows <= xa.FLASH_ROW_GROUP
        self._rows_kv_proj(x, xpos, xstride, Px, wpack, Kw, swk, bk, swv, bv, xlen, B, X_, Cx, Cw,
                           d, qx, sx, kv)
        return self._flash_attend(yq, kv, xlen, B, X_, M, d, scale, part_acc, part_ml, logits,
                                  probs, attn, rows)


@pytest.fixture
def fake(monkeypatch):
    lib = FakeK8cLib()
    monkeypatch.setattr(_build, "lib", lambda: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    return lib


def _pair(rng, shape, scale=1.0):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _inputs(seed, M, X, Cx, xlen, y_pos, x_pos):
    """(jax list, torch list) of x2y_attention_q8's arguments: y (B, M, CY)
    with y_pos "none" (JAX: zeros), "shared" or "per_video", x (B, X, Cx)
    with x_pos the same way."""
    rng = np.random.default_rng(seed)
    B = len(xlen)
    y, x = _pair(rng, (B, M, CY)), _pair(rng, (B, X, Cx))
    yp = None if y_pos == "none" else _pair(rng, (B if y_pos == "per_video" else 1, M, CY), 0.5)
    xp = None if x_pos == "none" else _pair(rng, (B if x_pos == "per_video" else 1, X, Cx), 0.5)
    w = [_pair(rng, (Cx, D), 0.15), _pair(rng, (D,), 0.05), _pair(rng, (Cx, D), 0.15),
         _pair(rng, (D,), 0.05), _pair(rng, (CY, D), 0.15), _pair(rng, (D,), 0.05)]
    xl = np.array(xlen, np.int32)
    j = [y[0], jnp.zeros((1, M, CY), jnp.float32) if yp is None else yp[0], x[0],
         jnp.zeros((1, X, Cx), jnp.float32) if xp is None else xp[0], *[a[0] for a in w],
         jnp.asarray(xl)]
    t = [y[1], None if yp is None else yp[1], x[1], None if xp is None else xp[1],
         *[a[1] for a in w], torch.from_numpy(xl)]
    return j, t


def _calls(rows):
    return [("rows_kv",), ("kv_proj",), ("x2y_flash_attn", rows), ("combine",)]


def _integer_parts_equal(seen, t, qw):
    """The rows, their scales, the zeros past Cx and [xk | xv] (zeros past
    the attended length) bit for bit the plain quantizer's and ``_proj_q8``'s."""
    x, xp, bk, bv, xl = t[2], t[3], t[5], t[7], t[10]
    X, Cx = x.shape[1:]
    xk = add_pos(x, xp)
    (kq, ks), (vq, vs) = qc._quantize_rows(xk), qc._quantize_rows(x)
    qx, sx = seen["qx"], seen["sx"]
    assert torch.equal(qx[0, ..., :Cx], kq) and torch.equal(qx[1, ..., :Cx], vq)
    assert torch.equal(sx[0], ks[..., 0]) and torch.equal(sx[1], vs[..., 0])
    assert not qx[..., Cx:].any()
    att = torch.arange(X)[None, :] < attended_lengths(xl, X)[:, None]
    kv = torch.cat([qc._proj_q8(xk, qw.qk, bk), qc._proj_q8(x, qw.qv, bv)], -1)
    assert torch.equal(seen["kv"], torch.where(att[..., None], kv, 0.0))


CASES = [  # M, X, Cx, x_len, y_pos, x_pos, JAX's kernel comparable
    (11, 1100, 40, [1100, 517, 1], "shared", "shared", True),
    (40, 2000, 48, [2000, 1500], "per_video", "per_video", True),
    (60, 1100, 40, [0, 1000], "none", "none", False),
    (40, 2048, 40, [2048, 0, 64], "shared", "per_video", True),
]


@pytest.mark.parametrize("M,X,Cx,xlen,y_pos,x_pos,jax_ok", CASES)
def test_emulated_k8c_matches_jax_interpret_and_plain(fake, M, X, Cx, xlen, y_pos, x_pos,
                                                      jax_ok):
    """The launches against JAX's ``x2y_attention_q8`` in interpret mode and
    the plain version: attn, probs, logits (the masked logits exactly -1e9; a
    video with x_len = 0 attends uniformly to every frame); the integer parts
    bit for bit."""
    j, t = _inputs(1, M, X, Cx, xlen, y_pos, x_pos)
    qw = qc.quantize_x2y(t[4], t[6], t[8])
    seen = {}
    got = qc._x2y_flash_q8_card(*t, qw, inspect=seen)
    assert fake.calls == _calls(xa.flash_rows(M))
    plain = qc.x2y_attention_q8_reference(*t, qweights=qw)
    ref = jqc.x2y_attention_q8(*j, interpret=True) if jax_ok else plain
    for name, g, r, p in zip(("attn", "probs", "logits"), got, ref, plain):
        _close(g.numpy(), np.asarray(r), what=name)
        _close(g.numpy(), p.numpy(), what=name)
    for b, xl in enumerate(xlen):
        assert (got[2][b, :, xl:].numpy() == -1e9).all()
        if xl == 0:
            np.testing.assert_allclose(got[1][b].numpy(), 1.0 / X, rtol=1e-6)
    _integer_parts_equal(seen, t, qw)


def test_emulated_k8c_gives_the_same_bits_twice(fake):
    """The int8 sums are exact, the partials sum each tile's keys in one
    order and the combine the tiles in tile order: two runs on the same
    inputs give the same bits."""
    _, t = _inputs(3, 60, 2048, 40, [2048, 1500, 0], "shared", "shared")
    qw = qc.quantize_x2y(t[4], t[6], t[8])
    first = qc._x2y_flash_q8_card(*t, qw)
    second = qc._x2y_flash_q8_card(*t, qw)
    for name, a, b in zip(("attn", "probs", "logits"), first, second):
        assert torch.equal(a, b), name


def test_k8c_pack_and_weights_made_in_the_call(fake):
    """``quantize_x2y``'s pack (the X2Y layer's cache): [qWk^T ; qWv^T] K-major,
    zeros past Cx up to ``k8d_layout(Cx)``'s Kw (128 at Cx = 40); without
    weights the call makes the same ones, and the same bits come out."""
    _, t = _inputs(4, 11, 1100, 40, [1100, 700], "shared", "none")
    qw = qc.quantize_x2y(t[4], t[6], t[8])
    assert qw.kvpack.shape == (2 * D, 128) and qc.k8d_layout(40) == (64, 128, 128)
    assert torch.equal(qw.kvpack[:D, :40], qw.qk.qt) and torch.equal(qw.kvpack[D:, :40], qw.qv.qt)
    assert not qw.kvpack[:, 40:].any()
    cached = qc._x2y_flash_q8_card(*t, qw)
    made = qc._x2y_flash_q8_card(*t)
    for a, b in zip(cached, made):
        assert torch.equal(a, b)


def test_x2y_layer_caches_quantize_x2y():
    """The X2Y layer in int8 evaluation makes its weights once
    (``quantize_x2y``, pack included) and serves from that cache; its output
    is the plain version's on the same weights."""
    torch.manual_seed(0)
    layer = X2YMap(40, CY, 32, D, quantize="int8").eval()
    x, y = torch.randn(2, 1100, 40), torch.randn(2, 11, CY)
    x_len = torch.tensor([1100, 600], dtype=torch.int32)
    with torch.no_grad():
        first = layer(x, y, x_len=x_len)
        cached = layer.cached("q8", lambda: None)
        second = layer(x, y, x_len=x_len)
    assert isinstance(cached, qc.QX2Y) and cached.kvpack.shape == (2 * D, 128)
    assert layer.cached("q8", lambda: None) is cached
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    lay = layer.layout()
    plain = qc.x2y_attention_q8_reference(y, None, x, None, *lay, x_len, cached)
    assert torch.equal(first[1], plain[1])


def test_emulated_k8c_refuses_before_any_launch(monkeypatch):
    """d not a multiple of 4 (the attention's 16-byte rows) raises
    NotImplementedError, a gradient NotImplementedError, inconsistent shapes,
    a wrong x_len or a pack not in ``k8d_layout(Cx)`` ValueError, all before
    the library is asked for (meta tensors for the card's); any Cx runs."""
    def no_lib():
        raise AssertionError("the kernel library was asked for")

    monkeypatch.setattr(_build, "lib", no_lib)
    meta = lambda *s: torch.empty(s, device="meta")  # noqa: E731
    x_len = torch.empty((2,), dtype=torch.int32, device="meta")

    def args(Cx, d, xl=x_len, pack_rows=None):
        q8 = lambda c: qc.QWeight(torch.empty((d, c), dtype=torch.int8, device="meta"),  # noqa
                                  meta(d))
        pack = torch.empty((pack_rows or 2 * d, qc.k8d_layout(Cx).Kw), dtype=torch.int8,
                           device="meta")
        return (meta(2, 40, CY), None, meta(2, 1100, Cx), None, meta(Cx, d), meta(d),
                meta(Cx, d), meta(d), meta(CY, d), meta(d), xl,
                qc.QX2Y(q8(Cx), q8(Cx), q8(CY), pack))

    with pytest.raises(NotImplementedError, match="d=50"):
        qc._x2y_flash_q8_card(*args(48, 50))
    for a in (args(48, 48, torch.empty((3,), dtype=torch.int32, device="meta")),
              args(48, 48, pack_rows=48)):
        with pytest.raises(ValueError):
            qc._x2y_flash_q8_card(*a)
    bad = list(args(48, 48))
    bad[4] = meta(40, 48)
    with pytest.raises(ValueError, match="inconsistent shapes"):
        qc._x2y_flash_q8_card(*bad)
    grad = list(args(48, 48))
    grad[2] = torch.empty((2, 1100, 48), requires_grad=True)
    with pytest.raises(NotImplementedError, match="gradients"):
        qc._x2y_flash_q8_card(*grad)
    with pytest.raises(AssertionError, match="library was asked for"):
        qc._x2y_flash_q8_card(*args(21, 48))  # Cx = 21 passes every check
