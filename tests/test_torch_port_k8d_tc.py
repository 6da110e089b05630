"""K8d's redesign (``csrc/q8_proj.cu`` on ``csrc/tc_int8.cuh``, then K3's attention) on the CPU.

On the card K8d is one library call, ``fk_q8_mha_cross``, of four launches
into one workspace: the frame rows quantized once into q(x + pos) and q(x)
with their scales, the int8 [K | V] projection as one persistent wgmma
launch of two problems into K3's (B, X, 2E) layout, zero at frames past
the attended length, and K3's attention and combine (``fk_k3_attn``) with
the queries pre-scaled.  Here, without a card, ``FakeK8dLib``
(``FakeK3Lib`` of ``test_torch_port_k3_tc.py`` and the new entry on the
raw memory of CPU tensors: the padded rows, the 128-frame items and their
skips, the dequantization in the kernel's order, then K3's attention
model) stands in for the library.  The port's launch sequence
(``_mha_q8_card``) is held against JAX's ``mha_cross_attention_q8`` in
interpret mode and the plain version (tolerance: 2e-5 of max(1, the
reference's largest value), the softmax summed in another order), and its
quantized rows and projection bit-equal to the plain quantizer and
``_proj_q8``.  Cases: H = 8 at hd = 32 and 64, ragged ``x_len`` with a
video of no valid key (it attends to every frame), shared and per-video
positional terms, Cx = 48 (one and a half 32-byte K steps).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_k3_tc import FakeK3Lib
from test_torch_port_k6_tc import _ints, _view
from test_torch_port_k8e_tc import _bytes

from fact_clip_tpu.ops.pallas import quant_conv as jqc
from fact_clip_tpu_torch import _build
from fact_clip_tpu_torch.ops import quant_conv as qc
from fact_clip_tpu_torch.ops.mha_attn import attended_lengths
from fact_clip_tpu_torch.ops.pos import add_pos

torch.set_num_threads(2)
TOL = 2e-5
B, M, X, CX, H = 3, 10, 512, 48, 8  # X two JAX tiles of 256: no padded keys
XLEN = [512, 0, 301]


class FakeK8dLib(FakeK3Lib):
    """``FakeK3Lib`` and K8d's entry: its row quantizer and projection, then
    K3's attention model on the projection."""

    BM = 128  # frames of a projection item

    def fk_q8_mha_cross(self, x, pos, pos_bstride, P, wpack, Kw, swk, bk, swv, bv, q, xlen, B_,
                        X_, Cx, Cw, M_, H_, hd, qx, sx, kv, part_acc, part_ml, out, stream):
        self._rows_kv_proj(x, pos, pos_bstride, P, wpack, Kw, swk, bk, swv, bv, xlen, B_, X_, Cx,
                           Cw, H_ * hd, qx, sx, kv)
        return self.fk_k3_attn(kv, q, xlen, B_, X_, M_, H_, hd, 1.0, part_acc, part_ml, out,
                               None, None, 0, 0, 1.0, stream)

    def _rows_kv_proj(self, x, pos, pos_bstride, P, wpack, Kw, swk, bk, swv, bv, xlen, B_, X_,
                      Cx, Cw, E, qx, sx, kv):
        """``fk::q8_rows_kv_proj`` (csrc/q8_proj.cu): the rows, then [K | V]."""
        kseg = -(-Cx // 32) * 32
        assert Cw >= Cx and Cw % 16 == 0 and Kw >= kseg and E % 2 == 0
        # the rows: q(x + pos) at 0, q(x) at 1, zeros past Cx
        self.calls.append(("rows_kv",))
        xs = _view(x, B_ * X_ * Cx).view(B_, X_, Cx)
        QX = _bytes(qx, 2 * B_ * X_ * Cw).view(2, B_, X_, Cw)
        SX = _view(sx, 2 * B_ * X_).view(2, B_, X_)
        xk = xs.clone()
        if pos is not None:
            Bp = 1 if pos_bstride == 0 else B_
            xk[..., :P] = xs[..., :P] + _view(pos, Bp * X_ * P).view(Bp, X_, P)
        for z, v in enumerate((xk, xs)):
            s = v.abs().amax(dim=-1).clamp_min(1e-12)
            qz = torch.zeros(B_, X_, Cw, dtype=torch.int8)
            qz[..., :Cx] = torch.round(v * qc._div(127.0, s[..., None])).to(torch.int8)
            QX[z], SX[z] = qz, s
        # the projection: per (128 frames, problem, video), zeros past the attended length
        self.calls.append(("kv_proj",))
        WP = _bytes(wpack, 2 * E * Kw).view(2, E, Kw)
        KV = _view(kv, B_ * X_ * 2 * E).view(B_, X_, 2, E)
        sw, bias = (_view(swk, E), _view(swv, E)), (_view(bk, E), _view(bv, E))
        lens = _ints(xlen, B_)
        for b in range(B_):
            lim = min(int(lens[b]), X_) if int(lens[b]) > 0 else X_
            for r0 in range(0, X_, self.BM):
                rows = torch.arange(r0, min(r0 + self.BM, X_))
                for z in range(2):
                    res = torch.zeros(len(rows), E)
                    if r0 < lim:  # else no product
                        a = torch.nn.functional.pad(QX[z, b, rows], (0, max(0, kseg - Cw)))
                        acc = torch.matmul(a[:, :kseg].double(),
                                           WP[z, :, :kseg].double().t()).float()
                        v = ((acc * SX[z, b, rows][:, None]).double() * sw[z].double()
                             + bias[z].double()).float()  # fma(idot * s_row, sw, b)
                        res = torch.where((rows < lim)[:, None], v, 0.0)
                    KV[b, rows, z] = res


@pytest.fixture
def fake(monkeypatch):
    lib = FakeK8dLib()
    monkeypatch.setattr(_build, "lib", lambda: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    return lib


def _inputs(seed, hd, pos):
    rng = np.random.default_rng(seed)
    E = H * hd

    def pair(shape, scale=1.0):
        a = (rng.standard_normal(shape) * scale).astype(np.float32)
        return jnp.asarray(a), torch.from_numpy(a)

    q, x = pair((B, M, E)), pair((B, X, CX))
    p = pair((1 if pos == "shared" else B, X, CX), 0.5)
    wk, bk, wv, bv = pair((CX, E), 0.15), pair((E,), 0.05), pair((CX, E), 0.15), pair((E,), 0.05)
    xl = np.array(XLEN, np.int32)
    args = [q, x, p, wk, bk, wv, bv]
    return ([a[0] for a in args] + [jnp.asarray(xl)], [a[1] for a in args] + [torch.from_numpy(xl)])


def _close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=TOL * max(1.0, float(np.abs(ref).max())), rtol=0)


@pytest.mark.parametrize("pos", ["shared", "per_video"])
@pytest.mark.parametrize("hd", [32, 64])
def test_emulated_k8d_matches_jax_interpret_and_plain(fake, hd, pos):
    """The three launches against JAX's kernel in interpret mode and the plain
    version; the quantized rows and the projection exactly the plain ones."""
    j, t = _inputs(7, hd, pos)
    ref_j = np.asarray(jqc.mha_cross_attention_q8(*j, num_heads=H, tile=256, interpret=True))
    qw = qc.quantize_kv(t[3], t[5])
    seen = {}
    out = qc._mha_q8_card(*t, H, qw, inspect=seen)
    assert fake.calls == [("rows_kv",), ("kv_proj",), ("k3_attn",)]
    _close(out.numpy(), ref_j)
    _close(out.numpy(), qc.mha_cross_q8_reference(*t, num_heads=H, qweights=qw).numpy())
    # the video of no valid key attends to every frame: its output is the mean of V
    q, x, p, wk, bk, wv, bv, xl = t
    v = qc._proj_q8(x, qw.qv, bv)
    _close(out[1].numpy(), v[1].mean(dim=0).expand(M, -1).numpy())
    # the rows and the projection, bit for bit
    xk = add_pos(x, p)
    (kq, ks), (vq, vs) = qc._quantize_rows(xk), qc._quantize_rows(x)
    assert torch.equal(seen["qx"][0, ..., :CX], kq) and torch.equal(seen["qx"][1, ..., :CX], vq)
    assert torch.equal(seen["sx"][0], ks[..., 0]) and torch.equal(seen["sx"][1], vs[..., 0])
    assert not seen["qx"][..., CX:].any()
    att = torch.arange(X)[None, :] < attended_lengths(xl, X)[:, None]
    kv = torch.where(att[..., None], torch.cat([qc._proj_q8(xk, qw.qk, bk), v], -1), 0.0)
    assert torch.equal(seen["kv"], kv)


def test_k8d_weights_pack_any_width():
    """``quantize_kv``'s pack: [qWk^T ; qWv^T] rows K-major, padded past Cx to
    ``k8d_layout``'s Kw."""
    _, t = _inputs(8, 32, "shared")
    qw = qc.quantize_kv(t[3], t[5])
    lay = qc.k8d_layout(CX)
    assert lay == (64, 128, 128) and qc.k8d_layout(512) == (512, 512, 512)
    assert qw.pack.shape == (2 * H * 32, lay.Kw)
    assert torch.equal(qw.pack[:256, :CX], qw.qk.qt) and torch.equal(qw.pack[256:, :CX], qw.qv.qt)
    assert not qw.pack[:, CX:].any()
