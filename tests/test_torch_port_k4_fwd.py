"""K4's SA forward on the port's split kernels, on the CPU.

The SA sublayer's forward on the card is three kernels of
``csrc/sa_layer.cu``, the backward's split: q, k and v per (32-row tile,
video, projection) on the f32 GEMM core (``fk_sa_qkv``), then
``fk_sa_attn_out``: the attention per
(32-query tile, head, video) with the probability dropout hashed inline
(SA stream 0 over (B, H*M, M)), and the out projection, its dropout
(stream 1 over (B, M, E)), the residual and the LayerNorm per 32-row tile.
Here, without a card, ``FakeK4Lib`` (``FakeK6Lib`` of
``test_torch_port_k6_tc.py`` and the two SA entries, on the raw memory of
CPU tensors, reading q, k and v at the strides the wrapper hands them)
stands in for the library; the port's launch sequence (``_sa_fwd_card``)
is held against JAX's ``sa_sublayer`` in interpret mode and the
f32 plain version: M = 11, 40, 200 and 300, B = 1-3, E = 64 (H = 2,
hd = 32) and E = 128 (H = 2 and 4: hd = 64 and 32).  With dropout (B =
1-8) the fake's keep bits are those of
``sa_dropout_masks`` (the mask kernel's replay, which the backward takes),
and the result equals the plain version given those masks.

Tolerance: 2e-5 of max(1, the reference's largest value), as in K3's file.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_k6_tc import FakeK6Lib, _view

from fact_clip_tpu.ops.pallas.sa_layer import sa_sublayer
from fact_clip_tpu_torch import _build
from fact_clip_tpu_torch.ops import sa_layer as sl

torch.set_num_threads(2)
TOL = 2e-5


class FakeK4Lib(FakeK6Lib):
    """``FakeK6Lib`` and the SA forward's two entries; ``keeps`` holds the
    keep values each ``fk_sa_attn_out`` call drew (probabilities, output)."""

    def __init__(self):
        super().__init__()
        self.keeps = []

    def fk_sa_qkv(self, x, pos, Pp, wq, bq, wk, bk, wv, bv, qkv, B, M, E, stream):
        self.calls.append(("sa_qkv",))
        X = _view(x, B * M * E).view(B, M, E)
        a = X.clone()
        if pos is not None:
            a[..., :Pp] += _view(pos, M * Pp).view(1, M, Pp)
        W = [_view(w, E * E).view(E, E) for w in (wq, wk, wv)]
        bias = [_view(v, E) for v in (bq, bk, bv)]
        out = _view(qkv, B * 3 * M * E).view(B, 3, M, E)
        for i, (src, w, bv_) in enumerate(zip((a, a, X), W, bias)):
            out[:, i] = src @ w + bv_
        return 0

    def fk_sa_attn_out(self, qkv, bstride, ld, koff, voff, x, wo, bo, gamma, beta, c, y, B, M,
                       E, H, eps, seed_a, stream_a, thresh_a, scale_a, seed_o, stream_o,
                       thresh_o, scale_o, stream):
        self.calls.append(("sa_attn_out",))
        flat = _view(qkv, B * bstride)
        q, k, v = (torch.as_strided(flat, (B, M, E), (bstride, ld, 1), off)
                   for off in (0, koff, voff))
        hd = E // H
        ka = self._keep(seed_a, stream_a, thresh_a, scale_a, (B, H * M, M))
        ko = self._keep(seed_o, stream_o, thresh_o, scale_o, (B, M, E))
        self.keeps.append((ka, ko))
        s = torch.einsum("bmhd,bnhd->bhmn", q.reshape(B, M, H, hd), k.reshape(B, M, H, hd))
        p = torch.softmax(s / hd ** 0.5, dim=-1) * ka.view(B, H, M, M)
        C = torch.einsum("bhmn,bnhd->bmhd", p, v.reshape(B, M, H, hd)).reshape(B, M, E)
        _view(c, B * M * E).view(B, M, E)[:] = C
        X = _view(x, B * M * E).view(B, M, E)
        o = (C @ _view(wo, E * E).view(E, E) + _view(bo, E)) * ko
        _view(y, B * M * E).view(B, M, E)[:] = torch.nn.functional.layer_norm(
            X + o, (E,), _view(gamma, E), _view(beta, E), eps)
        return 0


@pytest.fixture
def fake(monkeypatch):
    lib = FakeK4Lib()
    monkeypatch.setattr(_build, "lib", lambda: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    return lib


def _pair(rng, shape, scale=1.0, shift=0.0):
    a = (rng.standard_normal(shape) * scale + shift).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _inputs(seed, B, M, E):
    """x, pos (1, M, E) and the ten weights: (jax list, torch list)."""
    rng = np.random.default_rng(seed)
    w = lambda *s: _pair(rng, s, 1.0 / np.sqrt(s[0]))  # noqa: E731
    parts = [_pair(rng, (B, M, E)), _pair(rng, (1, M, E), 0.5), w(E, E), _pair(rng, (E,), 0.05),
             w(E, E), _pair(rng, (E,), 0.05), w(E, E), _pair(rng, (E,), 0.05), w(E, E),
             _pair(rng, (E,), 0.05), _pair(rng, (E,), 0.1, 1.0), _pair(rng, (E,), 0.1)]
    return [p[0] for p in parts], [p[1] for p in parts]


def _close(got, ref, what=""):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, what
    scale = max(1.0, float(np.abs(ref).max()))
    assert float(np.abs(got - ref).max()) <= TOL * scale, (what, float(np.abs(got - ref).max()))


CALLS = [("sa_qkv",), ("sa_attn_out",)]


@pytest.mark.parametrize("B,M,E,H", [(3, 11, 64, 2), (2, 40, 128, 2), (2, 200, 64, 2),
                                     (1, 300, 64, 2), (3, 300, 128, 4)])
def test_emulated_sa_forward_matches_jax_interpret(fake, B, M, E, H):
    """The projections, then the attention and the out projection with the
    LayerNorm, against JAX's ``sa_sublayer`` in interpret mode and the plain
    version."""
    j, t = _inputs(1, B, M, E)
    ref_j = sa_sublayer(*j, num_heads=H, interpret=True)
    got = sl._sa_fwd_card(*t, H, sl.LN_EPS, 0.0, 0.0, None)
    assert fake.calls == CALLS
    _close(got.numpy(), ref_j, "jax")
    _close(got.numpy(), sl.sa_sublayer_reference(*t, num_heads=H).numpy(), "plain")


@pytest.mark.parametrize("B,M", [(3, 11), (1, 300), (2, 200), (8, 40)])
def test_emulated_sa_forward_with_dropout_replays_the_masks(fake, B, M):
    """Rate 0.2 on the probabilities and the output: the keep values the
    forward draws equal ``sa_dropout_masks`` of the same seed (the masks the
    backward regenerates), and the result equals the plain version given
    them; the masks did act."""
    E, H = 64, 2
    _, t = _inputs(2, B, M, E)
    seed = torch.tensor([77777], dtype=torch.int32)
    got = sl._sa_fwd_card(*t, H, sl.LN_EPS, 0.2, 0.2, seed)
    ka, ko = sl.sa_dropout_masks(seed, B, M, E, H, 0.2, 0.2)
    assert torch.equal(fake.keeps[-1][0], ka) and torch.equal(fake.keeps[-1][1], ko)
    ref = sl.sa_sublayer_reference(*t, num_heads=H, keep_attn=ka, keep_out=ko)
    _close(got.numpy(), ref.numpy(), "plain with the masks")
    nodrop = sl.sa_sublayer_reference(*t, num_heads=H)
    assert float((got - nodrop).abs().max()) > 1e-2


@pytest.mark.parametrize("P", [None, 32])
def test_emulated_sa_forward_with_a_narrow_or_no_pos(fake, P):
    """No positional table, or one narrower than E (added to the leading
    channels of the query / key input)."""
    _, t = _inputs(3, 2, 40, 64)
    t[1] = None if P is None else t[1][..., :P].contiguous()
    got = sl._sa_fwd_card(*t, 2, sl.LN_EPS, 0.0, 0.0, None)
    assert fake.calls == CALLS
    _close(got.numpy(), sl.sa_sublayer_reference(*t, num_heads=2).numpy())


def test_sa_forward_limits():
    """The forward's attention block is the backward's context block: up to
    M = 756 at hd = 32 and 40 at E = 512, H = 4 (hd = 128, which the
    backward refuses)."""
    assert sl.has_forward(300, 256, 8) and sl.has_forward(200, 256, 8)
    assert sl.has_forward(756, 256, 8) and not sl.has_forward(757, 256, 8)
    assert sl.has_forward(40, 512, 4) and not sl.has_backward(40, 512, 4)
    for M, E, H in ((40, 256, 8), (300, 256, 8), (60, 512, 8)):
        assert sl.has_forward(M, E, H) or not sl.has_backward(M, E, H)


def test_sa_forward_refuses_before_any_launch(monkeypatch):
    """Off the CPU a token count past the attention block's shared memory
    raises before the library is asked for (meta tensors for the card's)."""
    def no_lib():
        raise AssertionError("the kernel library was asked for")

    monkeypatch.setattr(_build, "lib", no_lib)
    meta = lambda *s: torch.empty(s, device="meta")  # noqa: E731
    E = 256
    weights = [meta(E, E), meta(E), meta(E, E), meta(E), meta(E, E), meta(E), meta(E, E),
               meta(E), meta(E), meta(E)]
    with pytest.raises(NotImplementedError, match="M=800, E=256"):
        sl.sa_sublayer_fwd(meta(1, 800, E), meta(1, 800, E), *weights, num_heads=8)
