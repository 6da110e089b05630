"""K4's FFN forward on the port's split kernels, on the CPU.

On the card the FFN sublayer's forward is one library call,
``csrc/sa_layer.cu::fk_ffn_fwd``, into a workspace that the library lays out
and reports (``fk_ffn_fwd_workspace``: the two products' K slices) and the
output: x W1 on the f32 FMA core over (32-row tile, 256-column chunk, K
slice of 128) blocks of the batch's B * M token rows; hk W2 over the same
blocks, hk = relu(z1) * keep_1 staged from the first product's slices + b1;
then y = LN(x + drop_2(hk W2 + b2)) per 16-row tile.  Both keep masks are
the counter hash drawn in the kernels (FFN stream 0 over (B, M, F), stream 1
over (B, M, E)), never stored.  Here, without a card, ``FakeFFNFwdLib``
(``FakeFFNLib`` of the backward's file and the forward's two entries, on the
raw memory of CPU tensors, tile by tile, chunk by chunk and slice by slice)
stands in for the library; the port's call (``_ffn_fwd_card``) is held
against JAX's ``_ffn_fwd_impl`` (the Pallas forward, interpret mode) and
the plain version at (B, M, E) = (3, 11, 256), (1, 300, 256), (2, 200,
256), (8, 40, 256), (4, 60, 512) with F = 512, and E = 42 with F = 84 (the
LayerNorm step's scalar staging), without dropout and with the port's
masks (JAX's kernel handed the same masks in place of its on-core draws).

Tolerance: 2e-5 of max(1, the reference's largest value), as in the
backward's file: f32 products, sums in other orders.
"""

import jax.numpy as jnp
import pytest
import torch
from test_torch_port_k4_ffn_bwd import FakeFFNLib, _close, _inputs, _KeepSpy, _NoSeed
from test_torch_port_k6_tc import FakeK6Lib, _view

from fact_clip_tpu.ops.pallas import sa_layer as jsl
from fact_clip_tpu_torch import _build
from fact_clip_tpu_torch.ops import sa_layer as sl

torch.set_num_threads(2)


class FakeFFNFwdLib(FakeFFNLib):
    """``FakeFFNLib`` and the forward's two entries; ``keeps`` holds the keep
    values each ``fk_ffn_fwd`` call drew (hidden, output)."""

    def __init__(self):
        super().__init__()
        self.keeps = []

    _keep = FakeK6Lib._keep  # the keep values a kernel hashes, from its dropout arguments

    def fk_ffn_fwd_workspace(self, B, M, E, F, out):
        out[0] = self._layout(B, M, E, F, backward=False)[3]
        return 0

    def fk_ffn_fwd(self, x, w1, b1, w2, b2, gamma, beta, ws, y, B, M, E, F, eps, seed_1,
                   stream_1, thresh_1, scale_1, seed_2, stream_2, thresh_2, scale_2, stream):
        self.calls.append(("ffn_fwd",))
        R = B * M
        off, _, _, total = self._layout(B, M, E, F, backward=False)
        WS = _view(ws, total)
        X, Y = (_view(p, R * E).view(R, E) for p in (x, y))
        W1, W2 = _view(w1, E * F).view(E, F), _view(w2, F * E).view(F, E)
        bias1, bias2, gam, bet = _view(b1, F), _view(b2, E), _view(gamma, E), _view(beta, E)
        K1 = self._keep(seed_1, stream_1, thresh_1, scale_1, (B, M, F)).view(R, F)
        K2 = self._keep(seed_2, stream_2, thresh_2, scale_2, (B, M, E)).view(R, E)
        self.keeps.append((K1.view(B, M, F), K2.view(B, M, E)))
        SA, SB = WS[off["sa"]:], WS[off["sb"]:]
        hk = torch.relu(self._sliced(X, W1, SA) + bias1) * K1  # staged by the next product
        t2 = self._sliced(hk, W2, SB)
        for r in self._ln_tiles(R):  # res and its LayerNorm per 16-row tile
            v = (t2[r] + bias2) * K2[r] + X[r]
            mean, rstd = self._ln_stats(v, eps)
            Y[r] = (v - mean) * rstd * gam + bet
        return 0


class _FwdKeepSpy(_KeepSpy):
    """``_KeepSpy`` for the forward kernel, which draws the hidden mask and
    then the output mask in each trace of its body: the masks by call order
    (E may equal F)."""

    calls = 0

    def _pick(self, shape):
        self.calls += 1
        return self.k1 if self.calls % 2 else self.k2


@pytest.fixture
def fake(monkeypatch):
    lib = FakeFFNFwdLib()
    monkeypatch.setattr(_build, "lib", lambda: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    return lib


# (B, M, E, F): the token counts and widths of the zoo's decoders (flagship,
# epic, EgoProceL, Breakfast) and E % 4 != 0 (the LayerNorm's scalar staging)
SHAPES = [(3, 11, 256, 512), (1, 300, 256, 512), (2, 200, 256, 512), (8, 40, 256, 512),
          (4, 60, 512, 512), (2, 37, 42, 84)]


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("B,M,E,F", SHAPES)
def test_emulated_ffn_forward_matches_jax_interpret(fake, monkeypatch, B, M, E, F, rate):
    """The split's output against JAX's Pallas forward in interpret mode and
    the plain version; with dropout 0.2 the keep values the call drew equal
    ``ffn_dropout_masks`` of its seed (the masks the backward regenerates)
    and JAX's kernel and the plain version take them."""
    j, t = _inputs(B * 1000 + M + E, B, M, E, F)
    seed = torch.tensor([9191 + M], dtype=torch.int32)
    got = sl._ffn_fwd_card(*t[:7], sl.LN_EPS, rate, seed if rate else None)
    assert fake.calls == [("ffn_fwd",)]
    k1, k2 = sl.ffn_dropout_masks(seed, B, M, E, F, rate) if rate else (None, None)
    if rate:
        assert torch.equal(fake.keeps[-1][0], k1) and torch.equal(fake.keeps[-1][1], k2)
        spy = _FwdKeepSpy(k1, k2, -(-M // 8) * 8)
        monkeypatch.setattr(jsl, "_keep_mask", spy.keep_mask)
        monkeypatch.setattr(jsl, "pltpu", _NoSeed(jsl.pltpu))
    seed_j = jnp.asarray(seed.numpy()) if rate else None
    ref = jsl._ffn_fwd_impl(*j[:7], seed_j, rate, False, True)
    _close(got, ref, "vs jax")
    _close(got, sl.ffn_sublayer_reference(*t[:7], keep_hidden=k1, keep_out=k2), "vs plain")
    if rate:  # the masks acted
        assert float((got - sl.ffn_sublayer_reference(*t[:7])).abs().max()) > 1e-2

