"""K5's forward (the fused frame loss's sums) on the port's split kernels, on
the CPU.

On the card the forward is one library call, ``csrc/frame_loss.cu::
fk_frame_loss_fwd``, of two launches: one block per (64-row chunk, video),
each of its 8 warps walking 8 rows (the pair across the end of a warp's rows
recomputes the log-softmax of the next row), the block's (ce, sl) partials
summed over its warps in warp order; then each video's partials added in
chunk order, into one buffer with ce and sl.  Here, without a card,
``FakeK5Lib`` (a model of the entry on the raw memory of CPU tensors, chunk
by chunk and warp by warp) stands in for the library; the port's call
(``_frame_loss_fwd_card``) is held against JAX's ``fused_ce_smooth_sums`` /
``fused_smooth_sum`` (interpret mode) and the plain version: T not a
multiple of the chunk and shorter than one, a video shorter than a chunk, a
video of length 0, C = 75, 40 and 37, without the CE term, and a pair that
straddles a chunk boundary.

Tolerance: 1e-5 of max(1, |sum|): f32 sums in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_k6_tc import _ints, _view

from fact_clip_tpu.ops.pallas.frame_loss import fused_ce_smooth_sums, fused_smooth_sum
from fact_clip_tpu_torch import _build
from fact_clip_tpu_torch.ops import frame_loss as fl

torch.set_num_threads(2)
TOL = 1e-5


class FakeK5Lib:
    """The forward's entry: the (chunk, video) blocks' partials, then the
    per-video sums in chunk order; ``calls`` lists the calls."""

    WARPS, ROWS = 8, 8  # a block's warps, a warp's rows

    def __init__(self):
        self.calls = []

    def fk_frame_loss_fwd_workspace(self, B, T, out):
        out[0] = 2 * B * (1 + max(1, -(-T // (self.WARPS * self.ROWS))))
        return 0

    def fk_frame_loss_fwd(self, x, labels, mk, cw, ws, B, T, C, stream):
        self.calls.append(("frame_loss_fwd",))
        chunk = self.WARPS * self.ROWS
        chunks = max(1, -(-T // chunk))
        out, part = ws, ws + 8 * B  # ce | sl, then the partials
        X = _view(x, B * T * C).view(B, T, C)
        MK = _view(mk, B * T).view(B, T)
        lab = _ints(labels, B * T).view(B, T).long() if labels else None
        w = _view(cw, C) if labels else None
        P = _view(part, B * chunks * 2).view(B, chunks, 2)
        for b in range(B):
            for c in range(chunks):
                block = torch.zeros(2)
                for wp in range(self.WARPS):  # the warps' sums in warp order
                    t_lo = c * chunk + wp * self.ROWS
                    t_hi = min(T, t_lo + self.ROWS)
                    if t_lo >= t_hi:
                        continue
                    # the warp's rows and the next one (the pair across its end)
                    ls = torch.log_softmax(X[b, t_lo:min(T, t_hi + 1)], dim=-1)
                    m = MK[b, t_lo:min(T, t_hi + 1)]
                    ce = torch.zeros(())
                    if lab is not None:
                        li = lab[b, t_lo:t_hi]
                        ce = -(ls[:t_hi - t_lo].gather(1, li[:, None])[:, 0] * w[li]
                               * m[:t_hi - t_lo]).sum()
                    d = (ls[1:] - ls[:-1]).square().clamp(0.0, 16.0)
                    sl = (d.sum(-1) * m[1:] * m[:-1]).sum()
                    block += torch.stack([ce, sl])
                P[b, c] = block
        O = _view(out, 2 * B).view(2, B)
        O[:] = 0.0
        for c in range(chunks):  # each video's partials in chunk order
            O += P[:, c].t()
        return 0


@pytest.fixture
def fake(monkeypatch):
    lib = FakeK5Lib()
    monkeypatch.setattr(_build, "lib", lambda: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    return lib


def _inputs(seed, B, T, C, lengths):
    """Logits piecewise constant in time plus noise (as a model's), labels,
    the frame mask of ``lengths`` and class weights."""
    rng = np.random.default_rng(seed)
    seg = np.arange(T) // 23
    x = (rng.standard_normal((B, T // 23 + 1, C)) * 3.0)[:, seg] \
        + rng.standard_normal((B, T, C)) * 0.3
    labels = rng.integers(0, C, (B, T)).astype(np.int32)
    mask = np.arange(T)[None, :] < np.asarray(lengths)[:, None]
    cw = rng.uniform(0.1, 1.0, C + 3).astype(np.float32)  # >= C entries, as the callers pass
    return x.astype(np.float32), labels, mask, cw


def _close(got, ref, what=""):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, what
    err = float(np.abs(got - ref).max())
    assert err <= TOL * max(1.0, float(np.abs(ref).max())), (what, err)


def _card(x, labels, mask, cw, C):
    t = torch.from_numpy
    return fl._frame_loss_fwd_card(t(x), t(labels) if labels is not None else None,
                                   t(mask.astype(np.float32)),
                                   t(cw[:C]) if labels is not None else None)


# (B, T, C, lengths): T not a multiple of the 64-row chunk with a video of
# length 0 and one shorter than a chunk; T shorter than one chunk; one chunk
# exactly; the classes of the flagship (75), Breakfast / the TDU (40) and a
# ragged 37
CASES = [(3, 1000, 75, [1000, 0, 50]), (2, 37, 40, [37, 20]), (1, 64, 75, [64]),
         (2, 700, 37, [700, 513]), (2, 129, 40, [129, 65])]


@pytest.mark.parametrize("B,T,C,lengths", CASES)
def test_emulated_k5_forward_matches_jax_interpret(fake, B, T, C, lengths):
    """ce and sl per video against JAX's ``fused_ce_smooth_sums`` in interpret
    mode and the plain version."""
    x, labels, mask, cw = _inputs(B * 100 + T, B, T, C, lengths)
    ce, sl = _card(x, labels, mask, cw, C)
    assert fake.calls == [("frame_loss_fwd",)]
    ref_ce, ref_sl = fused_ce_smooth_sums(jnp.asarray(x), jnp.asarray(labels),
                                          jnp.asarray(mask), jnp.asarray(cw), interpret=True)
    t = torch.from_numpy
    plain_ce, plain_sl = fl.frame_loss_reference(t(x), t(labels), t(mask.astype(np.float32)),
                                                 t(cw[:C]))
    for name, got, ref, plain in (("ce", ce, ref_ce, plain_ce), ("sl", sl, ref_sl, plain_sl)):
        _close(got, ref, f"{name} vs jax")
        _close(got, plain, f"{name} vs plain")
    if 0 in lengths:  # a video of no valid frame sums to 0
        i = lengths.index(0)
        assert float(ce[i]) == 0.0 and float(sl[i]) == 0.0


@pytest.mark.parametrize("B,T,C,lengths", [(2, 1000, 40, [1000, 777]), (2, 37, 75, [37, 0])])
def test_emulated_k5_forward_without_ce(fake, B, T, C, lengths):
    """``with_ce`` off (the smoothing sum alone, no labels or weights):
    against JAX's ``fused_smooth_sum`` in interpret mode and the plain
    version; the call returns no CE sum."""
    x, _, mask, _ = _inputs(B * 7 + T, B, T, C, lengths)
    ce, sl = _card(x, None, mask, None, C)
    assert ce is None and fake.calls == [("frame_loss_fwd",)]
    ref = fused_smooth_sum(jnp.asarray(x), jnp.asarray(mask), interpret=True)
    _close(sl, ref, "vs jax")
    _close(sl, fl.frame_loss_reference(torch.from_numpy(x), None,
                                       torch.from_numpy(mask.astype(np.float32)), None)[1],
           "vs plain")


@pytest.mark.parametrize("t", [7, 63, 127])
def test_emulated_k5_forward_counts_the_pair_across_a_boundary(fake, t):
    """Logits constant in time but for one step between rows t and t + 1: at
    the end of a warp's rows (7), of a chunk (63) and of the second chunk
    (127).  The smoothing sum is that one pair's, clipped at 16 per class,
    as in JAX and the plain version."""
    B, T, C = 1, 200, 40
    rng = np.random.default_rng(t)
    row = rng.standard_normal(C).astype(np.float32)
    x = np.tile(row, (B, T, 1))
    x[:, t + 1:] += rng.standard_normal(C).astype(np.float32) * 5.0
    mask = np.ones((B, T), bool)
    _, sl = _card(x, None, mask, None, C)
    ls = torch.log_softmax(torch.from_numpy(x[0, t:t + 2]), dim=-1)
    pair = float((ls[1] - ls[0]).square().clamp(0.0, 16.0).sum())
    assert pair > 1.0
    _close(sl, [pair], "the one pair")
    _close(sl, fused_smooth_sum(jnp.asarray(x), jnp.asarray(mask), interpret=True), "vs jax")
