"""K5's backward (the fused frame loss's dlogits) on the port's kernel, on
the CPU.

On the card the backward is one library call, ``csrc/frame_loss.cu::
fk_frame_loss_bwd``, of one launch: one block per (64-row chunk, video)
stages the chunk's rows and one row on each side in shared memory, takes
each staged row's log-softmax once (max, then the log of the sum of
exponentials, as the kernel computes it), and writes each of the chunk's
rows of dx from the rows above and below it.  Here, without a card,
``FakeK5BwdLib`` (a model of that entry on the raw memory of CPU tensors,
chunk by chunk) stands in for the library; the port's call
(``_frame_loss_bwd_card``) is held against ``jax.vjp`` of JAX's
``fused_ce_smooth_sums`` / ``fused_smooth_sum`` (interpret mode) and the
plain version: T not a multiple of the chunk and shorter than one, a video
of length 0 and one shorter than a chunk, C = 75, 40 and 37, without the
CE term, a pair that straddles a chunk boundary, and squared differences
either side of the clip at 16.

Tolerance: 1e-5 of max(1, |dx|): f32 sums in another order.
"""

import jax
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


class FakeK5BwdLib:
    """The backward's entry, block by block: the staged rows' log-softmax,
    then each chunk row's dx from its neighbours; ``calls`` lists the calls
    and ``blocks`` the (video, first row, staged rows) of each block."""

    CHUNK = 64  # rows of a block (csrc/frame_loss.cu BWD_CHUNK)

    def __init__(self):
        self.calls, self.blocks = [], []

    def fk_frame_loss_bwd(self, x, labels, mk, cw, gce, gsl, dx, B, T, C, stream):
        self.calls.append(("frame_loss_bwd",))
        X = _view(x, B * T * C).view(B, T, C)
        D = _view(dx, B * T * C).view(B, T, C)
        MK = _view(mk, B * T).view(B, T)
        lab = _ints(labels, B * T).view(B, T).long() if labels else None
        w = _view(cw, C) if labels else None
        g_ce = _view(gce, B) if gce else torch.zeros(B)
        g2 = 2.0 * _view(gsl, B)
        for b in range(B):
            for t0 in range(0, T, self.CHUNK):
                t1 = min(T, t0 + self.CHUNK)
                r_lo, r_hi = max(0, t0 - 1), min(T, t1 + 1)
                self.blocks.append((b, t0, r_hi - r_lo))
                rows = X[b, r_lo:r_hi]
                mx = rows.max(-1, keepdim=True).values
                ls = rows - (mx + torch.log(torch.exp(rows - mx).sum(-1, keepdim=True)))
                m = MK[b, r_lo:r_hi]
                t = torch.arange(t0, t1)
                r = t - r_lo
                cur = ls[r]
                has_in, has_out = (t > 0)[:, None], (t + 1 < T)[:, None]
                ri, ro = (r - 1).clamp(min=0), (r + 1).clamp(max=r_hi - r_lo - 1)
                pm_in = torch.where(has_in, (m[r] * m[ri])[:, None], 0.0)
                pm_out = torch.where(has_out, (m[r] * m[ro])[:, None], 0.0)
                d_in, d_out = cur - ls[ri], ls[ro] - cur
                gi = torch.where(has_in & (d_in * d_in <= 16.0), g2[b] * d_in * pm_in, 0.0)
                go = torch.where(has_out & (d_out * d_out <= 16.0), g2[b] * d_out * pm_out, 0.0)
                dls = gi - go
                if lab is not None:
                    li = lab[b, t0:t1]
                    onehot = li[:, None] == torch.arange(C)
                    dls = dls - torch.where(onehot, (g_ce[b] * w[li] * m[r])[:, None], 0.0)
                D[b, t0:t1] = dls - torch.exp(cur) * dls.sum(-1, keepdim=True)
        return 0


@pytest.fixture
def fake(monkeypatch):
    lib = FakeK5BwdLib()
    monkeypatch.setattr(_build, "lib", lambda: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    return lib


def _inputs(seed, B, T, C, lengths):
    """Logits piecewise constant in time plus noise (as a model's), labels,
    the frame mask of ``lengths``, class weights (>= C entries, as the
    callers pass) and the per-video cotangents."""
    rng = np.random.default_rng(seed)
    seg = np.arange(T) // 23
    x = (rng.standard_normal((B, T // 23 + 1, C)) * 3.0)[:, seg] \
        + rng.standard_normal((B, T, C)) * 0.3
    labels = rng.integers(0, C, (B, T)).astype(np.int32)
    mask = np.arange(T)[None, :] < np.asarray(lengths)[:, None]
    cw = rng.uniform(0.1, 1.0, C + 3).astype(np.float32)
    g = rng.standard_normal((2, B)).astype(np.float32)
    return x.astype(np.float32), labels, mask, cw, g[0], g[1]


def _close(got, ref, what=""):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, what
    err = float(np.abs(got - ref).max())
    assert err <= TOL * max(1.0, float(np.abs(ref).max())), (what, err)


def _card(x, labels, mask, cw, gce, gsl, C):
    t = torch.from_numpy
    with_ce = labels is not None
    return fl._frame_loss_bwd_card(t(x), t(labels) if with_ce else None,
                                   t(mask.astype(np.float32)), t(cw[:C]) if with_ce else None,
                                   t(gce) if with_ce else None, t(gsl))


def _plain(x, labels, mask, cw, gce, gsl, C):
    t = torch.from_numpy
    with_ce = labels is not None
    return fl.frame_loss_bwd_reference(t(x), t(labels) if with_ce else None,
                                       t(mask.astype(np.float32)),
                                       t(cw[:C]) if with_ce else None,
                                       t(gce) if with_ce else None, t(gsl))


def _jax_dx(x, labels, mask, cw, gce, gsl):
    if labels is None:
        _, vjp = jax.vjp(lambda a: fused_smooth_sum(a, jnp.asarray(mask), interpret=True),
                         jnp.asarray(x))
        return vjp(jnp.asarray(gsl))[0]
    _, vjp = jax.vjp(lambda a: fused_ce_smooth_sums(a, jnp.asarray(labels), jnp.asarray(mask),
                                                    jnp.asarray(cw), interpret=True),
                     jnp.asarray(x))
    return vjp((jnp.asarray(gce), jnp.asarray(gsl)))[0]


# (B, T, C, lengths): T not a multiple of the 64-row chunk with a video of
# length 0 and one shorter than a chunk; T shorter than one chunk; one chunk
# exactly; the classes of the flagship (75), Breakfast / the TDU (40) and a
# ragged 37
CASES = [(3, 1000, 75, [1000, 0, 50]), (2, 37, 40, [37, 20]), (1, 64, 75, [64]),
         (2, 700, 37, [700, 513]), (2, 129, 40, [129, 65]), (1, 1, 75, [1])]


@pytest.mark.parametrize("B,T,C,lengths", CASES)
def test_emulated_k5_backward_matches_jax_interpret(fake, B, T, C, lengths):
    """dx against ``jax.vjp`` of ``fused_ce_smooth_sums`` in interpret mode
    and the plain backward; every (64-row chunk, video) block once, each
    staging its rows and one on each side."""
    x, labels, mask, cw, gce, gsl = _inputs(B * 100 + T, B, T, C, lengths)
    dx = _card(x, labels, mask, cw, gce, gsl, C)
    assert fake.calls == [("frame_loss_bwd",)]
    chunks = -(-T // FakeK5BwdLib.CHUNK)
    assert len(fake.blocks) == B * chunks
    assert all(n == min(T, t0 + 65) - max(0, t0 - 1) for _, t0, n in fake.blocks)
    _close(dx, _jax_dx(x, labels, mask, cw, gce, gsl), "vs jax")
    _close(dx, _plain(x, labels, mask, cw, gce, gsl, C), "vs plain")
    if 0 in lengths:  # a video of no valid frame has no gradient
        assert float(dx[lengths.index(0)].abs().max()) == 0.0


@pytest.mark.parametrize("B,T,C,lengths", [(2, 1000, 40, [1000, 777]), (2, 37, 75, [37, 0])])
def test_emulated_k5_backward_without_ce(fake, B, T, C, lengths):
    """``with_ce`` off (the smoothing sum alone: no labels, weights or CE
    cotangent): against ``jax.vjp`` of ``fused_smooth_sum`` in interpret
    mode and the plain backward."""
    x, _, mask, _, _, gsl = _inputs(B * 7 + T, B, T, C, lengths)
    dx = _card(x, None, mask, None, None, gsl, C)
    assert fake.calls == [("frame_loss_bwd",)]
    _close(dx, _jax_dx(x, None, mask, None, None, gsl), "vs jax")
    _close(dx, _plain(x, None, mask, None, None, gsl, C), "vs plain")


@pytest.mark.parametrize("t", [62, 63, 64, 127])
def test_emulated_k5_backward_pair_across_a_chunk_boundary(fake, t):
    """Logits constant in time but for one step between rows t and t + 1: at
    a chunk's last row (63, 127), its first (64) and the row before its last
    (62).  Only rows t and t + 1 get a gradient, +-2 gsl diff less the
    softmax share, as in JAX and the plain backward."""
    B, T, C = 1, 200, 40
    rng = np.random.default_rng(t)
    row = rng.standard_normal(C).astype(np.float32)
    x = np.tile(row, (B, T, 1))
    x[:, t + 1:] += rng.standard_normal(C).astype(np.float32)
    mask = np.ones((B, T), bool)
    gsl = np.array([0.7], np.float32)
    dx = _card(x, None, mask, None, None, gsl, C)
    rows = np.nonzero(np.abs(dx[0].numpy()).max(-1) > 0)[0]
    np.testing.assert_array_equal(rows, [t, t + 1])
    _close(dx, _jax_dx(x, None, mask, None, None, gsl), "vs jax")
    _close(dx, _plain(x, None, mask, None, None, gsl, C), "vs plain")


@pytest.mark.parametrize("C", [75, 37])
def test_emulated_k5_backward_either_side_of_the_clip(fake, C):
    """Consecutive rows whose log-softmax differs by 3.9-4.1 in some classes:
    squared differences either side of the clip at 16 (a gradient of 2 gsl
    diff below it, none above), each at least 0.05 from it, so that no
    rounding decides the side.  dx against JAX and the plain backward."""
    B, T = 2, 150
    rng = np.random.default_rng(C)
    x = np.zeros((B, T, C), np.float32)
    x[:, :, :] = rng.standard_normal((B, 1, C)).astype(np.float32)
    steps = rng.uniform(3.9, 4.1, (B, T // 2, C)).astype(np.float32) * rng.choice([-1, 1], C)
    x[:, 1::2] += steps  # odd rows step away from the even rows around them
    ls = torch.log_softmax(torch.from_numpy(x), -1).numpy()
    d2 = (ls[:, 1:] - ls[:, :-1]) ** 2
    assert (d2 < 15.95).any() and (d2 > 16.05).any()
    assert not ((d2 > 15.95) & (d2 < 16.05)).any()
    labels = rng.integers(0, C, (B, T)).astype(np.int32)
    mask = np.arange(T)[None, :] < np.array([[T], [101]])
    cw = rng.uniform(0.1, 1.0, C).astype(np.float32)
    gce, gsl = np.array([0.3, -1.1], np.float32), np.array([0.9, 0.4], np.float32)
    dx = _card(x, labels, mask, cw, gce, gsl, C)
    _close(dx, _jax_dx(x, labels, mask, cw, gce, gsl), "vs jax")
    _close(dx, _plain(x, labels, mask, cw, gce, gsl, C), "vs plain")


def test_k5_backward_wrapper_counts_only_card_launches(fake):
    """On CPU tensors the wrapper runs the plain backward and counts no
    launch; the card function holds the same checks as the forward's."""
    x, labels, mask, cw, gce, gsl = _inputs(3, 2, 70, 40, [70, 31])
    t = torch.from_numpy
    before = fl.frame_loss_bwd.launches
    dx = fl.frame_loss_bwd(t(x), t(labels), t(mask.astype(np.float32)), t(cw[:40]), t(gce),
                           t(gsl))
    assert fl.frame_loss_bwd.launches == before and fake.calls == []
    _close(dx, _plain(x, labels, mask, cw, gce, gsl, 40))
    with pytest.raises(ValueError, match="int32"):
        fl._frame_loss_bwd_card(t(x), t(labels.astype(np.int64)), t(mask.astype(np.float32)),
                                t(cw[:40]), t(gce), t(gsl))
    assert fake.calls == []
