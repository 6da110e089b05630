"""K4's FFN backward on the port's split kernels, on the CPU.

On the card the FFN sublayer's backward is one library call,
``csrc/sa_layer.cu::fk_ffn_bwd``, into a workspace that the library lays out
and reports (``fk_ffn_bwd_workspace``): W1^T, W2^T, and x with the ones
columns of the weight products' operands by one launch, then its four
products on the f32 FMA core over (32-row tile, 256-column chunk, K slice
of 128) blocks of the batch's B * M token rows, each product's slices added
in order by the step after it: z1 = x W1 + b1 and h * keep_1, as hk W2
stages its A operand; res = x + drop_2(hk W2 + b2), the LayerNorm backward
(its column sums per 16-row tile) and dt2 on whole E rows; dz1 = (dt2 W2^T)
* keep_1 * (z1 > 0), as dz1 W1^T stages it; dx = dz1 W1^T + dres, and the
tiles' column sums added in tile order.  The wrapper takes both weight
gradients and both bias sums from one batched product of the operands
[dz1 | 1], [hk | 1] and [x | 1], [dt2 | 1].  Here, without a card,
``FakeFFNLib`` (a model of both entries on the raw memory of CPU tensors)
runs the split tile by tile, chunk by chunk and slice by slice; the port's
call (``_ffn_bwd_card``) is held against JAX's ``_ffn_bwd`` (the Pallas
backward, interpret mode) and the plain version at (B, M) = (3, 11), (1,
300), (2, 200) and (8, 40), without dropout and with the port's replayed
masks (JAX's kernel handed the same masks in place of its on-core draws).

Tolerance: 2e-5 of max(1, the reference's largest value), as in K4's
forward file: f32 products, sums in other orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_k6_tc import FakeK6Lib, _view

from fact_clip_tpu.ops.pallas import sa_layer as jsl
from fact_clip_tpu_torch import _build
from fact_clip_tpu_torch.ops import sa_layer as sl

torch.set_num_threads(2)
TOL = 2e-5


class FakeFFNLib:
    """The FFN backward's entries: its workspace's layout, and the split
    block by block over the batch's B * M token rows; ``calls`` lists the
    splits run."""

    def __init__(self):
        self.calls = []
        self.bwd_keeps = []  # the keep values of each backward call (hidden, output)

    ROWS, LN_ROWS, CHUNK, SLICE = 32, 16, 256, 128

    def _layout(self, B, M, E, F, backward=True):
        """csrc/sa_layer.cu::ffn_workspace: each region's offset (64-float
        steps), the operands' row strides, the total; the forward's
        workspace holds only the products' K slices sa and sb."""
        R, at, off = B * M, 0, {}
        ldl, ldr = F + 4, E + 4
        regions = [("wt", 2 * E * F), ("res", R * E), ("dx", R * E), ("z1", R * F),
                   ("lhs", 2 * R * ldl), ("rhs", 2 * R * ldr),
                   ("part", -(-R // self.LN_ROWS) * 2 * E), ("dgb", 2 * E)] if backward else []
        for name, n in regions + [("sa", -(-E // self.SLICE) * R * F),
                                  ("sb", -(-F // self.SLICE) * R * E)]:
            off[name] = at
            at += -(-n // 64) * 64
        return off, ldl, ldr, at

    def _sliced(self, A, W, buf):
        """A (R x K) W (K x N) over (32-row tile, K slice of 128, 256-column
        chunk) blocks, each block's partial into its slice of ``buf``; the
        slices summed in order."""
        R, (K, N) = A.shape[0], W.shape

        def chunks(n, w):
            return [slice(c, min(n, c + w)) for c in range(0, n, w)]

        ks = chunks(K, self.SLICE)
        P = buf[:len(ks) * R * N].view(len(ks), R, N)
        for r in chunks(R, self.ROWS):
            for k, kk in enumerate(ks):
                for c in chunks(N, self.CHUNK):
                    P[k, r, c] = A[r, kk] @ W[kk, c]
        out = P[0].clone()
        for k in range(1, len(ks)):
            out += P[k]
        return out

    def _ln_tiles(self, R):
        return [slice(i, min(R, i + self.LN_ROWS)) for i in range(0, R, self.LN_ROWS)]

    @staticmethod
    def _ln_stats(v, eps):
        mean = v.mean(dim=-1, keepdim=True)
        return mean, torch.rsqrt((v - mean).pow(2).mean(dim=-1, keepdim=True) + eps)

    def fk_ffn_bwd_workspace(self, B, M, E, F, out):
        off, ldl, ldr, total = self._layout(B, M, E, F)
        out[:] = [total, off["dx"], off["lhs"], ldl, off["rhs"], ldr, off["dgb"]]
        return 0

    def fk_ffn_bwd(self, x, w1, b1, w2, b2, gamma, keep_1, keep_2, g, ws, B, M, E, F, eps,
                   seed_1, stream_1, thresh_1, scale_1, seed_2, stream_2, thresh_2, scale_2,
                   stream):
        self.calls.append(("ffn_bwd",))
        R = B * M
        off, ldl, ldr, total = self._layout(B, M, E, F)
        WS = _view(ws, total)

        def region(name, *shape):
            n = int(np.prod(shape))
            return WS[off[name]:off[name] + n].view(*shape)

        X, G = (_view(p, R * E).view(R, E) for p in (x, g))
        W1, W2 = _view(w1, E * F).view(E, F), _view(w2, F * E).view(F, E)
        bias1, bias2, gam = _view(b1, F), _view(b2, E), _view(gamma, E)
        # the masks: the replayed tensors, or the forward's hash at its indices
        K1 = (_view(keep_1, R * F).view(R, F).clone() if keep_1
              else FakeK6Lib._keep(self, seed_1, stream_1, thresh_1, scale_1, (B, M, F)).view(R, F))
        K2 = (_view(keep_2, R * E).view(R, E).clone() if keep_2
              else FakeK6Lib._keep(self, seed_2, stream_2, thresh_2, scale_2, (B, M, E)).view(R, E))
        self.bwd_keeps.append((K1.view(B, M, F), K2.view(B, M, E)))
        WT = region("wt", 2 * E * F)
        W1T, W2T = WT[:E * F].view(F, E), WT[E * F:].view(E, F)
        RS, DX, Z = region("res", R, E), region("dx", R, E), region("z1", R, F)
        LHS, RHS = region("lhs", 2, R, ldl), region("rhs", 2, R, ldr)
        DZ, HK, DT2 = LHS[0, :, :F], LHS[1, :, :F], RHS[1, :, :E]
        ln_rows = self._ln_tiles(R)
        PART = region("part", len(ln_rows), 2, E)
        SA = region("sa", -(-E // self.SLICE) * R * F)
        SB = region("sb", -(-F // self.SLICE) * R * E)
        W1T[:], W2T[:] = W1.t(), W2.t()
        RHS[0, :, :E] = X
        LHS[:, :, F] = 1.0
        RHS[:, :, E] = 1.0
        Z[:] = self._sliced(X, W1, SA) + bias1  # z1 and hk, staged by the next product
        HK[:] = torch.relu(Z) * K1
        t2 = self._sliced(HK, W2, SB)
        for i, r in enumerate(ln_rows):  # res, the LayerNorm backward, dt2, the tile's sums
            v = (t2[r] + bias2) * K2[r] + X[r]
            mean, rstd = self._ln_stats(v, eps)
            xhat = (v - mean) * rstd
            gg = G[r] * gam
            PART[i, 0], PART[i, 1] = (G[r] * xhat).sum(dim=0), G[r].sum(dim=0)
            d = rstd * (gg - gg.mean(dim=-1, keepdim=True)
                        - xhat * (gg * xhat).mean(dim=-1, keepdim=True))
            RS[r] = d
            DT2[r] = d * K2[r]
        DZ[:] = torch.where(Z > 0, self._sliced(DT2, W2T, SA) * K1, 0.0)  # dz1, staged likewise
        DX[:] = self._sliced(DZ, W1T, SB) + RS  # dz1 W1^T's slices, + dres
        out = region("dgb", 2, E)  # the tiles' sums in tile order
        out[:] = 0.0
        for i in range(len(ln_rows)):
            out += PART[i]
        return 0


@pytest.fixture
def fake(monkeypatch):
    lib = FakeFFNLib()
    monkeypatch.setattr(_build, "lib", lambda: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    return lib


def _pair(rng, shape, scale=1.0, shift=0.0):
    a = (rng.standard_normal(shape) * scale + shift).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _inputs(seed, B, M, E, F):
    """x, w1, b1, w2, b2, gamma, beta and g: (jax list, torch list).  The
    hidden pre-activations stay away from 0 (|b1| >= 0.6, small x W1), so
    that both sides take every ReLU alike."""
    rng = np.random.default_rng(seed)
    b1 = (np.sign(rng.standard_normal(F)) * rng.uniform(0.6, 1.0, F)).astype(np.float32)
    parts = [_pair(rng, (B, M, E)), _pair(rng, (E, F), 0.02),
             (jnp.asarray(b1), torch.from_numpy(b1)),
             _pair(rng, (F, E), 1.0 / np.sqrt(F)), _pair(rng, (E,), 0.05),
             _pair(rng, (E,), 0.2, 1.0), _pair(rng, (E,), 0.2), _pair(rng, (B, M, E))]
    return [p[0] for p in parts], [p[1] for p in parts]


class _KeepSpy:
    """Stands in for JAX's on-core dropout inside ``sa_layer.py``: each
    ``_keep_mask`` call of the FFN backward kernel returns, through a host
    callback (a Pallas kernel captures no constants), the port's mask of the
    grid cell's video (the hidden mask by its F columns, the output mask by
    its E columns); ``prng_seed`` is left out."""

    def __init__(self, k1, k2, M8):
        pad = lambda k: np.pad(k.numpy(), ((0, 0), (0, M8 - k.shape[1]), (0, 0)))  # noqa: E731
        self.k1, self.k2 = pad(k1), pad(k2)

    def _pick(self, shape):
        return self.k1 if shape[1] == self.k1.shape[2] else self.k2

    def keep_mask(self, rate, shape):
        src = self._pick(shape)
        assert tuple(shape) == src.shape[1:]
        return jax.pure_callback(lambda b: src[int(b)], jax.ShapeDtypeStruct(shape, jnp.float32),
                                 jsl.pl.program_id(0))


class _NoSeed:
    def __init__(self, mod):
        self._mod = mod

    def __getattr__(self, name):
        return getattr(self._mod, name)

    def prng_seed(self, *args):
        pass


def _close(got, ref, what=""):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, what
    scale = max(1.0, float(np.abs(ref).max()))
    assert float(np.abs(got - ref).max()) <= TOL * scale, (what, float(np.abs(got - ref).max()))


# (B, M, E, F): the four token counts, F past one 256-column chunk (E != F)
SHAPES = [(3, 11, 64, 320), (1, 300, 96, 320), (2, 200, 64, 160), (8, 40, 64, 320)]
NAMES = ("dx", "dW1", "db1", "dW2", "db2", "dgamma", "dbeta")


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("B,M,E,F", SHAPES)
def test_emulated_ffn_backward_matches_jax_interpret(fake, monkeypatch, B, M, E, F, rate):
    """The split's dx and every weight and LayerNorm gradient against JAX's
    Pallas backward in interpret mode and the plain version; with dropout
    0.2 all three take the masks ``ffn_dropout_masks`` replays."""
    j, t = _inputs(B * 1000 + M, B, M, E, F)
    seed = torch.tensor([4242 + M], dtype=torch.int32)
    k1, k2 = sl.ffn_dropout_masks(seed, B, M, E, F, rate) if rate else (None, None)
    if rate:
        spy = _KeepSpy(k1, k2, -(-M // 8) * 8)
        monkeypatch.setattr(jsl, "_keep_mask", spy.keep_mask)
        monkeypatch.setattr(jsl, "pltpu", _NoSeed(jsl.pltpu))
    seed_j = jnp.asarray(seed.numpy()) if rate else None
    ref = jsl._ffn_bwd(rate, False, True, (*j[:7], seed_j), j[7])[:7]
    got = sl._ffn_bwd_card(*t[:7], t[7], sl.LN_EPS, k1, k2)
    assert fake.calls == [("ffn_bwd",)]
    plain = sl.ffn_sublayer_bwd_reference(*t, keep_hidden=k1, keep_out=k2)
    for name, a, r, p in zip(NAMES, got, ref, plain):
        _close(a, r, f"{name} vs jax")
        _close(a, p, f"{name} vs plain")
    if rate:  # the masks acted
        nodrop = sl.ffn_sublayer_bwd_reference(*t)
        assert float((got[0] - nodrop[0]).abs().max()) > 1e-2


@pytest.mark.parametrize("B,M,E,F", SHAPES)
def test_emulated_ffn_backward_hashes_the_masks(fake, B, M, E, F):
    """Rate 0.2, the masks hashed from the forward's seed in the kernels: the
    keep values equal ``ffn_dropout_masks`` of the seed bit for bit, and
    every gradient equals, bit for bit, that of the same call fed those
    masks."""
    _, t = _inputs(B * 1000 + M + 1, B, M, E, F)
    seed = torch.tensor([5151 + M], dtype=torch.int32)
    hashed = sl._ffn_bwd_card(*t[:7], t[7], sl.LN_EPS, None, None, seed, 0.2)
    k1, k2 = sl.ffn_dropout_masks(seed, B, M, E, F, 0.2)
    assert torch.equal(fake.bwd_keeps[-1][0], k1) and torch.equal(fake.bwd_keeps[-1][1], k2)
    fed = sl._ffn_bwd_card(*t[:7], t[7], sl.LN_EPS, k1, k2)
    for name, a, b in zip(NAMES, hashed, fed):
        assert torch.equal(a, b), name
    plain = sl.ffn_sublayer_bwd_reference(*t, keep_hidden=k1, keep_out=k2)
    for name, a, p in zip(NAMES, hashed, plain):
        _close(a, p, f"{name} vs plain")


def test_ffn_autograd_backward_hashes_and_makes_no_mask(fake, monkeypatch):
    """``ffn_sublayer``'s autograd backward hands the backward the forward's
    seed and rate and no mask; on the card's launch sequence no mask is made
    (``ffn_dropout_masks`` not called, its launches 0), and the gradients
    equal the plain backward given the replayed masks."""
    B, M, E, F = 2, 11, 64, 160
    _, t = _inputs(17, B, M, E, F)
    x = [a.clone().requires_grad_(True) for a in t[:7]]
    seed = torch.tensor([31337], dtype=torch.int32)
    seen = []

    def card_bwd(*args, eps, keep_hidden=None, keep_out=None, seed=None, rate=0.0):
        seen.append((keep_hidden, keep_out, seed, rate))
        return sl._ffn_bwd_card(*args, eps, keep_hidden, keep_out, seed, rate)

    y = sl.ffn_sublayer(*x, rate=0.2, seed=seed)
    k1, k2 = sl.ffn_dropout_masks(seed, B, M, E, F, 0.2)

    def no_mask(*a, **k):
        raise AssertionError("a mask was made for the backward")

    replay = sl.ffn_dropout_masks
    launches = replay.launches
    monkeypatch.setattr(sl, "ffn_sublayer_bwd", card_bwd)
    monkeypatch.setattr(sl, "ffn_dropout_masks", no_mask)
    y.backward(t[7])
    (keep_hidden, keep_out, seen_seed, rate), = seen
    assert keep_hidden is None and keep_out is None and int(seen_seed[0]) == 31337
    assert rate == 0.2 and replay.launches == launches
    ref = sl.ffn_sublayer_bwd_reference(*t, keep_hidden=k1, keep_out=k2)
    for name, a, r in zip(NAMES, [a.grad for a in x], ref):
        _close(a, r, name)


def test_ffn_backward_refuses_dropout_without_a_seed(monkeypatch):
    """A rate above 0 with neither a seed nor masks raises before the library
    is asked for; masks given need no seed."""
    def no_lib():
        raise AssertionError("the kernel library was asked for")

    monkeypatch.setattr(_build, "lib", no_lib)
    _, t = _inputs(19, 1, 11, 64, 160)
    with pytest.raises(ValueError, match="seed"):
        sl.ffn_sublayer_bwd(*t, rate=0.2)
    k1, k2 = sl.ffn_dropout_masks(torch.tensor([3], dtype=torch.int32), 1, 11, 64, 160, 0.2)
    got = sl.ffn_sublayer_bwd(*t, keep_hidden=k1, keep_out=k2, rate=0.2)
    ref = sl.ffn_sublayer_bwd_reference(*t, keep_hidden=k1, keep_out=k2)
    for name, a, r in zip(NAMES, got, ref):
        assert torch.equal(a, r), name
