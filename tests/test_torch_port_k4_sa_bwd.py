"""K4's SA backward with its dropout masks hashed in the kernels, on the CPU.

On the card the SA backward is one library call, ``fk_sa_bwd``
(``csrc/sa_layer.cu``), of six kernels: q, k and v; each query row's
softmax and the context c = (P * keep_a) v; the out projection, the
residual x + drop_o(c Wo + bo), its LayerNorm backward and dout = dres *
keep_o, dc = dout Wo^T; dq; dk and dv; dx.  The two keep masks are the
forward's: each kernel hashes the keep value of the element it reads at the
forward's index (SA stream 0 over (B, H*M, M), row (b H + h) M + m, column
j; stream 1 over (B, M, E), the flat index), or reads a replayed mask where
one is given.  The weight products and the fixed-order sums follow
(``csrc/grad.cu``).  Here, without a card, ``FakeK4BwdLib``
(``FakeK4Lib`` of ``test_torch_port_k4_fwd.py``, the backward's entry and
``fk_atb`` on the raw memory of CPU tensors, the keep values hashed with the
forward's hash, ``FakeK6Lib._keep``) stands in for the library.  The port's
launch sequence (``_sa_bwd_card``) with the masks hashed is held against
``sa_sublayer_bwd_reference`` given ``sa_dropout_masks`` of the same seed,
its keep values against those masks bit for bit, and without dropout against
``jax.vjp`` of JAX's ``sa_sublayer`` in interpret mode; ``_SA.backward``
hands the backward the forward's seed and rates and makes no mask.

Tolerance: 2e-5 of max(1, the reference's largest value), as the forward's
file: f32 sums in another order.
"""

import jax
import numpy as np
import pytest
import torch
from test_torch_port_k4_fwd import FakeK4Lib, _close, _inputs
from test_torch_port_k6_tc import _view

from fact_clip_tpu.ops.pallas.sa_layer import sa_sublayer
from fact_clip_tpu_torch import _build
from fact_clip_tpu_torch.ops import sa_layer as sl

torch.set_num_threads(2)
E, H = 64, 2
RATE = 0.2
SEED = 424242


class FakeK4BwdLib(FakeK4Lib):
    """``FakeK4Lib`` (the forward's entries), the SA backward's entry and
    ``fk_atb``: the six kernels' results written into the wrapper's buffers,
    the keep values (recorded in ``keeps``) read from a mask pointer or
    hashed from the seed, as the kernels choose."""

    def fk_sa_bwd(self, x, pos, Pp, wq, bq, wk, bk, wv, bv, wo, bo, gamma, wot, wqkt, wvt, keep_a,
                  keep_o, g, qkv, c, res, dout, dc, stats, dqk, dv, dxa, dx, part, B, M, E_, H_,
                  eps, seed_a, stream_a, thresh_a, scale_a, seed_o, stream_o, thresh_o, scale_o,
                  stream):
        hd = E_ // H_
        assert hd <= 64
        self.calls.append(("sa_bwd",))
        n = B * M * E_
        X = _view(x, n).view(B, M, E_)
        a = X.clone()
        if pos is not None:
            a[..., :Pp] += _view(pos, M * Pp).view(1, M, Pp)
        W = lambda p: _view(p, E_ * E_).view(E_, E_)  # noqa: E731
        vec = lambda p: _view(p, E_)  # noqa: E731
        # 1. q, k, v
        Q, K, V = a @ W(wq) + vec(bq), a @ W(wk) + vec(bk), X @ W(wv) + vec(bv)
        _view(qkv, 3 * n).view(B, 3, M, E_)[:] = torch.stack([Q, K, V], 1)
        # the masks: the replayed tensors, or the forward's hash at its indices
        ka = (_view(keep_a, B * H_ * M * M).view(B, H_ * M, M).clone() if keep_a is not None
              else self._keep(seed_a, stream_a, thresh_a, scale_a, (B, H_ * M, M)))
        ko = (_view(keep_o, n).view(B, M, E_).clone() if keep_o is not None
              else self._keep(seed_o, stream_o, thresh_o, scale_o, (B, M, E_)))
        self.keeps.append((ka, ko))
        heads = lambda t: t.view(B, M, H_, hd).transpose(1, 2)  # noqa: E731
        q, k, v = heads(Q), heads(K), heads(V)
        # 2. the softmax with its statistics and the context
        s = q @ k.transpose(-1, -2) * (1.0 / hd ** 0.5)
        mx = s.amax(-1, keepdim=True)
        inv = 1.0 / torch.exp(s - mx).sum(-1, keepdim=True)
        p = torch.exp(s - mx) * inv
        pd = p * ka.view(B, H_, M, M)
        C = (pd @ v).transpose(1, 2).reshape(B, M, E_)
        _view(c, n).view(B, M, E_)[:] = C
        # 3. the residual, its LayerNorm backward per 64-row tile, dout and dc
        r = X + (C @ W(wo) + vec(bo)) * ko
        mean = r.mean(-1, keepdim=True)
        rstd = torch.rsqrt(((r - mean) ** 2).mean(-1, keepdim=True) + eps)
        xhat = (r - mean) * rstd
        G = _view(g, n).view(B, M, E_)
        gg = G * vec(gamma)
        dres = rstd * (gg - gg.mean(-1, keepdim=True) - xhat * (gg * xhat).mean(-1, keepdim=True))
        _view(res, n).view(B, M, E_)[:] = dres
        tiles = -(-M // sl.SA_ROWS)
        PART = _view(part, B * tiles * 2 * E_).view(B, tiles, 2, E_)
        for t in range(tiles):
            rows = slice(t * sl.SA_ROWS, (t + 1) * sl.SA_ROWS)
            PART[:, t, 0] = (G * xhat)[:, rows].sum(1)
            PART[:, t, 1] = G[:, rows].sum(1)
        Dout = dres * ko
        _view(dout, n).view(B, M, E_)[:] = Dout
        DC = Dout @ _view(wot, E_ * E_).view(E_, E_)
        _view(dc, n).view(B, M, E_)[:] = DC
        # 4.-5. the row term, dq, dk and dv
        dch = heads(DC)
        D = (dch * heads(C)).sum(-1, keepdim=True)
        ST = _view(stats, B * H_ * M * 3).view(B, H_, M, 3)
        ST[..., 0], ST[..., 1], ST[..., 2] = mx[..., 0], inv[..., 0], D[..., 0]
        ds = p * ((dch @ v.transpose(-1, -2)) * ka.view(B, H_, M, M) - D) * (1.0 / hd ** 0.5)
        merge = lambda t: t.transpose(1, 2).reshape(B, M, E_)  # noqa: E731
        DQK = torch.cat([merge(ds @ k), merge(ds.transpose(-1, -2) @ q)], -1)
        DV = merge(pd.transpose(-1, -2) @ dch)
        _view(dqk, 2 * n).view(B, M, 2 * E_)[:] = DQK
        _view(dv, n).view(B, M, E_)[:] = DV
        # 6. dxa and dx
        DXA = DQK @ _view(wqkt, 2 * E_ * E_).view(2 * E_, E_)
        _view(dxa, n).view(B, M, E_)[:] = DXA
        _view(dx, n).view(B, M, E_)[:] = dres + DXA + DV @ _view(wvt, E_ * E_).view(E_, E_)
        return 0

    def fk_atb(self, A, pos, pos_stride, P, lengths, shift0, step, Bm, part, Bt, T, Ca, Cb, chunk,
               n_taps, stream):
        """One partial product per (chunk of rows, video): A^T Bm (pos on A's
        leading channels)."""
        assert lengths is None and n_taps == 1 and shift0 == 0
        self.calls.append(("atb",))
        a = _view(A, Bt * T * Ca).view(Bt, T, Ca).clone()
        if pos is not None:
            a[..., :P] += _view(pos, (Bt if pos_stride else 1) * T * P).view(-1, T, P)
        bm = _view(Bm, Bt * T * Cb).view(Bt, T, Cb)
        per = -(-T // chunk)
        out = _view(part, Bt * per * Ca * Cb).view(Bt, per, Ca, Cb)
        for b in range(Bt):
            for i in range(per):
                rows = slice(i * chunk, (i + 1) * chunk)
                out[b, i] = a[b, rows].t() @ bm[b, rows]
        return 0


@pytest.fixture
def fake(monkeypatch):
    lib = FakeK4BwdLib()
    monkeypatch.setattr(_build, "lib", lambda: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    return lib


def _seed():
    return torch.tensor([SEED], dtype=torch.int32)


def _grads_close(got, ref):
    assert len(got) == len(ref)
    for i, (a, b) in enumerate(zip(got, ref)):
        assert (a is None) == (b is None), i
        if a is not None:
            _close(a.numpy(), np.asarray(b), f"cotangent {i}")


@pytest.mark.parametrize("B,M", [(3, 11), (1, 300), (2, 200), (8, 40)])
def test_emulated_sa_backward_hashes_the_masks(fake, B, M):
    """Rate 0.2 on the probabilities and the output, the masks hashed from the
    seed: the launches equal ``sa_sublayer_bwd_reference`` given
    ``sa_dropout_masks`` of the same seed; the masks did act."""
    _, t = _inputs(4, B, M, E)
    g = torch.from_numpy(np.random.default_rng(5).standard_normal((B, M, E)).astype(np.float32))
    got = sl._sa_bwd_card(*t, g, H, sl.LN_EPS, None, None, _seed(), RATE, RATE)
    assert fake.calls[0] == ("sa_bwd",) and set(fake.calls[1:]) == {("atb",)}
    ka, ko = sl.sa_dropout_masks(_seed(), B, M, E, H, RATE, RATE)
    ref = sl.sa_sublayer_bwd_reference(*t, g, num_heads=H, keep_attn=ka, keep_out=ko)
    _grads_close(got, ref)
    nodrop = sl.sa_sublayer_bwd_reference(*t, g, num_heads=H)
    assert float((got[0] - nodrop[0]).abs().max()) > 1e-2


def test_emulated_sa_backward_keep_values_equal_the_replay(fake):
    """The keep values the backward hashes equal ``sa_dropout_masks`` of the
    seed bit for bit (both masks), and the gradients equal those of the same
    launches fed that replay, bit for bit."""
    B, M = 3, 37
    _, t = _inputs(6, B, M, E)
    g = torch.from_numpy(np.random.default_rng(7).standard_normal((B, M, E)).astype(np.float32))
    hashed = sl._sa_bwd_card(*t, g, H, sl.LN_EPS, None, None, _seed(), RATE, RATE)
    ka, ko = sl.sa_dropout_masks(_seed(), B, M, E, H, RATE, RATE)
    assert torch.equal(fake.keeps[-1][0], ka) and torch.equal(fake.keeps[-1][1], ko)
    fed = sl._sa_bwd_card(*t, g, H, sl.LN_EPS, ka, ko, None, RATE, RATE)
    assert torch.equal(fake.keeps[-1][0], ka) and torch.equal(fake.keeps[-1][1], ko)
    for a, b in zip(hashed, fed):
        assert (a is None and b is None) or torch.equal(a, b)


def test_emulated_sa_backward_without_dropout_matches_jax_vjp(fake):
    """No dropout: every cotangent against ``jax.vjp`` of JAX's
    ``sa_sublayer`` in interpret mode (its Pallas backward)."""
    B, M = 2, 40
    j, t = _inputs(8, B, M, E)
    gj = np.random.default_rng(9).standard_normal((B, M, E)).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: sa_sublayer(*a, num_heads=H, interpret=True), *j)
    ref = vjp(gj)
    got = sl._sa_bwd_card(*t, torch.from_numpy(gj), H, sl.LN_EPS, None, None, None, 0.0, 0.0)
    assert fake.keeps[-1][0].eq(1).all() and fake.keeps[-1][1].eq(1).all()
    _grads_close(got, ref)


def test_sa_autograd_backward_hashes_and_makes_no_mask(fake, monkeypatch):
    """``sa_sublayer``'s autograd backward hands the backward the forward's
    seed and rates and no mask; on the card's launch sequence no mask is
    made (``sa_dropout_masks`` not called, its launches 0), and the
    gradients equal the plain backward given the replayed masks."""
    B, M = 2, 11
    _, t = _inputs(10, B, M, E)
    t = [a.clone().requires_grad_(True) for a in t]
    g = torch.from_numpy(np.random.default_rng(11).standard_normal((B, M, E)).astype(np.float32))
    seen = []

    def card_bwd(*args, num_heads, eps, keep_attn=None, keep_out=None, seed=None, rate_attn=0.0,
                 rate=0.0):
        seen.append((keep_attn, keep_out, seed, rate_attn, rate))
        return sl._sa_bwd_card(*args, num_heads, eps, keep_attn, keep_out, seed, rate_attn, rate)

    y = sl.sa_sublayer(*t, num_heads=H, rate_attn=RATE, rate=RATE, seed=_seed())
    ka, ko = sl.sa_dropout_masks(_seed(), B, M, E, H, RATE, RATE)

    def no_mask(*a, **k):
        raise AssertionError("a mask was made for the backward")

    replay = sl.sa_dropout_masks
    monkeypatch.setattr(sl, "sa_sublayer_bwd", card_bwd)
    monkeypatch.setattr(sl, "sa_dropout_masks", no_mask)
    y.backward(g)
    (keep_attn, keep_out, seed, rate_attn, rate), = seen
    assert keep_attn is None and keep_out is None and int(seed[0]) == SEED
    assert (rate_attn, rate) == (RATE, RATE) and replay.launches == 0
    ref = sl.sa_sublayer_bwd_reference(*[a.detach() for a in t], g, num_heads=H, keep_attn=ka,
                                       keep_out=ko)
    _grads_close([a.grad for a in t], ref)


def test_sa_backward_refuses_dropout_without_a_seed(monkeypatch):
    """A rate above 0 with neither a seed nor masks raises before the library
    is asked for; masks given need no seed."""
    def no_lib():
        raise AssertionError("the kernel library was asked for")

    monkeypatch.setattr(_build, "lib", no_lib)
    _, t = _inputs(12, 1, 11, E)
    g = torch.zeros(1, 11, E)
    with pytest.raises(ValueError, match="seed"):
        sl.sa_sublayer_bwd(*t, g, num_heads=H, rate_attn=RATE)
    with pytest.raises(ValueError, match="seed"):
        sl.sa_sublayer_bwd(*t, g, num_heads=H, rate=RATE, seed=torch.tensor([1]))
    ka, ko = sl.sa_dropout_masks(_seed(), 1, 11, E, H, RATE, RATE)
    got = sl.sa_sublayer_bwd(*t, g, num_heads=H, keep_attn=ka, keep_out=ko, rate=RATE)
    assert float(got[0].abs().max()) == 0.0
