"""K4's SA backward with its dropout masks hashed in the kernels, on the CPU.

On the card the SA backward is one library call, ``fk_sa_bwd``
(``csrc/sa_layer.cu``), into one workspace that the library lays out and
reports (``fk_sa_bwd_workspace``), over the batch's B * M token rows as one
row space: the weight packs and the rows [x + pos | x | c | 1]; q | k | v on
the 3xTF32 GEMM (three problems); each query row's probabilities P (kept)
and the context c = (P * keep_a) v; c Wo on the GEMM; the residual x +
drop_o(c Wo + bo), its LayerNorm backward per 16-row tile and dout = dres *
keep_o; dc = dout Wo^T on the GEMM; dS, P * keep_a and dq per (query tile,
head, video); dk and dv per (key tile, head, video); [dq Wq^T | dk Wk^T | dv
Wv^T] on the GEMM (three problems); the weight products and bias sums (x +
pos)^T [dq | dk], x^T dv, c^T dout and 1^T [dq | dk | dv | dout] as one
weight-product launch over chunks of the rows; the chunks' and the
LayerNorm tiles' sums in two fixed-order stages, dx and d(pos).  The two
keep masks are the forward's: each kernel hashes the keep value of the
element it reads at the forward's index (SA stream 0 over (B, H*M, M), row
(b H + h) M + m, column j; stream 1 over (B, M, E), the flat index), or
reads a replayed mask where one is given.  Here, without a card,
``FakeK4BwdLib`` (``FakeK4Lib`` of ``test_torch_port_k4_fwd.py`` and the
backward's two entries on the raw memory of CPU tensors: the products in
the kernels' 3xTF32 arithmetic, ``_mm3``, the keep values hashed with the
forward's hash, ``FakeK6Lib._keep``) stands in for the library.  The port's
call (``_sa_bwd_card``), hashed and fed, is held against
``sa_sublayer_bwd_reference`` given ``sa_dropout_masks`` of the same seed,
its keep values against those masks bit for bit, and without dropout
against ``jax.vjp`` of JAX's ``sa_sublayer`` in interpret mode, at (B, M) =
(3, 11), (1, 300), (2, 200), (8, 40) with hd = 32 (E=64, H=2) and at hd =
64 (E=128, H=2); ``_SA.backward`` hands the backward the forward's seed and
rates and makes no mask.

Tolerance: 2e-5 of max(1, the reference's largest value), as the forward's
file: f32 sums in another order, 3xTF32 products.
"""

import jax
import numpy as np
import pytest
import torch
from test_torch_port_k4_fwd import FakeK4Lib, _close, _inputs
from test_torch_port_k6_tc import _ints, _mm3, _view

from fact_clip_tpu.ops.pallas.sa_layer import sa_sublayer
from fact_clip_tpu_torch import _build
from fact_clip_tpu_torch.ops import sa_layer as sl

torch.set_num_threads(2)
E, H = 64, 2
RATE = 0.2
SEED = 424242
# (B, M, E, H): the zoo's token counts at hd = 32, and hd = 64
SHAPES = [(3, 11, 64, 2), (1, 300, 64, 2), (2, 200, 64, 2), (8, 40, 64, 2), (2, 40, 128, 2)]


def _up(n, k):
    return -(-n // k) * k


class FakeK4BwdLib(FakeK4Lib):
    """``FakeK4Lib`` (the forward's entries) and the SA backward's two: the
    workspace's layout, and the call's ten steps written into it region by
    region, the keep values (recorded in ``keeps``) read from a mask pointer
    or hashed from the seed, as the kernels choose."""

    SMS, LN_ROWS, QT = 132, 16, 32

    @staticmethod
    def _slices(Kp):
        """csrc/sa_layer.cu::sa_slices: the K slices of the out, dc and dx
        products."""
        s = 4
        while s > 1:
            if Kp % (32 * s) == 0 and Kp // s >= 64:
                return s
            s //= 2
        return 1

    def _layout(self, B, M, E_, H_, Pp):
        """csrc/sa_layer.cu::sa_workspace: each region's offset (64-float
        steps; dx, dpos and dw in the results' buffer), the packs' padded K,
        the K slices of the out, dc and dx products, the weight products'
        chunk of rows and chunks, the LayerNorm tiles, Sw and both buffers'
        floats."""
        R, Kp = B * M, _up(E_, 32)
        S = self._slices(Kp)
        tiles = sum(-(-ca // 128) * -(-cb // 128) for _, ca, _, cb in self._pairs(E_))
        Kc = _up(-(-R // max(1, self.SMS // tiles)), 32)
        chunks, ln_tiles, Sw = -(-R // Kc), -(-R // self.LN_ROWS), 4 * E_ * E_ + 4 * E_
        at, off = 0, {}
        RE = R * E_
        for name, n in [("lens", 1), ("pack", 8 * 2 * E_ * Kp), ("rows", R * (3 * E_ + 4)),
                        ("qkv", 3 * RE), ("o", S * RE), ("dres", RE), ("dc", S * RE),
                        ("grads", R * 4 * E_), ("dxo", 3 * S * RE), ("P", R * H_ * M),
                        ("dS", R * H_ * M), ("part", ln_tiles * 2 * E_), ("wpart", chunks * Sw),
                        # the results' buffer
                        ("total", 0), ("dx", RE), ("dpos", M * Pp), ("dw", Sw + 2 * E_)]:
            if name == "total":
                at, total = 0, at
            off[name] = at
            at += _up(n, 64)
        return off, Kp, S, Kc, chunks, ln_tiles, Sw, (total, at)

    @staticmethod
    def _sliced(A, W, sl, bias=None):
        """A @ W as the library forms it: a 3xTF32 product a K slice (the
        bias on slice 0), the slices added in order."""
        ks = W.shape[0] // sl
        out = _mm3(A[:, :ks], W[:ks])
        if bias is not None:
            out = out + bias
        for k in range(1, sl):
            out = out + _mm3(A[:, k * ks:(k + 1) * ks], W[k * ks:(k + 1) * ks])
        return out

    @staticmethod
    def _pairs(E_):
        return [(0, E_, 0, 2 * E_), (E_, E_, 2 * E_, E_), (2 * E_, E_, 3 * E_, E_),
                (3 * E_, 1, 0, 4 * E_)]

    @staticmethod
    def _sum2(parts, group):
        """Partials summed in two fixed-order stages: each run of ``group`` in
        order, then the runs in order."""
        runs = []
        for r in range(0, len(parts), group):
            t = parts[r].clone()
            for k in range(r + 1, min(len(parts), r + group)):
                t += parts[k]
            runs.append(t)
        out = runs[0]
        for t in runs[1:]:
            out = out + t
        return out

    def fk_sa_bwd_workspace(self, B, M, E_, H_, Pp, out):
        off, *_, (total, n_out) = self._layout(B, M, E_, H_, Pp)
        out[:] = [total, n_out, off["dx"], off["dpos"], off["dw"]]
        return 0

    def fk_sa_bwd(self, x, pos, Pp, wq, bq, wk, bk, wv, bv, wo, bo, gamma, keep_a, keep_o, g, ws,
                  res, B, M, E_, H_, eps, seed_a, stream_a, thresh_a, scale_a, seed_o, stream_o,
                  thresh_o, scale_o, stream):
        hd = E_ // H_
        assert hd <= 64 and hd % 4 == 0 and E_ % 4 == 0
        self.calls.append(("sa_bwd",))
        R = B * M
        off, Kp, S, Kc, chunks, ln_tiles, Sw, (total, n_out) = self._layout(B, M, E_, H_, Pp)
        WS, OUT = _view(ws, total), _view(res, n_out)

        def region(name, *shape):
            n = int(np.prod(shape))
            buf = OUT if name in ("dx", "dpos", "dw") else WS
            return buf[off[name]:off[name] + n].view(*shape)

        X = _view(x, R * E_).view(R, E_)
        W = lambda p: _view(p, E_ * E_).view(E_, E_)  # noqa: E731
        vec = lambda p: _view(p, E_)  # noqa: E731
        # 0. the rows [x + pos | x | c | 1 0 0 0] and lens
        _ints(ws + 4 * off["lens"], 1)[0] = R
        rows = region("rows", R, 3 * E_ + 4)
        rows[:] = 0.0
        rows[:, :E_], rows[:, E_:2 * E_], rows[:, 3 * E_] = X, X, 1.0
        if pos is not None:
            rows[:, :Pp] += _view(pos, M * Pp).view(1, M, Pp).expand(B, M, Pp).reshape(R, Pp)
        # 1. q | k | v (three problems, 3xTF32)
        qkv = torch.cat([self._sliced(rows[:, c0:c0 + E_], W(w), 1, vec(b))
                         for c0, w, b in ((0, wq, bq), (0, wk, bk), (E_, wv, bv))], 1)
        # the masks: the replayed tensors, or the forward's hash at its indices
        ka = (_view(keep_a, R * H_ * M).view(B, H_ * M, M).clone() if keep_a is not None
              else self._keep(seed_a, stream_a, thresh_a, scale_a, (B, H_ * M, M)))
        ko = (_view(keep_o, R * E_).view(B, M, E_).clone() if keep_o is not None
              else self._keep(seed_o, stream_o, thresh_o, scale_o, (B, M, E_)))
        self.keeps.append((ka, ko))
        heads = lambda t: t.reshape(B, M, H_, hd).transpose(1, 2)  # noqa: E731
        merge = lambda t: t.transpose(1, 2).reshape(R, E_)  # noqa: E731
        q, k, v = (heads(qkv[:, i * E_:(i + 1) * E_]) for i in range(3))
        # 2. P (kept) and the context c into rows; the softmax in float64,
        # rounded once: a float32 exp-and-sum here came out ~1e-5 off in about
        # one pytest-xdist worker in eight, the same inputs exact in the others
        s = q @ k.transpose(-1, -2) * (1.0 / hd ** 0.5)
        P = region("P", B, H_, M, M)
        P[:] = torch.softmax(s.double(), dim=-1).float()
        kav = ka.view(B, H_, M, M)
        rows[:, 2 * E_:3 * E_] = merge((P * kav) @ v)
        # 3. o = c Wo; 4. the LayerNorm backward per 16-row tile, dout; 5. dc
        o = self._sliced(rows[:, 2 * E_:3 * E_], W(wo), S)
        G = _view(g, R * E_).view(R, E_)
        kof = ko.view(R, E_)
        dres, grads = region("dres", R, E_), region("grads", R, 4 * E_)
        part = region("part", ln_tiles, 2, E_)
        for t in range(ln_tiles):
            r = slice(t * self.LN_ROWS, (t + 1) * self.LN_ROWS)
            v_ = X[r] + (o[r] + vec(bo)) * kof[r]
            mean = v_.mean(-1, keepdim=True)
            rstd = torch.rsqrt(((v_ - mean) ** 2).mean(-1, keepdim=True) + eps)
            xhat = (v_ - mean) * rstd
            gg = G[r] * vec(gamma)
            part[t, 0], part[t, 1] = (G[r] * xhat).sum(0), G[r].sum(0)
            d = rstd * (gg - gg.mean(-1, keepdim=True) - xhat * (gg * xhat).mean(-1, keepdim=True))
            dres[r] = d
            grads[r, 3 * E_:] = d * kof[r]
        dc = self._sliced(grads[:, 3 * E_:], W(wo).t(), S)
        # 6. D, dS, P * keep and dq; 7. dk and dv
        dch, ch = heads(dc), heads(rows[:, 2 * E_:3 * E_])
        D = (dch * ch).sum(-1, keepdim=True)
        dS = region("dS", B, H_, M, M)
        dS[:] = P * ((dch @ v.transpose(-1, -2)) * kav - D) * (1.0 / hd ** 0.5)
        P *= kav
        grads[:, :E_] = merge(dS @ k)
        grads[:, E_:2 * E_] = merge(dS.transpose(-1, -2) @ q)
        grads[:, 2 * E_:3 * E_] = merge(P.transpose(-1, -2) @ dch)
        # 8. dq Wq^T, dk Wk^T, dv Wv^T
        dxo = [self._sliced(grads[:, z * E_:(z + 1) * E_], W(w).t(), S)
               for z, w in enumerate((wq, wk, wv))]
        # 9. the weight products and bias sums, chunk by chunk of Kc rows
        wpart = region("wpart", chunks, Sw)
        for c in range(chunks):
            r, at = slice(c * Kc, (c + 1) * Kc), 0
            for a_c0, ca, b_c0, cb in self._pairs(E_):
                A = rows[r, a_c0:a_c0 + ca]
                wpart[c, at:at + ca * cb] = _mm3(A.t().contiguous(),
                                                 grads[r, b_c0:b_c0 + cb]).reshape(-1)
                at += ca * cb
        # 10. the sums, dx and d(pos)
        # dw: dWq, dWk, dWv, dWo, then the bias sums, dgamma and dbeta
        dw = self._sum2(list(wpart), 4)
        qk = dw[:2 * E_ * E_].view(E_, 2 * E_)
        region("dw", Sw + 2 * E_)[:] = torch.cat(
            [qk[:, :E_].reshape(-1), qk[:, E_:].reshape(-1), dw[2 * E_ * E_:],
             self._sum2(list(part.view(ln_tiles, 2 * E_)), 8)])
        dxa = dxo[0] + dxo[1]
        region("dx", R, E_)[:] = dres + dxa + dxo[2]
        if Pp:
            region("dpos", M, Pp)[:] = self._sum2(list(dxa.view(B, M, E_)[..., :Pp]), B)
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


def _hashes_the_masks(fake, B, M, E_, H_):
    _, t = _inputs(4, B, M, E_)
    g = torch.from_numpy(np.random.default_rng(5).standard_normal((B, M, E_)).astype(np.float32))
    got = sl._sa_bwd_card(*t, g, H_, sl.LN_EPS, None, None, _seed(), RATE, RATE)
    assert fake.calls == [("sa_bwd",)]
    ka, ko = sl.sa_dropout_masks(_seed(), B, M, E_, H_, RATE, RATE)
    ref = sl.sa_sublayer_bwd_reference(*t, g, num_heads=H_, keep_attn=ka, keep_out=ko)
    _grads_close(got, ref)
    fed = sl._sa_bwd_card(*t, g, H_, sl.LN_EPS, ka, ko, None, RATE, RATE)
    _grads_close(fed, ref)
    nodrop = sl.sa_sublayer_bwd_reference(*t, g, num_heads=H_)
    assert float((got[0] - nodrop[0]).abs().max()) > 1e-2


@pytest.mark.parametrize("B,M", [(3, 11), (1, 300), (2, 200), (8, 40)])
def test_emulated_sa_backward_hashes_the_masks(fake, B, M):
    """Rate 0.2 on the probabilities and the output, the masks hashed from the
    seed: the call equals ``sa_sublayer_bwd_reference`` given
    ``sa_dropout_masks`` of the same seed, and so does the call fed those
    masks; the masks did act."""
    _hashes_the_masks(fake, B, M, E, H)


def test_emulated_sa_backward_hashes_the_masks_at_hd64(fake):
    """The same at a head 64 wide (E=128, H=2): two dimensions a thread in
    the key-tile kernel, two K slices in the sliced products."""
    _hashes_the_masks(fake, 2, 40, 128, 2)


def test_emulated_sa_backward_keep_values_equal_the_replay(fake):
    """The keep values the backward hashes equal ``sa_dropout_masks`` of the
    seed bit for bit (both masks), and the gradients equal those of the same
    call fed that replay, bit for bit."""
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


def _matches_jax_vjp(B, M, E_, H_):
    j, t = _inputs(8, B, M, E_)
    gj = np.random.default_rng(9).standard_normal((B, M, E_)).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: sa_sublayer(*a, num_heads=H_, interpret=True), *j)
    ref = vjp(gj)
    got = sl._sa_bwd_card(*t, torch.from_numpy(gj), H_, sl.LN_EPS, None, None, None, 0.0, 0.0)
    return got, ref


def test_emulated_sa_backward_without_dropout_matches_jax_vjp(fake):
    """No dropout: every cotangent against ``jax.vjp`` of JAX's
    ``sa_sublayer`` in interpret mode (its Pallas backward)."""
    got, ref = _matches_jax_vjp(2, 40, E, H)
    assert fake.keeps[-1][0].eq(1).all() and fake.keeps[-1][1].eq(1).all()
    _grads_close(got, ref)


@pytest.mark.parametrize("B,M,E_,H_", SHAPES)
def test_emulated_sa_backward_matches_jax_vjp_at_the_zoo_shapes(fake, B, M, E_, H_):
    """The same at the zoo's token counts and at hd = 64."""
    got, ref = _matches_jax_vjp(B, M, E_, H_)
    _grads_close(got, ref)


@pytest.mark.parametrize("P", [None, 32])
def test_emulated_sa_backward_with_a_narrow_or_no_pos(fake, P):
    """No positional table (no d(pos)), or one narrower than E: its
    gradient is the batch sum of dxa's leading P channels."""
    B, M = 3, 40
    _, t = _inputs(13, B, M, E)
    t[1] = None if P is None else t[1][..., :P].contiguous()
    g = torch.from_numpy(np.random.default_rng(14).standard_normal((B, M, E)).astype(np.float32))
    got = sl._sa_bwd_card(*t, g, H, sl.LN_EPS, None, None, _seed(), RATE, RATE)
    ka, ko = sl.sa_dropout_masks(_seed(), B, M, E, H, RATE, RATE)
    ref = sl.sa_sublayer_bwd_reference(*t, g, num_heads=H, keep_attn=ka, keep_out=ko)
    assert (got[1] is None) == (P is None)
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
