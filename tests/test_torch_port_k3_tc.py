"""K3 on the port's tensor-core GEMM with per-head attention, on the CPU.

K3's forward on the card is the K / V projection, one 3xTF32 GEMM of the
towers' core (``fk_k6_gemm``, epilogue kProj: [bk | bv] and the key's
positional term pos @ Wk, itself a kMasked GEMM), then per (key tile, head,
video) the masked softmax partials and their fixed-order combine
(``fk_k3_attn``, ``csrc/mha_attn.cu``).  Its backward recomputes the
projection, runs the per-(tile, head, video) attention backward
(``fk_k3_attn_bwd``: dKV, dq's tile shares, the bias column sums), dx as one
more GEMM (K = 2E), the weight products on ``fk_k6_wgrad`` (pos^T of the
batch's dK where pos is shared) and the two-stage fixed-order sums.  Here,
without a card, ``FakeK3Lib`` (``FakeK6Lib`` of ``test_torch_port_k6_tc.py``
and the two attention entries, on the raw memory of CPU tensors, with the
kernels' tiles, skips and partial layouts) stands in for the library; the
port's launch sequences (``_mha_fwd_card``, ``_mha_bwd_card``) are held
against JAX's ``mha_cross_attention`` in interpret mode and ``jax.vjp`` of
it (``pos_grad=False``), against ``_mha_reference`` given the port's mask
with dropout, and against the f32 plain versions: M = 11, 40, 200, hd = 32
and 64, ragged ``x_len`` (a key tile wholly past one video), X not a
multiple of the tile, no, shared and per-video positional terms.

Also ``egoprocel_cfg()`` against ``fact_clip_tpu/configs/egoprocel.yaml``,
and a narrow egoprocel-shaped model (``iUUU``, 200 tokens, ``f: m2``, o2o,
bgw 0.5, ``ref_weight_order``) against the JAX model's forward and loss.

Tolerances: 2e-5 of max(1, the reference's largest value) on forward values
and on each gradient (dbk is zero but for rounding without dropout): the projection's split keeps ~2^-22 of
each product, f32 sums in another order (K = Cx, and X for the weight
products).
"""

import dataclasses
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_k6_tc import FakeK6Lib, _close_split, _ints, _unpack, _view

from fact_clip_tpu.ops.pallas.mha_attn import _mha_reference, mha_cross_attention
from fact_clip_tpu_torch import _build
from fact_clip_tpu_torch.ops import dilated_conv as dc
from fact_clip_tpu_torch.ops import mha_attn as ma
from fact_clip_tpu_torch.ops.dropout import dropout_mask_reference

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-5
X, CX = 150, 48  # 64-key tiles: 64, 64, 22; 48 channels: one and a half 32-float K steps
XLEN = [150, 70]  # the second video's last tile lies wholly past it


class FakeK3Lib(FakeK6Lib):
    """``FakeK6Lib`` and K3's attention entries: per (key tile, head, video)
    partials in the kernels' layouts, the combine in tile order; a tile wholly
    past x_len is skipped unless the video has no valid key (x_len = 0: every
    logit -1e9, so every tile runs).  ``bwd_keeps`` lists the keep values
    each backward read or hashed."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.bwd_keeps = []

    def fk_k3_attn(self, kv, q, xlen, B, X_, M, H, hd, scale, part_acc, part_ml, out, stats, seed,
                   drop_stream, thresh, drop_scale, stream):
        self.calls.append(("k3_attn",))
        E, BK = H * hd, ma.FWD_KEY_TILE
        n_t = -(-X_ // BK)
        KV = _view(kv, B * X_ * 2 * E).view(B, X_, 2 * E)
        Q = _view(q, B * M * E).view(B, M, H, hd)
        PA = _view(part_acc, B * n_t * H * M * hd).view(B, n_t, H, M, hd)
        PML = _view(part_ml, B * n_t * H * M * 2).view(B, n_t, H, M, 2)
        keep = self._keep(seed, drop_stream, thresh, drop_scale, (B, H * M, X_)).view(B, H, M, X_)
        lens = _ints(xlen, B)
        for b in range(B):
            xl = min(int(lens[b]), X_)
            for t in range(n_t):
                keys = torch.arange(t * BK, min((t + 1) * BK, X_))
                if xl > 0 and t * BK >= xl:  # every key masked: the partials of p = 1, V = 0
                    PA[b, t] = 0.0
                    PML[b, t, :, :, 0] = -1e9
                    PML[b, t, :, :, 1] = float(len(keys))
                    continue
                K = KV[b, keys, :E].view(-1, H, hd)
                V = KV[b, keys, E:].view(-1, H, hd)
                lg = torch.einsum("mhd,jhd->hmj", Q[b], K) * scale
                lg[..., keys >= xl] = -1e9
                m = lg.amax(-1)
                p = torch.exp(lg - m[..., None])
                PA[b, t] = torch.einsum("hmj,jhd->hmd", p * keep[b][:, :, keys], V)
                PML[b, t, ..., 0] = m
                PML[b, t, ..., 1] = p.sum(-1)
        mx = PML[..., 0].amax(1, keepdim=True)
        w = torch.exp(PML[..., 0] - mx)
        l_tot = (w * PML[..., 1]).sum(1)
        O_ = (w[..., None] * PA).sum(1) / l_tot.clamp_min(1e-30)[..., None]  # (B, H, M, hd)
        _view(out, B * M * E).view(B, M, H, hd)[:] = O_.permute(0, 2, 1, 3)
        if stats is not None:
            _view(stats, B * H * M * 2).view(B, H, M, 2)[:] = torch.stack([mx[:, 0], l_tot], -1)
        return 0

    def fk_k3_attn_bwd(self, kv, q, g, stats, Dr, keep, xlen, B, X_, M, H, hd, scale, dkv,
                       part_dq, part_b, n_slots, key_tile, seed, drop_stream, thresh, drop_scale,
                       stream):
        self.calls.append(("k3_attn_bwd", key_tile))
        E, BK = H * hd, key_tile
        n_t = -(-X_ // BK)
        assert n_slots >= n_t
        KV = _view(kv, B * X_ * 2 * E).view(B, X_, 2 * E)
        Q = _view(q, B * M * E).view(B, M, H, hd)
        G = _view(g, B * M * E).view(B, M, H, hd)
        ST = _view(stats, B * H * M * 2).view(B, H, M, 2)
        DR = _view(Dr, B * H * M).view(B, H, M)
        # the keep values: the mask given, else hashed from the seed (at the
        # forward's index (b*H*M + h*M + m)*X + key), else none
        KP = (_view(keep, B * H * M * X_).view(B, H, M, X_).clone() if keep is not None
              else self._keep(seed, drop_stream, thresh, drop_scale, (B, H * M, X_))
              .view(B, H, M, X_))
        self.bwd_keeps.append(KP)
        DKV = _view(dkv, B * X_ * 2 * E).view(B, X_, 2 * E)
        PQ = _view(part_dq, B * n_slots * M * E).view(B, n_slots, M, E)
        PB = _view(part_b, B * n_slots * 2 * E).view(B, n_slots, 2 * E)
        lens = _ints(xlen, B)
        for b in range(B):
            xl = min(int(lens[b]), X_)
            for t in range(n_t):
                keys = torch.arange(t * BK, min((t + 1) * BK, X_))
                if xl > 0 and t * BK >= xl:  # p = 0 on every key: all zero
                    PQ[b, t] = 0.0
                    DKV[b, keys] = 0.0
                    PB[b, t] = 0.0
                    continue
                K = KV[b, keys, :E].view(-1, H, hd)
                V = KV[b, keys, E:].view(-1, H, hd)
                valid = keys < xl
                lg = (torch.einsum("mhd,jhd->hmj", Q[b], K) * scale).masked_fill(~valid, -1e9)
                p = torch.exp(lg - ST[b, ..., :1]) / ST[b, ..., 1:].clamp_min(1e-30)
                dp = torch.einsum("mhd,jhd->hmj", G[b], V)
                kp = KP[b][..., keys]
                dl = torch.where(valid, p * (dp * kp - DR[b][..., None]), 0.0) * scale
                pk = p * kp
                PQ[b, t] = torch.einsum("hmj,jhd->mhd", dl, K).reshape(M, E)
                dK = torch.einsum("hmj,mhd->jhd", dl, Q[b]).reshape(-1, E)
                dV = torch.einsum("hmj,mhd->jhd", pk, G[b]).reshape(-1, E)
                DKV[b, keys] = torch.cat([dK, dV], 1)
                PB[b, t] = torch.cat([dK.sum(0), dV.sum(0)])
        return 0


@pytest.fixture
def fake(monkeypatch):
    lib = FakeK3Lib()
    monkeypatch.setattr(_build, "lib", lambda: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    return lib


def _pair(rng, shape, scale=1.0):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _inputs(seed, M, hd, pos, H=2, B=2, xlen=XLEN):
    """q, x, pos (None, shared (1, X, CX) or per-video (B, X, CX)), the
    projections and x_len: (jax list, torch list) in the entry's order."""
    rng = np.random.default_rng(seed)
    E = H * hd
    q, x = _pair(rng, (B, M, E)), _pair(rng, (B, X, CX))
    p = None if pos is None else _pair(rng, (1 if pos == "shared" else B, X, CX), 0.5)
    wk, bk = _pair(rng, (CX, E), 0.15), _pair(rng, (E,), 0.05)
    wv, bv = _pair(rng, (CX, E), 0.15), _pair(rng, (E,), 0.05)
    xl = np.array(xlen, np.int32)
    zeros = jnp.zeros((1, X, CX), jnp.float32)
    j = [q[0], x[0], zeros if p is None else p[0], wk[0], bk[0], wv[0], bv[0], jnp.asarray(xl)]
    t = [q[1], x[1], None if p is None else p[1], wk[1], bk[1], wv[1], bv[1], torch.from_numpy(xl)]
    return j, t


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=tol * max(1.0, float(np.abs(ref).max())), rtol=0)


FWD_CALLS = {None: [("gemm", dc._PROJ), ("k3_attn",)],
             "shared": [("gemm", dc._MASKED), ("gemm", dc._PROJ), ("k3_attn",)]}
FWD_CALLS["per_video"] = FWD_CALLS["shared"]


def test_k3_packed_operands_unpack_to_the_jax_layout():
    """``k3_pack``: [Wk | Wv]^T's TF32 hi / lo parts (2, 2E, Cx), the biases
    side by side, and Wk^T's (2, E, Cx) for the positional table."""
    _, (q, x, pos, wk, bk, wv, bv, xl) = _inputs(1, 11, 32, None)
    wkv, bkv, wkp = ma.k3_pack(wk, bk, wv, bv)
    assert wkv.shape == (2, 128, CX) and wkp.shape == (2, 64, CX) and bkv.shape == (128,)
    _close_split(wkv, torch.cat([wk, wv], 1), transpose=True)
    _close_split(wkp, wk, transpose=True)
    assert float((_unpack(wkv, True) - torch.cat([wk, wv], 1)).abs().max()) <= 2.0 ** -22
    assert torch.equal(bkv, torch.cat([bk, bv]))


@pytest.mark.parametrize("M,hd,pos", [(11, 32, "shared"), (40, 64, "per_video"),
                                      (200, 32, "shared"), (200, 64, None)])
def test_emulated_forward_matches_jax_interpret(fake, M, hd, pos):
    """The forward's launches (the positional table, the projection, the
    per-head partials and their combine) against JAX's kernel in interpret
    mode and the plain version, the softmax stats against the plain ones."""
    j, t = _inputs(2, M, hd, pos)
    H = 2
    ref_j = mha_cross_attention(*j, num_heads=H, tile=128, interpret=True)
    out, stats = ma._mha_fwd_card(*t, H, 0.0, None, True, None)
    assert fake.calls == FWD_CALLS[pos]
    _close(out.numpy(), ref_j)
    ref, ref_st = ma.mha_cross_attention_reference(*t, num_heads=H, with_stats=True)
    _close(out.numpy(), ref.numpy())
    _close(stats.numpy()[..., 0], ref_st.numpy()[..., 0])
    np.testing.assert_allclose(stats.numpy()[..., 1], ref_st.numpy()[..., 1], rtol=TOL)


@pytest.mark.parametrize("M,hd", [(11, 32), (200, 64)])
def test_emulated_forward_with_dropout_replays_the_mask(fake, M, hd):
    """Rate 0.2: the partials hash the layer's mask at ``mha_dropout_mask``'s
    index layout; against JAX's ``_mha_reference`` given that mask and the
    plain version with it."""
    j, t = _inputs(3, M, hd, "shared")
    H, B = 2, 2
    seed = torch.tensor([123457], dtype=torch.int32)
    keep = dropout_mask_reference(seed, 0, (B, H * M, X), 0.2)
    got = ma._mha_fwd_card(*t, H, 0.2, seed, False, None)
    ref_j = _mha_reference(*j, jnp.asarray(keep.numpy().reshape(B, H, M, X)), H)
    _close(got.numpy(), ref_j)
    _close(got.numpy(), ma.mha_cross_attention_reference(*t, num_heads=H, keep=keep).numpy())
    nodrop = ma.mha_cross_attention_reference(*t, num_heads=H)
    assert float((got - nodrop).abs().max()) > 1e-2  # the mask did act


def _grads_close(got, ref):
    for i, (a, b) in enumerate(zip(got, ref)):
        if b is None:
            assert a is None, i
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, i
        scale = max(float(np.abs(b).max()), 1.0)  # dbk is zero but for rounding without dropout
        assert float(np.abs(a - b).max()) <= TOL * scale, (i, float(np.abs(a - b).max()) / scale)


@pytest.mark.parametrize("M,hd,pos", [(40, 32, "shared"), (11, 64, "per_video"),
                                      (200, 64, None)])
def test_emulated_backward_matches_jax_vjp(fake, M, hd, pos):
    """The backward's launches from the emulated forward's saves against
    ``jax.vjp`` of JAX's kernels in interpret mode (``pos_grad=False``):
    dq, dx, dWk (with pos^T dK), dbk, dWv, dbv.  At M=200, hd=64 the
    backward takes 32-key tiles."""
    j, t = _inputs(4, M, hd, pos)
    H = 2
    g = np.random.default_rng(5).standard_normal(t[0].shape).astype(np.float32)

    def f(q, x, wk, bk, wv, bv):
        return mha_cross_attention(q, x, j[2], wk, bk, wv, bv, j[7], num_heads=H, tile=128,
                                   interpret=True, pos_grad=False)

    out_j, vjp = jax.vjp(f, j[0], j[1], *j[3:7])
    refs = vjp(jnp.asarray(g))
    out, stats = ma._mha_fwd_card(*t, H, 0.0, None, True, None)
    _close(out.numpy(), out_j)
    fake.calls.clear()
    got = ma._mha_bwd_card(*t, stats, out, torch.from_numpy(g), H, None)
    tile = ma.bwd_key_tile(M, H * hd, H)
    assert tile == (32 if (M, hd) == (200, 64) else 64)
    wgrads = [("wgrad", 1)] * (1 if pos is None else 2)
    assert [c for c in fake.calls if c[0] != "gemm"] == [("k3_attn_bwd", tile)] + wgrads
    assert [c for c in fake.calls if c[0] == "gemm"] == (
        FWD_CALLS[pos][:-1] + [("gemm", dc._MASKED)])  # the recompute, then dx
    assert got[2] is None  # the constant positional term
    _grads_close([got[0], got[1], *got[3:]], [np.asarray(r) for r in refs])


def test_emulated_backward_with_dropout_matches_plain_and_jax_reference(fake):
    """Rate 0.2, shared pos, M=200: the backward on the layer's regenerated
    mask against the plain backward on the same saves and mask, and against
    ``jax.vjp`` of ``_mha_reference`` given that mask."""
    M, hd, H, B = 200, 32, 2, 2
    j, t = _inputs(6, M, hd, "shared")
    seed = torch.tensor([99991], dtype=torch.int32)
    keep = dropout_mask_reference(seed, 0, (B, H * M, X), 0.2)
    g = torch.from_numpy(np.random.default_rng(7).standard_normal((B, M, H * hd))
                         .astype(np.float32))
    out, stats = ma._mha_fwd_card(*t, H, 0.2, seed, True, None)
    got = ma._mha_bwd_card(*t, stats, out, g, H, keep)
    ref = ma.mha_cross_bwd_reference(*t, stats, out, g, num_heads=H, keep=keep)
    _grads_close(got, ref)
    keep_j = jnp.asarray(keep.numpy().reshape(B, H, M, X))

    def f(q, x, wk, bk, wv, bv):
        return _mha_reference(q, x, j[2], wk, bk, wv, bv, j[7], keep_j, H)

    _, vjp = jax.vjp(f, j[0], j[1], *j[3:7])
    refs = vjp(jnp.asarray(g.numpy()))
    _grads_close([got[0], got[1], *got[3:]], [np.asarray(r) for r in refs])


@pytest.mark.parametrize("M,hd,pos", [(11, 32, "shared"), (40, 64, "per_video"),
                                      (200, 32, None)])
def test_emulated_backward_hashes_the_mask(fake, M, hd, pos):
    """Rate 0.2, no mask handed over: the backward hashes the keep values
    from the forward's seed, bit for bit ``mha_dropout_mask``'s, and its
    gradients equal, bit for bit, those of the same call fed that mask; both
    match the plain backward given the mask, and the mask did act."""
    H, B = 2, 2
    j, t = _inputs(11, M, hd, pos)
    seed = torch.tensor([424243], dtype=torch.int32)
    keep = ma.mha_dropout_mask(seed, (B, H * M, X), 0.2)
    g = torch.from_numpy(np.random.default_rng(12).standard_normal((B, M, H * hd))
                         .astype(np.float32))
    out, stats = ma._mha_fwd_card(*t, H, 0.2, seed, True, None)
    hashed = ma._mha_bwd_card(*t, stats, out, g, H, None, seed, 0.2)
    assert torch.equal(fake.bwd_keeps[-1], keep.view(B, H, M, X))
    fed = ma._mha_bwd_card(*t, stats, out, g, H, keep)
    assert torch.equal(fake.bwd_keeps[-1], keep.view(B, H, M, X))
    for a, b in zip(hashed, fed):
        assert (a is None and b is None) or torch.equal(a, b)
    ref = ma.mha_cross_bwd_reference(*t, stats, out, g, num_heads=H, keep=keep)
    _grads_close(hashed, ref)
    nodrop = ma.mha_cross_bwd_reference(*t, stats, out, g, num_heads=H)
    assert float((hashed[0] - nodrop[0]).abs().max()) > 1e-3


def test_mha_autograd_backward_hashes_and_makes_no_mask(fake, monkeypatch):
    """``mha_cross_attention``'s autograd backward hands the backward the
    forward's seed and rate and no mask; on the card's launch sequence no
    mask is made (``mha_dropout_mask`` not called, its launches unchanged),
    and the gradients equal the plain backward given the replayed mask."""
    M, hd, H, B = 11, 32, 2, 2
    _, t = _inputs(13, M, hd, "shared")
    seed = torch.tensor([777767], dtype=torch.int32)
    diff = [a.clone().requires_grad_(True) for a in (t[0], t[1], *t[3:7])]
    args = [diff[0], diff[1], t[2], *diff[2:], t[7]]
    g = torch.from_numpy(np.random.default_rng(14).standard_normal((B, M, H * hd))
                         .astype(np.float32))
    seen = []

    def card_bwd(*a, num_heads, keep=None, seed=None, rate=0.0):
        seen.append((keep, seed, rate))
        return ma._mha_bwd_card(*a, num_heads, keep, seed, rate)

    y = ma.mha_cross_attention(*args, num_heads=H, rate=0.2, seed=seed)
    keep = ma.mha_dropout_mask(seed, (B, H * M, X), 0.2)
    launches = ma.mha_dropout_mask.launches

    def no_mask(*a, **k):
        raise AssertionError("a mask was made for the backward")

    monkeypatch.setattr(ma, "mha_cross_bwd", card_bwd)
    monkeypatch.setattr(ma, "mha_dropout_mask", no_mask)
    y.backward(g)
    (kp, sd, rate), = seen
    assert kp is None and int(sd[0]) == 777767 and rate == 0.2
    assert torch.equal(fake.bwd_keeps[-1], keep.view(B, H, M, X))
    monkeypatch.undo()
    assert ma.mha_dropout_mask.launches == launches
    y0, stats = ma.mha_cross_fwd(*[a.detach() if a is not None else None for a in args],
                                 num_heads=H, rate=0.2, seed=seed, with_stats=True)
    ref = ma.mha_cross_bwd_reference(*[a.detach() if a is not None else None for a in args],
                                     stats, y0, g, num_heads=H, keep=keep)
    got = [diff[0].grad, diff[1].grad, None, *[a.grad for a in diff[2:]]]
    _grads_close(got, ref)


def test_emulated_backward_sums_in_two_fixed_stages(fake):
    """dq's tile shares and the bias sums go through ``_grad.sum_groups``:
    runs of K3_SUM_GROUP partials, then the runs (every call to the reduce
    entry is such a stage, never a chain over all tiles at once)."""
    M, hd, H = 11, 32, 2
    j, t = _inputs(8, M, hd, None, xlen=[150, 150])
    out, stats = ma._mha_fwd_card(*t, H, 0.0, None, True, None)
    seen = []
    reduce = fake.fk_reduce

    def spy(src, G, P, *rest):
        seen.append(P)
        return reduce(src, G, P, *rest)

    fake.fk_reduce = spy
    ma._mha_bwd_card(*t, stats, out, torch.ones_like(t[0]), H, None)
    # n_t = 3 tiles a video in one run of 16 slots: dq (16 then 1), the bias
    # sums over both videos' 32 slots (16 then 2), the weight products' chunks
    assert seen[-4:] == [ma.K3_SUM_GROUP, 1, ma.K3_SUM_GROUP, 2]


def test_k3_takes_200_queries_and_states_its_limits():
    """M=200 at E=256, H=8 (egoprocel) has a forward and a backward; the
    limits are the blocks' shared memory."""
    assert ma.has_forward(200, 256, 8) and ma.has_backward(200, 256, 8)
    assert ma.bwd_key_tile(200, 256, 8) == 64 and ma.bwd_key_tile(200, 512, 8) == 32
    assert ma.has_forward(763, 512, 8) and not ma.has_forward(764, 512, 8)
    assert ma.has_backward(437, 256, 8) and not ma.has_backward(438, 256, 8)
    assert ma.has_backward(281, 512, 8) and not ma.has_backward(282, 512, 8)
    assert ma.attn_smem(200, 32) == 4 * (200 * 32 + 64 * 33 + 64 * 32 + 16 * 64)


def test_k3_refuses_before_any_launch(monkeypatch):
    """Off the CPU a shape outside the limits raises NotImplementedError
    naming it before the library is asked for (meta tensors for the card's)."""
    def no_lib():
        raise AssertionError("the kernel library was asked for")

    monkeypatch.setattr(_build, "lib", no_lib)
    meta = lambda *s: torch.empty(s, device="meta")  # noqa: E731
    x_len = torch.empty((2,), dtype=torch.int32, device="meta")
    E, Cx = 256, 64
    with pytest.raises(NotImplementedError, match="M=2000, E=256"):
        ma.mha_cross_fwd(meta(2, 2000, E), meta(2, 300, Cx), None, meta(Cx, E), meta(E),
                         meta(Cx, E), meta(E), x_len, num_heads=8)
    with pytest.raises(NotImplementedError, match="Cx=66"):
        ma.mha_cross_fwd(meta(2, 40, E), meta(2, 300, 66), None, meta(66, E), meta(E),
                         meta(66, E), meta(E), x_len, num_heads=8)
    with pytest.raises(NotImplementedError, match="M=500, E=256"):
        ma.mha_cross_bwd(meta(2, 500, E), meta(2, 300, Cx), None, meta(Cx, E), meta(E),
                         meta(Cx, E), meta(E), x_len, meta(2, 8 * 500, 2), meta(2, 500, E),
                         meta(2, 500, E), num_heads=8)


# ---------------------------------------------------------------------------
# EgoProceL: the configuration and a narrow model of its shape against JAX

_PALLAS = ("pallas", "pallas_attn", "pallas_sa")


def test_egoprocel_cfg_equals_the_yaml(monkeypatch):
    from fact_clip_tpu.configs.utils import setup_cfg
    from fact_clip_tpu.models import blocks as jblocks
    from fact_clip_tpu_torch.configs import (egoprocel_cfg, egoprocel_train_cfg,
                                             resolve_block_cfgs)

    monkeypatch.setattr(jblocks, "_PALLAS_PLATFORM_OVERRIDE", "tpu")
    jcfg = setup_cfg([os.path.join(REPO, "fact_clip_tpu", "configs", "egoprocel.yaml")])
    ref = jblocks.resolve_block_cfgs(jcfg)
    cfg = egoprocel_cfg()
    got = resolve_block_cfgs(cfg)
    strip = lambda c: {k: v for k, v in dataclasses.asdict(c).items() if k not in _PALLAS}  # noqa: E731
    assert [strip(c) for c in got] == [strip(c) for c in ref]
    assert [(c.kind, c.f, c.f_dim, c.a_dim, c.hid_dim, c.a) for c in got] == \
        [("i", "m2", 256, 256, 512, "sca")] + [("U", "m2", 256, 256, 512, "sa")] * 3
    for key in ("ntoken", "block", "fpos", "cmr", "mwt", "trans"):
        assert cfg["FACT"][key] == jcfg.FACT[key], key
    for key in ("pc", "a2fc", "match", "bgw", "nullw", "sw", "ref_weight_order"):
        assert cfg["Loss"][key] == jcfg.Loss[key], key
    assert cfg["TM"]["use"] == jcfg.TM.use
    for key in ("optimizer", "lr", "lr_decay", "momentum", "weight_decay", "clip_grad_norm",
                "dataset", "batch_size"):
        assert cfg[key] == jcfg[key], key
    train = egoprocel_train_cfg()
    assert train["TPU"]["matcher"] == "host"
    assert resolve_block_cfgs(train) == got
    # the SCA runs K3 at 200 queries over the 512-wide stream
    assert got[0].a_layers == 6 and got[0].a_nhead == 8 and cfg["FACT"]["ntoken"] == 200
    assert ma.has_forward(200, 256, 8) and ma.has_backward(200, 256, 8)


D_E, C_E, S_CAP_E, B_E, T_E, S_E = 12, 5, 24, 2, 96, 8


def _ego_cfgs():
    from __graft_entry__ import _make_cfg
    from fact_clip_tpu_torch.configs import small_cfg

    jcfg = _make_cfg(small=True)
    jcfg.FACT.block, jcfg.FACT.ntoken, jcfg.FACT.cmr, jcfg.FACT.mwt = "iUUU", 200, 0.0, 0.9
    jcfg.Bi.f, jcfg.Bi.dropout, jcfg.Bi.a_layers = "m2", 0.0, 1
    jcfg.Loss.bgw, jcfg.Loss.ref_weight_order = 0.5, True
    jcfg.TPU.matcher = "host"
    cfg = small_cfg()
    cfg["FACT"].update(block="iUUU", ntoken=200, cmr=0.0, mwt=0.9)
    cfg["Bi"].update(f="m2", dropout=0.0, a_layers=1)
    cfg["Loss"].update(bgw=0.5, ref_weight_order=True)
    cfg["TPU"]["matcher"] = "host"
    return jcfg, cfg


@pytest.fixture(scope="module")
def ego_run():
    from __graft_entry__ import _make_batch
    from fact_clip_tpu.models import blocks as jblocks
    from fact_clip_tpu.models import losses as jl
    from fact_clip_tpu.models import matching as jm
    from fact_clip_tpu.utils.torch_import import convert_fact_state_dict
    from fact_clip_tpu_torch.models.blocks import build_fact

    jcfg, cfg = _ego_cfgs()
    model = jblocks.build_fact(jcfg, D_E, C_E, s_pred_cap=S_CAP_E)
    batch = _make_batch(np.random.default_rng(0), B_E, T_E, D_E, C_E, S_E)
    port = build_fact(cfg, D_E, C_E, S_CAP_E, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    params = convert_fact_state_dict({k: v.numpy() for k, v in port.state_dict().items()},
                                     jblocks.resolve_block_cfgs(jcfg))
    cweight = jl.build_class_weights(jcfg, C_E, [0])

    def loss_fn(params):
        saves, _ = model.apply({"params": params}, batch["feats"], batch["mask"],
                               batch["lengths"], train=True,
                               rngs={"dropout": jax.random.PRNGKey(1),
                                     "aug": jax.random.PRNGKey(2)})
        last = saves[-1]
        seg2tok = jm.match(jcfg.Loss, jax.nn.softmax(last["action_clogit"], axis=-1),
                           last["a2f_attn"], batch["transcript"], batch["seg_label"],
                           batch["seg_mask"], batch["mask"], matcher="host", nclasses=C_E)
        per_video = jl.fact_loss(saves, batch, seg2tok, jnp.asarray(cweight), float(jcfg.Loss.sw),
                                 ref_weight_order=True)
        return per_video.mean(), (per_video, seg2tok)

    loss, (per_video, seg2tok) = loss_fn(params)
    saves, _ = model.apply({"params": params}, batch["feats"], batch["mask"], batch["lengths"],
                           train=False)
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return dict(cfg=cfg, params=tree(params), cweight=cweight,
                batch={k: np.array(v) for k, v in batch.items()},
                per_video=np.asarray(per_video), seg2tok=np.asarray(seg2tok),
                saves=[{k: np.asarray(v) for k, v in s.items() if k != "kind"} for s in saves])


def test_egoprocel_shaped_model_matches_jax_forward_and_loss(ego_run):
    """A narrow ``iUUU`` with 200 action tokens, ``f: m2`` towers, o2o
    matching with bgw 0.5 and ``ref_weight_order`` (the egoprocel recipe at
    ``_make_cfg(small=True)``'s widths) through the bridge: every block's
    outputs on valid frames (1e-4 absolute) and one train step's loss (1e-4
    relative) and matching (equal) against the JAX model."""
    from fact_clip_tpu_torch.engine.steps import make_train_step
    from fact_clip_tpu_torch.engine.train_loop import batch_to_device
    from fact_clip_tpu_torch.models.blocks import build_fact
    from fact_clip_tpu_torch.utils.bridge import load_jax_params

    run = ego_run
    model = build_fact(run["cfg"], D_E, C_E, S_CAP_E, device="cpu")
    load_jax_params(model, run["params"])
    assert model.action_query.shape[0] == 200
    x = [torch.from_numpy(run["batch"][k]) for k in ("feats", "mask", "lengths")]
    with torch.no_grad():
        saves, _ = model(*x)
    mask = run["batch"]["mask"]
    for i, (sp, sj) in enumerate(zip(saves, run["saves"])):
        for key in ("frame_clogit", "action_clogit", "a2f_attn"):
            if key not in sj:
                continue
            got, ref = sp[key].numpy(), sj[key]
            assert got.shape == ref.shape, (i, key)
            if key != "action_clogit":
                got, ref = got[mask], ref[mask]
            np.testing.assert_allclose(got, ref, atol=1e-4, err_msg=f"block {i} {key}")
    step = make_train_step(model, run["cfg"], C_E, run["cweight"])
    per_video, seg2tok, _ = step.loss(batch_to_device(run["batch"], "cpu"),
                                      torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(seg2tok.numpy(), run["seg2tok"])
    np.testing.assert_allclose(per_video.detach().numpy(), run["per_video"], rtol=1e-4)
    assert math.isfinite(float(per_video.detach().mean()))
