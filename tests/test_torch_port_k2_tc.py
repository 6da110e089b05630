"""K2's flash backward on the port's tensor-core GEMM, and the x_len = 0 rule
of K2 and K3, on the CPU.

K2's flash backward on the card is K3's split at one head: the projection
[xk | xv] recomputed by the towers' 3xTF32 GEMM (``fk_k6_gemm``, epilogue
kProj with the key's positional table from a kMasked GEMM), the attention
terms per 64-key tile (``fk_x2y_flash_attn_bwd``, ``csrc/x2y_bwd.cu``:
dkv = [dxk | dxv], dyq's tile shares and the bias column sums), dx as one
more GEMM (K = 2d), [dWk | dWv] on ``fk_k6_wgrad`` (x_pos^T of the batch's
dxk where x_pos is shared) and the two-stage fixed-order sums.  Here,
without a card, ``FakeK2Lib`` (``FakeK3Lib`` of ``test_torch_port_k3_tc.py``
and the attention-backward entry, on the raw memory of CPU tensors, with
the kernel's tiles, skips and partial layouts) stands in for the library;
the port's launch sequence (``_x2y_flash_bwd_card``) is held against
``jax.vjp`` of JAX's ``x2y_attention`` in interpret mode at X > 1024 (its
``_flash_vjp``: the fused Pallas backward where x_pos is shared) and
against the f32 plain version: M = 11, 40, 64, Cx = d = 48, ragged x_len (a
key tile wholly past one video), no and a shared x_pos, g_probs and
g_logits non-zero.

A video with no valid key (x_len = 0) attends uniformly to all its X frames
in JAX's kernels and the plain versions (every logit -1e9).  K3's forward
and backward and K2's flash backward give that result: the fake library's
launch sequences at x_len = 0 against JAX in interpret mode where X is a
multiple of JAX's key tile.  Where it is not, JAX's kernels also weigh their
zero-padded key rows (the bias rows) at x_len = 0, and the port follows
JAX's plain versions (``_mha_reference``, ``_flash_bwd_xla``), whose softmax
runs over the X frames only.  The -1e9 logits are constants: no gradient
reaches q or the keys through them, as ``jax.vjp`` of the plain versions and
JAX's flash backward give; JAX's fused K3 backward leaves its dl unmasked
and so differs from its own forward's derivative at x_len = 0 only.

Tolerance: 2e-5 of max(1, the reference's largest value), as in K3's file:
the split keeps ~2^-22 of each product, f32 sums in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_k3_tc import FakeK3Lib, _ints, _view

from fact_clip_tpu.ops.pallas.mha_attn import _mha_reference, mha_cross_attention
from fact_clip_tpu.ops.pallas.x2y_attn import _flash_bwd_xla, x2y_attention
from fact_clip_tpu_torch import _build
from fact_clip_tpu_torch.ops import dilated_conv as dc
from fact_clip_tpu_torch.ops import mha_attn as ma
from fact_clip_tpu_torch.ops import x2y_attn as xa

torch.set_num_threads(2)
TOL = 2e-5
CX = D = 48  # one and a half 32-float K steps
CY = 40


class FakeK2Lib(FakeK3Lib):
    """``FakeK3Lib`` and K2's flash attention-backward entry: per (64-key
    tile, video) dkv rows, dyq's tile share and the bias sums in the
    kernel's layouts; a tile wholly past x_len writes zeros unless the video
    has no valid key."""

    def fk_x2y_flash_attn_bwd(self, kv, probs, gprobs, glogits, gattn, yq, Dr, xlen, B, X_, M,
                              d, scale, dkv, part_dyq, part_b, n_slots, stream):
        self.calls.append(("x2y_flash_attn_bwd",))
        T = xa.FLASH_KEY_TILE
        n_t = -(-X_ // T)
        assert M <= xa.FLASH_MAX_QUERIES and d % 4 == 0 and n_slots >= n_t
        KV = _view(kv, B * X_ * 2 * d).view(B, X_, 2 * d)
        P = _view(probs, B * M * X_).view(B, M, X_)
        zeros = torch.zeros(B, M, X_)
        GP = _view(gprobs, B * M * X_).view(B, M, X_) if gprobs is not None else zeros
        GL = _view(glogits, B * M * X_).view(B, M, X_) if glogits is not None else zeros
        GA = _view(gattn, B * M * d).view(B, M, d)
        YQ = _view(yq, B * M * d).view(B, M, d)
        DR = _view(Dr, B * M).view(B, M)
        DKV = _view(dkv, B * X_ * 2 * d).view(B, X_, 2 * d)
        PQ = _view(part_dyq, B * n_slots * M * d).view(B, n_slots, M, d)
        PB = _view(part_b, B * n_slots * 2 * d).view(B, n_slots, 2 * d)
        lens = _ints(xlen, B)
        for b in range(B):
            xl = min(int(lens[b]), X_)
            for t in range(n_t):
                keys = torch.arange(t * T, min((t + 1) * T, X_))
                if xl > 0 and t * T >= xl:  # probs and dlogits 0 on every key
                    DKV[b, keys] = 0.0
                    PQ[b, t] = 0.0
                    PB[b, t] = 0.0
                    continue
                xk, xv = KV[b, keys, :d], KV[b, keys, d:]
                p = P[b][:, keys]
                dp = GA[b] @ xv.t() + GP[b][:, keys]
                dl = p * (dp - DR[b][:, None]) + GL[b][:, keys]
                dl = torch.where(keys[None] < xl, dl * scale, 0.0)
                dxk, dxv = dl.t() @ YQ[b], p.t() @ GA[b]
                DKV[b, keys] = torch.cat([dxk, dxv], 1)
                PQ[b, t] = dl @ xk
                PB[b, t] = torch.cat([dxk.sum(0), dxv.sum(0)])
        return 0


@pytest.fixture
def fake(monkeypatch):
    lib = FakeK2Lib()
    monkeypatch.setattr(_build, "lib", lambda: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    return lib


def _pair(rng, shape, scale=1.0):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _x2y_inputs(seed, M, X, xlen, x_pos):
    """(jax list, torch list) of x2y_attention's arguments: y (B, M, CY) with
    a shared y_pos, x (B, X, CX), x_pos None (JAX: zeros) or shared."""
    rng = np.random.default_rng(seed)
    B = len(xlen)
    y, yp, x = _pair(rng, (B, M, CY)), _pair(rng, (1, M, CY), 0.5), _pair(rng, (B, X, CX))
    xp = _pair(rng, (1, X, CX), 0.5) if x_pos else None
    w = [_pair(rng, (CX, D), 0.15), _pair(rng, (D,), 0.05), _pair(rng, (CX, D), 0.15),
         _pair(rng, (D,), 0.05), _pair(rng, (CY, D), 0.15), _pair(rng, (D,), 0.05)]
    xl = np.array(xlen, np.int32)
    zeros = jnp.zeros((1, X, CX), jnp.float32)
    j = [y[0], yp[0], x[0], zeros if xp is None else xp[0], *[a[0] for a in w], jnp.asarray(xl)]
    t = [y[1], yp[1], x[1], None if xp is None else xp[1], *[a[1] for a in w],
         torch.from_numpy(xl)]
    return j, t


def _close(got, ref, tol=TOL, what=""):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, what
    scale = max(1.0, float(np.abs(ref).max()))
    assert float(np.abs(got - ref).max()) <= tol * scale, (what, float(np.abs(got - ref).max()))


GRADS = ("d_y", "d_ypos", "d_x", "d_xpos", "d_wk", "d_bk", "d_wv", "d_bv", "d_wq", "d_bq")


def _x2y_vjp(j, rng):
    """JAX's forward (interpret mode) and the cotangents of all ten float
    inputs for seeded (g_attn, g_probs, g_logits)."""
    def f(*a):
        return x2y_attention(*a, j[10], interpret=True)

    outs, vjp = jax.vjp(f, *j[:10])
    g = [(rng.standard_normal(o.shape) * s).astype(np.float32)
         for o, s in zip(outs, (1.0, 0.1, 0.1))]
    return [np.array(o) for o in outs], g, vjp(tuple(jnp.asarray(a) for a in g))


def _run_bwd(t, outs, g):
    attn, probs = torch.from_numpy(outs[0]), torch.from_numpy(outs[1])
    gt = [torch.from_numpy(a) for a in g]
    return xa._x2y_flash_bwd_card(*t, probs, attn, *gt, True), (probs, attn, gt)


def _calls(fake, x_pos):
    table = [("gemm", dc._MASKED)] if x_pos else []
    wgrads = [("wgrad", 1)] * (2 if x_pos else 1)
    return table + [("gemm", dc._PROJ), ("x2y_flash_attn_bwd",), ("gemm", dc._MASKED)] + wgrads


@pytest.mark.parametrize("M,x_pos", [(11, True), (40, False), (64, True)])
def test_emulated_flash_backward_matches_jax_vjp(fake, M, x_pos):
    """The flash backward's launches from JAX's forward saves against
    ``jax.vjp`` of JAX's flash form in interpret mode (its fused backward
    where x_pos is shared) and against the plain backward: every cotangent
    (d_xpos None where there is no x_pos, as the entry returns)."""
    X, xlen = 1100, [1100, 600]  # keys 640-1099 of the second video: tiles wholly past it
    j, t = _x2y_inputs(1, M, X, xlen, x_pos)
    outs, g, refs = _x2y_vjp(j, np.random.default_rng(2))
    got, (probs, attn, gt) = _run_bwd(t, outs, g)
    assert [c for c in fake.calls if c[0] != "reduce"] == _calls(fake, x_pos)
    plain = xa.x2y_bwd_reference(*t, probs, *gt)
    for i, name in enumerate(GRADS):
        if not x_pos and name == "d_xpos":
            assert got[i] is None and plain[i] is None
            continue
        _close(got[i].numpy(), refs[i], what=name)
        _close(got[i].numpy(), plain[i].numpy(), what=name)


def test_emulated_flash_backward_gives_the_same_bits_twice(fake):
    """dyq's tile shares and the bias sums go through two fixed-order stages
    (runs of FLASH_SUM_GROUP slots, then the runs), and nothing else sums
    across blocks: two runs on the same inputs give the same bits."""
    j, t = _x2y_inputs(3, 40, 1100, [1100, 777], True)
    outs, g, _ = _x2y_vjp(j, np.random.default_rng(4))
    seen = []
    reduce = fake.fk_reduce

    def spy(src, G, P, *rest):
        seen.append(P)
        return reduce(src, G, P, *rest)

    fake.fk_reduce = spy
    first, _ = _run_bwd(t, outs, g)
    # 18 tiles a video in two runs of 16 slots: dyq (16 then 2), the bias
    # sums over both videos' 64 slots (16 then 4)
    assert seen[-4:] == [xa.FLASH_SUM_GROUP, 2, xa.FLASH_SUM_GROUP, 4]
    second, _ = _run_bwd(t, outs, g)
    for name, a, b in zip(GRADS, first, second):
        assert torch.equal(a, b), name


def test_flash_backward_limits():
    """M up to 64 query rows at any d (the attention's panels are 64 wide,
    d runs in column chunks); the small-X form's limit is its (64, d) panel."""
    assert xa.has_backward(64, 4096, 512) and not xa.has_backward(65, 4096, 512)
    assert xa.has_backward(60, 4096, 1024) and xa.has_backward(40, 3072, 512)
    assert xa.has_backward(4096, 60, 512) and not xa.has_backward(4096, 60, 4096)


def test_emulated_flash_backward_refuses_before_any_launch(monkeypatch):
    """A per-video x_pos (JAX's plain backward runs there) and M > 64 raise
    ValueError before the library is asked for (meta tensors for the card's)."""
    def no_lib():
        raise AssertionError("the kernel library was asked for")

    monkeypatch.setattr(_build, "lib", no_lib)
    meta = lambda *s: torch.empty(s, device="meta")  # noqa: E731
    x_len = torch.empty((2,), dtype=torch.int32, device="meta")
    for M, xpos in ((40, meta(2, 2000, D)), (65, None)):
        args = (meta(2, M, CY), None, meta(2, 2000, CX), xpos, meta(CX, D), meta(D),
                meta(CX, D), meta(D), meta(CY, D), meta(D), x_len, meta(2, M, 2000),
                meta(2, M, D), meta(2, M, D))
        with pytest.raises(ValueError, match="x2y_flash_bwd"):
            xa.x2y_flash_bwd(*args)


# ---------------------------------------------------------------------------
# x_len = 0: every key's logit -1e9, so the video attends to all its frames


def test_emulated_flash_backward_at_x_len_0_matches_jax(fake):
    """K2's flash backward with one video that has no valid key: against
    ``jax.vjp`` of JAX's flash form at X = 1536 (three of its 512-key
    tiles) and against the plain backward; JAX's forward probabilities are
    uniform there, and dxv, dx, dWv and dbv take every frame of it."""
    X = 1536
    j, t = _x2y_inputs(5, 11, X, [X, 0], True)
    outs, g, refs = _x2y_vjp(j, np.random.default_rng(6))
    np.testing.assert_allclose(outs[1][1], 1.0 / X, rtol=1e-6)
    got, (probs, attn, gt) = _run_bwd(t, outs, g)
    plain = xa.x2y_bwd_reference(*t, probs, *gt)
    for i, name in enumerate(GRADS):
        _close(got[i].numpy(), refs[i], what=name)
        _close(got[i].numpy(), plain[i].numpy(), what=name)
    dx = got[2].numpy()[1]
    assert np.abs(dx[-64:]).max() > 1e-3  # the video's last tile is not skipped


def _k3_inputs(seed, X, xlen, M=11, H=2, hd=32):
    rng = np.random.default_rng(seed)
    B, E = len(xlen), H * hd
    q, x, p = _pair(rng, (B, M, E)), _pair(rng, (B, X, CX)), _pair(rng, (1, X, CX), 0.5)
    wk, bk = _pair(rng, (CX, E), 0.15), _pair(rng, (E,), 0.05)
    wv, bv = _pair(rng, (CX, E), 0.15), _pair(rng, (E,), 0.05)
    xl = np.array(xlen, np.int32)
    j = [q[0], x[0], p[0], wk[0], bk[0], wv[0], bv[0], jnp.asarray(xl)]
    t = [q[1], x[1], p[1], wk[1], bk[1], wv[1], bv[1], torch.from_numpy(xl)]
    return j, t


@pytest.mark.parametrize("xlen", [[256, 0], [0, 0]])
def test_emulated_k3_at_x_len_0_matches_jax(fake, xlen):
    """K3's forward and backward with videos that have no valid key: the
    fake library's launch sequences against JAX's forward kernel in
    interpret mode (X = 256, two of its 128-key tiles), the output of such a
    video the mean of its value rows; the backward against ``jax.vjp`` of
    JAX's ``_mha_reference`` (the same math), where the constant -1e9 logits
    carry no gradient to q and K.  JAX's fused backward kernel leaves its dl
    unmasked (p is 0 past x_len when x_len > 0), so at x_len = 0 its dq and dK
    are p (dp - D) K and q, not the derivative of its forward; the port
    follows the derivative, as its plain versions do."""
    X, H = 256, 2
    j, t = _k3_inputs(7, X, xlen)
    g = np.random.default_rng(8).standard_normal(t[0].shape).astype(np.float32)
    out_j = mha_cross_attention(*j, num_heads=H, tile=128, interpret=True)

    def f(q, x, wk, bk, wv, bv):
        return _mha_reference(q, x, j[2], wk, bk, wv, bv, j[7], None, H)

    _, vjp = jax.vjp(f, j[0], j[1], *j[3:7])
    refs = vjp(jnp.asarray(g))
    out, stats = ma._mha_fwd_card(*t, H, 0.0, None, True, None)
    _close(out.numpy(), out_j, what="out")
    plain, plain_st = ma.mha_cross_attention_reference(*t, num_heads=H, with_stats=True)
    _close(out.numpy(), plain.numpy(), what="out")
    _close(stats.numpy(), plain_st.numpy(), what="stats")
    v_mean = (t[1][1] @ t[5] + t[6]).mean(0)
    _close(out.numpy()[1], np.broadcast_to(v_mean.numpy(), out.shape[1:]), what="mean of v")
    got = ma._mha_bwd_card(*t, stats, out, torch.from_numpy(g), H, None)
    names = ("dq", "dx", "dWk", "dbk", "dWv", "dbv")
    plain_b = ma.mha_cross_bwd_reference(*t, stats, out, torch.from_numpy(g), num_heads=H)
    for name, a, r, p in zip(names, [got[0], got[1], *got[3:]], refs,
                             [plain_b[0], plain_b[1], *plain_b[3:]]):
        _close(a.numpy(), np.asarray(r), what=name)
        _close(a.numpy(), p.numpy(), what=name)
    assert float(got[0][1].abs().max()) == 0.0  # no gradient through the masked logits

    def k(q, x, wk, bk, wv, bv):
        return mha_cross_attention(q, x, j[2], wk, bk, wv, bv, j[7], num_heads=H, tile=128,
                                   interpret=True, pos_grad=False)

    dq_kernel = jax.vjp(k, j[0], j[1], *j[3:7])[1](jnp.asarray(g))[0]
    assert float(np.abs(np.asarray(dq_kernel)[1]).max()) > 1e-3  # JAX's unmasked dl


def test_emulated_k3_at_x_len_0_with_a_ragged_x_follows_the_plain_version(fake):
    """X = 150 (not a multiple of JAX's 128-key tile) at x_len = 0 with
    dropout 0.2: the port against JAX's plain ``_mha_reference`` given the
    same mask (the softmax over the 150 frames) and the port's plain
    version; JAX's kernel there also weighs its 106 zero-padded key rows,
    whose values are the bias bv."""
    from fact_clip_tpu_torch.ops.dropout import dropout_mask_reference

    X, H, M = 150, 2, 11
    j, t = _k3_inputs(9, X, [150, 0], M)
    seed = torch.tensor([4242], dtype=torch.int32)
    keep = dropout_mask_reference(seed, 0, (2, H * M, X), 0.2)
    got = ma._mha_fwd_card(*t, H, 0.2, seed, False, None)
    ref_j = _mha_reference(*j, jnp.asarray(keep.numpy().reshape(2, H, M, X)), H)
    _close(got.numpy(), ref_j, what="out")
    _close(got.numpy(), ma.mha_cross_attention_reference(*t, num_heads=H, keep=keep).numpy(),
           what="out")
    kern_j = mha_cross_attention(*j, num_heads=H, tile=128, interpret=True)
    assert float(np.abs(np.asarray(kern_j)[1] - ref_j[1]).max()) > 1e-3  # JAX's padded rows


def test_x2y_plain_backward_at_x_len_0_matches_jax_xla():
    """The plain flash backward (the per-video x_pos path on the card) at
    x_len = 0 against JAX's ``_flash_bwd_xla`` on the same saves."""
    X = 1100
    j, t = _x2y_inputs(10, 11, X, [X, 0], True)
    with torch.no_grad():
        attn, probs, _ = xa.x2y_attention_reference(*t)
    rng = np.random.default_rng(11)
    g = [rng.standard_normal(s).astype(np.float32) * c
         for s, c in ((attn.shape, 1.0), (probs.shape, 0.1), (probs.shape, 0.1))]
    res = (*j[:8], (j[8], j[9], j[10]), jnp.asarray(probs.numpy()), jnp.asarray(attn.numpy()))
    ref = _flash_bwd_xla(res, tuple(jnp.asarray(a) for a in g), D)
    refs = list(ref[:8]) + [ref[8][0], ref[8][1]]
    got = xa.x2y_bwd_reference(*t, probs, *[torch.from_numpy(a) for a in g])
    for name, a, r in zip(GRADS, got, refs):
        _close(a.numpy(), np.asarray(r), what=name)
