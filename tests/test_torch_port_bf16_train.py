"""bf16 training (``TPU.compute_dtype: bfloat16``) in the port, on the CPU.

The port's plain versions of the bf16 backward forms (what the kernel
wrappers and the autograd Functions run on CPU tensors) are held against
``jax.vjp`` of JAX's own bf16 forms, their Pallas kernels in interpret mode
as ``tests/test_torch_port_bf16.py`` runs the forwards: K1's tower, K2's
small-X and flash forms (each with a shared and with a per-video
positional table: both branches of JAX's dispatch), K3, K4's SA and FFN
sublayers.  Then the device matcher (``ops/assignment.py``) against JAX's
auction on the cost families of ``tests/test_matching.py``; a narrow bf16
``iuUU`` train step against JAX's ``make_step_fns`` with ``matcher:
auction``; and ``run_train`` on ``havid_tpu.yaml`` over a fixture set with
a resume, its checkpoint read by JAX's model.

Tolerances (each against JAX's value, of the reference's largest magnitude
unless said otherwise):
* a form's cotangents: 2^-7 (one bf16 ulp at the scale) for K2, K3 and K4,
  whose roundings are one bf16 rounding of an f32 sum formed in another
  order; K1's 3-layer tower 2^-6 (a rounded stream cotangent flips a ulp
  and carries it through the layers below);
* a weight gradient JAX rounds to bf16 is checked to hold a bf16 value;
* auction assignments: equal to JAX's, prices too (bit for bit);
* the narrow train step: equal seg2tok, the loss within 1e-4 relative, each
  parameter's gradient within 2e-2 of its own scale and a cosine of at least
  0.9999 with JAX's (against ``tests/test_mixed_precision.py``'s bf16-vs-f32
  bounds of 0.03 on the loss and cosine 0.99); a key projection's bias
  gradient, which cancels to about 0, read against its weight's scale.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fact_clip_tpu.models import matching as jmatching
from fact_clip_tpu.ops import assignment as jassign
from fact_clip_tpu.ops.pallas import dilated_conv as jdc
from fact_clip_tpu.ops.pallas import frame_loss as jfl
from fact_clip_tpu.ops.pallas import mha_attn as jmha
from fact_clip_tpu.ops.pallas import sa_layer as jsa
from fact_clip_tpu.ops.pallas import x2y_attn as jx2y
from fact_clip_tpu_torch.models import matching as pmatching
from fact_clip_tpu_torch.ops import assignment as passign
from fact_clip_tpu_torch.ops import dilated_conv as dc
from fact_clip_tpu_torch.ops import mha_attn as ma
from fact_clip_tpu_torch.ops import sa_layer as sl
from fact_clip_tpu_torch.ops import x2y_attn as xa

torch.set_num_threads(2)
BF = jnp.bfloat16


@pytest.fixture(autouse=True)
def _two_threads():
    """Each test at two intra-op threads: in a whole run the module-level
    setting is overwritten by whichever test module is imported last, and
    the sums' order (so a bf16 rounding here and there) follows the count."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
FORM_TOL = 2.0 ** -7
TOWER_TOL = 2.0 ** -6


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        jnp.asarray(t).astype(jnp.float32))


def _rel(got, ref):
    got, ref = _np(got), _np(ref)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _is_bf16_valued(t):
    return torch.equal(t, t.to(torch.bfloat16).float())


def _pair16(rng, shape, scale=1.0):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    j = jnp.asarray(a).astype(BF)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)


def _pair(rng, shape, scale=1.0):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _check(names, got, ref, tol, scales=None):
    """Each cotangent within tol of its reference's scale (or of the scale
    ``scales`` names for it: a sum that cancels to about 0, as dbk, whose
    value is the roundings' noise, is read against a neighbour's scale)."""
    for name, g, r in zip(names, got, ref):
        if r is None:
            continue
        assert g is not None, name
        scale = np.abs(_np(dict(zip(names, ref))[scales[name]])).max() if scales and \
            name in scales else np.abs(_np(r)).max()
        err = float(np.abs(_np(g) - _np(r)).max() / max(scale, 1e-30))
        assert err <= tol, (name, err)


# ---------------------------------------------------------------------------
# the bf16 backward forms against jax.vjp of JAX's bf16 forms (interpret mode)


@pytest.mark.parametrize("L", [1, 3])
def test_k1_bwd_matches_jax_vjp(L):
    """K1's bf16 backward (``mstcn_stack16_bwd_reference``) against the
    vjp of ``dilated_residual_stack`` on bf16 x, Wd, W1 and Wo: C=32, O=16,
    ragged lengths with a video of 0 frames; dx bf16, dWd, dW1 and dWo bf16
    values, the biases f32."""
    rng = np.random.default_rng(10 + L)
    B, T, C, O = 3, 200, 32, 16
    x_j, x_t = _pair16(rng, (B, T, C))
    lengths = np.array([T, 133, 0], np.int32)
    mask = np.arange(T)[None] < lengths[:, None]
    dil = [2 ** i for i in range(L)]
    layers = [[_pair(rng, (3, C, C), 1.0 / np.sqrt(3 * C)), _pair(rng, (C,), 0.1),
               _pair(rng, (C, C), 1.0 / np.sqrt(C)), _pair(rng, (C,), 0.1)] for _ in range(L)]
    (ow_j, ow_t), (ob_j, ob_t) = _pair(rng, (C, O), 1.0 / np.sqrt(C)), _pair(rng, (O,), 0.1)
    g_j, g_t = _pair(rng, (B, T, O))
    ones, zeros = jnp.ones(C), jnp.zeros(C)

    def fwd(x, wds, bds, w1s, b1s, ow, ob):
        jl = [(wd, bd, w1, b1, ones, zeros) for wd, bd, w1, b1 in zip(wds, bds, w1s, b1s)]
        return jdc.dilated_residual_stack(x, jnp.asarray(mask), jl, dil, use_ln=False,
                                          out_params=(ow, ob), interpret=True)

    prim = (x_j, [l[0][0].astype(BF) for l in layers], [l[1][0] for l in layers],
            [l[2][0].astype(BF) for l in layers], [l[3][0] for l in layers], ow_j.astype(BF),
            ob_j)
    _, vjp = jax.vjp(fwd, *prim)
    dx_j, dwd_j, dbd_j, dw1_j, db1_j, dow_j, dob_j = vjp(g_j)
    assert dx_j.dtype == BF and dwd_j[0].dtype == BF and dw1_j[0].dtype == BF
    assert dow_j.dtype == BF and dbd_j[0].dtype == jnp.float32

    tl = [(l[0][1], l[1][1], l[2][1], l[3][1], torch.ones(C), torch.zeros(C)) for l in layers]
    lens = torch.from_numpy(lengths)
    _, streams, acts = dc.mstcn_stack16_reference(x_t, lens, tl, dil, out_w=ow_t, out_b=ob_t,
                                                  save=True)
    dx, dl, dow, dob = dc.mstcn_stack16_bwd_reference(g_t, streams, acts, lens, tl, dil,
                                                      out_w=ow_t, out_b=ob_t)
    assert dx.dtype == torch.bfloat16 and not dx.float().numpy()[~mask].any()
    for d in dl:
        assert _is_bf16_valued(d[0]) and _is_bf16_valued(d[2]) and d[1].dtype == torch.float32
    assert _is_bf16_valued(dow)
    tol = FORM_TOL if L == 1 else TOWER_TOL
    _check(["dx", "dow", "dob"], [dx, dow, dob], [dx_j, dow_j, dob_j], tol)
    for i in range(L):
        _check([f"dwd{i}", f"dbd{i}", f"dw1{i}", f"db1{i}"],
               [dl[i][0], dl[i][1], dl[i][2], dl[i][3]],
               [dwd_j[i], dbd_j[i], dw1_j[i], db1_j[i]], tol)


def _x2y_case(seed, X, batched):
    """K2's bf16 inputs: y, x and the positional tables bf16, the weights f32
    (JAX takes them cast to bf16), and the three output cotangents."""
    rng = np.random.default_rng(seed)
    flash = X >= xa.FLASH_MIN_KEYS
    B, Y, C, d = 3, 40 if flash else 96, 32, 32
    y = _pair16(rng, (B, Y, C))
    x = _pair16(rng, (B, X, C))
    yp = _pair16(rng, (B if batched and not flash else 1, Y, C), 0.5)
    xp = _pair16(rng, (B if batched and flash else 1, X, C), 0.5)
    w = [_pair(rng, s, sc) for s, sc in (((C, d), 0.2), ((d,), 0.1), ((C, d), 0.2), ((d,), 0.1),
                                         ((C, d), 0.2), ((d,), 0.1))]
    # JAX's flash kernel attends to its padded key rows where x_len is 0 (the
    # port, as JAX's plain version, to the X frames): x_len > 0 there
    x_len = np.array([X, X // 2 + 1, 7 if flash else 0], np.int32)
    g = [_pair(rng, (B, Y, d)), _pair(rng, (B, Y, X), 0.1), _pair(rng, (B, Y, X), 0.1)]
    return y, yp, x, xp, w, x_len, g


@pytest.mark.parametrize("X,batched", [(40, False), (40, True), (1100, False), (1100, True)])
def test_k2_bwd_matches_jax_vjp(X, batched):
    """Both of K2's forms' bf16 backward (``x2y16_bwd_reference``) against the
    vjp of ``x2y_attention`` on bf16 inputs, in each branch of JAX's dispatch:
    the kernel with the shared table (y_pos for small X, x_pos for flash),
    JAX's own plain backward with a per-video one.  dy, dx bf16; dWk, dWv,
    dWq bf16 values; the biases and positional cotangents f32."""
    (y_j, y_t), (yp_j, yp_t), (x_j, x_t), (xp_j, xp_t), w, x_len, g = _x2y_case(X, X, batched)
    jw = [w[i][0].astype(BF) if i % 2 == 0 else w[i][0] for i in range(6)]
    xl = jnp.asarray(x_len)

    def fwd(y, yp, x, xp, wk, bk, wv, bv, wq, bq):
        return jx2y.x2y_attention(y, yp, x, xp, wk, bk, wv, bv, wq, bq, xl, interpret=True)

    _, vjp = jax.vjp(fwd, y_j, yp_j, x_j, xp_j, *jw)
    ref = vjp(tuple(p[0] for p in g))
    assert ref[0].dtype == BF and ref[2].dtype == BF and ref[4].dtype == BF
    tw = [p[1] for p in w]
    attn, probs, _ = xa.x2y_attention16_reference(y_t, yp_t, x_t, xp_t, *tw,
                                                  torch.from_numpy(x_len))
    got = xa.x2y16_bwd_reference(y_t, yp_t, x_t, xp_t, *tw, torch.from_numpy(x_len), probs,
                                 attn, *[p[1] for p in g])
    assert got[0].dtype == torch.bfloat16 and got[2].dtype == torch.bfloat16
    for i in (4, 6, 8):
        assert _is_bf16_valued(got[i])
    _check(["dy", "dypos", "dx", "dxpos", "dwk", "dbk", "dwv", "dbv", "dwq", "dbq"], got, ref,
           FORM_TOL)


def test_k3_bwd_matches_jax_vjp():
    """K3's bf16 backward (``mha_cross16_bwd_reference``) against the vjp of
    ``mha_cross_attention`` on bf16 q, x, positional table and weights, hd =
    32: dq, dx bf16, dWk, dWv bf16 values, dbk, dbv f32 (dbk is about 0, the
    rows' sum of dl cancelling: read against dbv's scale).  The videos attend
    to X and X/3 keys: where x_len is 0 JAX's fused backward leaves dl
    unmasked (its plain version, which the port follows, masks it; the next
    test)."""
    rng = np.random.default_rng(3)
    B, M, X, Cx, E, H = 2, 11, 300, 64, 64, 2
    q_j, q_t = _pair16(rng, (B, M, E))
    x_j, x_t = _pair16(rng, (B, X, Cx))
    p_j, p_t = _pair16(rng, (1, X, Cx), 0.5)
    wk, bk, wv, bv = (_pair(rng, (Cx, E), 0.15), _pair(rng, (E,), 0.1),
                      _pair(rng, (Cx, E), 0.15), _pair(rng, (E,), 0.1))
    x_len = np.array([X, X // 3], np.int32)
    g_j, g_t = _pair(rng, (B, M, E))

    def fwd(q, x, wk_, bk_, wv_, bv_):
        return jmha.mha_cross_attention(q, x, p_j, wk_, bk_, wv_, bv_, jnp.asarray(x_len),
                                        num_heads=H, interpret=True)

    _, vjp = jax.vjp(fwd, q_j, x_j, wk[0].astype(BF), bk[0], wv[0].astype(BF), bv[0])
    dq_j, dx_j, dwk_j, dbk_j, dwv_j, dbv_j = vjp(g_j)
    assert dq_j.dtype == BF and dwk_j.dtype == BF and dbk_j.dtype == jnp.float32
    lens = torch.from_numpy(x_len)
    out, stats = ma.mha_cross16_reference(q_t, x_t, p_t, wk[1], bk[1], wv[1], bv[1], lens,
                                          num_heads=H, with_stats=True)
    got = ma.mha_cross16_bwd_reference(q_t, x_t, p_t, wk[1], bk[1], wv[1], bv[1], lens, stats,
                                       out, g_t, num_heads=H)
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.bfloat16 and got[2] is None
    assert _is_bf16_valued(got[3]) and _is_bf16_valued(got[5])
    _check(["dq", "dx", "dwk", "dbk", "dwv", "dbv"], [got[i] for i in (0, 1, 3, 4, 5, 6)],
           [dq_j, dx_j, dwk_j, dbk_j, dwv_j, dbv_j], FORM_TOL, scales={"dbk": "dbv"})


def test_k3_bwd_with_a_video_of_no_keys():
    """A video with x_len 0 attends uniformly to its X frames: its dl is 0
    (the masked logits, as JAX's plain version), so its dq is 0 and its dV
    rows are the uniform weights' product with g; the other video's
    cotangents are those of a batch without it."""
    rng = np.random.default_rng(4)
    B, M, X, Cx, E, H = 2, 11, 64, 32, 64, 2
    q = _pair16(rng, (B, M, E))[1]
    x = _pair16(rng, (B, X, Cx))[1]
    wk, bk, wv, bv = (_pair(rng, (Cx, E), 0.15)[1], _pair(rng, (E,), 0.1)[1],
                      _pair(rng, (Cx, E), 0.15)[1], _pair(rng, (E,), 0.1)[1])
    g = _pair(rng, (B, M, E))[1]
    lens = torch.tensor([X, 0], dtype=torch.int32)
    out, stats = ma.mha_cross16_reference(q, x, None, wk, bk, wv, bv, lens, num_heads=H,
                                          with_stats=True)
    dq, dx, _, dwk, dbk, dwv, dbv = ma.mha_cross16_bwd_reference(
        q, x, None, wk, bk, wv, bv, lens, stats, out, g, num_heads=H)
    assert not dq[1].float().any() and torch.isfinite(dx.float()).all()
    one = ma.mha_cross16_bwd_reference(q[:1], x[:1], None, wk, bk, wv, bv, lens[:1], stats[:1],
                                       out[:1], g[:1], num_heads=H)
    assert torch.equal(dq[:1], one[0]) and torch.equal(dx[:1], one[1])


def _sa_case(seed, B, M, E):
    rng = np.random.default_rng(seed)
    w = lambda *s: _pair(rng, s, 1.0 / np.sqrt(s[0]))  # noqa: E731
    parts = [_pair(rng, (B, M, E)), _pair(rng, (1, M, E), 0.5), w(E, E), _pair(rng, (E,), 0.05),
             w(E, E), _pair(rng, (E,), 0.05), w(E, E), _pair(rng, (E,), 0.05), w(E, E),
             _pair(rng, (E,), 0.05), _pair(rng, (E,), 0.1), _pair(rng, (E,), 0.1)]
    parts[10] = (parts[10][0] + 1.0, parts[10][1] + 1.0)
    return [p[0] for p in parts], [p[1] for p in parts], _pair(rng, (B, M, E))


def test_k4_sa_bwd_matches_jax_vjp():
    """K4's SA bf16 backward (``sa_sublayer16_bwd_reference``) against the vjp
    of ``sa_sublayer(bf16=True)``: B=3, M=11, E=64, H=2; every cotangent f32,
    as JAX's kernel accumulates them.  dbk is 0 in exact arithmetic (each
    row of dS sums to 0), its value the roundings' noise: read against dbq's
    scale."""
    j, t, (g_j, g_t) = _sa_case(7, 3, 11, 64)
    _, vjp = jax.vjp(lambda *a: jsa.sa_sublayer(*a, num_heads=2, bf16=True, interpret=True), *j)
    ref = vjp(g_j)
    got = sl.sa_sublayer16_bwd_reference(*t, g_t, num_heads=2)
    assert all(x.dtype == torch.float32 for x in got)
    _check(["dx", "dpos", "dwq", "dbq", "dwk", "dbk", "dwv", "dbv", "dwo", "dbo", "dls", "dlb"],
           got, ref, FORM_TOL, scales={"dbk": "dbq"})


def test_k4_ffn_bwd_matches_jax_vjp():
    """K4's FFN bf16 backward (``ffn_sublayer16_bwd_reference``) against the
    vjp of ``ffn_sublayer(bf16=True)``: B=3, M=11, E=64, F=128; dW1 from
    bf16(x) and bf16(dz1), every cotangent f32."""
    j, t, (g_j, g_t) = _sa_case(8, 3, 11, 64)
    rng = np.random.default_rng(9)
    E, Fd = 64, 128
    w1, b1, w2, b2 = (_pair(rng, (E, Fd), E ** -0.5), _pair(rng, (Fd,), 0.1),
                      _pair(rng, (Fd, E), Fd ** -0.5), _pair(rng, (E,), 0.1))
    _, vjp = jax.vjp(lambda *a: jsa.ffn_sublayer(*a, bf16=True, interpret=True),
                     j[0], w1[0], b1[0], w2[0], b2[0], j[10], j[11])
    ref = vjp(g_j)
    got = sl.ffn_sublayer16_bwd_reference(t[0], w1[1], b1[1], w2[1], b2[1], t[10], t[11], g_t)
    assert all(x.dtype == torch.float32 for x in got)
    _check(["dx", "dw1", "db1", "dw2", "db2", "dls", "dlb"], got, ref, FORM_TOL)


# ---------------------------------------------------------------------------
# the device matcher against JAX's auction


def _costs(rng):
    """The cost families of tests/test_matching.py, (name, cost (M, S))."""
    M, S = 40, 24
    base = rng.normal(size=(M, S)).astype(np.float32)
    tied = base.copy()
    tied[:, ::2] = tied[:, 1::2][:, : tied[:, ::2].shape[1]]
    dom = np.zeros((M, S), np.float32)
    for s in range(S):
        dom[rng.integers(0, M), s] = -2.0
    dom += rng.normal(size=(M, S)).astype(np.float32) * 1e-4
    spike = base.copy()
    spike[0, 0] = -1e4  # adversarial spreads (epsilon scaling's cases)
    return [("random", base), ("all_equal", np.zeros((M, S), np.float32)),
            ("dup_columns", tied),
            ("near_tie", base + rng.normal(size=(M, S)).astype(np.float32) * 1e-6),
            ("dominant_sparse", dom), ("one_spike", spike),
            ("log_spread_columns", base * np.logspace(0, 4, S, dtype=np.float32)[None, :]),
            ("coarse_grid_micro_ties", np.round(base * 2) * 1e3 + base * 1e-3),
            ("production", (-rng.random(size=(300, 165)) * 1.2).astype(np.float32))]



@pytest.mark.parametrize("phases", [1, 4])
def test_auction_equals_jaxs(phases):
    """``auction_assign`` on a batch of the cost families (phases 1: every
    family, epic's 300 x 165 too; phases 4: the random and the adversarial
    spreads, as tests/test_matching.py runs it): every assignment,
    iteration count and eps bound equal to JAX's ``auction_assign`` run per
    matrix under jit (its vmap's per-video loop), and prices bit for bit."""
    rng = np.random.default_rng(phases)
    for name, cost in _costs(rng):
        if phases > 1 and name not in ("random", "one_spike", "log_spread_columns",
                                       "coarse_grid_micro_ties"):
            continue  # epsilon scaling's cases in tests/test_matching.py
        M, S = cost.shape
        valid = np.ones(S, bool)
        valid[-2:] = False  # masked columns
        st_j, stats_j = jax.jit(lambda c, v: jassign.auction_assign(
            c, v, with_stats=True, phases=phases))(jnp.asarray(cost), jnp.asarray(valid))
        batch = np.stack([cost, cost[::-1].copy()])
        st_t, stats_t = passign.auction_assign(torch.from_numpy(batch),
                                               torch.from_numpy(np.stack([valid, valid])),
                                               with_stats=True, phases=phases)
        np.testing.assert_array_equal(st_t[0].numpy(), np.asarray(st_j), err_msg=name)
        assert int(stats_t["iterations"][0]) == int(stats_j["iterations"]), name
        assert int(stats_t["fallback_segments"][0]) == int(stats_j["fallback_segments"]), name
        st_j2 = jassign.auction_assign(jnp.asarray(batch[1]), jnp.asarray(valid), phases=phases)
        np.testing.assert_array_equal(st_t[1].numpy(), np.asarray(st_j2), err_msg=name)


def test_auction_phase_prices_equal_jaxs():
    """One epsilon phase's prices and picks, bit for bit with JAX's."""
    rng = np.random.default_rng(5)
    cost = rng.normal(size=(30, 20)).astype(np.float32)
    valid = np.ones(20, bool)
    value = -cost
    eps = np.float32(np.float32(value.max() - value.min()) * np.float32(1e-3))
    st_j, price_j, it_j = jassign._auction_phase(jnp.asarray(value), jnp.asarray(valid),
                                                 jnp.zeros(30, jnp.float32), jnp.float32(eps),
                                                 50000)
    st_t, price_t, it_t = passign._auction_phase(
        torch.from_numpy(value)[None], torch.from_numpy(valid)[None], torch.zeros((1, 30)),
        torch.tensor([eps]), 50000)
    np.testing.assert_array_equal(st_t[0].numpy(), np.asarray(st_j))
    np.testing.assert_array_equal(price_t[0].numpy(), np.asarray(price_j))
    assert int(it_t[0]) == int(it_j)


def test_fallback_place_equals_jaxs():
    """The sequential safety net on a partial assignment."""
    rng = np.random.default_rng(6)
    cost = rng.normal(size=(9, 6)).astype(np.float32)
    valid = np.array([1, 1, 1, 1, 1, 0], bool)
    st = np.array([3, -1, 5, -1, -1, -1], np.int32)
    ref = jassign.fallback_place(jnp.asarray(cost), jnp.asarray(valid), jnp.asarray(st))
    got = passign.fallback_place(torch.from_numpy(cost)[None], torch.from_numpy(valid)[None],
                                 torch.from_numpy(st)[None])
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref))


@pytest.mark.parametrize("seed", [8, 9])
def test_o2m_assign_equals_jaxs(seed):
    """The device one-to-many matching on a batch, against JAX's
    ``o2m_assign`` run per video: equal seg2tok."""
    rng = np.random.default_rng(seed)
    B, M, S, C = 3, 12, 10, 5
    cost = rng.normal(size=(B, M, S)).astype(np.float32)
    valid = np.arange(S)[None] < np.array([10, 6, 1])[:, None]
    transcript = rng.integers(0, C, size=(B, S)).astype(np.int32)
    got = passign.o2m_assign(torch.from_numpy(cost), torch.from_numpy(transcript),
                             torch.from_numpy(valid), C)
    for b in range(B):
        ref = jassign.o2m_assign(jnp.asarray(cost[b]), jnp.asarray(transcript[b]),
                                 jnp.asarray(valid[b]), C)
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(ref))


@pytest.mark.parametrize("mode", ["o2o", "o2m"])
def test_run_match_auction_equals_jaxs(mode):
    """``match`` with ``matcher: auction`` against JAX's ``run_match`` on a
    batch of costs with ragged segment counts: equal seg2tok."""
    rng = np.random.default_rng(7)
    B, M, S, C = 4, 16, 9, 6
    cost = rng.normal(size=(B, M, S)).astype(np.float32)
    nsegs = np.array([9, 5, 1, 7])
    seg_mask = np.arange(S)[None] < nsegs[:, None]
    transcript = rng.integers(0, C, size=(B, S)).astype(np.int32)
    ref = jmatching.run_match(jnp.asarray(cost), jnp.asarray(transcript), jnp.asarray(seg_mask),
                              mode, matcher="auction", nclasses=C)
    stats = {}
    got = pmatching.run_match_auction(torch.from_numpy(cost), torch.from_numpy(transcript),
                                      torch.from_numpy(seg_mask), mode, nclasses=C, stats=stats)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert stats["iterations"].shape == (B,)


# ---------------------------------------------------------------------------
# the narrow model's train step against JAX's


D, C, S_CAP, B, T, S = 12, 5, 24, 2, 96, 8
GRAD_TOL = 2e-2  # each gradient's largest element error, of its scale
GRAD_COS = 0.9999  # each gradient's cosine with JAX's


def _interp(fn):
    def f(*a, **kw):
        return fn(*a, **dict(kw, interpret=True))
    return f


def _cfgs():
    """``small_cfg()`` / ``_make_cfg(small=True)`` under bf16 with the
    auction matcher, at dropout 0 (the only rate bf16 trains at), no masking
    (cmr 0: its random draws differ between the two)."""
    from __graft_entry__ import _make_cfg
    from fact_clip_tpu_torch.configs import small_cfg

    jcfg, cfg = _make_cfg(small=True), small_cfg()
    jcfg.TPU.compute_dtype = cfg["TPU"]["compute_dtype"] = "bfloat16"
    jcfg.TPU.matcher = cfg["TPU"]["matcher"] = "auction"
    jcfg.Bi.dropout = cfg["Bi"]["dropout"] = 0.0
    jcfg.FACT.cmr = cfg["FACT"]["cmr"] = 0.0
    return jcfg, cfg


@pytest.fixture(scope="module")
def step_run():
    """JAX's bf16 train step (its Pallas kernels in interpret mode, the
    auction matcher) on a port model's weights and a seeded batch: the
    gradients ``apply_gradients`` gets and the step's outputs."""
    from fact_clip_tpu.engine.steps import make_step_fns
    from fact_clip_tpu.models import blocks as jblocks
    from fact_clip_tpu.models import losses as jl
    from fact_clip_tpu.utils.torch_import import convert_fact_state_dict
    from fact_clip_tpu_torch.engine.train_loop import synthetic_batch
    from fact_clip_tpu_torch.models.blocks import build_fact

    jcfg, cfg = _cfgs()
    batch = synthetic_batch(np.random.default_rng(0), D, C, S, T, [96, 61])
    port = build_fact(cfg, D, C, S_CAP, device="cpu", generator=torch.Generator().manual_seed(2))
    params = convert_fact_state_dict({k: v.numpy() for k, v in port.state_dict().items()},
                                     jblocks.resolve_block_cfgs(jcfg))
    params = jax.tree_util.tree_map(np.asarray, params)
    cweight = jl.build_class_weights(jcfg, C, [])

    class Capture:
        def __init__(self, p):
            self.params = p

        def apply_gradients(self, grads):
            self.grads = grads
            return self

    with mock.patch.object(jblocks, "_PALLAS_PLATFORM_OVERRIDE", "tpu"), \
            mock.patch.object(jdc, "dilated_residual_stack", _interp(jdc.dilated_residual_stack)), \
            mock.patch.object(jx2y, "x2y_attention", _interp(jx2y.x2y_attention)), \
            mock.patch.object(jmha, "mha_cross_attention", _interp(jmha.mha_cross_attention)), \
            mock.patch.object(jsa, "sa_sublayer", _interp(jsa.sa_sublayer)), \
            mock.patch.object(jsa, "ffn_sublayer", _interp(jsa.ffn_sublayer)), \
            mock.patch.object(jfl, "fused_ce_smooth_sums", _interp(jfl.fused_ce_smooth_sums)), \
            mock.patch.object(jfl, "fused_smooth_sum", _interp(jfl.fused_smooth_sum)):
        jmodel = jblocks.build_fact(jcfg, D, C, s_pred_cap=S_CAP)
        assert {c.dtype for c in jmodel.block_cfgs} == {"bfloat16"}
        train_step, _ = make_step_fns(jmodel, jcfg, C, cweight)

        @jax.jit
        def step(p, b):
            key = jax.random.PRNGKey(0)
            st, o = train_step.unjitted(Capture(p), b, key)
            # the step's matching, from the same (deterministic) train-mode forward
            rngs = {"dropout": jax.random.fold_in(key, 0), "aug": jax.random.fold_in(key, 1)}
            saves, _ = jmodel.apply({"params": p}, b["feats"], b["mask"], b["lengths"],
                                    train=True, rngs=rngs)
            last = saves[-1]
            o["seg2tok"] = jmatching.match(
                jcfg.Loss, jax.nn.softmax(last["action_clogit"], axis=-1), last["a2f_attn"],
                b["transcript"], b["seg_label"], b["seg_mask"], b["mask"], matcher="auction",
                nclasses=C)
            return st.grads, o

        grads, out = step(params, {k: jnp.asarray(v) for k, v in batch.items()})
    return dict(cfg=cfg, batch=batch, params=params, cweight=np.asarray(cweight),
                grads=jax.tree_util.tree_map(np.asarray, grads),
                out={k: np.asarray(v) for k, v in out.items()})


def test_narrow_bf16_train_step_matches_jax(step_run):
    """The port's bf16 ``TrainStep`` (the bf16 forms' Functions on CPU
    tensors, the auction on the batch) against JAX's: equal seg2tok, the loss
    within 1e-4 relative, every parameter's gradient within GRAD_TOL of its
    own scale and a cosine of GRAD_COS with JAX's (the limits reached are in
    CHANGES.md), the optimizer's update applied in f32."""
    from fact_clip_tpu_torch.engine.steps import make_train_step
    from fact_clip_tpu_torch.engine.train_loop import batch_to_device, feats_dtype
    from fact_clip_tpu_torch.models.blocks import build_fact
    from fact_clip_tpu_torch.utils.bridge import grads_from_jax, load_jax_params

    run = step_run
    model = build_fact(run["cfg"], D, C, S_CAP, device="cpu")
    load_jax_params(model, run["params"])
    step = make_train_step(model, run["cfg"], C, run["cweight"])
    assert step.matcher == "auction"
    x = batch_to_device(run["batch"], "cpu", torch.bfloat16)
    per_video, seg2tok, _ = step.loss(x, torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(seg2tok.numpy(), run["out"]["seg2tok"])
    np.testing.assert_allclose(per_video.detach().numpy(), run["out"]["per_video_loss"],
                               rtol=1e-4)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(per_video.mean(), list(model.parameters()))
    ref = grads_from_jax(run["grads"], model.block_cfgs)
    assert set(names) == set(ref)
    # a key projection's bias gradient cancels to about 0 (each query's
    # softmax gradient sums to 0 over the keys): read it against its weight's
    worst, cos = {}, {}
    for n, g in zip(names, grads):
        assert g.dtype == torch.float32, n
        r = ref[n].numpy()
        scale_of = n.replace("X_K.bias", "X_K.weight")
        scale = max(np.abs(ref[scale_of].numpy()).max(), 1e-12)
        worst[n] = float(np.abs(g.numpy() - r).max() / scale)
        if np.abs(r).max() > 0 and scale_of == n:  # cancelled and unused gradients aside
            cos[n] = float((g.numpy() * r).sum()
                           / (np.linalg.norm(g.numpy()) * np.linalg.norm(r)))
        else:
            assert scale_of != n or not g.numpy().any(), n  # unused: 0 in both
    bad = {n: e for n, e in worst.items() if e > GRAD_TOL}
    assert not bad, bad
    assert min(cos.values()) >= GRAD_COS, min(cos.values())
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    out = step(x, torch.Generator().manual_seed(0))
    np.testing.assert_allclose(float(out["loss"]), float(run["out"]["loss"]), rtol=1e-4)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert any(not torch.equal(before[n], p) for n, p in model.named_parameters())
    assert feats_dtype(_cfgs_node()) == torch.bfloat16


def _cfgs_node():
    from fact_clip_tpu_torch.configs import setup_cfg

    return setup_cfg([], ["TPU.compute_dtype", "bfloat16"])


# ---------------------------------------------------------------------------
# the loop on havid_tpu.yaml


HAVID_TPU = str(__import__("pathlib").Path(__file__).resolve().parents[1]
                / "fact_clip_tpu" / "configs" / "havid_tpu.yaml")
# havid_tpu.yaml narrowed for the CPU by an overlay (its keys stay out of the
# experiment's name): the fixture's paths, narrow widths, a few steps
OVERLAY = """feature_path: {base}/features
groundTruth_path: {base}/groundTruth
map_fname: {base}/mapping.txt
split_path: {base}/splits
feature_transpose: true
bg_class: 0
average_transcript_len: 4.0
batch_size: 3
epoch: 2
FACT:
  ntoken: 8
Bi:
  hid_dim: 48
  a_dim: 24
  a_ffdim: 48
  a_layers: 1
  a_nhead: 4
  f_dim: 32
  f_layers: 3
Bu:
  a_nhead: 4
  f_layers: 2
BU:
  a_nhead: 4
  f_layers: 2
aux:
  eval_every: 2
  print_every: 2
TPU:
  bucket_multiple: 64
  num_data_shards: 1
"""


@pytest.fixture(scope="module")
def havid_set(tmp_path_factory):
    from fact_clip_tpu_torch.data.synthetic import make_fixture_dataset

    root = tmp_path_factory.mktemp("havid16")
    base = make_fixture_dataset(str(root), name="havid_view0_lh_pt", n_classes=5, n_train=6,
                                n_test=3, feat_dim=16, min_len=60, max_len=120, min_segs=3,
                                max_segs=5, class_sep=3.0)
    overlay = root / "narrow.yaml"
    overlay.write_text(OVERLAY.format(base=base))
    return dict(root=root, cfgs=[HAVID_TPU, str(overlay)])


def test_run_train_trains_havid_tpu_and_resumes_bit_equal(havid_set, tmp_path):
    """``run_train`` on havid_tpu.yaml (bf16, the auction matcher) over the
    fixture set writes its run; then four steps against two, a checkpoint,
    a load into a model of other weights and two more: the same parameters
    and Adam state bit for bit."""
    from fact_clip_tpu_torch.configs import setup_cfg
    from fact_clip_tpu_torch.engine import checkpoint as ckpt_io
    from fact_clip_tpu_torch.engine import train_loop as tl
    from fact_clip_tpu_torch.engine.setup import build_experiment
    from fact_clip_tpu_torch.engine.steps import make_train_step

    cfg = setup_cfg(havid_set["cfgs"], [])
    assert cfg.TPU.compute_dtype == "bfloat16" and cfg.TPU.matcher == "auction"
    cfg.aux.logdir = "log/havid16"
    tl.check_loop_cfg(cfg)
    tl.run_train(cfg, device="cpu", base_dir=str(tmp_path))
    logdir = tmp_path / cfg.aux.logdir
    assert (logdir / "metrics.jsonl").exists() and list((logdir / "ckpts").iterdir())

    seed = cfg.aux.seed
    fdt = tl.feats_dtype(cfg)
    assert fdt == torch.bfloat16

    def train(exp, step, batches, steps):
        for g in steps:
            step(tl.batch_to_device(batches[g], "cpu", fdt), tl.step_generator(seed, g, "cpu"))

    whole = build_experiment(cfg, "cpu", seed=seed)
    assert {c.dtype for c in whole.model.block_cfgs} == {"bfloat16"}
    loader = whole.train_loader(seed=seed)
    batches = [b.device_arrays for _ in range(2) for b in loader]
    nclasses = whole.dataset.nclasses
    step_a = make_train_step(whole.model, cfg, nclasses, whole.cweight, len(loader))
    train(whole, step_a, batches, range(4))
    part = build_experiment(cfg, "cpu", seed=seed)
    step_b = make_train_step(part.model, cfg, nclasses, part.cweight, len(loader))
    train(part, step_b, batches, range(2))
    ckpt_io.save_model(part.model, str(tmp_path), 2)
    ckpt_io.save_train_state(step_b.optimizer, str(tmp_path), 2)
    again = build_experiment(cfg, "cpu", seed=seed + 1)
    step_c = make_train_step(again.model, cfg, nclasses, again.cweight, len(loader))
    ckpt_io.load_model(again.model, str(tmp_path / "network.iter-2.net"))
    assert ckpt_io.load_train_state(step_c.optimizer, str(tmp_path / "network.iter-2.net"))
    train(again, step_c, batches, range(2, 4))
    for (name, a), c in zip(whole.model.named_parameters(), again.model.parameters()):
        assert a.dtype == torch.float32 and torch.equal(a, c), name
    sa, sc = step_a.optimizer.opt.state_dict(), step_c.optimizer.opt.state_dict()
    for i, st in sa["state"].items():
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(st[k], sc["state"][i][k]), (i, k)


def test_bf16_checkpoint_reads_into_the_jax_model(havid_set, tmp_path):
    """The bf16-trained model's checkpoint (f32 parameters in the
    reference's layout), read by JAX's importer into JAX's havid_tpu model:
    the same tree, and in f32 (XLA, no Pallas) every block's frame logits
    within 1e-4 of scale of the port's f32 model on the same state dict."""
    from fact_clip_tpu.configs.utils import setup_cfg as jax_setup_cfg
    from fact_clip_tpu.models import blocks as jblocks
    from fact_clip_tpu.utils.torch_import import convert_fact_state_dict
    from fact_clip_tpu_torch.configs import setup_cfg
    from fact_clip_tpu_torch.engine import checkpoint as ckpt_io
    from fact_clip_tpu_torch.engine import train_loop as tl
    from fact_clip_tpu_torch.engine.setup import build_experiment
    from fact_clip_tpu_torch.engine.steps import make_train_step
    from fact_clip_tpu_torch.models.blocks import build_fact

    cfg = setup_cfg(havid_set["cfgs"], [])
    exp = build_experiment(cfg, "cpu", seed=3)
    arrays = next(iter(exp.train_loader(seed=3))).device_arrays
    make_train_step(exp.model, cfg, exp.dataset.nclasses, exp.cweight)(
        tl.batch_to_device(arrays, "cpu", torch.bfloat16), tl.step_generator(3, 0, "cpu"))
    path = ckpt_io.save_model(exp.model, str(tmp_path), 1)
    sd = torch.load(path, weights_only=True)
    assert all(v.dtype == torch.float32 for v in sd.values() if v.is_floating_point())
    sets = ["TPU.compute_dtype", "float32", "TPU.pallas", "false", "TPU.pallas_sa", "false"]
    jcfg = jax_setup_cfg(havid_set["cfgs"], sets)
    params = convert_fact_state_dict({k: v.numpy() for k, v in sd.items()},
                                     jblocks.resolve_block_cfgs(jcfg))
    jmodel = jblocks.build_fact(jcfg, exp.dataset.input_dimension, exp.dataset.nclasses,
                                s_pred_cap=exp.s_pred_cap)
    jsaves, _ = jmodel.apply({"params": params}, jnp.asarray(arrays["feats"]),
                             jnp.asarray(arrays["mask"]), jnp.asarray(arrays["lengths"]),
                             train=False)
    model = build_fact(setup_cfg(havid_set["cfgs"], sets), exp.dataset.input_dimension,
                       exp.dataset.nclasses, exp.s_pred_cap, device="cpu")
    model.load_state_dict(sd)
    x = tl.batch_to_device(arrays, "cpu")
    with torch.no_grad():
        saves, _ = model(x["feats"], x["mask"], x["lengths"])
    mask = arrays["mask"]
    for i, (sp, sj) in enumerate(zip(saves, jsaves)):
        got, ref = sp["frame_clogit"].numpy()[mask], np.asarray(sj["frame_clogit"])[mask]
        assert _rel(got, ref) <= 1e-4, (i, _rel(got, ref))
