"""The port's kernel modules (K1-K4) against the JAX kernels on the CPU.

Each kernel wrapper of ``fact_clip_tpu_torch.ops`` runs its plain PyTorch
version on CPU tensors; here that version is held against the JAX function
as the JAX package's own tests run it on the CPU: the Pallas kernel in
interpret mode at tiny shapes.  Inputs are made with numpy from a seed and
handed to both sides.  Tolerance: 1e-4 absolute (values are O(1)): float32
on both sides, sums taken in another order.  The CUDA kernels themselves are
checked against these plain versions on the card by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fact_clip_tpu_torch import kernel_counters
from fact_clip_tpu_torch.ops import dilated_conv, mha_attn, sa_layer, x2y_attn

torch.set_num_threads(2)
ATOL = 1e-4


def _pair(rng, shape, scale=1.0):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _close(port, ref, atol=ATOL):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), atol=atol, rtol=0)


@pytest.mark.parametrize("use_ln", [True, False])
def test_k1_mstcn_stack_matches_pallas_interpret(use_ln):
    from fact_clip_tpu.ops.pallas.dilated_conv import dilated_residual_stack

    rng = np.random.default_rng(0)
    B, T, C, O = 2, 70, 32, 48
    dilations = [1, 2, 4, 32]
    x_j, x_t = _pair(rng, (B, T, C))
    lengths = np.array([70, 50], np.int32)
    mask = np.arange(T)[None] < lengths[:, None]
    layers_j, layers_t = [], []
    for _ in dilations:
        parts = [_pair(rng, (3, C, C), 0.08), _pair(rng, (C,), 0.05), _pair(rng, (C, C), 0.08),
                 _pair(rng, (C,), 0.05), _pair(rng, (C,), 0.2), _pair(rng, (C,), 0.2)]
        parts[4] = (parts[4][0] + 1.0, parts[4][1] + 1.0)
        layers_j.append(tuple(p[0] for p in parts))
        layers_t.append(tuple(p[1] for p in parts))
    ow_j, ow_t = _pair(rng, (C, O), 0.1)
    ob_j, ob_t = _pair(rng, (O,), 0.1)

    ref = dilated_residual_stack(x_j, jnp.asarray(mask), layers_j, dilations, use_ln=use_ln,
                                 tile=32, interpret=True, out_params=(ow_j, ob_j))
    got = dilated_conv.mstcn_stack_fwd(x_t, torch.from_numpy(lengths), layers_t, dilations,
                                       use_ln=use_ln, out_w=ow_t, out_b=ob_t)
    assert got.shape == (B, T, O)
    _close(got, ref)
    # padded frames carry the bias row
    _close(got[1, 60], ob_j, atol=1e-6)


def test_k1_dilation_beyond_the_video_matches_xla_reference():
    """Dilations larger than the video (the flagship reaches 512): taps past
    either end read zeros.  JAX oracle: ``_stack_reference`` + the dense."""
    from fact_clip_tpu.ops.pallas.dilated_conv import _stack_reference

    rng = np.random.default_rng(1)
    B, T, C, O = 2, 40, 16, 24
    dilations = [1, 16, 64]
    x_j, x_t = _pair(rng, (B, T, C))
    lengths = np.array([40, 27], np.int32)
    mask = np.arange(T)[None] < lengths[:, None]
    layers_j, layers_t = [], []
    for _ in dilations:
        parts = [_pair(rng, (3, C, C), 0.1), _pair(rng, (C,), 0.1), _pair(rng, (C, C), 0.1),
                 _pair(rng, (C,), 0.1)]
        ones, zeros = np.ones(C, np.float32), np.zeros(C, np.float32)
        layers_j.append(tuple(p[0] for p in parts) + (jnp.asarray(ones), jnp.asarray(zeros)))
        layers_t.append(tuple(p[1] for p in parts) + (torch.from_numpy(ones),
                                                      torch.from_numpy(zeros)))
    ow_j, ow_t = _pair(rng, (C, O), 0.1)
    ob_j, ob_t = _pair(rng, (O,), 0.1)
    stream = _stack_reference(x_j, jnp.asarray(mask), layers_j, dilations, False, 1e-5,
                              (0.0,) * 3, (None,) * 3, 32, True)
    got = dilated_conv.mstcn_stack_fwd(x_t, torch.from_numpy(lengths), layers_t, dilations,
                                       use_ln=False, out_w=ow_t, out_b=ob_t)
    _close(got, stream @ ow_j + ob_j)


def _x2y_inputs(rng, B, Y, X, Cy, Cx, d, batched_ypos):
    yp_shape = (B, Y, Cy) if batched_ypos else (1, Y, Cy)
    names = ["y", "ypos", "x", "xpos", "wk", "bk", "wv", "bv", "wq", "bq"]
    shapes = [(B, Y, Cy), yp_shape, (B, X, Cx), (1, X, Cx), (Cx, d), (d,), (Cx, d), (d,),
              (Cy, d), (d,)]
    scales = [1, 1, 1, 1, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1]
    pairs = {n: _pair(rng, s, sc) for n, s, sc in zip(names, shapes, scales)}
    return pairs


@pytest.mark.parametrize("batched_ypos", [False, True])
def test_k2_small_x_matches_pallas_interpret(batched_ypos):
    from fact_clip_tpu.ops.pallas.x2y_attn import x2y_attention

    rng = np.random.default_rng(2)
    B, Y, X, Cy, Cx, d = 2, 70, 13, 24, 32, 16
    p = _x2y_inputs(rng, B, Y, X, Cy, Cx, d, batched_ypos)
    x_len = np.array([13, 6], np.int32)
    j = [p[n][0] for n in ("y", "ypos", "x", "xpos", "wk", "bk", "wv", "bv", "wq", "bq")]
    t = [p[n][1] for n in ("y", "ypos", "x", "xpos", "wk", "bk", "wv", "bv", "wq", "bq")]
    ref = x2y_attention(*j, jnp.asarray(x_len), tile=32, interpret=True)
    got = x2y_attn.x2y_small_x_fwd(*t, torch.from_numpy(x_len))
    for g, r in zip(got, ref):
        _close(g, r)
    assert float(got[2][1, 0, 6:].max()) == -1e9  # masked keys keep a finite logit


def test_k2_flash_matches_pallas_interpret():
    """The flash form, driven below its production threshold so that the
    interpret-mode kernel stays small: three key tiles, a ragged x_len."""
    from fact_clip_tpu.ops.pallas.x2y_attn import _x2y_flash_fwd_impl

    rng = np.random.default_rng(3)
    B, M, X, Cy, Cx, d = 2, 11, 300, 24, 32, 16
    p = _x2y_inputs(rng, B, M, X, Cy, Cx, d, False)
    x_len = np.array([300, 141], np.int32)
    yq = (p["y"][0] + p["ypos"][0]) @ p["wq"][0] + p["bq"][0]
    ref = _x2y_flash_fwd_impl(p["x"][0], p["xpos"][0], yq, p["wk"][0], p["bk"][0], p["wv"][0],
                              p["bv"][0], jnp.asarray(x_len), tile=128, interpret=True)
    t = [p[n][1] for n in ("y", "ypos", "x", "xpos", "wk", "bk", "wv", "bv", "wq", "bq")]
    got = x2y_attn.x2y_flash_fwd(*t, torch.from_numpy(x_len))
    for g, r in zip(got, ref):
        _close(g, r)


def test_k2_dispatch_threshold_matches_jax():
    """x2y_attention takes the flash form exactly when X > 1024, as JAX does;
    at X = 1100 the port equals the JAX X2Y math (XLA oracle)."""
    assert x2y_attn.FLASH_MIN_KEYS == 1025
    rng = np.random.default_rng(4)
    B, M, X, C, d = 1, 5, 1100, 16, 8
    p = _x2y_inputs(rng, B, M, X, C, C, d, False)
    x_len = np.array([1000], np.int32)
    j = {n: v[0] for n, v in p.items()}
    xk = (j["x"] + j["xpos"]) @ j["wk"] + j["bk"]
    xv = j["x"] @ j["wv"] + j["bv"]
    yq = (j["y"] + j["ypos"]) @ j["wq"] + j["bq"]
    logits = jnp.einsum("byd,bxd->byx", yq, xk) / np.sqrt(d)
    logits = jnp.where(jnp.arange(X)[None, None] < x_len[:, None, None], logits, -1e9)
    probs = jax.nn.softmax(logits, axis=-1)
    ref = (probs @ xv, probs, logits)
    t = [p[n][1] for n in ("y", "ypos", "x", "xpos", "wk", "bk", "wv", "bv", "wq", "bq")]
    got = x2y_attn.x2y_attention(*t, torch.from_numpy(x_len))
    for g, r in zip(got, ref):
        _close(g, r)


def test_k3_mha_cross_matches_pallas_interpret():
    from fact_clip_tpu.ops.pallas.mha_attn import mha_cross_attention

    rng = np.random.default_rng(5)
    B, M, X, E, Cx, H = 2, 10, 300, 32, 48, 4
    q = _pair(rng, (B, M, E))
    x = _pair(rng, (B, X, Cx))
    pos = _pair(rng, (1, X, Cx))
    wk, bk = _pair(rng, (Cx, E), 0.1), _pair(rng, (E,), 0.05)
    wv, bv = _pair(rng, (Cx, E), 0.1), _pair(rng, (E,), 0.05)
    x_len = np.array([300, 179], np.int32)
    args = [q, x, pos, wk, bk, wv, bv]
    ref = mha_cross_attention(*[a[0] for a in args], jnp.asarray(x_len), num_heads=H,
                              tile=128, interpret=True)
    got = mha_attn.mha_cross_fwd(*[a[1] for a in args], torch.from_numpy(x_len), num_heads=H)
    _close(got, ref)


def _sa_args(rng, E, F):
    w = lambda *s: _pair(rng, s, 0.1)  # noqa: E731
    sa = [w(E, E), w(E), w(E, E), w(E), w(E, E), w(E), w(E, E), w(E)]
    ln = [(a[0] + 1.0, a[1] + 1.0) for a in [w(E)]] + [w(E)]
    ffn = [w(E, F), w(F), w(F, E), w(E)]
    return sa, ln, ffn


@pytest.mark.parametrize("M", [11, 40])
def test_k4_sa_and_ffn_sublayers_match_pallas_interpret(M):
    from fact_clip_tpu.ops.pallas.sa_layer import ffn_sublayer, sa_sublayer

    rng = np.random.default_rng(6)
    B, E, H, F = 3, 32, 4, 48
    x = _pair(rng, (B, M, E))
    pos = _pair(rng, (1, M, E))
    sa, ln, ffn = _sa_args(rng, E, F)
    ref = sa_sublayer(x[0], pos[0], *[a[0] for a in sa], *[a[0] for a in ln], num_heads=H,
                      interpret=True)
    got = sa_layer.sa_sublayer(x[1], pos[1], *[a[1] for a in sa], *[a[1] for a in ln],
                               num_heads=H)
    _close(got, ref)
    ref2 = ffn_sublayer(ref, *[a[0] for a in ffn], *[a[0] for a in ln], interpret=True)
    got2 = sa_layer.ffn_sublayer(got, *[a[1] for a in ffn], *[a[1] for a in ln])
    _close(got2, ref2)


def test_wrappers_count_no_launch_on_cpu_tensors():
    before = kernel_counters()
    test_k3_mha_cross_matches_pallas_interpret()
    test_k2_flash_matches_pallas_interpret()
    assert kernel_counters() == before
    assert all(v == 0 for v in kernel_counters().values())


def test_wrappers_refuse_dropout_and_gradients():
    """K3 and K4 take dropout and gradients through their entries; their raw
    kernel wrappers and K2's raw forward wrappers refuse gradients (K2's also
    dropout); the K3 entry refuses a key positional term that wants a
    gradient, and dropout without a seed is refused."""
    rng = np.random.default_rng(8)
    t = lambda *s: torch.from_numpy((rng.standard_normal(s) * 0.3).astype(np.float32))  # noqa: E731
    x, w, b, w2 = t(2, 3, 8), t(8, 8), t(8), t(16, 8)
    w1, b1 = t(8, 16), t(16)
    ln = (torch.ones(8), torch.zeros(8))
    seed = torch.tensor([3], dtype=torch.int32)
    sa_w = [w, b, w, b, w, b, w, b, *ln]
    # K4: dropout and gradients through the entries
    xg = x.clone().requires_grad_(True)
    y = sa_layer.sa_sublayer(xg, None, *sa_w, num_heads=2, rate_attn=0.1, rate=0.1, seed=seed)
    y = sa_layer.ffn_sublayer(y, w1, b1, w2, b, *ln, rate=0.1, seed=seed)
    (gx,) = torch.autograd.grad(y.sum(), [xg])
    assert gx.shape == x.shape and torch.isfinite(gx).all()
    # K3: dropout and gradients through the entry
    q, mem = t(2, 3, 8).requires_grad_(True), t(2, 20, 8)
    x_len = torch.tensor([20, 7], dtype=torch.int32)
    out = mha_attn.mha_cross_attention(q, mem, None, w, b, w, b, x_len, num_heads=2, rate=0.2,
                                       seed=seed)
    (gq,) = torch.autograd.grad(out.sum(), [q])
    assert torch.isfinite(gq).all()
    with pytest.raises(NotImplementedError):
        mha_attn.mha_cross_attention(q, mem, t(1, 20, 8).requires_grad_(True), w, b, w, b,
                                     x_len, num_heads=2)
    # the raw kernel wrappers record nothing for autograd
    with pytest.raises(NotImplementedError):
        sa_layer.ffn_sublayer_fwd(xg, w1, b1, w2, b, *ln)
    with pytest.raises(NotImplementedError):
        sa_layer.sa_sublayer_fwd(xg, None, *sa_w, num_heads=2)
    with pytest.raises(NotImplementedError):
        mha_attn.mha_cross_fwd(q, mem, None, w, b, w, b, x_len, num_heads=2)
    # K2's raw forwards still refuse dropout and gradients
    x2y_args = (t(2, 5, 8), None, t(2, 9, 8), None, w, b, w, b, w, b,
                torch.tensor([9, 4], dtype=torch.int32))
    with pytest.raises(NotImplementedError):
        x2y_attn.x2y_small_x_fwd(*x2y_args, rate=0.1)
    with pytest.raises(NotImplementedError):
        x2y_attn.x2y_flash_fwd(x2y_args[0].requires_grad_(True), *x2y_args[1:])
    # dropout needs a seed
    with pytest.raises(ValueError):
        sa_layer.ffn_sublayer(x, w1, b1, w2, b, *ln, rate=0.1)
