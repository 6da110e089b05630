"""The port's training kernels' plain versions (K1 and K2 backwards, K1
dropout, K5) against the JAX package on the CPU.

Each kernel wrapper of ``fact_clip_tpu_torch.ops`` runs its plain PyTorch
version on CPU tensors; here those versions are held against the JAX
oracles: ``jax.vjp`` of ``_stack_reference`` + the out dense for the tower's
backward (dropout off: no JAX test covers the fused out-projection backward
with dropout, so with dropout on the port is held against torch autograd of
its own plain forward with the same hash mask), ``_small_x_bwd_xla`` and
``_flash_bwd_xla`` for K2, and the frame-loss Pallas kernel in interpret mode
for K5.  Inputs are made with numpy from a seed and handed to both sides.
Tolerance: 1e-5 absolute and 1e-4 relative (float32 on both sides, sums in
another order).  The CUDA kernels are held against these plain versions on
the card by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fact_clip_tpu_torch import kernel_counters
from fact_clip_tpu_torch.ops import dilated_conv, frame_loss, x2y_attn

torch.set_num_threads(2)
ATOL, RTOL = 1e-5, 1e-4


def _pair(rng, shape, scale=1.0, shift=0.0):
    a = (rng.standard_normal(shape) * scale + shift).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _close(port, ref, err_msg=""):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL,
                               err_msg=err_msg)


def _tower(rng, B, T, C, O, dilations):
    layers_j, layers_t = [], []
    for _ in dilations:
        parts = [_pair(rng, (3, C, C), 0.2), _pair(rng, (C,), 0.1), _pair(rng, (C, C), 0.2),
                 _pair(rng, (C,), 0.1), _pair(rng, (C,), 0.2, 1.0), _pair(rng, (C,), 0.2)]
        layers_j.append(tuple(p[0] for p in parts))
        layers_t.append(tuple(p[1] for p in parts))
    x = _pair(rng, (B, T, C))
    ow, ob = _pair(rng, (C, O), 0.2), _pair(rng, (O,), 0.1)
    g = _pair(rng, (B, T, O))
    return x, layers_j, layers_t, ow, ob, g


@pytest.mark.parametrize("use_ln", [False, True])
def test_k1_backward_matches_jax_vjp(use_ln):
    """Rate 0: the plain backward (and the autograd entry) against jax.vjp of
    ``_stack_reference`` followed by the out dense."""
    from fact_clip_tpu.ops.pallas.dilated_conv import _stack_reference

    rng = np.random.default_rng(0)
    B, T, C, O = 2, 40, 16, 24
    dil = [1, 4, 32]
    lengths = np.array([40, 27], np.int32)
    mask = jnp.asarray(np.arange(T)[None] < lengths[:, None])
    x, layers_j, layers_t, ow, ob, g = _tower(rng, B, T, C, O, dil)

    def f(x, layers, ow, ob):
        stream = _stack_reference(x, mask, layers, dil, use_ln, 1e-5, (0.0,) * 3, (None,) * 3,
                                  32, True)
        return stream @ ow + ob

    _, vjp = jax.vjp(f, x[0], layers_j, ow[0], ob[0])
    dx_j, dl_j, dow_j, dob_j = vjp(g[0])
    refs = [dx_j, dow_j, dob_j] + [t for layer in dl_j for t in layer]

    lens = torch.from_numpy(lengths)
    kw = dict(use_ln=use_ln, out_w=ow[1], out_b=ob[1])
    _, streams, acts = dilated_conv.mstcn_stack_reference(x[1], lens, layers_t, dil, save=True,
                                                          **kw)
    dx, dl, dow, dob = dilated_conv.mstcn_stack_bwd_reference(g[1], streams, acts, lens,
                                                              layers_t, dil, **kw)
    for got, ref in zip([dx, dow, dob] + [t for layer in dl for t in layer], refs):
        _close(got, ref)

    # the differentiable entry (kernels on the card, these plain versions here)
    params = [x[1], ow[1], ob[1]] + [p for layer in layers_t for p in layer]
    for p in params:
        p.requires_grad_(True)
    out = dilated_conv.mstcn_stack(x[1], lens, layers_t, dil, **kw)
    grads = torch.autograd.grad(out, params, g[1])
    for got, ref in zip(grads, refs):
        _close(got, ref)


@pytest.mark.parametrize("use_ln", [False, True])
def test_k1_dropout_backward_matches_autograd_of_plain_forward(use_ln):
    """Rate 0.2, the out projection fused into the last layer: the plain
    backward against torch autograd of the plain forward with the same
    hash mask."""
    rng = np.random.default_rng(1)
    B, T, C, O = 2, 50, 16, 12
    dil = [1, 8, 64]
    lens = torch.tensor([50, 31], dtype=torch.int32)
    x, _, layers, ow, ob, g = _tower(rng, B, T, C, O, dil)
    kw = dict(use_ln=use_ln, out_w=ow[1], out_b=ob[1], rates=[0.2] * 3,
              seeds=torch.tensor([7, 1234567, 2 ** 31 - 2], dtype=torch.int32))
    params = [x[1], ow[1], ob[1]] + [p for layer in layers for p in layer]
    for p in params:
        p.requires_grad_(True)
    out = dilated_conv.mstcn_stack_reference(x[1], lens, layers, dil, **kw)
    refs = torch.autograd.grad(out, params, g[1], allow_unused=True)
    with torch.no_grad():
        _, streams, acts = dilated_conv.mstcn_stack_reference(x[1], lens, layers, dil, save=True,
                                                              **kw)
        dx, dl, dow, dob = dilated_conv.mstcn_stack_bwd_reference(g[1], streams, acts, lens,
                                                                  layers, dil, **kw)
    for got, ref in zip([dx, dow, dob] + [t for layer in dl for t in layer], refs):
        _close(got, ref if ref is not None else torch.zeros_like(got))
    # the mask really dropped: the logits differ from the rate-0 tower
    with torch.no_grad():
        plain = dilated_conv.mstcn_stack_reference(x[1], lens, layers, dil, use_ln=use_ln,
                                                   out_w=ow[1], out_b=ob[1])
    assert float((plain - out.detach()).abs().max()) > 1e-2


def test_dropout_hash_mask_keep_rate_and_values():
    seed = torch.tensor([20260], dtype=torch.int32)
    m = dilated_conv.dropout_mask_reference(seed, 3, (4, 500, 64), 0.2)
    assert abs(float((m > 0).double().mean()) - 0.8) <= 0.005
    assert set(torch.unique(m).tolist()) == {0.0, 1.25}
    assert torch.equal(dilated_conv.mstcn_dropout_mask(seed, 3, (4, 500, 64), 0.2), m)
    # another layer or seed draws another mask
    assert not torch.equal(dilated_conv.dropout_mask_reference(seed, 4, (4, 500, 64), 0.2), m)
    other = torch.tensor([20261], dtype=torch.int32)
    assert not torch.equal(dilated_conv.dropout_mask_reference(other, 3, (4, 500, 64), 0.2), m)


def _x2y_case(rng, B, Y, X, C, d, batched_ypos):
    names = ["y", "ypos", "x", "xpos", "wk", "bk", "wv", "bv", "wq", "bq"]
    shapes = [(B, Y, C), (B if batched_ypos else 1, Y, C), (B, X, C), (1, X, C), (C, d), (d,),
              (C, d), (d,), (C, d), (d,)]
    scales = [1, 1, 1, 1, 0.3, 0.1, 0.3, 0.1, 0.3, 0.1]
    return [_pair(rng, s, sc) for s, sc in zip(shapes, scales)], names


@pytest.mark.parametrize("form,batched_ypos", [("small", False), ("small", True),
                                               ("flash", False)])
def test_k2_backward_matches_jax_xla_backward(form, batched_ypos):
    from fact_clip_tpu.ops.pallas.x2y_attn import _flash_bwd_xla, _small_x_bwd_xla

    rng = np.random.default_rng(2)
    B, C, d = 2, 12, 8
    Y, X = (30, 9) if form == "small" else (7, 60)
    args, _ = _x2y_case(rng, B, Y, X, C, d, batched_ypos)
    x_len = np.array([X, X - 4], np.int32)
    tj = [a[0] for a in args]
    tt = [a[1] for a in args]
    xl = torch.from_numpy(x_len)
    with torch.no_grad():
        attn, probs, logits = x2y_attn.x2y_attention_reference(*tt, xl)
    g = [_pair(rng, attn.shape), _pair(rng, probs.shape, 0.1), _pair(rng, logits.shape, 0.1)]
    res = (*tj[:8], (tj[8], tj[9], jnp.asarray(x_len)), jnp.asarray(probs.numpy()))
    if form == "small":
        ref = _small_x_bwd_xla(res, tuple(a[0] for a in g), d)
        got = x2y_attn.x2y_small_x_bwd(*tt, xl, probs, *[a[1] for a in g])
    else:
        ref = _flash_bwd_xla(res + (jnp.asarray(attn.numpy()),), tuple(a[0] for a in g), d)
        got = x2y_attn.x2y_flash_bwd(*tt, xl, probs, attn, *[a[1] for a in g])
    refs = list(ref[:8]) + [ref[8][0], ref[8][1]]
    for i, (a, r) in enumerate(zip(got, refs)):
        _close(a, r, err_msg=f"grad {i}")

    # the differentiable entry (on CPU tensors both forms take the plain backward)
    for t in tt:
        t.requires_grad_(True)
    outs = x2y_attn.x2y_attention(*tt, xl)
    grads = torch.autograd.grad(outs, tt, [a[1] for a in g])
    for i, (a, r) in enumerate(zip(grads, refs)):
        _close(a, r, err_msg=f"autograd grad {i}")


def test_k2_masked_logits_get_no_gradient():
    rng = np.random.default_rng(3)
    args, _ = _x2y_case(rng, 2, 5, 9, 6, 4, False)
    tt = [a[1].requires_grad_(True) for a in args]
    xl = torch.tensor([9, 3], dtype=torch.int32)
    _, _, logits = x2y_attn.x2y_attention(*tt, xl)
    g = torch.zeros_like(logits)
    g[1, :, 3:] = 1.0  # only masked entries
    grads = torch.autograd.grad(logits, tt, g, allow_unused=True)
    assert all(t is None or float(t.abs().max()) == 0.0 for t in grads)


@pytest.mark.parametrize("with_ce", [True, False])
def test_k5_forward_and_gradient_match_pallas_interpret(with_ce):
    from fact_clip_tpu.ops.pallas.frame_loss import fused_ce_smooth_sums, fused_smooth_sum

    rng = np.random.default_rng(4)
    B, T, C = 2, 70, 11  # C: tail lanes of the 128-lane tile
    x = _pair(rng, (B, T, C), 2.0)
    labels = rng.integers(0, C, (B, T)).astype(np.int32)
    lengths = np.array([70, 45], np.int32)
    mask = np.arange(T)[None] < lengths[:, None]
    cw = rng.uniform(0.2, 1.5, C + 1).astype(np.float32)
    gce, gsl = _pair(rng, (B,)), _pair(rng, (B,))
    if with_ce:
        f = lambda v: fused_ce_smooth_sums(v, jnp.asarray(labels), jnp.asarray(mask),  # noqa: E731
                                           jnp.asarray(cw), interpret=True)
        (ce_j, sl_j), vjp = jax.vjp(f, x[0])
        (dx_j,) = vjp((gce[0], gsl[0]))
    else:
        f = lambda v: fused_smooth_sum(v, jnp.asarray(mask), interpret=True)  # noqa: E731
        sl_j, vjp = jax.vjp(f, x[0])
        (dx_j,) = vjp(gsl[0])
    lab_t = torch.from_numpy(labels) if with_ce else None
    cw_t = torch.from_numpy(cw[:C]) if with_ce else None
    maskf = torch.from_numpy(mask.astype(np.float32))
    ce, sl = frame_loss.frame_loss_fwd(x[1], lab_t, maskf, cw_t)
    _close(sl, sl_j)
    if with_ce:
        _close(ce, ce_j)
    dx = frame_loss.frame_loss_bwd(x[1], lab_t, maskf, cw_t, gce[1] if with_ce else None, gsl[1])
    _close(dx, dx_j)

    # the differentiable entries
    xt = x[1].clone().requires_grad_(True)
    mt = torch.from_numpy(mask)
    if with_ce:
        out = frame_loss.fused_ce_smooth_sums(xt, lab_t, mt, torch.from_numpy(cw))
        (got,) = torch.autograd.grad(out, [xt], [gce[1], gsl[1]])
    else:
        out = frame_loss.fused_smooth_sum(xt, mt)
        (got,) = torch.autograd.grad(out, [xt], gsl[1])
    _close(got, dx_j)


def test_training_wrappers_count_no_launch_on_cpu_tensors():
    before = kernel_counters()
    test_k5_forward_and_gradient_match_pallas_interpret(True)
    test_dropout_hash_mask_keep_rate_and_values()
    assert kernel_counters() == before
    assert all(v == 0 for v in kernel_counters().values())
