"""The single-layer K1 (``ops/dilated_conv.py::dilated_residual_layer``) and
``models/layers.py::DilatedResidualLayer.forward`` against the JAX package on
the CPU.

The layer's forward wrapper runs its plain PyTorch version on CPU tensors;
here it is held against ``fact_clip_tpu/ops/pallas/dilated_conv.py::
dilated_residual_layer`` in interpret mode (T = 70 with tile 32, so the
d = 64 taps reach past the tile), LayerNorm on and off, within 1e-5
relative, and its gradients against ``jax.grad`` of that function (its
custom VJP, XLA recompute) within 1e-5 relative.  With dropout the keep
rate of the forward's mask is 0.8 and the backward replays exactly that
mask: its gradients equal torch autograd of the plain forward with the same
hash mask.  The module follows JAX's ``DilatedResidualLayer.__call__``:
input masked, every frame written, the plain path with dropout.  The CUDA
forward is held against the plain version on the card by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fact_clip_tpu.models import layers as jlayers
from fact_clip_tpu.ops.pallas import dilated_conv as jdc
from fact_clip_tpu_torch import kernel_counters
from fact_clip_tpu_torch.models.layers import DilatedResidualLayer
from fact_clip_tpu_torch.ops import dilated_conv as dc

torch.set_num_threads(2)
REL = 1e-5
B, T, C = 2, 70, 32


def _pair(rng, shape, scale=1.0, shift=0.0):
    a = (rng.standard_normal(shape) * scale + shift).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _inputs(seed):
    rng = np.random.default_rng(seed)
    parts = [_pair(rng, (B, T, C)), _pair(rng, (3, C, C), 0.1), _pair(rng, (C,), 0.1),
             _pair(rng, (C, C), 0.15), _pair(rng, (C,), 0.1), _pair(rng, (C,), 0.2, 1.0),
             _pair(rng, (C,), 0.2)]
    lengths = np.array([T, 47], np.int32)
    mask = np.arange(T)[None] < lengths[:, None]
    x = np.asarray(parts[0][0]) * mask[..., None]  # the caller masks the input
    parts[0] = (jnp.asarray(x), torch.from_numpy(x))
    return [p[0] for p in parts], [p[1] for p in parts], mask


@pytest.mark.parametrize("use_ln", [True, False])
@pytest.mark.parametrize("d", [1, 64])
def test_forward_and_gradients_match_jax(use_ln, d):
    pj, pt, _ = _inputs(10 + d)
    g = np.random.default_rng(3).standard_normal((B, T, C)).astype(np.float32)
    kw = dict(dilation=d, use_ln=use_ln)

    def f(*p):
        return jdc.dilated_residual_layer(*p, tile=32, interpret=True, **kw)

    ref = np.asarray(f(*pj))
    grads_j = jax.grad(lambda *p: jnp.sum(f(*p) * g), argnums=tuple(range(7)))(*pj)
    for p in pt:
        p.requires_grad_(True)
    before = kernel_counters()
    out = dc.dilated_residual_layer(*pt, **kw)
    assert kernel_counters() == before  # CPU tensors: the plain version, no launch
    assert out.shape == (B, T, C)
    assert _rel(out.detach(), ref) <= REL
    grads = torch.autograd.grad(out, pt, torch.from_numpy(g))
    for name, got, want in zip(("x", "wd", "bd", "w1", "b1", "gamma", "beta"), grads, grads_j):
        if not use_ln and name in ("gamma", "beta"):
            assert not got.any() and not np.asarray(want).any()
            continue
        assert _rel(got, want) <= REL, name


@pytest.mark.parametrize("use_ln", [True, False])
def test_dropout_keep_rate_and_the_backward_replays_the_mask(use_ln):
    _, pt, _ = _inputs(5)
    seed = torch.tensor([123457], dtype=torch.int32)
    kw = dict(dilation=8, use_ln=use_ln, rate=0.2, seed=seed)
    g = torch.from_numpy(np.random.default_rng(4).standard_normal((B, T, C)).astype(np.float32))
    params = [p.clone().requires_grad_(True) for p in pt]
    out = dc.dilated_residual_layer(*params, **kw)
    grads = torch.autograd.grad(out, params, g)
    # the keep mask the forward used: stream 0 over (B, T, C), 0.8 kept
    keep = dc.mstcn_dropout_mask(seed, 0, (B, T, C), 0.2)
    assert set(torch.unique(keep).tolist()) == {0.0, 1.25}
    assert abs(float((keep > 0).double().mean()) - 0.8) <= 0.01
    x, wd, bd, w1, b1, gamma, beta = [p.clone().requires_grad_(True) for p in pt]
    a = torch.relu(dc._conv3(x, wd, bd, 8))
    z = (a @ w1 + b1) * keep + x
    ref = dc._ln_two_pass(z, gamma, beta, 1e-5) if use_ln else z
    assert _rel(out.detach(), ref.detach()) <= REL
    refs = torch.autograd.grad(ref, [x, wd, bd, w1, b1, gamma, beta], g, allow_unused=True)
    for got, want in zip(grads, refs):
        want = want if want is not None else torch.zeros_like(got)
        assert _rel(got, want) <= REL
    # the mask really dropped, and another seed draws another mask
    no_drop = dc.dilated_residual_layer(*pt, dilation=8, use_ln=use_ln)
    assert float((no_drop - out.detach()).abs().max()) > 1e-2
    assert not torch.equal(dc.mstcn_dropout_mask(seed + 1, 0, (B, T, C), 0.2), keep)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_module_matches_jax_layer(use_kernel):
    """``DilatedResidualLayer.forward`` on the kernel entry and on the plain
    path against JAX's module with ``use_pallas`` (interpret mode) on the
    same parameters."""
    _, _, mask = _inputs(0)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    jmod = jlayers.DilatedResidualLayer(dilation=16, nchannels=C, dropout=0.2, layernorm=True,
                                        use_pallas=True)
    orig = jdc.dilated_residual_layer

    def interp(*a, **kw):
        return orig(*a, **dict(kw, tile=32, interpret=True))

    jdc.dilated_residual_layer = interp
    try:
        params = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(mask), True)
        ref = np.asarray(jmod.apply(params, jnp.asarray(x), jnp.asarray(mask), True))
    finally:
        jdc.dilated_residual_layer = orig
    layer = DilatedResidualLayer(16, C, True, use_kernel=use_kernel, dropout=0.2).eval()
    p = {k: torch.from_numpy(np.array(v)) for k, v in params["params"].items()}
    with torch.no_grad():
        layer.conv_dilated.weight.copy_(p["conv_dilated_kernel"].permute(2, 1, 0))
        layer.conv_dilated.bias.copy_(p["conv_dilated_bias"])
        layer.conv_1x1.weight.copy_(p["conv_1x1_kernel"].t()[:, :, None])
        layer.conv_1x1.bias.copy_(p["conv_1x1_bias"])
        layer.norm.weight.copy_(p["ln_scale"])
        layer.norm.bias.copy_(p["ln_bias"])
        got = layer(torch.from_numpy(x), torch.from_numpy(mask))
    assert _rel(got, ref) <= REL
    # train mode drops out from the generator (the mask is the port's own)
    layer.train()
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        dropped = layer(torch.from_numpy(x), torch.from_numpy(mask), generator=gen)
    assert float((dropped - got).abs().max()) > 1e-2
    with pytest.raises(ValueError, match="generator"):
        layer(torch.from_numpy(x), torch.from_numpy(mask))
