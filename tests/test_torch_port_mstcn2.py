"""The port's K6 (the MS-TCN++ tower, ``f: m2``) against the JAX package on the CPU.

``fact_clip_tpu_torch.ops.dilated_conv``'s K6 wrappers run their plain
PyTorch versions on CPU tensors; here those are held against
``dilated_residual2_stack`` run as the JAX package's own tests run it on the
CPU (the Pallas kernels in interpret mode), and the ``MSTCN2`` module against
the flax module's XLA path through the port's exporter.  Inputs are numpy
arrays from a seed, handed to both sides.  Tolerances: the forward 1e-5
absolute (values O(1), float32, sums in another order), the gradients 1e-4
of each gradient's largest value.  The CUDA kernels are checked against
these plain versions on the card by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fact_clip_tpu.models import layers as JL
from fact_clip_tpu.ops.pallas.dilated_conv import dilated_residual2_stack
from fact_clip_tpu_torch import kernel_counters
from fact_clip_tpu_torch.models import layers
from fact_clip_tpu_torch.ops import dilated_conv as dc
from fact_clip_tpu_torch.ops.dropout import dropout_mask_reference
from fact_clip_tpu_torch.utils import torch_export as ptx

torch.set_num_threads(2)
B, T, C, O, L = 3, 40, 24, 20, 4
LENGTHS = np.array([40, 23, 6], np.int32)  # the last video is shorter than d = 8
DIL = [(2 ** (L - 1 - i), 2 ** i) for i in range(L)]


def _pair(rng, shape, scale=1.0):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _case(seed, O_=O):
    rng = np.random.default_rng(seed)
    x = _pair(rng, (B, T, C))
    layers_j, layers_t = [], []
    for _ in range(L):
        parts = [_pair(rng, (3, C, C), 0.12), _pair(rng, (C,), 0.1),
                 _pair(rng, (3, C, C), 0.12), _pair(rng, (C,), 0.1),
                 _pair(rng, (C, C), 0.15), _pair(rng, (C, C), 0.15), _pair(rng, (C,), 0.1)]
        layers_j.append(tuple(p[0] for p in parts))
        layers_t.append(tuple(p[1] for p in parts))
    ow, ob = _pair(rng, (C, O_), 0.2), _pair(rng, (O_,), 0.1)
    return x, layers_j, layers_t, ow, ob


def _mask():
    return jnp.asarray(np.arange(T)[None] < LENGTHS[:, None])


@pytest.mark.parametrize("out_proj", [True, False])
def test_k6_forward_matches_pallas_interpret(out_proj):
    """With ``out_params`` the logits; without, the tower's output stream,
    which the port gives through an identity out projection."""
    x, layers_j, layers_t, ow, ob = _case(0)
    lens = torch.from_numpy(LENGTHS)
    if out_proj:
        ref = dilated_residual2_stack(x[0], _mask(), layers_j, DIL, tile=32, interpret=True,
                                      out_params=(ow[0], ob[0]))
        got = dc.mstcn2_stack_fwd(x[1], lens, layers_t, DIL, out_w=ow[1], out_b=ob[1])
    else:
        ref = dilated_residual2_stack(x[0], _mask(), layers_j, DIL, tile=32, interpret=True)
        got = dc.mstcn2_stack_fwd(x[1], lens, layers_t, DIL, out_w=torch.eye(C),
                                  out_b=torch.zeros(C))
    valid = np.asarray(_mask())
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(ref)[valid], atol=1e-5, rtol=0)
    if out_proj:  # padded frames carry the bias row
        np.testing.assert_allclose(got[2, 6:].numpy(), np.broadcast_to(ob[1].numpy(), (T - 6, O)),
                                   atol=1e-6)
    else:
        assert not got.numpy()[~valid].any()


def _rel_close(got, ref, name, tol=1e-4):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, name
    scale = max(float(np.abs(ref).max()), 1e-6)
    err = float(np.abs(got - ref).max()) / scale
    assert err <= tol, f"{name}: {err:.2e} of its scale"


def test_k6_backward_matches_jax_vjp():
    x, layers_j, layers_t, ow, ob = _case(1)
    g = np.random.default_rng(2).standard_normal((B, T, O)).astype(np.float32)
    valid = np.asarray(_mask())
    g[~valid] = 0.0  # the JAX vjp sees the padded logits; the losses never read them

    def f(x_, layers_, ow_, ob_):
        return dilated_residual2_stack(x_, _mask(), layers_, DIL, tile=32, interpret=True,
                                       out_params=(ow_, ob_))

    _, vjp = jax.vjp(f, x[0], tuple(layers_j), ow[0], ob[0])
    dx_j, dlayers_j, dow_j, dob_j = vjp(jnp.asarray(g))
    lens = torch.from_numpy(LENGTHS)
    _, streams, cs, hs = dc.mstcn2_stack_reference(x[1], lens, layers_t, DIL, out_w=ow[1],
                                                   out_b=ob[1], save=True)
    dx, dlayers, dow, dob = dc.mstcn2_stack_bwd_reference(
        torch.from_numpy(g), streams, cs, hs, lens, layers_t, DIL, out_w=ow[1], out_b=ob[1])
    _rel_close(dx.numpy()[valid], np.asarray(dx_j)[valid], "dx")
    _rel_close(dow, dow_j, "dow")
    _rel_close(dob, dob_j, "dob")
    names = ("dk1", "db1", "dk2", "db2", "dwt", "dwb", "dbf")
    for i, (lt, lj) in enumerate(zip(dlayers, dlayers_j)):
        for n, a, b in zip(names, lt, lj):
            _rel_close(a, b, f"layer {i} {n}")


def test_k6_backward_with_dropout_matches_autograd():
    """Rate 0.3 on every layer but the last: the explicit plain backward
    against torch autograd through the plain forward with the same masks."""
    x, _, layers_t, ow, ob = _case(3)
    lens = torch.from_numpy(LENGTHS)
    rates = [0.3] * (L - 1) + [0.0]
    seeds = torch.tensor([11, 12, 13, 14], dtype=torch.int32)
    xg = x[1].clone().requires_grad_(True)
    lg = [tuple(p.clone().requires_grad_(True) for p in layer) for layer in layers_t]
    owg, obg = ow[1].clone().requires_grad_(True), ob[1].clone().requires_grad_(True)
    logits = dc.mstcn2_stack_reference(xg, lens, lg, DIL, out_w=owg, out_b=obg, rates=rates,
                                       seeds=seeds)
    g = torch.from_numpy(np.random.default_rng(4).standard_normal((B, T, O)).astype(np.float32))
    flat = [p for layer in lg for p in layer]
    auto = torch.autograd.grad(logits, [xg, *flat, owg, obg], g)
    with torch.no_grad():
        _, streams, cs, hs = dc.mstcn2_stack_reference(x[1], lens, layers_t, DIL, out_w=ow[1],
                                                       out_b=ob[1], rates=rates, seeds=seeds,
                                                       save=True)
        dx, dlayers, dow, dob = dc.mstcn2_stack_bwd_reference(
            g, streams, cs, hs, lens, layers_t, DIL, out_w=ow[1], out_b=ob[1], rates=rates,
            seeds=seeds)
    explicit = [dx, *[t for layer in dlayers for t in layer], dow, dob]
    for i, (a, b) in enumerate(zip(explicit, auto)):
        _rel_close(a, b, f"grad {i}", tol=1e-5)
    # the autograd entry takes the same path on CPU tensors
    ent = dc.mstcn2_stack(xg, lens, lg, DIL, out_w=owg, out_b=obg, rates=rates, seeds=seeds)
    np.testing.assert_array_equal(ent.detach().numpy(), logits.detach().numpy())
    assert all(v == 0 for v in kernel_counters().values())


def test_mstcn2_module_never_drops_the_last_layer():
    """In train mode the module draws one seed per layer and runs every
    layer but the last at its dropout rate (layers.py:480-482)."""
    torch.manual_seed(0)
    m = layers.MSTCN2(12, 16, 10, 3, in_map=True, dropout=0.5).train()
    x = torch.randn(2, 30, 12)
    lens = torch.tensor([30, 17], dtype=torch.int32)
    with torch.no_grad():
        got = m(x, lens, torch.Generator().manual_seed(7))
        seeds = torch.randint(0, 2 ** 31 - 1, (3,), generator=torch.Generator().manual_seed(7),
                              dtype=torch.int32)
        h = torch.nn.functional.linear(x, m.conv_1x1_in.weight[:, :, 0], m.conv_1x1_in.bias)
        lay, ow, ob, _ = m.kernel_layout()
        kw = dict(out_w=ow, out_b=ob, seeds=seeds)
        ref = dc.mstcn2_stack_reference(h, lens, lay, m.dil_pairs, rates=[0.5, 0.5, 0.0], **kw)
        all_dropped = dc.mstcn2_stack_reference(h, lens, lay, m.dil_pairs, rates=[0.5] * 3, **kw)
    np.testing.assert_array_equal(got.numpy(), ref.numpy())
    assert not torch.equal(got, all_dropped)
    # the last layer's mask would have dropped values of its output
    assert float((dropout_mask_reference(seeds[2], 2, (2, 30, 16), 0.5) == 0).float().mean()) > 0.3


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("in_map", [True, False])
def test_mstcn2_module_matches_flax_on_valid_frames(use_kernel, in_map):
    """The JAX XLA path leaves padded frames unzeroed (layers.py:509-511):
    compared on valid frames only."""
    rng = np.random.default_rng(5)
    D = 12 if in_map else 16
    Bm, Tm, H, Om, Lm = 2, 50, 16, 20, 4
    x = rng.standard_normal((Bm, Tm, D)).astype(np.float32)
    lengths = np.array([50, 13], np.int32)
    mask = np.arange(Tm)[None] < lengths[:, None]
    jm = JL.MSTCN2(in_dim=D, hid_dim=H, out_dim=Om, num_layers=Lm, dropout=0.0, in_map=in_map,
                   use_pallas=False)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask), True)
    ref = np.asarray(jm.apply(params, jnp.asarray(x), jnp.asarray(mask), True))
    sd = {}
    ptx._mstcn2(sd, "m", jax.tree_util.tree_map(np.asarray, params["params"]), in_map)
    pm = layers.MSTCN2(D, H, Om, Lm, in_map=in_map, use_kernel=use_kernel)
    pm.load_state_dict({k[2:]: torch.from_numpy(np.array(v)) for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = pm(torch.from_numpy(x), torch.from_numpy(lengths)).numpy()
    np.testing.assert_allclose(got[mask], ref[mask], atol=1e-4)
