"""K6, the MS-TCN++ tower (``f: m2``), under mixed precision
(``TPU.compute_dtype: bfloat16``) in the port, on the CPU.

The port's plain versions of K6's bf16 forms (what ``mstcn2_stack16`` and
``mstcn2_stack16_train`` run on CPU tensors) are held against JAX's: the
forward against ``dilated_residual2_stack`` on bf16 inputs with its Pallas
kernel in interpret mode (``_stack2_kernel``, not ``_stack2_reference``,
which rounds elsewhere), with and without ``out_params``, at T not a
multiple of the tile and with a video of 0 frames; the backward against
``jax.vjp`` of the same, its cotangents in the primals' dtypes.  The
grouped towers (``f_ngp > 1``) against JAX's flax modules, which compute
them outside any kernel, forward and gradients.  Then a narrow Breakfast-shaped ``iuUU`` with
``f: m2`` in bf16 against JAX's model block by block, as an eval step and
as a train step (JAX's ``make_step_fns`` with its kernels in interpret mode
and the host matcher); ``breakfast_bf16_cfg()`` against ``breakfast.yaml``
with the override; ``run_train`` on ``breakfast.yaml`` in bf16 over a
fixture set with a resume, its checkpoint read by JAX's model.  Inputs are
made with numpy from a seed.

Tolerances (``tests/test_torch_port_bf16.py``'s and
``tests/test_torch_port_bf16_train.py``'s):
* one layer's bf16 stream: within 2 bf16 ulps of JAX's (the same roundings
  of f32 sums formed in another order); a tower's f32 logits within 1e-2 of
  their scale (one-ulp flips of the stream compound over the layers);
* cotangents: 2^-7 of the reference's scale for one layer, 2^-6 through a
  3-layer tower; a weight gradient JAX rounds to bf16 holds a bf16 value;
* a grouped tower's gradients (its ReLU gates kept away from 0): within
  2e-2 of each one's scale and a cosine of at least 0.9999;
* the narrow model: f32 logits within 2e-2 of scale and at least 95 % of
  the frame predictions equal; the train step's matching equal, its loss
  within 1e-4 relative, every gradient within 2e-2 of its scale with a
  cosine of at least 0.9999 with JAX's.
"""

import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fact_clip_tpu.models import layers as JL
from fact_clip_tpu.ops.pallas import dilated_conv as jdc
from fact_clip_tpu.ops.pallas import frame_loss as jfl
from fact_clip_tpu.ops.pallas import mha_attn as jmha
from fact_clip_tpu.ops.pallas import sa_layer as jsa
from fact_clip_tpu.ops.pallas import x2y_attn as jx2y
from fact_clip_tpu_torch import kernel_counters
from fact_clip_tpu_torch.models import layers
from fact_clip_tpu_torch.ops import dilated_conv as dc
from fact_clip_tpu_torch.utils import torch_export as ptx

BF = jnp.bfloat16
ULPS = 2
TOWER_TOL = 1e-2
FORM_TOL = 2.0 ** -7
BWD_TOWER_TOL = 2.0 ** -6
MODEL_TOL = 2e-2
MIN_AGREE = 0.95
GRAD_TOL = 2e-2
GRAD_COS = 0.9999
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML = os.path.join(REPO, "fact_clip_tpu", "configs", "breakfast.yaml")


@pytest.fixture(autouse=True)
def _two_threads():
    """Each test at two intra-op threads (the sums' order, so a bf16 rounding
    here and there, follows the count; a whole run sets it per module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        jnp.asarray(t).astype(jnp.float32))


def _ulps(got, ref):
    got, ref = _np(got), _np(ref)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 2.0 ** -126))) - 7)
    return float(np.max(np.abs(got - ref) / ulp))


def _rel(got, ref):
    got, ref = _np(got), _np(ref)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _pair16(rng, shape, scale=1.0):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    j = jnp.asarray(a).astype(BF)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)


def _pair(rng, shape, scale=1.0):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _is_bf16_valued(t):
    return torch.equal(t, t.to(torch.bfloat16).float())


def _tower2(rng, C, O, L):
    """L layers (k1, b1, k2, b2, wt, wb, bf) as (jax, torch) f32 pairs, and
    the out projection."""
    layers = [[_pair(rng, (3, C, C), 1.0 / np.sqrt(3 * C)), _pair(rng, (C,), 0.1),
               _pair(rng, (3, C, C), 1.0 / np.sqrt(3 * C)), _pair(rng, (C,), 0.1),
               _pair(rng, (C, C), 1.0 / np.sqrt(2 * C)), _pair(rng, (C, C), 1.0 / np.sqrt(2 * C)),
               _pair(rng, (C,), 0.1)] for _ in range(L)]
    return layers, _pair(rng, (C, O), 1.0 / np.sqrt(C)), _pair(rng, (O,), 0.1)


def _jax_layers(layers):
    """JAX's bf16 call (``layers.py:462-468``): the weights cast, the biases f32."""
    return [tuple(p[0].astype(BF) if i in (0, 2, 4, 5) else p[0] for i, p in enumerate(layer))
            for layer in layers]


# ---------------------------------------------------------------------------
# K6's bf16 forms against JAX's kernels in interpret mode


@pytest.mark.parametrize("L,C,proj", [(1, 32, False), (1, 32, True), (10, 32, True),
                                      (3, 24, True), (3, 24, False)])
def test_k6_tower16_matches_jax_interpret(L, C, proj):
    """K6's plain bf16 tower against ``dilated_residual2_stack`` on bf16 x and
    weights (tile 128, T = 200 not a multiple of it; a video of 0 frames):
    without ``out_params`` its bf16 stream (one layer within 2 ulps, three
    layers within 1e-2 of scale); with them the logits, one layer through an
    identity out projection (exact: the stream) within 2 ulps, a tower's
    within 1e-2 of scale; the padded frames' stream zero."""
    rng = np.random.default_rng(10 * L + C)
    B, T = 3, 200
    O = C if L == 1 else 16
    x_j, x_t = _pair16(rng, (B, T, C))
    lengths = np.array([T, 133, 0], np.int32)
    mask = np.arange(T)[None] < lengths[:, None]
    layers2, (ow_j, ow_t), (ob_j, ob_t) = _tower2(rng, C, O, L)
    if L == 1:  # the identity: the logits are the layer's stream
        ow_j, ow_t = jnp.eye(C), torch.eye(C)
        ob_j, ob_t = jnp.zeros(C), torch.zeros(C)
    dil = [(2 ** (L - 1 - i), 2 ** i) for i in range(L)]
    tl = [tuple(p[1] for p in layer) for layer in layers2]
    lens = torch.from_numpy(lengths)
    ref = jax.jit(lambda x, jl, op: jdc.dilated_residual2_stack(
        x, jnp.asarray(mask), jl, dil, tile=128, interpret=True, out_params=op))(
            x_j, _jax_layers(layers2), (ow_j.astype(BF), ob_j) if proj else None)
    got, streams, _, _ = dc.mstcn2_stack16_reference(x_t, lens, tl, dil, out_w=ow_t, out_b=ob_t,
                                                     save=True)
    assert got.dtype == torch.float32 and streams[-1].dtype == torch.bfloat16
    assert not streams[-1].float().numpy()[~mask].any()
    if proj:
        assert ref.dtype == jnp.float32
        err = _ulps(got, ref) if L == 1 else _rel(got, ref)
        assert err <= (ULPS if L == 1 else TOWER_TOL), err
    else:
        assert ref.dtype == BF
        err = _ulps(streams[-1], ref) if L == 1 else _rel(streams[-1], ref)
        assert err <= (ULPS if L == 1 else TOWER_TOL), err
    before = kernel_counters()
    assert torch.equal(dc.mstcn2_stack16(x_t, lens, tl, dil, out_w=ow_t, out_b=ob_t), got)
    assert kernel_counters() == before  # CPU tensors: the plain version, no launch


@pytest.mark.parametrize("L", [1, 3])
def test_k6_bwd16_matches_jax_vjp(L):
    """K6's bf16 backward (``mstcn2_stack16_bwd_reference``) against the vjp
    of ``dilated_residual2_stack`` with ``out_params`` on bf16 x, k1, k2, Wt,
    Wb and Wo (interpret mode, tile 128, T = 200, a video of 0 frames): the
    cotangents in the primals' dtypes (dx bf16, the weights' bf16 values, the
    biases f32), each within 2^-7 of its scale for a layer, 2^-6 through
    three.  Both sides start from the same forward state, as JAX's backward
    replays its own forward: the saves hold JAX's streams (each layer's
    output from ``dilated_residual2_stack`` on the one before it), and
    [c1 | c2] and the ReLU outputs of the plain forward layer on each (a
    stream of the plain tower may land a bf16 ulp from JAX's, which can move
    a ReLU input near 0 to the other side: a whole cotangent of that unit)."""
    rng = np.random.default_rng(20 + L)
    B, T, C, O = 3, 200, 32, 16
    x_j, x_t = _pair16(rng, (B, T, C))
    lengths = np.array([T, 133, 0], np.int32)
    mask = np.arange(T)[None] < lengths[:, None]
    layers2, (ow_j, ow_t), (ob_j, ob_t) = _tower2(rng, C, O, L)
    dil = [(2 ** (L - 1 - i), 2 ** i) for i in range(L)]
    g_j, g_t = _pair(rng, (B, T, O))

    def fwd(x, jl, ow, ob):
        return jdc.dilated_residual2_stack(x, jnp.asarray(mask), jl, dil, tile=128,
                                           interpret=True, out_params=(ow, ob))

    @jax.jit
    def jax_side(prim, g):  # the vjp, and each layer's output stream
        ys = [prim[0]]
        for i in range(L):
            ys.append(jdc.dilated_residual2_stack(ys[-1], jnp.asarray(mask), prim[1][i:i + 1],
                                                  dil[i:i + 1], tile=128, interpret=True))
        return jax.vjp(fwd, *prim)[1](g), ys[1:]

    prim = (x_j, _jax_layers(layers2), ow_j.astype(BF), ob_j)
    (dx_j, dl_j, dow_j, dob_j), ys = jax_side(prim, g_j)
    for p, d in zip(jax.tree_util.tree_leaves(prim), jax.tree_util.tree_leaves(
            (dx_j, dl_j, dow_j, dob_j))):
        assert d.dtype == p.dtype and np.isfinite(_np(d)).all()

    tl = [tuple(p[1] for p in layer) for layer in layers2]
    lens = torch.from_numpy(lengths)
    streams, cs, hs = [x_t * torch.from_numpy(mask)[..., None].to(torch.bfloat16)], [], []
    for i in range(L):
        _, _, c, h = dc.mstcn2_stack16_reference(streams[i], lens, tl[i:i + 1], dil[i:i + 1],
                                                 out_w=ow_t, out_b=ob_t, save=True)
        cs.append(c[0])
        hs.append(h[0])
        streams.append(torch.from_numpy(np.array(_np(ys[i]))).to(torch.bfloat16))
    dx, dl, dow, dob = dc.mstcn2_stack16_bwd_reference(g_t, streams, cs, hs, lens, tl, dil,
                                                       out_w=ow_t, out_b=ob_t)
    assert dx.dtype == torch.bfloat16 and not dx.float().numpy()[~mask].any()
    assert _is_bf16_valued(dow) and dob.dtype == torch.float32
    tol = FORM_TOL if L == 1 else BWD_TOWER_TOL
    names = ("dk1", "db1", "dk2", "db2", "dwt", "dwb", "dbf")
    for name, g, r in zip(("dx", "dow", "dob"), (dx, dow, dob), (dx_j, dow_j, dob_j)):
        assert _rel(g, r) <= tol, (name, _rel(g, r))
    for i in range(L):
        for j, name in enumerate(names):
            g, r = dl[i][j], dl_j[i][j]
            assert g.dtype == torch.float32
            assert (r.dtype == BF) == (j in (0, 2, 4, 5)) and (j not in (0, 2, 4, 5)
                                                               or _is_bf16_valued(g))
            assert _rel(g, r) <= tol, (i, name, _rel(g, r))


def test_k6_train16_function_matches_its_plain_pieces():
    """``mstcn2_stack16_train`` on CPU tensors: the logits of the plain
    forward, and autograd's gradients are the plain backward's (the weight
    cotangents back in the f32 parameters)."""
    rng = np.random.default_rng(3)
    B, T, C, O, L = 2, 64, 16, 8, 2
    x = _pair16(rng, (B, T, C))[1].requires_grad_(True)
    lens = torch.tensor([T, 40], dtype=torch.int32)
    layers2, (_, ow), (_, ob) = _tower2(rng, C, O, L)
    tl = [tuple(p[1].clone().requires_grad_(True) for p in layer) for layer in layers2]
    ow.requires_grad_(True)
    ob.requires_grad_(True)
    dil = [(2, 1), (1, 2)]
    logits = dc.mstcn2_stack16_train(x, lens, tl, dil, out_w=ow, out_b=ob)
    g = torch.from_numpy(rng.standard_normal((B, T, O)).astype(np.float32))
    grads = torch.autograd.grad(logits, [x, ow, ob, *[p for la in tl for p in la]], g)
    with torch.no_grad():
        plain = [tuple(p.detach() for p in la) for la in tl]
        ref, streams, cs, hs = dc.mstcn2_stack16_reference(x.detach(), lens, plain, dil,
                                                           out_w=ow.detach(), out_b=ob.detach(),
                                                           save=True)
        dx, dl, dow, dob = dc.mstcn2_stack16_bwd_reference(g, streams, cs, hs, lens, plain, dil,
                                                           out_w=ow.detach(), out_b=ob.detach())
    assert torch.equal(logits.detach(), ref)
    want = [dx, dow, dob, *[t for la in dl for t in la]]
    for a, b in zip(grads, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_k6_bf16_forms_refuse_before_any_launch(monkeypatch):
    """Off the CPU, a width the bf16 GEMM does not take (C % 8), a stream that
    is not bf16 or a grouped layer raises before the library is asked for,
    forward and backward."""
    from fact_clip_tpu_torch import _build

    def no_lib():
        raise AssertionError("the kernel library was asked for")

    monkeypatch.setattr(_build, "lib", no_lib)
    f32, bf = torch.float32, torch.bfloat16
    meta = lambda *s, dt=f32: torch.empty(s, device="meta", dtype=dt)  # noqa: E731

    def layer(C, g=1):
        return (meta(3, C // g, C), meta(C), meta(3, C // g, C), meta(C), meta(C, C), meta(C, C),
                meta(C))

    lens = torch.empty(2, device="meta", dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="C=20"):
        dc.mstcn2_stack16(meta(2, 64, 20, dt=bf), lens, [layer(20)], [(1, 1)],
                          out_w=meta(20, 8), out_b=meta(8))
    with pytest.raises(ValueError, match="bfloat16"):
        dc.mstcn2_stack16(meta(2, 64, 24), lens, [layer(24)], [(1, 1)], out_w=meta(24, 8),
                          out_b=meta(8))
    with pytest.raises(ValueError, match="ungrouped"):
        dc.mstcn2_stack16(meta(2, 64, 24, dt=bf), lens, [layer(24, 2)], [(1, 1)],
                          out_w=meta(24, 8), out_b=meta(8))
    with pytest.raises(NotImplementedError, match="C=20"):
        dc.mstcn2_stack16_bwd(meta(2, 64, 8), [meta(2, 64, 20, dt=bf)] * 2,
                              [meta(2, 64, 40, dt=bf)], [meta(2, 64, 20, dt=bf)], lens,
                              [layer(20)], [(1, 1)], out_w=meta(20, 8), out_b=meta(8))


# ---------------------------------------------------------------------------
# grouped towers (f_ngp > 1) against JAX's flax modules (outside any kernel)


def _gates_apart(params, kind, rng):
    """``params`` with every tower ReLU's input kept at |z| >= ~0.5: the
    gate's bias (the fuse's for MS-TCN++, the dilated conv's for MSTCN) of
    magnitude 1 to 1.5 and a random sign, the weights feeding it scaled by
    0.3 (``chip_smoke.ffn_case(away_from_zero=True)``'s rule).  Both sides
    then agree on every gate, so no ReLU flips between them."""
    p = jax.tree_util.tree_map(np.array, params)
    if kind == "m2":
        gates = [(p, k, k.replace("_bias", "_kernel")) for k in list(p)
                 if k.startswith("fuse_") and k.endswith("_bias")]
    else:
        gates = [(node, "conv_dilated_bias", "conv_dilated_kernel") for k, node in p.items()
                 if k.startswith("DilatedResidualLayer_")]
    for node, bias, kernel in gates:
        n = node[bias].shape[0]
        node[bias] = (np.sign(rng.standard_normal(n)) * rng.uniform(1.0, 1.5, n)).astype(np.float32)
        node[kernel] = node[kernel] * np.float32(0.3)
    return p


@pytest.mark.parametrize("kind", ["m2", "m"])
def test_grouped_tower16_matches_flax(kind):
    """A grouped tower (ngroup 2, 4 layers) under bf16 against JAX's flax
    module with ``dtype=bfloat16`` (its XLA path: ``layers.py:494-508`` for
    MS-TCN++, the unfused layers ``:290-331`` for MSTCN), through the port's
    exporter: the f32 logits on valid frames within 1e-2 of scale; then,
    with the ReLU gates kept apart (``_gates_apart``), every parameter's
    gradient of the valid frames' squared logits against ``jax.grad`` of the
    same: within 2e-2 of its scale and a cosine of at least 0.9999 (the
    narrow train step's limits).  At random weights a one-ulp difference of
    a rounded ReLU input near 0 flips its gate on one side only, which moves
    a whole unit's cotangent; the forward does not see it."""
    rng = np.random.default_rng(7)
    Bm, Tm, D, H, Om, Lm = 2, 50, 12, 16, 20, 4
    x = rng.standard_normal((Bm, Tm, D)).astype(np.float32)
    lengths = np.array([50, 13], np.int32)
    mask = np.arange(Tm)[None] < lengths[:, None]
    if kind == "m2":
        jm = JL.MSTCN2(in_dim=D, hid_dim=H, out_dim=Om, num_layers=Lm, dropout=0.0,
                       in_map=True, ngroup=2, dtype=BF)
        pm = layers.MSTCN2(D, H, Om, Lm, ngroup=2, in_map=True, dtype=torch.bfloat16)
    else:
        jm = JL.MSTCN(in_dim=D, hid_dim=H, out_dim=Om, num_layers=Lm, dropout=0.0, ln=False,
                      in_map=True, ngroup=2, dtype=BF)
        pm = layers.MSTCN(D, H, Om, Lm, ln=False, ngroup=2, in_map=True, dtype=torch.bfloat16)
    export = ptx._mstcn2 if kind == "m2" else ptx._mstcn
    xj, mj = jnp.asarray(x), jnp.asarray(mask)
    xt, lt, mt = torch.from_numpy(x), torch.from_numpy(lengths), torch.from_numpy(mask)

    def load(tree):  # a flax tree (parameters or gradients) -> the port's names, numpy
        sd = {}
        export(sd, "m", jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree), True)
        return {k[2:]: v for k, v in sd.items()}

    params = jm.init(jax.random.PRNGKey(0), xj, mj, True)
    ref = np.asarray(jax.jit(lambda p, a, m: jm.apply(p, a, m, True))(params, xj, mj))
    assert ref.dtype == np.float32
    pm.load_state_dict({k: torch.tensor(v) for k, v in load(params["params"]).items()},
                       strict=True)
    with torch.no_grad():
        got = pm(xt, lt)
    assert got.dtype == torch.float32
    assert _rel(got.numpy()[mask], ref[mask]) <= TOWER_TOL, _rel(got.numpy()[mask], ref[mask])

    apart = {"params": _gates_apart(params["params"], kind, rng)}

    def loss(p):
        out = jm.apply(p, xj, mj, True)
        return jnp.sum(jnp.where(mj[..., None], out, 0.0) ** 2)

    want = load(jax.jit(jax.grad(loss))(apart)["params"])
    pm.load_state_dict({k: torch.tensor(v) for k, v in load(apart["params"]).items()},
                       strict=True)
    names = [n for n, _ in pm.named_parameters()]
    grads = torch.autograd.grad(pm(xt, lt)[mt].square().sum(), list(pm.parameters()))
    assert set(names) == set(want)
    for n, g in zip(names, grads):
        assert g.dtype == torch.float32 and torch.isfinite(g).all(), n
        g, r = g.numpy(), want[n]
        err = float(np.abs(g - r).max() / np.abs(r).max())
        cos = float((g * r).sum() / (np.linalg.norm(g) * np.linalg.norm(r)))
        assert err <= GRAD_TOL and cos >= GRAD_COS, (n, err, cos)


# ---------------------------------------------------------------------------
# a narrow Breakfast-shaped model in bf16 against JAX's, block by block


D, C, S_CAP, B, T, S = 12, 5, 24, 2, 96, 8


def _interp(fn):
    def f(*a, **kw):
        return fn(*a, **dict(kw, interpret=True))
    return f


def _cfgs():
    """``_make_cfg(small=True)`` / ``small_cfg()`` with Breakfast's tower
    (``f: m2``) under bf16 with the host matcher (Breakfast's), at dropout 0
    (Breakfast's, the only rate bf16 trains at), no channel masking (its
    random draws differ between the two)."""
    from __graft_entry__ import _make_cfg
    from fact_clip_tpu_torch.configs import small_cfg

    jcfg, cfg = _make_cfg(small=True), small_cfg()
    jcfg.Bi.f = cfg["Bi"]["f"] = "m2"
    jcfg.TPU.compute_dtype = cfg["TPU"]["compute_dtype"] = "bfloat16"
    jcfg.TPU.matcher = cfg["TPU"]["matcher"] = "host"
    jcfg.Bi.dropout = cfg["Bi"]["dropout"] = 0.0
    jcfg.FACT.cmr = cfg["FACT"]["cmr"] = 0.0
    # depth cut for JAX's compile time of its interpret-mode kernels
    jcfg.Bi.f_layers = cfg["Bi"]["f_layers"] = 2
    jcfg.Bu.f_layers = cfg["Bu"]["f_layers"] = 1
    jcfg.BU.f_layers = cfg["BU"]["f_layers"] = 1
    return jcfg, cfg


@pytest.fixture(scope="module")
def m2_run():
    """JAX's bf16 model with ``f: m2`` (its Pallas kernels in interpret mode)
    on a port model's weights and a seeded batch: the train step's gradients
    (``make_step_fns``, the host matcher) and outputs, and the forward's saves
    and decoded frames (at dropout 0 with no masking, the train-mode forward
    that the matching reads is the eval forward: one compilation for both)."""
    from fact_clip_tpu.engine.steps import make_step_fns
    from fact_clip_tpu.models import blocks as jblocks
    from fact_clip_tpu.models import decode as jdecode
    from fact_clip_tpu.models import losses as jl
    from fact_clip_tpu.models import matching as jmatching
    from fact_clip_tpu.utils.torch_import import convert_fact_state_dict
    from fact_clip_tpu_torch.engine.train_loop import synthetic_batch
    from fact_clip_tpu_torch.models.blocks import build_fact

    jcfg, cfg = _cfgs()
    batch = synthetic_batch(np.random.default_rng(0), D, C, S, T, [96, 61])
    port = build_fact(cfg, D, C, S_CAP, device="cpu", generator=torch.Generator().manual_seed(4))
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
            mock.patch.object(jdc, "dilated_residual2_stack",
                              _interp(jdc.dilated_residual2_stack)), \
            mock.patch.object(jx2y, "x2y_attention", _interp(jx2y.x2y_attention)), \
            mock.patch.object(jmha, "mha_cross_attention", _interp(jmha.mha_cross_attention)), \
            mock.patch.object(jsa, "sa_sublayer", _interp(jsa.sa_sublayer)), \
            mock.patch.object(jsa, "ffn_sublayer", _interp(jsa.ffn_sublayer)), \
            mock.patch.object(jfl, "fused_ce_smooth_sums", _interp(jfl.fused_ce_smooth_sums)), \
            mock.patch.object(jfl, "fused_smooth_sum", _interp(jfl.fused_smooth_sum)):
        jmodel = jblocks.build_fact(jcfg, D, C, s_pred_cap=S_CAP)
        assert {c.dtype for c in jmodel.block_cfgs} == {"bfloat16"}
        assert {c.f for c in jmodel.block_cfgs} == {"m2"} and all(
            c.pallas for c in jmodel.block_cfgs)
        train_step, _ = make_step_fns(jmodel, jcfg, C, cweight)

        @jax.jit
        def step(p, b):
            key = jax.random.PRNGKey(0)
            st, o = train_step.unjitted(Capture(p), b, key)
            rngs = {"dropout": jax.random.fold_in(key, 0), "aug": jax.random.fold_in(key, 1)}
            saves, _ = jmodel.apply({"params": p}, b["feats"], b["mask"], b["lengths"],
                                    train=True, rngs=rngs)
            last = saves[-1]
            o["seg2tok"] = jmatching.match(
                jcfg.Loss, jax.nn.softmax(last["action_clogit"], axis=-1), last["a2f_attn"],
                b["transcript"], b["seg_label"], b["seg_mask"], b["mask"], matcher="host",
                nclasses=C)
            return st.grads, o, [{k: v for k, v in sv.items() if k != "kind"} for sv in saves]

        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        grads, out, saves = step(params, jb)
    last = saves[-1]
    pred = jdecode.decode_two_branch(last["action_clogit"], last["a2f_attn"],
                                     last["frame_clogit"], float(jcfg.FACT.mwt),
                                     jnp.ones(last["action_clogit"].shape[:2], bool))
    return dict(cfg=cfg, batch=batch, params=params, cweight=np.asarray(cweight),
                grads=jax.tree_util.tree_map(np.asarray, grads),
                out={k: np.asarray(v) for k, v in out.items()}, pred=np.asarray(pred),
                saves=[{k: np.asarray(v) for k, v in s.items()} for s in saves])


def _port(run, kernels=True):
    from fact_clip_tpu_torch.models.blocks import build_fact
    from fact_clip_tpu_torch.utils.bridge import load_jax_params

    model = build_fact(run["cfg"], D, C, S_CAP, device="cpu")
    load_jax_params(model, run["params"])
    model.set_kernels(kernels)
    return model


@pytest.mark.parametrize("kernels", [True, False])
def test_narrow_m2_bf16_model_matches_jax_block_by_block(m2_run, kernels):
    """Every block's f32 frame and action logits within 2e-2 of scale of
    JAX's, the eval step's frames at least 95 % equal; the towers are K6's
    bf16 form (``MSTCN2`` with dtype bf16), no kernel launches on CPU
    tensors."""
    from fact_clip_tpu_torch.engine.steps import make_eval_step
    from fact_clip_tpu_torch.engine.train_loop import batch_to_device

    model = _port(m2_run, kernels)
    assert all(isinstance(b.frame_branch, layers.MSTCN2) and b.frame_branch.dtype == torch.bfloat16
               for b in model.block_list)
    x = batch_to_device(m2_run["batch"], "cpu", torch.bfloat16)
    args = (x["feats"], x["mask"], x["lengths"])
    mask = m2_run["batch"]["mask"]
    before = kernel_counters()
    with torch.no_grad():
        saves, _ = model(*args)
    assert kernel_counters() == before
    for i, (sp, sj) in enumerate(zip(saves, m2_run["saves"])):
        for key in ("frame_clogit", "action_clogit"):
            got, ref = sp[key], sj[key]
            assert got.dtype == torch.float32
            got, ref = (got.numpy()[mask], ref[mask]) if key == "frame_clogit" else (
                got.numpy(), ref)
            assert _rel(got, ref) <= MODEL_TOL, (i, key, _rel(got, ref))
    pred = make_eval_step(model, 0.1)(*args).numpy()
    assert float((pred == m2_run["pred"])[mask].mean()) >= MIN_AGREE


def test_narrow_m2_bf16_train_step_matches_jax(m2_run):
    """The port's bf16 ``TrainStep`` (K6's bf16 training form and the other
    bf16 forms' Functions on CPU tensors, the host matcher) against JAX's:
    equal seg2tok, the loss within 1e-4 relative, every parameter's gradient
    within GRAD_TOL of its own scale and a cosine of GRAD_COS with JAX's, the
    towers' included; the update applied to the f32 parameters."""
    from fact_clip_tpu_torch.engine.steps import make_train_step
    from fact_clip_tpu_torch.engine.train_loop import batch_to_device
    from fact_clip_tpu_torch.utils.bridge import grads_from_jax

    run = m2_run
    model = _port(run)
    step = make_train_step(model, run["cfg"], C, run["cweight"])
    assert step.matcher == "host"
    x = batch_to_device(run["batch"], "cpu", torch.bfloat16)
    per_video, seg2tok, _ = step.loss(x, torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(seg2tok.numpy(), run["out"]["seg2tok"])
    np.testing.assert_allclose(per_video.detach().numpy(), run["out"]["per_video_loss"],
                               rtol=1e-4)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(per_video.mean(), list(model.parameters()))
    ref = grads_from_jax(run["grads"], model.block_cfgs)
    assert set(names) == set(ref) and any("conv_fusion" in n for n in names)
    worst, cos = {}, {}
    for n, g in zip(names, grads):
        assert g.dtype == torch.float32, n
        r = ref[n].numpy()
        scale_of = n.replace("X_K.bias", "X_K.weight")  # a key bias cancels to about 0
        scale = max(np.abs(ref[scale_of].numpy()).max(), 1e-12)
        worst[n] = float(np.abs(g.numpy() - r).max() / scale)
        if np.abs(r).max() > 0 and scale_of == n:
            cos[n] = float((g.numpy() * r).sum()
                           / (np.linalg.norm(g.numpy()) * np.linalg.norm(r)))
        else:
            assert scale_of != n or not g.numpy().any(), n
    bad = {n: e for n, e in worst.items() if e > GRAD_TOL}
    assert not bad, bad
    assert min(cos.values()) >= GRAD_COS, min(cos.values())
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    out = step(x, torch.Generator().manual_seed(0))
    np.testing.assert_allclose(float(out["loss"]), float(run["out"]["loss"]), rtol=1e-4)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert any(not torch.equal(before[n], p) for n, p in model.named_parameters()
               if "conv_dilated" in n)


# ---------------------------------------------------------------------------
# breakfast_bf16_cfg(), and the loop on breakfast.yaml in bf16


def test_breakfast_bf16_cfg_equals_the_yaml_with_the_override(monkeypatch):
    """``breakfast_bf16_cfg()`` resolves as ``breakfast.yaml --set
    TPU.compute_dtype bfloat16`` does in the JAX package (block field by
    block field, bf16 everywhere), with the host matcher; nothing refuses
    it, nor EgoProceL under bf16; its model's state_dict has the f32
    model's keys and shapes (the bridge's, ``utils/bridge.py``)."""
    import dataclasses

    from fact_clip_tpu.configs.utils import setup_cfg as jax_setup_cfg
    from fact_clip_tpu.models import blocks as jblocks
    from fact_clip_tpu_torch.configs import (bf16_refusal, breakfast_bf16_cfg, egoprocel_cfg,
                                             resolve_block_cfgs, setup_cfg)

    monkeypatch.setattr(jblocks, "_PALLAS_PLATFORM_OVERRIDE", "tpu")
    jcfg = jax_setup_cfg([YAML], ["TPU.compute_dtype", "bfloat16"])
    ref = jblocks.resolve_block_cfgs(jcfg)
    cfg = breakfast_bf16_cfg()
    got = resolve_block_cfgs(cfg)
    pallas = ("pallas", "pallas_attn", "pallas_sa")
    strip = lambda c: {k: v for k, v in dataclasses.asdict(c).items() if k not in pallas}  # noqa: E731
    assert [strip(c) for c in got] == [strip(c) for c in ref]
    assert {c.dtype for c in got} == {"bfloat16"} and {c.f for c in got} == {"m2"}
    assert [(c.f_dim, c.f_layers, c.a_dim, c.a_nhead) for c in got] == [(512, 10, 512, 8)] * 4
    assert cfg["TPU"]["matcher"] == "host" and cfg["Bi"]["dropout"] == 0.0
    assert bf16_refusal(cfg) is None
    port_yaml = setup_cfg([YAML], ["TPU.compute_dtype", "bfloat16"])
    assert resolve_block_cfgs(port_yaml) == got
    ego = egoprocel_cfg()
    ego["TPU"]["compute_dtype"] = "bfloat16"
    assert bf16_refusal(ego) is None
    # the bf16 model takes the f32 parameters (the bridge's keys) unchanged
    from fact_clip_tpu_torch.configs import breakfast_cfg
    from fact_clip_tpu_torch.models.blocks import build_fact

    shapes = [{k: v.shape for k, v in build_fact(c, 2048, 48, 64, device="meta").state_dict().items()}
              for c in (cfg, breakfast_cfg())]
    assert shapes[0] == shapes[1]


# breakfast.yaml narrowed for the CPU by an overlay (its keys stay out of the
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
  hid_dim: 32
  a_dim: 32
  a_ffdim: 32
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
  compute_dtype: bfloat16
  matcher: host
  bucket_multiple: 64
  num_data_shards: 1
"""


@pytest.fixture(scope="module")
def breakfast_set(tmp_path_factory):
    from fact_clip_tpu_torch.data.synthetic import make_fixture_dataset

    root = tmp_path_factory.mktemp("breakfast16")
    base = make_fixture_dataset(str(root), name="breakfast", n_classes=5, n_train=6, n_test=3,
                                feat_dim=16, min_len=60, max_len=120, min_segs=3, max_segs=5,
                                class_sep=3.0)
    overlay = root / "narrow.yaml"
    overlay.write_text(OVERLAY.format(base=base))
    return dict(root=root, cfgs=[YAML, str(overlay)])


def test_run_train_trains_breakfast_bf16_resumes_and_jax_reads_it(breakfast_set, tmp_path):
    """``run_train`` on breakfast.yaml in bf16 over the fixture set writes its
    run; four steps against two, a checkpoint, a load into a model of other
    weights and two more: the same parameters and Adam state bit for bit;
    the checkpoint (f32 parameters in the reference's layout) read by JAX's
    importer into JAX's model, whose f32 frame logits (XLA, no Pallas) are
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

    cfg = setup_cfg(breakfast_set["cfgs"], [])
    assert cfg.TPU.compute_dtype == "bfloat16" and cfg.Bi.f == "m2"
    cfg.aux.logdir = "log/breakfast16"
    tl.check_loop_cfg(cfg)
    tl.run_train(cfg, device="cpu", base_dir=str(tmp_path))
    logdir = tmp_path / cfg.aux.logdir
    assert (logdir / "metrics.jsonl").exists() and list((logdir / "ckpts").iterdir())

    seed, fdt = cfg.aux.seed, tl.feats_dtype(cfg)
    assert fdt == torch.bfloat16

    def train(step, batches, steps):
        for g in steps:
            step(tl.batch_to_device(batches[g], "cpu", fdt), tl.step_generator(seed, g, "cpu"))

    whole = build_experiment(cfg, "cpu", seed=seed)
    assert {c.dtype for c in whole.model.block_cfgs} == {"bfloat16"}
    loader = whole.train_loader(seed=seed)
    batches = [b.device_arrays for _ in range(2) for b in loader]
    nclasses = whole.dataset.nclasses
    step_a = make_train_step(whole.model, cfg, nclasses, whole.cweight, len(loader))
    train(step_a, batches, range(4))
    part = build_experiment(cfg, "cpu", seed=seed)
    step_b = make_train_step(part.model, cfg, nclasses, part.cweight, len(loader))
    train(step_b, batches, range(2))
    ckpt_io.save_model(part.model, str(tmp_path), 2)
    ckpt_io.save_train_state(step_b.optimizer, str(tmp_path), 2)
    again = build_experiment(cfg, "cpu", seed=seed + 1)
    step_c = make_train_step(again.model, cfg, nclasses, again.cweight, len(loader))
    ckpt_io.load_model(again.model, str(tmp_path / "network.iter-2.net"))
    assert ckpt_io.load_train_state(step_c.optimizer, str(tmp_path / "network.iter-2.net"))
    train(step_c, batches, range(2, 4))
    for (name, a), c in zip(whole.model.named_parameters(), again.model.parameters()):
        assert a.dtype == torch.float32 and torch.equal(a, c), name
    sa, sc = step_a.optimizer.opt.state_dict(), step_c.optimizer.opt.state_dict()
    for i, st in sa["state"].items():
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(st[k], sc["state"][i][k]), (i, k)

    sd = torch.load(tmp_path / "network.iter-2.net", weights_only=True)
    assert all(v.dtype == torch.float32 for v in sd.values() if v.is_floating_point())
    sets = ["TPU.compute_dtype", "float32", "TPU.pallas", "false", "TPU.pallas_sa", "false"]
    jcfg = jax_setup_cfg(breakfast_set["cfgs"], sets)
    params = convert_fact_state_dict({k: v.numpy() for k, v in sd.items()},
                                     jblocks.resolve_block_cfgs(jcfg))
    arrays = batches[0]
    jmodel = jblocks.build_fact(jcfg, whole.dataset.input_dimension, nclasses,
                                s_pred_cap=whole.s_pred_cap)
    jsaves, _ = jmodel.apply({"params": params}, jnp.asarray(arrays["feats"]),
                             jnp.asarray(arrays["mask"]), jnp.asarray(arrays["lengths"]),
                             train=False)
    model = build_fact(setup_cfg(breakfast_set["cfgs"], sets), whole.dataset.input_dimension,
                       nclasses, whole.s_pred_cap, device="cpu")
    model.load_state_dict(sd)
    x = tl.batch_to_device(arrays, "cpu")
    with torch.no_grad():
        saves, _ = model(x["feats"], x["mask"], x["lengths"])
    mask = arrays["mask"]
    for i, (sp, sj) in enumerate(zip(saves, jsaves)):
        got, ref = sp["frame_clogit"].numpy()[mask], np.asarray(sj["frame_clogit"])[mask]
        assert _rel(got, ref) <= 1e-4, (i, _rel(got, ref))
