"""The port's int8 evaluation (K8, ``TPU.quantize_infer: "int8"``) against the
JAX package on the CPU.

``fact_clip_tpu_torch/ops/quant_conv.py`` runs its plain PyTorch versions on
CPU tensors; here they are held against ``fact_clip_tpu/ops/pallas/
quant_conv.py`` run as the JAX package's own tests run it (the Pallas kernels
in interpret mode), on inputs made with numpy from a seed.  The quantizers
and the tower layout must be equal (int8 values equal, scales bit-equal).
The integer products are exact on both sides, so what differs is f32 work in
another order: the no-LN tower is bit-equal on >= 99.9 % of its elements
with a relative L2 error <= 1e-4; with LayerNorm (its reductions in another
order move a value across a rounding boundary now and then, and the int8
requantization amplifies that with depth) JAX's own cross-backend error
model holds, rel(port, f32) <= max(2 rel(jax_q8, f32), 1e-4)
(scripts/verify_quant.py); the attention forms keep the f32 K2 / K3 tests'
1e-4 absolute.  Then a narrow int8 ``iuUU`` whose SCA fuses and whose f2a
takes the flash form, with MSTCN towers (K8a) and with MS-TCN++ towers
(K8e), loaded through the exporter, against JAX's.
"""

import dataclasses
import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _make_cfg
from fact_clip_tpu.models import blocks as jblocks
from fact_clip_tpu.models import decode as jdecode
from fact_clip_tpu.ops.pallas import dilated_conv as jdc
from fact_clip_tpu.ops.pallas import quant_conv as jqc
from fact_clip_tpu_torch import _build, kernel_counters
from fact_clip_tpu_torch.configs import (flagship_cfg, flagship_int8_cfg, resolve_block_cfgs,
                                         small_cfg)
from fact_clip_tpu_torch.engine.steps import make_eval_step
from fact_clip_tpu_torch.models.blocks import build_fact
from fact_clip_tpu_torch.ops import quant_conv as qc
from fact_clip_tpu_torch.utils.bridge import load_jax_params

torch.set_num_threads(2)
ATOL = 1e-4


def _pair(rng, shape, scale=1.0):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _rel(a, b):
    return float(np.linalg.norm(_np(a) - _np(b)) / np.linalg.norm(_np(b)))


# ---------------------------------------------------------------------------
# the quantizers, the tower layout and dense_q8


def test_quantizers_equal_jax():
    rng = np.random.default_rng(0)
    w_j, w_t = _pair(rng, (3, 40, 24), 0.1)
    for (qj, sj), (qt, st) in [(jqc.quantize_weight(w_j), qc.quantize_weight(w_t)),
                               (jqc.quantize_weight_joint(w_j), qc.quantize_weight_joint(w_t)),
                               (jqc.quantize_weight(w_j[1]), qc.quantize_weight(w_t[1]))]:
        assert qt.dtype == torch.int8
        np.testing.assert_array_equal(_np(qt), np.asarray(qj))
        np.testing.assert_array_equal(_np(st), np.asarray(sj))
    x_j, x_t = _pair(rng, (2, 17, 40))
    x_j, x_t = x_j.at[0, 3].set(0.0), x_t.clone()
    x_t[0, 3] = 0.0  # an all-zero row takes the 1e-12 floor
    (qj, sj), (qt, st) = jqc._quantize_rows(x_j), qc._quantize_rows(x_t)
    np.testing.assert_array_equal(_np(qt), np.asarray(qj))
    np.testing.assert_array_equal(_np(st), np.asarray(sj))


def test_tower_layout_equals_jax():
    for T in (1, 7, 8, 70, 511, 512, 513, 600, 1100, 3072, 4100):
        for tile in (32, 512):
            for dil in ((1,), (1, 2, 4, 8, 16, 64), tuple(2 ** i for i in range(10)), (600,)):
                assert qc._stack_layout(T, dil, tile) == jdc._stack_layout(T, dil, tile)
                assert qc._tiling(T, tile, dil[-1]) == jdc._tiling(T, tile, dil[-1])


def test_dense_q8_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 33, 2048)).astype(np.float32)
    w = (rng.standard_normal((2048, 64)) * 0.03).astype(np.float32)
    x[0] = 1.0 + 0.05 * x[0]  # near-constant rows and columns: integer sums past 2^24
    w[:, :8] = 0.03 + 0.001 * w[:, :8]
    x_j, x_t, w_j, w_t = jnp.asarray(x), torch.from_numpy(x), jnp.asarray(w), torch.from_numpy(w)
    b_j, b_t = _pair(rng, (64,), 0.1)
    ref = np.asarray(jqc.dense_q8(x_j, w_j, b_j))
    got = _np(qc.dense_q8(x_t, w_t, b_t))
    # the integer product (above 2^24 at D=2048) is exact in the plain version
    qx_j, qw_j = jqc._quantize_rows(x_j)[0], jqc._quantize_rows(w_j.T)[0].T
    exact = np.asarray(jnp.dot(qx_j.astype(jnp.int32), qw_j.astype(jnp.int32)))
    qx_t = qc._quantize_rows(x_t)[0]
    qw_t = torch.from_numpy(np.array(qw_j))
    np.testing.assert_array_equal(_np(qx_t), np.asarray(qx_j))
    assert np.abs(exact).max() > 2 ** 24
    np.testing.assert_array_equal(_np(torch.matmul(qx_t.double(), qw_t.double())), exact)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())


# ---------------------------------------------------------------------------
# K8a: the int8 tower


def _tower_inputs(rng, B, T, C, dilations, lengths):
    x_j, x_t = _pair(rng, (B, T, C))
    layers_j, layers_t = [], []
    for _ in dilations:
        parts = [_pair(rng, (3, C, C), 0.08), _pair(rng, (C,), 0.05), _pair(rng, (C, C), 0.08),
                 _pair(rng, (C,), 0.05), _pair(rng, (C,), 0.2), _pair(rng, (C,), 0.2)]
        parts[4] = (parts[4][0] + 1.0, parts[4][1] + 1.0)
        layers_j.append(tuple(p[0] for p in parts))
        layers_t.append(tuple(p[1] for p in parts))
    lengths = np.array(lengths, np.int32)
    mask = np.arange(T)[None] < lengths[:, None]
    return x_j, x_t, layers_j, layers_t, lengths, mask


@pytest.mark.parametrize("use_ln", [False, True])
def test_k8a_tower_matches_pallas_interpret(use_ln):
    rng = np.random.default_rng(2)
    B, T, C = 2, 70, 32
    dilations = (1, 2, 4, 8, 16, 64)  # 64 > the tile of 32
    x_j, x_t, lj, lt, lengths, mask = _tower_inputs(rng, B, T, C, dilations, (70, 50))
    ref = np.asarray(jqc.dilated_residual_stack_q8(x_j, jnp.asarray(mask), lj, dilations,
                                                   use_ln=use_ln, tile=32, interpret=True))
    got = _np(qc.mstcn_stack_q8(x_t, torch.from_numpy(lengths), qc.quantize_tower(lt),
                                dilations, use_ln=use_ln, tile=32))
    assert got.shape == (B, T, C) and np.isfinite(got).all()
    np.testing.assert_array_equal(got[1, 50:], 0.0)  # padded frames exactly 0
    if not use_ln:
        assert np.mean(got == ref) >= 0.999
        assert _rel(got, ref) <= 1e-4
    else:
        f32 = np.asarray(jdc._stack_reference(x_j, jnp.asarray(mask), lj, dilations, True, 1e-5,
                                              (0.0,) * 6, (None,) * 6, 32, True))
        assert _rel(got, f32) <= max(2 * _rel(ref, f32), 1e-4), (_rel(got, f32), _rel(ref, f32))


def test_k8a_scales_follow_jax_tile_at_a_padded_bucket():
    """The default tile of 512 at T = 1100 (three JAX tiles, T_pad 1536, the
    d = 512 window of a tile reaching across its neighbours)."""
    rng = np.random.default_rng(3)
    B, T, C = 2, 1100, 16
    dilations = (1, 64, 512)
    x_j, x_t, lj, lt, lengths, mask = _tower_inputs(rng, B, T, C, dilations, (1100, 700))
    ref = np.asarray(jqc.dilated_residual_stack_q8(x_j, jnp.asarray(mask), lj, dilations,
                                                   use_ln=False, interpret=True))
    got = _np(qc.mstcn_stack_q8(x_t, torch.from_numpy(lengths), qc.quantize_tower(lt),
                                dilations, use_ln=False))
    assert np.mean(got == ref) >= 0.999 and _rel(got, ref) <= 1e-4
    np.testing.assert_array_equal(got[1, 700:], 0.0)


# ---------------------------------------------------------------------------
# K8b / K8c / K8d


def _x2y_inputs(rng, B, Y, X, batched_ypos):
    Cx, Cy, d = 32, 24, 128
    shapes = [(B, Y, Cy), (B if batched_ypos else 1, Y, Cy), (B, X, Cx), (1, X, Cx), (Cx, d),
              (d,), (Cx, d), (d,), (Cy, d), (d,)]
    scales = [1, 1, 1, 1, 0.1, 0.05, 0.1, 0.05, 0.1, 0.05]
    return [_pair(rng, s, sc) for s, sc in zip(shapes, scales)]


@pytest.mark.parametrize("X,Y,batched_ypos", [(24, 70, False), (2000, 16, False),
                                              (24, 70, True)])  # small-X | flash | per-video
def test_k8bc_x2y_matches_pallas_interpret(X, Y, batched_ypos):
    rng = np.random.default_rng(4)
    args = _x2y_inputs(rng, 2, Y, X, batched_ypos)
    x_len = np.array([X, X - 5], np.int32)
    ref = jqc.x2y_attention_q8(*[a[0] for a in args], jnp.asarray(x_len), tile=256,
                               interpret=True)
    got = qc.x2y_attention_q8(*[a[1] for a in args], torch.from_numpy(x_len))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(_np(g), np.asarray(r), atol=ATOL, rtol=0)
    assert (_np(got[2])[1, :, X - 5:] == -1e9).all()  # invalid keys exactly -1e9
    assert (_np(got[2])[:, :, : X - 5] > -1e8).all()


def test_k8d_mha_cross_matches_pallas_interpret():
    rng = np.random.default_rng(5)
    B, M, X, E, Cx, H = 2, 10, 1500, 256, 256, 8
    args = [_pair(rng, (B, M, E)), _pair(rng, (B, X, Cx)), _pair(rng, (1, X, Cx)),
            _pair(rng, (Cx, E), 0.05), _pair(rng, (E,), 0.05), _pair(rng, (Cx, E), 0.05),
            _pair(rng, (E,), 0.05)]
    x_len = np.array([1500, 1179], np.int32)
    ref = jqc.mha_cross_attention_q8(*[a[0] for a in args], jnp.asarray(x_len), num_heads=H,
                                     tile=256, interpret=True)
    got = qc.mha_cross_q8(*[a[1] for a in args], torch.from_numpy(x_len), num_heads=H)
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# configuration and refusals


def test_flagship_int8_cfg_is_the_flagship_with_one_key():
    a, b = flagship_int8_cfg(), flagship_cfg()
    assert a["TPU"].pop("quantize_infer") == "int8" and b["TPU"].pop("quantize_infer") == ""
    assert a == b


def test_int8_configs_equal_the_jax_package_field_for_field(monkeypatch):
    monkeypatch.setattr(jblocks, "_PALLAS_PLATFORM_OVERRIDE", "tpu")
    jcfg = _make_cfg(small=False)
    jcfg.TPU.quantize_infer = "int8"
    ref = jblocks.resolve_block_cfgs(jcfg)
    got = resolve_block_cfgs(flagship_int8_cfg())
    assert [dataclasses.asdict(c) for c in got] == [dataclasses.asdict(c) for c in ref]
    assert {c.quantize for c in got} == {"int8"}


@pytest.mark.parametrize("case", ["int4", "m2", "no_pallas", "grad", "c24"])
def test_int8_refusals(case, monkeypatch):
    cfg = flagship_int8_cfg()
    if case == "int4":
        cfg["TPU"]["quantize_infer"] = "int4"
        with pytest.raises(ValueError):
            resolve_block_cfgs(cfg)
    elif case == "m2":  # the int8 MS-TCN++ tower (K8e) is ported: no refusal
        cfg["Bi"]["f"] = "m2"
        got = resolve_block_cfgs(cfg)
        assert {c.f for c in got} == {"m2"} and {c.quantize for c in got} == {"int8"}
    elif case == "no_pallas":
        cfg["TPU"]["pallas"] = False
        assert {c.quantize for c in resolve_block_cfgs(cfg)} == {""}
    elif case == "c24":  # K8a takes any width: small_cfg()'s towers, 24 wide, reach the launches
        cfg = small_cfg()
        cfg["TPU"]["quantize_infer"] = "int8"
        got = resolve_block_cfgs(cfg)
        assert {c.f_dim for c in got} == {24} and {c.quantize for c in got} == {"int8"}
        calls = []

        class Lib:  # records the entries launched, each returning cudaSuccess
            def __getattr__(self, name):
                return lambda *args: calls.append(name) or 0

        monkeypatch.setattr(_build, "lib", Lib)
        monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
        ql = qc.quantize_tower([(torch.ones(3, 24, 24), torch.zeros(24), torch.ones(24, 24),
                                 torch.zeros(24), None, None)])
        qc._mstcn_q8_card(torch.ones(1, 8, 24), torch.tensor([8], dtype=torch.int32), ql, [1],
                          False, 1e-5, 512, False)
        assert calls == ["fk_q8_group_max", "fk_q8_tower_layer"]
    else:
        x = torch.ones(1, 8, 16, requires_grad=True)
        ql = qc.quantize_tower([(torch.ones(3, 16, 16), torch.zeros(16), torch.ones(16, 16),
                                 torch.zeros(16), None, None)])
        with pytest.raises(NotImplementedError):
            qc.mstcn_stack_q8(x, torch.tensor([8], dtype=torch.int32), ql, [1], use_ln=False)
        w, b, n = torch.ones(16, 16), torch.zeros(16), torch.tensor([8], dtype=torch.int32)
        with pytest.raises(NotImplementedError):
            qc.mha_cross_q8(x, x, None, w, b, w, b, n, num_heads=2)
        with pytest.raises(NotImplementedError):
            qc.x2y_attention_q8(x, None, x, None, w, b, w, b, w, b, n)


# ---------------------------------------------------------------------------
# the slice: a narrow int8 iuUU against JAX's


D, C, S_CAP, B, T = 12, 5, 24, 2, 1152


def _narrow(cfg, f="m"):
    """small_cfg() widened until the SCA fuses (E, Cx multiples of 128)."""
    cfg["Bi"].update(hid_dim=128, a_dim=128, a_ffdim=32, a_layers=1, a_nhead=4, f=f, f_dim=32,
                     f_layers=3)
    cfg["Bu"]["f_layers"] = 2
    cfg["BU"]["f_layers"] = 2
    cfg["TPU"].update(quantize_infer="int8", pallas_sa=False)
    return cfg


def _interp(fn):
    def f(*a, **kw):
        return fn(*a, **dict(kw, interpret=True))
    return f


@pytest.fixture(scope="module", params=["m", "m2"])
def int8_run(request):
    """The JAX model in interpret mode, its towers MSTCN (K8a) or MS-TCN++
    (K8e)."""
    f = request.param
    jcfg = _make_cfg(small=True)
    for k, v in _narrow(small_cfg(), f)["Bi"].items():
        setattr(jcfg.Bi, k, v)
    jcfg.TPU.quantize_infer = "int8"
    jcfg.TPU.pallas_sa = False
    rng = np.random.default_rng(6)
    feats = rng.standard_normal((B, T, D)).astype(np.float32)
    lengths = np.array([T, 1100], np.int32)
    mask = np.arange(T)[None] < lengths[:, None]
    feats[~mask] = 0.0
    args = (jnp.asarray(feats), jnp.asarray(mask), jnp.asarray(lengths))
    with mock.patch.object(jblocks, "_PALLAS_PLATFORM_OVERRIDE", "tpu"), \
            mock.patch.object(jqc, "dilated_residual_stack_q8",
                              _interp(jqc.dilated_residual_stack_q8)), \
            mock.patch.object(jqc, "dilated_residual2_stack_q8",
                              _interp(jqc.dilated_residual2_stack_q8)), \
            mock.patch.object(jqc, "x2y_attention_q8", _interp(jqc.x2y_attention_q8)), \
            mock.patch.object(jqc, "mha_cross_attention_q8",
                              _interp(jqc.mha_cross_attention_q8)):
        model = jblocks.build_fact(jcfg, D, C, s_pred_cap=S_CAP)
        assert {c.quantize for c in model.block_cfgs} == {"int8"}
        params = model.init({"params": jax.random.PRNGKey(0)}, *args, train=False)
        saves, _ = model.apply(params, *args, train=False)
    last = saves[-1]
    pred = jdecode.decode_two_branch(last["action_clogit"], last["a2f_attn"],
                                     last["frame_clogit"], float(jcfg.FACT.mwt),
                                     jnp.ones(last["action_clogit"].shape[:2], bool))
    return dict(f=f, params=jax.tree_util.tree_map(np.asarray, params["params"]), feats=feats,
                mask=mask, lengths=lengths, frame_clogit=np.asarray(saves[0]["frame_clogit"]),
                pred=np.asarray(pred))


def test_int8_slice_matches_jax(int8_run):
    cfg = _narrow(small_cfg(), int8_run["f"])
    model = build_fact(cfg, D, C, S_CAP, device="cpu")
    # the f32 exporter: _Q8Dense keeps its names, and the int8 towers' out
    # projection keeps the f32 path's (TorchDense_1 with the in map)
    load_jax_params(model, int8_run["params"])
    assert model.block_list[0].action_branch.layers[0].multihead_attn.quantize == "int8"
    assert {b.frame_branch.quantize for b in model.block_list} == {"int8"}
    x = [torch.from_numpy(int8_run[k]) for k in ("feats", "mask", "lengths")]
    mask = int8_run["mask"]
    before = kernel_counters()
    with torch.no_grad():
        saves, _ = model(*x)
    assert kernel_counters() == before  # CPU tensors: plain versions, no launch
    got, ref = saves[0]["frame_clogit"].numpy()[mask], int8_run["frame_clogit"][mask]
    assert _rel(got, ref) <= 1e-3, _rel(got, ref)
    pred = make_eval_step(model, 0.1)(*x).numpy()
    agree = float(np.mean(pred[mask] == int8_run["pred"][mask]))
    assert agree >= 0.99, agree
    # the same weights in the port's f32 model: reported, not a gate
    cfg["TPU"]["quantize_infer"] = ""
    f32 = build_fact(cfg, D, C, S_CAP, device="cpu")
    f32.load_state_dict(model.state_dict())
    share = float(np.mean(make_eval_step(f32, 0.1)(*x).numpy()[mask] == pred[mask]))
    print(f"int8 vs f32 predictions agree on {share:.4f} of valid frames (random weights)")
