"""The Epic-Kitchens verb/noun model (``IUUU``) in the port, on the CPU.

* ``epic_cfg()`` equals ``fact_clip_tpu/configs/epic-kitchens.yaml`` as the
  JAX package resolves it.
* A narrow ``IUUU`` twin of it (hid 64, a_dim 16, 2 SCA layers, 4 heads,
  ``f: m2`` 24 wide, towers of 3 / 2 / 2 layers, 8 tokens, D 32, a 13 verb x
  29 noun / 97 action vocabulary, ``s_pred_cap`` 64; and an ``f: m`` case):
  the JAX model's parameters go through the port's own
  ``export_verbnoun_state_dict`` (equal to the JAX package's key for key
  and value for value) into the port, and on two ragged videos every block's
  ``tdu_P`` is equal, its frame / segment / action log-probs and a2f
  attention agree within 1e-4 (the forward tolerance of the Breakfast
  slice's test) on valid frames and segments, and the decoded action ids
  equal JAX's ``make_step_fns(..., verbnoun=True)`` eval step, on the port's
  kernel entries and on its plain path.  ``Predictor`` equals the eval step
  per video.
* The same narrow ``IUUU`` (``f: m2``) with int8 evaluation
  (``TPU.quantize_infer: "int8"``: K8e towers and in map, K8b X2Y; the SCA
  over <= 64 segments stays f32) against JAX's, its Pallas kernels in
  interpret mode: block-0 frame log-probs within 1e-3 relative, >= 0.99 of
  the predictions equal.
* The port's copy of ``load_vids_nids`` equals JAX's on an epic fixture.
* Shared memory at epic's widths: K4's SA forward fits at M = 300 tokens,
  and so do the SA backward's tiled blocks (at M = 300 and at egoprocel's
  M = 200); the train step builds for the verb/noun model.
"""

import dataclasses
import os
import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fact_clip_tpu.configs.utils import setup_cfg
from fact_clip_tpu.data.synthetic import make_epic_fixture
from fact_clip_tpu.engine.steps import make_step_fns
from fact_clip_tpu.models import blocks as jblocks
from fact_clip_tpu.models import verbnoun as jvn
from fact_clip_tpu.ops import verbnoun_compose as jvc
from fact_clip_tpu.ops.pallas import compose_decode as jcd
from fact_clip_tpu.ops.pallas import quant_conv as jqc
from fact_clip_tpu.utils.torch_export import export_verbnoun_state_dict as jax_export
from fact_clip_tpu_torch import _build
from fact_clip_tpu_torch.configs import epic_cfg, epic_vocab, resolve_block_cfgs
from fact_clip_tpu_torch.engine.serve import Predictor
from fact_clip_tpu_torch.engine.steps import make_eval_step, make_train_step
from fact_clip_tpu_torch.models import verbnoun as pvn
from fact_clip_tpu_torch.ops import compose_decode, dilated_conv, sa_layer
from fact_clip_tpu_torch.utils.bridge import load_jax_params
from fact_clip_tpu_torch.utils.torch_export import export_verbnoun_state_dict

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML = os.path.join(REPO, "fact_clip_tpu", "configs", "epic-kitchens.yaml")
N1, N2, N_ACT, D, S_CAP, T = 13, 29, 97, 32, 64, 200
LENGTHS = [200, 137]
ATOL = 1e-4  # forward outputs, as the Breakfast slice's block-by-block test
_PALLAS = ("pallas", "pallas_attn", "pallas_sa")
_NARROW = dict(hid_dim=64, a_dim=16, a_ffdim=32, a_layers=2, a_nhead=4, f_dim=24, f_layers=3,
               f_ln=False, f_ngp=1, dropout=0.0)


def test_epic_cfg_equals_the_yaml(monkeypatch):
    monkeypatch.setattr(jblocks, "_PALLAS_PLATFORM_OVERRIDE", "tpu")
    jcfg = setup_cfg([YAML])
    ref = jblocks.resolve_block_cfgs(jcfg)
    cfg = epic_cfg()
    got = resolve_block_cfgs(cfg)
    strip = lambda c: {k: v for k, v in dataclasses.asdict(c).items() if k not in _PALLAS}  # noqa: E731
    assert [strip(c) for c in got] == [strip(c) for c in ref]
    assert [(c.kind, c.f, c.f_dim, c.a_dim, c.hid_dim, c.a) for c in got] == \
        [("I", "m2", 256, 256, 512, "sca")] + [("U", "m2", 256, 256, 512, "sa")] * 3
    for key in ("ntoken", "block", "fpos", "cmr", "mwt", "trans"):
        assert cfg["FACT"][key] == jcfg.FACT[key], key
    for key in ("pc", "a2fc", "match", "bgw", "nullw", "sw"):
        assert cfg["Loss"][key] == jcfg.Loss[key], key
    assert cfg["TM"]["use"] == jcfg.TM.use
    for key in ("optimizer", "lr", "lr_decay", "momentum", "weight_decay", "clip_grad_norm",
                "dataset", "split", "sr", "batch_size"):
        assert cfg[key] == jcfg[key], key


def test_epic_shapes_at_full_width():
    """Full width on the meta device (no memory)."""
    model = pvn.build_verbnoun_fact(epic_cfg(), 1024, *epic_vocab(), 256, device="meta")
    assert len(model.vids) == 3806 and (model.n_classes1, model.n_classes2) == (98, 301)
    b0, b1 = model.block_list[0], model.block_list[1]
    assert isinstance(b0, pvn.InputBlockTDUVN) and isinstance(b1, pvn.UpdateBlockTDUVN)
    assert b0.frame_branch.conv_1x1_in.weight.shape == (256, 1024, 1)
    assert b0.frame_branch.conv_out.weight.shape == (512, 256, 1)
    assert b0.seg_update.num_layers == 2 and b1.seg_update.num_layers == 1
    assert len(b0.action_branch.layers) == 6 and len(b1.action_branch.layers) == 1
    assert b1.sf_merge[0].weight.shape == (256, 768)
    assert model.action_query.shape == (300, 1, 256)
    step = make_train_step(model, epic_cfg(), 3806, np.ones(3807, np.float32))
    assert step.verbnoun and step.cweight.shape == (3807,)
    with pytest.raises(ValueError, match="3807"):
        make_train_step(model, epic_cfg(), 3806, np.ones(3806, np.float32))


def test_shared_memory_at_epic_widths(monkeypatch):
    """K4 at M = 300, E = 256, H = 8: the SA forward's and backward's largest
    block (one head's k and v rows of every key, a 32-row tile's q and dc
    rows, an M-long row per warp) is 97,248 bytes; at egoprocel's M = 200
    67,648; both fit up to M = 756 at hd = 32 and the backward refuses heads
    wider than 64; K6 at C = 256; K7 at 98 / 301 / 3,806."""
    assert sa_layer.has_forward(300, 256, 8) and sa_layer.has_backward(300, 256, 8)
    assert sa_layer.has_forward(756, 256, 8) and not sa_layer.has_forward(757, 256, 8)
    assert sa_layer.sa_bwd_smem(300, 256, 8) == 4 * (2 * 300 * 33 + 2 * 32 * 33 + 8 * 300) == 97248
    assert sa_layer.has_backward(200, 256, 8) and sa_layer.sa_bwd_smem(200, 256, 8) == 67648
    assert sa_layer.has_backward(756, 256, 8) and not sa_layer.has_backward(757, 256, 8)
    assert sa_layer.has_backward(60, 512, 8) and not sa_layer.has_backward(40, 512, 4)
    assert dilated_conv.has_tower_kernels(256) and dilated_conv.has_tower_kernels(256, 512)
    assert compose_decode.compose_smem(98, 301, 3806) == 66296
    assert compose_decode.factored_smem(98, 301) == 102144

    class Launched(Exception):
        pass

    def lib():
        raise Launched

    monkeypatch.setattr(_build, "lib", lib)
    meta = lambda *s: torch.empty(s, device="meta")  # noqa: E731
    E = 256
    w = [meta(E, E), meta(E)] * 4 + [meta(E), meta(E)]
    with pytest.raises(Launched):  # the serving forward reaches its launch
        sa_layer.sa_sublayer_fwd(meta(1, 300, E), meta(1, 300, E), *w, num_heads=8)
    for M in (300, 200):  # the backward reaches its launch too
        with pytest.raises(Launched):
            sa_layer.sa_sublayer_bwd(meta(1, M, E), meta(1, M, E), *w, meta(1, M, E),
                                     num_heads=8)
    with pytest.raises(NotImplementedError, match="M=800"):  # past the bound: refused first
        sa_layer.sa_sublayer_bwd(meta(1, 800, E), meta(1, 800, E), *w, meta(1, 800, E),
                                 num_heads=8)


def test_load_vids_nids_equals_jax(tmp_path):
    base = make_epic_fixture(str(tmp_path), n_verbs=5, n_nouns=7, n_actions=11, n_train=2,
                             n_test=1, feat_dim=8, min_len=40, max_len=60)
    got = pvn.load_vids_nids(base)
    ref = jvn.load_vids_nids(base)
    for g, r in zip(got, ref):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, r)
    assert len(got[0]) == 11


# ---------------------------------------------------------------------------
# a narrow IUUU against the JAX package


def _cfgs(f: str):
    jcfg = setup_cfg([YAML])
    jcfg.FACT.ntoken = 8
    for k, v in dict(_NARROW, f=f).items():
        setattr(jcfg.Bi, k, v)
    for node in (jcfg.Bu, jcfg.BU):
        node.a_nhead, node.f_layers = 4, 2
    cfg = epic_cfg()
    cfg["FACT"]["ntoken"] = 8
    cfg["Bi"].update(_NARROW, f=f)
    for node in ("Bu", "BU"):
        cfg[node].update(a_nhead=4, f_layers=2)
    return jcfg, cfg


@pytest.fixture(scope="module", params=["m2", "m"])
def run(request):
    f = request.param
    jcfg, cfg = _cfgs(f)
    vids, nids = epic_vocab(N1, N2, N_ACT, seed=1)
    model = jvn.build_verbnoun_fact(jcfg, D, vids, nids, S_CAP, n_classes1=N1, n_classes2=N2)
    rng = np.random.default_rng(0)
    lens = np.array(LENGTHS, np.int32)
    mask = np.arange(T)[None] < lens[:, None]
    feats = (rng.standard_normal((len(lens), T, D)) * mask[..., None]).astype(np.float32)
    params = model.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(feats),
                        jnp.asarray(mask), jnp.asarray(lens), train=False)["params"]
    saves, _ = model.apply({"params": params}, jnp.asarray(feats), jnp.asarray(mask),
                           jnp.asarray(lens), train=False)
    _, eval_step = make_step_fns(model, jcfg, N_ACT, np.ones(N_ACT + 1, np.float32),
                                 verbnoun=True)
    pred = eval_step(params, {"feats": jnp.asarray(feats), "mask": jnp.asarray(mask),
                              "lengths": jnp.asarray(lens)})
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return dict(f=f, cfg=cfg, bcfgs=jblocks.resolve_block_cfgs(jcfg), vids=vids, nids=nids,
                params=tree(params), feats=feats, mask=mask, lens=lens, pred=np.asarray(pred),
                saves=[{k: np.asarray(v) for k, v in s.items() if k != "kind"} for s in saves])


def _port(run, kernels: bool):
    model = pvn.build_verbnoun_fact(run["cfg"], D, run["vids"], run["nids"], S_CAP, N1, N2,
                                    device="cpu")
    load_jax_params(model, run["params"])
    model.set_kernels(kernels)
    return model


def test_exporter_equals_the_jax_packages(run):
    ref = jax_export(run["params"], run["bcfgs"])
    got = export_verbnoun_state_dict(run["params"], resolve_block_cfgs(run["cfg"]))
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert got[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    port = _port(run, True)
    assert set(port.state_dict()) == set(ref)


@pytest.mark.parametrize("kernels", [True, False])
def test_iuuu_matches_jax_block_by_block(run, kernels):
    model = _port(run, kernels)
    x = [torch.from_numpy(run[k]) for k in ("feats", "mask", "lens")]
    with torch.no_grad():
        saves, _ = model(*x)
    mask = run["mask"]
    assert [s["kind"] for s in saves] == ["I", "U", "U", "U"]
    for i, (sp, sj) in enumerate(zip(saves, run["saves"])):
        assert set(sj) <= set(sp), i
        np.testing.assert_array_equal(sp["tdu_P"].numpy(), sj["tdu_P"], err_msg=f"block {i} P")
        seg_valid = sj["tdu_seg_valid"]
        np.testing.assert_array_equal(sp["tdu_seg_valid"].numpy(), seg_valid)
        for key in ("frame_vlogp", "frame_nlogp", "seg_logp", "action_logp", "a2f_attn",
                    "f2a_attn"):
            if key not in sj:
                continue
            got, ref = sp[key].numpy(), sj[key]
            assert got.shape == ref.shape, (i, key)
            if key in ("frame_vlogp", "frame_nlogp", "a2f_attn"):
                got, ref = got[mask], ref[mask]
            elif key == "seg_logp":
                got, ref = got[seg_valid], ref[seg_valid]
            elif key == "f2a_attn":
                got, ref = got.transpose(0, 2, 1)[mask], ref.transpose(0, 2, 1)[mask]
            np.testing.assert_allclose(got, ref, atol=ATOL, err_msg=f"block {i} {key}")
    pred = make_eval_step(model, float(run["cfg"]["FACT"]["mwt"]))(*x)
    assert pred.dtype == torch.int32
    np.testing.assert_array_equal(pred.numpy()[mask], run["pred"][mask])
    # the frame branch alone (weight 1): the composed frame argmax
    last = run["saves"][-1]
    ref = jvc.composed_decode(*[jnp.asarray(last[k]) for k in
                                ("action_logp", "a2f_attn", "frame_vlogp", "frame_nlogp")],
                              jnp.asarray(run["vids"]), jnp.asarray(run["nids"]), 1.0,
                              jnp.ones((len(LENGTHS), 8), bool))
    pred1 = make_eval_step(model, 1.0)(*x).numpy()
    np.testing.assert_array_equal(pred1[mask], np.asarray(ref)[mask])
    # the first TDU's composed argmax changes along the videos: it cuts them
    # into more segments than the cap holds
    assert (run["saves"][0]["tdu_seg_valid"].sum(axis=1) == S_CAP).all()


def test_predictor_equals_the_eval_step_per_video(run):
    model = _port(run, True)
    feats = [run["feats"][i, :n] for i, n in enumerate(run["lens"])] + [run["feats"][1, :90]]
    got = Predictor(model, 0.1, batch_size=1, max_len=256).predict(feats)
    step = make_eval_step(model, 0.1)
    for f, g in zip(feats, got):
        n = len(f)
        ref = step(torch.from_numpy(f[None]), torch.ones(1, n, dtype=torch.bool),
                   torch.tensor([n])).numpy()[0]
        assert g.dtype == np.int32 and g.shape == (n,) and 0 <= g.min() and g.max() < N_ACT
        np.testing.assert_array_equal(g, ref)
    np.testing.assert_array_equal(got[0], run["pred"][0])


# ---------------------------------------------------------------------------
# the narrow IUUU with int8 evaluation


def _interp(fn):
    def f(*a, **kw):
        return fn(*a, **dict(kw, interpret=True))
    return f


def test_int8_iuuu_matches_jax():
    jcfg, cfg = _cfgs("m2")
    jcfg.TPU.quantize_infer, jcfg.TPU.pallas_sa = "int8", False
    cfg["TPU"].update(quantize_infer="int8", pallas_sa=False)
    vids, nids = epic_vocab(N1, N2, N_ACT, seed=1)
    rng = np.random.default_rng(3)
    lens = np.array(LENGTHS, np.int32)
    mask = np.arange(T)[None] < lens[:, None]
    feats = (rng.standard_normal((len(lens), T, D)) * mask[..., None]).astype(np.float32)
    args = (jnp.asarray(feats), jnp.asarray(mask), jnp.asarray(lens))
    with mock.patch.object(jblocks, "_PALLAS_PLATFORM_OVERRIDE", "tpu"), \
            mock.patch.object(jqc, "dilated_residual2_stack_q8",
                              _interp(jqc.dilated_residual2_stack_q8)), \
            mock.patch.object(jqc, "x2y_attention_q8", _interp(jqc.x2y_attention_q8)), \
            mock.patch.object(jcd, "mxu_argmax", _interp(jcd.mxu_argmax)), \
            mock.patch.object(jcd, "blend_argmax", _interp(jcd.blend_argmax)):
        model = jvn.build_verbnoun_fact(jcfg, D, vids, nids, S_CAP, n_classes1=N1, n_classes2=N2)
        assert {c.quantize for c in model.block_cfgs} == {"int8"}
        params = model.init({"params": jax.random.PRNGKey(0)}, *args, train=False)["params"]
        saves, _ = model.apply({"params": params}, *args, train=False)
        _, eval_step = make_step_fns(model, jcfg, N_ACT, np.ones(N_ACT + 1, np.float32),
                                     verbnoun=True)
        ref_pred = np.asarray(eval_step(params, {"feats": args[0], "mask": args[1],
                                                 "lengths": args[2]}))
    port = pvn.build_verbnoun_fact(cfg, D, vids, nids, S_CAP, N1, N2, device="cpu")
    load_jax_params(port, jax.tree_util.tree_map(np.asarray, params))
    assert {b.frame_branch.quantize for b in port.block_list} == {"int8"}
    x = [torch.from_numpy(a) for a in (feats, mask, lens)]
    with torch.no_grad():
        got, _ = port(*x)
    for key in ("frame_vlogp", "frame_nlogp"):
        g, r = got[0][key].numpy()[mask], np.asarray(saves[0][key])[mask]
        assert np.linalg.norm(g - r) / np.linalg.norm(r) <= 1e-3, key
    pred = make_eval_step(port, float(cfg["FACT"]["mwt"]))(*x).numpy()
    agree = float(np.mean(pred[mask] == ref_pred[mask]))
    assert agree >= 0.99, agree
