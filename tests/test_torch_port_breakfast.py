"""The Breakfast configuration (MS-TCN++ towers, ``f: m2``) in the port, on the CPU.

* ``breakfast_cfg()`` equals ``fact_clip_tpu/configs/breakfast.yaml`` as the
  JAX package resolves it, block field by block field, and in its FACT,
  Loss, TM and optimizer keys.
* A narrow ``iuUU`` with ``f: m2`` (``_make_cfg(small=True)`` with
  ``Bi.f = "m2"``, its XLA path on the CPU) against the port through the
  bridge: every block's outputs on valid frames and the decoded classes
  (1e-4 absolute); one train step's loss (1e-4 relative), matching (equal)
  and every gradient (1e-4 of the largest, 1e-3 relative), with dropout and
  channel masking off, on the kernel entries and on the plain path.
* The shared-memory arithmetic that decides which kernels exist at
  Breakfast's widths (E = 512, H = 8, M = 60; C = 512), and the wrappers
  refusing a shape that does not fit before anything is built or launched.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _make_batch, _make_cfg
from fact_clip_tpu.configs.utils import setup_cfg
from fact_clip_tpu.models import blocks as jblocks
from fact_clip_tpu.models import decode as jdecode
from fact_clip_tpu.models import losses as jl
from fact_clip_tpu.models import matching as jm
from fact_clip_tpu.utils.torch_import import convert_fact_state_dict
from fact_clip_tpu_torch import _build
from fact_clip_tpu_torch.configs import breakfast_cfg, breakfast_train_cfg, resolve_block_cfgs
from fact_clip_tpu_torch.configs import small_cfg
from fact_clip_tpu_torch.engine.steps import make_eval_step, make_train_step
from fact_clip_tpu_torch.engine.train_loop import (batch_to_device, synthetic_batch,
                                                   synthetic_set_stats)
from fact_clip_tpu_torch.models.blocks import build_fact
from fact_clip_tpu_torch.models.layers import MSTCN2
from fact_clip_tpu_torch.models.losses import compute_null_weight
from fact_clip_tpu_torch.ops import dilated_conv, mha_attn, x2y_attn
from fact_clip_tpu_torch.utils.bridge import grads_from_jax, load_jax_params

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML = os.path.join(REPO, "fact_clip_tpu", "configs", "breakfast.yaml")
D, C, S_CAP, B, T, S = 12, 5, 24, 2, 96, 8
_PALLAS = ("pallas", "pallas_attn", "pallas_sa")


def test_breakfast_cfg_equals_the_yaml(monkeypatch):
    monkeypatch.setattr(jblocks, "_PALLAS_PLATFORM_OVERRIDE", "tpu")
    jcfg = setup_cfg([YAML])
    ref = jblocks.resolve_block_cfgs(jcfg)
    cfg = breakfast_cfg()
    got = resolve_block_cfgs(cfg)
    strip = lambda c: {k: v for k, v in dataclasses.asdict(c).items() if k not in _PALLAS}  # noqa: E731
    assert [strip(c) for c in got] == [strip(c) for c in ref]
    assert [(c.kind, c.f, c.f_dim, c.a_dim, c.hid_dim) for c in got] == \
        [(k, "m2", 512, 512, 512) for k in "iuUU"]
    for key in ("ntoken", "block", "fpos", "cmr", "mwt", "trans"):
        assert cfg["FACT"][key] == jcfg.FACT[key], key
    for key in ("pc", "a2fc", "match", "bgw", "nullw", "sw"):
        assert cfg["Loss"][key] == jcfg.Loss[key], key
    for key in ("use", "t", "p", "m"):
        assert cfg["TM"][key] == jcfg.TM[key], key
    for key in ("optimizer", "lr", "lr_decay", "momentum", "weight_decay", "clip_grad_norm",
                "dataset"):
        assert cfg[key] == jcfg[key], key
    train = breakfast_train_cfg()
    assert train["TPU"]["matcher"] == "host"
    assert resolve_block_cfgs(train) == got


def test_breakfast_shapes_and_null_weight():
    """Full width on the meta device (no memory); nullw = -1 resolved from a
    set of synthetic batches as the JAX package resolves it from a dataset."""
    model = build_fact(breakfast_cfg(), 2048, 48, 64, device="meta")
    towers = [b.frame_branch for b in model.block_list]
    assert all(isinstance(t, MSTCN2) and len(t.conv_fusion) == 10 for t in towers)
    assert towers[0].conv_1x1_in.weight.shape == (512, 2048, 1)
    assert not any(hasattr(t, "conv_1x1_in") for t in towers[1:])
    assert towers[0].dil_pairs[0] == (512, 1) and towers[0].dil_pairs[-1] == (1, 512)
    assert towers[0].conv_fusion[0].weight.shape == (512, 1024, 1)
    assert model.action_query.shape == (60, 1, 512)
    rng = np.random.default_rng(0)
    batches = [synthetic_batch(rng, 8, 48, 32, 200, [200, 150]) for _ in range(2)]
    stats = synthetic_set_stats(batches, 48)
    n_seg = [int(b["seg_mask"][i].sum()) for b in batches for i in range(2)]
    assert stats.average_transcript_len == pytest.approx(np.mean(n_seg))
    cfg = compute_null_weight(breakfast_train_cfg(), stats)
    assert cfg["Loss"]["nullw"] == pytest.approx(60 / ((60 - np.mean(n_seg)) * 48))


def test_shared_memory_fits_at_breakfast_widths():
    # K3 at E=512, H=8, M=60: per-head blocks, 64-key tiles forward and
    # backward; K2's flash forward and its int8 twin K8c stream panels at any
    # M and d, Breakfast's 60 query rows in one group of 32 rows a block
    assert mha_attn.has_forward(60, 512, 8) and mha_attn.has_backward(60, 512, 8)
    assert mha_attn.bwd_key_tile(60, 512, 8) == 64 and x2y_attn.flash_rows(60) == 32
    # the flagship's K3 keeps its 64-key tiles; its 40 query rows in two groups of 20
    assert mha_attn.bwd_key_tile(40, 256, 8) == 64 and x2y_attn.flash_rows(40) == 20
    assert x2y_attn.FLASH_KEY_TILE == 64
    assert x2y_attn.has_backward(60, 4096, 512) and x2y_attn.has_backward(4096, 60, 512)
    # K6 at C=512, and K1 (on the same GEMM) at the flagship's 256 / O=512
    # and gtea's 128.  The tensor-core kernels hold 128 x 128 tiles whatever
    # C is, pad each tap to whole 32-float K steps in the pack and need
    # 16-byte TMA row strides
    assert dilated_conv.has_tower_kernels(512) and dilated_conv.has_tower_kernels(512, 48)
    assert dilated_conv.has_tower_kernels(256, 512) and dilated_conv.has_tower_kernels(128)
    assert dilated_conv.has_tower_kernels(1024, 1024) and dilated_conv.has_tower_kernels(1024, 48)
    assert dilated_conv.has_tower_kernels(1000) and dilated_conv.has_tower_kernels(528)
    assert not dilated_conv.has_tower_kernels(1002) and not dilated_conv.has_tower_kernels(530)
    assert not dilated_conv.has_tower_kernels(512, 50)
    assert _build.gemm_smem(64) == _build.GEMM_SMEM == 41472


def test_wrappers_refuse_a_block_that_does_not_fit_before_any_launch(monkeypatch):
    """Off the CPU, a shape with no kernel raises NotImplementedError with
    the shape before the kernel library is built or loaded (meta tensors
    stand in for the card's)."""
    def no_lib():
        raise AssertionError("the kernel library was asked for")

    monkeypatch.setattr(_build, "lib", no_lib)
    meta = lambda *s: torch.empty(s, device="meta")  # noqa: E731
    x_len = torch.empty((2,), dtype=torch.int32, device="meta")
    E, M, H, Cx = 1024, 1000, 8, 64  # K3's block holds M x hd = 1000 x 128 query values
    with pytest.raises(NotImplementedError, match="M=1000, E=1024"):
        mha_attn.mha_cross_fwd(meta(2, M, E), meta(2, 300, Cx), None, meta(Cx, E), meta(E),
                               meta(Cx, E), meta(E), x_len, num_heads=H)
    Cw = 1002  # K6 takes 16-byte TMA row strides
    layer = (meta(3, Cw, Cw), meta(Cw), meta(3, Cw, Cw), meta(Cw), meta(Cw, Cw), meta(Cw, Cw),
             meta(Cw))
    with pytest.raises(NotImplementedError, match="C=1002"):
        dilated_conv.mstcn2_stack_fwd(meta(2, 50, Cw), x_len, [layer], [(1, 1)],
                                      out_w=meta(Cw, 8), out_b=meta(8))


# ---------------------------------------------------------------------------
# a narrow iuUU with f: m2 against the JAX package


def _cfgs():
    jcfg = _make_cfg(small=True)
    jcfg.Bi.f = "m2"
    jcfg.Bi.dropout = 0.0
    jcfg.FACT.cmr = 0.0
    jcfg.TPU.matcher = "host"
    cfg = small_cfg()
    cfg["Bi"].update(f="m2", dropout=0.0)
    cfg["FACT"]["cmr"] = 0.0
    cfg["TPU"]["matcher"] = "host"
    return jcfg, cfg


@pytest.fixture(scope="module")
def run():
    jcfg, cfg = _cfgs()
    model = jblocks.build_fact(jcfg, D, C, s_pred_cap=S_CAP)
    batch = _make_batch(np.random.default_rng(0), B, T, D, C, S)
    port = build_fact(cfg, D, C, S_CAP, device="cpu", generator=torch.Generator().manual_seed(0))
    params = convert_fact_state_dict({k: v.numpy() for k, v in port.state_dict().items()},
                                     jblocks.resolve_block_cfgs(jcfg))
    cweight = jl.build_class_weights(jcfg, C, [0])

    def loss_fn(params):  # engine/steps.py:131-135, vanilla FACT
        saves, _ = model.apply({"params": params}, batch["feats"], batch["mask"],
                               batch["lengths"], train=True,
                               rngs={"dropout": jax.random.PRNGKey(1),
                                     "aug": jax.random.PRNGKey(2)})
        last = saves[-1]
        seg2tok = jm.match(jcfg.Loss, jax.nn.softmax(last["action_clogit"], axis=-1),
                           last["a2f_attn"], batch["transcript"], batch["seg_label"],
                           batch["seg_mask"], batch["mask"], matcher="host", nclasses=C)
        per_video = jl.fact_loss(saves, batch, seg2tok, jnp.asarray(cweight), float(jcfg.Loss.sw))
        return per_video.mean(), (per_video, seg2tok)

    (loss, (per_video, seg2tok)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    saves, _ = model.apply({"params": params}, batch["feats"], batch["mask"], batch["lengths"],
                           train=False)
    last = saves[-1]
    pred = jdecode.decode_two_branch(last["action_clogit"], last["a2f_attn"],
                                     last["frame_clogit"], float(jcfg.FACT.mwt),
                                     jnp.ones(last["action_clogit"].shape[:2], bool))
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return dict(cfg=cfg, params=tree(params), grads=tree(grads), cweight=cweight,
                batch={k: np.array(v) for k, v in batch.items()}, loss=float(loss),
                per_video=np.asarray(per_video), seg2tok=np.asarray(seg2tok),
                saves=[{k: np.asarray(v) for k, v in s.items() if k != "kind"} for s in saves],
                pred=np.asarray(pred))


def _port(run, kernels: bool):
    model = build_fact(run["cfg"], D, C, S_CAP, device="cpu")
    load_jax_params(model, run["params"])
    model.set_kernels(kernels)
    return model


@pytest.mark.parametrize("kernels", [True, False])
def test_m2_slice_matches_jax_block_by_block(run, kernels):
    model = _port(run, kernels)
    assert all(isinstance(b.frame_branch, MSTCN2) for b in model.block_list)
    x = [torch.from_numpy(run["batch"][k]) for k in ("feats", "mask", "lengths")]
    with torch.no_grad():
        saves, _ = model(*x)
    mask = run["batch"]["mask"]
    for i, (sp, sj) in enumerate(zip(saves, run["saves"])):
        for key in ("frame_clogit", "action_clogit", "a2f_attn", "f2a_attn"):
            if key not in sj:
                continue
            got, ref = sp[key].numpy(), sj[key]
            assert got.shape == ref.shape, (i, key)
            if key in ("frame_clogit", "a2f_attn"):
                got, ref = got[mask], ref[mask]
            elif key == "f2a_attn":
                got, ref = got.transpose(0, 2, 1)[mask], ref.transpose(0, 2, 1)[mask]
            np.testing.assert_allclose(got, ref, atol=1e-4, err_msg=f"block {i} {key}")
    pred = make_eval_step(model, 0.1)(*x).numpy()
    np.testing.assert_array_equal(pred[mask], run["pred"][mask])


@pytest.mark.parametrize("kernels", [True, False])
def test_m2_train_step_loss_matching_and_every_gradient_match_jax(run, kernels):
    model = _port(run, kernels)
    step = make_train_step(model, run["cfg"], C, run["cweight"])
    per_video, seg2tok, _ = step.loss(batch_to_device(run["batch"], "cpu"),
                                      torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(seg2tok.numpy(), run["seg2tok"])
    np.testing.assert_allclose(per_video.detach().numpy(), run["per_video"], rtol=1e-4)
    loss = per_video.mean()
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params)
    ref = grads_from_jax(run["grads"], model.block_cfgs)
    assert set(names) == set(ref)
    assert any("conv_fusion" in n for n in names)
    scale = max(float(np.abs(v.numpy()).max()) for v in ref.values())
    for n, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), ref[n].numpy(), atol=1e-4 * max(1.0, scale),
                                   rtol=1e-3, err_msg=n)


def test_train_step_loss_takes_a_given_matching(run):
    """``TrainStep.loss(seg2tok=...)`` trains on that matching: the JAX
    matching gives JAX's losses; another one is returned as given and moves
    the loss of the videos whose matching changed."""
    step = make_train_step(_port(run, False), run["cfg"], C, run["cweight"])
    batch = batch_to_device(run["batch"], "cpu")
    given = torch.from_numpy(run["seg2tok"]).long()
    per_video, seg2tok, _ = step.loss(batch, torch.Generator().manual_seed(0), seg2tok=given)
    assert seg2tok is given
    np.testing.assert_allclose(per_video.detach().numpy(), run["per_video"], rtol=1e-4)
    swapped = given.clone()
    swapped[0, [0, 1]] = given[0, [1, 0]]
    assert not torch.equal(swapped, given)
    moved, _, _ = step.loss(batch, torch.Generator().manual_seed(0), seg2tok=swapped)
    assert float(moved[0]) != pytest.approx(float(per_video[0]), rel=1e-4)
    np.testing.assert_allclose(moved[1:].detach().numpy(), per_video[1:].detach().numpy(),
                               rtol=1e-6)
