"""The port's serving slice as a whole against the JAX package on the CPU.

JAX ``build_fact(_make_cfg(small=True))`` runs on the CPU (its XLA path);
its parameters cross through ``fact_clip_tpu_torch.utils.bridge`` into the
port, which loads them strictly.  Every block's frame_clogit, action_clogit,
a2f_attn and f2a_attn, and the decoded predictions, are compared on valid
frames.  Tolerance 1e-4 absolute: float32 on both sides, sums in another
order; the decoded classes must be equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _make_cfg
from fact_clip_tpu.models import blocks as jblocks
from fact_clip_tpu.models import decode as jdecode
from fact_clip_tpu.utils.torch_export import export_fact_state_dict
from fact_clip_tpu_torch.configs import flagship_cfg, resolve_block_cfgs, small_cfg
from fact_clip_tpu_torch.engine.steps import make_eval_step
from fact_clip_tpu_torch.models.blocks import build_fact
from fact_clip_tpu_torch.utils.bridge import load_jax_params

torch.set_num_threads(2)
ATOL = 1e-4
D, C, S_CAP, B, T = 12, 5, 24, 2, 96


@pytest.fixture(scope="module")
def jax_run():
    cfg = _make_cfg(small=True)
    model = jblocks.build_fact(cfg, D, C, s_pred_cap=S_CAP)
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((B, T, D)).astype(np.float32)
    lengths = np.array([96, 61], np.int32)
    mask = np.arange(T)[None] < lengths[:, None]
    feats[~mask] = 0.0
    args = (jnp.asarray(feats), jnp.asarray(mask), jnp.asarray(lengths))
    params = model.init({"params": jax.random.PRNGKey(0)}, *args, train=False)
    saves, _ = model.apply(params, *args, train=False)
    last = saves[-1]
    pred = jdecode.decode_two_branch(last["action_clogit"], last["a2f_attn"],
                                     last["frame_clogit"], float(cfg.FACT.mwt),
                                     jnp.ones(last["action_clogit"].shape[:2], bool))
    params_np = jax.tree_util.tree_map(np.asarray, params["params"])
    return dict(params=params_np, feats=feats, mask=mask, lengths=lengths,
                saves=[{k: v for k, v in s.items() if k != "kind"} for s in saves],
                pred=np.asarray(pred))


def _port(jax_run):
    model = build_fact(small_cfg(), D, C, S_CAP, device="cpu")
    load_jax_params(model, jax_run["params"])
    return model


@pytest.mark.parametrize("kernels", [True, False])
def test_slice_matches_jax_block_by_block(jax_run, kernels):
    model = _port(jax_run)
    model.set_kernels(kernels)
    x = [torch.from_numpy(jax_run[k]) for k in ("feats", "mask", "lengths")]
    with torch.no_grad():
        saves, _ = model(*x)
    mask = jax_run["mask"]
    assert len(saves) == len(jax_run["saves"]) == 4
    for i, (sp, sj) in enumerate(zip(saves, jax_run["saves"])):
        for key in ("frame_clogit", "action_clogit", "a2f_attn", "f2a_attn"):
            if key not in sj:
                continue
            got, ref = sp[key].numpy(), np.asarray(sj[key])
            assert got.shape == ref.shape, (i, key)
            if key in ("frame_clogit", "a2f_attn"):
                got, ref = got[mask], ref[mask]
            elif key == "f2a_attn":
                got, ref = got.transpose(0, 2, 1)[mask], ref.transpose(0, 2, 1)[mask]
            np.testing.assert_allclose(got, ref, atol=ATOL, err_msg=f"block {i} {key}")
    pred = make_eval_step(model, 0.1)(*x).numpy()
    np.testing.assert_array_equal(pred[mask], jax_run["pred"][mask])


def test_state_dict_keys_are_the_exporters(jax_run):
    model = build_fact(small_cfg(), D, C, S_CAP, device="cpu")
    exported = export_fact_state_dict(jax_run["params"], model.block_cfgs)
    assert set(model.state_dict()) == set(exported)
    for k, v in model.state_dict().items():
        assert tuple(v.shape) == exported[k].shape, k
    assert model.state_dict()["action_query"].shape == (8, 1, 16)


def test_padding_does_not_change_valid_frames(jax_run):
    """A video padded into a longer bucket decodes the same on its frames."""
    model = _port(jax_run)
    f, n = jax_run["feats"][1:2, :61], 61
    step = make_eval_step(model, 0.1)
    short = step(torch.from_numpy(f), torch.ones(1, n, dtype=torch.bool),
                 torch.tensor([n])).numpy()
    padded = np.zeros((1, T, D), np.float32)
    padded[:, :n] = f
    long = step(torch.from_numpy(padded), torch.from_numpy(np.arange(T)[None] < n),
                torch.tensor([n])).numpy()
    np.testing.assert_array_equal(short[0], long[0, :n])


def _jax_block_cfgs(small: bool, monkeypatch):
    # the JAX resolution asks the live backend; name the TPU so that
    # ``pallas`` resolves as it does on the chip the config was written for
    monkeypatch.setattr(jblocks, "_PALLAS_PLATFORM_OVERRIDE", "tpu")
    return jblocks.resolve_block_cfgs(_make_cfg(small))


@pytest.mark.parametrize("small", [False, True])
def test_configs_equal_the_jax_package_field_for_field(small, monkeypatch):
    ref = _jax_block_cfgs(small, monkeypatch)
    cfg = small_cfg() if small else flagship_cfg()
    got = resolve_block_cfgs(cfg)
    assert [dataclasses.asdict(c) for c in got] == [dataclasses.asdict(c) for c in ref]
    jcfg = _make_cfg(small)
    for key in ("ntoken", "block", "fpos", "mwt", "trans"):
        assert cfg["FACT"][key] == jcfg.FACT[key], key


def test_flagship_shapes():
    """The flagship at full width, built on the meta device (no memory)."""
    c = resolve_block_cfgs(flagship_cfg())
    assert [b.kind for b in c] == list("iuUU")
    assert (c[0].hid_dim, c[0].a_dim, c[0].f_dim, c[0].a_layers, c[0].f_layers) == \
        (512, 256, 256, 6, 10)
    assert [(b.a, b.a_layers, b.f_layers, b.a_nhead, b.a_ffdim) for b in c[1:]] == \
        [("sa", 1, 5, 8, 512)] * 3
    model = build_fact(flagship_cfg(), 2048, 75, 128, device="meta")
    assert model.block_list[0].frame_branch.conv_1x1.weight.shape == (256, 2048, 1)
    assert model.block_list[0].action_branch.layers[0].multihead_attn.k_proj_weight.shape == \
        (256, 512)
    assert len(model.block_list[0].action_branch.layers) == 6
