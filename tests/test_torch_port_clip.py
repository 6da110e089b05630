"""FACT_CLIP in the port against the JAX package on the CPU, module by module
and as a train step.

* ``data/text_prompts.py`` equal to JAX's on ``tests/test_clip.py``'s labels
  and a spread of HAViD codes, its tables equal; the text descriptions and
  the cache's default path equal; the embedding cache read back equal from
  ``.pt`` (also by JAX's reader) and ``.npy``.
* ``build_clip_bundle`` equal to JAX's with and without held-out classes.
* ``FeatureProjection`` against flax's within 1e-5 (eval mode, and train
  mode with dropout 0); its dropout draws from the generator.
* ``infonce_contrastive_loss`` and ``action_token_contrastive_loss`` per
  video within rtol 1e-5, their gradients against ``jax.grad`` within 1e-5 x
  max(1, |ref|), with ragged masks and absent classes.
* ``decode_with_clip`` equal, the no-action fallback included.
* A narrow FACT_CLIP (``iu`` / ``iuU``, ``f: m`` and ``f: m2``) through the
  port's exporter: every block's outputs and the projected embeddings within
  1e-4 (``tests/test_torch_port_model.py``'s ATOL), its keys the exporter's.
* The train step against JAX's ``make_step_fns`` with a bundle (dropout off,
  classes held out): the loss to 1e-4 relative, its split, the matching, the
  decode and every gradient (``frame_projection.*`` included) to 1e-4 x
  scale absolute and 1e-3 relative; the eval step's decode equal.
* ``use_clip`` without embeddings: FACT_CLIP trains and decodes as FACT, the
  projection unused, as in JAX, and weight decay moves it as optax does.

JAX runs on the CPU on its XLA paths; the port runs both its kernel entries
(their plain versions on CPU tensors) and its plain path.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _make_batch
from fact_clip_tpu.configs.default import get_cfg_defaults as jax_defaults
from fact_clip_tpu.data import text_embeddings as jte
from fact_clip_tpu.data import text_prompts as jtp
from fact_clip_tpu.engine import setup as jsetup
from fact_clip_tpu.engine.steps import make_step_fns
from fact_clip_tpu.models import blocks as jblocks
from fact_clip_tpu.models import decode as jdecode
from fact_clip_tpu.models import layers as jlayers
from fact_clip_tpu.models import losses as jl
from fact_clip_tpu.models.clip_model import build_fact_clip as jax_build_fact_clip
from fact_clip_tpu.utils.torch_export import export_fact_state_dict as jax_export
from fact_clip_tpu.utils.torch_import import convert_fact_state_dict
from fact_clip_tpu_torch.configs import get_cfg_defaults
from fact_clip_tpu_torch.data import text_embeddings as tte
from fact_clip_tpu_torch.data import text_prompts as ttp
from fact_clip_tpu_torch.engine.setup import build_clip_bundle
from fact_clip_tpu_torch.engine.steps import make_eval_step, make_train_step
from fact_clip_tpu_torch.engine.train_loop import batch_to_device
from fact_clip_tpu_torch.models import decode as tdecode
from fact_clip_tpu_torch.models import losses as tl
from fact_clip_tpu_torch.models.clip_model import FACTCLIP, build_fact_clip
from fact_clip_tpu_torch.models.layers import FeatureProjection
from fact_clip_tpu_torch.utils.bridge import grads_from_jax, load_jax_params
from fact_clip_tpu_torch.utils.torch_export import export_fact_state_dict

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-4  # model forward parity, float32 both sides (tests/test_torch_port_model.py)

# tests/test_clip.py's labels, then HAViD codes of every verb and length,
# unknown letters, case and whitespace
LABELS = ["sshc1dh", "gnt", "null", "w", "iglft", "pntbx", "rhdcb", "crack_egg", "",
          "a", "dbo", "gsc", "hgl", "ispsp1", "lbxgs", "mnt", "pbt", "rhdsb", "sshc2dp",
          "tsssp2ws", "uwnwn", "zzz", "xqq1", "SSHC1DH", " gnt ", "NULL", "w1", "ig", "ignt",
          "iglftwn"]


# ----------------------------------------------------------------- prompts
def test_prompt_tables_are_jaxs():
    for name in ("VERB_MAP", "OBJECTS_MAP", "TOOL_MAP", "VERB_PREP", "NOISE_MAP"):
        assert getattr(ttp, name) == getattr(jtp, name), name


@pytest.mark.parametrize("label", LABELS)
def test_prompts_equal_jaxs(label):
    assert ttp.parse_havid_label(label) == jtp.parse_havid_label(label)
    assert ttp.is_havid_label(label) == jtp.is_havid_label(label)
    assert ttp.generate_simple_prompt(label) == jtp.generate_simple_prompt(label)
    if label.strip():
        assert ttp.generate_action_prompt(label) == jtp.generate_action_prompt(label)
        tmpl = "{verb} | {manipulated_object} | {target_object} | {tool} | {prep}"
        assert ttp.generate_action_prompt(label, tmpl) == jtp.generate_action_prompt(label, tmpl)


def test_all_prompts_and_descriptions_equal_jaxs():
    index2label = {i: l for i, l in enumerate(LABELS) if l.strip()}
    index2label.pop(3)  # a hole: "a person performs action 3"
    label2index = {l: i for i, l in index2label.items()}
    assert ttp.get_all_prompts(label2index, index2label) == \
        jtp.get_all_prompts(label2index, index2label)
    for dataset in ("havid_view0_lh_pt", "gtea"):
        for use_prompt in (True, False):
            jcfg, cfg = jax_defaults(), get_cfg_defaults()
            for c in (jcfg, cfg):
                c.dataset, c.CLIP.use_prompt = dataset, use_prompt
            got = tte.generate_text_descriptions(cfg, label2index, index2label)
            assert got == jte.generate_text_descriptions(jcfg, label2index, index2label)
            assert tte.default_emb_path(cfg, "/b") == jte.default_emb_path(jcfg, "/b")


def test_embedding_cache_reads_back(tmp_path):
    emb = np.random.default_rng(0).normal(size=(7, 16)).astype(np.float32)
    pt, npy = str(tmp_path / "cache.pt"), str(tmp_path / "cache.npy")
    tte.save_text_embeddings(emb, pt)
    tte.save_text_embeddings(emb, npy)
    for path in (pt, npy):
        np.testing.assert_array_equal(tte.load_text_embeddings(path), emb)
        np.testing.assert_array_equal(jte.load_text_embeddings(path), emb)
    ref = str(tmp_path / "ref.pt")  # the reference's format, as JAX writes it
    jte.save_text_embeddings(emb, ref)
    np.testing.assert_array_equal(tte.load_text_embeddings(ref), emb)
    cfg = get_cfg_defaults()
    cfg.use_clip, cfg.CLIP.text_emb_path = True, pt
    np.testing.assert_array_equal(
        tte.get_or_compute_text_embeddings(cfg, {}, {}, base=str(tmp_path)), emb)
    with pytest.raises(FileNotFoundError):
        tte.load_text_embeddings(str(tmp_path / "missing.pt"))


# ------------------------------------------------------------------ bundle
@pytest.mark.parametrize("holdout", [[], [2, 4], [0, 5]])
def test_clip_bundle_equals_jaxs(holdout):
    emb = np.random.default_rng(1).normal(size=(6, 8)).astype(np.float32)
    jcfg, cfg = jax_defaults(), get_cfg_defaults()
    for c in (jcfg, cfg):
        c.CLIP.temp, c.CLIP.contrastive_weight = 0.1, 0.3
    ref = jsetup.build_clip_bundle(jcfg, emb, holdout)
    got = build_clip_bundle(cfg, emb, holdout)
    assert set(got) == set(ref)
    for k, v in ref.items():
        if isinstance(v, float):
            assert got[k] == v, k
        else:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)


# -------------------------------------------------------------- projection
def test_feature_projection_matches_flax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 9, 20)).astype(np.float32)
    mod = jlayers.FeatureProjection(clip_dim=12, hidden_dim=24, dropout=0.0)
    params = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    ref = np.asarray(mod.apply({"params": params}, jnp.asarray(x)))
    port = FeatureProjection(20, 12, 24, dropout=0.0)
    d0, ln, d1 = params["TorchDense_0"]["Dense_0"], params["LayerNorm_0"], \
        params["TorchDense_1"]["Dense_0"]
    port.load_state_dict({
        "projection.0.weight": torch.from_numpy(np.asarray(d0["kernel"]).T.copy()),
        "projection.0.bias": torch.from_numpy(np.asarray(d0["bias"])),
        "projection.1.weight": torch.from_numpy(np.asarray(ln["scale"])),
        "projection.1.bias": torch.from_numpy(np.asarray(ln["bias"])),
        "projection.4.weight": torch.from_numpy(np.asarray(d1["kernel"]).T.copy()),
        "projection.4.bias": torch.from_numpy(np.asarray(d1["bias"]))}, strict=True)
    assert port.projection[1].eps == 1e-6  # flax's LayerNorm default, not torch's 1e-5
    for train in (False, True):
        port.train(train)
        with torch.no_grad():
            got = port(torch.from_numpy(x), torch.Generator().manual_seed(0)).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-6)


def test_feature_projection_dropout_draws_from_the_generator():
    port = FeatureProjection(8, 4, 64, dropout=0.5).train()
    x = torch.randn(3, 5, 8)
    a = port(x, torch.Generator().manual_seed(3))
    b = port(x, torch.Generator().manual_seed(3))
    c = port(x, torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="generator"):
        port(x)
    assert torch.equal(port.eval()(x), port(x, torch.Generator().manual_seed(5)))


# ------------------------------------------------------------------ losses
def _unit(rng, shape):
    v = rng.normal(size=shape).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _infonce_inputs(seed):
    """Ragged valid prefixes, a video with no valid frame, labels drawn from
    a subset so that classes are absent, frames of held-out classes masked."""
    rng = np.random.default_rng(seed)
    B, T, E, n = 3, 40, 16, 7
    emb, text = _unit(rng, (B, T, E)), _unit(rng, (n, E))
    labels = rng.choice([0, 2, 3, 5], size=(B, T)).astype(np.int32)
    mask = np.arange(T)[None] < np.array([40, 23, 0])[:, None]
    mask[0, rng.integers(0, T, 6)] = False
    return emb, text, labels, mask


@pytest.mark.parametrize("seed", [0, 1])
def test_infonce_and_its_gradients_match_jax(seed):
    emb, text, labels, mask = _infonce_inputs(seed)
    temp = 0.07

    def jax_loss(e, t):
        return jl.infonce_contrastive_loss(e, t, jnp.asarray(labels), jnp.asarray(mask), temp)

    ref = np.asarray(jax_loss(jnp.asarray(emb), jnp.asarray(text)))
    w = np.random.default_rng(seed + 7).normal(size=ref.shape).astype(np.float32)
    gref = jax.grad(lambda e, t: (jax_loss(e, t) * w).sum(), argnums=(0, 1))(
        jnp.asarray(emb), jnp.asarray(text))
    e, t = torch.from_numpy(emb).requires_grad_(), torch.from_numpy(text).requires_grad_()
    got = tl.infonce_contrastive_loss(e, t, torch.from_numpy(labels), torch.from_numpy(mask),
                                      temp)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-5)
    assert np.isfinite(ref).all()
    grads = torch.autograd.grad((got * torch.from_numpy(w)).sum(), (e, t))
    for g, r in zip(grads, gref):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, atol=1e-5 * max(1.0, float(np.abs(r).max())))


@pytest.mark.parametrize("seed", [0, 1])
def test_action_token_contrastive_loss_matches_jax(seed):
    rng = np.random.default_rng(seed)
    B, M, S, E, n = 2, 6, 5, 8, 9
    tok, text = _unit(rng, (B, M, E)), _unit(rng, (n, E))
    seg2tok = rng.integers(-1, M, (B, S)).astype(np.int32)  # -1 wraps, as in JAX
    transcript = rng.integers(0, n, (B, S)).astype(np.int32)
    seg_mask = np.arange(S)[None] < np.array([5, 3])[:, None]
    args = (jnp.asarray(seg2tok), jnp.asarray(transcript), jnp.asarray(seg_mask), 0.1)
    ref = np.asarray(jl.action_token_contrastive_loss(jnp.asarray(tok), jnp.asarray(text),
                                                      *args))
    gref = jax.grad(lambda a, b: jl.action_token_contrastive_loss(a, b, *args).sum(),
                    argnums=(0, 1))(jnp.asarray(tok), jnp.asarray(text))
    a, b = torch.from_numpy(tok).requires_grad_(), torch.from_numpy(text).requires_grad_()
    got = tl.action_token_contrastive_loss(a, b, torch.from_numpy(seg2tok),
                                           torch.from_numpy(transcript),
                                           torch.from_numpy(seg_mask), 0.1)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-5)
    for g, r in zip(torch.autograd.grad(got.sum(), (a, b)), gref):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, atol=1e-5 * max(1.0, float(np.abs(r).max())))


# ------------------------------------------------------------------ decode
@pytest.mark.parametrize("case", ["votes", "no_action", "mixed"])
def test_decode_with_clip_equals_jaxs(case):
    rng = np.random.default_rng(3)
    B, T, M, C, E = 3, 30, 6, 5, 8
    aclog = rng.normal(size=(B, M, C + 1)).astype(np.float32)
    if case in ("no_action", "mixed"):  # every token of video 0 (all videos) predicts null
        aclog[: B if case == "no_action" else 1, :, C] = 9.0
    a2f = rng.dirichlet(np.ones(M), size=(B, T)).astype(np.float32)
    emb, text = _unit(rng, (B, T, E)), _unit(rng, (C, E))
    token_mask = np.ones((B, M), bool)
    token_mask[2, 4:] = False
    for w in (0.1, 0.9):
        ref = np.asarray(jdecode.decode_with_clip(jnp.asarray(aclog), jnp.asarray(a2f),
                                                  jnp.asarray(emb), jnp.asarray(text), 0.07, w,
                                                  jnp.asarray(token_mask)))
        got = tdecode.decode_with_clip(torch.from_numpy(aclog), torch.from_numpy(a2f),
                                       torch.from_numpy(emb), torch.from_numpy(text), 0.07, w,
                                       torch.from_numpy(token_mask))
        np.testing.assert_array_equal(got.numpy(), ref)
    if case == "no_action":  # the CLIP argmax
        sim = emb @ text.T
        np.testing.assert_array_equal(got.numpy(), sim.argmax(-1))


# ------------------------------------------------------------------- model
D, C, S_CAP, B, T, S, CLIP_DIM = 12, 5, 24, 2, 96, 8, 10


def _narrow(block: str, f: str, holdout=(), proj_dropout=0.0):
    """The same narrow FACT_CLIP config in the JAX and the port tree."""
    jcfg, cfg = jax_defaults(), get_cfg_defaults()
    for c in (jcfg, cfg):
        c.use_clip = True
        c.holdout_mode, c.holdout_classes = bool(holdout), list(holdout)
        c.FACT.block, c.FACT.ntoken, c.FACT.fpos, c.FACT.cmr = block, 8, False, 0.0
        c.Bi.hid_dim, c.Bi.a_dim, c.Bi.a_ffdim, c.Bi.a_layers, c.Bi.a_nhead = 32, 16, 32, 2, 4
        c.Bi.f, c.Bi.f_dim, c.Bi.f_layers, c.Bi.f_ln, c.Bi.dropout = f, 24, 3, False, 0.0
        c.Bu.f_layers = c.BU.f_layers = 2
        c.Loss.sw, c.Loss.pc, c.Loss.nullw = 1.0, 0.2, 0.1
        c.CLIP.temp, c.CLIP.projection_hidden_dim = 0.1, 20
        c.CLIP.projection_dropout = proj_dropout
        c.optimizer, c.lr = "Adam", 0.002
        c.TPU.matcher = "host"
    return jcfg, cfg


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((B, T, D)).astype(np.float32)
    lengths = np.array([96, 61], np.int32)
    mask = np.arange(T)[None] < lengths[:, None]
    feats[~mask] = 0.0
    return feats, mask, lengths


@pytest.mark.parametrize("block, f", [("iu", "m"), ("iuU", "m"), ("iu", "m2"), ("iuU", "m2")])
@pytest.mark.parametrize("kernels", [True, False])
def test_fact_clip_matches_jax_block_by_block(block, f, kernels):
    jcfg, cfg = _narrow(block, f)
    feats, mask, lengths = _inputs()
    jmodel = jax_build_fact_clip(jcfg, D, C, S_CAP, CLIP_DIM)
    args = (jnp.asarray(feats), jnp.asarray(mask), jnp.asarray(lengths))
    params = jax.tree_util.tree_map(
        np.asarray, jmodel.init({"params": jax.random.PRNGKey(1)}, *args, train=False)["params"])
    jsaves, jemb = jmodel.apply({"params": params}, *args, train=False)

    model = build_fact_clip(cfg, D, C, S_CAP, CLIP_DIM, device="cpu")
    assert isinstance(model, FACTCLIP)
    ref_sd = jax_export(params, jblocks.resolve_block_cfgs(jcfg))
    assert set(model.state_dict()) == set(ref_sd)
    assert {k for k in ref_sd if k.startswith("frame_projection")} == {
        f"frame_projection.projection.{i}.{p}" for i in (0, 1, 4) for p in ("weight", "bias")}
    port_sd = export_fact_state_dict(params, model.block_cfgs)
    assert set(port_sd) == set(ref_sd)
    for k, v in ref_sd.items():
        np.testing.assert_array_equal(port_sd[k], v, err_msg=k)
    load_jax_params(model, params)
    model.set_kernels(kernels)
    with torch.no_grad():
        saves, emb = model(*(torch.from_numpy(a) for a in (feats, mask, lengths)))
    assert emb.shape == (B, T, CLIP_DIM)
    np.testing.assert_allclose(emb.numpy()[mask], np.asarray(jemb)[mask], atol=ATOL)
    for i, (sp, sj) in enumerate(zip(saves, jsaves)):
        for key in ("frame_clogit", "action_clogit", "a2f_attn"):
            if key not in sj:
                continue
            got, ref = sp[key].numpy(), np.asarray(sj[key])
            if key != "action_clogit":
                got, ref = got[mask], ref[mask]
            np.testing.assert_allclose(got, ref, atol=ATOL, err_msg=f"block {i} {key}")


# -------------------------------------------------------------- train step
class _Capture:
    """A stand-in TrainState: keeps the gradients ``apply_gradients`` is given."""

    def __init__(self, params):
        self.params = params

    def apply_gradients(self, grads):
        self.grads = grads
        return self


@pytest.fixture(scope="module", params=[("iuU", "m"), ("iuU", "m2")], ids=["m", "m2"])
def clip_run(request):
    """JAX's ``make_step_fns`` with a bundle, classes 1 and 3 held out: the
    step's outputs and the gradients it hands to ``apply_gradients``."""
    block, f = request.param
    jcfg, cfg = _narrow(block, f, holdout=(1, 3))
    batch = _make_batch(np.random.default_rng(0), B, T, D, C, S)
    emb = _unit(np.random.default_rng(5), (C, CLIP_DIM))
    jmodel = jax_build_fact_clip(jcfg, D, C, S_CAP, CLIP_DIM)
    port = build_fact_clip(cfg, D, C, S_CAP, CLIP_DIM, device="cpu",
                           generator=torch.Generator().manual_seed(2))
    params = convert_fact_state_dict({k: v.numpy() for k, v in port.state_dict().items()},
                                     jblocks.resolve_block_cfgs(jcfg))
    assert set(params) == {"fact", "frame_projection"}
    cweight = jl.build_class_weights(jcfg, C, [0])
    out = {}
    for name, bundle in (("clip", jsetup.build_clip_bundle(jcfg, emb, [1, 3])), ("plain", None)):
        train_step, eval_step = make_step_fns(jmodel, jcfg, C, cweight, bundle)

        @jax.jit
        def step(params, batch):
            st, o = train_step.unjitted(_Capture(params), batch, jax.random.PRNGKey(0))
            return st.grads, o

        grads, o = step(params, batch)
        out[name] = dict(grads=jax.tree_util.tree_map(np.asarray, grads),
                         out={k: np.asarray(v) for k, v in o.items()},
                         pred=np.asarray(eval_step(params, batch)))
    return dict(jcfg=jcfg, cfg=cfg, batch={k: np.asarray(v) for k, v in batch.items()},
                emb=emb, params=jax.tree_util.tree_map(np.asarray, params), cweight=cweight,
                **out)


def _port_model(run, kernels):
    model = build_fact_clip(run["cfg"], D, C, S_CAP, CLIP_DIM, device="cpu")
    load_jax_params(model, run["params"])
    model.set_kernels(kernels)
    return model


def _check_grads(model, grads, ref_tree, zero_projection=False):
    names = [n for n, _ in model.named_parameters()]
    ref = grads_from_jax(ref_tree, model.block_cfgs)
    assert set(names) == set(ref)
    scale = max(float(np.abs(v.numpy()).max()) for v in ref.values())
    for n, g in zip(names, grads):
        if g is None:  # a parameter the loss does not reach: JAX's gradient is 0
            g = torch.zeros_like(ref[n])
        np.testing.assert_allclose(g.numpy(), ref[n].numpy(), atol=1e-4 * max(1.0, scale),
                                   rtol=1e-3, err_msg=n)
        if zero_projection and n.startswith("frame_projection"):
            assert not ref[n].abs().max() > 0, n
    return dict(zip(names, grads))


@pytest.mark.parametrize("kernels", [True, False])
def test_clip_train_step_matches_jax(clip_run, kernels):
    run = clip_run
    model = _port_model(run, kernels)
    bundle = build_clip_bundle(run["cfg"], run["emb"], [1, 3])
    step = make_train_step(model, run["cfg"], C, run["cweight"], clip_bundle=bundle)
    ref = run["clip"]["out"]
    aux = {}
    per_video, seg2tok, _ = step.loss(batch_to_device(run["batch"], "cpu"),
                                      torch.Generator().manual_seed(0), aux=aux)
    np.testing.assert_allclose(per_video.detach().numpy(), ref["per_video_loss"], rtol=1e-4)
    np.testing.assert_allclose(aux["fact_loss"].detach().numpy(), ref["fact_loss"], rtol=1e-4)
    np.testing.assert_allclose(aux["contrastive_loss"].detach().numpy(),
                               ref["contrastive_loss"], rtol=1e-4)
    assert (ref["contrastive_loss"] > 0).all()
    loss = per_video.mean()
    np.testing.assert_allclose(float(loss.detach()), float(ref["loss"]), rtol=1e-4)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    got = _check_grads(model, grads, run["clip"]["grads"])
    assert all(float(got[n].abs().max()) > 0 for n in got if n.startswith("frame_projection"))

    # the whole step: its outputs and the train-time decode of the pre-update forward
    out = step(batch_to_device(run["batch"], "cpu"), torch.Generator().manual_seed(0))
    np.testing.assert_allclose(float(out["loss"]), float(ref["loss"]), rtol=1e-4)
    np.testing.assert_allclose(out["contrastive_loss"].numpy(), ref["contrastive_loss"],
                               rtol=1e-4)
    mask = run["batch"]["mask"]
    np.testing.assert_array_equal(out["pred"].numpy()[mask], ref["pred"][mask])
    np.testing.assert_array_equal(seg2tok.numpy(), _seg2tok(run))


def _seg2tok(run):
    """JAX's matching of the run's batch (the step does not return it)."""
    from fact_clip_tpu.models import matching as jm

    jmodel = jax_build_fact_clip(run["jcfg"], D, C, S_CAP, CLIP_DIM)
    b = {k: jnp.asarray(v) for k, v in run["batch"].items()}
    saves, _ = jmodel.apply({"params": run["params"]}, b["feats"], b["mask"], b["lengths"],
                            train=False)
    last = saves[-1]
    return np.asarray(jm.match(run["jcfg"].Loss, jax.nn.softmax(last["action_clogit"], -1),
                               last["a2f_attn"], b["transcript"], b["seg_label"],
                               b["seg_mask"], b["mask"], matcher="host", nclasses=C))


def test_clip_eval_step_matches_jax(clip_run):
    run = clip_run
    model = _port_model(run, True)
    bundle = build_clip_bundle(run["cfg"], run["emb"], [1, 3])
    x = batch_to_device(run["batch"], "cpu")
    pred = make_eval_step(model, run["cfg"].FACT.mwt, bundle)(x["feats"], x["mask"],
                                                              x["lengths"])
    mask = run["batch"]["mask"]
    np.testing.assert_array_equal(pred.numpy()[mask], run["clip"]["pred"][mask])


@pytest.mark.parametrize("kernels", [True, False])
def test_use_clip_without_embeddings_trains_as_fact(clip_run, kernels):
    """No bundle: the FACT loss alone, the two-branch decode, the projection
    computed but unused (its gradient 0 in JAX, none from autograd here; the
    optimizer gives it zeros), as JAX does."""
    run = clip_run
    model = _port_model(run, kernels)
    step = make_train_step(model, run["cfg"], C, run["cweight"])
    ref = run["plain"]["out"]
    assert "contrastive_loss" not in ref
    per_video, _, _ = step.loss(batch_to_device(run["batch"], "cpu"),
                                torch.Generator().manual_seed(0))
    np.testing.assert_allclose(per_video.detach().numpy(), ref["per_video_loss"], rtol=1e-4)
    loss = per_video.mean()
    grads = torch.autograd.grad(loss, list(model.parameters()), allow_unused=True)
    got = _check_grads(model, grads, run["plain"]["grads"], zero_projection=True)
    assert all(got[n] is None for n in got if n.startswith("frame_projection"))
    out = step(batch_to_device(run["batch"], "cpu"), torch.Generator().manual_seed(0))
    assert set(out) == {"loss", "per_video_loss", "pred", "seg2tok"}
    mask = run["batch"]["mask"]
    np.testing.assert_array_equal(out["pred"].numpy()[mask], ref["pred"][mask])


@pytest.mark.parametrize("optimizer", ["Adam", "SGD"])
def test_use_clip_without_embeddings_decays_the_projection_as_jax(clip_run, optimizer):
    """weight_decay > 0 without a bundle: optax hands the unused projection a
    zero gradient and decays it (``optax.add_decayed_weights``), and so does
    the port's optimizer: two steps leave ``frame_projection.*`` where two of
    JAX's updates do.  The projection's gradients are 0 on both sides, so its
    update does not depend on the other parameters' (Adam and L2 act per
    element, clipping scales zeros)."""
    import copy

    from fact_clip_tpu.engine import state as jstate

    run = clip_run
    jcfg, cfg = copy.deepcopy(run["jcfg"]), copy.deepcopy(run["cfg"])
    for c in (jcfg, cfg):
        c.optimizer, c.weight_decay = optimizer, 0.05
        if optimizer == "SGD":
            c.lr, c.momentum = 0.05, 0.9
    tx = jstate.build_optimizer(jcfg, steps_per_epoch=1)
    params, grads = run["params"], run["plain"]["grads"]
    assert all(not np.abs(g).max() > 0
               for g in jax.tree_util.tree_leaves(grads["frame_projection"]))
    opt_state = tx.init(params)
    for _ in range(2):
        updates, opt_state = tx.update(grads, opt_state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
    model = _port_model(run, False)
    step = make_train_step(model, cfg, C, run["cweight"])
    before = {k: v.clone() for k, v in model.state_dict().items()}
    for _ in range(2):
        step(batch_to_device(run["batch"], "cpu"), torch.Generator().manual_seed(0))
    ref = export_fact_state_dict(jax.tree_util.tree_map(np.asarray, params), model.block_cfgs)
    names = [k for k in ref if k.startswith("frame_projection")]
    assert len(names) == 6
    for k in names:
        got = model.state_dict()[k]
        assert not torch.equal(got, before[k]) or not before[k].abs().max() > 0, k  # decayed
        np.testing.assert_allclose(got.numpy(), ref[k], atol=1e-6, rtol=0, err_msg=k)


def test_the_clip_modules_import_no_jax():
    code = """
import sys
import fact_clip_tpu_torch.models.clip_model, fact_clip_tpu_torch.data.text_embeddings  # noqa
import fact_clip_tpu_torch.data.text_prompts, fact_clip_tpu_torch.engine.setup  # noqa
import fact_clip_tpu_torch.train, fact_clip_tpu_torch.run_eval  # noqa
bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'fact_clip_tpu', 'yaml',
                                                     'transformers')]
assert not bad, bad
print('GUARD_OK')
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=dict(os.environ, PYTHONPATH=REPO), timeout=120)
    assert proc.returncode == 0 and "GUARD_OK" in proc.stdout, proc.stderr[-2000:]


# ------------------------------------------- K2's flash backward at 75 tokens
@pytest.mark.parametrize("x_pos", [True, False])
def test_flash_backward_over_75_query_rows_matches_jax(monkeypatch, x_pos):
    """The holdout recipes' 75 action tokens over > 1024 frames: the flash
    backward runs its card launches (``FakeK2Lib``, the model of the
    library's C interface) on 64 + 11 query rows, the chunks joined by
    ``_flash_bwd_rows``, against ``jax.vjp`` of JAX's flash form in
    interpret mode and against the plain backward of all 75 rows, at the
    K2 tests' tolerance."""
    from test_torch_port_k2_tc import GRADS, TOL, FakeK2Lib, _close, _x2y_inputs, _x2y_vjp

    from fact_clip_tpu_torch import _build
    from fact_clip_tpu_torch.ops import x2y_attn as xa

    lib = FakeK2Lib()
    monkeypatch.setattr(_build, "lib", lambda: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(xa, "x2y_flash_bwd", lambda *a, need_xpos_grad: xa._x2y_flash_bwd_card(
        *a, need_xpos_grad))
    M, X = 75, 1100
    assert not xa.has_backward(M, X, 48) and xa.takes_grad(M, X, 48)
    j, t = _x2y_inputs(5, M, X, [1100, 600], x_pos)
    outs, g, refs = _x2y_vjp(j, np.random.default_rng(6))
    attn, probs = torch.from_numpy(outs[0]), torch.from_numpy(outs[1])
    gt = [torch.from_numpy(a) for a in g]
    got = xa._flash_bwd_rows(*t, probs, attn, *gt, True)
    assert [c for c in lib.calls if c[0] == "x2y_flash_attn_bwd"] == [("x2y_flash_attn_bwd",)] * 2
    plain = xa.x2y_bwd_reference(*t, probs, *gt)
    for i, name in enumerate(GRADS):
        if not x_pos and name == "d_xpos":
            assert got[i] is None
            continue
        _close(got[i].numpy(), refs[i], TOL, what=name)
        _close(got[i].numpy(), plain[i].numpy(), TOL, what=name)


# ------------------------------------------------------------ the optimizer
def test_a_fused_adam_step_refreshes_the_kernel_packs(monkeypatch):
    """The card's Adam is fused, and a fused update leaves the parameters'
    version counters as they were; the modules' packed-weight caches key on
    them, so an eval after a step (the loop's second test pass, phase 16's
    ``run_eval`` check) ran on stale packs until ``Optimizer.step`` bumped
    them.  Fused Adam forced on the CPU: every version moves and a cached
    layout is rebuilt from the updated weights."""
    from fact_clip_tpu_torch.engine.state import build_optimizer

    real = torch.optim.Adam
    monkeypatch.setattr(torch.optim, "Adam",
                        lambda params, **kw: real(params, **dict(kw, fused=True)))
    _, cfg = _narrow("iu", "m")
    model = build_fact_clip(cfg, D, C, S_CAP, CLIP_DIM, device="cpu")
    opt = build_optimizer(model, cfg)
    assert opt.opt.defaults["fused"]
    tower = model.block_list[0].frame_branch
    before = [t.clone() for t in tower.kernel_layout()[:1]]
    versions = [p._version for p in model.parameters()]
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    assert all(p._version > v for p, v in zip(model.parameters(), versions))
    fresh = tower._make_kernel_layout()
    for a, b, c in zip(before, tower.kernel_layout()[:1], fresh[:1]):
        assert not torch.equal(a, b) and torch.equal(b, c)


# ------------------------------------------------------------------ configs
def _plain(node):
    return {k: _plain(v) for k, v in node.items()} if isinstance(node, dict) else node


def test_openvocab_cfgs_are_the_recipes():
    """``openvocab_cfg()`` is ``openvocab_havid_view0_lh_pt.yaml`` over the
    defaults, key for key, as JAX's ``setup_cfg`` reads it (``aux`` aside);
    ``openvocab_train_cfg()`` adds the holdout recipes' split and the host
    matcher; both resolve to JAX's block configs."""
    from fact_clip_tpu.configs.utils import setup_cfg as jax_setup_cfg
    from fact_clip_tpu_torch.configs import (openvocab_cfg, openvocab_train_cfg,
                                             resolve_block_cfgs)

    yaml = os.path.join(REPO, "fact_clip_tpu", "configs", "openvocab_havid_view0_lh_pt.yaml")
    ref = _plain(jax_setup_cfg([yaml], []))
    got = openvocab_cfg()
    assert got["aux"]["eval_every"] == ref["aux"]["eval_every"]
    assert {k: v for k, v in got.items() if k != "aux"} == \
        {k: v for k, v in ref.items() if k != "aux"}
    holdout = _plain(jax_setup_cfg(
        [os.path.join(REPO, "fact_clip_tpu", "configs", "havid_view0_lh_pt_holdout.yaml")], []))
    train = openvocab_train_cfg()
    assert train["holdout_mode"] and train["holdout_classes"] == holdout["holdout_classes"]
    assert train["TPU"]["matcher"] == "host"
    jcfg = jax_setup_cfg([yaml], [])
    jcfg.TPU.pallas = False  # the JAX resolution on the CPU
    port = [dict(vars(c)) for c in resolve_block_cfgs(got)]
    for c in port:
        c.update(pallas=False)
    assert port == [dict(vars(c)) for c in jblocks.resolve_block_cfgs(jcfg)]
