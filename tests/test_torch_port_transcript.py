"""Transcript mode (``FACT.trans``) and GTEA's recipes in the port against the
JAX package on the CPU, module by module and as train and eval steps.

* ``gtea_cfg()``, ``gtea_train_cfg()`` and ``gtea_transcript_cfg()`` equal to
  ``gtea.yaml`` / ``gtea_transcript.yaml`` as JAX's ``setup_cfg`` reads them,
  their block configs JAX's; the GRU action branch resolves only in
  transcript mode.
* ``ActionUpdateGRU`` (``a: gru`` and ``gru_om``) and the masked ``BiGRU``
  against flax's on padded tokens, every position (the padding included:
  the SA layers after it see every token) within 1e-5.
* Both transcript decodes equal to JAX's, padding and ties included; ``seq``
  matching equal to JAX's ``match``.
* The column-masked smoothing, ``block_loss`` (kinds i, u, U) and
  ``fact_loss`` with a token mask, through K5's plain version and without
  it: values within 1e-5, gradients against ``jax.vjp`` within 1e-5.
* A narrow transcript FACT (``iuU``, an ``sca`` and a ``gru_om`` input
  block, towers 24 wide) through the port's exporter: every block's outputs
  within 1e-4 (``tests/test_torch_port_model.py``'s ATOL), its keys the JAX
  exporter's (``trans=True``); the verb/noun model in transcript mode the
  same way.
* The train step against JAX's ``make_step_fns`` with ``trans`` (dropout
  and masking off): the loss to 1e-4 relative, the matching, the decode and
  every gradient to 1e-4 x scale absolute and 1e-3 relative; the eval
  step's and ``Predictor``'s predictions equal to JAX's.
* The exporter both ways: a port state_dict read by JAX's
  ``convert_fact_state_dict(trans=True)`` / ``convert_verbnoun_state_dict``
  gives JAX's forward, equal to the port's within 1e-4.

JAX runs on the CPU on its XLA paths (its Pallas kernels are TPU-only
there); the port runs both its kernel entries (their plain versions on CPU
tensors) and its plain path.
"""

import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _make_batch
from fact_clip_tpu.configs.utils import setup_cfg as jax_setup_cfg
from fact_clip_tpu.engine.steps import make_step_fns
from fact_clip_tpu.models import blocks as jblocks
from fact_clip_tpu.models import decode as jdecode
from fact_clip_tpu.models import layers as jlayers
from fact_clip_tpu.models import losses as jl
from fact_clip_tpu.models import matching as jm
from fact_clip_tpu.models import verbnoun as jvn
from fact_clip_tpu.utils.torch_export import export_fact_state_dict as jax_export
from fact_clip_tpu.utils.torch_export import export_verbnoun_state_dict as jax_export_vn
from fact_clip_tpu.utils.torch_import import convert_fact_state_dict, convert_verbnoun_state_dict
from fact_clip_tpu_torch.configs import (epic_cfg, epic_vocab, gtea_cfg, gtea_train_cfg,
                                         gtea_transcript_cfg, resolve_block_cfgs)
from fact_clip_tpu_torch.engine.serve import Predictor
from fact_clip_tpu_torch.engine.steps import make_eval_step, make_train_step
from fact_clip_tpu_torch.engine.train_loop import batch_to_device
from fact_clip_tpu_torch.models import decode as tdecode
from fact_clip_tpu_torch.models import layers as tlayers
from fact_clip_tpu_torch.models import losses as tl
from fact_clip_tpu_torch.models import matching as tm
from fact_clip_tpu_torch.models import verbnoun as tvn
from fact_clip_tpu_torch.models.blocks import build_fact
from fact_clip_tpu_torch.utils import torch_export as texport
from fact_clip_tpu_torch.utils.bridge import grads_from_jax, load_jax_params

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "fact_clip_tpu", "configs")
TOL = 1e-5  # module and loss parity, float32 both sides (tests/test_torch_port_losses.py)
ATOL = 1e-4  # model forward parity (tests/test_torch_port_model.py)


def _plain(node):
    return {k: _plain(v) for k, v in node.items()} if isinstance(node, dict) else node


# ----------------------------------------------------------------- configs
@pytest.mark.parametrize("name, yaml, host", [
    ("gtea_cfg", "gtea.yaml", False), ("gtea_train_cfg", "gtea.yaml", True),
    ("gtea_transcript_cfg", "gtea_transcript.yaml", False)])
def test_gtea_cfgs_are_the_recipes(name, yaml, host):
    """Key for key the YAML over the defaults as JAX's ``setup_cfg`` reads it
    (the train form adds the host matcher), and JAX's block configs."""
    got = {"gtea_cfg": gtea_cfg, "gtea_train_cfg": gtea_train_cfg,
           "gtea_transcript_cfg": gtea_transcript_cfg}[name]()
    jcfg = jax_setup_cfg([os.path.join(CONFIGS, yaml)], [])
    ref = _plain(jcfg)
    assert got["TPU"].pop("matcher") == ("host" if host else ref["TPU"]["matcher"])
    ref["TPU"].pop("matcher")
    assert got["aux"]["eval_every"] == ref["aux"]["eval_every"]
    assert {k: v for k, v in got.items() if k != "aux"} == \
        {k: v for k, v in ref.items() if k != "aux"}
    jcfg.TPU.pallas = False  # the JAX resolution on the CPU
    port = [dict(vars(c), pallas=False) for c in resolve_block_cfgs(got)]
    assert port == [dict(vars(c)) for c in jblocks.resolve_block_cfgs(jcfg)]
    assert [c.a_dim // c.a_nhead for c in resolve_block_cfgs(got)] == [16, 16, 16]


@pytest.mark.parametrize("a", ["gru", "gru_om"])
def test_the_gru_branch_resolves_in_transcript_mode_only(a):
    cfg = gtea_transcript_cfg()
    cfg["Bi"]["a"] = a
    assert resolve_block_cfgs(cfg)[0].a == a
    cfg["FACT"]["trans"] = False
    with pytest.raises(ValueError, match="transcript mode"):
        resolve_block_cfgs(cfg)


# --------------------------------------------------------------------- GRU
def _gru_inputs(seed, B=3, N=9, E=16, lengths=(9, 4, 0)):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, N, E)).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    return x, lens, np.arange(N)[None] < lens[:, None]


@pytest.mark.parametrize("layers", [1, 3])
def test_bigru_matches_flax_on_every_step(layers):
    """The padding included: JAX's scan holds the forward state over it and
    the backward direction is 0 there (a video of no valid token too)."""
    x, lens, mask = _gru_inputs(layers)
    jmod = jlayers.BiGRU(8, layers)
    params = jmod.init(jax.random.PRNGKey(layers), jnp.asarray(x), jnp.asarray(mask))["params"]
    ref = np.asarray(jmod.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask)))
    sd = {}
    texport._gru(sd, "g", jax.tree_util.tree_map(np.asarray, params))
    mod = tlayers.BiGRU(16, 8, layers)
    mod.load_state_dict({k[2:]: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = mod(torch.from_numpy(x), torch.from_numpy(lens)).numpy()
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=TOL)
    assert not np.abs(got[1, 4:, :8] - got[1, 3:4, :8]).max() > 0  # held over the padding
    assert not np.abs(got[1, 4:, 8:]).max() > 0 and not np.abs(got[2]).max() > 0


@pytest.mark.parametrize("a, out_dim", [("gru", 16), ("gru_om", 40)])
@pytest.mark.parametrize("train", [False, True])
def test_action_update_gru_matches_flax(a, out_dim, train):
    """Eval mode, and train mode at dropout 0 (the dropout draws from the
    generator, which JAX's own RNG cannot match)."""
    x, lens, mask = _gru_inputs(7)
    jmod = jlayers.ActionUpdateGRU(in_dim=16, hid_dim=16, out_dim=out_dim, n_layers=2,
                                   dropout=0.0, out_map=a == "gru_om")
    params = jmod.init(jax.random.PRNGKey(3), jnp.asarray(x), jnp.asarray(mask))["params"]
    ref = np.asarray(jmod.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask),
                                deterministic=not train))
    sd = {}
    texport._abranch(sd, "b", jax.tree_util.tree_map(np.asarray, params), SimpleNamespace(a=a))
    mod = tlayers.ActionUpdateGRU(16, 16, out_dim, 2, out_map=a == "gru_om").train(train)
    mod.load_state_dict({k[2:]: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = mod(torch.from_numpy(x), torch.from_numpy(lens),
                  torch.Generator().manual_seed(0)).numpy()
    assert got.shape == (3, 9, out_dim)
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=TOL)


def test_action_update_gru_drops_out_between_layers_from_the_generator():
    x, lens, _ = _gru_inputs(2)
    mod = tlayers.ActionUpdateGRU(16, 16, 16, 2, dropout=0.5)
    tlayers.init_parameters(mod, torch.Generator().manual_seed(0))
    args = (torch.from_numpy(x), torch.from_numpy(lens))
    with torch.no_grad():
        ev = mod.eval()(*args)
        a = mod.train()(*args, torch.Generator().manual_seed(1))
        b = mod(*args, torch.Generator().manual_seed(1))
        c = mod(*args, torch.Generator().manual_seed(2))
        with pytest.raises(ValueError, match="generator"):
            mod(*args)
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, ev)
    with pytest.raises(ValueError, match="a_dim == hid_dim"):
        tlayers.ActionUpdateGRU(16, 16, 32, 1)


# ------------------------------------------------------------------ decode
def _decode_inputs(seed, ties=False):
    rng = np.random.default_rng(seed)
    B, T, S, C = 3, 40, 7, 11
    transcript = rng.integers(0, C, (B, S)).astype(np.int32)
    nseg = np.array([7, 4, 1])
    seg_mask = np.arange(S)[None] < nseg[:, None]
    a2f = rng.standard_normal((B, T, S)).astype(np.float32)
    a2f = np.exp(a2f) / np.exp(a2f).sum(-1, keepdims=True)
    clogit = rng.standard_normal((B, T, C)).astype(np.float32)
    if ties:  # whole columns and classes equal: the first of a tie wins
        a2f = np.round(a2f * 4) / 4
        a2f[:, :, 2] = a2f[:, :, 1]
        clogit = np.round(clogit)
        transcript[:, 3] = transcript[:, 0]
    return transcript, seg_mask, a2f.astype(np.float32), clogit.astype(np.float32)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("weight", [0.0, 0.3, 1.0])
def test_decode_with_transcript_equals_jaxs(ties, weight):
    args = _decode_inputs(int(weight * 10) + ties, ties)
    ref = np.asarray(jdecode.decode_with_transcript(*map(jnp.asarray, args), weight))
    got = tdecode.decode_with_transcript(*map(torch.from_numpy, args), weight)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), ref)
    tr, sm = args[0], args[1]
    assert all(set(got[b].tolist()) <= set(tr[b][sm[b]].tolist()) for b in range(3))


@pytest.mark.parametrize("ties", [False, True])
def test_decode_transcript_attn_only_equals_jaxs(ties):
    tr, sm, a2f, _ = _decode_inputs(5, ties)
    ref = np.asarray(jdecode.decode_transcript_attn_only(*map(jnp.asarray, (tr, sm, a2f))))
    got = tdecode.decode_transcript_attn_only(*map(torch.from_numpy, (tr, sm, a2f)))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_seq_matching_is_jaxs_identity():
    rng = np.random.default_rng(0)
    b = {k: np.asarray(v) for k, v in _make_batch(rng, 2, 50, 4, 5, 9).items()}
    cprob = rng.uniform(size=(2, 9, 6)).astype(np.float32)
    a2f = rng.uniform(size=(2, 50, 9)).astype(np.float32)
    keys = ("transcript", "seg_label", "seg_mask", "mask")
    loss_cfg = dict(gtea_transcript_cfg()["Loss"])
    ref = jm.match(SimpleNamespace(**loss_cfg), jnp.asarray(cprob), jnp.asarray(a2f),
                   *[jnp.asarray(b[k]) for k in keys])
    got = tm.match(loss_cfg, torch.from_numpy(cprob), torch.from_numpy(a2f),
                   *[torch.from_numpy(b[k]) for k in keys])
    assert loss_cfg["match"] == "seq" and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got.numpy(), np.tile(np.arange(9), (2, 1)))


# ------------------------------------------------------------------ losses
B_L, T_L, C_L, S_L, S_PRED = 2, 60, 5, 8, 10


@pytest.fixture(scope="module")
def loss_case():
    """Saves shaped like a transcript model's: M = S tokens, the padded
    tokens' logits as unmasked as a model leaves them."""
    rng = np.random.default_rng(1)
    batch = {k: np.array(v) for k, v in _make_batch(rng, B_L, T_L, 4, C_L, S_L).items()}
    mask = batch["mask"]
    r = lambda *s: (rng.standard_normal(s) * 2).astype(np.float32)  # noqa: E731
    f2a = r(B_L, S_L, T_L)
    f2a[np.broadcast_to(~mask[:, None, :], f2a.shape)] = -1e9
    seg_id = np.minimum(np.arange(T_L) // 7, S_PRED - 1)
    P = (np.eye(S_PRED, dtype=np.float32)[seg_id][None] * mask[..., None]).astype(np.float32)
    seg_valid = P.sum(axis=1) > 0
    f2a_seg = r(B_L, S_L, S_PRED)
    f2a_seg[np.broadcast_to(~seg_valid[:, None, :], f2a_seg.shape)] = -1e9
    saves = {
        "i": {"frame_clogit": r(B_L, T_L, C_L), "action_clogit": r(B_L, S_L, C_L + 1),
              "kind": "i"},
        "u": {"frame_clogit": r(B_L, T_L, C_L), "action_clogit": r(B_L, S_L, C_L + 1),
              "kind": "u", "f2a_attn_logit": f2a, "a2f_attn_logit": r(B_L, T_L, S_L)},
        "U": {"frame_clogit": r(B_L, T_L, C_L), "action_clogit": r(B_L, S_L, C_L + 1),
              "kind": "U", "seg_clogit": r(B_L, S_PRED, C_L), "tdu_P": P,
              "tdu_seg_valid": seg_valid, "f2a_attn_logit": f2a_seg,
              "a2f_attn_logit": r(B_L, S_PRED, S_L)},
    }
    assert not batch["seg_mask"].all()  # padded tokens
    cweight = rng.uniform(0.2, 1.5, C_L + 1).astype(np.float32)
    return dict(batch=batch, saves=saves, cweight=cweight,
                seg2tok=np.tile(np.arange(S_L, dtype=np.int32), (B_L, 1)))


def _close(port, ref, err_msg=""):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), atol=TOL, rtol=TOL,
                               err_msg=err_msg)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_column_masked_smoothing_matches_jax(loss_case, use_kernel):
    """With a column mask ``smooth_loss_opt`` stays plain on both sides (JAX
    keeps it off its kernel); without one the port's goes through K5."""
    b, s = loss_case["batch"], loss_case["saves"]["u"]
    x, fm, cm = s["a2f_attn_logit"], b["mask"], b["seg_mask"]
    for col in (cm, None):
        ref = jl.smooth_loss_opt(jnp.asarray(x), jnp.asarray(fm),
                                 None if col is None else jnp.asarray(col), use_pallas=False)
        got = tl.smooth_loss_opt(torch.from_numpy(x), torch.from_numpy(fm),
                                 None if col is None else torch.from_numpy(col),
                                 use_kernel=use_kernel)
        _close(got, ref)
    pair = fm[:, 1:] & fm[:, :-1]
    _close(tl.smooth_loss(*map(torch.from_numpy, (x, pair, cm))),
           jl.smooth_loss(*map(jnp.asarray, (x, pair)), col_mask=jnp.asarray(cm)))


def _loss_vjp(case, jfn, tfn, kinds):
    keys = [(kd, k) for kd in kinds for k, v in case["saves"][kd].items()
            if isinstance(v, np.ndarray) and v.dtype == np.float32 and k != "tdu_P"]
    ref, vjp = jax.vjp(lambda *leaves: jfn(_rebuild(case, keys, leaves, jnp.asarray)),
                       *[jnp.asarray(case["saves"][kd][k]) for kd, k in keys])
    gv = np.linspace(0.5, 1.5, B_L).astype(np.float32)
    ref_grads = vjp(jnp.asarray(gv))
    leaves = [torch.from_numpy(case["saves"][kd][k]).requires_grad_(True) for kd, k in keys]
    got = tfn(_rebuild(case, keys, leaves, torch.from_numpy))
    _close(got, ref)
    for (kd, k), g, r in zip(keys, torch.autograd.grad(got, leaves, torch.from_numpy(gv)),
                             ref_grads):
        _close(g, r, err_msg=f"{kd} {k}")


def _rebuild(case, keys, leaves, to):
    out = {kd: {k: (to(v) if isinstance(v, np.ndarray) else v) for k, v in s.items()}
           for kd, s in case["saves"].items()}
    for (kd, k), leaf in zip(keys, leaves):
        out[kd][k] = leaf
    return out


def _jb(case):
    return {k: jnp.asarray(v) for k, v in case["batch"].items()}


def _tb(case):
    return {k: torch.from_numpy(v) for k, v in case["batch"].items()}


@pytest.mark.parametrize("kind", ["i", "u", "U"])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_block_loss_with_a_token_mask_and_its_gradients(loss_case, kind, use_kernel):
    c = loss_case
    jargs = (jnp.asarray(c["seg2tok"]), jnp.asarray(c["cweight"]), 5.0)
    targs = (torch.from_numpy(c["seg2tok"]), torch.from_numpy(c["cweight"]), 5.0)
    _loss_vjp(c, lambda s: jl.block_loss(s[kind], _jb(c), *jargs,
                                         token_mask=jnp.asarray(c["batch"]["seg_mask"])),
              lambda s: tl.block_loss(s[kind], _tb(c), *targs,
                                      token_mask=torch.from_numpy(c["batch"]["seg_mask"]),
                                      use_kernel=use_kernel), [kind])


def test_fact_loss_with_a_token_mask_and_its_gradients(loss_case):
    c = loss_case
    order = ["i", "u", "U"]
    jm_, tm_ = jnp.asarray(c["batch"]["seg_mask"]), torch.from_numpy(c["batch"]["seg_mask"])
    _loss_vjp(c, lambda s: jl.fact_loss([s[k] for k in order], _jb(c), jnp.asarray(c["seg2tok"]),
                                        jnp.asarray(c["cweight"]), 5.0, token_mask=jm_),
              lambda s: tl.fact_loss([s[k] for k in order], _tb(c), torch.from_numpy(c["seg2tok"]),
                                     torch.from_numpy(c["cweight"]), 5.0, token_mask=tm_,
                                     use_kernel=True), order)
    # the mask matters: the unmasked 'u' loss differs
    s = _rebuild(c, [], [], torch.from_numpy)["u"]
    assert not torch.allclose(
        tl.block_loss(s, _tb(c), *(torch.from_numpy(c["seg2tok"]),
                                   torch.from_numpy(c["cweight"]), 5.0)),
        tl.block_loss(s, _tb(c), torch.from_numpy(c["seg2tok"]), torch.from_numpy(c["cweight"]),
                      5.0, token_mask=tm_))


# ------------------------------------------------------------ narrow model
D, C, S_CAP, B, T, S = 12, 11, 24, 2, 96, 9
_NARROW = dict(hid_dim=32, a_dim=16, a_ffdim=32, a_layers=2, a_nhead=4, f_dim=24, f_layers=3,
               f_ln=False, dropout=0.0)


def _narrow(a: str = "sca"):
    """gtea_transcript.yaml narrowed the same way in the JAX and the port tree
    (no masking or dropout, nullw fixed: its -1 resolves to 0 here)."""
    jcfg = jax_setup_cfg([os.path.join(CONFIGS, "gtea_transcript.yaml")], [])
    cfg = gtea_transcript_cfg()
    for k, v in dict(_NARROW, a=a).items():
        setattr(jcfg.Bi, k, v)
    cfg["Bi"].update(_NARROW, a=a)
    jcfg.Bu.f_layers = jcfg.BU.f_layers = 2
    cfg["Bu"]["f_layers"] = cfg["BU"]["f_layers"] = 2
    jcfg.FACT.cmr = cfg["FACT"]["cmr"] = 0.0
    jcfg.TM.use = cfg["TM"]["use"] = False
    jcfg.Loss.nullw = cfg["Loss"]["nullw"] = 0.1
    jcfg.lr = cfg["lr"] = 0.002
    return jcfg, cfg


def _batch(seed=0):
    b = {k: np.asarray(v) for k, v in _make_batch(np.random.default_rng(seed), B, T, D, C,
                                                   S).items()}
    assert not b["seg_mask"].all()
    return b


def _jargs(b):
    return dict(transcript=jnp.asarray(b["transcript"]), seg_mask=jnp.asarray(b["seg_mask"]))


class _Capture:
    """A stand-in TrainState: keeps the gradients ``apply_gradients`` is given."""

    def __init__(self, params):
        self.params = params

    def apply_gradients(self, grads):
        self.grads = grads
        return self


def _jax_steps(jmodel, jcfg, params, batch, nclasses, verbnoun=False):
    cweight = jl.build_class_weights(jcfg, nclasses, [0])
    train_step, eval_step = make_step_fns(jmodel, jcfg, nclasses, cweight, verbnoun=verbnoun)

    @jax.jit
    def step(params, batch):
        st, o = train_step.unjitted(_Capture(params), batch, jax.random.PRNGKey(0))
        return st.grads, o

    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    grads, o = step(params, jb)
    return dict(cweight=cweight, grads=jax.tree_util.tree_map(np.asarray, grads),
                out={k: np.asarray(v) for k, v in o.items()},
                pred=np.asarray(eval_step(params, jb)))


@pytest.fixture(scope="module", params=["sca", "gru_om"])
def trans_run(request):
    """The JAX model, its init (from a port model's weights through JAX's
    importer), forward saves, train step and eval step."""
    a = request.param
    jcfg, cfg = _narrow(a)
    batch = _batch()
    jmodel = jblocks.build_fact(jcfg, D, C, S_CAP)
    port = build_fact(cfg, D, C, S_CAP, device="cpu", generator=torch.Generator().manual_seed(4))
    params = convert_fact_state_dict({k: v.numpy() for k, v in port.state_dict().items()},
                                     jblocks.resolve_block_cfgs(jcfg), trans=True)
    params = jax.tree_util.tree_map(np.asarray, params)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    saves, _ = jmodel.apply({"params": params}, jb["feats"], jb["mask"], jb["lengths"],
                            train=False, **_jargs(batch))
    return dict(a=a, jcfg=jcfg, cfg=cfg, batch=batch, params=params, port_sd=port.state_dict(),
                saves=[{k: np.asarray(v) for k, v in s.items() if k != "kind"} for s in saves],
                **_jax_steps(jmodel, jcfg, params, batch, C))


def _port_model(run, kernels):
    model = build_fact(run["cfg"], D, C, S_CAP, device="cpu")
    load_jax_params(model, run["params"])
    model.set_kernels(kernels)
    return model


def test_transcript_exporter_equals_the_jax_packages(trans_run):
    run = trans_run
    ref = jax_export(run["params"], jblocks.resolve_block_cfgs(run["jcfg"]), trans=True)
    got = texport.export_fact_state_dict(run["params"], resolve_block_cfgs(run["cfg"]))
    assert "action_embed.weight" in ref and "action_query" not in ref
    assert set(got) == set(ref) == set(run["port_sd"])
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
        np.testing.assert_array_equal(run["port_sd"][k].numpy(), v, err_msg=k)  # the round trip
    if run["a"] == "gru_om":
        assert {"block_list.0.action_branch.out_map.weight",
                "block_list.0.action_branch.layernorm.bias",
                "block_list.0.action_branch.gru.weight_hh_l1_reverse"} <= set(ref)


@pytest.mark.parametrize("kernels", [True, False])
def test_transcript_fact_matches_jax_block_by_block(trans_run, kernels):
    run = trans_run
    model = _port_model(run, kernels)
    x = batch_to_device(run["batch"], "cpu")
    with torch.no_grad():
        saves, _ = model(x["feats"], x["mask"], x["lengths"], transcript=x["transcript"],
                         seg_mask=x["seg_mask"])
    mask = run["batch"]["mask"]
    assert [s["kind"] for s in saves] == ["i", "u", "U"]
    for i, (sp, sj) in enumerate(zip(saves, run["saves"])):
        for key in ("frame_clogit", "action_clogit", "a2f_attn", "f2a_attn", "seg_clogit"):
            if key not in sj:
                continue
            got, ref = sp[key].numpy(), sj[key]
            assert got.shape == ref.shape, (i, key)
            if key in ("frame_clogit", "a2f_attn"):
                got, ref = got[mask], ref[mask]
            elif key == "f2a_attn":
                got, ref = got.transpose(0, 2, 1)[mask], ref.transpose(0, 2, 1)[mask]
            elif key == "seg_clogit":
                got, ref = got[sj["tdu_seg_valid"]], ref[sj["tdu_seg_valid"]]
            np.testing.assert_allclose(got, ref, atol=ATOL, err_msg=f"block {i} {key}")
    assert saves[0]["action_clogit"].shape[1] == S  # a token per transcript slot


def _check_grads(model, grads, ref_tree):
    names = [n for n, _ in model.named_parameters()]
    ref = grads_from_jax(ref_tree, model.block_cfgs)
    assert set(names) == set(ref)
    scale = max(float(np.abs(v.numpy()).max()) for v in ref.values())
    for n, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), ref[n].numpy(), atol=1e-4 * max(1.0, scale),
                                   rtol=1e-3, err_msg=n)
    assert float(dict(zip(names, grads))["action_embed.weight"].abs().max()) > 0


@pytest.mark.parametrize("kernels", [True, False])
def test_transcript_train_step_matches_jax(trans_run, kernels):
    run = trans_run
    model = _port_model(run, kernels)
    step = make_train_step(model, run["cfg"], C, run["cweight"])
    ref = run["out"]
    x = batch_to_device(run["batch"], "cpu")
    per_video, seg2tok, _ = step.loss(x, torch.Generator().manual_seed(0))
    np.testing.assert_allclose(per_video.detach().numpy(), ref["per_video_loss"], rtol=1e-4)
    np.testing.assert_array_equal(seg2tok.numpy(), np.tile(np.arange(S), (B, 1)))
    loss = per_video.mean()
    _check_grads(model, torch.autograd.grad(loss, list(model.parameters())), run["grads"])
    out = step(x, torch.Generator().manual_seed(0))
    np.testing.assert_allclose(float(out["loss"]), float(ref["loss"]), rtol=1e-4)
    mask = run["batch"]["mask"]
    np.testing.assert_array_equal(out["pred"].numpy()[mask], ref["pred"][mask])


def test_transcript_eval_step_and_predictor_match_jax(trans_run):
    run = trans_run
    model = _port_model(run, True)
    x = batch_to_device(run["batch"], "cpu")
    pred = make_eval_step(model, run["cfg"]["FACT"]["mwt"])(
        x["feats"], x["mask"], x["lengths"], x["transcript"], x["seg_mask"])
    mask = run["batch"]["mask"]
    np.testing.assert_array_equal(pred.numpy()[mask], run["pred"][mask])
    b = run["batch"]
    feats = [b["feats"][i, :n] for i, n in enumerate(b["lengths"])]
    trans = [b["transcript"][i][b["seg_mask"][i]] for i in range(B)]
    got = Predictor(model, run["cfg"]["FACT"]["mwt"], batch_size=2, max_len=128,
                    seg_cap=S).predict(feats, transcripts=trans)
    for i, g in enumerate(got):
        assert g.dtype == np.int32 and g.shape == (b["lengths"][i],)
        np.testing.assert_array_equal(g, run["pred"][i, :b["lengths"][i]])


def test_a_port_checkpoint_reads_into_the_jax_transcript_model(trans_run):
    """The port's state_dict after a train step, read by JAX's importer with
    ``trans=True``: JAX's forward equals the port's."""
    run = trans_run
    model = _port_model(run, True)
    x = batch_to_device(run["batch"], "cpu")
    make_train_step(model, run["cfg"], C, run["cweight"])(x, torch.Generator().manual_seed(0))
    params = convert_fact_state_dict({k: v.numpy() for k, v in model.state_dict().items()},
                                     jblocks.resolve_block_cfgs(run["jcfg"]), trans=True)
    jb = {k: jnp.asarray(v) for k, v in run["batch"].items()}
    jsaves, _ = jblocks.build_fact(run["jcfg"], D, C, S_CAP).apply(
        {"params": params}, jb["feats"], jb["mask"], jb["lengths"], train=False,
        **_jargs(run["batch"]))
    with torch.no_grad():
        saves, _ = model(x["feats"], x["mask"], x["lengths"], transcript=x["transcript"],
                         seg_mask=x["seg_mask"])
    mask = run["batch"]["mask"]
    for i, (sp, sj) in enumerate(zip(saves, jsaves)):
        np.testing.assert_allclose(sp["frame_clogit"].numpy()[mask],
                                   np.asarray(sj["frame_clogit"])[mask], atol=ATOL)
        np.testing.assert_allclose(sp["action_clogit"].numpy(), np.asarray(sj["action_clogit"]),
                                   atol=ATOL)


def test_a_gru_branch_as_wide_as_the_stream():
    """``a: gru`` (no out map) needs a_dim == hid_dim: the narrow model at
    a_dim 32, against JAX block by block."""
    jcfg, cfg = _narrow("gru")
    for c in (jcfg.Bi, jcfg.Bu, jcfg.BU):
        c.a_dim = 32
    cfg["Bi"]["a_dim"] = cfg["Bu"]["a_dim"] = cfg["BU"]["a_dim"] = 32
    batch = _batch(3)
    port = build_fact(cfg, D, C, S_CAP, device="cpu")
    assert "block_list.0.action_branch.out_map.weight" not in port.state_dict()
    params = convert_fact_state_dict({k: v.numpy() for k, v in port.state_dict().items()},
                                     jblocks.resolve_block_cfgs(jcfg), trans=True)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jsaves, _ = jblocks.build_fact(jcfg, D, C, S_CAP).apply(
        {"params": params}, jb["feats"], jb["mask"], jb["lengths"], train=False,
        **_jargs(batch))
    x = batch_to_device(batch, "cpu")
    with torch.no_grad():
        saves, _ = port(x["feats"], x["mask"], x["lengths"], transcript=x["transcript"],
                        seg_mask=x["seg_mask"])
    for sp, sj in zip(saves, jsaves):
        np.testing.assert_allclose(sp["action_clogit"].numpy(), np.asarray(sj["action_clogit"]),
                                   atol=ATOL)


def test_transcript_mode_refusals(trans_run):
    run = trans_run
    model = _port_model(run, True)
    b = run["batch"]
    feats = [b["feats"][0, :50]]
    with pytest.raises(ValueError, match="seg_cap"):
        Predictor(model, 0.0)
    pred = Predictor(model, 0.0, max_len=128, seg_cap=4)
    with pytest.raises(ValueError, match="exactly when"):
        pred.predict(feats)
    with pytest.raises(ValueError, match="seg_cap = 4"):
        pred.predict(feats, transcripts=[np.arange(5)])
    x = batch_to_device(b, "cpu")
    with pytest.raises(ValueError, match="transcript="):
        model(x["feats"], x["mask"], x["lengths"])
    _, plain_cfg = _narrow()
    plain_cfg["FACT"].update(trans=False, ntoken=6)
    plain = build_fact(plain_cfg, D, C, S_CAP, device="cpu")
    with pytest.raises(ValueError, match="exactly when"):
        Predictor(plain, 0.0, max_len=128).predict(feats, transcripts=[np.arange(3)])
    with pytest.raises(ValueError, match="FACT.trans"):
        make_train_step(plain, run["cfg"], C, run["cweight"])


# ------------------------------------------------------- verb/noun model
N1, N2, N_ACT, VD, VS_CAP, VT = 13, 29, 97, 32, 64, 200
_VN_NARROW = dict(hid_dim=64, a_dim=16, a_ffdim=32, a_layers=2, a_nhead=4, f="m2", f_dim=24,
                  f_layers=3, f_ln=False, f_ngp=1, dropout=0.0)


def _vn_cfgs():
    """epic-kitchens.yaml narrowed, in transcript mode (``FACT.trans``,
    ``ntoken`` 0, ``seq`` matching)."""
    jcfg = jax_setup_cfg([os.path.join(CONFIGS, "epic-kitchens.yaml")], [])
    cfg = epic_cfg()
    for k, v in _VN_NARROW.items():
        setattr(jcfg.Bi, k, v)
    cfg["Bi"].update(_VN_NARROW)
    for node in (jcfg.Bu, jcfg.BU):
        node.a_nhead, node.f_layers = 4, 2
    for node in ("Bu", "BU"):
        cfg[node].update(a_nhead=4, f_layers=2)
    jcfg.FACT.trans, jcfg.FACT.ntoken, jcfg.Loss.match, jcfg.FACT.cmr = True, 0, "seq", 0.0
    cfg["FACT"].update(trans=True, ntoken=0, cmr=0.0)
    cfg["Loss"]["match"] = "seq"
    return jcfg, cfg


def _vn_batch(seed=0):
    """Two videos of epic's kind: 6 segments over a pool of 5 actions (one
    repeats), the transcript padded to 12."""
    from fact_clip_tpu_torch.engine.train_loop import epic_batch

    return epic_batch(np.random.default_rng(seed), VD, N_ACT, VT, [VT, 137], n_seg=6, S=12,
                      pool=5)


@pytest.fixture(scope="module")
def vn_run():
    jcfg, cfg = _vn_cfgs()
    vids, nids = epic_vocab(N1, N2, N_ACT, seed=1)
    batch = _vn_batch()
    jmodel = jvn.build_verbnoun_fact(jcfg, VD, vids, nids, VS_CAP, n_classes1=N1, n_classes2=N2)
    port = tvn.build_verbnoun_fact(cfg, VD, vids, nids, VS_CAP, N1, N2, device="cpu",
                                   generator=torch.Generator().manual_seed(5))
    assert {"verb_embed.weight", "noun_embed.weight"} <= set(port.state_dict())
    params = convert_verbnoun_state_dict({k: v.numpy() for k, v in port.state_dict().items()},
                                         jblocks.resolve_block_cfgs(jcfg), trans=True)
    params = jax.tree_util.tree_map(np.asarray, params)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    saves, _ = jmodel.apply({"params": params}, jb["feats"], jb["mask"], jb["lengths"],
                            train=False, **_jargs(batch))
    return dict(jcfg=jcfg, cfg=cfg, vids=vids, nids=nids, batch=batch, params=params,
                port_sd=port.state_dict(),
                saves=[{k: np.asarray(v) for k, v in s.items() if k != "kind"} for s in saves],
                **_jax_steps(jmodel, jcfg, params, batch, N_ACT, verbnoun=True))


def _vn_port(run, kernels):
    model = tvn.build_verbnoun_fact(run["cfg"], VD, run["vids"], run["nids"], VS_CAP, N1, N2,
                                    device="cpu")
    load_jax_params(model, run["params"])
    model.set_kernels(kernels)
    return model


def test_verbnoun_transcript_exporter_equals_the_jax_packages(vn_run):
    ref = jax_export_vn(vn_run["params"], jblocks.resolve_block_cfgs(vn_run["jcfg"]), trans=True)
    got = texport.export_verbnoun_state_dict(vn_run["params"], resolve_block_cfgs(vn_run["cfg"]))
    assert {"verb_embed.weight", "noun_embed.weight"} <= set(ref)
    assert set(got) == set(ref) == set(vn_run["port_sd"])
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
        np.testing.assert_array_equal(vn_run["port_sd"][k].numpy(), v, err_msg=k)


@pytest.mark.parametrize("kernels", [True, False])
def test_verbnoun_transcript_matches_jax(vn_run, kernels):
    """Block by block, the transcript decode (the attention's argmax over the
    transcript) and one train step: loss and every gradient."""
    run = vn_run
    model = _vn_port(run, kernels)
    x = batch_to_device(run["batch"], "cpu")
    kw = dict(transcript=x["transcript"], seg_mask=x["seg_mask"])
    with torch.no_grad():
        saves, _ = model(x["feats"], x["mask"], x["lengths"], **kw)
    mask = run["batch"]["mask"]
    for i, (sp, sj) in enumerate(zip(saves, run["saves"])):
        np.testing.assert_array_equal(sp["tdu_P"].numpy(), sj["tdu_P"], err_msg=f"block {i}")
        for key in ("frame_vlogp", "action_logp", "a2f_attn"):
            if key not in sj:
                continue
            got, ref = sp[key].numpy(), sj[key]
            if key != "action_logp":
                got, ref = got[mask], ref[mask]
            np.testing.assert_allclose(got, ref, atol=ATOL, err_msg=f"block {i} {key}")
    pred = make_eval_step(model, 0.1)(x["feats"], x["mask"], x["lengths"], **kw)
    np.testing.assert_array_equal(pred.numpy()[mask], run["pred"][mask])

    step = make_train_step(model, run["cfg"], N_ACT, run["cweight"])
    per_video, seg2tok, _ = step.loss(x, torch.Generator().manual_seed(0))
    np.testing.assert_allclose(per_video.detach().numpy(), run["out"]["per_video_loss"],
                               rtol=1e-4)
    np.testing.assert_array_equal(seg2tok.numpy(), np.tile(np.arange(12), (2, 1)))
    grads = torch.autograd.grad(per_video.mean(), list(model.parameters()))
    names = [n for n, _ in model.named_parameters()]
    ref = grads_from_jax(run["grads"], model.block_cfgs, verbnoun=True)
    scale = max(float(np.abs(v.numpy()).max()) for v in ref.values())
    for n, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), ref[n].numpy(), atol=1e-4 * max(1.0, scale),
                                   rtol=1e-3, err_msg=n)
    out = step(x, torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(out["pred"].numpy()[mask], run["out"]["pred"][mask])


def test_verbnoun_port_checkpoint_reads_into_jax(vn_run):
    run = vn_run
    model = _vn_port(run, True)
    x = batch_to_device(run["batch"], "cpu")
    make_train_step(model, run["cfg"], N_ACT, run["cweight"])(x, torch.Generator().manual_seed(0))
    params = convert_verbnoun_state_dict({k: v.numpy() for k, v in model.state_dict().items()},
                                         jblocks.resolve_block_cfgs(run["jcfg"]), trans=True)
    jmodel = jvn.build_verbnoun_fact(run["jcfg"], VD, run["vids"], run["nids"], VS_CAP,
                                     n_classes1=N1, n_classes2=N2)
    jb = {k: jnp.asarray(v) for k, v in run["batch"].items()}
    jsaves, _ = jmodel.apply({"params": params}, jb["feats"], jb["mask"], jb["lengths"],
                             train=False, **_jargs(run["batch"]))
    with torch.no_grad():
        saves, _ = model(x["feats"], x["mask"], x["lengths"], transcript=x["transcript"],
                         seg_mask=x["seg_mask"])
    np.testing.assert_allclose(saves[-1]["action_logp"].numpy(),
                               np.asarray(jsaves[-1]["action_logp"]), atol=ATOL)


# ------------------------------------------------------------------- guard
def test_the_transcript_modules_import_no_jax():
    code = """
import sys
import fact_clip_tpu_torch.models.blocks, fact_clip_tpu_torch.models.verbnoun  # noqa
import fact_clip_tpu_torch.models.layers, fact_clip_tpu_torch.models.decode  # noqa
import fact_clip_tpu_torch.models.matching, fact_clip_tpu_torch.models.losses  # noqa
import fact_clip_tpu_torch.engine.steps, fact_clip_tpu_torch.engine.serve  # noqa
import fact_clip_tpu_torch.engine.setup, fact_clip_tpu_torch.engine.train_loop  # noqa
import fact_clip_tpu_torch.utils.torch_export, fact_clip_tpu_torch.utils.bridge  # noqa
import fact_clip_tpu_torch.data.synthetic, fact_clip_tpu_torch.configs  # noqa
import fact_clip_tpu_torch.train, fact_clip_tpu_torch.run_eval  # noqa
bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'fact_clip_tpu', 'yaml')]
assert not bad, bad
print('GUARD_OK')
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=dict(os.environ, PYTHONPATH=REPO), timeout=120)
    assert proc.returncode == 0 and "GUARD_OK" in proc.stdout, proc.stderr[-2000:]
