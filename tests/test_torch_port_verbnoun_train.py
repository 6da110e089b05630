"""Training the Epic-Kitchens verb/noun model in the port, against the JAX
package on the CPU.

* o2m matching: ``models/matching.py::o2m_host`` equals JAX's ``_o2m_host``
  on seeded costs where classes repeat inside a video and tokens outnumber
  classes, and ``match`` with ``match: o2m`` equals JAX's
  ``match(..., matcher="host")``; the assignment must be equal.
* The verb/noun losses (``verbnoun_action_token_loss``,
  ``composed_smooth_loss``, ``verbnoun_block_loss`` of kinds ``I`` and ``U``,
  ``verbnoun_fact_loss``) on seeded saves shaped like a model's, and their
  gradients with respect to every float save: rtol 1e-5 (atol 1e-6; float32
  on both sides, sums in another order).
* One train step of the narrow ``IUUU`` of
  ``tests/test_torch_port_verbnoun.py::_cfgs`` (``f: m2`` and ``f: m``)
  with channel masking off, on the kernel entries (their plain versions on
  CPU tensors) and on the plain path: the port's ``TrainStep`` against the
  loss function of JAX's ``make_step_fns(..., verbnoun=True)`` train step
  (``engine/steps.py:131-135``: train-mode forward, o2m on exp(action_logp),
  ``verbnoun_fact_loss``, the composed decode) and ``jax.value_and_grad``:
  per-video loss rtol 1e-4, ``seg2tok`` and the decode equal, every
  parameter's gradient at ``tests/test_torch_port_train.py``'s tolerance,
  and the Adam-updated parameters against optax on JAX's gradients.
* ``epic_train_cfg()`` is ``epic_cfg()`` with the host matcher; the epic
  batch maker repeats actions inside a video.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_verbnoun import D, N1, N2, N_ACT, S_CAP, _cfgs

from fact_clip_tpu.engine import state as jstate
from fact_clip_tpu.models import blocks as jblocks
from fact_clip_tpu.models import losses as jl
from fact_clip_tpu.models import matching as jm
from fact_clip_tpu.models import verbnoun as jvn
from fact_clip_tpu.ops import verbnoun_compose as jvc
from fact_clip_tpu.utils.torch_export import export_verbnoun_state_dict
from fact_clip_tpu.utils.torch_import import convert_verbnoun_state_dict
from fact_clip_tpu_torch.configs import epic_cfg, epic_train_cfg, epic_vocab
from fact_clip_tpu_torch.engine.steps import make_train_step
from fact_clip_tpu_torch.engine.train_loop import batch_to_device, epic_batch
from fact_clip_tpu_torch.models import losses as tl
from fact_clip_tpu_torch.models import matching as tm
from fact_clip_tpu_torch.models import verbnoun as pvn
from fact_clip_tpu_torch.ops import verbnoun_compose as pvc
from fact_clip_tpu_torch.utils.bridge import grads_from_jax, load_jax_params

torch.set_num_threads(2)
RTOL, ATOL = 1e-5, 1e-6
B, T, M, S_GT, S_PRED = 2, 60, 7, 10, 9
LENGTHS = [60, 41]
FLOAT_SAVES = ("frame_vlogp", "frame_nlogp", "seg_logp", "action_logp", "f2a_attn_logit",
               "a2f_attn_logit")


def _close(port, ref, err_msg=""):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL,
                               err_msg=err_msg)


def _repeating_costs(rng, Bc, Mc, S, n_cls, nsegs):
    """Costs (Bc, Mc, S) and transcripts whose n_cls classes repeat."""
    cost = rng.standard_normal((Bc, Mc, S)).astype(np.float32)
    trans = rng.integers(0, 50, (Bc, n_cls))[np.arange(Bc)[:, None],
                                             rng.integers(0, n_cls, (Bc, S))].astype(np.int32)
    return cost, trans, np.asarray(nsegs, np.int32)


@pytest.mark.parametrize("Mc,S,n_cls,nsegs", [(8, 12, 4, [12, 7, 0]), (30, 16, 6, [16, 16, 5])])
def test_o2m_host_equals_jax(Mc, S, n_cls, nsegs):
    cost, trans, ns = _repeating_costs(np.random.default_rng(Mc), 3, Mc, S, n_cls, nsegs)
    got = tm.o2m_host(cost, trans, ns)
    ref = jm._o2m_host(cost, trans, ns)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, ref)
    if Mc < ns[0]:  # more segments than tokens: a token serves several segments of its class
        assert len(np.unique(got[0, :ns[0]])) < ns[0]


def _loss_case():
    rng = np.random.default_rng(7)
    vids, nids = epic_vocab(N1, N2, N_ACT, seed=1)
    batch = epic_batch(rng, 4, N_ACT, T, LENGTHS, n_seg=8, S=S_GT, pool=4)
    mask = batch["mask"]
    r = lambda *s: torch.from_numpy((rng.standard_normal(s) * 2).astype(np.float32))  # noqa: E731
    vt, nt = torch.from_numpy(vids), torch.from_numpy(nids)
    seg_id = np.minimum(np.arange(T) // 7, S_PRED - 1)
    P = (np.eye(S_PRED, dtype=np.float32)[seg_id][None] * mask[..., None]).astype(np.float32)
    seg_valid = P.sum(axis=1) > 0
    f2a = r(B, M, S_PRED).numpy()
    f2a[np.broadcast_to(~seg_valid[:, None, :], f2a.shape)] = -1e9
    saves = {"frame_vlogp": torch.log_softmax(r(B, T, N1), -1).numpy(),
             "frame_nlogp": torch.log_softmax(r(B, T, N2), -1).numpy(),
             "seg_logp": pvn.combine_verb_noun(r(B, S_PRED, N1 + N2), vt, nt, N1).numpy(),
             "action_logp": pvn.combine_verb_noun(r(B, M, N1 + N2 + 2), vt, nt, N1,
                                                  action=True).numpy(),
             "f2a_attn_logit": f2a, "a2f_attn_logit": r(B, S_PRED, M).numpy(),
             "tdu_P": P, "tdu_seg_valid": seg_valid}
    cost = rng.standard_normal((B, M, S_GT)).astype(np.float32)
    seg2tok = jm._o2m_host(cost, batch["transcript"], batch["seg_mask"].sum(1))
    cweight = rng.uniform(0.2, 1.5, N_ACT + 1).astype(np.float32)
    w = rng.uniform(0.5, 2.0, B).astype(np.float32)  # cotangent of the per-video loss
    return dict(vids=vids, nids=nids, batch=batch, saves=saves, seg2tok=seg2tok,
                cweight=cweight, w=w)


@pytest.fixture(scope="module")
def case():
    return _loss_case()


def _both(case, fn_jax, fn_port, kind="U"):
    """(port value, port grads, JAX value, JAX grads) of a per-video loss of
    the float saves, the gradients those of sum(w * loss)."""
    saves = case["saves"]
    jf = {k: jnp.asarray(saves[k]) for k in FLOAT_SAVES}
    jrest = {k: jnp.asarray(v) for k, v in saves.items() if k not in FLOAT_SAVES}
    jrest["kind"] = kind
    w = case["w"]

    def f(fs):
        v = fn_jax({**fs, **jrest})
        return (v * w).sum(), v

    (_, ref), gref = jax.jit(jax.value_and_grad(f, has_aux=True))(jf)
    leaves = {k: torch.from_numpy(saves[k]).requires_grad_(True) for k in FLOAT_SAVES}
    rest = {k: torch.from_numpy(v) for k, v in saves.items() if k not in FLOAT_SAVES}
    got = fn_port({**leaves, **rest, "kind": kind})
    grads = torch.autograd.grad((got * torch.from_numpy(w)).sum(), list(leaves.values()),
                                allow_unused=True)
    return got, dict(zip(FLOAT_SAVES, grads)), np.asarray(ref), gref


def _check(got, grads, ref, gref):
    _close(got, ref, "loss")
    for k in FLOAT_SAVES:
        g = grads[k] if grads[k] is not None else torch.zeros(gref[k].shape)
        _close(g, gref[k], f"d {k}")


def test_action_token_loss_and_its_gradient(case):
    args = lambda s, mod: (case["seg2tok"], case["batch"]["transcript"],  # noqa: E731
                           case["batch"]["seg_mask"], case["cweight"])
    jargs = [jnp.asarray(a) for a in args(None, None)]
    targs = [torch.from_numpy(np.asarray(a)) for a in args(None, None)]
    _check(*_both(case, lambda s: jl.verbnoun_action_token_loss(s["action_logp"], *jargs),
                  lambda s: tl.verbnoun_action_token_loss(s["action_logp"], *targs)))


def test_composed_smooth_loss_and_its_gradient(case):
    m = case["batch"]["mask"]
    pm = m[:, 1:] & m[:, :-1]
    v, n = case["vids"], case["nids"]
    _check(*_both(case, lambda s: jvc.composed_smooth_loss(
        s["frame_vlogp"], s["frame_nlogp"], jnp.asarray(v), jnp.asarray(n), jnp.asarray(pm)),
        lambda s: pvc.composed_smooth_loss(s["frame_vlogp"], s["frame_nlogp"],
                                           torch.from_numpy(v), torch.from_numpy(n),
                                           torch.from_numpy(pm))))


def _block_fns(case, fact: bool):
    batch, sw = case["batch"], 5.0
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jv, jn = jnp.asarray(case["vids"]), jnp.asarray(case["nids"])
    tv, tn = torch.from_numpy(case["vids"]), torch.from_numpy(case["nids"])
    js, ts = jnp.asarray(case["seg2tok"]), torch.from_numpy(case["seg2tok"])
    jw, tw = jnp.asarray(case["cweight"]), torch.from_numpy(case["cweight"])
    if fact:  # an I block and a U block on the same saves
        return (lambda s: jl.verbnoun_fact_loss([dict(s, kind="I"), s], jb, js, jw, sw, jv, jn),
                lambda s: tl.verbnoun_fact_loss([dict(s, kind="I"), s], tb, ts, tw, sw, tv, tn))
    return (lambda s: jl.verbnoun_block_loss(s, jb, js, jw, sw, jv, jn),
            lambda s: tl.verbnoun_block_loss(s, tb, ts, tw, sw, tv, tn))


@pytest.mark.parametrize("kind", ["I", "U"])
def test_block_loss_and_its_gradient(case, kind):
    _check(*_both(case, *_block_fns(case, False), kind=kind))


def test_fact_loss_and_its_gradient(case):
    _check(*_both(case, *_block_fns(case, True)))


def test_match_o2m_equals_jax(case):
    """Through the cost: exp(action_logp) and softmaxed a2f attention."""
    rng = np.random.default_rng(3)
    batch = case["batch"]
    a2f = rng.standard_normal((B, T, M)).astype(np.float32)
    a2f = np.exp(a2f) / np.exp(a2f).sum(-1, keepdims=True)
    cprob = np.exp(case["saves"]["action_logp"])
    loss_cfg = epic_cfg()["Loss"]
    keys = ("transcript", "seg_label", "seg_mask", "mask")
    ref = jax.jit(lambda *a: jm.match(SimpleNamespace(**loss_cfg), *a, matcher="host",
                                      nclasses=N_ACT))(
        jnp.asarray(cprob), jnp.asarray(a2f), *[jnp.asarray(batch[k]) for k in keys])
    got = tm.match(loss_cfg, torch.from_numpy(cprob), torch.from_numpy(a2f),
                   *[torch.from_numpy(batch[k]) for k in keys])
    assert loss_cfg["match"] == "o2m" and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # seq (transcript mode): the identity, as JAX's
    seq = dict(loss_cfg, match="seq")
    ref = jm.match(SimpleNamespace(**seq), *[jnp.asarray(a) for a in (cprob, a2f)],
                   *[jnp.asarray(batch[k]) for k in keys])
    got = tm.match(seq, torch.from_numpy(cprob), torch.from_numpy(a2f),
                   *[torch.from_numpy(batch[k]) for k in keys])
    assert got.dtype == torch.int64 and got.shape == batch["transcript"].shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_epic_train_cfg_and_batches():
    cfg, ref = epic_train_cfg(), epic_cfg()
    assert cfg["TPU"].pop("matcher") == "host"
    ref["TPU"].pop("matcher")
    assert cfg == ref
    b = epic_batch(np.random.default_rng(0), 8, 3806, 3000, [3000, 1200])
    assert b["feats"].shape == (2, 3000, 8) and b["transcript"].shape == (2, 64)
    for i, n in enumerate([3000, 1200]):
        tr = b["transcript"][i, :b["seg_mask"][i].sum()]
        assert len(tr) == 40 and (tr[1:] != tr[:-1]).all() and len(np.unique(tr)) <= 12
        assert b["mask"][i].sum() == n and b["seg_label"][i, n - 1] == 39
        starts = np.flatnonzero(np.diff(b["labels"][i, :n])) + 1
        np.testing.assert_array_equal(b["labels"][i, np.r_[0, starts]], tr)


# ---------------------------------------------------------------------------
# one train step of a narrow IUUU against JAX's


@pytest.fixture(scope="module", params=["m2", "m"])
def run(request):
    f = request.param
    jcfg, cfg = _cfgs(f)
    jcfg.FACT.cmr = 0.0
    jcfg.TPU.matcher = "host"
    cfg["FACT"]["cmr"] = 0.0
    cfg["TPU"]["matcher"] = "host"
    vids, nids = epic_vocab(N1, N2, N_ACT, seed=1)
    model = jvn.build_verbnoun_fact(jcfg, D, vids, nids, S_CAP, n_classes1=N1, n_classes2=N2)
    bcfgs = jblocks.resolve_block_cfgs(jcfg)
    port = pvn.build_verbnoun_fact(cfg, D, vids, nids, S_CAP, N1, N2, device="cpu",
                                   generator=torch.Generator().manual_seed(3))
    params = convert_verbnoun_state_dict({k: v.numpy() for k, v in port.state_dict().items()},
                                         bcfgs)
    batch = epic_batch(np.random.default_rng(1), D, N_ACT, 200, [200, 137], n_seg=12, S=16,
                       pool=5)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    cweight = jl.build_class_weights(jcfg, N_ACT, [])
    jv, jn = jnp.asarray(vids), jnp.asarray(nids)

    def loss_fn(params):  # engine/steps.py:131-135 with verbnoun=True
        saves, _ = model.apply({"params": params}, jb["feats"], jb["mask"], jb["lengths"],
                               train=True, rngs={"dropout": jax.random.PRNGKey(1),
                                                 "aug": jax.random.PRNGKey(2)})
        last = saves[-1]
        seg2tok = jm.match(jcfg.Loss, jnp.exp(last["action_logp"]), last["a2f_attn"],
                           jb["transcript"], jb["seg_label"], jb["seg_mask"], jb["mask"],
                           matcher="host", nclasses=N_ACT)
        per_video = jl.verbnoun_fact_loss(saves, jb, seg2tok, jnp.asarray(cweight),
                                          float(jcfg.Loss.sw), jv, jn)
        pred = jvc.composed_decode(last["action_logp"], last["a2f_attn"], last["frame_vlogp"],
                                   last["frame_nlogp"], jv, jn, float(jcfg.FACT.mwt),
                                   jnp.ones(last["action_logp"].shape[:2], bool))
        return per_video.mean(), (per_video, seg2tok, pred)

    (_, (per_video, seg2tok, pred)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    tx = jstate.build_optimizer(jcfg, steps_per_epoch=1)

    @jax.jit
    def adam(params, grads):
        updates, _ = tx.update(grads, tx.init(params), params)
        return jax.tree_util.tree_map(lambda p, u: p + u, params, updates)

    after = adam(params, grads)
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return dict(cfg=cfg, bcfgs=bcfgs, vids=vids, nids=nids, params=tree(params), batch=batch,
                cweight=cweight, grads=tree(grads), per_video=np.asarray(per_video),
                seg2tok=np.asarray(seg2tok), pred=np.asarray(pred),
                after=export_verbnoun_state_dict(after, bcfgs))


@pytest.mark.parametrize("kernels", [True, False])
def test_train_step_matches_jax(run, kernels):
    model = pvn.build_verbnoun_fact(run["cfg"], D, run["vids"], run["nids"], S_CAP, N1, N2,
                                    device="cpu")
    load_jax_params(model, run["params"])
    model.set_kernels(kernels)
    step = make_train_step(model, run["cfg"], N_ACT, run["cweight"])
    batch = batch_to_device(run["batch"], "cpu")
    per_video, seg2tok, _ = step.loss(batch, torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(seg2tok.numpy(), run["seg2tok"])
    np.testing.assert_allclose(per_video.detach().numpy(), run["per_video"], rtol=1e-4)
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(per_video.mean(), params)
    ref = grads_from_jax(run["grads"], model.block_cfgs, verbnoun=True)
    assert set(names) == set(ref)
    scale = max(float(np.abs(v.numpy()).max()) for v in ref.values())
    for n, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), ref[n].numpy(), atol=1e-4 * max(1.0, scale),
                                   rtol=1e-3, err_msg=n)

    # the whole step: the same loss, matching and decode, then Adam.  Adam's
    # first update is lr * g / (|g| + eps), about the sign of each gradient:
    # it is held wherever the two gradients' signs are certain to agree
    clear = {n: (np.abs(ref[n].numpy()) > 2 * np.abs(g.numpy() - ref[n].numpy()))
             & (np.abs(ref[n].numpy()) > 1e-6) for n, g in zip(names, grads)}
    out = step(batch, torch.Generator().manual_seed(0))
    np.testing.assert_allclose(float(out["loss"]), run["per_video"].mean(), rtol=1e-4)
    np.testing.assert_array_equal(out["seg2tok"].numpy(), run["seg2tok"])
    np.testing.assert_array_equal(out["pred"].numpy()[run["batch"]["mask"]],
                                  run["pred"][run["batch"]["mask"]])
    held = 0
    for n, p in model.named_parameters():
        got, want = p.detach().numpy(), run["after"][n]
        np.testing.assert_allclose(got[clear[n]], want[clear[n]], atol=1e-6, rtol=0, err_msg=n)
        held += int(clear[n].sum())
    assert held > 0.5 * sum(p.numel() for p in model.parameters())
