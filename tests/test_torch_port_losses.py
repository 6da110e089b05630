"""The port's matching and losses against the JAX package on the CPU.

Seeded inputs (the graft entry's batch layout and random logits shaped like
a model's saves) go through ``fact_clip_tpu.models.matching`` / ``losses``
and their counterparts in ``fact_clip_tpu_torch.models``: the soft IoU, the
matching cost, the host Hungarian assignment, every loss term, the block
losses of kinds i, u and U (through the fused frame loss's plain version and
without it), ``fact_loss``, and the class and automatic null weights.  Tolerance 1e-5 absolute and relative
(float32 on both sides, sums in another order); the assignment must be equal.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _make_batch, _make_cfg
from fact_clip_tpu.models import losses as jl
from fact_clip_tpu.models import matching as jm
from fact_clip_tpu_torch.configs import small_cfg
from fact_clip_tpu_torch.models import losses as tl
from fact_clip_tpu_torch.models import matching as tm

torch.set_num_threads(2)
TOL = 1e-5
B, T, C, M, S_GT, S_PRED = 2, 60, 5, 6, 8, 10


def _close(port, ref, err_msg=""):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), atol=TOL, rtol=TOL,
                               err_msg=err_msg)


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    batch = {k: np.array(v) for k, v in _make_batch(rng, B, T, 4, C, S_GT).items()}
    mask = batch["mask"]
    r = lambda *s: (rng.standard_normal(s) * 2).astype(np.float32)  # noqa: E731
    f2a = r(B, M, T)
    f2a[np.broadcast_to(~mask[:, None, :], f2a.shape)] = -1e9
    a2f = r(B, T, M)
    seg_id = np.minimum(np.arange(T) // 7, S_PRED - 1)
    P = (np.eye(S_PRED, dtype=np.float32)[seg_id][None] * mask[..., None]).astype(np.float32)
    seg_valid = P.sum(axis=1) > 0
    f2a_seg = r(B, M, S_PRED)
    f2a_seg[np.broadcast_to(~seg_valid[:, None, :], f2a_seg.shape)] = -1e9
    saves = {
        "i": {"frame_clogit": r(B, T, C), "action_clogit": r(B, M, C + 1), "kind": "i"},
        "u": {"frame_clogit": r(B, T, C), "action_clogit": r(B, M, C + 1), "kind": "u",
              "f2a_attn_logit": f2a, "a2f_attn_logit": a2f},
        "U": {"frame_clogit": r(B, T, C), "action_clogit": r(B, M, C + 1), "kind": "U",
              "seg_clogit": r(B, S_PRED, C), "tdu_P": P, "tdu_seg_valid": seg_valid,
              "f2a_attn_logit": f2a_seg, "a2f_attn_logit": r(B, S_PRED, M)},
    }
    cweight = rng.uniform(0.2, 1.5, C + 1).astype(np.float32)
    cprob = np.asarray(jax.nn.softmax(jnp.asarray(saves["u"]["action_clogit"]), axis=-1))
    a2f_attn = np.asarray(jax.nn.softmax(jnp.asarray(a2f), axis=-1))
    return dict(batch=batch, saves=saves, cweight=cweight, cprob=cprob, a2f_attn=a2f_attn)


def _t(d):
    return {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v) for k, v in d.items()}


def _j(d):
    return {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in d.items()}


def _seg2tok(case):
    b = case["batch"]
    return np.array(jm.match(_make_cfg(True).Loss, jnp.asarray(case["cprob"]),
                             jnp.asarray(case["a2f_attn"]), jnp.asarray(b["transcript"]),
                             jnp.asarray(b["seg_label"]), jnp.asarray(b["seg_mask"]),
                             jnp.asarray(b["mask"]), matcher="host"))


def test_soft_iou_and_match_cost_match_jax(case):
    b = case["batch"]
    args = (case["a2f_attn"], b["seg_label"], b["seg_mask"], b["mask"])
    _close(tm.soft_iou(*map(torch.from_numpy, args)), jm.soft_iou(*map(jnp.asarray, args)))
    cargs = (case["cprob"], case["a2f_attn"], b["transcript"], b["seg_label"], b["seg_mask"],
             b["mask"])
    _close(tm.match_cost(*map(torch.from_numpy, cargs), 0.2, 1.0),
           jm.match_cost(*map(jnp.asarray, cargs), 0.2, 1.0))


def test_o2o_assignment_matches_jax(case):
    b = case["batch"]
    cfg = small_cfg()
    got = tm.match(cfg["Loss"], torch.from_numpy(case["cprob"]),
                   torch.from_numpy(case["a2f_attn"]),
                   *[torch.from_numpy(b[k]) for k in ("transcript", "seg_label", "seg_mask",
                                                      "mask")])
    ref = _seg2tok(case)
    np.testing.assert_array_equal(got.numpy(), ref)
    # one token per valid segment, never twice
    for v in range(B):
        toks = ref[v][b["seg_mask"][v]]
        assert len(set(toks.tolist())) == len(toks)


def _term_args(case, term):
    b, s = case["batch"], case["saves"]
    seg2tok = _seg2tok(case)
    Y = np.asarray(jl._build_targets(jnp.asarray(b["seg_label"]), jnp.asarray(b["mask"]),
                                     jnp.asarray(b["seg_mask"])))
    sweight = np.where(b["seg_mask"], case["cweight"][b["transcript"]], 0.0).astype(np.float32)
    pair = b["mask"][:, 1:] & b["mask"][:, :-1]
    return {
        "action_token_loss": (s["u"]["action_clogit"], seg2tok, b["transcript"], b["seg_mask"],
                              case["cweight"]),
        "a2f_attn_loss": (s["u"]["a2f_attn_logit"], seg2tok, b["seg_mask"], Y, sweight),
        "f2a_attn_loss": (s["u"]["f2a_attn_logit"], seg2tok, b["seg_mask"], b["mask"], Y,
                          sweight),
        "frame_loss": (s["u"]["frame_clogit"], b["labels"], b["mask"], case["cweight"]),
        "frame_loss_tdu": (s["U"]["seg_clogit"], s["U"]["tdu_P"], b["labels"], case["cweight"]),
        "smooth_loss": (s["u"]["frame_clogit"], pair),
        "ref_order_sweight": (sweight, seg2tok, b["seg_mask"]),
    }[term]


@pytest.mark.parametrize("term", ["action_token_loss", "a2f_attn_loss", "f2a_attn_loss",
                                  "frame_loss", "frame_loss_tdu", "smooth_loss",
                                  "ref_order_sweight"])
def test_loss_terms_match_jax(case, term):
    args = _term_args(case, term)
    _close(getattr(tl, term)(*map(torch.from_numpy, args)),
           getattr(jl, term)(*map(jnp.asarray, args)))


@pytest.mark.parametrize("use_kernel", [True, False])
def test_fused_frame_terms_match_jax(case, use_kernel):
    b, s = case["batch"], case["saves"]["u"]
    args = (s["frame_clogit"], b["labels"], b["mask"], case["cweight"])
    got = tl.frame_ce_smooth(*map(torch.from_numpy, args), use_kernel=use_kernel)
    ref = jl.frame_ce_smooth(*map(jnp.asarray, args), use_pallas=False)
    for g, r in zip(got, ref):
        _close(g, r)
    sm = (s["a2f_attn_logit"], b["mask"])
    _close(tl.smooth_loss_opt(*map(torch.from_numpy, sm), use_kernel=use_kernel),
           jl.smooth_loss_opt(*map(jnp.asarray, sm), None, use_pallas=False))


@pytest.mark.parametrize("kind", ["i", "u", "U"])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_block_loss_and_gradient_match_jax(case, kind, use_kernel):
    """Per-video block loss, and its gradient with respect to every logit save."""
    b, saves = case["batch"], case["saves"][kind]
    seg2tok = _seg2tok(case)
    keys = [k for k in ("frame_clogit", "action_clogit", "seg_clogit", "f2a_attn_logit",
                        "a2f_attn_logit") if k in saves]
    sj = _j(saves)

    def f(*logits):
        d = dict(sj, **dict(zip(keys, logits)))
        return jl.block_loss(d, _j(b), jnp.asarray(seg2tok), jnp.asarray(case["cweight"]), 5.0)

    ref, vjp = jax.vjp(f, *[sj[k] for k in keys])
    gv = np.linspace(0.5, 1.5, B).astype(np.float32)
    ref_grads = vjp(jnp.asarray(gv))

    st = _t(saves)
    leaves = [st[k].clone().requires_grad_(True) for k in keys]
    got = tl.block_loss(dict(st, **dict(zip(keys, leaves))), _t(b), torch.from_numpy(seg2tok),
                        torch.from_numpy(case["cweight"]), 5.0, use_kernel=use_kernel)
    _close(got, ref)
    grads = torch.autograd.grad(got, leaves, torch.from_numpy(gv))
    for k, g, r in zip(keys, grads, ref_grads):
        _close(g, r, err_msg=k)


def test_fact_loss_matches_jax(case):
    b = case["batch"]
    seg2tok = _seg2tok(case)
    order = ["i", "u", "U", "U"]
    ref = jl.fact_loss([_j(case["saves"][k]) for k in order], _j(b), jnp.asarray(seg2tok),
                       jnp.asarray(case["cweight"]), 5.0)
    got = tl.fact_loss([_t(case["saves"][k]) for k in order], _t(b), torch.from_numpy(seg2tok),
                       torch.from_numpy(case["cweight"]), 5.0, use_kernel=True)
    _close(got, ref)


def test_class_weights_match_jax():
    jcfg, cfg = _make_cfg(True), small_cfg()
    np.testing.assert_array_equal(tl.build_class_weights(cfg, 7, [0, 3]),
                                  jl.build_class_weights(jcfg, 7, [0, 3]))
    cw = np.arange(7, dtype=np.float32)
    np.testing.assert_array_equal(tl.build_class_weights(cfg, 7, [], cw),
                                  jl.build_class_weights(jcfg, 7, [], cw))


@pytest.mark.parametrize("dataset", ["breakfast", "epic"])
def test_null_weight_matches_jax(dataset):
    stats = SimpleNamespace(average_transcript_len=5.25, nclasses=48)
    jcfg, cfg = _make_cfg(True), small_cfg()
    jcfg.dataset, cfg["dataset"] = dataset, dataset
    got = tl.compute_null_weight(cfg, stats)["Loss"]["nullw"]
    assert got == jl.compute_null_weight(jcfg, stats).Loss.nullw
