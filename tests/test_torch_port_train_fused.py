"""The port's train step with the fused K3 / K4 entries against the JAX
package's train step on the CPU.

The approach of ``tests/test_torch_port_train.py``: dropout 0, channel
masking 0 and the host matcher on both sides; JAX ``build_fact`` runs its
XLA path on the CPU, its seeded parameters cross into the port through the
bridge, and one seeded batch goes through both.  On the port side the
action branch runs through the kernels' autograd entries (their plain
versions and explicit backwards on CPU tensors):

* the small config (``_make_cfg(small=True)``) with ``pallas_sa`` on: every
  SA and SCA self-attention / FFN sublayer through K4;
* a mid-width config where K3 fuses as well: a_dim = hid_dim = 128, H = 4,
  T = 1100 with ragged lengths, B = 2, 2 SCA layers, 2-layer towers.

Held: the loss to 1e-4 relative, the matching (``seg2tok``) exactly, every
parameter's gradient to 1e-4 absolute and 1e-3 relative (float32 on both
sides through ~30 layers, sums in another order); and that the fused
backwards really ran.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _make_cfg
from fact_clip_tpu.models import blocks as jblocks
from fact_clip_tpu.models import losses as jl
from fact_clip_tpu.models import matching as jm
from fact_clip_tpu.utils.torch_import import convert_fact_state_dict
from fact_clip_tpu_torch.configs import small_cfg
from fact_clip_tpu_torch.engine.steps import make_train_step
from fact_clip_tpu_torch.engine.train_loop import batch_to_device, synthetic_batch
from fact_clip_tpu_torch.models.blocks import build_fact
from fact_clip_tpu_torch.ops import mha_attn, sa_layer
from fact_clip_tpu_torch.utils.bridge import grads_from_jax, load_jax_params

torch.set_num_threads(2)

SMALL = dict(D=12, C=5, S_CAP=24, S=8, lengths=[96, 70], T=96)
MID = dict(D=64, C=5, S_CAP=24, S=8, lengths=[1100, 1031], T=1100)
_MID_BLOCK = dict(hid_dim=128, a_dim=128, a_ffdim=128, a_nhead=4, a_layers=2, f_dim=32,
                  f_layers=2)


def _cfgs(mid: bool):
    jcfg = _make_cfg(small=True)
    cfg = small_cfg()
    jcfg.Bi.dropout = cfg["Bi"]["dropout"] = 0.0
    jcfg.FACT.cmr = cfg["FACT"]["cmr"] = 0.0
    jcfg.TPU.matcher = cfg["TPU"]["matcher"] = "host"
    if mid:
        for k, v in _MID_BLOCK.items():
            setattr(jcfg.Bi, k, v)
            cfg["Bi"][k] = v
        jcfg.Bu.f_layers = jcfg.BU.f_layers = cfg["Bu"]["f_layers"] = cfg["BU"]["f_layers"] = 2
    return jcfg, cfg


def _run(mid: bool):
    shape = MID if mid else SMALL
    D, C, S_CAP, S, T = (shape[k] for k in ("D", "C", "S_CAP", "S", "T"))
    jcfg, cfg = _cfgs(mid)
    batch = synthetic_batch(np.random.default_rng(3), D, C, S, T, shape["lengths"])
    port = build_fact(cfg, D, C, S_CAP, device="cpu", generator=torch.Generator().manual_seed(1))
    params = convert_fact_state_dict({k: v.numpy() for k, v in port.state_dict().items()},
                                     jblocks.resolve_block_cfgs(jcfg))
    model = jblocks.build_fact(jcfg, D, C, s_pred_cap=S_CAP)
    cweight = jl.build_class_weights(jcfg, C, [0])
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(params):  # engine/steps.py:131-135, vanilla FACT
        saves, _ = model.apply({"params": params}, jb["feats"], jb["mask"], jb["lengths"],
                               train=True, rngs={"dropout": jax.random.PRNGKey(1),
                                                 "aug": jax.random.PRNGKey(2)})
        last = saves[-1]
        seg2tok = jm.match(jcfg.Loss, jax.nn.softmax(last["action_clogit"], axis=-1),
                           last["a2f_attn"], jb["transcript"], jb["seg_label"], jb["seg_mask"],
                           jb["mask"], matcher="host", nclasses=C)
        per_video = jl.fact_loss(saves, jb, seg2tok, jnp.asarray(cweight), float(jcfg.Loss.sw))
        return per_video.mean(), seg2tok

    (loss, seg2tok), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return dict(cfg=cfg, shape=shape, batch=batch, params=tree(params), grads=tree(grads),
                cweight=cweight, loss=float(loss), seg2tok=np.asarray(seg2tok))


@pytest.fixture(scope="module", params=["small_k4", "mid_k3_k4"])
def run(request):
    return _run(request.param == "mid_k3_k4")


def test_fused_train_step_matches_jax(run, monkeypatch):
    shape = run["shape"]
    model = build_fact(run["cfg"], shape["D"], shape["C"], shape["S_CAP"], device="cpu")
    load_jax_params(model, run["params"])
    mid = shape is MID
    assert all(layer.use_kernel for b in model.block_list for layer in b.action_branch.layers)
    calls = {"sa": 0, "ffn": 0, "mha": 0}

    def spy(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(sa_layer, "sa_sublayer_bwd", spy("sa", sa_layer.sa_sublayer_bwd))
    monkeypatch.setattr(sa_layer, "ffn_sublayer_bwd", spy("ffn", sa_layer.ffn_sublayer_bwd))
    monkeypatch.setattr(mha_attn, "mha_cross_bwd", spy("mha", mha_attn.mha_cross_bwd))

    step = make_train_step(model, run["cfg"], shape["C"], run["cweight"])
    per_video, seg2tok, _ = step.loss(batch_to_device(run["batch"], "cpu"),
                                      torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(seg2tok.numpy(), run["seg2tok"])
    loss = per_video.mean()
    np.testing.assert_allclose(float(loss.detach()), run["loss"], rtol=1e-4)
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params)
    # every SA / SCA layer's two sublayers, and (mid) every SCA cross-attention
    n_layers = sum(len(b.action_branch.layers) for b in model.block_list)
    assert calls == {"sa": n_layers, "ffn": n_layers, "mha": 2 if mid else 0}, calls
    ref = grads_from_jax(run["grads"], model.block_cfgs)
    assert set(names) == set(ref)
    for n, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), ref[n].numpy(), atol=1e-4, rtol=1e-3, err_msg=n)
