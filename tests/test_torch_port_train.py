"""The port's train step against the JAX package's on the CPU.

``_make_cfg(small=True)`` with dropout 0, channel masking 0 and the host
matcher: JAX ``build_fact`` runs its XLA path on the CPU, its parameters
cross into the port through the bridge, and one seeded batch in the graft
entry's layout goes through both.  Held equal:

* the loss of the ``steps.py:131-135`` loss function, to 1e-4 relative, and
  the matching (``seg2tok``) exactly;
* every parameter's gradient (``jax.value_and_grad``, mapped to the port's
  names by the exporter), to 1e-4 absolute and 1e-3 relative: float32 on
  both sides through ~30 layers, sums in another order;
* the parameters after optimizer steps on the same gradients (Adam with
  global-norm clipping, and SGD with momentum and L2), against optax through
  ``engine/state.py``, to 1e-6;
* the whole step through ``run_steps`` (loss, matching and train-time
  decode) against the same JAX loss function's;
* the LR schedule; the masks by their properties; and the weight round trip
  JAX -> exporter -> port -> ``torch_import`` -> JAX.

Both port paths are run: the kernel entries (on CPU tensors their plain
versions with the explicit backwards) and the plain autograd path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _make_batch, _make_cfg
from fact_clip_tpu.engine import state as jstate
from fact_clip_tpu.models import blocks as jblocks
from fact_clip_tpu.models import decode as jdecode
from fact_clip_tpu.models import losses as jl
from fact_clip_tpu.models import matching as jm
from fact_clip_tpu.utils.torch_export import export_fact_state_dict
from fact_clip_tpu.utils.torch_import import convert_fact_state_dict
from fact_clip_tpu_torch.configs import small_cfg
from fact_clip_tpu_torch.engine import state as tstate
from fact_clip_tpu_torch.engine.steps import make_train_step
from fact_clip_tpu_torch.engine.train_loop import batch_to_device, run_steps
from fact_clip_tpu_torch.models.blocks import build_fact
from fact_clip_tpu_torch.ops import masking
from fact_clip_tpu_torch.utils.bridge import grads_from_jax, load_jax_params

torch.set_num_threads(2)
D, C, S_CAP, B, T, S = 12, 5, 24, 2, 96, 8


def _cfgs(sa_input: bool = False):
    jcfg = _make_cfg(small=True)
    jcfg.Bi.dropout = 0.0
    jcfg.FACT.cmr = 0.0
    jcfg.TPU.matcher = "host"
    cfg = small_cfg()
    cfg["Bi"]["dropout"] = 0.0
    cfg["FACT"]["cmr"] = 0.0
    cfg["TPU"].update(pallas_attn=False, pallas_sa=False, matcher="host")
    if sa_input:
        jcfg.Bi.a = "sa"
        cfg["Bi"]["a"] = "sa"
    return jcfg, cfg


def _flax_params(jcfg, cfg, seed: int):
    """Seeded parameters in the flax layout: the port's initializer through
    ``torch_import`` (cheaper on the CPU than tracing flax's init)."""
    port = build_fact(cfg, D, C, S_CAP, device="cpu",
                      generator=torch.Generator().manual_seed(seed))
    return convert_fact_state_dict({k: v.numpy() for k, v in port.state_dict().items()},
                                   jblocks.resolve_block_cfgs(jcfg))


@pytest.fixture(scope="module")
def run():
    jcfg, cfg = _cfgs()
    model = jblocks.build_fact(jcfg, D, C, s_pred_cap=S_CAP)
    batch = _make_batch(np.random.default_rng(0), B, T, D, C, S)
    params = _flax_params(jcfg, cfg, 0)
    cweight = jl.build_class_weights(jcfg, C, [0])
    sw = float(jcfg.Loss.sw)

    def loss_fn(params):  # engine/steps.py:131-135, vanilla FACT
        saves, _ = model.apply({"params": params}, batch["feats"], batch["mask"],
                               batch["lengths"], train=True,
                               rngs={"dropout": jax.random.PRNGKey(1),
                                     "aug": jax.random.PRNGKey(2)})
        last = saves[-1]
        seg2tok = jm.match(jcfg.Loss, jax.nn.softmax(last["action_clogit"], axis=-1),
                           last["a2f_attn"], batch["transcript"], batch["seg_label"],
                           batch["seg_mask"], batch["mask"], matcher="host", nclasses=C)
        per_video = jl.fact_loss(saves, batch, seg2tok, jnp.asarray(cweight), sw)
        pred = jdecode.decode_two_branch(last["action_clogit"], last["a2f_attn"],
                                         last["frame_clogit"], float(jcfg.FACT.mwt),
                                         jnp.ones(last["action_clogit"].shape[:2], bool))
        return per_video.mean(), (per_video, seg2tok, pred)

    (loss, (per_video, seg2tok, pred)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return dict(jcfg=jcfg, cfg=cfg, params=tree(params), grads=tree(grads), cweight=cweight,
                batch={k: np.array(v) for k, v in batch.items()}, loss=float(loss),
                per_video=np.asarray(per_video), seg2tok=np.asarray(seg2tok),
                pred=np.asarray(pred))


def _port(run, kernels: bool):
    model = build_fact(run["cfg"], D, C, S_CAP, device="cpu")
    load_jax_params(model, run["params"])
    model.set_kernels(kernels)
    return model


@pytest.mark.parametrize("kernels", [True, False])
def test_loss_matching_and_every_gradient_match_jax(run, kernels):
    model = _port(run, kernels)
    step = make_train_step(model, run["cfg"], C, run["cweight"])
    per_video, seg2tok, _ = step.loss(batch_to_device(run["batch"], "cpu"),
                                      torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(seg2tok.numpy(), run["seg2tok"])
    np.testing.assert_allclose(per_video.detach().numpy(), run["per_video"], rtol=1e-4)
    loss = per_video.mean()
    np.testing.assert_allclose(float(loss.detach()), run["loss"], rtol=1e-4)

    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params)
    ref = grads_from_jax(run["grads"], model.block_cfgs)
    assert set(names) == set(ref)
    scale = max(float(np.abs(v.numpy()).max()) for v in ref.values())
    for n, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), ref[n].numpy(), atol=1e-4 * max(1.0, scale),
                                   rtol=1e-3, err_msg=n)


def test_train_step_matches_jax_train_step(run):
    """The whole step through ``run_steps``: the loss, the matching and the
    train-time decode of the pre-update forward equal JAX's."""
    model = _port(run, True)
    step = make_train_step(model, run["cfg"], C, run["cweight"])
    before = {k: v.clone() for k, v in model.state_dict().items()}
    times = {}
    (out,) = run_steps(step, [run["batch"]], generator=torch.Generator().manual_seed(0),
                       times=times)
    np.testing.assert_allclose(out["loss"], run["loss"], rtol=1e-4)
    np.testing.assert_array_equal(out["pred"].numpy(), run["pred"])
    np.testing.assert_array_equal(out["seg2tok"].numpy(), run["seg2tok"])
    assert set(times) == {"forward", "match", "losses", "backward", "optimizer", "decode"}
    # Adam moves exactly the parameters whose gradient is not all zero
    for n, p in model.named_parameters():
        assert (not torch.equal(p.detach(), before[n])) == bool(p.grad.abs().max() > 0), n


@pytest.mark.parametrize("optimizer", ["Adam", "SGD"])
def test_optimizer_steps_match_optax(run, optimizer):
    """Two steps on the same gradients, scaled so that clipping at 10 acts."""
    jcfg, cfg = _cfgs()
    jcfg.optimizer = cfg["optimizer"] = optimizer
    if optimizer == "SGD":
        jcfg.lr = cfg["lr"] = 0.05
        jcfg.momentum = cfg["momentum"] = 0.9
        jcfg.weight_decay = cfg["weight_decay"] = 1e-3
    grads = jax.tree_util.tree_map(lambda g: g * 50.0, run["grads"])
    norm = np.sqrt(sum(float((g ** 2).sum()) for g in jax.tree_util.tree_leaves(grads)))
    assert norm > 10.0

    tx = jstate.build_optimizer(jcfg, steps_per_epoch=1)
    params = run["params"]
    opt_state = tx.init(params)

    @jax.jit
    def update(params, opt_state):
        updates, opt_state = tx.update(grads, opt_state, params)
        return jax.tree_util.tree_map(lambda p, u: p + u, params, updates), opt_state

    for _ in range(2):
        params, opt_state = update(params, opt_state)

    model = _port(run, True)
    opt = tstate.build_optimizer(model, cfg)
    tg = grads_from_jax(grads, model.block_cfgs)
    for _ in range(2):
        opt.zero_grad()
        for n, p in model.named_parameters():
            p.grad = tg[n].clone()
        opt.step()
    ref = export_fact_state_dict(jax.tree_util.tree_map(np.asarray, params), model.block_cfgs)
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), ref[k], atol=1e-6, rtol=0, err_msg=k)


def test_lr_schedule_matches_jax():
    for base, decay, spe in ((0.1, 3, 5), (1e-4, -1, 7), (0.5, 1, 1)):
        ref = jstate.lr_schedule(base, decay, spe)
        got = tstate.lr_schedule(base, decay, spe)
        for step in range(0, 31):
            assert got(step) == pytest.approx(float(ref(step)), rel=1e-7), (base, decay, step)


def test_time_mask_shapes_and_bounds():
    feats = torch.ones((3, 50, 8))
    out = masking.time_mask(torch.Generator().manual_seed(0), feats,
                            torch.tensor([50, 30, 10]), t_max=20, num_masks=2, p=0.3)
    assert out.shape == (3, 50, 8)
    assert set(torch.unique(out).tolist()) <= {0.0, 1.0}
    assert torch.all(out[2, 30:] == 1.0)  # spans start within [0, len - t]
    # spans are whole frames: every channel of a frame agrees
    assert torch.equal(out, out[..., :1].expand_as(out))


def test_channel_mask_drops_whole_channels():
    out = masking.channel_mask(torch.Generator().manual_seed(1), torch.ones((2, 10, 64)), 0.5)
    for b in range(2):
        col = out[b, 0]
        assert set(torch.unique(col).tolist()) <= {0.0, 2.0}
        assert torch.equal(out[b], col.expand(10, 64))
    assert masking.channel_mask(torch.Generator(), torch.ones(1, 2, 3), 0.0).sum() == 6.0


@pytest.mark.parametrize("sa_input", [False, True])
def test_weight_round_trip_through_the_port(run, sa_input):
    """JAX params -> exporter -> port (strict load) -> port state_dict ->
    ``torch_import`` -> the same flax tree, leaf for leaf."""
    jcfg, cfg = _cfgs(sa_input)
    params = _flax_params(jcfg, cfg, 5) if sa_input else run["params"]
    bcfgs = jblocks.resolve_block_cfgs(jcfg)
    port = build_fact(cfg, D, C, S_CAP, device="cpu")
    port.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                          export_fact_state_dict(params, bcfgs).items()}, strict=True)
    back = convert_fact_state_dict({k: v.numpy() for k, v in port.state_dict().items()}, bcfgs)
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    back_flat = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat) == len(back_flat)
    for path, leaf in flat:
        np.testing.assert_array_equal(np.asarray(back_flat[path]), np.asarray(leaf),
                                      err_msg=jax.tree_util.keystr(path))
