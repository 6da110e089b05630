"""The training and evaluation loops (the port's counterpart of
``fact_clip_tpu/engine/train_loop.py``).

``run_train`` follows the JAX loop: ``args.json``, the epoch loop over a
shuffled ``TrainLoader(seed=aux.seed)`` with a thread prefetcher, train
metrics every ``print_every`` steps, a test pass (``evaluate``) with its
results checkpoint ``saves/<N>.gz`` and the weights ``ckpts/network.iter-<N>.net``
(and the optimizer sidecar) every ``eval_every`` steps, the best test pass by
F1@0.50 in ``best_ckpt.gz``, and FINISH_PROOF.  Channel and time masking and
dropout of step ``g`` draw from a generator seeded by ``(aux.seed, g)``
(``step_generator``), so a resumed run draws at step ``g`` what an unbroken
run drew there.  One process drives one device: the JAX loop's mesh and
multi-process branches, and its profiler hook, raise when a config asks for
them.  A resumed run starts its epoch from the loader's first shuffle, as
the JAX loop's does (ROADMAP Queue 3).

``run_steps`` steps numpy batches in the ``Batch.device_arrays`` layout;
``synthetic_batch`` makes a seeded batch in that layout, ``epic_batch``
one of long verb/noun videos, and ``synthetic_set_stats`` the dataset
statistics a config's ``nullw = -1`` is resolved from
(``models/losses.py::compute_null_weight``).
"""

from __future__ import annotations

import json
import os
import time
import types

import numpy as np
import torch

from ..configs import compute_dtype
from ..configs.utils import cfg2flatdict
from ..data.prefetch import prefetch
from ..utils.results import Checkpoint, save_results
from . import checkpoint as ckpt_io
from .logging import Logger, split_metric_namespace
from .setup import Experiment, build_experiment, resolve_device
from .steps import make_eval_step, make_train_step

BATCH_KEYS = ("feats", "mask", "labels", "seg_label", "transcript", "seg_mask", "lengths")
LOSS_KEYS = ("per_video_loss", "fact_loss", "contrastive_loss")  # per-video step outputs


def _host(a) -> np.ndarray:
    a = np.ascontiguousarray(a)
    return a if a.flags.writeable else a.copy()


def batch_to_device(arrays: dict, device, feats_dtype=torch.float32) -> dict:
    """``Batch.device_arrays`` (numpy) -> the same dict of tensors on
    ``device``; the features cross as ``feats_dtype`` (cast on the host)."""
    out = {k: torch.from_numpy(_host(arrays[k])) for k in BATCH_KEYS}
    out["feats"] = out["feats"].to(feats_dtype)
    return {k: v.to(device) for k, v in out.items()}


def feats_dtype(cfg) -> torch.dtype:
    """The dtype the features cross to the device as, as JAX's loop feeds
    them (``engine/train_loop.py:182-185``): ``TPU.feature_dtype``, or where
    it is "" the compute dtype; bf16 under mixed precision halves the copy
    (the in map casts them to bf16 in any case, so no number changes)."""
    fdt = cfg.TPU.feature_dtype or cfg.TPU.compute_dtype
    return torch.bfloat16 if fdt == "bfloat16" else torch.float32


def run_steps(train_step, batches, *, generator: torch.Generator, times=None) -> list:
    """Step ``train_step`` once per numpy batch; returns each step's output
    (loss as a host float, the per-video losses, and FACT_CLIP's per-video
    "fact_loss" and "contrastive_loss" where the step has them, as host
    arrays).  The generator must live on the step's device, which is where
    the batches go."""
    device = train_step.device
    if torch.device(generator.device).type != device.type:
        raise ValueError(f"generator on {generator.device}, train step on {device}")
    outs = []
    for arrays in batches:
        out = train_step(batch_to_device(arrays, device), generator, times=times)
        outs.append({"loss": float(out["loss"]), "pred": out["pred"], "seg2tok": out["seg2tok"],
                     **{k: out[k].cpu().numpy() for k in LOSS_KEYS if k in out}})
    return outs


def synthetic_batch(rng: np.random.Generator, D: int, C: int, S: int, T: int, lengths) -> dict:
    """A seeded batch in the ``Batch.device_arrays`` layout, padded to T:
    10-30 segments of piecewise-constant labels per video (at most S),
    features a class pattern plus unit noise; padded frames repeat the last
    label and segment."""
    B = len(lengths)
    proto = rng.standard_normal((C, D)).astype(np.float32)
    out = dict(feats=np.zeros((B, T, D), np.float32), mask=np.zeros((B, T), bool),
               labels=np.zeros((B, T), np.int32), seg_label=np.zeros((B, T), np.int32),
               transcript=np.zeros((B, S), np.int32), seg_mask=np.zeros((B, S), bool),
               lengths=np.asarray(lengths, np.int32))
    for b, t in enumerate(lengths):
        n_seg = int(rng.integers(min(10, S), min(30, S) + 1))
        cuts = np.sort(rng.choice(np.arange(1, t), n_seg - 1, replace=False))
        bounds = np.concatenate([[0], cuts, [t]])
        classes = [int(rng.integers(0, C))]
        while len(classes) < n_seg:
            c = int(rng.integers(0, C))
            if c != classes[-1]:
                classes.append(c)
        for k in range(n_seg):
            out["labels"][b, bounds[k]:bounds[k + 1]] = classes[k]
            out["seg_label"][b, bounds[k]:bounds[k + 1]] = k
        out["labels"][b, t:], out["seg_label"][b, t:] = classes[-1], n_seg - 1
        out["transcript"][b, :n_seg] = classes
        out["seg_mask"][b, :n_seg] = out["mask"][b, :t] = True
        out["feats"][b, :t] = (proto[out["labels"][b, :t]]
                               + rng.standard_normal((t, D)).astype(np.float32))
    return out


def epic_batch(rng: np.random.Generator, D: int, n_act: int, T: int, lengths, n_seg: int = 40,
               S: int = 64, pool: int = 12) -> dict:
    """A seeded batch of epic-length videos in the ``Batch.device_arrays``
    layout, padded to T: the recipe of ``scripts/bench_epic.py::
    _epic_train_labels`` (``n_seg`` piecewise-constant segments per video,
    no two neighbours of one action; the transcript padded to S), except
    that each video draws its segments' actions from a seeded pool of
    ``pool`` actions in place of all ``n_act``: actions then repeat within a
    video, as they do in Epic-Kitchens (taking and putting back, opening and
    closing), and that is where o2m matching differs from o2o.  Features are
    a per-action pattern plus unit noise; padded frames repeat the last label
    and segment."""
    if n_seg > S:
        raise ValueError(f"epic_batch: {n_seg} segments do not fit a transcript of {S}")
    B = len(lengths)
    out = dict(feats=np.zeros((B, T, D), np.float32), mask=np.zeros((B, T), bool),
               labels=np.zeros((B, T), np.int32), seg_label=np.zeros((B, T), np.int32),
               transcript=np.zeros((B, S), np.int32), seg_mask=np.zeros((B, S), bool),
               lengths=np.asarray(lengths, np.int32))
    for b, t in enumerate(lengths):
        actions = rng.choice(n_act, pool, replace=False)
        proto = rng.standard_normal((pool, D)).astype(np.float32)
        cuts = np.sort(rng.choice(np.arange(1, t), n_seg - 1, replace=False))
        bounds = np.concatenate([[0], cuts, [t]])
        picks = [int(rng.integers(0, pool))]
        while len(picks) < n_seg:
            k = int(rng.integers(0, pool))
            if k != picks[-1]:
                picks.append(k)
        for s, k in enumerate(picks):
            out["labels"][b, bounds[s]:bounds[s + 1]] = actions[k]
            out["seg_label"][b, bounds[s]:bounds[s + 1]] = s
            out["feats"][b, bounds[s]:bounds[s + 1]] = proto[k]
        out["labels"][b, t:], out["seg_label"][b, t:] = actions[picks[-1]], n_seg - 1
        out["transcript"][b, :n_seg] = actions[picks]
        out["seg_mask"][b, :n_seg] = out["mask"][b, :t] = True
        out["feats"][b, :t] += rng.standard_normal((t, D)).astype(np.float32)
    return out


def synthetic_set_stats(batches, nclasses: int):
    """What ``compute_null_weight`` reads of a dataset, for a set of
    synthetic batches: the mean transcript length (segments per video) and
    the class count."""
    counts = [int(n) for b in batches for n in np.asarray(b["seg_mask"]).sum(axis=1)]
    return types.SimpleNamespace(average_transcript_len=float(np.mean(counts)), nclasses=nclasses)


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of train step ``step``'s masks and dropout: seeded by
    (seed, step) alone, on ``device``."""
    state = np.random.SeedSequence([int(seed), int(step)]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state) & (2 ** 63 - 1))


def _collect_video_saves(batch, pred, step_out=None) -> list:
    """Slice a step's outputs back into per-video host dicts: the
    predictions, and from a train step's output dict each video's
    ``LOSS_KEYS`` entries it has ("per_video_loss" as "loss")."""
    pred = pred.cpu().numpy() if isinstance(pred, torch.Tensor) else np.asarray(pred)
    losses = {("loss" if k == "per_video_loss" else k): step_out[k].cpu().numpy()
              for k in LOSS_KEYS if k in (step_out or {})}
    saves = []
    for i in range(len(batch.vnames)):
        data = {"pred": pred[i, : int(batch.lengths[i])]}
        if losses:
            data["loss"] = {k: float(v[i]) for k, v in losses.items()}
        saves.append(data)
    return saves


def evaluate(global_step, exp: Experiment, eval_step, logger, savedir) -> Checkpoint:
    """Test pass -> metrics -> results checkpoint ``saves/<global_step + 1>.gz``."""
    cfg = exp.cfg
    test_ds = exp.test_dataset
    device = next(exp.model.parameters()).device
    print("TESTING" + "~" * 10)
    ckpt = Checkpoint(
        global_step + 1,
        bg_class=([] if cfg.eval_bg else test_ds.bg_class),
        holdout_classes=test_ds.holdout_classes,
        seen_classes=test_ds.seen_classes,
    )
    fdt = feats_dtype(cfg)
    for batch in prefetch(exp.test_loader(), cfg.TPU.prefetch):
        arrays = batch_to_device(batch.device_arrays, device, fdt)
        # transcript mode decodes with the test videos' transcripts (JAX's eval
        # step takes the whole batch)
        pred = eval_step(arrays["feats"], arrays["mask"], arrays["lengths"],
                         transcript=arrays["transcript"], seg_mask=arrays["seg_mask"])
        save_results(ckpt, batch.vnames, batch.eval_labels, _collect_video_saves(batch, pred))

    ckpt.compute_metrics()
    log_dict = split_metric_namespace(ckpt.metrics)
    print(", ".join("%s:%.1f" % (k, v) for k, v in ckpt.metrics.items()) + "\n")
    if len(test_ds.holdout_classes) > 0:
        print("=" * 60)
        print("HOLDOUT EVALUATION SUMMARY")
        for key in ("Acc-seen", "Acc-unseen", "F1@0.50-seen", "F1@0.50-unseen"):
            if key in ckpt.metrics:
                print(f"{key}: {ckpt.metrics[key]:.1f}%")
        print("=" * 60)

    if logger is not None:
        logger.log(log_dict, step=global_step + 1)
    if savedir is not None:
        ckpt.save(os.path.join(savedir, "%d.gz" % (global_step + 1)))
        if len(test_ds.holdout_classes) > 0:
            ckpt.save_detailed_results(
                os.path.join(savedir, f"{global_step + 1}_detailed.json"))
    return ckpt


def check_loop_cfg(cfg, train: bool = True) -> None:
    """Refuse what the JAX loop does and this one has no path for
    (``build_experiment`` refuses the models the port has no path for):
    training (``train``) or, for evaluation, what ``evaluate`` and
    ``run_eval`` cannot take.  Mixed precision evaluates and trains
    (``havid_tpu.yaml``, its ``matcher: auction`` on the device) at dropout
    0; bf16 training with dropout raises (ROADMAP M7 item 5)."""
    tpu = cfg.TPU
    bf16 = compute_dtype(cfg) == "bfloat16"
    if train and bf16 and any((cfg[k].dropout or 0.0) > 0 for k in ("Bi", "Bu", "BU")):
        raise NotImplementedError("TPU.compute_dtype bfloat16: training in bf16 with dropout > 0 "
                                  "is ROADMAP M7 item 5")
    if tpu.num_data_shards > 1 or tpu.num_slice_shards > 1 or tpu.num_seq_shards > 1:
        raise NotImplementedError(
            "TPU.num_data_shards / num_slice_shards / num_seq_shards > 1: the port trains on "
            "one device (multi-GPU is ROADMAP M13)")
    if tpu.profile_dir:
        raise NotImplementedError("TPU.profile_dir: the loop's profiler hook is not ported "
                                  "(ROADMAP Queue 1 item 5); use fact_clip_tpu_torch.profile_eval")
    if tpu.feature_dtype not in ("", "float32") and not (
            bf16 and tpu.feature_dtype == "bfloat16"):
        raise NotImplementedError(f"TPU.feature_dtype {tpu.feature_dtype!r}: the port feeds "
                                  "bf16 features only to its bf16 models (ROADMAP M7)")
    if tpu.matmul_precision not in ("", "highest"):
        raise NotImplementedError(f"TPU.matmul_precision {tpu.matmul_precision!r}: the port's "
                                  "matmuls are float32")
    ckpt_io.check_backend(tpu.checkpoint_backend)


def run_train(cfg, device=None, base_dir=None, text_embeddings=None):
    """The full training run of ``cfg`` (``setup_cfg``'s tree) on ``device``:
    the CUDA card when None (it raises without one); ``device="cpu"`` runs
    the plain PyTorch path on the CPU.  Logs go to ``<base_dir>/<aux.logdir>``
    (``base_dir``: the working directory when None).  ``text_embeddings``
    (n_classes, E) give a ``use_clip`` run its clip bundle: the contrastive
    loss, logged beside the loss as ``fact_loss`` / ``contrastive_loss``, and
    the CLIP decode.  Returns (the train step, with its model and optimizer,
    and the best test checkpoint or None); exits early when the run already
    finished (``resume: max``)."""
    device = resolve_device(device)
    check_loop_cfg(cfg)
    base = base_dir or os.getcwd()
    logdir = os.path.join(base, cfg.aux.logdir)
    ckptdir = os.path.join(logdir, "ckpts")
    savedir = os.path.join(logdir, "saves")

    # the resume decision first: it exits early when FINISH_PROOF exists;
    # then the experiment, which refuses an unported model before any file
    # is written.  args.json holds the config as given (nullw -1 unresolved)
    global_step, ckpt_file = ckpt_io.resume_ckpt(cfg, logdir)
    args = cfg2flatdict(cfg)
    exp = build_experiment(cfg, device, seed=cfg.aux.seed, text_embeddings=text_embeddings)

    os.makedirs(ckptdir, exist_ok=True)
    os.makedirs(savedir, exist_ok=True)
    print("Saving log at", logdir)
    with open(os.path.join(logdir, "args.json"), "w") as f:
        json.dump(args, f, indent=True)

    dataset, test_ds = exp.dataset, exp.test_dataset
    print("Train dataset", dataset)
    print("Test dataset ", test_ds)
    print(f"Buckets {exp.buckets}, seg_cap {exp.seg_cap}, pred_seg_cap {exp.s_pred_cap}")
    print(f"Model parameters: {sum(p.numel() for p in exp.model.parameters()):,}")

    trainloader = exp.train_loader(seed=cfg.aux.seed)
    steps_per_epoch = len(trainloader)
    step = make_train_step(exp.model, cfg, dataset.nclasses, exp.cweight, steps_per_epoch,
                           exp.clip_bundle)
    if ckpt_file is not None:
        ckpt_io.load_model(exp.model, ckpt_file)
        if cfg.TPU.save_opt_state and ckpt_io.load_train_state(step.optimizer, ckpt_file):
            print(f"Restored the optimizer state (step {step.optimizer.count})")
    eval_step = make_eval_step(exp.model, cfg.FACT.mwt, exp.clip_bundle)
    logger = Logger(logdir)

    def fresh_train_ckpt():
        return Checkpoint(-1, bg_class=(dataset.bg_class if cfg.eval_bg else []),
                          eval_edit=False, holdout_classes=test_ds.holdout_classes,
                          seen_classes=test_ds.seen_classes)

    train_ckpt = fresh_train_ckpt()
    best_ckpt, best_metric = None, 0.0
    start_epoch = global_step // max(steps_per_epoch, 1)
    print(f"Start Training from Epoch {start_epoch}...")
    t_start = time.time()

    for _ in range(start_epoch, cfg.epoch):
        for batch in prefetch(trainloader, cfg.TPU.prefetch):
            out = step(batch_to_device(batch.device_arrays, device, feats_dtype(cfg)),
                       step_generator(cfg.aux.seed, global_step, device))
            save_results(train_ckpt, batch.vnames, batch.eval_labels,
                         _collect_video_saves(batch, out["pred"], out))

            if (global_step + 1) % cfg.aux.print_every == 0:
                train_ckpt.compute_metrics()
                train_ckpt.average_losses()
                log_dict = {f"train-loss/{k}": v for k, v in train_ckpt.loss.items()}
                log_dict.update({"train-metric/" + k: v for k, v in train_ckpt.metrics.items()})
                loss_str = ", ".join(f"{k}:{v:.2f}" for k, v in train_ckpt.loss.items())
                metr_str = ", ".join(f"{k}:{v:.3f}" for k, v in train_ckpt.metrics.items())
                print(f"Iter{global_step + 1} [{time.time() - t_start:.0f}s], {loss_str}")
                print(" " * 6 + metr_str)
                logger.log(log_dict, step=global_step + 1)
                train_ckpt = fresh_train_ckpt()

            if global_step != 0 and (global_step + 1) % cfg.aux.eval_every == 0:
                test_ckpt = evaluate(global_step, exp, eval_step, logger, savedir)
                if test_ckpt.metrics["F1@0.50"] >= best_metric:
                    best_ckpt = test_ckpt
                    best_metric = test_ckpt.metrics["F1@0.50"]
                ckpt_io.save_model(exp.model, ckptdir, global_step + 1)
                if cfg.TPU.save_opt_state:
                    ckpt_io.save_train_state(step.optimizer, ckptdir, global_step + 1)
            global_step += 1

    if best_ckpt is not None:
        print(f"Best Checkpoint: {best_ckpt.iteration}")
        best_ckpt.eval_edit = True
        best_ckpt.compute_metrics()
        best_ckpt.save(os.path.join(logdir, "best_ckpt.gz"))
    else:
        print("No evaluation performed during training (best checkpoint not available)")
    logger.finish()
    ckpt_io.write_finish_proof(logdir)
    return step, best_ckpt
