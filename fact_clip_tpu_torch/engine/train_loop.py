"""A minimal training loop: numpy batches to the card, one train step each.

The start of a counterpart of ``fact_clip_tpu/engine/train_loop.py``
(``run_train``): batches arrive in the numpy layout of
``fact_clip_tpu/data/batching.py::Batch.device_arrays`` (a loader that
imports no JAX), are copied to the train step's device and stepped.
``synthetic_batch`` makes a seeded batch in that layout, ``epic_batch``
one of long verb/noun videos, and ``synthetic_set_stats`` the dataset
statistics a config's ``nullw = -1`` is resolved from
(``models/losses.py::compute_null_weight``).  Checkpoints,
evaluation, logging and the command line are not ported yet.
"""

from __future__ import annotations

import types

import numpy as np
import torch

BATCH_KEYS = ("feats", "mask", "labels", "seg_label", "transcript", "seg_mask", "lengths")


def _host(a) -> np.ndarray:
    a = np.ascontiguousarray(a)
    return a if a.flags.writeable else a.copy()


def batch_to_device(arrays: dict, device) -> dict:
    """``Batch.device_arrays`` (numpy) -> the same dict of tensors on ``device``."""
    return {k: torch.from_numpy(_host(arrays[k])).to(device) for k in BATCH_KEYS}


def run_steps(train_step, batches, *, generator: torch.Generator, times=None) -> list:
    """Step ``train_step`` once per numpy batch; returns each step's output
    (loss and per-video loss as host floats).  The generator must live on
    the step's device, which is where the batches go."""
    device = train_step.device
    if torch.device(generator.device).type != device.type:
        raise ValueError(f"generator on {generator.device}, train step on {device}")
    outs = []
    for arrays in batches:
        out = train_step(batch_to_device(arrays, device), generator, times=times)
        outs.append({"loss": float(out["loss"]),
                     "per_video_loss": out["per_video_loss"].cpu().numpy(),
                     "pred": out["pred"], "seg2tok": out["seg2tok"]})
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
