"""Where the time of an eval step (or train step) goes on the card.

    python3 -m fact_clip_tpu_torch.profile_eval
        [--cfg flagship|int8|breakfast|breakfast_int8|epic|epic_int8|egoprocel]
        [--train] [--steps N] [--trace DIR]

Builds the flagship FACT model (iuUU, D=2048, C=75, M=40), or with
``--cfg int8`` the same model evaluated with int8 (``flagship_int8_cfg()``:
its towers, their in map, the X2Y projections over the frames and the SCA
key / value projections on int8 operands; the plain path is its int8 plain
versions; ``--train`` trains it as the flagship trains), or with
``--cfg breakfast`` the Breakfast model (``breakfast_cfg()``: MS-TCN++
towers, every width 512, D=2048, 48 classes, M=60), or with ``--cfg epic``
the verb/noun model (``epic_cfg()``: IUUU, D=1024, 98 verbs x 301 nouns,
3,806 actions, M=300, ``s_pred_cap`` 256), or with ``--cfg breakfast_int8``
/ ``epic_int8`` those two evaluated with int8 (``breakfast_int8_cfg()`` /
``epic_int8_cfg()``: the MS-TCN++ towers through K8e; ``--train`` trains
them as their f32 twins train), or with ``--cfg egoprocel`` the EgoProceL
model (``egoprocel_cfg()``: iUUU, 200 action tokens, D=2048, 64 classes),
with seeded random weights and
times one eval step of 8 videos padded to 3072 frames (Breakfast: 4096;
epic: one video of 24,576; egoprocel: 4096 and 3072 frames padded to
4096), on the kernel path and on the plain PyTorch
path: wall time (host clock around a synchronised step), device busy time
per step (the sum of the CUDA kernels' own times under ``torch.profiler``),
the idle share 1 - busy / wall, the device launches per step, the peak
device memory, and the kernels that take the most time.  With ``--train``
the step is the train step of ``train_cfg()`` (every kernel on,
dropout 0.2, channel masking 0.3, Adam) on a seeded batch of 8 x 3072 with
piecewise-constant labels, or of ``breakfast_train_cfg()`` (dropout 0,
channel masking 0.3, time masking, nullw resolved from the batch) on 4 x
4096, or of ``epic_train_cfg()`` (channel masking 0.3, o2m matching, the
verb/noun losses) on one 24,576-frame video of ``engine.train_loop.
epic_batch``, or of ``egoprocel_train_cfg()`` (channel masking 0.3, nullw
resolved from the batch) on one 4,096-frame video.  Needs a CUDA card; f32
with TF32 off.
"""

from __future__ import annotations

import argparse
import functools
import os
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .configs import (breakfast_cfg, breakfast_int8_cfg, breakfast_train_cfg, egoprocel_cfg,
                      egoprocel_train_cfg, epic_cfg, epic_int8_cfg, epic_train_cfg, epic_vocab,
                      flagship_cfg, flagship_int8_cfg, train_cfg)
from .engine.setup import resolve_device
from .engine.steps import make_eval_step, make_train_step
from .engine.train_loop import batch_to_device, epic_batch, synthetic_batch, synthetic_set_stats
from .models.blocks import build_fact
from .models.losses import build_class_weights, compute_null_weight
from .models.verbnoun import build_verbnoun_fact


def _build_epic(cfg, D, C, s_pred_cap, **kw):
    """``build_fact``'s signature; the vocabulary is ``epic_vocab()``'s."""
    return build_verbnoun_fact(cfg, D, *epic_vocab(), s_pred_cap, **kw)


_synthetic = functools.partial(synthetic_batch, S=32)  # up to 32 segments a video

# (eval config, train config, D, classes, s_pred_cap, padded T, the eval videos' lengths,
#  the model builder, the train batch maker (rng, D, classes, T=, lengths=))
SETUPS = {
    "flagship": (flagship_cfg, train_cfg, 2048, 75, 128, 3072,
                 [3072, 3000, 2950, 2800, 2700, 2600, 2500, 2400], build_fact, _synthetic),
    "int8": (flagship_int8_cfg, train_cfg, 2048, 75, 128, 3072,
             [3072, 3000, 2950, 2800, 2700, 2600, 2500, 2400], build_fact, _synthetic),
    "breakfast": (breakfast_cfg, breakfast_train_cfg, 2048, 48, 64, 4096,
                  [4096, 4050, 3980, 3900, 3700, 3500, 3300, 3100], build_fact, _synthetic),
    "epic": (epic_cfg, epic_train_cfg, 1024, 3806, 256, 24576, [24576], _build_epic,
             epic_batch),
    "egoprocel": (egoprocel_cfg, egoprocel_train_cfg, 2048, 64, 64, 4096, [4096, 3072],
                  build_fact, _synthetic),
}
SETUPS["breakfast_int8"] = (breakfast_int8_cfg, *SETUPS["breakfast"][1:])
SETUPS["epic_int8"] = (epic_int8_cfg, *SETUPS["epic"][1:])
TRAIN_LENGTHS = {"flagship": SETUPS["flagship"][6], "int8": SETUPS["flagship"][6],
                 "breakfast": [4096, 3600, 2500, 1400], "breakfast_int8": [4096, 3600, 2500, 1400],
                 "epic": [24576], "epic_int8": [24576], "egoprocel": [4096]}


def wall_ms(step, args, n):
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(*args)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)


def device_kernels(step, args, n):
    """{kernel name: (ms per step, launches per step)} of the CUDA kernels."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step(*args)
        torch.cuda.synchronize()
    return prof, {e.key: (e.self_device_time_total / n / 1e3, e.count / n)
                  for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


def train_step_args(name, dev):
    """(model, step, args) of the train step of ``name`` on a seeded batch;
    a config's ``nullw = -1`` is resolved from that batch."""
    _, make_train_cfg, D, C, S_CAP, T, _, build, make_batch = SETUPS[name]
    batch = make_batch(np.random.default_rng(0), D, C, T=T, lengths=TRAIN_LENGTHS[name])
    cfg = make_train_cfg()
    if cfg["Loss"]["nullw"] < 0:
        cfg = compute_null_weight(cfg, synthetic_set_stats([batch], C))
    model = build(cfg, D, C, S_CAP, device=dev, generator=torch.Generator().manual_seed(0))
    step = make_train_step(model, cfg, C, build_class_weights(cfg, C, []))
    return model, step, (batch_to_device(batch, dev), torch.Generator(device=dev).manual_seed(0))


def eval_step_args(name, dev):
    """(model, step, args) of the eval step of ``name`` on seeded features."""
    make_cfg, _, D, C, S_CAP, T, lengths, build, _ = SETUPS[name]
    cfg = make_cfg()
    model = build(cfg, D, C, S_CAP, device=dev, generator=torch.Generator().manual_seed(0))
    lens = np.array(lengths, np.int32)
    mask = np.arange(T)[None] < lens[:, None]
    x = np.random.default_rng(0).standard_normal((len(lens), T, D)).astype(np.float32)
    args = (torch.from_numpy(x * mask[..., None]).to(dev), torch.from_numpy(mask).to(dev),
            torch.from_numpy(lens).to(dev))
    return model, make_eval_step(model, cfg["FACT"]["mwt"]), args


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cfg", choices=sorted(SETUPS), default="flagship")
    ap.add_argument("--train", action="store_true", help="the train step, not the eval step")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--trace", default="", help="directory for chrome traces")
    ap.add_argument("--top", type=int, default=25)
    a = ap.parse_args()
    dev = resolve_device(None)  # the card, TF32 off
    model, step, args = (train_step_args if a.train else eval_step_args)(a.cfg, dev)
    B, T = args[0]["feats"].shape[:2] if a.train else args[0].shape[:2]
    kind = "train" if a.train else "eval"
    print(f"device {torch.cuda.get_device_name(0)}; {kind} step of {B} x {T}, {a.cfg}")
    for kernels in (True, False):
        model.set_kernels(kernels)
        wall_ms(step, args, 3)  # warm: build, load, caches
        torch.cuda.reset_peak_memory_stats()
        wall = wall_ms(step, args, a.steps)
        med = wall[len(wall) // 2]
        prof, ks = device_kernels(step, args, 3)
        busy = sum(ms for ms, _ in ks.values())
        launches = sum(cnt for _, cnt in ks.values())
        path = "kernel path" if kernels else "plain path"
        print(f"[{path}] wall ms median {med:.3f} (all {', '.join(f'{t:.3f}' for t in wall)}); "
              f"device busy ms per step {busy:.3f}; idle share {1 - busy / med:.3f}; "
              f"device launches per step {launches:.0f}; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        for name, (ms, cnt) in sorted(ks.items(), key=lambda kv: -kv[1][0])[:a.top]:
            print(f"  {ms:8.3f} ms x {cnt:5.1f}  {name[:100]}")
        if a.trace:
            os.makedirs(a.trace, exist_ok=True)
            name = "kernels" if kernels else "plain"
            prof.export_chrome_trace(os.path.join(a.trace, f"{a.cfg}_{kind}_{name}.json"))


if __name__ == "__main__":
    main()
