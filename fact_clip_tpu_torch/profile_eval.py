"""Where the time of the flagship eval step (or train step) goes on the card.

    python3 -m fact_clip_tpu_torch.profile_eval [--train] [--steps N] [--trace DIR]

Builds the flagship FACT model (iuUU, D=2048, C=75, M=40) with seeded random
weights and times one eval step of 8 videos padded to 3072 frames, on the
kernel path and on the plain PyTorch path: wall time (host clock around a
synchronised step), device busy time per step (the sum of the CUDA kernels'
own times under ``torch.profiler``), the idle share 1 - busy / wall, and the
kernels that take the most time.  With ``--train`` the step is the train
step of ``train_cfg()`` (dropout 0.2, channel masking 0.3, Adam) on seeded
batches with piecewise-constant labels.  Needs a CUDA card; f32 with TF32
off.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .configs import flagship_cfg, train_cfg
from .engine.steps import make_eval_step, make_train_step
from .engine.train_loop import batch_to_device, synthetic_batch
from .models.blocks import build_fact
from .models.losses import build_class_weights

LENGTHS = [3072, 3000, 2950, 2800, 2700, 2600, 2500, 2400]


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


def train_step_args(dev):
    """(step, args) of the flagship train step on seeded batches."""
    cfg = train_cfg()
    D, C, S_CAP, T, S = 2048, 75, 128, 3072, 32
    model = build_fact(cfg, D, C, S_CAP, device=dev, generator=torch.Generator().manual_seed(0))
    step = make_train_step(model, cfg, C, build_class_weights(cfg, C, []))
    batch = batch_to_device(synthetic_batch(np.random.default_rng(0), D, C, S, T, LENGTHS), dev)
    return model, step, (batch, torch.Generator(device=dev).manual_seed(0))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--train", action="store_true", help="the train step, not the eval step")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--trace", default="", help="directory for chrome traces")
    ap.add_argument("--top", type=int, default=25)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_eval needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    B, T, D = len(LENGTHS), 3072, 2048
    if a.train:
        model, step, args = train_step_args(dev)
    else:
        cfg = flagship_cfg()
        model = build_fact(cfg, D, 75, 128, device=dev,
                           generator=torch.Generator().manual_seed(0))
        lens = np.array(LENGTHS, np.int32)
        rng = np.random.default_rng(0)
        mask = np.arange(T)[None] < lens[:, None]
        x = rng.standard_normal((B, T, D)).astype(np.float32) * mask[..., None]
        args = (torch.from_numpy(x).to(dev), torch.from_numpy(mask).to(dev),
                torch.from_numpy(lens).to(dev))
        step = make_eval_step(model, cfg["FACT"]["mwt"])
    kind = "train" if a.train else "eval"
    print(f"device {torch.cuda.get_device_name(0)}; {kind} step of {B} x {T}, flagship")
    for kernels in (True, False):
        model.set_kernels(kernels)
        wall_ms(step, args, 3)  # warm: build, load, caches
        wall = wall_ms(step, args, a.steps)
        med = wall[len(wall) // 2]
        prof, ks = device_kernels(step, args, 3)
        busy = sum(ms for ms, _ in ks.values())
        path = "kernel path" if kernels else "plain path"
        print(f"[{path}] wall ms median {med:.3f} (all {', '.join(f'{t:.3f}' for t in wall)}); "
              f"device busy ms per step {busy:.3f}; idle share {1 - busy / med:.3f}")
        for name, (ms, cnt) in sorted(ks.items(), key=lambda kv: -kv[1][0])[:a.top]:
            print(f"  {ms:8.3f} ms x {cnt:5.1f}  {name[:100]}")
        if a.trace:
            os.makedirs(a.trace, exist_ok=True)
            name = "kernels" if kernels else "plain"
            prof.export_chrome_trace(os.path.join(a.trace, f"{kind}_{name}.json"))
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")


if __name__ == "__main__":
    main()
