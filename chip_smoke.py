#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA H100: build, kernels, serving.

    python3 chip_smoke.py

Phases, one line or more each; any failure ends the run with a non-zero exit:

1. environment: torch / CUDA versions, the card's name and power limit.
   There is no CPU fallback: without a card the script exits 1.
2. build: nvcc compiles fact_clip_tpu_torch/csrc/*.cu (timed).
3. kernels: every hand-written kernel against its plain PyTorch version on
   the card, at the flagship serving shapes and at one ragged case each,
   f32 with TF32 off; error against the stated tolerance, and the kernel's
   time beside the plain version's (CUDA events).
4. serving: the flagship FACT model (iuUU, D=2048, C=75, M=40,
   s_pred_cap=128) at full width with seeded random weights, loaded through
   a state_dict round trip, serves ~10 requests through
   ``Predictor(batch_size=8).predict``.  Every kernel must have launched
   during that call.  Then the warm time of ``predict`` on 8 requests that
   fill one 8 x 3072 batch, the warm time of the eval step alone on such a
   batch, and the kernel path against the plain path on one batch.
5. the JSON line of kernel results, the nvidia-smi line, and last the
   contract line {"ok": true, "device": {...}}.

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP_LENGTHS = [3072, 3000, 2950, 2800, 2700, 2600, 2500, 2400]
REL_TOL = 2e-4  # max |kernel - plain| / max(1, max |plain|): f32, other summation order
PROB_TOL = 1e-5  # absolute, on probabilities
LOGIT_TOL = 1e-3  # block-0 frame logits, whole model, kernel vs plain path
MIN_AGREE = 0.95  # share of valid frames whose final prediction agrees


def log(msg):
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def phase_environment(torch):
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this smoke test needs an "
              "NVIDIA GPU (no CPU fallback)", file=sys.stderr)
        sys.exit(1)
    smi = nvidia_smi_line()
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    log(f"[env] nvidia-smi: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build(verbose: bool = False):
    """Build the kernels of the package that sits beside this script, and
    nothing installed elsewhere."""
    if not os.path.isdir(os.path.join(REPO, "fact_clip_tpu_torch", "csrc")):
        print("chip_smoke: fact_clip_tpu_torch/ is not beside this script: run it from the "
              "root of a checkout of the repo", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, REPO)
    import fact_clip_tpu_torch
    from fact_clip_tpu_torch import _build

    if not os.path.abspath(fact_clip_tpu_torch.__file__).startswith(REPO + os.sep):
        raise RuntimeError(f"imported {fact_clip_tpu_torch.__file__}, not the checkout's package")
    t0 = time.perf_counter()
    path, out = _build.build(verbose=verbose)
    _build.lib()
    log(f"[build] {path} in {time.perf_counter() - t0:.1f} s")
    if verbose and out:
        log(out)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def compare(name, outs, refs):
    """Worst relative error of the kernel outputs against the plain ones.
    Entries at -1e9 (masked logits) must match exactly and are left out."""
    import torch

    worst_abs, worst_rel = 0.0, 0.0
    for o, r in zip(outs, refs):
        if not torch.isfinite(o).all():
            raise AssertionError(f"{name}: non-finite kernel output")
        masked = r <= -1e8
        if not torch.equal(o[masked], r[masked]):
            raise AssertionError(f"{name}: masked logits differ from -1e9")
        d = (o - r).abs().masked_fill(masked, 0.0)
        scale = max(1.0, float(r.masked_fill(masked, 0.0).abs().max()))
        worst_abs = max(worst_abs, float(d.max()))
        worst_rel = max(worst_rel, float(d.max()) / scale)
    return worst_abs, worst_rel


def _rand(rng, shape, scale=1.0):
    import torch

    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).cuda()


def _uniform(rng, shape, fan_in):
    import torch

    b = 1.0 / math.sqrt(fan_in)
    return torch.from_numpy(rng.uniform(-b, b, shape).astype(np.float32)).cuda()


def _lens(vals):
    import torch

    return torch.tensor(vals, dtype=torch.int32, device="cuda")


def k1_case(rng, B, T, C, O, dilations, lengths, use_ln):
    layers = []
    for _ in dilations:
        layers.append((_uniform(rng, (3, C, C), 3 * C), _uniform(rng, (C,), 3 * C),
                       _uniform(rng, (C, C), C), _uniform(rng, (C,), C),
                       1.0 + _rand(rng, (C,), 0.2 if use_ln else 0.0),
                       _rand(rng, (C,), 0.2 if use_ln else 0.0)))
    args = (_rand(rng, (B, T, C)), _lens(lengths), layers, dilations)
    kw = dict(use_ln=use_ln, eps=1e-5, out_w=_uniform(rng, (C, O), C),
              out_b=_uniform(rng, (O,), C))
    return args, kw


def x2y_case(rng, B, Y, X, Cy, Cx, d, x_len, y_pos, x_pos):
    return (_rand(rng, (B, Y, Cy)), y_pos, _rand(rng, (B, X, Cx)), x_pos,
            _uniform(rng, (Cx, d), Cx), _uniform(rng, (d,), Cx),
            _uniform(rng, (Cx, d), Cx), _uniform(rng, (d,), Cx),
            _uniform(rng, (Cy, d), Cy), _uniform(rng, (d,), Cy), _lens(x_len)), {}


def mha_case(rng, B, M, X, E, Cx, H, x_len, pos):
    def xavier(shape):
        import torch

        b = math.sqrt(6.0 / (shape[0] + shape[1]))
        return torch.from_numpy(rng.uniform(-b, b, shape).astype(np.float32)).cuda()
    return (_rand(rng, (B, M, E)), _rand(rng, (B, X, Cx)), pos, xavier((Cx, E)),
            _rand(rng, (E,), 0.02), xavier((Cx, E)), _rand(rng, (E,), 0.02),
            _lens(x_len)), dict(num_heads=H)


def sa_case(rng, B, M, E, H):
    import torch

    def xavier():
        b = math.sqrt(6.0 / (2 * E))
        return torch.from_numpy(rng.uniform(-b, b, (E, E)).astype(np.float32)).cuda()
    return (_rand(rng, (B, M, E)), _rand(rng, (1, M, E)), xavier(), _rand(rng, (E,), 0.02),
            xavier(), _rand(rng, (E,), 0.02), xavier(), _rand(rng, (E,), 0.02),
            _uniform(rng, (E, E), E), _rand(rng, (E,), 0.02), 1.0 + _rand(rng, (E,), 0.1),
            _rand(rng, (E,), 0.1)), dict(num_heads=H)


def ffn_case(rng, B, M, E, Fd):
    return (_rand(rng, (B, M, E)), _uniform(rng, (E, Fd), E), _uniform(rng, (Fd,), E),
            _uniform(rng, (Fd, E), Fd), _uniform(rng, (E,), Fd), 1.0 + _rand(rng, (E,), 0.1),
            _rand(rng, (E,), 0.1)), {}


def kernel_table():
    """(name, source, replaces, kernel fn, plain fn, flagship case, ragged case)."""
    import torch

    from fact_clip_tpu_torch.ops import dilated_conv, mha_attn, sa_layer, x2y_attn

    zeros = lambda *s: torch.zeros(s, device="cuda")  # noqa: E731
    B, T, D = 8, 3072, 512
    return [
        ("mstcn_stack", "fact_clip_tpu_torch/csrc/mstcn.cu",
         "fact_clip_tpu/ops/pallas/dilated_conv.py:311",
         dilated_conv.mstcn_stack_fwd, dilated_conv.mstcn_stack_reference,
         lambda r: k1_case(r, B, T, 256, D, [2 ** i for i in range(10)], FLAGSHIP_LENGTHS,
                           False),
         lambda r: k1_case(r, 2, 1000, 256, D, [1, 64, 512], [1000, 777], True)),
        ("x2y_small_x", "fact_clip_tpu_torch/csrc/x2y_attn.cu",
         "fact_clip_tpu/ops/pallas/x2y_attn.py:76",
         x2y_attn.x2y_small_x_fwd, x2y_attn.x2y_attention_reference,
         lambda r: x2y_case(r, B, T, 40, D, D, D, [40] * B, zeros(1, T, D),
                            _rand(r, (1, 40, 256))),
         lambda r: x2y_case(r, 2, 1000, 37, D, D, D, [37, 20], _rand(r, (2, 1000, D)),
                            _rand(r, (1, 37, D)))),
        ("x2y_flash", "fact_clip_tpu_torch/csrc/flash_attn.cu",
         "fact_clip_tpu/ops/pallas/x2y_attn.py:159",
         x2y_attn.x2y_flash_fwd, x2y_attn.x2y_attention_reference,
         lambda r: x2y_case(r, B, 40, T, D, D, D, FLAGSHIP_LENGTHS, _rand(r, (1, 40, 256)),
                            zeros(1, T, D)),
         lambda r: x2y_case(r, 2, 37, 2000, D, D, D, [2000, 1500], _rand(r, (1, 37, D)),
                            _rand(r, (1, 2000, D)))),
        ("mha_cross", "fact_clip_tpu_torch/csrc/flash_attn.cu",
         "fact_clip_tpu/ops/pallas/mha_attn.py:235",
         mha_attn.mha_cross_fwd, mha_attn.mha_cross_attention_reference,
         lambda r: mha_case(r, B, 40, T, 256, D, 8, FLAGSHIP_LENGTHS, zeros(1, T, D)),
         lambda r: mha_case(r, 2, 37, 1100, 256, D, 8, [1100, 900], _rand(r, (1, 1100, D)))),
        ("sa_sublayer", "fact_clip_tpu_torch/csrc/sa_layer.cu",
         "fact_clip_tpu/ops/pallas/sa_layer.py:336",
         sa_layer.sa_sublayer, sa_layer.sa_sublayer_reference,
         lambda r: sa_case(r, B, 40, 256, 8), lambda r: sa_case(r, 3, 37, 256, 8)),
        ("ffn_sublayer", "fact_clip_tpu_torch/csrc/sa_layer.cu",
         "fact_clip_tpu/ops/pallas/sa_layer.py:422",
         sa_layer.ffn_sublayer, sa_layer.ffn_sublayer_reference,
         lambda r: ffn_case(r, B, 40, 256, 512), lambda r: ffn_case(r, 3, 37, 256, 512)),
    ]


def phase_kernels(seed: int = 0):
    import torch

    results = {}
    failed = []
    rng = np.random.default_rng(seed)
    with torch.inference_mode():
        for name, source, replaces, kern, plain, flagship, ragged in kernel_table():
            for case_name, make in (("flagship", flagship), ("ragged", ragged)):
                args, kw = make(rng)
                out = kern(*args, **kw)
                ref = plain(*args, **kw)
                torch.cuda.synchronize()
                outs = out if isinstance(out, tuple) else (out,)
                refs = ref if isinstance(ref, tuple) else (ref,)
                err_abs, err_rel = compare(f"{name}/{case_name}", outs, refs)
                ok = err_rel <= REL_TOL
                if name.startswith("x2y"):  # probabilities: absolute bound
                    p_err = float((outs[1] - refs[1]).abs().max())
                    ok = ok and p_err <= PROB_TOL
                    extra = f" probs_abs_err {p_err:.3e} (tol {PROB_TOL:g})"
                else:
                    extra = ""
                line = (f"[kernel] {name:<12} {case_name:<8} max_abs_err {err_abs:.3e} "
                        f"max_rel_err {err_rel:.3e} (tol {REL_TOL:g}){extra}")
                if case_name == "flagship":
                    iters = 5 if name == "mstcn_stack" else 20
                    ms = cuda_ms(lambda: kern(*args, **kw), iters)
                    plain_ms = cuda_ms(lambda: plain(*args, **kw), iters)
                    line += f" ms {ms:.4f} plain_ms {plain_ms:.4f}"
                    results[name] = dict(name=name, route="cuda", source=source,
                                         replaces=replaces, max_abs_err=err_abs,
                                         ms=ms, plain_ms=plain_ms)
                log(line + ("" if ok else "  FAIL"))
                if not ok:
                    failed.append(f"{name}/{case_name}")
                del args, kw, out, ref, outs, refs
    if failed:
        raise AssertionError(f"kernels disagree with their plain versions: {failed}")
    return results


# ---------------------------------------------------------------------------
# phase 4: the flagship serving path


def phase_serving(seed: int = 0):
    import torch

    from fact_clip_tpu_torch import kernel_counters, reset_kernel_counters
    from fact_clip_tpu_torch.configs import flagship_cfg
    from fact_clip_tpu_torch.engine.serve import Predictor
    from fact_clip_tpu_torch.engine.steps import make_eval_step
    from fact_clip_tpu_torch.models.blocks import build_fact

    D, C, S_CAP = 2048, 75, 128
    cfg = flagship_cfg()
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    src = build_fact(cfg, D, C, S_CAP, device=dev,
                     generator=torch.Generator(device="cpu").manual_seed(seed))
    model = build_fact(cfg, D, C, S_CAP, device=dev,
                       generator=torch.Generator(device="cpu").manual_seed(seed + 1))
    model.load_state_dict(src.state_dict(), strict=True)  # the reference-key layout
    for (k, a), b in zip(src.state_dict().items(), model.state_dict().values()):
        if not torch.equal(a, b):
            raise AssertionError(f"state_dict round trip changed {k}")
    del src
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[serve] flagship model: {n_params} parameters, built and reloaded in "
        f"{time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(seed)
    lengths = [int(rng.integers(2400, 3001)) for _ in range(6)]
    lengths += [int(rng.integers(600, 1001)) for _ in range(4)]
    feats = [rng.standard_normal((n, D)).astype(np.float32) for n in lengths]
    pred = Predictor(model, mwt=cfg["FACT"]["mwt"], batch_size=8, max_len=3072, device=dev)

    pred.predict(feats[:1])  # first call: builds/loads the kernels
    torch.cuda.synchronize()
    reset_kernel_counters()
    t0 = time.perf_counter()
    outs = pred.predict(feats)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = kernel_counters()
    for n, o in zip(lengths, outs):
        if o.shape != (n,) or o.dtype != np.int32 or o.min() < 0 or o.max() >= C:
            raise AssertionError(f"bad prediction: shape {o.shape} dtype {o.dtype}")
    log(f"[serve] predict: {len(feats)} requests, lengths {lengths}, {dt:.3f} s; "
        f"launch counts {counts}")
    missing = [k for k, v in counts.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the serving path: {missing}")

    # warm predict of 8 requests that fill one batch of the 3072 bucket:
    # host-side padding, the copy to the card, the eval step and the trim
    B, T = 8, 3072
    full = [rng.standard_normal((int(n), D)).astype(np.float32)
            for n in rng.integers(pred.buckets[-2] + 1, T + 1, B)]
    times = []
    for _ in range(4):
        t0 = time.perf_counter()
        outs = pred.predict(full)
        times.append((time.perf_counter() - t0) * 1e3)
    if [o.shape for o in outs] != [(len(f),) for f in full]:
        raise AssertionError("bad prediction shapes for the full batch")
    log(f"[serve] predict 8 requests, one batch of 8 x {T}, warm ms: median "
        f"{sorted(times[1:])[1]:.3f} (all {', '.join(f'{t:.3f}' for t in times)})")
    del full

    # warm time of the eval step alone on one full batch of the largest bucket
    blen = np.array(FLAGSHIP_LENGTHS, np.int32)
    bfeats = np.zeros((B, T, D), np.float32)
    for i, n in enumerate(blen):
        bfeats[i, :n] = rng.standard_normal((n, D)).astype(np.float32)
    x = torch.from_numpy(bfeats).to(dev)
    mask = torch.from_numpy(np.arange(T)[None, :] < blen[:, None]).to(dev)
    lens = torch.from_numpy(blen).to(dev)
    step = make_eval_step(model, cfg["FACT"]["mwt"])

    def warm_ms(n=6):
        times = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(x, mask, lens)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return out, times

    def summary(times):
        w = sorted(times[1:])
        return (f"median {w[len(w) // 2]:.3f} min {w[0]:.3f} max {w[-1]:.3f} "
                f"(all {', '.join(f'{t:.3f}' for t in times)})")

    p_kernel, times = warm_ms()
    log(f"[serve] eval step 8 x 3072 warm ms, kernels: {summary(times)}")

    # kernel path against the plain path (TPU.pallas=False counterpart) on one batch
    with torch.inference_mode():
        saves_k, _ = model(x, mask, lens)
        model.set_kernels(False)
        saves_p, _ = model(x, mask, lens)
    p_plain, times = warm_ms()
    model.set_kernels(True)
    log(f"[serve] eval step 8 x 3072 warm ms, plain path: {summary(times)}")
    valid = mask
    fl_err = float((saves_k[0]["frame_clogit"] - saves_p[0]["frame_clogit"]).abs()[valid].max())
    agree = float((p_kernel == p_plain)[valid].float().mean())
    log(f"[serve] kernel vs plain path: block-0 frame logits max_abs_err {fl_err:.3e} "
        f"(tol {LOGIT_TOL:g}); final predictions agree on {agree:.5f} of valid frames "
        f"(min {MIN_AGREE})")
    if not (fl_err <= LOGIT_TOL and agree >= MIN_AGREE):
        raise AssertionError("kernel path disagrees with the plain path")
    return counts


def main():
    import torch

    smi = phase_environment(torch)
    phase_build(verbose="--ptxas" in sys.argv)
    results = phase_kernels()
    counts = phase_serving()
    for name, r in results.items():
        r["launches"] = counts[name]
    kernels = [results[n] for n in results]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
