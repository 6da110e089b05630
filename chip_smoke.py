#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA H100: build, kernels,
serving, training.

    python3 chip_smoke.py

Phases, one line or more each; any failure ends the run with a non-zero exit:

1. environment: torch / CUDA versions, the card's name and power limit.
   There is no CPU fallback: without a card the script exits 1.
2. build: nvcc compiles fact_clip_tpu_torch/csrc/*.cu (timed).
3. kernels: every hand-written kernel against its plain PyTorch version on
   the card, at the flagship shapes and at ragged cases, f32 with TF32 off;
   error against the stated tolerance, and the kernel's time beside the
   plain version's (CUDA events).  The serving kernels (K1-K4 forwards),
   then the training kernels (the K1 dropout mask, bit-equal; the K1 and K2
   backwards; the K5 frame loss).
4. serving: the flagship FACT model (iuUU, D=2048, C=75, M=40,
   s_pred_cap=128) at full width with seeded random weights, loaded through
   a state_dict round trip, serves ~10 requests through
   ``Predictor(batch_size=8).predict``.  Every serving kernel must have
   launched during that call.  Then the warm time of ``predict`` on 8
   requests that fill one 8 x 3072 batch, the warm time of the eval step
   alone on such a batch, and the kernel path against the plain path.
5. training: ``train_cfg()`` at full width with seeded weights takes one
   warm-up step and 5 Adam steps through ``run_steps`` on 8 seeded videos
   with piecewise-constant labels in the 8 x 3072 bucket, dropout 0.2 and
   channel masking 0.3.  Every loss must be finite and every training
   kernel must have launched during the 5 steps.  Then the warm step time
   of the kernel path and of the plain path, each split into forward, host
   match, losses, backward and optimizer, with peak memory; and, with
   dropout and masking off, one kernel-path step against the plain-path
   step on the same batch (loss, matching, every gradient).
6. the JSON line of kernel results, the nvidia-smi line, and last the
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
TRAIN_LOSS_TOL = 1e-4  # relative, kernel-path vs plain-path train loss
GRAD_TOL = 1e-3  # max |kernel - plain| / max |plain| per parameter (floored, below)
SERVING_KERNELS = ("mstcn_stack", "x2y_small_x", "x2y_flash", "mha_cross", "sa_sublayer",
                   "ffn_sublayer")
TRAIN_KERNELS = ("mstcn_stack", "mstcn_dropout_mask", "mstcn_stack_bwd", "x2y_small_x",
                 "x2y_small_x_bwd", "x2y_flash", "x2y_flash_bwd", "frame_loss_fwd",
                 "frame_loss_bwd")


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


def _flat(out):
    """The tensors of a kernel's result, in order, None entries kept."""
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _flat(o)]
    return [out]


def _pairs(name, outs, refs):
    outs, refs = _flat(outs), _flat(refs)
    if len(outs) != len(refs) or any((o is None) != (r is None) for o, r in zip(outs, refs)):
        raise AssertionError(f"{name}: kernel and plain results differ in structure")
    return [o for o in outs if o is not None], [r for r in refs if r is not None]


def k1_bwd_case(rng, B, T, C, O, dilations, lengths, use_ln, rate=0.2):
    """The tower's backward from the kernel forward's saves, dropout on; the
    plain backward takes the same saves (a recomputed forward could put a
    ReLU input on the other side of 0 at a few of the 63M activations)."""
    import torch

    from fact_clip_tpu_torch.ops import dilated_conv as dc

    (x, lens, layers, dil), kw = k1_case(rng, B, T, C, O, dilations, lengths, use_ln)
    kw.update(rates=[rate] * len(dil),
              seeds=torch.tensor(rng.integers(0, 2 ** 31 - 1, len(dil)), dtype=torch.int32,
                                 device="cuda"))
    g = _rand(rng, (B, T, O), 0.01)
    _, streams, acts = dc.mstcn_stack_fwd(x, lens, layers, dil, save=True, **kw)
    return (lambda: dc.mstcn_stack_bwd(g, streams, acts, lens, layers, dil, **kw),
            lambda: dc.mstcn_stack_bwd_reference(g, streams, acts, lens, layers, dil, **kw))


def x2y_bwd_case(rng, flash, *shape):
    from fact_clip_tpu_torch.ops import x2y_attn as xa

    args, _ = x2y_case(rng, *shape)
    attn, probs, logits = (xa.x2y_flash_fwd if flash else xa.x2y_small_x_fwd)(*args)
    g_attn = _rand(rng, attn.shape)
    g_probs, g_logits = _rand(rng, probs.shape, 0.1), _rand(rng, logits.shape, 0.1)
    if flash:
        kern = lambda: xa.x2y_flash_bwd(*args, probs, attn, g_attn, g_probs, g_logits)  # noqa: E731
    else:
        kern = lambda: xa.x2y_small_x_bwd(*args, probs, g_attn, g_probs, g_logits)  # noqa: E731
    return kern, lambda: xa.x2y_bwd_reference(*args, probs, g_attn, g_probs, g_logits)


def frame_loss_case(rng, backward, B, T, C, lengths, with_ce=True):
    import torch

    from fact_clip_tpu_torch.ops import frame_loss as fl

    # frame logits are piecewise constant in time plus noise, as a model's
    # are; white noise at this scale would put some squared differences
    # within rounding of the clip at 16, where the gradient jumps
    seg = np.arange(T) // 97
    x = _rand(rng, (B, T // 97 + 1, C), 3.0)[:, seg] + _rand(rng, (B, T, C), 0.3)
    labels = torch.tensor(rng.integers(0, C, (B, T)), dtype=torch.int32, device="cuda")
    maskf = (torch.arange(T, device="cuda")[None] < _lens(lengths)[:, None]).float()
    cw = torch.from_numpy(rng.uniform(0.1, 1.0, C).astype(np.float32)).cuda()
    args = (x, labels if with_ce else None, maskf, cw if with_ce else None)
    if backward:
        g = (_rand(rng, (B,)), _rand(rng, (B,)))
        return (lambda: fl.frame_loss_bwd(*args, *g),
                lambda: fl.frame_loss_bwd_reference(*args, *g))
    return lambda: fl.frame_loss_fwd(*args), lambda: fl.frame_loss_reference(*args)


def mask_case(rng, shape, rate=0.2):
    import torch

    from fact_clip_tpu_torch.ops import dilated_conv as dc

    seed = torch.tensor([int(rng.integers(0, 2 ** 31 - 1))], dtype=torch.int32, device="cuda")
    layer = int(rng.integers(0, 25))
    return (lambda: dc.mstcn_dropout_mask(seed, layer, shape, rate),
            lambda: dc.dropout_mask_reference(seed, layer, shape, rate))


def train_kernel_table():
    """(name, source, replaces, [(case, make(rng) -> (kernel fn, plain fn))]);
    the first case is the flagship's and is timed."""
    import torch

    B, T, D = 8, 3072, 512
    zeros = lambda *s: torch.zeros(s, device="cuda")  # noqa: E731
    ragged_k1 = lambda r: k1_bwd_case(r, 2, 1000, 256, D, [1, 64, 512], [1000, 777], True)  # noqa: E731
    return [
        ("mstcn_dropout_mask", "fact_clip_tpu_torch/csrc/mstcn.cu",
         "fact_clip_tpu/ops/pallas/dilated_conv.py:97",
         [("flagship", lambda r: mask_case(r, (B, T, 256))),
          ("ragged", lambda r: mask_case(r, (2, 1000, 37)))]),
        ("mstcn_stack_bwd", "fact_clip_tpu_torch/csrc/mstcn.cu",
         "fact_clip_tpu/ops/pallas/dilated_conv.py:689",
         [("flagship", lambda r: k1_bwd_case(r, B, T, 256, D, [2 ** i for i in range(10)],
                                             FLAGSHIP_LENGTHS, False)),
          ("ragged", ragged_k1)]),
        ("x2y_small_x_bwd", "fact_clip_tpu_torch/csrc/x2y_bwd.cu",
         "fact_clip_tpu/ops/pallas/x2y_attn.py:430",
         [("flagship", lambda r: x2y_bwd_case(r, False, B, T, 40, D, D, D, [40] * B,
                                              zeros(1, T, D), _rand(r, (1, 40, 256)))),
          ("tdu", lambda r: x2y_bwd_case(r, False, B, 40, 128, D, D, D, [128, 90] * 4,
                                         _rand(r, (1, 40, 256)), _rand(r, (B, 128, D)))),
          ("ragged", lambda r: x2y_bwd_case(r, False, 2, 1000, 37, D, D, D, [37, 20],
                                            _rand(r, (1, 1000, D)), _rand(r, (2, 37, D))))]),
        ("x2y_flash_bwd", "fact_clip_tpu_torch/csrc/x2y_bwd.cu",
         "fact_clip_tpu/ops/pallas/x2y_attn.py:282",
         [("flagship", lambda r: x2y_bwd_case(r, True, B, 40, T, D, D, D, FLAGSHIP_LENGTHS,
                                              _rand(r, (1, 40, 256)), zeros(1, T, D))),
          ("ragged", lambda r: x2y_bwd_case(r, True, 2, 37, 2000, D, D, D, [2000, 1500],
                                            _rand(r, (1, 37, D)), _rand(r, (1, 2000, D))))]),
        ("frame_loss_fwd", "fact_clip_tpu_torch/csrc/frame_loss.cu",
         "fact_clip_tpu/ops/pallas/frame_loss.py:185",
         [("flagship", lambda r: frame_loss_case(r, False, B, T, 75, FLAGSHIP_LENGTHS)),
          ("smooth", lambda r: frame_loss_case(r, False, B, T, 40, FLAGSHIP_LENGTHS, False)),
          ("ragged", lambda r: frame_loss_case(r, False, 2, 1000, 37, [1000, 777]))]),
        ("frame_loss_bwd", "fact_clip_tpu_torch/csrc/frame_loss.cu",
         "fact_clip_tpu/ops/pallas/frame_loss.py:212",
         [("flagship", lambda r: frame_loss_case(r, True, B, T, 75, FLAGSHIP_LENGTHS)),
          ("smooth", lambda r: frame_loss_case(r, True, B, T, 40, FLAGSHIP_LENGTHS, False)),
          ("ragged", lambda r: frame_loss_case(r, True, 2, 1000, 37, [1000, 777]))]),
    ]


def phase_train_kernels(seed: int = 1):
    """The training path's kernels against their plain versions (phase 3, cont.)."""
    import torch

    results = {}
    failed = []
    rng = np.random.default_rng(seed)
    for name, source, replaces, cases in train_kernel_table():
        for case_name, make in cases:
            kern, plain = make(rng)
            outs, refs = _pairs(name, kern(), plain())
            torch.cuda.synchronize()
            if name == "mstcn_dropout_mask":
                keep = float((outs[0] > 0).double().mean())
                err_abs = float((outs[0] - refs[0]).abs().max())
                ok = torch.equal(outs[0], refs[0]) and abs(keep - 0.8) <= 0.005
                line = (f"[kernel] {name:<18} {case_name:<8} bit-equal "
                        f"{torch.equal(outs[0], refs[0])} keep rate {keep:.5f} (0.8 +- 0.005)")
            else:
                err_abs, err_rel = compare(f"{name}/{case_name}", outs, refs)
                ok = err_rel <= REL_TOL
                line = (f"[kernel] {name:<18} {case_name:<8} max_abs_err {err_abs:.3e} "
                        f"max_rel_err {err_rel:.3e} (tol {REL_TOL:g})")
            if case_name == "flagship":
                iters = 3 if name == "mstcn_stack_bwd" else 10
                ms = cuda_ms(kern, iters, warmup=1)
                plain_ms = cuda_ms(plain, iters, warmup=1)
                line += f" ms {ms:.4f} plain_ms {plain_ms:.4f}"
                results[name] = dict(name=name, route="cuda", source=source,
                                     replaces=replaces, max_abs_err=err_abs,
                                     ms=ms, plain_ms=plain_ms)
            else:
                results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err_abs)
            log(line + ("" if ok else "  FAIL"))
            if not ok:
                failed.append(f"{name}/{case_name}")
            del kern, plain, outs, refs
            torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"training kernels disagree with their plain versions: {failed}")
    return results


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
    missing = [k for k in SERVING_KERNELS if counts[k] <= 0]
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


# ---------------------------------------------------------------------------
# phase 5: the flagship training step


def _median(v):
    w = sorted(v)
    return w[len(w) // 2]


def _time_steps(step, batches, gen, n):
    """Warm train steps: (median ms of whole steps, median ms per phase, peak GiB)."""
    import torch

    from fact_clip_tpu_torch.engine.train_loop import batch_to_device

    dev = torch.device("cuda")
    on_dev = [batch_to_device(b, dev) for b in batches]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    totals = []
    for i in range(n):  # whole steps, one synchronisation at the end of each
        t0 = time.perf_counter()
        step(on_dev[i % len(on_dev)], gen)
        torch.cuda.synchronize()
        totals.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    phases = []
    for i in range(n):  # the same steps split, a synchronisation after each phase
        times = {}
        step(on_dev[i % len(on_dev)], gen, times=times)
        phases.append(times)
    split = {k: _median([p[k] for p in phases]) for k in phases[0]}
    return _median(totals), split, peak, totals


def phase_training(seed: int = 0):
    import torch

    from fact_clip_tpu_torch import kernel_counters, plain_counters, reset_kernel_counters
    from fact_clip_tpu_torch.configs import train_cfg
    from fact_clip_tpu_torch.engine.steps import make_train_step
    from fact_clip_tpu_torch.engine.train_loop import batch_to_device, run_steps, synthetic_batch
    from fact_clip_tpu_torch.models.blocks import build_fact
    from fact_clip_tpu_torch.models.losses import build_class_weights

    D, C, S_CAP, B, T, S = 2048, 75, 128, 8, 3072, 32
    cfg = train_cfg()
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    model = build_fact(cfg, D, C, S_CAP, device=dev,
                       generator=torch.Generator(device="cpu").manual_seed(seed))
    cweight = build_class_weights(cfg, C, [])
    step = make_train_step(model, cfg, C, cweight)
    lengths = [FLAGSHIP_LENGTHS] + [sorted(rng.integers(2500, T + 1, B).tolist(), reverse=True)
                                    for _ in range(2)]
    batches = [synthetic_batch(rng, D, C, S, T, ln) for ln in lengths]
    gen = torch.Generator(device=dev).manual_seed(seed)
    log(f"[train] train_cfg() flagship: {sum(p.numel() for p in model.parameters())} "
        f"parameters, dropout {cfg['Bi']['dropout']}, cmr {cfg['FACT']['cmr']}, "
        f"{cfg['optimizer']} lr {cfg['lr']}; 3 batches of {B} x {T} built in "
        f"{time.perf_counter() - t0:.1f} s")

    warm = run_steps(step, batches[:1], generator=gen)  # builds/loads the kernels
    torch.cuda.synchronize()
    reset_kernel_counters()
    outs = run_steps(step, [batches[i % 3] for i in range(1, 6)], generator=gen)
    torch.cuda.synchronize()
    counts = kernel_counters()
    losses = [warm[0]["loss"]] + [o["loss"] for o in outs]
    log(f"[train] 1 warm-up + 5 Adam steps, losses {', '.join(f'{v:.5f}' for v in losses)}; "
        f"launch counts {counts}; plain K2 backwards (per-batch pos) {plain_counters()}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    missing = [k for k in TRAIN_KERNELS if counts[k] <= 0]
    if missing:
        raise AssertionError(f"training kernels not launched in the 5 steps: {missing}")

    for path in ("kernels", "plain"):
        model.set_kernels(path == "kernels")
        med, split, peak, totals = _time_steps(step, batches, gen, 5)
        log(f"[train] warm train step 8 x {T}, {path} path: median {med:.3f} ms "
            f"(all {', '.join(f'{t:.3f}' for t in totals)}); split (ms, synchronised): "
            + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
            + f"; peak memory {peak:.2f} GiB")
    model.set_kernels(True)

    # kernel path against the plain path, dropout and channel masking off, on
    # freshly seeded weights (a ReLU input within rounding of 0 can fall on
    # either side in the two forwards; seeded weights keep that draw fixed)
    del model, step
    cfg0 = train_cfg()
    cfg0["Bi"]["dropout"], cfg0["FACT"]["cmr"] = 0.0, 0.0
    ref = build_fact(cfg0, D, C, S_CAP, device=dev,
                     generator=torch.Generator(device="cpu").manual_seed(seed + 1))
    step0 = make_train_step(ref, cfg0, C, cweight)
    batch = batch_to_device(batches[0], dev)
    res = {}
    for path in ("kernels", "plain"):
        ref.set_kernels(path == "kernels")
        per_video, seg2tok, _ = step0.loss(batch, gen)
        loss = per_video.mean()
        names, params = zip(*ref.named_parameters())
        grads = torch.autograd.grad(loss, params)
        res[path] = (float(loss.detach()), seg2tok, grads)
    ref.set_kernels(True)
    (lk, sk, gk), (lp, sp, gp) = res["kernels"], res["plain"]
    top = max(float(g.abs().max()) for g in gp)
    worst, worst_name, worst_scale = 0.0, "", 0.0
    for n, a, b in zip(names, gk, gp):
        # per parameter, normalised by its own largest gradient, floored at
        # 1e-3 of the largest anywhere (gradients that are all but zero)
        scale = max(float(b.abs().max()), 1e-3 * top)
        e = float((a - b).abs().max()) / scale
        if e > worst:
            worst, worst_name, worst_scale = e, n, scale
    loss_err = abs(lk - lp) / abs(lp)
    same = bool(torch.equal(sk, sp))
    log(f"[train] kernel vs plain path (dropout 0, cmr 0): loss {lk:.6f} vs {lp:.6f} "
        f"(rel {loss_err:.2e}, tol {TRAIN_LOSS_TOL:g}); seg2tok equal {same}; worst gradient "
        f"{worst:.3e} ({worst_name}, its scale {worst_scale:.3e}, largest gradient {top:.3e}; "
        f"tol {GRAD_TOL:g}) over {len(names)} parameters")
    if not (loss_err <= TRAIN_LOSS_TOL and same and worst <= GRAD_TOL):
        raise AssertionError("training kernel path disagrees with the plain path")
    return counts


def main():
    import torch

    smi = phase_environment(torch)
    phase_build(verbose="--ptxas" in sys.argv)
    results = phase_kernels()
    results.update(phase_train_kernels())
    counts = phase_serving()
    train_counts = phase_training()
    for name, r in results.items():
        # the serving kernels' launches in the serving path, the others' in training
        r["launches"] = counts[name] if name in SERVING_KERNELS else train_counts[name]
    kernels = [results[n] for n in results]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
