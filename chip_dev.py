"""Measurements on the card beside ``chip_smoke.py``, none of them a gate.

    python3 chip_dev.py ab PARENT_DIR ROW[:CASE,...] [ROW[:CASE,...] ...]
        An old-against-new A/B of phase 3's rows (``chip_smoke.py``) for the
        named kernels, e.g. ``mstcn_stack mstcn_stack_bwd``, or only the
        named cases of a row (``mha_cross:flagship,ragged``; a case the
        parent's package refuses, such as one this tree made possible, is
        left out so); ``k3`` stands for K3's rows at the cases both trees
        run, ``k2k4`` for K2's flash backward and K4's SA forward at theirs,
        ``k2sx`` for K2's small-X forward and backward at theirs,
        ``k8ffn`` for K8e (the int8 MS-TCN++ tower) and K4's FFN backward
        at theirs with K6's serving form at Breakfast's 4 x 4096 x 512,
        ``ffn_sublayer_fwd`` for K4's FFN forward (the row ``ffn_sublayer``)
        ``k4k5`` for it and K5's forward (``frame_loss_fwd``), ``k8a`` for
        K8a (the int8 MSTCN tower) at the cases its parent runs, ``k8d``
        for K8d (int8 SCA cross-attention), ``k2f`` for K2's flash forward
        (``x2y_flash``), ``k8b`` for K8b (int8 small-X X2Y) and ``k8c``
        for K8c (int8 flash X2Y) at the cases its parent runs too (it
        refused Cx = 40), ``k4bwd`` for K4's SA and FFN backwards,
        ``k5k7`` for K5's backward (``frame_loss_bwd``) and K7a
        (``compose_argmax``), ``k7k3`` for K7a, K7b (``compose_blend``) and
        K3's backward (its mask hashed, a parent's fed it) and mask at the
        cases their parent runs too (it refused the wide vocabularies),
        ``k7c`` for K7c (``factored_argmax``, every case): PARENT_DIR is
        an unpacked ``git archive`` of the parent commit inside this
        checkout (under ``build/``, which git ignores).  Each tree builds
        its own kernel library and runs the rows of this tree's
        ``chip_smoke.py`` (the same cases, inputs and work counts, so a case
        this tree added is timed on the parent's package too) on its own
        package, in the order parent, this tree, this tree, parent, all on
        one card.

    python3 chip_dev.py k6-f64
        K6 (training form and backward, B=2, T=2048, C=512, 10 layers) and
        its f32 plain version, each against the plain version in float64:
        the error's max and rms over the reference's, and its coherent
        part, mean(err * sign(ref)) / mean |ref|, a shrink or growth of
        every value that a truncating accumulation leaves and a max-error
        gate does not see.

    python3 chip_dev.py k1-f64
        The same for K1 (training form with dropout 0.2 and backward, the
        flagship's 8 x 3072 x 256, O=512, 10 layers, no LN).

    python3 chip_dev.py b16-f64
        The bf16 GEMM of the mixed-precision forms (``csrc/tc_bf16.cu``,
        epilogue B16_PROJ: an f32 result, no rounding) at the flagship's 8
        x 3072 rows, N=256, K = 256, 512 and three taps of 256, and
        PyTorch's f32 product of the same bf16 values, each against the
        float64 product: the error over the row's sum of |terms| (max, and
        its coherent part, mean(err * sign(ref))).

    python3 chip_dev.py k3-f64 [TREE]
        The same for K3 (forward and backward, no dropout, at Breakfast's and
        the flagship's shapes: the output, dq, dx and the weight and bias
        gradients), of the package in TREE (default: this checkout; an
        unpacked parent to compare).

    python3 chip_dev.py k2-f64 [TREE]
        The same for K2's flash backward (the flagship's 8 x 3072, M=40 and
        Breakfast's 4 x 4096, M=60, d = Cx = 512, shared x_pos): every
        cotangent from the same saves (probabilities, output) against the
        plain backward in float64.

    python3 chip_dev.py k2f-f64 [TREE]
        The same for K2's flash forward (the flagship's 8 x 3072, M=40 and
        Breakfast's 4 x 4096, M=60, d = Cx = 512, shared x_pos): the
        projection [xk | xv] (from the call's workspace, where the package
        has one), the logits on the valid keys, attn and probs, against the
        plain version in float64.

    python3 chip_dev.py k2sx-f64
        The same for K2's small-X forward and backward (the flagship's a2f,
        8 x 3072 over X=40, and epic's a2f and f2a at batch 1, Cy = Cx =
        d = 512, shared positional tables): yq, attn and probs, then from
        the kernel forward's probabilities dy, dy_pos, dWq, dbq, dxk and dxv
        (the per-video products inside the backward) and the X side's
        cotangents, against the plain versions in float64.

    python3 chip_dev.py ffn-f64 [TREE]
        The same for K4's FFN forward without dropout (the flagship's B=8,
        M=40, E=256, epic's B=1, M=300, E=256 and Breakfast's B=4, M=60,
        E=512; F=512) of the package in TREE: y, the kernel's and the f32
        plain version's, against the plain version in float64.

    python3 chip_dev.py ffn-host [TREE]
        K4's FFN backward (``ffn_sublayer_bwd``) and forward
        (``ffn_sublayer_fwd``) of the package in TREE at the flagship's B=8,
        M=40 (the backward with dropout 0.2) and epic's B=1, M=300, E=256,
        F=512, and K5's forward at the flagship's 8 x 3072 x 75: the
        wrapper's host time a call (the median over 50 calls, each started
        on an idle card) and the library entries' share of it, the
        CUDA-event time a call, and the device busy time a call from
        ``torch.profiler`` with its kernels.

    python3 chip_dev.py ffn16-ties [SEEDS]
        K4's FFN bf16 backward (``ffn_sublayer16_bwd``) at the flagship's
        B=8, M=40, E=256, F=512 on SEEDS (default 12) draws of phase 3's
        inputs without ``away_from_zero``: per draw the ReLU units whose gate
        differs between the kernel (dz1 != 0 in its workspace) and the plain
        version (bf16 z1 > 0), the worst cotangent's error of its scale
        against the plain backward, and against the plain backward with the
        kernel's gate on those units (``chip_smoke._ffn16_forced``).

    python3 chip_dev.py k8-host [TREE]
        The same for K8a (the flagship's 8 x 3072 x 256 and the LayerNorm
        case), K8b (the flagship's a2f and epic's f2a and a2f), K8c and K8d
        (the flagship's and Breakfast's shapes), K8e (Breakfast's 4 x 4096 x
        512) and K2's flash forward (the flagship's and Breakfast's) of the
        package in TREE.

    python3 chip_dev.py sa-host [TREE]
        The same for K4's SA backward (dropout 0.2) at the flagship's B=8,
        M=40, E=256, H=8, epic's B=1, M=300, EgoProceL's B=2, M=200 and
        Breakfast's B=4, M=60, E=512, its masks hashed in the kernels from
        the seed and fed as replayed tensors (a package whose backward takes
        no seed is fed the masks in both), and K4's FFN backward hashed at
        the flagship's shape.

    python3 chip_dev.py k5k7-host [TREE]
        The same for K5's backward (the flagship's 8 x 3072 x 75 with the CE
        term, and 8 x 3072 x 40 without it) and K7a (epic's 1 x 24,576 over
        98 / 301 / 3,806, and the ragged 3 x 1000 over 13 / 29 / 97).

    python3 chip_dev.py k7k3-host [TREE]
        The same for K7a (epic's 1 x 24,576 over 98 / 301 / 3,806), K7b
        there (random votes and votes constant over 500-frame runs), at
        phase 3's small rows and over a sweep of sizes (the data behind the
        library's choice of the blend's form), and K3's backward at the
        flagship's shape, dropout 0.2 (its mask hashed where the package
        hashes it, and fed).

    python3 chip_dev.py k8row-host [TREE]
        The same for the int8 towers' row forms (``act_scale="row"``) beside
        their tile forms: K8a at the flagship's 8 x 3072 x 256 (and with the
        LayerNorm), K8e at Breakfast's 4 x 4096 x 512 and epic's 1 x 24,576
        x 256.

    python3 chip_dev.py k7c-host [TREE]
        The same for K7c, the factored argmax, at epic's 1 x 24,576 over 98
        / 301 / 3,806, at 4,224 frames (one 32-frame tile a block: the
        table's prologue and one tile), over 13 / 29 / 97 at 24,576 frames,
        and K7a at epic's shape beside it.

    python3 chip_dev.py k6b16-host [TREE]
        The same for K6's bf16 forms (``mstcn2_stack16`` and
        ``mstcn2_stack16_bwd``, 10 layers, O = 512) at phase 3's Breakfast 4 x
        4096 x 512 and ragged 3 x 600 (a video of 0 frames) cases: whether
        the host (the weight packs each call builds, the launches) or the
        card sets a call's time.

    python3 chip_dev.py sa-f64 [TREE]
        K4's SA backward (dropout 0.2, hashed) of the package in TREE and
        its f32 plain version against the plain version in float64 at the
        same four shapes: max, rms and coherent error of every cotangent.

    python3 chip_dev.py loop-host [EPOCHS [sync]]
        ``chip_smoke.py`` phase 15's training run (havid.yaml, batch 8, the
        HAViD-shaped set) for EPOCHS epochs (default 6: 12 steps) with no
        test pass: each loop step split into its wait on the prefetcher, the
        batch's copy to the card, the train step and the train metrics
        (``print_every 1``), each synchronised, beside the step's padded
        length; medians over the steps at a length seen before.  With
        ``sync`` the batches are assembled on the loop's own thread, with no
        prefetcher beside the step.

Run from the root of a checkout, on a machine with an H100 (the kernels
build there with nvcc, as for ``chip_smoke.py``).
"""
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# this tree's chip_smoke.py (``cs``) on a parent's package: a K3 backward
# that takes no seed is fed the mask, and a blend with no plan takes the tile
# form at every call
_OLD_PACKAGE = """
import inspect
from fact_clip_tpu_torch.ops import compose_decode as _k7, mha_attn as _ma
if "seed" not in inspect.signature(_ma.mha_cross_bwd).parameters:
    _bwd_case = cs.mha_bwd_case
    cs.mha_bwd_case = lambda *a, hashed=False, **kw: _bwd_case(*a, **kw)
if not hasattr(_k7, "blend_plan"):
    _k7.blend_plan = lambda *a: ("tile", 0)
"""
# run in each tree's own directory: this tree's chip_smoke.py (argv[1]) on
# that tree's package and build
_PHASE3 = """
import importlib.util, os, sys, torch
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
cs.REPO = os.getcwd()
want = dict((a.split(":") + [""])[:2] for a in sys.argv[2:])  # row -> cases ("": all)
cs.phase_environment(torch)
cs.phase_build()
table = cs.kernel_table
cs.kernel_table = lambda: [
    (*r[:4], [c for c in r[4] if not want[r[0]] or c[0] in want[r[0]].split(",")])
    for r in table() if r[0] in want]
cs.phase_kernels()
"""
_PHASE3 = _PHASE3.replace("cs.phase_kernels()", _OLD_PACKAGE + "cs.phase_kernels()")
# K3's rows at the cases the parent of the K3 redesign runs too (it refused M=200)
ALIASES = {"k3": ["mha_cross:flagship,ragged,flag_drop,rag_drop", "mha_cross_bwd:flagship,ragged",
                  "mha_cross_e512", "mha_cross_bwd_e512"],
           # K2's flash backward and K4's SA forward at the cases their parent runs too
           "k2k4": ["x2y_flash_bwd:flagship,ragged,breakfast",
                    "sa_sublayer:flagship,ragged,flag_drop,rag_drop,epic,epic_b3,epic_drop,ego"],
           # K2's small-X forward and backward: the parent of their redesign runs every case
           "k2sx": ["x2y_small_x", "x2y_small_x_bwd"],
           # K8e and K4's FFN backward at the cases their parent runs too (it refused
           # widths of no multiple of 32), beside K6's serving form at Breakfast's shape
           "k8ffn": ["mstcn2_stack_q8:breakfast,ragged,epic", "ffn_sublayer_bwd",
                     "mstcn2_stack:bf_full"],
           # K4's FFN forward (its phase-3 row is ffn_sublayer) and K5's forward
           "ffn_sublayer_fwd": ["ffn_sublayer"],
           "k4k5": ["ffn_sublayer", "frame_loss_fwd"],
           # K8a (the int8 MSTCN tower) at the cases its parent runs too (it refused
           # widths of no multiple of 32), and K8d (int8 SCA cross-attention)
           "k8a": ["mstcn_stack_q8:flagship,ragged,ln"],
           "k8d": ["mha_cross_q8"],
           # K2's flash forward and K8b (int8 small-X X2Y): their parent runs every case
           "k2f": ["x2y_flash:flagship,ragged,xlen0,breakfast"],
           "k8b": ["x2y_small_x_q8"],
           # K8c (int8 flash X2Y) at the cases its parent runs too (it refused Cx = 40)
           "k8c": ["x2y_flash_q8:flagship,ragged,breakfast,xlen0"],
           # K4's SA and FFN backwards: their parent runs every case (its FFN backward
           # takes no seed, so it is fed the masks of the hashed cases)
           "k4bwd": ["sa_sublayer_bwd", "ffn_sublayer_bwd"],
           # K5's backward and K7a: their parent runs every case
           "k5k7": ["frame_loss_bwd", "compose_argmax"],
           # K7a, K7b and K3's backward and mask at the cases their parent runs too
           "k7k3": ["compose_argmax:epic,ragged,ties,shuffled,segments",
                    "compose_blend:epic,segments,ragged,w0,w1,ties,ties_w0,m1,v1000,v2000,v2000_ties",
                    "mha_cross_bwd:flagship,flag_fed,m200", "mha_cross_bwd_e512:breakfast",
                    "mha_dropout_mask:flagship"],
           # K7c (the factored argmax): its parent runs every case
           "k7c": ["factored_argmax"]}


def ab(parent: str, names):
    parent = os.path.abspath(parent)
    failed = 0
    for tree in (parent, REPO, REPO, parent):
        print(f"== {os.path.relpath(tree, REPO)}", flush=True)
        rc = subprocess.run([sys.executable, "-c", _PHASE3, os.path.join(REPO, "chip_smoke.py"),
                             *names], cwd=tree).returncode
        failed += rc != 0
    return 1 if failed else 0


def _stats(a, ref, valid):
    """The error of ``a`` against the float64 ``ref`` where ``valid``: max and
    rms over the reference's, and the coherent part."""
    e, r = (a.double() - ref) * valid, ref * valid
    return (f"max {float(e.abs().max() / r.abs().max()):.2e} rms "
            f"{float(e.pow(2).mean().sqrt() / r.pow(2).mean().sqrt()):.2e} coherent "
            f"{float((e * r.sign()).mean() / r.abs().mean()):+.2e}")


def k6_f64(seed: int = 0):
    import torch

    sys.path.insert(0, REPO)
    import chip_smoke as cs

    cs.phase_environment(torch)
    cs.phase_build()
    from fact_clip_tpu_torch.ops import dilated_conv as dc

    def d(t):
        return t.double()

    rng = np.random.default_rng(seed)
    B, T, C = 2, 2048, 512
    x, lens, layers, dil, kw = cs.k6_case(rng, B, T, C, C, 10, [2048, 1500], 0.0)
    valid = (torch.arange(T, device="cuda")[None, :] < lens[:, None])[..., None].double()
    layers64 = [tuple(d(p) for p in layer) for layer in layers]
    kw64 = dict(out_w=d(kw["out_w"]), out_b=d(kw["out_b"]))
    one = torch.ones((), device="cuda", dtype=torch.float64)
    with torch.no_grad():
        ref = dc.mstcn2_stack_reference(d(x), lens, layers64, dil, save=True, **kw64)
        fwd = {"kernel": dc.mstcn2_stack_fwd(x, lens, layers, dil, save=True, **kw),
               "plain": dc.mstcn2_stack_reference(x, lens, layers, dil, save=True, **kw)}
        _, streams, cs_, hs = fwd["kernel"]
        g = cs._rand(rng, (B, T, C), 0.01)
        ref_b = dc.mstcn2_stack_bwd_reference(d(g), [d(t) for t in streams], [d(t) for t in cs_],
                                              [d(t) for t in hs], lens, layers64, dil, **kw64)
        for name, bwd in (("kernel", dc.mstcn2_stack_bwd), ("plain", dc.mstcn2_stack_bwd_reference)):
            dx, dl, _, _ = bwd(g, streams, cs_, hs, lens, layers, dil, **kw)
            print(f"[k6-f64] {name:<6} vs float64: logits {_stats(fwd[name][0], ref[0], valid)}; "
                  f"h (last layer) {_stats(fwd[name][3][-1], ref[3][-1], valid)}; dx "
                  f"{_stats(dx, ref_b[0], valid)}; dK1 (layer 0) "
                  f"{_stats(dl[0][0], ref_b[1][0][0], one)}", flush=True)
    return 0


def b16_f64(seed: int = 0):
    import torch

    sys.path.insert(0, REPO)
    import chip_smoke as cs

    cs.phase_environment(torch)
    cs.phase_build()
    from fact_clip_tpu_torch.ops import dilated_conv as dc

    g = torch.Generator(device="cuda").manual_seed(seed)
    B, T, N = 8, 3072, 256
    lens = torch.full((B,), T, dtype=torch.int32, device="cuda")
    for C, shifts in ((256, [0]), (512, [0]), (256, [-1, 0, 1])):
        x = torch.randn(B, T, C, device="cuda", generator=g).to(torch.bfloat16)
        w = torch.randn(len(shifts) * C, N, device="cuda", generator=g) / (len(shifts) * C) ** 0.5
        w16 = w.to(torch.bfloat16)
        out = torch.empty(B, T, N, device="cuda")
        segs = len(shifts)
        dc.b16_gemm(dc.B16_PROJ, x, shifts, dc.b16_pack(w, True, segs=segs), N, lens, out,
                    kseg=dc.b16_pad(C) if segs > 1 else None)
        taps = [(dc._shift(x, s), w16[i * C:(i + 1) * C]) for i, s in enumerate(shifts)]
        ref = sum(a.double() @ b.double() for a, b in taps)
        mag = sum(a.double().abs() @ b.double().abs() for a, b in taps)
        f32 = sum(a.float() @ b.float() for a, b in taps)
        for name, y in (("kernel", out), ("torch f32", f32)):
            e = (y.double() - ref) / mag
            print(f"[b16-f64] K={segs * C:<4} {name:<9} error / sum |terms|: max "
                  f"{float(e.abs().max()):.2e} coherent {float((e * ref.sign()).mean()):+.2e}",
                  flush=True)
    return 0


def k1_f64(seed: int = 0):
    import torch

    sys.path.insert(0, REPO)
    import chip_smoke as cs

    cs.phase_environment(torch)
    cs.phase_build()
    from fact_clip_tpu_torch.ops import dilated_conv as dc

    def d(t):
        return t.double()

    rng = np.random.default_rng(seed)
    B, T, C, L = 8, 3072, 256, 10
    (x, lens, layers, dil), kw = cs.k1_case(rng, B, T, C, 512, [2 ** i for i in range(L)],
                                            cs.FLAGSHIP_LENGTHS, False)
    kw.update(rates=[0.2] * L, seeds=torch.tensor(rng.integers(0, 2 ** 31 - 1, L),
                                                  dtype=torch.int32, device="cuda"))
    valid = (torch.arange(T, device="cuda")[None, :] < lens[:, None])[..., None].double()
    kw64 = dict(kw, out_w=d(kw["out_w"]), out_b=d(kw["out_b"]))
    layers64 = [tuple(d(p) for p in layer) for layer in layers]
    one = torch.ones((), device="cuda", dtype=torch.float64)
    with torch.no_grad():
        ref = dc.mstcn_stack_reference(d(x), lens, layers64, dil, save=True, **kw64)
        fwd = {"kernel": dc.mstcn_stack_fwd(x, lens, layers, dil, save=True, **kw),
               "plain": dc.mstcn_stack_reference(x, lens, layers, dil, save=True, **kw)}
        _, streams, acts = fwd["kernel"]
        g = cs._rand(rng, (B, T, 512), 0.01)
        ref_b = dc.mstcn_stack_bwd_reference(d(g), [d(t) for t in streams], [d(t) for t in acts],
                                             lens, layers64, dil, **kw64)
        for name, bwd in (("kernel", dc.mstcn_stack_bwd), ("plain", dc.mstcn_stack_bwd_reference)):
            dx, dl, dow, _ = bwd(g, streams, acts, lens, layers, dil, **kw)
            print(f"[k1-f64] {name:<6} vs float64: logits {_stats(fwd[name][0], ref[0], valid)}; "
                  f"h (last layer) {_stats(fwd[name][2][-1], ref[2][-1], valid)}; dx "
                  f"{_stats(dx, ref_b[0], valid)}; dWd (layer 0) "
                  f"{_stats(dl[0][0], ref_b[1][0][0], one)}; dWo {_stats(dow, ref_b[2], one)}",
                  flush=True)
    return 0


def _chip_smoke(tree: str):
    """This checkout's chip_smoke.py on the package in ``tree``, built."""
    import importlib.util

    import torch

    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cs.REPO = tree
    cs.phase_environment(torch)
    cs.phase_build()
    exec(_OLD_PACKAGE, {"cs": cs})
    return cs


def k3_f64(tree: str = REPO, seed: int = 0):
    """K3 (forward and backward, no dropout, Breakfast's 4 x 4096, M=60,
    E=512, H=8, and the flagship's 8 x 3072, M=40, E=256) of the package in
    ``tree`` and its f32 plain version, each against the plain version in
    float64: max, rms and coherent error of the output, dq, dx, dWk, dbk,
    dWv and dbv."""
    import torch

    cs = _chip_smoke(tree)
    from fact_clip_tpu_torch.ops import mha_attn as ma

    one = torch.ones((), device="cuda", dtype=torch.float64)
    rng = np.random.default_rng(seed)
    for tag, (B, M, X, E, lens) in {"breakfast": (4, 60, 4096, 512, cs.BF_TRAIN_LENGTHS),
                                    "flagship": (8, 40, 3072, 256, cs.FLAGSHIP_LENGTHS)}.items():
        pos = torch.zeros((1, X, 512), device="cuda")
        args = cs.mha_case(rng, B, M, X, E, 512, lens, pos)
        a64 = [t.double() if t is not None and t.is_floating_point() else t for t in args]
        g = cs._rand(rng, (B, M, E))
        with torch.no_grad():
            out64, st64 = ma.mha_cross_attention_reference(*a64, num_heads=8, with_stats=True)
            ref = ma.mha_cross_bwd_reference(*a64, st64, out64, g.double(), num_heads=8)
            out, st = ma.mha_cross_fwd(*args, num_heads=8, with_stats=True)
            runs = {"kernel": (out, ma.mha_cross_bwd(*args, st, out, g, num_heads=8)),
                    "plain": (ma.mha_cross_attention_reference(*args, num_heads=8),
                              ma.mha_cross_bwd_reference(*args, st, out, g, num_heads=8))}
        for name, (o, grads) in runs.items():
            parts = [f"out {_stats(o, out64, one)}"]
            for gname, a, r in zip(("dq", "dx", "dWk", "dbk", "dWv", "dbv"),
                                   [grads[0], grads[1], *grads[3:]], [ref[0], ref[1], *ref[3:]]):
                parts.append(f"{gname} {_stats(a, r, one)}")
            print(f"[k3-f64] {os.path.relpath(tree, REPO)} {tag} {name:<6} vs float64: "
                  + "; ".join(parts), flush=True)
    return 0


def k2_f64(tree: str = REPO, seed: int = 0):
    """K2's flash backward (shared x_pos, g_probs and g_logits non-zero) of
    the package in ``tree`` and its f32 plain version, each against the
    plain version in float64 on the same saves: max, rms and coherent error
    of every cotangent."""
    import torch

    cs = _chip_smoke(tree)
    from fact_clip_tpu_torch.ops import x2y_attn as xa

    one = torch.ones((), device="cuda", dtype=torch.float64)
    rng = np.random.default_rng(seed)
    names = ("dy", "dy_pos", "dx", "dx_pos", "dWk", "dbk", "dWv", "dbv", "dWq", "dbq")
    for tag, (B, M, X, lens, P) in {"flagship": (8, 40, 3072, cs.FLAGSHIP_LENGTHS, 256),
                                    "breakfast": (4, 60, 4096, cs.BF_TRAIN_LENGTHS, 512)}.items():
        args = cs.x2y_case(rng, B, M, X, 512, 512, 512, lens, cs._rand(rng, (1, M, P)),
                           cs._rand(rng, (1, X, 512)))
        a64 = [t.double() if t is not None and t.is_floating_point() else t for t in args]
        with torch.no_grad():
            attn, probs, _ = (t.float() for t in xa.x2y_attention_reference(*a64))
            g = [cs._rand(rng, attn.shape), cs._rand(rng, probs.shape, 0.1),
                 cs._rand(rng, probs.shape, 0.1)]
            ref = xa.x2y_bwd_reference(*a64, probs.double(), *[t.double() for t in g])
            runs = {"kernel": xa.x2y_flash_bwd(*args, probs, attn, *g),
                    "plain": xa.x2y_bwd_reference(*args, probs, *g)}
        for name, grads in runs.items():
            parts = [f"{n} {_stats(a, r, one)}" for n, a, r in zip(names, grads, ref)]
            print(f"[k2-f64] {os.path.relpath(os.path.abspath(tree), REPO)} {tag} {name:<6} vs "
                  "float64: " + "; ".join(parts), flush=True)
    return 0


def k2f_f64(tree: str = REPO, seed: int = 0):
    """K2's flash forward (shared x_pos) of the package in ``tree`` and its
    f32 plain version against the plain version in float64: max, rms and
    coherent error of the projection [xk | xv] over the attended frames
    (the kernel's from its workspace, where the package's wrapper hands it
    out), the logits over the valid keys, attn and probs."""
    import torch

    cs = _chip_smoke(tree)
    from fact_clip_tpu_torch.ops import x2y_attn as xa

    one = torch.ones((), device="cuda", dtype=torch.float64)
    rng = np.random.default_rng(seed)
    for tag, (B, M, X, lens, P) in {"flagship": (8, 40, 3072, cs.FLAGSHIP_LENGTHS, 256),
                                    "breakfast": (4, 60, 4096, cs.BF_TRAIN_LENGTHS, 512)}.items():
        args = cs.x2y_case(rng, B, M, X, 512, 512, 512, lens, cs._rand(rng, (1, M, P)),
                           cs._rand(rng, (1, X, 512)))
        a64 = [t.double() if t is not None and t.is_floating_point() else t for t in args]
        keys = (torch.arange(X, device="cuda")[None, :] < args[10][:, None]).double()
        valid = keys[:, None, :]  # the logits' valid keys (the masked ones are -1e9 exactly)

        def project(a):
            return torch.cat([xa.add_pos(a[2], a[3]) @ a[4] + a[5], a[2] @ a[6] + a[7]], -1)

        with torch.no_grad():
            ref = xa.x2y_attention_reference(*a64)
            kv64 = project(a64)
            seen = {}
            if hasattr(xa, "_x2y_flash_fwd_card"):
                kern = xa._x2y_flash_fwd_card(*args, inspect=seen)
            else:  # a parent's package
                kern = xa.x2y_flash_fwd(*args)
            runs = {"kernel": (kern, seen.get("kv")),
                    "plain": (xa.x2y_attention_reference(*args), project(args))}
            for name, ((attn, probs, logits), kv) in runs.items():
                parts = [] if kv is None else [f"kv {_stats(kv, kv64, keys[..., None])}"]
                parts += [f"logits {_stats(logits, ref[2], valid)}",
                          f"attn {_stats(attn, ref[0], one)}",
                          f"probs {_stats(probs, ref[1], one)}"]
                print(f"[k2f-f64] {os.path.relpath(os.path.abspath(tree), REPO)} {tag} "
                      f"{name:<6} vs float64: " + "; ".join(parts), flush=True)
    return 0


def _sx_dxkv(xa, a, probs, g):
    """The small-X backward's dxk = dlogits^T yq and dxv = probs^T g_attn per
    video, plain, in the precision of the arguments ``a`` (x2y_attention's)."""
    import torch

    d = a[8].shape[1]
    yq = xa.add_pos(a[0], a[1]) @ a[8] + a[9]
    dp = g[1] + g[0] @ (a[2] @ a[6] + a[7]).transpose(1, 2)
    dl = probs * (dp - (dp * probs).sum(-1, keepdim=True)) + g[2]
    valid = torch.arange(probs.shape[2], device=probs.device)[None, None, :] < a[10][:, None, None]
    dl = torch.where(valid, dl, 0.0) * (1.0 / np.sqrt(d))
    return torch.einsum("byx,byd->bxd", dl, yq), torch.einsum("byx,byd->bxd", probs, g[0])


def k2sx_f64(seed: int = 0):
    """K2's small-X forward and backward (shared positional tables, g_probs
    and g_logits non-zero) of this checkout's package and its f32 plain
    version, each against the plain version in float64: max, rms and
    coherent error of yq, attn, probs and every cotangent, and of dxk and
    dxv, the per-video weight products inside the backward."""
    import torch

    cs = _chip_smoke(REPO)
    from fact_clip_tpu_torch.ops import x2y_attn as xa

    one = torch.ones((), device="cuda", dtype=torch.float64)
    rng = np.random.default_rng(seed)
    names = ("dy", "dy_pos", "dx", "dx_pos", "dWk", "dbk", "dWv", "dbv", "dWq", "dbq", "dxk",
             "dxv")
    cases = {"flagship": (8, 3072, 40, [40] * 8, (1, 3072, 512), (1, 40, 256)),
             "epic_a2f": (1, 256, 300, [300], (1, 256, 512), (1, 300, 256)),
             "epic_f2a": (1, 300, 256, [256], (1, 300, 256), (1, 256, 512))}
    for tag, (B, Y, X, lens, yps, xps) in cases.items():
        args = cs.x2y_case(rng, B, Y, X, 512, 512, 512, lens, cs._rand(rng, yps),
                           cs._rand(rng, xps))
        a64 = [t.double() if t is not None and t.is_floating_point() else t for t in args]
        with torch.no_grad():
            yq64 = xa.add_pos(a64[0], a64[1]) @ a64[8] + a64[9]
            attn64, probs64, _ = xa.x2y_attention_reference(*a64)
            seen = {}
            attn, probs, _ = xa._x2y_small_x_fwd_card(*args, inspect=seen)
            yq = seen["yq"]
            fwd = {"kernel": (yq, attn, probs),
                   "plain": (xa.add_pos(args[0], args[1]) @ args[8] + args[9],
                             *xa.x2y_attention_reference(*args)[:2])}
            g = [cs._rand(rng, attn64.shape), cs._rand(rng, probs.shape, 0.1),
                 cs._rand(rng, probs.shape, 0.1)]
            p64, g64 = probs.double(), [t.double() for t in g]  # the kernel's saves for all
            ref = (*xa.x2y_bwd_reference(*a64, p64, *g64), *_sx_dxkv(xa, a64, p64, g64))
            grads = xa._x2y_small_x_bwd_card(*args, probs, *g, inspect=seen)
            dkv = seen["dkv"]  # [dxk | dxv] from its workspace
            bwd = {"kernel": (*grads, dkv[..., :512], dkv[..., 512:]),
                   "plain": (*xa.x2y_bwd_reference(*args, probs, *g),
                             *_sx_dxkv(xa, args, probs, g))}
        for name in ("kernel", "plain"):
            parts = [f"{n} {_stats(a, r, one)}"
                     for n, a, r in zip(("yq", "attn", "probs"), fwd[name], (yq64, attn64,
                                                                             probs64))]
            parts += [f"{n} {_stats(a, r, one)}" for n, a, r in zip(names, bwd[name], ref)]
            print(f"[k2sx-f64] {tag} {name:<6} vs float64: " + "; ".join(parts), flush=True)
    return 0


def ffn_f64(tree: str = REPO, seed: int = 0):
    """K4's FFN forward (no dropout) of the package in ``tree`` and its f32
    plain version against the plain version in float64: max, rms and
    coherent error of y."""
    import torch

    cs = _chip_smoke(tree)
    from fact_clip_tpu_torch.ops import sa_layer as sl

    one = torch.ones((), device="cuda", dtype=torch.float64)
    rng = np.random.default_rng(seed)
    for tag, (B, M, E) in {"flagship": (8, 40, 256), "epic": (1, 300, 256),
                           "breakfast": (4, 60, 512)}.items():
        args = cs.ffn_case(rng, B, M, E, 512)
        with torch.no_grad():
            ref = sl.ffn_sublayer_reference(*[t.double() for t in args])
            runs = {"kernel": sl.ffn_sublayer_fwd(*args), "plain": sl.ffn_sublayer_reference(*args)}
        for name, y in runs.items():
            print(f"[ffn-f64] {os.path.relpath(os.path.abspath(tree), REPO)} {tag} {name:<6} vs "
                  f"float64: y {_stats(y, ref, one)}", flush=True)
    return 0


class _TimedLib:
    """The kernel library with the host time of its entries' calls added up
    (``spent``): the library's share of a wrapper's host time."""

    def __init__(self, lib):
        self.lib, self.spent = lib, 0.0

    def __getattr__(self, name):
        import time

        fn = getattr(self.lib, name)

        def timed(*args):
            t0 = time.perf_counter()
            try:
                return fn(*args)
            finally:
                self.spent += time.perf_counter() - t0

        return timed


def _per_call(cs, tag: str, cases):
    """For each case's kernel call: the wrapper's host time a call (the
    median over 50 calls of the time until it returns, each started on an
    idle card, so that no full launch queue holds the host back) and the
    median of the library calls' share of it, the CUDA-event time a call,
    and the device busy time a call from ``torch.profiler`` with its
    kernels."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    from fact_clip_tpu_torch import _build

    timed = _TimedLib(_build.lib())
    for name, make in cases.items():
        kern = make()[0]
        n = 200
        for _ in range(10):
            kern()
        times, inner = [], []
        lib = _build.lib
        _build.lib = lambda: timed
        try:
            for _ in range(50):
                torch.cuda.synchronize()
                timed.spent = 0.0
                t0 = time.perf_counter()
                kern()
                times.append(time.perf_counter() - t0)
                inner.append(timed.spent)
        finally:
            _build.lib = lib
        host = sorted(times)[len(times) // 2] * 1e3
        in_lib = sorted(inner)[len(inner) // 2] * 1e3
        torch.cuda.synchronize()
        ms = cs.cuda_ms(kern, n)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                kern()
            torch.cuda.synchronize()
        rows = [(getattr(e, "device_time_total", 0) / 20e3, e.count // 20, e.key[:70])
                for e in prof.key_averages() if e.device_type.name == "CUDA"]
        print(f"[{tag}] {name}: host {host:.4f} ms a call ({in_lib:.4f} in the library's "
              f"entries), events {ms:.4f} ms, device busy {sum(r[0] for r in rows):.4f} ms",
              flush=True)
        for r in sorted(rows, reverse=True):
            print(f"[{tag}]    {r[0]:.4f} ms x{r[1]} {r[2]}", flush=True)
    return 0


def ffn_host(tree: str = REPO, seed: int = 0):
    """The host time, event time and device busy time a call of K4's FFN
    backward and forward and of K5's forward."""
    cs = _chip_smoke(tree)
    rng = np.random.default_rng(seed)
    return _per_call(cs, "ffn-host", {
        "bwd flagship": lambda: cs.ffn_bwd_case(rng, 8, 40, 256, 512, 0.2),
        "bwd epic": lambda: cs.ffn_bwd_case(rng, 1, 300, 256, 512, 0.0),
        "fwd flagship": lambda: cs.ffn_fwd_case(rng, 8, 40, 256, 512, 0.2),
        "fwd epic": lambda: cs.ffn_fwd_case(rng, 1, 300, 256, 512),
        "k5 flagship": lambda: cs.frame_loss_case(rng, False, 8, 3072, 75, cs.FLAGSHIP_LENGTHS)})


def ffn16_ties(n_seeds: int = 12):
    """Whether phase 3's FFN bf16 backward misses on ReLU ties: per draw the
    gate mismatches and the worst error before and after the kernel's gate
    is given to the plain backward."""
    import torch

    cs = _chip_smoke(REPO)
    from fact_clip_tpu_torch import _build
    from fact_clip_tpu_torch.ops import sa_layer as sl
    from fact_clip_tpu_torch.ops.bf16 import rnd

    B, M, E, Fd = 8, 40, 256, 512
    names = ["dx", "dw1", "db1", "dw2", "db2", "dls", "dlb"]
    for seed in range(n_seeds):
        rng = np.random.default_rng(seed)
        args = cs.ffn_case(rng, B, M, E, Fd)
        g = cs._rand(rng, (B, M, E))
        x, w1, b1, w2, b2, ls, lb = args
        kern = sl.ffn_sublayer16_bwd(*args, g)
        plain = sl.ffn_sublayer16_bwd_reference(*args, g)
        # the kernel's gate: its dz1 panel in the backward's workspace (as
        # ``_ffn16_bwd_card`` lays it out)
        lib = _build.lib()
        total, _, o_lhs, ldl, _, _, _ = _build.workspace(lib, "fk_ffn_bwd_workspace", 7, B, M, E,
                                                         Fd)
        ws = torch.empty(total, device="cuda", dtype=torch.float32)
        w1h = w1.to(torch.bfloat16).contiguous()
        _build.check("fk_ffn_bwd16", lib.fk_ffn_bwd16(
            x.data_ptr(), w1h.data_ptr(), w1h.float().data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), ls.data_ptr(), g.data_ptr(), ws.data_ptr(), B, M, E, Fd, 1e-6,
            _build.stream_ptr(x.device)))
        torch.cuda.synchronize()
        gate_k = ws.as_strided((B * M, Fd), (ldl, 1), o_lhs).view(B, M, Fd) != 0
        gate_p = rnd(rnd(rnd(x) @ rnd(w1)) + rnd(b1)) > 0
        differ = gate_k != gate_p
        xr = x.detach().clone().requires_grad_(True)
        ws_ = [t.detach().clone().requires_grad_(True) for t in args[1:]]
        y = cs._ffn16_forced(xr, differ, gate_k, 1e-6, *ws_)
        forced = torch.autograd.grad(y, [xr, *ws_], g)

        def worst(got, ref):
            errs = [(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30), n)
                    for n, a, b in zip(names, got, ref)]
            return max(errs)

        (e0, n0), (e1, n1) = worst(kern, plain), worst(kern, forced)
        print(f"[ffn16-ties] seed {seed}: gate differs on {int(differ.sum())} of "
              f"{differ.numel()} units; kernel vs plain: worst {n0} {e0:.3e} of its scale; vs "
              f"plain given the kernel's gate: worst {n1} {e1:.3e}", flush=True)
    return 0


def k8_host(tree: str = REPO, seed: int = 0):
    """The same for K8a (the flagship's 8 x 3072 x 256 and the LayerNorm
    case), K8b (the flagship's a2f, epic's f2a and a2f), K8c (the flagship's
    8 x 3072, M=40 and Breakfast's 4 x 4096, M=60), K8d (the flagship's and
    Breakfast's shapes), K8e (Breakfast's 4 x 4096 x 512) and K2's flash
    forward (the flagship's and Breakfast's shapes)."""
    import torch

    cs = _chip_smoke(tree)
    rng = np.random.default_rng(seed)
    zeros = lambda X: torch.zeros((1, X, 512), device="cuda")  # noqa: E731
    rand = lambda *s: cs._rand(rng, s)  # noqa: E731
    return _per_call(cs, "k8-host", {
        "k8a flagship": lambda: cs.k8a_case(rng, 8, 3072, 256, 10, cs.FLAGSHIP_LENGTHS, False),
        "k8a ln": lambda: cs.k8a_case(rng, 3, 600, 256, 10, [600, 517, 90], True),
        "k8b flagship": lambda: cs.k8bc_case(rng, False, 8, 3072, 40, 512, 512, 512, [40] * 8,
                                             zeros(3072), rand(1, 40, 256)),
        "k8b epic_f2a": lambda: cs.k8bc_case(rng, False, 2, 300, 256, 512, 512, 512, [256, 190],
                                             rand(1, 300, 256), rand(2, 256, 512)),
        "k8b epic_a2f": lambda: cs.k8bc_case(rng, False, 2, 256, 300, 512, 512, 512, [300, 300],
                                             rand(2, 256, 512), rand(1, 300, 256)),
        "k2f flagship": lambda: cs.x2y_fwd_case(rng, True, 8, 40, 3072, 512, 512, 512,
                                                cs.FLAGSHIP_LENGTHS, rand(1, 40, 256),
                                                zeros(3072)),
        "k2f breakfast": lambda: cs.x2y_fwd_case(rng, True, 4, 60, 4096, 512, 512, 512,
                                                 cs.BF_TRAIN_LENGTHS, rand(1, 60, 512),
                                                 zeros(4096)),
        "k8c flagship": lambda: cs.k8bc_case(rng, True, 8, 40, 3072, 512, 512, 512,
                                             cs.FLAGSHIP_LENGTHS, rand(1, 40, 256), zeros(3072)),
        "k8c breakfast": lambda: cs.k8bc_case(rng, True, 4, 60, 4096, 512, 512, 512,
                                              cs.BF_TRAIN_LENGTHS, rand(1, 60, 512),
                                              zeros(4096)),
        "k8d flagship": lambda: cs.k8d_case(rng, 8, 40, 3072, 256, 512, 8, cs.FLAGSHIP_LENGTHS,
                                            zeros(3072)),
        "k8d breakfast": lambda: cs.k8d_case(rng, 4, 60, 4096, 512, 512, 8, cs.BF_TRAIN_LENGTHS,
                                             zeros(4096)),
        "k8e breakfast": lambda: cs.k8e_case(rng, 4, 4096, 512, 10, [4096] * 4)})


SA_SHAPES = {"flagship": (8, 40, 256), "epic": (1, 300, 256), "m200": (2, 200, 256),
             "breakfast": (4, 60, 512)}  # (B, M, E) of the zoo's SA backwards, H = 8


def sa_host(tree: str = REPO, seed: int = 0):
    """The same for K4's SA backward, its masks hashed and fed, and its FFN
    backward hashed, at the zoo's SA shapes."""
    cs = _chip_smoke(tree)
    rng = np.random.default_rng(seed)
    cases = {f"{name} {form}": (lambda B=B, M=M, E=E, hashed=form == "hashed":
                                cs.sa_bwd_case(rng, B, M, E, 8, hashed=hashed))
             for name, (B, M, E) in SA_SHAPES.items() for form in ("hashed", "fed")}
    cases["ffn flagship hashed"] = lambda: cs.ffn_bwd_case(rng, 8, 40, 256, 512, 0.2, True)
    return _per_call(cs, "sa-host", cases)


def k5k7_host(tree: str = REPO, seed: int = 0):
    """The same for K5's backward and K7a at their main paths' shapes."""
    cs = _chip_smoke(tree)
    rng = np.random.default_rng(seed)
    return _per_call(cs, "k5k7-host", {
        "k5 bwd flagship": lambda: cs.frame_loss_case(rng, True, 8, 3072, 75,
                                                      cs.FLAGSHIP_LENGTHS),
        "k5 bwd smooth": lambda: cs.frame_loss_case(rng, True, 8, 3072, 40, cs.FLAGSHIP_LENGTHS,
                                                    False),
        "k7a epic": lambda: cs.k7a_case(rng, 1, cs.EPIC_T, (98, 301, 3806), [cs.EPIC_T]),
        "k7a ragged": lambda: cs.k7a_case(rng, 3, 1000, (13, 29, 97), [1000, 777, 129])})


def k7k3_host(tree: str = REPO, seed: int = 0):
    """The same for K7a and K7b at epic's shape, K7b at phase 3's small rows
    and over a sweep of sizes (random votes unless named: epic's vocabulary
    at T = 250-8000 with M = 300 and 30, segment votes at 4000, a vocabulary
    of 13 x 29 -> 97 at T = 1000, 4000 and epic's, epic's verbs and nouns
    over 250-2000 actions at T = 1000 and epic's), and K3's backward at the
    flagship's."""
    cs = _chip_smoke(tree)
    rng = np.random.default_rng(seed)
    voc, rag = (98, 301, 3806), (13, 29, 97)
    epic = (1, cs.EPIC_T, voc, [cs.EPIC_T])
    cases = {
        "k7a epic": lambda: cs.k7a_case(rng, *epic),
        "k7b epic": lambda: cs.k7b_case(rng, *epic, 300, 0.1),
        "k7b segments": lambda: cs.k7b_case(rng, *epic, 300, 0.1, segment=500),
        "k7b ragged": lambda: cs.k7b_case(rng, 3, 1000, rag, [1000, 777, 129], 7, 0.5, all_null=1),
        "k7b ties": lambda: cs.k7b_case(rng, 3, 1000, rag, [1000, 777, 129], 7, 0.5, all_null=0,
                                        coarse=True),
        "k7b m1": lambda: cs.k7b_case(rng, 2, 3000, voc, [3000, 1200], 1, 0.5),
        "k7b wide": lambda: cs.k7b_case(rng, 2, 4000, (98, 900, 6000), [4000, 2500], 60, 0.1,
                                        pairs=True)}
    for T, M in [(250, 30), (500, 300), (1000, 300), (2000, 300), (4000, 300), (8000, 300),
                 (1000, 30), (4000, 30)]:
        cases[f"k7b T={T} M={M}"] = lambda T=T, M=M: cs.k7b_case(rng, 1, T, voc, [T], M, 0.1)
    cases["k7b T=4000 M=300 segments"] = lambda: cs.k7b_case(rng, 1, 4000, voc, [4000], 300,
                                                              0.1, segment=500)
    for T in (1000, 4000, cs.EPIC_T):
        cases[f"k7b 13x29->97 T={T}"] = lambda T=T: cs.k7b_case(rng, 1, T, rag, [T], 300, 0.1)
    for n_act in (250, 500, 1000, 2000):
        for T in (1000, cs.EPIC_T):
            cases[f"k7b 98x301->{n_act} T={T}"] = (
                lambda T=T, n_act=n_act: cs.k7b_case(rng, 1, T, (98, 301, n_act), [T], 300, 0.1))
    import torch

    zeros = torch.zeros((1, 3072, 512), device="cuda")
    for form in ("hashed", "fed"):
        cases[f"k3 bwd flagship {form}"] = (
            lambda form=form: cs.mha_bwd_case(rng, 8, 40, 3072, 256, 512, 8, cs.FLAGSHIP_LENGTHS,
                                              zeros, hashed=form == "hashed"))
    return _per_call(cs, "k7k3-host", cases)


def k8row_host(tree: str = REPO, seed: int = 0):
    """The same for the int8 towers' row forms beside their tile forms."""
    cs = _chip_smoke(tree)
    rng = np.random.default_rng(seed)
    flag = (8, 3072, 256, 10, cs.FLAGSHIP_LENGTHS)
    cases = {}
    for form in ("tile", "row"):
        cases[f"k8a {form} flagship"] = lambda f=form: cs.k8a_case(rng, *flag, False, f)
        cases[f"k8a {form} ln"] = lambda f=form: cs.k8a_case(rng, *flag, True, f)
        cases[f"k8e {form} breakfast"] = lambda f=form: cs.k8e_case(rng, 4, 4096, 512, 10,
                                                                   [4096] * 4, f)
        cases[f"k8e {form} epic"] = lambda f=form: cs.k8e_case(rng, 1, cs.EPIC_T, 256, 10,
                                                              [cs.EPIC_T], f)
    return _per_call(cs, "k8row-host", cases)


def k6b16_host(tree: str = REPO, seed: int = 0):
    """The same for K6's bf16 forward and backward at phase 3's Breakfast and
    ragged cases."""
    cs = _chip_smoke(tree)
    rng = np.random.default_rng(seed)
    D = 512
    shapes = {"breakfast": (4, 4096, cs.BF_TRAIN_LENGTHS), "ragged": (3, 600, [600, 517, 0])}
    cases = {}
    for name, (B, T, lens) in shapes.items():
        cases[f"fwd {name}"] = lambda s=(B, T, lens): cs.k6_16_case(rng, s[0], s[1], D, D, 10, s[2])
        cases[f"bwd {name}"] = lambda s=(B, T, lens): cs.k6_bwd16_case(rng, s[0], s[1], D, D, 10,
                                                                        s[2])
    return _per_call(cs, "k6b16-host", cases)


def k7c_host(tree: str = REPO, seed: int = 0):
    """The same for K7c at epic's shape, at one tile a block, over a small
    vocabulary, and K7a at epic's shape."""
    cs = _chip_smoke(tree)
    rng = np.random.default_rng(seed)
    voc, rag = (98, 301, 3806), (13, 29, 97)
    return _per_call(cs, "k7c-host", {
        "k7c epic": lambda: cs.k7c_case(rng, 1, cs.EPIC_T, voc, [cs.EPIC_T]),
        "k7c T=4224": lambda: cs.k7c_case(rng, 1, 4224, voc, [4224]),
        "k7c 13x29->97": lambda: cs.k7c_case(rng, 1, cs.EPIC_T, rag, [cs.EPIC_T]),
        "k7a epic": lambda: cs.k7a_case(rng, 1, cs.EPIC_T, voc, [cs.EPIC_T])})


def sa_f64(tree: str = REPO, seed: int = 0):
    """K4's SA backward (dropout 0.2, its masks hashed where the package
    hashes them) of the package in ``tree`` and its f32 plain version, each
    against the plain version in float64 given the same masks, at the zoo's
    SA shapes: max, rms and coherent error of every cotangent."""
    import inspect

    import torch

    cs = _chip_smoke(tree)
    from fact_clip_tpu_torch.ops import sa_layer as sl

    one = torch.ones((), device="cuda", dtype=torch.float64)
    rng = np.random.default_rng(seed)
    hashed = "seed" in inspect.signature(sl.sa_sublayer_bwd).parameters
    names = ("dx", "dpos", "dWq", "dbq", "dWk", "dbk", "dWv", "dbv", "dWo", "dbo", "dgamma",
             "dbeta")
    for tag, (B, M, E) in SA_SHAPES.items():
        args = cs.sa_case(rng, B, M, E)
        seed_t, ka, ko = cs._sa_masks(rng, B, M, E, 8, 0.2)
        g = cs._rand(rng, (B, M, E))
        kw = dict(num_heads=8, keep_attn=ka, keep_out=ko)
        with torch.no_grad():
            ref = sl.sa_sublayer_bwd_reference(*[t.double() for t in args], g.double(),
                                               num_heads=8, keep_attn=ka.double(),
                                               keep_out=ko.double())
            kern = (sl.sa_sublayer_bwd(*args, g, num_heads=8, seed=seed_t, rate_attn=0.2,
                                       rate=0.2) if hashed else sl.sa_sublayer_bwd(*args, g, **kw))
            runs = {"kernel": kern, "plain": sl.sa_sublayer_bwd_reference(*args, g, **kw)}
        for name, grads in runs.items():
            # dbk is 0 in exact arithmetic (a softmax row is shift-invariant): its
            # error is read against dbq's scale
            parts = [f"{n} {_stats(a, r if n != 'dbk' else ref[3], one)}" if n != "dbk" else
                     f"dbk max {float((a.double() - r).abs().max() / ref[3].abs().max()):.2e} "
                     "of dbq's"
                     for n, a, r in zip(names, grads, ref)]
            print(f"[sa-f64] {os.path.relpath(os.path.abspath(tree), REPO)} {tag} {name:<6} vs "
                  "float64: " + "; ".join(parts), flush=True)
    return 0


def loop_host(epochs: str = "6", mode: str = ""):
    """``chip_smoke.py`` phase 15's run for ``epochs`` epochs, no test pass,
    each loop step split by its parts; ``mode="sync"``: no prefetch thread
    (see the module's docstring)."""
    cs = _chip_smoke(REPO)
    from fact_clip_tpu_torch.engine import train_loop

    with cs._loop_run("chip_dev_loop") as (_, cfg_of), cs._LoopSpies(mode == "sync") as spies:
        cfg, _, _ = cfg_of(int(epochs), "aux.eval_every", "1000000")
        train_loop.run_train(cfg, device="cuda", base_dir=REPO)
    smi = cs.nvidia_smi_line()
    warm = []
    for i, (st, nxt, gap) in enumerate(spies.gaps()):
        # from this step's start to the next's: the step, its metrics, the
        # next batch's wait and copy, and the rest (results, logging)
        row = dict(T=st["T"], step=st["ms"], metrics=spies.metrics[i], wait=nxt["wait"],
                   copy=nxt["copy"], gap=gap)
        print(f"[loop-host] {smi}: step {i} " + ", ".join(
            f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}" for k, v in row.items()),
            flush=True)
        if spies.seen(st):
            warm.append(row)
    parts_of_step = ("wait", "copy", "step", "metrics")
    med = {k: float(np.median([r[k] for r in warm])) for k in (*parts_of_step, "gap")}
    rest = med["gap"] - sum(med[k] for k in parts_of_step)
    print(f"[loop-host] {smi} ({mode or 'prefetch'}): {len(warm)} steps at a length seen "
          "before, median ms: " + ", ".join(f"{k} {v:.3f}" for k, v in med.items())
          + f"; the rest of the loop's step {rest:.3f}", flush=True)
    return 0


def main(argv):
    if len(argv) >= 3 and argv[0] == "ab":
        return ab(argv[1], [n for a in argv[2:] for n in ALIASES.get(a, [a])])
    if argv == ["k6-f64"]:
        return k6_f64()
    if argv == ["k1-f64"]:
        return k1_f64()
    if argv == ["b16-f64"]:
        return b16_f64()
    if argv[:1] == ["k3-f64"] and len(argv) <= 2:
        return k3_f64(*argv[1:])
    if argv[:1] == ["k2-f64"] and len(argv) <= 2:
        return k2_f64(*argv[1:])
    if argv[:1] == ["ffn-f64"] and len(argv) <= 2:
        return ffn_f64(*argv[1:])
    if argv[:1] == ["ffn-host"] and len(argv) <= 2:
        return ffn_host(*argv[1:])
    if argv[:1] == ["ffn16-ties"] and len(argv) <= 2:
        return ffn16_ties(*[int(a) for a in argv[1:]])
    if argv[:1] == ["k8-host"] and len(argv) <= 2:
        return k8_host(*argv[1:])
    if argv[:1] == ["sa-host"] and len(argv) <= 2:
        return sa_host(*argv[1:])
    if argv[:1] == ["k5k7-host"] and len(argv) <= 2:
        return k5k7_host(*argv[1:])
    if argv[:1] == ["k7k3-host"] and len(argv) <= 2:
        return k7k3_host(*argv[1:])
    if argv[:1] == ["k8row-host"] and len(argv) <= 2:
        return k8row_host(*argv[1:])
    if argv[:1] == ["k6b16-host"] and len(argv) <= 2:
        return k6b16_host(*argv[1:])
    if argv[:1] == ["k7c-host"] and len(argv) <= 2:
        return k7c_host(*argv[1:])
    if argv[:1] == ["sa-f64"] and len(argv) <= 2:
        return sa_f64(*argv[1:])
    if argv[:1] == ["k2f-f64"] and len(argv) <= 2:
        return k2f_f64(*argv[1:])
    if argv == ["k2sx-f64"]:
        return k2sx_f64()
    if argv[:1] == ["loop-host"] and len(argv) <= 3:
        return loop_host(*argv[1:])
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
