"""Measurements on the card beside ``chip_smoke.py``, none of them a gate.

    python3 chip_dev.py ab PARENT_DIR KERNEL [KERNEL ...]
        An old-against-new A/B of phase 3's rows (``chip_smoke.py``) for the
        named kernels, e.g. ``mstcn_stack mstcn_stack_bwd``: PARENT_DIR is
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

Run from the root of a checkout, on a machine with an H100 (the kernels
build there with nvcc, as for ``chip_smoke.py``).
"""
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# run in each tree's own directory: this tree's chip_smoke.py (argv[1]) on
# that tree's package and build
_PHASE3 = """
import importlib.util, os, sys, torch
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
cs.REPO = os.getcwd()
names = set(sys.argv[2:])
cs.phase_environment(torch)
cs.phase_build()
table = cs.kernel_table
cs.kernel_table = lambda: [r for r in table() if r[0] in names]
cs.phase_kernels()
"""


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


def main(argv):
    if len(argv) >= 3 and argv[0] == "ab":
        return ab(argv[1], argv[2:])
    if argv == ["k6-f64"]:
        return k6_f64()
    if argv == ["k1-f64"]:
        return k1_f64()
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
