"""Measurements on the card beside ``chip_smoke.py``, none of them a gate.

    python3 chip_dev.py ab PARENT_DIR KERNEL [KERNEL ...]
        An old-against-new A/B of phase 3's rows (``chip_smoke.py``) for the
        named kernels, e.g. ``mstcn2_stack mstcn2_stack_bwd``: PARENT_DIR is
        an unpacked ``git archive`` of the parent commit inside this
        checkout (under ``build/``, which git ignores).  Each tree builds
        its own kernel library and runs its own ``chip_smoke.py``, in the
        order parent, this tree, this tree, parent, all on one card.

    python3 chip_dev.py k6-f64
        K6 (training form and backward, B=2, T=2048, C=512, 10 layers) and
        its f32 plain version, each against the plain version in float64:
        the error's max and rms over the reference's, and its coherent
        part, mean(err * sign(ref)) / mean |ref|, a shrink or growth of
        every value that a truncating accumulation leaves and a max-error
        gate does not see.

Run from the root of a checkout, on a machine with an H100 (the kernels
build there with nvcc, as for ``chip_smoke.py``).
"""
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# run in each tree's own directory: its chip_smoke.py, its package, its build
_PHASE3 = """
import os, sys, torch
sys.path.insert(0, os.getcwd())
import chip_smoke as cs
names = set(sys.argv[1:])
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
        rc = subprocess.run([sys.executable, "-c", _PHASE3, *names], cwd=tree).returncode
        failed += rc != 0
    return 1 if failed else 0


def k6_f64(seed: int = 0):
    import torch

    sys.path.insert(0, REPO)
    import chip_smoke as cs

    cs.phase_environment(torch)
    cs.phase_build()
    from fact_clip_tpu_torch.ops import dilated_conv as dc

    def d(t):
        return t.double()

    def stats(a, ref, valid):
        e, r = (a.double() - ref) * valid, ref * valid
        return (f"max {float(e.abs().max() / r.abs().max()):.2e} rms "
                f"{float(e.pow(2).mean().sqrt() / r.pow(2).mean().sqrt()):.2e} coherent "
                f"{float((e * r.sign()).mean() / r.abs().mean()):+.2e}")

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
            print(f"[k6-f64] {name:<6} vs float64: logits {stats(fwd[name][0], ref[0], valid)}; "
                  f"h (last layer) {stats(fwd[name][3][-1], ref[3][-1], valid)}; dx "
                  f"{stats(dx, ref_b[0], valid)}; dK1 (layer 0) "
                  f"{stats(dl[0][0], ref_b[1][0][0], one)}", flush=True)
    return 0


def main(argv):
    if len(argv) >= 3 and argv[0] == "ab":
        return ab(argv[1], argv[2:])
    if argv == ["k6-f64"]:
        return k6_f64()
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
