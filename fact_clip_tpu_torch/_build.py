"""Build the port's CUDA kernels and load them with ctypes.

``csrc/*.cu`` compile with ``nvcc`` for ``sm_90a``, one process per source
started together, and link into ONE shared library with a plain C interface
(no PyTorch headers, so the build takes seconds).
The library lands in ``build/kernels/`` at the repository root, named by a
hash of the sources and flags, so an edited source rebuilds and an
unchanged one loads the existing file.  Nothing is built at import time:
the first kernel launch builds, and ``chip_smoke.py`` builds explicitly to
time it.  A missing ``nvcc`` or a failed build raises.

Each kernel's C entry returns the ``cudaError_t`` of its launch; the
wrappers in ``ops/`` raise on anything but 0 (``check``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_lib = None

P = ctypes.c_void_p  # every device pointer and the stream
I = ctypes.c_int
L = ctypes.c_longlong
F = ctypes.c_float
U = ctypes.c_uint

# shared memory: a block's dynamic limit on sm_90, and csrc/common.cuh's
# GemmSmem<64> staging, which every backward kernel's block holds
MAX_SMEM = 232448
GEMM_SMEM = 4 * (2 * 16 * 68 + 2 * 16 * 256)

# C signatures of the kernels' entry points (csrc/*.cu, extern "C")
SIGNATURES = {
    "fk_mstcn_layer": [P] * 14 + [I, U, F, I, I, I, I, I, I, F, P],
    "fk_mstcn_dropout_mask": [P, I, U, F, P, I, I, I, P],
    "fk_mstcn_bwd_dc": [P] * 18 + [I, I, I, I, I, F, P],
    "fk_mstcn_bwd_dx": [P] * 5 + [I, I, I, I, P],
    "fk_atb": [P, P, L, I, P, I, I, P, P, I, I, I, I, I, I, P],
    "fk_reduce": [P, I, I, L, L, I, L, I, P, P],
    "fk_x2y_sx_bwd": [P, P, L, I] + [P] * 15 + [I, I, I, I, I, F, P],
    "fk_x2y_flash_bwd": [P, P, L, I] + [P] * 19 + [I, I, I, I, I, F, P],
    "fk_frame_loss_fwd": [P] * 6 + [I, I, I, P],
    "fk_frame_loss_bwd": [P] * 7 + [I, I, I, P],
    "fk_x2y_small_x": [P, P, L, I, P, P, P, P, P, P, P, P, I, I, I, I, I, F, P],
    "fk_proj_attn": [P, P, L, I, P, P, P, P, P, P, I, I, I, I, I, I, F, P, P, P, P, P, P],
    "fk_sa_sublayer": [P, P, L, I, P, P, P, P, P, P, P, P, P, P, P, P, I, I, I, I, F, P],
    "fk_ffn_sublayer": [P, P, P, P, P, P, P, P, P, I, I, I, I, F, P],
}


def sources() -> list:
    return sorted(os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
                  if f.endswith((".cu", ".cuh")))


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libfact_kernels_{h.hexdigest()[:16]}.so")


def find_nvcc() -> str:
    cands = [os.path.join(os.environ[v], "bin", "nvcc")
             for v in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(v)]
    cands += ["/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME, /usr/local/cuda, $PATH): "
                       "the port's CUDA kernels cannot be built")


def _run_all(cmds) -> str:
    """Run the commands at once; wait for every one, then raise on any failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for c, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n{' '.join(c)}\n{out}")
    return "".join(outs)


def build(verbose: bool = False) -> tuple:
    """Compile the library if it is not built yet: one nvcc per source, all
    started together, then one link.  Returns (path, compiler output); with
    ``verbose`` ptxas reports registers, shared memory and spills per
    kernel."""
    path = library_path()
    if os.path.isfile(path):
        return path, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = find_nvcc()
    tmp = f"{path}.{os.getpid()}.tmp"
    objs = {s: f"{tmp}.{os.path.basename(s)}.o" for s in sources() if s.endswith(".cu")}
    try:
        out = _run_all([[nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []), "-c",
                         "-o", o, s] for s, o in objs.items()])
        out += _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs.values()]])
    finally:
        for o in objs.values():
            if os.path.exists(o):
                os.remove(o)
    os.replace(tmp, path)  # atomic: a concurrent loader never sees a partial file
    return path, out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            path, _ = build()
            handle = ctypes.CDLL(path)
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
        return _lib


def check(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")


def no_grad_inputs(name: str, tensors) -> None:
    """A raw kernel launch records nothing for autograd: refuse inputs that
    want a gradient (the differentiable entries wrap the launches in a
    ``torch.autograd.Function``)."""
    import torch

    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(f"{name}: gradients go through the autograd entry")


def forward_only(name: str, rates, tensors) -> None:
    """Forward-only launches (K3, K4, and K2's raw forward wrappers, whose
    autograd entry is ``x2y_attention``) take no dropout and no gradient."""
    if any(float(r) != 0.0 for r in rates):
        raise NotImplementedError(f"{name}: dropout is not supported (forward-only kernel)")
    no_grad_inputs(name, tensors)


def require_backward(name: str, available: bool) -> None:
    """A K1/K2 call whose shape has no backward kernel refuses a gradient."""
    if not available:
        raise NotImplementedError(f"{name}: no backward kernel at this shape")


def check_tensors(name: str, tensors, device) -> None:
    """Device, dtype and contiguity of every pointer handed to a kernel."""
    import torch

    for t in tensors:
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"{name}: tensor on {t.device}, expected {device}")
        if t.dtype not in (torch.float32, torch.int32):
            raise ValueError(f"{name}: unsupported dtype {t.dtype} (float32 kernels)")
        if not t.is_contiguous():
            raise ValueError(f"{name}: kernel inputs must be contiguous")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
