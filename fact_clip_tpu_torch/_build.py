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

# shared memory: a block's dynamic limit on sm_90
MAX_SMEM = 232448


def gemm_smem(bm: int) -> int:
    """Bytes of csrc/common.cuh's GemmSmem<bm> staging (A chunks of bm rows,
    W chunks of 256 columns), which every GEMM kernel's block holds."""
    return 4 * (2 * 16 * (bm + 4) + 2 * 16 * 256)


GEMM_SMEM = gemm_smem(64)

# C signatures of the kernels' entry points (csrc/*.cu, extern "C")
SIGNATURES = {
    "fk_dropout_mask": [P, I, U, F, P, L, P],
    "fk_atb": [P, P, L, I, P, I, I, P, P, I, I, I, I, I, I, P],
    "fk_reduce": [P, I, I, L, L, I, L, I, P, P],
    "fk_x2y_sx_bwd": [P, P, L, I, P, P, L, I] + [P] * 11 + [I] * 6 + [F] + [P] * 13 + [I]
                     + [P] * 14 + [I] * 4 + [P],
    "fk_x2y_flash_attn_bwd": [P] * 8 + [I, I, I, I, F] + [P] * 3 + [I, P],
    "fk_frame_loss_fwd": [P] * 5 + [I, I, I, P],
    "fk_frame_loss_fwd_workspace": [I, I, P],
    "fk_frame_loss_bwd": [P] * 7 + [I, I, I, P],
    "fk_x2y_sx_fwd": [P, P, L, I, P, P, L, I] + [P] * 7 + [I] * 6 + [F] + [P] * 10 + [I, P],
    "fk_x2y_flash_fwd": [P, P, L, I] + [P] * 6 + [I] * 5 + [F] + [P] * 9 + [I, P],
    "fk_k3_attn": [P, P, P, I, I, I, I, I, F, P, P, P, P, P, I, U, F, P],
    "fk_k3_attn_bwd": [P] * 7 + [I] * 5 + [F] + [P] * 3 + [I, I, P, I, U, F, P],
    "fk_sa_qkv": [P, P, I] + [P] * 7 + [I, I, I, P],
    "fk_sa_attn_out": [P, L, I, I, I] + [P] * 7 + [I, I, I, I, F] + [P, I, U, F] * 2 + [P],
    "fk_ffn_fwd": [P] * 9 + [I, I, I, I, F] + [P, I, U, F] * 2 + [P],
    "fk_ffn_fwd_workspace": [I, I, I, I, P],
    "fk_sa_bwd": [P, P, I] + [P] * 14 + [I, I, I, I, F] + [P, I, U, F] * 2 + [P],
    "fk_sa_bwd_workspace": [I, I, I, I, I, P],
    "fk_ffn_bwd": [P] * 10 + [I, I, I, I, F] + [P, I, U, F] * 2 + [P],
    "fk_ffn_bwd_workspace": [I, I, I, I, P],
    "fk_k6_pack": [P, P, I, I, I, I, I, P],
    "fk_k6_gemm": [I, P, I, I, I, P, I, P, I, I, I, I, P, P, I, I] + [P] * 3 + [I, L]
                  + [P] * 3 + [I, U, F, P],
    "fk_k1_ln": [P] * 4 + [I] * 4 + [F, P],
    "fk_k1_dz": [P] * 7 + [I, U, F] + [P] * 5 + [I] * 6 + [F, P],
    "fk_k6_wgrad": [P, I, I, I, P, I, I, I, P, I, I, I, P, I, I, I, P],
    "fk_k6_ds": [P] * 6 + [I, U, F] + [P] * 4 + [I] * 5 + [P],
    "fk_compose_argmax": [P] * 5 + [I] * 5 + [P],
    "fk_compose_blend_plan": [I] * 6 + [P],
    "fk_compose_blend": [P] * 9 + [I] * 6 + [F, F, P],
    "fk_factored_plan": [I, I, P],
    "fk_factored_argmax": [P] * 5 + [I] * 4 + [P],
    "fk_q8_group_max": [P] * 3 + [I] * 4 + [P],
    "fk_q8_tower_layer": [P] * 4 + [I] + [P] * 3 + [I] + [P] * 4 + [I, F] + [P] * 7 + [I] * 9
                         + [P],
    "fk_q8_tower2_layer": [P] * 4 + [I] + [P] * 5 + [I] + [P] * 10 + [I] * 10 + [P],
    "fk_q8_tower_row_layer": [P] * 3 + [I] + [P] * 3 + [I] + [P] * 4 + [I, F] + [P] * 6
                             + [I] * 9 + [P],
    "fk_q8_tower2_row_layer": [P] * 3 + [I] + [P] * 5 + [I] + [P] * 9 + [I] * 10 + [P],
    "fk_q8_mha_cross": [P, P, L, I, P, I] + [P] * 6 + [I] * 7 + [P] * 7,
    "fk_x2y_sx_q8_fwd": [P, P, L, I, P, P, L, I, P, I] + [P] * 7 + [I] * 7 + [F] + [P] * 10
                        + [I, P],
    "fk_x2y_flash_q8_fwd": [P, P, L, I, P, I] + [P] * 6 + [I] * 6 + [F] + [P] * 8 + [I, P],
    # the mixed-precision (bf16) forms
    "fk_b16_gemm": [I, P, I, I, P, P, I, P, I, I, I, I, P, P, I, I, P, P, P, P],
    "fk_b16_add_pos": [P, P, L, I, I, I, I, P, P],
    "fk_x2y_sx_attn": [P, P, P, I, I, I, I, F, P, P, P, I, P],
    "fk_x2y_flash_attend": [P, P, P, I, I, I, I, F] + [P] * 5 + [I, P],
    "fk_k3_attn16": [P, P, P] + [I] * 5 + [P] * 5,
    "fk_sa_qkv16": [P, P, I] + [P] * 7 + [I, I, I, P],
    "fk_sa_attn_out16": [P, L, I, I, I] + [P] * 7 + [I, I, I, I, F, P],
    "fk_ffn_fwd16": [P] * 9 + [I, I, I, I, F, P],
    # the bf16 backward forms (training under mixed precision)
    "fk_b16_wgrad": [P, I, I, I, P, I, I, I, P, I, I, I, P, I, I, I, P],
    "fk_b16_round": [P, I, P, P, I, I, I, I, P, P, P],
    "fk_k3_attn_bwd16": [P] * 6 + [I] * 5 + [P] * 3 + [I, I, P],
    "fk_x2y_sx_attn_bwd": [P] * 6 + [I] * 4 + [F] + [P] * 3 + [I, I, P],
    "fk_ffn_bwd16": [P] * 9 + [I] * 4 + [F, P],
    "fk_sa_bwd16": [P, P, I] + [P] * 25 + [I] * 4 + [F, P],
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


_WORKSPACES = {}  # (library, entry, dims) -> the entry's answer


def workspace(library, entry: str, n: int, *dims: int) -> tuple:
    """The first ``n`` numbers that the workspace entry ``entry`` (e.g.
    ``fk_ffn_bwd_workspace``) reports for ``dims``: the floats of a call's
    workspace as the library lays it out, then whatever offsets and strides
    the entry gives.  Asked once a shape."""
    key = (library, entry, dims)
    if key not in _WORKSPACES:
        out = (ctypes.c_longlong * n)()
        check(entry, getattr(library, entry)(*dims, out))
        _WORKSPACES[key] = tuple(out)
    return _WORKSPACES[key]


def no_grad_inputs(name: str, tensors) -> None:
    """A raw kernel launch records nothing for autograd: refuse inputs that
    want a gradient (the differentiable entries wrap the launches in a
    ``torch.autograd.Function``)."""
    import torch

    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(f"{name}: gradients go through the autograd entry")


def forward_only(name: str, rates, tensors) -> None:
    """K2's raw forward wrappers (whose autograd entry is ``x2y_attention``)
    take no dropout and no gradient."""
    if any(float(r) != 0.0 for r in rates):
        raise NotImplementedError(f"{name}: dropout is not supported (forward-only kernel)")
    no_grad_inputs(name, tensors)


def require_backward(name: str, available: bool) -> None:
    """A K1/K2 call whose shape has no backward kernel refuses a gradient."""
    if not available:
        raise NotImplementedError(f"{name}: no backward kernel at this shape")


def check_tensors(name: str, tensors, device, bf16: bool = False) -> None:
    """Device, dtype and contiguity of every pointer handed to a kernel (one
    test a tensor where all hold: it runs on every kernel call's host path).
    ``bf16``: the entry takes bfloat16 tensors too (the mixed-precision
    forms); the others take float32, int32 and int8 only."""
    import torch

    kinds = (torch.float32, torch.int32, torch.int8) + ((torch.bfloat16,) if bf16 else ())
    for t in tensors:
        if t is None or (t.dtype in kinds and t.device == device and t.is_contiguous()):
            continue
        if t.device != device:
            raise ValueError(f"{name}: tensor on {t.device}, expected {device}")
        if t.dtype not in kinds:
            raise ValueError(f"{name}: unsupported dtype {t.dtype} ("
                             + ", ".join(str(k).replace("torch.", "") for k in kinds)
                             + " kernels)")
        if not t.is_contiguous():
            raise ValueError(f"{name}: kernel inputs must be contiguous")


def stream_ptr(device) -> int:
    """The current stream of ``device`` as an int (the raw handle where this
    PyTorch build exposes it: a Stream object costs a few microseconds of
    host time per kernel call)."""
    import torch

    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None and device.index is not None:
        return raw(device.index)
    return torch.cuda.current_stream(device).cuda_stream
