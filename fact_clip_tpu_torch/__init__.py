"""fact_clip_tpu_torch: the PyTorch / NVIDIA H100 port of fact_clip_tpu.

The JAX package ``fact_clip_tpu`` is the reference; this package mirrors its
layout where that helps find a module's counterpart:

configs.py        BlockCfg, resolve_block_cfgs, flagship_cfg (no YAML)
models/           layers, blocks (FACT), two-branch decode
ops/              the hand-written CUDA kernels (K1-K4) beside their plain
                  PyTorch versions; TDU segment operations; positional terms
engine/           the eval step and the serving Predictor
utils/bridge.py   JAX parameters (numpy) -> this package's state_dict
csrc/             CUDA C++ sources for sm_90a, built by _build.py on first use

Everything runs in float32.  Importing this package imports neither JAX nor
the JAX package and builds nothing.
"""

from .ops import dilated_conv, mha_attn, sa_layer, x2y_attn

# launch counters of the kernel wrappers, by kernel name
_KERNELS = {
    "mstcn_stack": dilated_conv.mstcn_stack_fwd,
    "x2y_small_x": x2y_attn.x2y_small_x_fwd,
    "x2y_flash": x2y_attn.x2y_flash_fwd,
    "mha_cross": mha_attn.mha_cross_fwd,
    "sa_sublayer": sa_layer.sa_sublayer,
    "ffn_sublayer": sa_layer.ffn_sublayer,
}


def kernel_counters() -> dict:
    """How many times each kernel wrapper launched its CUDA kernel."""
    return {name: fn.launches for name, fn in _KERNELS.items()}


def reset_kernel_counters() -> None:
    for fn in _KERNELS.values():
        fn.launches = 0
