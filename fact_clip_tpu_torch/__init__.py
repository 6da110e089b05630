"""fact_clip_tpu_torch: the PyTorch / NVIDIA H100 port of fact_clip_tpu.

The JAX package ``fact_clip_tpu`` is the reference; this package mirrors its
layout where that helps find a module's counterpart:

configs.py        BlockCfg, resolve_block_cfgs, flagship_cfg, train_cfg (no YAML)
models/           layers, blocks (FACT), two-branch decode, matching, losses
ops/              the hand-written CUDA kernels (K1-K5, forwards and the
                  K1/K2 backwards) beside their plain PyTorch versions; TDU
                  segment operations; training masks; positional terms
engine/           the eval and train steps, the serving Predictor, the
                  optimizer and a minimal training loop
utils/bridge.py   JAX parameters (numpy) -> this package's state_dict
csrc/             CUDA C++ sources for sm_90a, built by _build.py on first use

Everything runs in float32.  Importing this package imports neither JAX nor
the JAX package and builds nothing.
"""

from .ops import dilated_conv, frame_loss, mha_attn, sa_layer, x2y_attn

# launch counters of the kernel wrappers, by kernel name
_KERNELS = {
    "mstcn_stack": dilated_conv.mstcn_stack_fwd,
    "x2y_small_x": x2y_attn.x2y_small_x_fwd,
    "x2y_flash": x2y_attn.x2y_flash_fwd,
    "mha_cross": mha_attn.mha_cross_fwd,
    "sa_sublayer": sa_layer.sa_sublayer,
    "ffn_sublayer": sa_layer.ffn_sublayer,
    "mstcn_dropout_mask": dilated_conv.mstcn_dropout_mask,
    "mstcn_stack_bwd": dilated_conv.mstcn_stack_bwd,
    "x2y_small_x_bwd": x2y_attn.x2y_small_x_bwd,
    "x2y_flash_bwd": x2y_attn.x2y_flash_bwd,
    "frame_loss_fwd": frame_loss.frame_loss_fwd,
    "frame_loss_bwd": frame_loss.frame_loss_bwd,
}
# the plain backward that the K2 dispatch runs on the card (per-batch pos), as JAX does
_PLAIN = {"x2y_bwd_reference": x2y_attn.x2y_bwd_reference}


def kernel_counters() -> dict:
    """How many times each kernel wrapper launched its CUDA kernel."""
    return {name: fn.launches for name, fn in _KERNELS.items()}


def plain_counters() -> dict:
    """How many times the K2 backward dispatch took the plain backward on the card."""
    return {name: fn.launches for name, fn in _PLAIN.items()}


def reset_kernel_counters() -> None:
    for fn in (*_KERNELS.values(), *_PLAIN.values()):
        fn.launches = 0
