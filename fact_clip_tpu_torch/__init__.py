"""fact_clip_tpu_torch: the PyTorch / NVIDIA H100 port of fact_clip_tpu.

The JAX package ``fact_clip_tpu`` is the reference; this package mirrors its
layout where that helps find a module's counterpart:

configs/          BlockCfg, resolve_block_cfgs, flagship_cfg, train_cfg,
                  breakfast_cfg, breakfast_train_cfg, breakfast_bf16_cfg, epic_cfg,
                  epic_train_cfg,
                  epic_vocab, flagship_int8_cfg, breakfast_int8_cfg,
                  epic_int8_cfg, egoprocel_cfg, egoprocel_train_cfg,
                  openvocab_cfg, openvocab_train_cfg; the
                  default tree, CfgNode and setup_cfg; yaml_lite, which reads
                  the JAX package's YAML recipes as data (no PyYAML)
data/             the dataset registry, bucketed loaders, the prefetcher, the
                  synthetic fixture writers, and FACT_CLIP's prompts and
                  text-embedding cache
models/           layers, blocks (FACT), FACT_CLIP (FACTCLIP), the verb/noun
                  model (VerbNounFACT), the two-branch and CLIP decodes,
                  matching (o2o, o2m; scipy on the host, or the auction on
                  the device), losses (FACT's, the verb/noun model's
                  and FACT_CLIP's contrastive ones)
ops/              the hand-written CUDA kernels (K1-K6, forwards with dropout
                  and backwards, and the single-layer K1; the shared dropout
                  mask; K7, the composed verb/noun argmaxes; K8, int8
                  evaluation) beside their plain PyTorch versions;
                  the lazy verb/noun composition; TDU segment operations;
                  training masks; positional terms
engine/           the eval and train steps, the serving Predictor (FACT,
                  FACT_CLIP and VerbNounFACT), the optimizer, the training loop (run_train,
                  evaluate), experiment setup, checkpoints with resume, logging
utils/            the FACT, FACT_CLIP and verb/noun exporter (its own copy), the bridge
                  (JAX parameters (numpy) -> this package's state_dict), and
                  segments, metrics and the results Checkpoint
train.py          python -m fact_clip_tpu_torch.train --cfg <yaml> [--device cpu] --set k v ...
run_eval.py       python -m fact_clip_tpu_torch.run_eval --cfg <yaml> --ckpt <file> [--device cpu]
csrc/             CUDA C++ sources for sm_90a, built by _build.py on first use

The entry points run on the CUDA card and refuse to start without one
unless given the CPU (``device="cpu"``, ``--device cpu``).  Everything runs
in float32 but FACT under ``TPU.compute_dtype: bfloat16`` (JAX's mixed
precision: the bf16 forms of K1-K4 and K6, forward and backward, ``ops/bf16.py``),
served, evaluated and trained at dropout 0.  Importing this package imports neither JAX nor the JAX package
nor PyYAML, and builds nothing.
"""

from .ops import compose_decode, dilated_conv, frame_loss, mha_attn, quant_conv, sa_layer, x2y_attn

# launch counters of the kernel wrappers, by kernel name
_KERNELS = {
    "mstcn_stack": dilated_conv.mstcn_stack_fwd,
    "dilated_residual_layer": dilated_conv.dilated_residual_layer_fwd,
    "x2y_small_x": x2y_attn.x2y_small_x_fwd,
    "x2y_flash": x2y_attn.x2y_flash_fwd,
    "mha_cross": mha_attn.mha_cross_fwd,
    "sa_sublayer": sa_layer.sa_sublayer_fwd,
    "ffn_sublayer": sa_layer.ffn_sublayer_fwd,
    "mstcn_dropout_mask": dilated_conv.mstcn_dropout_mask,
    "mha_dropout_mask": mha_attn.mha_dropout_mask,
    "sa_dropout_masks": sa_layer.sa_dropout_masks,
    "ffn_dropout_masks": sa_layer.ffn_dropout_masks,
    "mha_cross_bwd": mha_attn.mha_cross_bwd,
    "sa_sublayer_bwd": sa_layer.sa_sublayer_bwd,
    "ffn_sublayer_bwd": sa_layer.ffn_sublayer_bwd,
    "mstcn_stack_bwd": dilated_conv.mstcn_stack_bwd,
    "x2y_small_x_bwd": x2y_attn.x2y_small_x_bwd,
    "x2y_flash_bwd": x2y_attn.x2y_flash_bwd,
    "frame_loss_fwd": frame_loss.frame_loss_fwd,
    "frame_loss_bwd": frame_loss.frame_loss_bwd,
    "mstcn2_stack": dilated_conv.mstcn2_stack_fwd,
    "mstcn2_stack_bwd": dilated_conv.mstcn2_stack_bwd,
    "compose_argmax": compose_decode.compose_argmax,
    "compose_blend": compose_decode.compose_blend,
    "factored_argmax": compose_decode.factored_argmax,
    "mstcn_stack_q8": quant_conv.mstcn_stack_q8,
    "mstcn2_stack_q8": quant_conv.mstcn2_stack_q8,
    "mstcn_stack_q8_row": quant_conv.mstcn_q8_row_count,
    "mstcn2_stack_q8_row": quant_conv.mstcn2_q8_row_count,
    "x2y_small_x_q8": quant_conv.x2y_small_x_q8,
    "x2y_flash_q8": quant_conv.x2y_flash_q8,
    "mha_cross_q8": quant_conv.mha_cross_q8,
    "mstcn_stack16": dilated_conv.mstcn_stack16,
    "x2y_small_x16": x2y_attn.x2y_small_x16_fwd,
    "x2y_flash16": x2y_attn.x2y_flash16_fwd,
    "mha_cross16": mha_attn.mha_cross16_fwd,
    "sa_sublayer16": sa_layer.sa_sublayer16_fwd,
    "ffn_sublayer16": sa_layer.ffn_sublayer16_fwd,
    "mstcn2_stack16": dilated_conv.mstcn2_stack16,
    # the bf16 backward forms (training under mixed precision)
    "mstcn_stack16_bwd": dilated_conv.mstcn_stack16_bwd,
    "mstcn2_stack16_bwd": dilated_conv.mstcn2_stack16_bwd,
    "x2y_small_x16_bwd": x2y_attn.x2y_small_x16_bwd,
    "x2y_flash16_bwd": x2y_attn.x2y_flash16_bwd,
    "mha_cross16_bwd": mha_attn.mha_cross16_bwd,
    "sa_sublayer16_bwd": sa_layer.sa_sublayer16_bwd,
    "ffn_sublayer16_bwd": sa_layer.ffn_sublayer16_bwd,
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
