"""JAX parameters (and gradients) -> the port's state_dict layout.

The port's module paths reproduce the reference's torch keys, so the bridge
is the exporter (``utils/torch_export.py``, the port's own numpy-only copy of
the JAX package's) plus ``load_state_dict(strict=True)``.  The exporter only
transposes and reshapes, which are linear, so it maps a gradient tree as
well.  Nothing here imports JAX or the JAX package: the parameters arrive as
numpy (or any array) leaves.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.verbnoun import VerbNounFACT
from .torch_export import export_fact_state_dict, export_verbnoun_state_dict


def state_dict_from_jax(params, block_cfgs, verbnoun: bool = False) -> dict:
    """params: the flax ``variables["params"]`` tree of FACT or FACT_CLIP
    (``{"fact", "frame_projection"}``), or of VerbNounFACT with ``verbnoun``
    (numpy or jax arrays); block_cfgs: the port's (or the JAX package's)
    BlockCfg tuple."""
    export = export_verbnoun_state_dict if verbnoun else export_fact_state_dict
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in export(params, block_cfgs).items()}


def load_jax_params(model, params) -> None:
    """Load JAX FACT, FACT_CLIP or VerbNounFACT parameters into the port's
    model of the same kind, strictly."""
    verbnoun = isinstance(model, VerbNounFACT)
    model.load_state_dict(state_dict_from_jax(params, model.block_cfgs, verbnoun), strict=True)


def grads_from_jax(grads, block_cfgs, verbnoun: bool = False) -> dict:
    """A JAX gradient tree of FACT's or FACT_CLIP's (or with ``verbnoun``
    VerbNounFACT's) params -> {port parameter name: gradient}."""
    return state_dict_from_jax(grads, block_cfgs, verbnoun)
