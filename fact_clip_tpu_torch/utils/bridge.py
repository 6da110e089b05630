"""JAX parameters -> the port's state_dict.

The JAX package's exporter (``fact_clip_tpu/utils/torch_export.py``,
numpy-only) already writes the reference's torch layout, and the port's
module paths reproduce those keys, so the bridge is that exporter plus
``load_state_dict(strict=True)``.  It is imported lazily: the port's serving
path imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch


def state_dict_from_jax(params, block_cfgs) -> dict:
    """params: the flax ``variables["params"]`` tree of FACT (numpy or jax
    arrays); block_cfgs: the port's (or the JAX package's) BlockCfg tuple."""
    from fact_clip_tpu.utils.torch_export import export_fact_state_dict

    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in export_fact_state_dict(params, block_cfgs).items()}


def load_jax_params(model, params) -> None:
    """Load JAX FACT parameters into a port FACT model, strictly."""
    model.load_state_dict(state_dict_from_jax(params, model.block_cfgs), strict=True)
