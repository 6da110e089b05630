"""The flagship at its full widths against the JAX package on the CPU.

``flagship_cfg()`` (``iuUU``, D=2048, 40 tokens, towers 256 wide with 10
layers, a 6-layer SCA input decoder of 8 heads at a_dim 256) at a small
length (B=2, T=128), in float32 and under ``TPU.compute_dtype: bfloat16``:
JAX's model (its XLA path in f32; in bf16 its Pallas kernels in interpret
mode, the path the port's bf16 forms follow) and the port's plain path on
the exporter's weights.  Tolerances: f32, every block's frame logits within
1e-4 absolute (``test_torch_port_model.py``'s) and 99 % of the decoded frames
equal; bf16, within 2e-2 of scale and 95 % equal
(``test_torch_port_bf16.py``'s).  Each case takes 25-45 s on one worker, most
of it JAX compiling the flagship (in interpret mode for bf16).
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _make_cfg
from fact_clip_tpu.models import blocks as jblocks
from fact_clip_tpu.models import decode as jdecode
from fact_clip_tpu.ops.pallas import dilated_conv as jdc
from fact_clip_tpu.ops.pallas import mha_attn as jmha
from fact_clip_tpu.ops.pallas import sa_layer as jsa
from fact_clip_tpu.ops.pallas import x2y_attn as jx2y
from fact_clip_tpu_torch.configs import flagship_cfg
from fact_clip_tpu_torch.engine.steps import make_eval_step
from fact_clip_tpu_torch.models.blocks import build_fact
from fact_clip_tpu_torch.utils.bridge import load_jax_params

torch.set_num_threads(2)
D, C, S_CAP, B, T = 2048, 75, 32, 2, 128
F32_ATOL, F32_AGREE = 1e-4, 0.99
BF16_TOL, BF16_AGREE = 2e-2, 0.95


def _interp(fn):
    def f(*a, **kw):
        return fn(*a, **dict(kw, interpret=True))
    return f


def _jax_patches(bf16: bool):
    if not bf16:
        return []
    return [mock.patch.object(jblocks, "_PALLAS_PLATFORM_OVERRIDE", "tpu"),
            mock.patch.object(jdc, "dilated_residual_stack", _interp(jdc.dilated_residual_stack)),
            mock.patch.object(jx2y, "x2y_attention", _interp(jx2y.x2y_attention)),
            mock.patch.object(jmha, "mha_cross_attention", _interp(jmha.mha_cross_attention)),
            mock.patch.object(jsa, "sa_sublayer", _interp(jsa.sa_sublayer)),
            mock.patch.object(jsa, "ffn_sublayer", _interp(jsa.ffn_sublayer))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flagship_widths_match_jax(dtype):
    bf16 = dtype == "bfloat16"
    jcfg = _make_cfg(small=False)
    jcfg.TPU.compute_dtype = dtype
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((B, T, D)).astype(np.float32)
    lengths = np.array([T, 97], np.int32)
    mask = np.arange(T)[None] < lengths[:, None]
    feats[~mask] = 0.0
    args = (jnp.asarray(feats), jnp.asarray(mask), jnp.asarray(lengths))
    patches = _jax_patches(bf16)
    for p in patches:
        p.start()
    try:
        model = jblocks.build_fact(jcfg, D, C, s_pred_cap=S_CAP)
        params = model.init({"params": jax.random.PRNGKey(0)}, *args, train=False)
        saves, _ = model.apply(params, *args, train=False)
    finally:
        for p in patches:
            p.stop()
    last = saves[-1]
    ref_pred = np.asarray(jdecode.decode_two_branch(
        last["action_clogit"], last["a2f_attn"], last["frame_clogit"], float(jcfg.FACT.mwt),
        jnp.ones(last["action_clogit"].shape[:2], bool)))

    cfg = flagship_cfg()
    cfg["TPU"]["compute_dtype"] = dtype
    port = build_fact(cfg, D, C, S_CAP, device="cpu")
    load_jax_params(port, jax.tree_util.tree_map(np.asarray, params["params"]))
    x = [torch.from_numpy(a) for a in (feats, mask, lengths)]
    with torch.no_grad():
        got, _ = port(*x)
    for i, (sp, sj) in enumerate(zip(got, saves)):
        g, r = sp["frame_clogit"].numpy()[mask], np.asarray(sj["frame_clogit"])[mask]
        if bf16:
            rel = float(np.abs(g - r).max() / np.abs(r).max())
            assert rel <= BF16_TOL, (i, rel)
        else:
            np.testing.assert_allclose(g, r, atol=F32_ATOL, err_msg=f"block {i}")
    pred = make_eval_step(port, float(jcfg.FACT.mwt))(*x).numpy()
    agree = float(np.mean(pred[mask] == ref_pred[mask]))
    assert agree >= (BF16_AGREE if bf16 else F32_AGREE), agree
