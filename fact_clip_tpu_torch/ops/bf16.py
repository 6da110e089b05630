"""Mixed precision's arithmetic, shared by the bf16 forms of K1-K4 and the
layers (``TPU.compute_dtype: bfloat16``).

JAX's policy (``fact_clip_tpu/models/layers.py:31-35``): heavy products
take bf16 operands and accumulate in f32; softmax, LayerNorm statistics,
probabilities and logits stay f32; parameters stay f32 and are cast where
they are used.  A product of two bf16 values is exact in f32, so the plain
versions compute ``a.float() @ b.float()`` on bf16-valued operands and round
with ``.to(bfloat16)`` exactly where JAX rounds.  They never multiply bf16
tensors directly: ``torch.matmul`` on bf16 rounds its output (and may sum in
reduced precision on the card), which JAX's ``preferred_element_type=f32``
products do not.
"""

from __future__ import annotations

import torch

BF16 = torch.bfloat16


def rnd(x):
    """x rounded to bf16 (to nearest, ties to even) and held as f32."""
    return x.to(BF16).float()


def mm(a, w):
    """a @ w on bf16 operands with an f32 result: a (..., K) and w (K, N)
    are rounded to bf16 (a no-op where they are bf16 already), their
    products are exact in f32 and their sums f32."""
    return a.to(BF16).float() @ w.to(BF16).float()


def add_pos16(x, pos):
    """bf16(x + pos) on the leading pos.shape[-1] channels, x and pos bf16
    (JAX adds a zero-extended bf16 table in f32 and rounds once); x where
    pos is None."""
    if pos is None:
        return x
    d = pos.shape[-1]
    lead = (x[..., :d].float() + pos.float()).to(BF16)
    return lead if d == x.shape[-1] else torch.cat([lead, x[..., d:]], dim=-1)


def dense16(x, w, b):
    """flax ``nn.Dense(dtype=bfloat16)`` of torch-layout (out, in) weights:
    bf16(bf16(x @ W) + bf16(b)), a bf16 result."""
    return (rnd(x.to(BF16).float() @ w.to(BF16).float().t()) + rnd(b)).to(BF16)
