"""Positional terms: the sinusoid table, ``add_pos`` and their kernel form.

Counterpart of ``fact_clip_tpu/models/layers.py:203-231``.  A positional
tensor may be narrower than the stream it shifts: it is added to the leading
channels only (the reference's add_positional_encoding).
"""

from __future__ import annotations

import math

import torch


def positional_encoding_table(length: int, d_model: int, empty: bool = False, device=None):
    """(length, d_model) sin/cos table; zeros when ``empty`` (FACT.fpos off)."""
    pe = torch.zeros((length, d_model), dtype=torch.float32, device=device)
    if empty:
        return pe
    position = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    div_term = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32, device=device)
                         * (-math.log(10000.0) / d_model))
    ang = position * div_term
    pe[:, 0::2] = torch.sin(ang)
    pe[:, 1::2] = torch.cos(ang[:, : d_model // 2])
    return pe


def add_pos(x, pos):
    """x + pos on the leading pos.shape[-1] channels (pos broadcasts over batch)."""
    if pos is None:
        return x
    d = pos.shape[-1]
    if d == x.shape[-1]:
        return x + pos
    return torch.cat([x[..., :d] + pos, x[..., d:]], dim=-1)


def kernel_pos(pos, B: int, N: int, C: int):
    """A positional term as kernel arguments: (contiguous (Bp, N, P) tensor or
    None, batch stride in elements (0 when shared by the batch), P)."""
    if pos is None:
        return None, 0, 0
    if pos.dim() == 2:
        pos = pos[None]
    Bp, Np, P = pos.shape
    if Np != N or P > C or Bp not in (1, B):
        raise ValueError(f"positional term {tuple(pos.shape)} does not fit ({B}, {N}, {C})")
    pos = pos.contiguous()
    return pos, (0 if Bp == 1 else N * P), P


def pos_grad(d_in, pos):
    """The cotangent of a positional term from that of the stream it shifts:
    its leading channels, summed over the batch where ``pos`` is shared."""
    if pos is None:
        return None
    g = d_in[..., :pos.shape[-1]]
    if pos.dim() == 2:
        return g.sum(dim=0)
    if pos.shape[0] == 1 and g.shape[0] != 1:
        return g.sum(dim=0, keepdim=True)
    return g
