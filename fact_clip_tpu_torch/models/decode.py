"""Inference decoding on the last block's saves.

Counterpart of ``fact_clip_tpu/models/decode.py:15-43``: the two-branch
decode blends the action tokens' votes with the frame branch and falls back
to the frame branch when no token predicts a non-null class.
"""

from __future__ import annotations

import torch


def decode_two_branch(action_clogit, a2f_attn, frame_clogit, weight: float, token_mask):
    """action_clogit (B, M, C+1), a2f_attn (B, T, M), frame_clogit (B, T, C),
    token_mask (B, M) bool -> (B, T) int64 class per frame."""
    fbranch = torch.softmax(frame_clogit, dim=-1)
    null_id = action_clogit.shape[-1] - 1
    nonnull = (action_clogit.argmax(dim=-1) != null_id) & token_mask
    has_action = nonnull.any(dim=1)
    qtk_prob = torch.softmax(action_clogit[..., :-1], dim=-1)  # (B, M, C)
    attn = a2f_attn.masked_fill(~nonnull[:, None, :], float("-inf"))
    act_idx = attn.argmax(dim=-1)  # (B, T)
    abranch = qtk_prob.gather(1, act_idx[..., None].expand(-1, -1, qtk_prob.shape[-1]))
    pred = ((1.0 - weight) * abranch + weight * fbranch).argmax(dim=-1)
    return torch.where(has_action[:, None], pred, fbranch.argmax(dim=-1))
