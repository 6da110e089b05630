"""The eval step: forward through every block, then the two-branch decode.

Counterpart of the vanilla branch of ``fact_clip_tpu/engine/steps.py``
(``_apply`` + ``_decode``, ``eval_step`` at :149-152).
"""

from __future__ import annotations

import torch

from ..models import decode


def make_eval_step(model, mwt: float):
    """eval_step(feats (B, T, D), mask (B, T) bool, lengths (B,)) -> (B, T) int64."""

    def eval_step(feats, mask, lengths):
        with torch.inference_mode():
            saves, _ = model(feats, mask, lengths)
            last = saves[-1]
            token_mask = torch.ones(last["action_clogit"].shape[:2], dtype=torch.bool,
                                    device=feats.device)
            return decode.decode_two_branch(last["action_clogit"], last["a2f_attn"],
                                            last["frame_clogit"], mwt, token_mask)

    return eval_step
