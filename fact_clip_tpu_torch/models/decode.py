"""Inference decoding on the last block's saves.

Counterpart of ``fact_clip_tpu/models/decode.py``: the two-branch decode
blends the action tokens' votes with the frame branch and falls back to the
frame branch when no token predicts a non-null class; its verb/noun variant
does the same on composed log-probs, and FACT_CLIP's zero-shot decode on the
CLIP similarities in place of the frame branch.  In transcript mode the
decode picks, for each frame, one of the video's transcript entries: by the
a2f attention over the transcript's columns blended with the frame branch
at the transcript's classes (FACT), or by that attention alone (the
verb/noun model).  ``votes`` and
``token_probs`` are shared with ``ops/verbnoun_compose.py::composed_decode``.
"""

from __future__ import annotations

import torch


def votes(action_score, a2f_attn, token_mask):
    """Which token votes for each frame -> (has_action (B,), act_idx (B, T)).
    A token votes when it is valid and the argmax of its action_score (B, M,
    C+1; logits or log-probs) is not the null class C; a frame takes the
    voting token it attends to most in a2f_attn (B, T, M)."""
    null_id = action_score.shape[-1] - 1
    nonnull = (action_score.argmax(dim=-1) != null_id) & token_mask
    act_idx = a2f_attn.masked_fill(~nonnull[:, None, :], float("-inf")).argmax(dim=-1)
    return nonnull.any(dim=1), act_idx


def token_probs(action_logp):
    """The tokens' non-null class probs, exp(logp) renormalised: (B, M, C)."""
    q = torch.exp(action_logp[..., :-1])
    return q / q.sum(dim=-1, keepdim=True).clamp(min=1e-12)


def _blend(qtk_prob, act_idx, fbranch, weight: float, has_action):
    abranch = qtk_prob.gather(1, act_idx[..., None].expand(-1, -1, qtk_prob.shape[-1]))
    pred = ((1.0 - weight) * abranch + weight * fbranch).argmax(dim=-1)
    return torch.where(has_action[:, None], pred, fbranch.argmax(dim=-1))


def decode_two_branch(action_clogit, a2f_attn, frame_clogit, weight: float, token_mask):
    """action_clogit (B, M, C+1), a2f_attn (B, T, M), frame_clogit (B, T, C),
    token_mask (B, M) bool -> (B, T) int64 class per frame."""
    has_action, act_idx = votes(action_clogit, a2f_attn, token_mask)
    qtk_prob = torch.softmax(action_clogit[..., :-1], dim=-1)  # (B, M, C)
    return _blend(qtk_prob, act_idx, torch.softmax(frame_clogit, dim=-1), weight, has_action)


def decode_two_branch_logp(action_logp, a2f_attn, frame_logp, weight: float, token_mask):
    """The verb/noun variant (``decode.py:65-87``): the inputs are composed
    action log-probs, action_logp (B, M, C+1) and frame_logp (B, T, C); token
    probs are exp(logp) renormalised over the non-null classes.  The dense
    definition that ``ops/verbnoun_compose.py::composed_decode`` equals."""
    has_action, act_idx = votes(action_logp, a2f_attn, token_mask)
    return _blend(token_probs(action_logp), act_idx, torch.exp(frame_logp), weight, has_action)


def decode_with_clip(action_clogit, a2f_attn, frame_emb, text_emb, temp: float, weight: float,
                     token_mask):
    """FACT_CLIP's zero-shot decode (``decode.py:99``): the softmax of the
    frames' cosine similarities to every class's text embedding, frame_emb
    (B, T, E) against text_emb (n, E) at ``temp``, replaces the frame branch
    and is blended with the tokens' votes at ``weight``; a video with no
    voting token takes the CLIP argmax.  -> (B, T) int64 class per frame."""
    fbranch = torch.softmax(torch.matmul(frame_emb, text_emb.t()) / temp, dim=-1)
    has_action, act_idx = votes(action_clogit, a2f_attn, token_mask)
    qtk_prob = torch.softmax(action_clogit[..., :-1], dim=-1)
    return _blend(qtk_prob, act_idx, fbranch, weight, has_action)


def _transcript_pick(transcript, seg_mask, score):
    """transcript (B, S) ids at the argmax of score (B, T, S) over the valid
    columns (-inf at the padding; the first of tied columns)."""
    score = score.masked_fill(~seg_mask[:, None, :], float("-inf"))
    return transcript.long().gather(1, score.argmax(dim=-1))


def decode_with_transcript(transcript, seg_mask, a2f_attn, frame_clogit, weight: float):
    """FACT's transcript decode (``decode.py:46-62``): the softmax of the a2f
    attention probabilities (B, T, S) over the transcript's valid columns,
    blended at ``weight`` with the frame branch's probabilities of the
    transcript's classes; each frame takes the class of its best column ->
    (B, T) int64."""
    fbranch = torch.softmax(frame_clogit, dim=-1)  # (B, T, C)
    fbranch = fbranch.gather(2, transcript.long()[:, None, :].expand(-1, fbranch.shape[1], -1))
    abranch = torch.softmax(a2f_attn.masked_fill(~seg_mask[:, None, :], float("-inf")), dim=-1)
    return _transcript_pick(transcript, seg_mask, (1.0 - weight) * abranch + weight * fbranch)


def decode_transcript_attn_only(transcript, seg_mask, a2f_attn):
    """The verb/noun model's transcript decode (``decode.py:90-96``): each
    frame takes the transcript entry it attends to most -> (B, T) int64."""
    return _transcript_pick(transcript, seg_mask, a2f_attn)
