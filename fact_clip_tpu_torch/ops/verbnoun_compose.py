"""Lazy verb/noun action composition.

Counterpart of ``fact_clip_tpu/ops/verbnoun_compose.py``: the epic model's
action space is the outer composition of its verb and noun heads,
``logp_a = lv[..., vids[a]] + ln[..., nids[a]]`` (3,806 actions at epic
scale).  The blocks save the factored log-probs; these functions compose
them where a consumer needs it.  With ``kernel`` (the model's kernels on)
the argmax and the decode's blend go to the K7 wrappers
(``ops/compose_decode.py``), which launch their CUDA kernels on CUDA tensors
and run their plain versions on CPU ones; without it they are JAX's dense
path (one transient (B, T, n_act) pass).  The factored argmax, which no
model path runs, is the K7c wrapper itself.  ``composed_smooth_loss`` (the
training loss; JAX has no kernel for it) is JAX's dense path.  JAX's
``chunk`` streaming variants are not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.decode import token_probs, votes
from . import compose_decode as k7


def composed_gather(lv, ln, vids, nids, action_idx):
    """logp of given action indices: lv[..., vids[a]] + ln[..., nids[a]]; (...)."""
    idx = action_idx.long()
    v = lv.gather(-1, vids.long()[idx][..., None])[..., 0]
    n = ln.gather(-1, nids.long()[idx][..., None])[..., 0]
    return v + n


def build_factored_tables(vids, nids, n1: int, n2: int):
    """Static (verb, noun) tables of the factored argmax (numpy): mask_vn[v, n]
    = 0 where (v, n) is an action and -inf elsewhere; a_table[v, n] its
    action index (0 elsewhere, never selected)."""
    vids, nids = np.asarray(vids), np.asarray(nids)
    mask_vn = np.full((n1, n2), -np.inf, np.float32)
    a_table = np.zeros((n1, n2), np.int32)
    mask_vn[vids, nids] = 0.0
    a_table[vids, nids] = np.arange(len(vids), dtype=np.int32)
    return mask_vn, a_table


def composed_argmax_factored(lv, ln, mask_vn, a_table):
    """Exact composed argmax via max_a lv[v(a)] + ln[n(a)] = max_v (lv[v] +
    max_{n in N(v)} ln[n]); ties break verb first, then noun."""
    return k7.factored_argmax(lv, ln, mask_vn, a_table)


def composed_argmax(lv, ln, vids, nids, kernel: bool = False):
    """First argmax over the actions of the composed log-prob: (B, T) int32."""
    if kernel:
        return k7.compose_argmax(lv.detach().contiguous(), ln.detach().contiguous(), vids, nids)
    return k7.compose_argmax_reference(lv, ln, vids, nids)


def composed_smooth_loss(lv, ln, vids, nids, pair_mask):
    """The smoothing loss over the composed log-probs (JAX's dense form,
    ``chunk >= n_act``): the mean over valid adjacent frame pairs and all
    n_act actions of clip(diff^2, 0, 16), diff the composed log-prob's step
    in time; (B,), differentiable.  It makes dense (B, T-1, n_act)
    transients (374 MB each at 1 x 24,576 x 3,806), as JAX's does."""
    n_act = vids.shape[0]
    d = (lv[:, 1:] - lv[:, :-1])[..., vids.long()] + (ln[:, 1:] - ln[:, :-1])[..., nids.long()]
    d = (d * d).clamp(0.0, 16.0)
    total = (d * pair_mask.to(d.dtype)[..., None]).sum(dim=(1, 2))
    return total / (pair_mask.sum(dim=1) * n_act).to(d.dtype).clamp(min=1e-12)


def composed_decode(action_logp, a2f_attn, lv, ln, vids, nids, weight: float, token_mask,
                    kernel: bool = False):
    """The two-branch verb/noun decode without a persistent (T, n_act)
    tensor: per frame, blend the voting token's renormalised action probs
    with exp(composed logp) and argmax; fall back to the composed argmax in
    a video where every token predicts null.  Equals
    ``models/decode.py::decode_two_branch_logp`` on frame_logp = compose(lv,
    ln).  Returns (B, T) int32."""
    has_action, act_idx = votes(action_logp, a2f_attn, token_mask)
    qtk_prob = token_probs(action_logp)
    if kernel:
        pred, fb = k7.compose_blend(lv.detach().contiguous(), ln.detach().contiguous(), vids,
                                    nids, qtk_prob.detach().contiguous(),
                                    act_idx.to(torch.int32), weight)
    else:
        pred, fb = k7.compose_blend_reference(lv, ln, vids, nids, qtk_prob, act_idx, weight)
    return torch.where(has_action[:, None], pred, fb)
