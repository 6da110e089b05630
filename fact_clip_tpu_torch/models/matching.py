"""Token <-> ground-truth-segment matching (o2o and o2m).

Counterpart of ``fact_clip_tpu/models/matching.py``: the cost
-pc * P(segment class) - a2fc * softIoU(a2f attention, segment) is computed
on the device without gradient and crosses to the host, where

* ``o2o``: scipy's Hungarian solver assigns one token to every valid segment;
* ``o2m``: the reference's greedy two-stage matching: a Hungarian match of
  tokens to the video's classes, then each segment takes its cheapest token
  of its class (a token may serve several segments of one class).

* ``seq`` (transcript mode, where the tokens are the transcript): token k
  is segment k, with no cost computed.

With ``matcher: auction`` both modes run on the device instead, through
the port's Bertsekas auction (``ops/assignment.py``), with JAX's
rarely-taken sequential fallback (``run_match``).  ``auto`` is ``host``.

The result is ``seg2tok (B, S)``, the token index of each ground-truth
segment.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment

from ..ops import assignment


def soft_iou(a2f_attn, seg_label, seg_mask, frame_mask):
    """(B, M, S) soft IoU between token attention columns (a2f_attn (B, T, M))
    and ground-truth segments, in the closed form union = seg_len +
    attn_sum - overlap."""
    S = seg_mask.shape[1]
    fm = frame_mask.to(a2f_attn.dtype)[..., None]
    onehot = torch.nn.functional.one_hot(seg_label.long(), S).to(a2f_attn.dtype) * fm
    attn = a2f_attn * fm
    overlap = torch.einsum("btm,bts->bms", attn, onehot)
    union = onehot.sum(dim=1)[:, None, :] + attn.sum(dim=1)[:, :, None] - overlap
    iou = torch.where(union > 0, overlap / union.clamp(min=1e-12), torch.zeros_like(union))
    return iou * seg_mask.to(iou.dtype)[:, None, :]


def match_cost(action_cprob, a2f_attn, transcript, seg_label, seg_mask, frame_mask,
               pc: float, a2fc: float):
    """Matching cost (B, M, S), no gradient."""
    with torch.no_grad():
        B, M = action_cprob.shape[:2]
        cost = action_cprob.new_zeros((B, M, transcript.shape[1]))
        if pc > 0:
            idx = transcript.long()[:, None, :].expand(-1, M, -1)
            cost = cost - pc * action_cprob.gather(2, idx)
        if a2fc > 0:
            cost = cost - a2fc * soft_iou(a2f_attn, seg_label, seg_mask, frame_mask)
        return cost


def hungarian_host(cost: np.ndarray, nsegs: np.ndarray) -> np.ndarray:
    """o2o: scipy Hungarian per video on the valid segment prefix."""
    B, M, S = cost.shape
    out = np.zeros((B, S), np.int32)
    for b in range(B):
        s = int(nsegs[b])
        if s == 0:
            continue
        rows, cols = linear_sum_assignment(cost[b, :, :s])
        out[b, cols] = rows.astype(np.int32)
    return out


def o2m_host(cost: np.ndarray, transcript: np.ndarray, nsegs: np.ndarray) -> np.ndarray:
    """o2m: the reference's greedy two-stage matching per video, in JAX's
    loop order and numpy types (``_o2m_host``, matching.py:75-107)."""
    B, M, S = cost.shape
    out = np.zeros((B, S), np.int32)
    for b in range(B):
        s = int(nsegs[b])
        if s == 0:
            continue
        c = cost[b, :, :s]
        trans = transcript[b, :s]
        actions = np.unique(trans)

        # stage 1: Hungarian between tokens and classes (summed column costs);
        # a token left over takes its cheapest class
        token2action_cost = np.stack([c[:, trans == a].sum(1) for a in actions], axis=1)
        aid, cid = linear_sum_assignment(token2action_cost)
        unassigned = [a for a in range(M) if a not in aid]
        unassigned_cid = token2action_cost[unassigned].argmin(1)
        all_aid = np.array(list(aid) + unassigned)
        all_cid = np.array([actions[i] for i in list(cid) + list(unassigned_cid)])
        token_cid = np.zeros(M)
        token_cid[all_aid] = all_cid

        # stage 2: per class, each segment takes its cheapest token of that class
        for a in actions:
            seg_where = np.where(trans == a)[0]
            token_where = np.where(token_cid == a)[0]
            assign = c[token_where][:, seg_where].argmin(0)
            for sidx, tpos in zip(seg_where, assign):
                out[b, sidx] = token_where[tpos]
    return out


def resolve_matcher(matcher: str = "auto") -> str:
    """``auto`` is the host's scipy in the port; ``auction`` the device's."""
    matcher = matcher or "auto"
    if matcher not in ("auto", "host", "auction"):
        raise ValueError(f"unknown matcher {matcher!r} (auto, host or auction)")
    return "host" if matcher == "auto" else matcher


def run_match_auction(cost, transcript, seg_mask, mode: str, nclasses: int = None,
                      phases: int = 1, stats=None):
    """The device matching of JAX's ``run_match`` (matching.py:134-170) on a
    batch: ``auction_assign`` (o2o) or ``o2m_assign`` (o2m), each running
    JAX's sequential fallback only where a video of the batch left a
    segment unassigned.  seg2tok (B, S) int32; ``stats``, a dict, receives
    the auction's per-video iterations."""
    seg_mask = seg_mask.bool()
    if mode == "o2o":
        st, info = assignment.auction_assign(cost, seg_mask, phases=phases, with_stats=True)
    elif mode == "o2m":
        if nclasses is None:
            raise ValueError("o2m on the device needs the class count")
        st, info = assignment.o2m_assign(cost, transcript.to(torch.int32), seg_mask, nclasses,
                                         phases=phases, with_stats=True)
    else:
        raise ValueError(f"unknown match mode {mode!r}")
    if stats is not None:
        stats["iterations"] = info["iterations"]
    return st


def match(loss_cfg: dict, action_cprob, a2f_attn, transcript, seg_label, seg_mask,
          frame_mask, matcher: str = "auto", nclasses: int = None, phases: int = 1,
          stats=None):
    """The cost on the device, then ``loss_cfg["match"]`` (o2o or o2m) on the
    host (``matcher`` host or auto) or on the device (auction): seg2tok (B,
    S) int64 on the inputs' device; ``seq`` is the identity
    (matching.py:186-189)."""
    mode = loss_cfg["match"]
    if mode == "seq":
        B, S = transcript.shape
        return torch.arange(S, device=transcript.device).repeat(B, 1)
    if mode not in ("o2o", "o2m"):
        raise ValueError(f"unknown match mode {mode!r} (o2o, o2m or seq)")
    cost = match_cost(action_cprob, a2f_attn, transcript, seg_label, seg_mask, frame_mask,
                      float(loss_cfg["pc"]), float(loss_cfg["a2fc"]))
    if resolve_matcher(matcher) == "auction":
        with torch.no_grad():
            st = run_match_auction(cost.float(), transcript, seg_mask, mode, nclasses, phases,
                                   stats)
        return st.to(torch.int64)
    cost = cost.float().cpu().numpy()
    nsegs = seg_mask.sum(dim=1).cpu().numpy()
    if mode == "o2o":
        host = hungarian_host(cost, nsegs)
    else:
        host = o2m_host(cost, transcript.to(torch.int32).cpu().numpy(), nsegs)
    return torch.from_numpy(host).to(device=transcript.device, dtype=torch.int64)
