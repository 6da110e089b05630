"""Token <-> ground-truth-segment matching (o2o).

Counterpart of ``fact_clip_tpu/models/matching.py``: the cost
-pc * P(segment class) - a2fc * softIoU(a2f attention, segment) is computed
on the device without gradient, crosses to the host, and scipy's Hungarian
solver assigns one token to every valid segment of each video.  The result is
``seg2tok (B, S)``, the token index of each ground-truth segment.  o2m and the
on-device auction (a TPU workaround) are not ported.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment


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


def match(loss_cfg: dict, action_cprob, a2f_attn, transcript, seg_label, seg_mask,
          frame_mask):
    """Cost on the device, Hungarian on the host: seg2tok (B, S) int64 on
    the inputs' device.  Only o2o matching is ported."""
    if loss_cfg["match"] != "o2o":
        raise ValueError(f"match mode {loss_cfg['match']!r} is not ported (o2o only)")
    cost = match_cost(action_cprob, a2f_attn, transcript, seg_label, seg_mask, frame_mask,
                      float(loss_cfg["pc"]), float(loss_cfg["a2fc"]))
    nsegs = seg_mask.sum(dim=1)
    host = hungarian_host(cost.float().cpu().numpy(), nsegs.cpu().numpy())
    return torch.from_numpy(host).to(device=transcript.device, dtype=torch.int64)
