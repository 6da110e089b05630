"""Batched, masked training losses of FACT.

Counterpart of ``fact_clip_tpu/models/losses.py:27-317``, term for term:
every normalizer is computed per video from validity masks, every function
returns a per-video (B,) vector, and the batch loss is the mean of the
per-video losses.  ``frame_ce_smooth`` and ``smooth_loss_opt`` reach the
fused frame-loss kernel (K5, ``ops/frame_loss.py``) when ``use_kernel`` is
set, as the JAX functions reach theirs with ``use_pallas``.

``batch`` is the dict of ``Batch.device_arrays`` as tensors: labels (B, T),
mask (B, T) bool, seg_label (B, T), transcript (B, S), seg_mask (B, S) bool.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.frame_loss import fused_ce_smooth_sums, fused_smooth_sum


def build_class_weights(cfg: dict, nclasses: int, bg_ids, class_weight=None) -> np.ndarray:
    """(C+1,) class weights: 1, bgw at background ids, nullw at the null slot."""
    w = np.ones(nclasses + 1, np.float32)
    w[-1] = cfg["Loss"]["nullw"]
    if class_weight is not None:
        w[:nclasses] = np.asarray(class_weight, np.float32)
    else:
        for i in bg_ids:
            w[i] = cfg["Loss"]["bgw"]
    return w


def compute_null_weight(cfg: dict, dataset) -> dict:
    """Auto nullw = ntoken / (num_null * nclasses), set in ``cfg``."""
    ntoken = cfg["FACT"]["ntoken"]
    num_null = ntoken - dataset.average_transcript_len
    if cfg.get("dataset") == "epic":
        null_weight = ntoken / (num_null * (301 + 98) / 2)
    else:
        null_weight = ntoken / (num_null * dataset.nclasses)
    cfg["Loss"]["nullw"] = float(null_weight)
    return cfg


def masked_log_softmax(logits, mask, dim: int):
    """log_softmax restricted to ``mask`` entries (others held at -1e9)."""
    return torch.log_softmax(torch.where(mask, logits, torch.full_like(logits, -1e9)), dim=dim)


def _clamp_norm(x):
    return x.clamp(min=1e-12)


# ---------------------------------------------------------------------------
# per-loss terms; every function returns a per-video (B,) vector


def action_token_loss(action_clogit, seg2tok, transcript, seg_mask, cweight):
    """Weighted CE of token logits vs matched class, null elsewhere."""
    B, M, C1 = action_clogit.shape
    null_id = C1 - 1
    clabel = torch.full((B, M + 1), null_id, dtype=torch.int64, device=action_clogit.device)
    idx = torch.where(seg_mask, seg2tok.long(), M)  # invalid segments land in the spare column
    val = torch.where(seg_mask, transcript.long(), null_id)
    clabel = clabel.scatter(1, idx, val)[:, :M]
    onehot = F.one_hot(clabel, C1).to(action_clogit.dtype)
    ce = -(torch.log_softmax(action_clogit, dim=-1) * onehot).sum(dim=-1)
    w = onehot @ cweight
    return (ce * w).sum(dim=1) / _clamp_norm(w.sum(dim=1))


def _build_targets(seg_label, frame_mask, seg_mask):
    """Hard frame -> GT-segment membership Y (B, R, S)."""
    S = seg_mask.shape[1]
    Y = F.one_hot(seg_label.long(), S).float() * frame_mask.float()[..., None]
    return Y * seg_mask.float()[:, None, :]


def a2f_attn_loss(logits_r2m, seg2tok, seg_mask, Y, sweight):
    """Cross-attention loss, softmax over the matched-token axis; logits
    (B, R, M), Y (B, R, S)."""
    A = F.one_hot(seg2tok.long(), logits_r2m.shape[2]).to(logits_r2m.dtype)  # (B, S, M)
    G = torch.einsum("brm,bsm->brs", logits_r2m, A)
    logp = masked_log_softmax(G, seg_mask[:, None, :], dim=2)
    loss = -(logp * Y * sweight[:, None, :]).sum(dim=(1, 2))
    return loss / _clamp_norm(Y.sum(dim=(1, 2)))


def f2a_attn_loss(logits_m2r, seg2tok, seg_mask, row_mask, Y, sweight):
    """Cross-attention loss, softmax over rows (frames / predicted segments);
    logits (B, M, R)."""
    A = F.one_hot(seg2tok.long(), logits_m2r.shape[1]).to(logits_m2r.dtype)  # (B, S, M)
    G = torch.einsum("bmr,bsm->bsr", logits_m2r, A)
    logp = masked_log_softmax(G, row_mask[:, None, :], dim=2)
    loss = -(logp * Y.transpose(1, 2) * sweight[:, :, None]).sum(dim=(1, 2))
    return loss / _clamp_norm(Y.sum(dim=(1, 2)))


def frame_loss(frame_clogit, labels, frame_mask, cweight):
    """Class-weighted CE on frame logits, normalized by frame count."""
    C = frame_clogit.shape[-1]
    onehot = F.one_hot(labels.long(), C).to(frame_clogit.dtype)
    ce = -(torch.log_softmax(frame_clogit, dim=-1) * onehot).sum(dim=-1)
    w = onehot @ cweight[:C]
    m = frame_mask.to(ce.dtype)
    return (ce * w * m).sum(dim=1) / _clamp_norm(m.sum(dim=1))


def frame_loss_tdu(seg_clogit, P, labels, cweight):
    """Weighted CE on length-normalized pooled labels."""
    C = seg_clogit.shape[-1]
    onehot = F.one_hot(labels.long(), C).float()
    pooled = torch.einsum("bts,btc->bsc", P, onehot)
    zoomed = pooled / P.sum(dim=1).clamp(min=1.0)[..., None]
    logp = torch.log_softmax(seg_clogit, dim=-1)
    loss = -(logp * zoomed * cweight[:C]).sum(dim=(1, 2))
    return loss / _clamp_norm(zoomed.sum(dim=(1, 2)))


def smooth_loss(logits, pair_mask):
    """Truncated squared difference of adjacent log-softmax rows, masked mean
    over valid adjacent pairs; logits (B, R, C), pair_mask (B, R-1).  The
    JAX function's column mask serves transcript mode only, which is not
    ported."""
    ls = torch.log_softmax(logits, dim=-1)
    d = ((ls[:, 1:] - ls[:, :-1]) ** 2).clamp(0.0, 16.0)
    pm = pair_mask.to(d.dtype)[..., None]
    denom = pair_mask.sum(dim=1) * logits.shape[-1]
    return (d * pm).sum(dim=(1, 2)) / _clamp_norm(denom.to(d.dtype))


def frame_ce_smooth(frame_clogit, labels, frame_mask, cweight, use_kernel: bool = False):
    """(frame_loss, smooth_loss) on frame logits, through K5 with
    ``use_kernel``.  The class weights get no gradient on either path."""
    C = frame_clogit.shape[-1]
    cweight = cweight.detach()
    pair_mask = frame_mask[:, 1:] & frame_mask[:, :-1]
    if use_kernel:
        ce_sum, sl_sum = fused_ce_smooth_sums(frame_clogit, labels, frame_mask, cweight)
        fl = ce_sum / _clamp_norm(frame_mask.float().sum(dim=1))
        sl = sl_sum / _clamp_norm((pair_mask.sum(dim=1) * C).float())
        return fl, sl
    return (frame_loss(frame_clogit, labels, frame_mask, cweight),
            smooth_loss(frame_clogit, pair_mask))


def smooth_loss_opt(logits, frame_mask, use_kernel: bool = False):
    """smooth_loss, through K5 with ``use_kernel``."""
    pair_mask = frame_mask[:, 1:] & frame_mask[:, :-1]
    if use_kernel:
        sl_sum = fused_smooth_sum(logits, frame_mask)
        return sl_sum / _clamp_norm((pair_mask.sum(dim=1) * logits.shape[-1]).float())
    return smooth_loss(logits, pair_mask)


# ---------------------------------------------------------------------------
# per-block compositions


def ref_order_sweight(sweight, seg2tok, seg_mask):
    """Permute segment weights into the reference's matching order."""
    order = torch.argsort(torch.where(seg_mask, seg2tok.long(), 1 << 30), dim=1, stable=True)
    rank = torch.argsort(order, dim=1, stable=True)
    return sweight.gather(1, rank)


def block_loss(saves: dict, batch: dict, seg2tok, cweight, sw: float,
               ref_weight_order: bool = False, use_kernel: bool = False):
    """Per-video loss (B,) of one block (the JAX ``token_mask`` is None
    outside transcript mode, which is not ported)."""
    labels, frame_mask = batch["labels"], batch["mask"]
    seg_label, transcript, seg_mask = batch["seg_label"], batch["transcript"], batch["seg_mask"]

    sweight = torch.where(seg_mask, cweight[transcript.long()], 0.0)
    if ref_weight_order:
        sweight = ref_order_sweight(sweight, seg2tok, seg_mask)

    fl, sl = frame_ce_smooth(saves["frame_clogit"], labels, frame_mask, cweight,
                             use_kernel=use_kernel)
    atk = action_token_loss(saves["action_clogit"], seg2tok, transcript, seg_mask, cweight)

    kind = saves["kind"]
    if kind == "i":
        return fl + atk + sw * sl

    if kind == "u":
        Y = _build_targets(seg_label, frame_mask, seg_mask)
        f2a = f2a_attn_loss(saves["f2a_attn_logit"], seg2tok, seg_mask, frame_mask, Y, sweight)
        a2f = a2f_attn_loss(saves["a2f_attn_logit"], seg2tok, seg_mask, Y, sweight)
        al = smooth_loss_opt(saves["a2f_attn_logit"], frame_mask, use_kernel=use_kernel)
        flog = saves["f2a_attn_logit"].transpose(1, 2)  # (B, T, M)
        fsl = smooth_loss_opt(flog, frame_mask, use_kernel=use_kernel)
        return atk + f2a + a2f + fl + sw * (al + fsl + sl)

    if kind == "U":
        P = saves["tdu_P"]
        seg_loss = frame_loss_tdu(saves["seg_clogit"], P, labels, cweight)
        # soft targets: GT-segment membership pooled over predicted segments
        onehot_gt = (F.one_hot(seg_label.long(), seg_mask.shape[1]).float()
                     * frame_mask.float()[..., None])
        pooled = torch.einsum("btp,bts->bps", P, onehot_gt)
        Y = pooled / P.sum(dim=1).clamp(min=1.0)[..., None] * seg_mask.float()[:, None, :]
        f2a = f2a_attn_loss(saves["f2a_attn_logit"], seg2tok, seg_mask, saves["tdu_seg_valid"],
                            Y, sweight)
        a2f = a2f_attn_loss(saves["a2f_attn_logit"], seg2tok, seg_mask, Y, sweight)
        return (fl + seg_loss) / 2.0 + atk + f2a + a2f + sw * sl

    raise ValueError(kind)


def fact_loss(saves_list, batch, seg2tok, cweight, sw: float,
              ref_weight_order: bool = False, use_kernel: bool = False):
    """Mean over blocks of the per-video block losses -> (B,)."""
    per_block = [block_loss(s, batch, seg2tok, cweight, sw,
                            ref_weight_order=ref_weight_order, use_kernel=use_kernel)
                 for s in saves_list]
    return sum(per_block) / len(per_block)
