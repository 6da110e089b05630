"""Batched, masked training losses of FACT and of the verb/noun model.

Counterpart of ``fact_clip_tpu/models/losses.py:27-436`` (FACT_CLIP's
contrastive losses included), term for term:
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
from ..ops.verbnoun_compose import composed_gather, composed_smooth_loss


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


def frame_loss_tdu(seg_clogit, P, labels, cweight, is_logit: bool = True):
    """Weighted CE on length-normalized pooled labels; ``is_logit=False``
    takes log-probs as they are (the verb/noun model's composed ones)."""
    C = seg_clogit.shape[-1]
    onehot = F.one_hot(labels.long(), C).float()
    pooled = torch.einsum("bts,btc->bsc", P, onehot)
    zoomed = pooled / P.sum(dim=1).clamp(min=1.0)[..., None]
    logp = torch.log_softmax(seg_clogit, dim=-1) if is_logit else seg_clogit
    loss = -(logp * zoomed * cweight[:C]).sum(dim=(1, 2))
    return loss / _clamp_norm(zoomed.sum(dim=(1, 2)))


def verbnoun_action_token_loss(action_logp, seg2tok, transcript, seg_mask, cweight):
    """The verb/noun model's token loss: each token targets the null class,
    a matched token its segment's action instead; the class-weighted CE of
    the composed log-probs, mean over tokens."""
    B, M, C1 = action_logp.shape
    null_id = C1 - 1
    bidx = torch.arange(B, device=action_logp.device)[:, None].expand_as(seg2tok)
    idx = torch.where(seg_mask, seg2tok.long(), M)  # invalid segments land in the spare row
    clabel = torch.zeros((B, M + 1, C1), dtype=action_logp.dtype, device=action_logp.device)
    clabel[..., null_id] = 1.0
    clabel[bidx, idx, null_id] = 0.0
    clabel[bidx, idx, torch.where(seg_mask, transcript.long(), 0)] = seg_mask.to(clabel.dtype)
    loss = (-action_logp * clabel[:, :M] * cweight).sum(dim=-1)
    return loss.mean(dim=1)


def smooth_loss(logits, pair_mask, col_mask=None):
    """Truncated squared difference of adjacent log-softmax rows, masked mean
    over valid adjacent pairs; logits (B, R, C), pair_mask (B, R-1).  With
    ``col_mask`` (B, C) (transcript mode: the valid tokens) the log-softmax
    runs over the valid columns only and the mean is over them."""
    if col_mask is None:
        ls = torch.log_softmax(logits, dim=-1)
    else:
        ls = masked_log_softmax(logits, col_mask[:, None, :], dim=-1)
    d = ((ls[:, 1:] - ls[:, :-1]) ** 2).clamp(0.0, 16.0)
    pm = pair_mask.to(d.dtype)[..., None]
    if col_mask is None:
        denom = pair_mask.sum(dim=1) * logits.shape[-1]
    else:
        pm = pm * col_mask[:, None, :].to(d.dtype)
        denom = pair_mask.sum(dim=1) * col_mask.sum(dim=1).clamp(min=1)
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


def smooth_loss_opt(logits, frame_mask, col_mask=None, use_kernel: bool = False):
    """smooth_loss, through K5 with ``use_kernel`` where there is no column
    mask (the column-masked form stays plain, as JAX's ``smooth_loss_opt``
    keeps it off its kernel)."""
    pair_mask = frame_mask[:, 1:] & frame_mask[:, :-1]
    if use_kernel and col_mask is None:
        sl_sum = fused_smooth_sum(logits, frame_mask)
        return sl_sum / _clamp_norm((pair_mask.sum(dim=1) * logits.shape[-1]).float())
    return smooth_loss(logits, pair_mask, col_mask)


# ---------------------------------------------------------------------------
# per-block compositions


def ref_order_sweight(sweight, seg2tok, seg_mask):
    """Permute segment weights into the reference's matching order."""
    order = torch.argsort(torch.where(seg_mask, seg2tok.long(), 1 << 30), dim=1, stable=True)
    rank = torch.argsort(order, dim=1, stable=True)
    return sweight.gather(1, rank)


def block_loss(saves: dict, batch: dict, seg2tok, cweight, sw: float, token_mask=None,
               ref_weight_order: bool = False, use_kernel: bool = False):
    """Per-video loss (B,) of one block; ``token_mask`` (B, M) (transcript
    mode: the transcript's seg_mask) restricts an update block's attention
    smoothing to the valid tokens."""
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
        al = smooth_loss_opt(saves["a2f_attn_logit"], frame_mask, token_mask,
                             use_kernel=use_kernel)
        flog = saves["f2a_attn_logit"].transpose(1, 2)  # (B, T, M)
        fsl = smooth_loss_opt(flog, frame_mask, token_mask, use_kernel=use_kernel)
        return atk + f2a + a2f + fl + sw * (al + fsl + sl)

    if kind == "U":
        seg_loss = frame_loss_tdu(saves["seg_clogit"], saves["tdu_P"], labels, cweight)
        return (fl + seg_loss) / 2.0 + atk + _tdu_attn_losses(saves, batch, seg2tok, sweight) \
            + sw * sl

    raise ValueError(kind)


def _tdu_attn_losses(saves: dict, batch: dict, seg2tok, sweight):
    """f2a + a2f of a TDU block: the cross-attention losses at predicted-
    segment granularity, on soft targets (the ground-truth segment membership
    pooled over the predicted segments)."""
    P, seg_mask = saves["tdu_P"], batch["seg_mask"]
    onehot_gt = (F.one_hot(batch["seg_label"].long(), seg_mask.shape[1]).float()
                 * batch["mask"].float()[..., None])
    pooled = torch.einsum("btp,bts->bps", P, onehot_gt)
    Y = pooled / P.sum(dim=1).clamp(min=1.0)[..., None] * seg_mask.float()[:, None, :]
    return (f2a_attn_loss(saves["f2a_attn_logit"], seg2tok, seg_mask, saves["tdu_seg_valid"], Y,
                          sweight)
            + a2f_attn_loss(saves["a2f_attn_logit"], seg2tok, seg_mask, Y, sweight))


def fact_loss(saves_list, batch, seg2tok, cweight, sw: float, token_mask=None,
              ref_weight_order: bool = False, use_kernel: bool = False):
    """Mean over blocks of the per-video block losses -> (B,)."""
    per_block = [block_loss(s, batch, seg2tok, cweight, sw, token_mask=token_mask,
                            ref_weight_order=ref_weight_order, use_kernel=use_kernel)
                 for s in saves_list]
    return sum(per_block) / len(per_block)


def verbnoun_block_loss(saves: dict, batch: dict, seg2tok, cweight, sw: float, vids, nids):
    """Per-video loss (B,) of one verb/noun block (``I`` or ``U``).  The frame
    log-probs arrive factored (``frame_vlogp``, ``frame_nlogp``): the frame
    loss gathers the composed value at the labels, the smoothing loss
    composes it densely.  K5 is not used: JAX's verb/noun losses never call
    the fused frame loss."""
    labels, frame_mask = batch["labels"], batch["mask"]
    transcript, seg_mask = batch["transcript"], batch["seg_mask"]
    sweight = torch.where(seg_mask, cweight[transcript.long()], 0.0)
    lv, ln = saves["frame_vlogp"], saves["frame_nlogp"]
    logp_at_label = composed_gather(lv, ln, vids, nids, labels)
    w = cweight[:vids.shape[0]][labels.long()]
    m = frame_mask.to(logp_at_label.dtype)
    fl = (-logp_at_label * w * m).sum(dim=1) / _clamp_norm(m.sum(dim=1)) / 2.0
    seg_l = frame_loss_tdu(saves["seg_logp"], saves["tdu_P"], labels, cweight,
                           is_logit=False) / 2.0
    atk = verbnoun_action_token_loss(saves["action_logp"], seg2tok, transcript, seg_mask,
                                     cweight) / 2.0
    sl = composed_smooth_loss(lv, ln, vids, nids, frame_mask[:, 1:] & frame_mask[:, :-1])
    if saves["kind"] == "I":
        return (fl + seg_l) / 2.0 + atk + sw * sl
    return (fl + seg_l) / 2.0 + atk + _tdu_attn_losses(saves, batch, seg2tok, sweight) + sw * sl


def verbnoun_fact_loss(saves_list, batch, seg2tok, cweight, sw: float, vids, nids):
    """Mean over blocks of the per-video verb/noun block losses -> (B,)."""
    per_block = [verbnoun_block_loss(s, batch, seg2tok, cweight, sw, vids, nids)
                 for s in saves_list]
    return sum(per_block) / len(per_block)


# --------------------------------------------------------------------------
# FACT_CLIP's contrastive losses (``fact_clip_tpu/models/losses.py:376-436``)


def infonce_contrastive_loss(frame_emb, text_emb, labels, frame_mask, temperature: float):
    """Symmetric InfoNCE between frame embeddings and class text embeddings
    -> (B,).  frame_emb (B, T, E) normalised; text_emb (n, E); labels (B, T)
    in [0, n); frame_mask (B, T) bool.  v2t: the frames' CE over classes,
    a masked mean (count clamped at 1e-12); t2v: per class a softmax over the
    valid frames (-1e9 on the others), its CE averaged over the class's
    frames (count clamped at 1), then the mean over all n classes, absent
    ones included."""
    n = text_emb.shape[0]
    sim = torch.matmul(frame_emb, text_emb.t()) / temperature  # (B, T, n)
    m = frame_mask.to(sim.dtype)
    ce = -torch.log_softmax(sim, dim=-1).gather(-1, labels.long()[..., None])[..., 0]
    v2t = (ce * m).sum(dim=1) / m.sum(dim=1).clamp(min=1e-12)

    logp_t2v = torch.log_softmax(sim.masked_fill(~frame_mask[:, :, None], -1e9), dim=1)
    targets = F.one_hot(labels.long(), n).to(sim.dtype) * m[..., None]
    counts = targets.sum(dim=1).clamp(min=1.0)  # (B, n)
    t2v = (-(logp_t2v * targets).sum(dim=1) / counts).mean(dim=1)
    return (v2t + t2v) / 2.0


def action_token_contrastive_loss(projected_tokens, text_emb, seg2tok, transcript, seg_mask,
                                  temperature: float):
    """Symmetric contrastive loss between the matched action tokens and their
    segments' text embeddings -> (B,) (the reference's loss.py:344-384; no
    training path calls it, as in JAX).  projected_tokens (B, M, E)
    normalised; text_emb (n, E); seg2tok (B, S) token of each segment
    (negative indices wrap, as JAX's ``take_along_axis``); transcript (B, S);
    seg_mask (B, S) bool."""
    M, E = projected_tokens.shape[1:]
    idx = (seg2tok.long() % M)[..., None].expand(-1, -1, E)
    matched_tok = projected_tokens.gather(1, idx)  # (B, S, E)
    matched_text = text_emb[transcript.long()]  # (B, S, E)
    sim = torch.matmul(matched_tok, matched_text.transpose(1, 2)) / temperature  # (B, S, S)
    sim = sim.masked_fill(~seg_mask[:, None, :], -1e9).masked_fill(~seg_mask[:, :, None], -1e9)
    m = seg_mask.to(sim.dtype)
    norm = m.sum(dim=1).clamp(min=1e-12)
    ce_a2t = -torch.diagonal(torch.log_softmax(sim, dim=2), dim1=1, dim2=2)
    ce_t2a = -torch.diagonal(torch.log_softmax(sim, dim=1), dim1=1, dim2=2)
    return ((ce_a2t * m).sum(dim=1) / norm + (ce_t2a * m).sum(dim=1) / norm) / 2.0
