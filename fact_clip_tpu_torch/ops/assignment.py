"""The on-device matcher: the Bertsekas auction of ``matcher: auction``.

Counterpart of ``fact_clip_tpu/ops/assignment.py`` (JAX's ``lax.while_loop``
auction, which replaces scipy's Hungarian solver where a compiled program
cannot call the host), in plain PyTorch on the device and batched over the
videos as JAX's ``vmap`` runs it.  Every step is the same compare-and-where
arithmetic in f32 as JAX's, with the first maximum taken where JAX's
``argmax`` takes it, so prices and picks equal JAX's bit for bit.

The ``while_loop`` is a host loop over device tensors: one ``.any()``
synchronisation an iteration, running until every video has converged (a
converged video takes no bid, so it no longer changes) or ``max_iters``.
Each video's own iteration count is returned as JAX's loop counts it.
"""

from __future__ import annotations

import torch

_NEG = -1e30


def _auction_phase(value, col_valid, price, eps, max_iters: int):
    """One epsilon phase over a batch: value (B, M, S) to maximize, col_valid
    (B, S) bool, price (B, M), eps (B,) -> (seg_tok (B, S) int32, -1 where
    unassigned; price; iterations (B,) int32)."""
    B, M, S = value.shape
    dev = value.device
    neg = torch.tensor(_NEG, dtype=value.dtype, device=dev)
    valueT = torch.where(col_valid[:, :, None], value.transpose(1, 2), neg)  # (B, S, M)
    m_ids = torch.arange(M, device=dev)
    s_ids = torch.arange(S, device=dev)
    seg_tok = torch.full((B, S), -1, dtype=torch.int32, device=dev)
    tok_seg = torch.full((B, M), -1, dtype=torch.int32, device=dev)
    iters = torch.zeros((B,), dtype=torch.int32, device=dev)
    minus1 = torch.tensor(-1, dtype=torch.int32, device=dev)
    for _ in range(max_iters):
        active = ((seg_tok < 0) & col_valid).any(dim=1)
        if not bool(active.any()):
            break
        iters += active.to(torch.int32)
        net = valueT - price[:, None, :]  # (B, S, M)
        best_idx = net.argmax(dim=2)
        best_val = net.amax(dim=2)
        net2 = torch.where(m_ids[None, None, :] == best_idx[:, :, None], neg, net)
        second_val = net2.amax(dim=2)
        bid = price.gather(1, best_idx) + best_val - second_val + eps[:, None]  # (B, S)

        bidding = (seg_tok < 0) & col_valid
        bidmat = torch.where(bidding[:, None, :] & (best_idx[:, None, :] == m_ids[None, :, None]),
                             bid[:, None, :], neg)  # (B, M, S)
        win_val = bidmat.amax(dim=2)
        win_seg = bidmat.argmax(dim=2).to(torch.int32)
        has_bid = win_val > _NEG / 2

        price = torch.where(has_bid, win_val, price)
        won = has_bid[:, :, None] & (win_seg[:, :, None] == s_ids[None, None, :])  # (B, M, S)
        won_any = won.any(dim=1)
        won_tok = won.to(torch.uint8).argmax(dim=1).to(torch.int32)
        disp = ((has_bid & (tok_seg >= 0))[:, :, None]
                & (tok_seg[:, :, None] == s_ids[None, None, :]))
        disp_any = disp.any(dim=1)
        seg_tok = torch.where(won_any, won_tok, torch.where(disp_any, minus1, seg_tok))
        tok_seg = torch.where(has_bid, win_seg, tok_seg)
    return seg_tok, price, iters


def auction_assign(cost, col_valid, eps_rel: float = 1e-3, max_iters: int = 50000,
                   with_stats: bool = False, phases: int = 1):
    """Minimize the assignment cost of each video: cost (B, M, S), col_valid
    (B, S) bool -> seg_tok (B, S) int32, a distinct token per valid segment
    (0 for invalid segments); a segment the auction left unassigned is
    placed by ``fallback_place``, which runs only where a video of the batch
    needs it (JAX's ``run_match`` gating, matching.py:143-148).
    ``phases`` > 1: JAX's epsilon scaling on the symmetric padding
    (assignment.py:136-147).  ``with_stats`` also returns {"iterations",
    "fallback_segments", "eps_bound"} per video."""
    B, M, S = cost.shape
    value = -cost
    spread = torch.clamp(value.amax(dim=(1, 2)) - value.amin(dim=(1, 2)), min=1e-3)
    if phases <= 1:
        eps = spread * eps_rel
        price = torch.zeros((B, M), dtype=value.dtype, device=value.device)
        seg_tok, price, total_iters = _auction_phase(value, col_valid, price, eps, max_iters)
        eps_bound = eps * col_valid.sum(dim=1).to(eps.dtype)
    else:
        ratio = (4.0 * eps_rel) ** (1.0 / (phases - 1))
        eps_ladder = [spread / 4.0 * (ratio ** i) for i in range(phases)]
        v_pad = torch.zeros((B, M, M), dtype=value.dtype, device=value.device)
        v_pad[:, :, :S] = torch.where(col_valid[:, None, :], value, torch.zeros_like(value))
        all_valid = torch.ones((B, M), dtype=torch.bool, device=value.device)
        price = torch.zeros((B, M), dtype=value.dtype, device=value.device)
        total_iters = torch.zeros((B,), dtype=torch.int32, device=value.device)
        for eps in eps_ladder:
            seg_tok_pad, price, iters = _auction_phase(v_pad, all_valid, price, eps, max_iters)
            total_iters = total_iters + iters
        seg_tok = torch.where(col_valid, seg_tok_pad[:, :S], torch.full_like(seg_tok_pad[:, :S], -1))
        eps_bound = eps_ladder[-1] * M
    fallback_segs = ((seg_tok < 0) & col_valid).sum(dim=1)
    if bool((fallback_segs > 0).any()):
        seg_tok = fallback_place(cost, col_valid, seg_tok)
    else:
        seg_tok = torch.clamp(seg_tok, min=0)
    if with_stats:
        return seg_tok, {"iterations": total_iters, "fallback_segments": fallback_segs,
                         "eps_bound": eps_bound}
    return seg_tok


def fallback_place(cost, col_valid, seg_tok):
    """Place each still-unassigned (-1) valid segment, in segment order, on
    its best untaken token (JAX's ``fallback_place``, run per video of the
    batch: the auction exhausting ``max_iters`` is pathological, so this S-step
    loop runs only behind a check of the whole batch)."""
    B, M, S = cost.shape
    value = -cost
    neg = torch.tensor(_NEG, dtype=value.dtype, device=value.device)
    rows = torch.arange(B, device=value.device)
    taken = torch.zeros((B, M + 1), dtype=torch.bool, device=value.device)
    taken[rows[:, None], torch.where(seg_tok >= 0, seg_tok, M).long()] = True
    taken = taken[:, :M].clone()
    seg_tok = seg_tok.clone()
    for i in range(S):
        need = (seg_tok[:, i] < 0) & col_valid[:, i]
        avail = torch.where(taken, neg, value[:, :, i])
        pick = avail.argmax(dim=1).to(torch.int32)
        seg_tok[:, i] = torch.where(need, pick, seg_tok[:, i])
        taken[rows[need], pick[need].long()] = True
    return torch.clamp(seg_tok, min=0)


def o2m_class_cost(cost, transcript, col_valid, nclasses: int):
    """Stage 1's inputs of the device o2m: the per-class summed cost (B, M,
    C) and class presence (B, C)."""
    onehot = (torch.nn.functional.one_hot(transcript.long(), nclasses).to(cost.dtype)
              * col_valid[:, :, None].to(cost.dtype))  # (B, S, C)
    class_present = onehot.sum(dim=1) > 0
    return cost @ onehot, class_present


def o2m_stage2(cost, transcript, col_valid, tok_for_class, class_present, nclasses: int,
               class_cost=None):
    """Token -> class from the class auction (the other tokens take their
    cheapest present class), then each segment its cheapest token of its
    class (B, S) int32."""
    B, M, S = cost.shape
    if class_cost is None:
        class_cost = o2m_class_cost(cost, transcript, col_valid, nclasses)[0]
    inf = torch.tensor(float("inf"), dtype=class_cost.dtype, device=cost.device)
    tok_class = torch.where(class_present[:, None, :], class_cost, inf).argmin(dim=2)  # (B, M)
    rows = torch.arange(B, device=cost.device)[:, None].expand(B, nclasses)
    cls = torch.arange(nclasses, device=cost.device)[None, :].expand(B, nclasses)
    idx = torch.where(class_present, tok_for_class.long(), M)
    tok_class = torch.cat([tok_class, tok_class.new_zeros((B, 1))], dim=1)
    tok_class[rows[class_present], idx[class_present]] = cls[class_present]
    tok_class = tok_class[:, :M]
    same_class = tok_class[:, :, None] == transcript.long()[:, None, :]  # (B, M, S)
    masked = torch.where(same_class, cost, inf)
    seg_tok = masked.argmin(dim=1).to(torch.int32)
    has_tok = same_class.any(dim=1)
    seg_tok = torch.where(has_tok, seg_tok, cost.argmin(dim=1).to(torch.int32))
    return torch.where(col_valid, seg_tok, torch.zeros_like(seg_tok))


def o2m_assign(cost, transcript, col_valid, nclasses: int, phases: int = 1,
               with_stats: bool = False):
    """The device one-to-many matching (JAX's ``o2m_assign``): the auction
    between tokens and the classes present, then each segment's cheapest
    token of its class.  ``with_stats`` also returns the stage-1 auction's
    stats (``auction_assign``'s)."""
    class_cost, class_present = o2m_class_cost(cost, transcript, col_valid, nclasses)
    tok_for_class, info = auction_assign(class_cost, class_present, phases=phases,
                                         with_stats=True)
    seg_tok = o2m_stage2(cost, transcript, col_valid, tok_for_class, class_present, nclasses,
                         class_cost=class_cost)
    return (seg_tok, info) if with_stats else seg_tok
