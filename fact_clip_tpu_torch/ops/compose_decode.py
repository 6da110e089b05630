"""K7: the composed-action argmaxes of the epic verb/noun model.

Replaces ``fact_clip_tpu/ops/pallas/compose_decode.py`` with
``csrc/compose_decode.cu``, one launch each:

* ``compose_argmax`` (``mxu_argmax``): per frame the first argmax over the
  actions of ``lv[vids[a]] + ln[nids[a]]``, (B, T) int32, two frames a lane
  over the actions grouped into verb runs: the best verb from the max of
  each run, then the lowest action index of the best verbs' runs;
* ``compose_blend`` (``blend_argmax``): the two-branch decode's blend, the
  first argmax of ``(1 - w) q[b, act_idx[t], a] + w exp(lv[vids[a]] +
  ln[nids[a]])``, and the all-null fallback, the composed argmax, both
  (B, T) int32;
* ``factored_argmax`` (``factored_argmax``): the composed argmax through the
  verb / noun factorisation, the best verb from the kernel and then the best
  noun and the action id in PyTorch, as JAX gathers them outside its kernel.

lv (B, T, n1) and ln (B, T, n2) are float32 log-probabilities; vids, nids
(n_act,) int32 action -> verb / noun ids; q (B, M, n_act) the tokens'
renormalised action probabilities; act_idx (B, T) the voting token.  None
of them has a gradient (JAX stop-gradients their inputs): the wrappers take
detached tensors.  Beside each wrapper is its plain version, the dense
formula of JAX's XLA path (``ops/verbnoun_compose.py:119-120, 196-201``,
``composed_argmax_factored``), which materialises the (B, T, n_act)
composition that the kernels keep out of device memory.  On CPU tensors a
wrapper runs its plain version; on CUDA tensors it launches the kernel or
raises.
"""

from __future__ import annotations

import torch

from .. import _build

TILE = 32  # frames per block of the blend (csrc/compose_decode.cu)
ARGMAX_TILE = 64  # frames per tile of the composed argmax, two a lane
ARGMAX_WARPS = 16  # warps of a composed-argmax block, each on a share of the verbs
ARGMAX_QUEUE = 128  # pass-2 items a tile
MAX_IDS = 32767  # verb and noun ids share one int in the kernels' table


def compose_argmax_reference(lv, ln, vids, nids):
    return (lv[..., vids.long()] + ln[..., nids.long()]).argmax(dim=-1).to(torch.int32)


def compose_blend_reference(lv, ln, vids, nids, q, act_idx, weight: float):
    """(pred, fallback), the dense blend of ``composed_decode`` and the composed argmax."""
    s = lv[..., vids.long()] + ln[..., nids.long()]
    abranch = q.gather(1, act_idx.long()[..., None].expand(-1, -1, q.shape[-1]))
    pred = ((1.0 - weight) * abranch + weight * torch.exp(s)).argmax(dim=-1)
    return pred.to(torch.int32), s.argmax(dim=-1).to(torch.int32)


def factored_verb_reference(lv, ln, mask_vn):
    """(B, T) best verb: first argmax_v lv[v] + max_n (ln[n] + mask_vn[v, n])."""
    best = (ln[:, :, None, :] + mask_vn).amax(dim=-1)
    return (lv + best).argmax(dim=-1).to(torch.int32)


def _factored_action(ln, mask_vn, a_table, v_star):
    """The best noun of the winning verb, then the action id (outside the kernel, as in JAX)."""
    n_star = (ln + mask_vn[v_star.long()]).argmax(dim=-1)
    return a_table[v_star.long(), n_star].to(torch.int32)


def factored_argmax_reference(lv, ln, mask_vn, a_table):
    return _factored_action(ln, mask_vn, a_table, factored_verb_reference(lv, ln, mask_vn))


def compose_smem(n1: int, n2: int, n_act: int) -> int:
    """Bytes of a blend block: the action table and a tile's rows."""
    return 4 * n_act + 4 * TILE * (n1 + n2)


def argmax_smem(n1: int, n2: int, n_act: int) -> int:
    """Bytes of a composed-argmax block (csrc/compose_decode.cu::argmax_smem):
    the run table (each run padded to a multiple of 4 entries), the run
    starts, the fill counts and the warps' verb bounds (padded to 16 bytes),
    the warps' bests, pass 2's queue, the frames' picks and the queue's
    count, and two tiles' rows (each block of rows with room for its
    16-byte alignment); past the limit where the ids, staged in a tile's
    room, do not fit there."""
    slots = (n_act + 3 * n1 + 3) // 4 * 4
    tile = ((ARGMAX_TILE * n1 + 7) & ~3) + ((ARGMAX_TILE * n2 + 7) & ~3)
    if 2 * ((n_act + 7) & ~3) > tile:  # the ids are staged in a tile's room
        return _build.MAX_SMEM + 1
    return (16 * ((slots + 2 * n1 + ARGMAX_WARPS + 5) // 4) + 8 * ARGMAX_WARPS * 32
            + 16 * ARGMAX_QUEUE + 4 * ARGMAX_TILE + 16
            + 8 * tile)


def factored_smem(n1: int, n2: int) -> int:
    """Bytes of a factored block: the mask (odd row stride) and each warp's frame."""
    return 4 * (n1 * (n2 | 1) + 8 * (n1 + n2))


def _check_lp(name, lv, ln):
    B, T, n1 = lv.shape
    n2 = ln.shape[-1]
    if ln.shape[:2] != (B, T) or max(n1, n2) > MAX_IDS:
        raise ValueError(f"{name}: lv (B, T, n1) and ln (B, T, n2) with n1, n2 <= {MAX_IDS}")
    return B, T, n1, n2


def _check_ids(name, lv, ln, vids, nids, smem):
    B, T, n1, n2 = _check_lp(name, lv, ln)
    if vids.dim() != 1 or nids.shape != vids.shape or vids.dtype != torch.int32 \
            or nids.dtype != torch.int32:
        raise ValueError(f"{name}: vids and nids must be (n_act,) int32")
    if smem > _build.MAX_SMEM:
        raise NotImplementedError(f"{name}: no block fits in shared memory at n1={n1}, "
                                  f"n2={n2}, n_act={vids.shape[0]}")
    _build.check_tensors(name, [lv, ln, vids, nids], lv.device)
    return B, T, n1, n2


def compose_argmax(lv, ln, vids, nids):
    """The kernel on CUDA tensors, the plain version on CPU ones: (B, T) int32."""
    if lv.device.type == "cpu":
        return compose_argmax_reference(lv, ln, vids, nids)
    out = _compose_argmax_card(lv, ln, vids, nids)
    compose_argmax.launches += 1
    return out


def _compose_argmax_card(lv, ln, vids, nids):
    """The card's call (also run on CPU tensors against a model of the
    library in the tests): one library call, one launch whose blocks build
    the run table from vids and nids themselves, into (B, T) int32."""
    n_act = vids.shape[0] if vids.dim() == 1 else 0
    B, T, n1, n2 = _check_ids("compose_argmax", lv, ln, vids, nids,
                              argmax_smem(lv.shape[-1], ln.shape[-1], n_act))
    out = torch.empty((B, T), device=lv.device, dtype=torch.int32)
    err = _build.lib().fk_compose_argmax(lv.data_ptr(), ln.data_ptr(), vids.data_ptr(),
                                         nids.data_ptr(), out.data_ptr(), B, T, n1, n2,
                                         n_act, _build.stream_ptr(lv.device))
    _build.check("fk_compose_argmax", err)
    return out


compose_argmax.launches = 0


def compose_blend(lv, ln, vids, nids, q, act_idx, weight: float):
    """The kernel on CUDA tensors, the plain version on CPU ones: (pred, fallback)."""
    if lv.device.type == "cpu":
        return compose_blend_reference(lv, ln, vids, nids, q, act_idx, weight)
    n_act = vids.shape[0] if vids.dim() == 1 else 0
    B, T, n1, n2 = _check_ids("compose_blend", lv, ln, vids, nids,
                              compose_smem(lv.shape[-1], ln.shape[-1], n_act))
    if q.dim() != 3 or q.shape[0] != B or q.shape[2] != n_act or act_idx.shape != (B, T) \
            or act_idx.dtype != torch.int32:
        raise ValueError("compose_blend: q (B, M, n_act) and act_idx (B, T) int32")
    _build.check_tensors("compose_blend", [q, act_idx], lv.device)
    pred = torch.empty((B, T), device=lv.device, dtype=torch.int32)
    fb = torch.empty_like(pred)
    err = _build.lib().fk_compose_blend(
        lv.data_ptr(), ln.data_ptr(), vids.data_ptr(), nids.data_ptr(), q.data_ptr(),
        act_idx.data_ptr(), pred.data_ptr(), fb.data_ptr(), B, T, n1, n2, n_act, q.shape[1],
        float(1.0 - weight), float(weight), _build.stream_ptr(lv.device))
    _build.check("fk_compose_blend", err)
    compose_blend.launches += 1
    return pred, fb


compose_blend.launches = 0


def factored_argmax(lv, ln, mask_vn, a_table):
    """The best verb from the kernel (CUDA tensors) or the plain version (CPU
    ones), then the best noun and the action id: (B, T) int32."""
    if lv.device.type == "cpu":
        return factored_argmax_reference(lv, ln, mask_vn, a_table)
    B, T, n1, n2 = _check_lp("factored_argmax", lv, ln)
    if mask_vn.shape != (n1, n2) or a_table.shape != (n1, n2):
        raise ValueError("factored_argmax: mask_vn and a_table must be (n1, n2)")
    if factored_smem(n1, n2) > _build.MAX_SMEM:
        raise NotImplementedError(f"factored_argmax: the mask does not fit in shared memory at "
                                  f"n1={n1}, n2={n2}")
    _build.check_tensors("factored_argmax", [lv, ln, mask_vn], lv.device)
    v_star = torch.empty((B, T), device=lv.device, dtype=torch.int32)
    err = _build.lib().fk_factored_argmax(lv.data_ptr(), ln.data_ptr(), mask_vn.data_ptr(),
                                          v_star.data_ptr(), B, T, n1, n2,
                                          _build.stream_ptr(lv.device))
    _build.check("fk_factored_argmax", err)
    factored_argmax.launches += 1
    return _factored_action(ln, mask_vn, a_table, v_star)


factored_argmax.launches = 0
