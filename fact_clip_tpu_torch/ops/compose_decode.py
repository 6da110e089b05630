"""K7: the composed-action argmaxes of the epic verb/noun model.

Replaces ``fact_clip_tpu/ops/pallas/compose_decode.py`` with
``csrc/compose_decode.cu``, one launch each:

* ``compose_argmax`` (``mxu_argmax``): per frame the first argmax over the
  actions of ``lv[vids[a]] + ln[nids[a]]``, (B, T) int32, two frames a lane
  over the actions grouped into verb runs: the best verb from the max of
  each run, then the lowest action index of the best verbs' runs; a
  vocabulary whose run-table block does not fit in shared memory takes the
  tile form (32 frames a block, ``compose_smem``);
* ``compose_blend`` (``blend_argmax``): the two-branch decode's blend, the
  first argmax of ``(1 - w) q[b, act_idx[t], a] + w exp(lv[vids[a]] +
  ln[nids[a]])``, and the all-null fallback, the composed argmax, both
  (B, T) int32: the frames grouped by voting token (a sort, then blocks
  over runs of up to 32 frames that share a token, a lane a frame, the
  token's q row staged once an item, the verb runs and exact pruning of the
  expfs); on a small call or past its shared memory the tile form (the
  library's plan, ``blend_plan``);
* ``factored_argmax`` (``factored_argmax``): the composed argmax through the
  verb / noun factorisation, a lane a frame over a table of each verb's
  finite mask entries that each persistent block builds once, the best verb
  and then, in the same kernel, the best noun and the action id (JAX
  gathers those two outside its kernel).

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

TILE = 32  # frames per block of the tile form (csrc/compose_decode.cu)
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
    """Bytes of a tile-form block (both K7a's and K7b's): the packed ids and
    32 frames' rows.  Every other block form of K7a and K7b holds at least
    as much, so a vocabulary whose tile form does not fit is refused."""
    return 4 * n_act + 4 * TILE * (n1 + n2)


_FORMS = {1: "runs", 2: "tile"}  # the library's block forms by number (0: none fits)


def blend_plan(B: int, T: int, n1: int, n2: int, n_act: int, M: int):
    """(form, workspace ints) of a blend call, as the library reports them
    (``fk_compose_blend_plan``): "runs" (the token-grouped form, two
    launches through a workspace of that many ints), "tile" (the tile form,
    one launch and no workspace: a vocabulary under 1,280 actions, or past
    the token-grouped block's shared memory) or None (neither fits)."""
    form, ints = _build.workspace(_build.lib(), "fk_compose_blend_plan", 2, B, T, n1, n2, n_act,
                                  M)
    return _FORMS.get(form), ints


FACTORED_TILE = 32  # frames of a factored tile, one a lane (csrc/compose_decode.cu)


def factored_smem(n1: int, n2: int) -> int:
    """Bytes of the factored block's two tiles of rows.  The block holds more
    (the run starts, the warps' bests, the table), laid out by the library
    (``factored_plan``), so a vocabulary whose tiles do not fit is refused
    before the library is asked."""
    return 8 * FACTORED_TILE * (n1 + n2)


def factored_plan(n1: int, n2: int):
    """(fits, shared-memory bytes, table slots) of the factored block, as the
    library lays it out (``fk_factored_plan``); a mask with more finite
    entries than the table's slots is read densely."""
    fits, smem, cap = _build.workspace(_build.lib(), "fk_factored_plan", 3, n1, n2)
    return bool(fits), smem, cap


def _check_lp(name, lv, ln):
    B, T, n1 = lv.shape
    n2 = ln.shape[-1]
    if ln.shape[:2] != (B, T) or max(n1, n2) > MAX_IDS:
        raise ValueError(f"{name}: lv (B, T, n1) and ln (B, T, n2) with n1, n2 <= {MAX_IDS}")
    return B, T, n1, n2


def _check_ids(name, lv, ln, vids, nids):
    """(B, T, n1, n2); a vocabulary that no block form takes (the tile
    form's shared memory) is refused before any launch."""
    B, T, n1, n2 = _check_lp(name, lv, ln)
    if vids.dim() != 1 or nids.shape != vids.shape or vids.dtype != torch.int32 \
            or nids.dtype != torch.int32:
        raise ValueError(f"{name}: vids and nids must be (n_act,) int32")
    if compose_smem(n1, n2, vids.shape[0]) > _build.MAX_SMEM:
        raise NotImplementedError(f"{name}: no block fits in shared memory at n1={n1}, "
                                  f"n2={n2}, n_act={vids.shape[0]}")
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
    library in the tests): one library call, one launch into (B, T) int32,
    of the run-table block (whose blocks build the run table from vids and
    nids themselves) or, past its shared memory, of the tile form."""
    B, T, n1, n2 = _check_ids("compose_argmax", lv, ln, vids, nids)
    n_act = vids.shape[0]
    _build.check_tensors("compose_argmax", [lv, ln, vids, nids], lv.device)
    out = torch.empty((B, T), device=lv.device, dtype=torch.int32)
    err = _build.lib().fk_compose_argmax(lv.data_ptr(), ln.data_ptr(), vids.data_ptr(),
                                         nids.data_ptr(), out.data_ptr(), B, T, n1, n2,
                                         n_act, _build.stream_ptr(lv.device))
    _build.check("fk_compose_argmax", err)
    return out


compose_argmax.launches = 0


def compose_blend(lv, ln, vids, nids, q, act_idx, weight: float):
    """The kernels on CUDA tensors, the plain version on CPU ones: (pred, fallback)."""
    if lv.device.type == "cpu":
        return compose_blend_reference(lv, ln, vids, nids, q, act_idx, weight)
    out = _compose_blend_card(lv, ln, vids, nids, q, act_idx, weight)
    compose_blend.launches += 1
    return out


def _compose_blend_card(lv, ln, vids, nids, q, act_idx, weight: float):
    """The card's call (also run on CPU tensors against a model of the
    library in the tests): one library call into (pred, fallback), of the
    form ``blend_plan`` reports: the token-grouped form through a workspace
    (two launches: the sort and the table, then the blocks over the items)
    or the tile form (one launch)."""
    B, T, n1, n2 = _check_ids("compose_blend", lv, ln, vids, nids)
    n_act = vids.shape[0]
    if q.dim() != 3 or q.shape[0] != B or q.shape[1] < 1 or q.shape[2] != n_act \
            or act_idx.shape != (B, T) or act_idx.dtype != torch.int32:
        raise ValueError("compose_blend: q (B, M, n_act), M >= 1, and act_idx (B, T) int32")
    _build.check_tensors("compose_blend", [lv, ln, vids, nids, q, act_idx], lv.device)
    M = q.shape[1]
    ints = blend_plan(B, T, n1, n2, n_act, M)[1]
    pred = torch.empty((B, T), device=lv.device, dtype=torch.int32)
    fb = torch.empty_like(pred)
    ws = torch.empty(ints, device=lv.device, dtype=torch.int32) if ints else None
    err = _build.lib().fk_compose_blend(
        lv.data_ptr(), ln.data_ptr(), vids.data_ptr(), nids.data_ptr(), q.data_ptr(),
        act_idx.data_ptr(), pred.data_ptr(), fb.data_ptr(),
        ws.data_ptr() if ws is not None else None, B, T, n1, n2, n_act, M,
        float(1.0 - weight), float(weight), _build.stream_ptr(lv.device))
    _build.check("fk_compose_blend", err)
    return pred, fb


compose_blend.launches = 0


def factored_argmax(lv, ln, mask_vn, a_table):
    """The kernel on CUDA tensors, the plain version on CPU ones: (B, T) int32
    action ids (the best verb, its best noun, ``a_table``'s entry)."""
    if lv.device.type == "cpu":
        return factored_argmax_reference(lv, ln, mask_vn, a_table)
    out = _factored_argmax_card(lv, ln, mask_vn, a_table)
    factored_argmax.launches += 1
    return out


def _factored_argmax_card(lv, ln, mask_vn, a_table):
    """The card's call (also run on CPU tensors against a model of the
    library in the tests): one launch into (B, T) int32."""
    B, T, n1, n2 = _check_lp("factored_argmax", lv, ln)
    if mask_vn.shape != (n1, n2) or a_table.shape != (n1, n2) or a_table.dtype != torch.int32:
        raise ValueError("factored_argmax: mask_vn (n1, n2) and a_table (n1, n2) int32")
    if factored_smem(n1, n2) > _build.MAX_SMEM or not factored_plan(n1, n2)[0]:
        raise NotImplementedError(f"factored_argmax: no block fits in shared memory at "
                                  f"n1={n1}, n2={n2}")
    _build.check_tensors("factored_argmax", [lv, ln, mask_vn, a_table], lv.device)
    out = torch.empty((B, T), device=lv.device, dtype=torch.int32)
    err = _build.lib().fk_factored_argmax(lv.data_ptr(), ln.data_ptr(), mask_vn.data_ptr(),
                                          a_table.data_ptr(), out.data_ptr(), B, T, n1, n2,
                                          _build.stream_ptr(lv.device))
    _build.check("fk_factored_argmax", err)
    return out


factored_argmax.launches = 0
