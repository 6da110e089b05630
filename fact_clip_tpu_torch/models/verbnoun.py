"""The Epic-Kitchens verb/noun FACT (PyTorch), serving.

Counterpart of ``fact_clip_tpu/models/verbnoun.py``: the frame and token
heads emit separate verb (n1) and noun (n2) logits, and an action's
log-prob is the composition ``lv[vids[a]] + ln[nids[a]]`` through the
action -> verb / noun id tables.  The block string uses 'I' (the input block
that compresses the frames to predicted segments before its SCA decoder
attends to them) and 'U' (the update block with TDU, as in FACT, on verb /
noun heads).  Every TDU segments the video by the composed argmax (K7,
``ops/verbnoun_compose.py``), so the (T, n_act) composition is never kept.
Module paths are the reference's torch keys (``blocks_SepVerbNoun.py``),
which ``utils/torch_export.py::export_verbnoun_state_dict`` emits.  The
model serves and trains: ``forward(..., train=True, generator=...)`` masks
the input channels at ``cmr`` (and time spans when ``TM.use``) and runs the
layers' dropout, every draw from the generator, as ``FACT.forward`` does;
the TDU's composed argmax takes detached inputs (JAX's ``stop_gradient``).
In transcript mode (``FACT.trans``, ``verbnoun.py:296-307``) the tokens are
the transcript's actions embedded as [verb_embed(verb) | noun_embed(noun)],
each a_dim / 2 wide, plus the sinusoid table of the token axis.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from torch import nn

from ..configs import BlockCfg, compute_dtype, resolve_block_cfgs
from ..data.io import load_action_mapping
from ..ops import segments
from ..ops.verbnoun_compose import composed_argmax
from . import layers as L
from .blocks import (FACT, _apply_abranch, augment, make_abranch, make_fbranch, make_x2y,
                     token_inputs)


def load_vids_nids(processed_dir: str):
    """Action -> verb-id / action -> noun-id tables (int32) from the epic
    mapping files: ``mapping.txt`` lines are ``<id> verb,noun``."""
    v2i, _ = load_action_mapping(os.path.join(processed_dir, "verb_mapping.txt"))
    n2i, _ = load_action_mapping(os.path.join(processed_dir, "noun_mapping.txt"))
    _, i2a = load_action_mapping(os.path.join(processed_dir, "mapping.txt"))
    vids, nids = [], []
    for i in range(len(i2a)):
        v, n = i2a[i].split(",")
        vids.append(v2i[v])
        nids.append(n2i[n])
    return np.asarray(vids, np.int32), np.asarray(nids, np.int32)


def split_softmax(clogit, class_sep: int):
    """Independent softmaxes over the verb and the noun logits, concatenated."""
    return torch.cat([torch.softmax(clogit[..., :class_sep], dim=-1),
                      torch.softmax(clogit[..., class_sep:], dim=-1)], dim=-1)


def combine_verb_noun(clogit, vids, nids, n1: int, action: bool = False):
    """Composed action log-probabilities (``combine_verb_noun(...,
    apply_log=True)``, the form the blocks save).  With ``action`` the heads
    carry an extra null slot each; the composed null is their product."""
    split = n1 + 1 if action else n1
    v = torch.log_softmax(clogit[..., :split], dim=-1)
    n = torch.log_softmax(clogit[..., split:], dim=-1)
    a = v[..., vids.long()] + n[..., nids.long()]
    return torch.cat([a, v[..., -1:] + n[..., -1:]], dim=-1) if action else a


def process_feature_vn(feature, n1: int, n2: int):
    """Split the trailing n1 + n2 logits off and put their split softmax back."""
    clogit = feature[..., -(n1 + n2):]
    return torch.cat([feature[..., :-(n1 + n2)], split_softmax(clogit, n1)], dim=-1), clogit


class _TDUBlock(nn.Module):
    """A block with the verb/noun TDU (``verbnoun.py:90-129``): segments by
    the composed argmax of the frame probabilities carried in the feature,
    mean-pools them, and runs the segment BiGRU and dense layer."""

    def __init__(self, c: BlockCfg, n1: int, n2: int, s_pred_cap: int, gru_layers: int):
        super().__init__()
        self.c, self.n1, self.n2, self.s_pred_cap = c, n1, n2, s_pred_cap
        self.seg_update = L.BiGRU(c.hid_dim, c.hid_dim // 2, gru_layers)
        self.seg_combine = nn.Linear(c.hid_dim, c.hid_dim)
        self.kernel_allowed = c.pallas  # the composed argmax (K7)
        self.use_kernel = c.pallas

    def tdu(self, frame_feature, mask, vids, nids):
        n1, n2, S = self.n1, self.n2, self.s_pred_cap
        cprob = frame_feature[..., -(n1 + n2):]
        # the argmax of the composed probabilities is that of the summed
        # log-probs of the probabilities in the feature (not log_softmax of
        # the logits: the two round differently)
        pred = composed_argmax(torch.log(cprob[..., :n1].clamp(min=1e-30)),
                               torch.log(cprob[..., n1:].clamp(min=1e-30)), vids, nids,
                               kernel=self.use_kernel)
        seg_id, _ = segments.segment_ids_from_pred(pred, mask, S)
        P = segments.assignment_matrix(seg_id, mask, S)
        seg_valid = segments.segment_lengths(P) > 0
        seg_len = seg_valid.sum(dim=1).to(torch.int32)  # valid segments are a prefix
        seg_feature = torch.relu(self.seg_update(segments.pool_mean(P, frame_feature), seg_len))
        seg_feature, seg_clogit = process_feature_vn(self.seg_combine(seg_feature), n1, n2)
        return dict(P=P, seg_valid=seg_valid, seg_len=seg_len,
                    centers=segments.segment_centers(P, S), seg_feature=seg_feature,
                    seg_clogit=seg_clogit)

    def _saves(self, frame_clogit, seg_clogit, action_clogit, vids, nids, t, kind):
        n1 = self.n1
        return {"frame_vlogp": torch.log_softmax(frame_clogit[..., :n1], dim=-1),
                "frame_nlogp": torch.log_softmax(frame_clogit[..., n1:], dim=-1),
                "seg_logp": combine_verb_noun(seg_clogit, vids, nids, n1),
                "action_logp": combine_verb_noun(action_clogit, vids, nids, n1, action=True),
                "tdu_P": t["P"], "tdu_seg_valid": t["seg_valid"], "kind": kind}


class InputBlockTDUVN(_TDUBlock):
    """``verbnoun.py:132-175``: frame tower, TDU with a fixed 2-layer segment
    GRU, SCA decoder over the predicted segments."""

    def __init__(self, c: BlockCfg, in_dim: int, n1: int, n2: int, s_pred_cap: int):
        super().__init__(c, n1, n2, s_pred_cap, gru_layers=2)
        self.frame_branch = make_fbranch(c, in_dim)
        self.action_branch = make_abranch(c)

    def forward(self, frame_feature, action_feature, frame_pos, action_pos, lengths, token_len,
                mask, vids, nids, generator=None):
        n1, n2 = self.n1, self.n2
        frame_feature, frame_clogit = process_feature_vn(
            self.frame_branch(frame_feature, lengths, generator), n1, n2)
        t = self.tdu(frame_feature, mask, vids, nids)
        action_feature = _apply_abranch(self.action_branch, self.c, action_feature, action_pos,
                                        token_len, generator, memory=t["seg_feature"],
                                        memory_pos=frame_pos[t["centers"]],
                                        memory_len=t["seg_len"])
        action_feature, action_clogit = process_feature_vn(action_feature, n1 + 1, n2 + 1)
        saves = self._saves(frame_clogit, t["seg_clogit"], action_clogit, vids, nids, t, "I")
        return frame_feature, action_feature, saves


class UpdateBlockTDUVN(_TDUBlock):
    """``verbnoun.py:178-244``: TDU, f2a X2Y over the segments, SA decoder,
    a2f X2Y back to the segments, the segment -> frame product, the merge
    and the frame tower."""

    def __init__(self, c: BlockCfg, n1: int, n2: int, s_pred_cap: int):
        super().__init__(c, n1, n2, s_pred_cap, gru_layers=c.s_layers)
        self.f2a_layer = make_x2y(c, c.a_dim)
        self.action_branch = make_abranch(c)
        self.a2f_layer = make_x2y(c, c.f_dim)
        self.sf_merge = nn.Sequential(nn.Linear(c.f_dim + c.hid_dim, c.f_dim), nn.ReLU())
        self.frame_branch = make_fbranch(c, None)

    def forward(self, frame_feature, action_feature, frame_pos, action_pos, lengths, token_len,
                mask, vids, nids, generator=None):
        n1, n2 = self.n1, self.n2
        t = self.tdu(frame_feature, mask, vids, nids)
        seg_feature, seg_pos = t["seg_feature"], frame_pos[t["centers"]]
        action_feature, f2a_attn_seg, f2a_logit = self.f2a_layer(
            seg_feature, action_feature, x_pos=seg_pos, y_pos=action_pos, x_len=t["seg_len"],
            generator=generator)
        action_feature = _apply_abranch(self.action_branch, self.c, action_feature, action_pos,
                                        token_len, generator)
        action_feature, action_clogit = process_feature_vn(action_feature, n1 + 1, n2 + 1)
        seg_out, a2f_attn_seg, a2f_logit = self.a2f_layer(
            action_feature, seg_feature, x_pos=action_pos, y_pos=seg_pos, x_len=token_len,
            generator=generator)
        # segment -> frame: the one-hot P rows make the product the gather
        P = t["P"]
        frame_feature = self.sf_merge(torch.cat([P @ seg_out, frame_feature], dim=-1))
        frame_feature, frame_clogit = process_feature_vn(
            self.frame_branch(frame_feature, lengths, generator), n1, n2)
        saves = self._saves(frame_clogit, t["seg_clogit"], action_clogit, vids, nids, t, "U")
        saves.update({"f2a_attn": f2a_attn_seg @ P.transpose(1, 2),  # (B, M, T)
                      "f2a_attn_logit": f2a_logit,  # (B, M, S)
                      "a2f_attn": P @ a2f_attn_seg,  # (B, T, M)
                      "a2f_attn_logit": a2f_logit})  # (B, S, M)
        return frame_feature, action_feature, saves


class VerbNounFACT(nn.Module):
    """``verbnoun.py:247-326``; forward returns (per-block saves, final frame
    feature).  ``vids`` / ``nids`` are int32 buffers, not parameters (the
    reference's state_dict has no such key).  With ``trans`` the tokens are
    the transcript's, embedded by ``verb_embed`` / ``noun_embed``."""

    def __init__(self, block_cfgs, in_dim: int, n_classes1: int, n_classes2: int, vids, nids,
                 ntoken: int, fpos: bool, s_pred_cap: int, cmr: float = 0.0,
                 tm: dict | None = None, trans: bool = False):
        super().__init__()
        self.block_cfgs = tuple(block_cfgs)
        self.in_dim, self.n_classes1, self.n_classes2 = in_dim, n_classes1, n_classes2
        self.ntoken, self.fpos, self.s_pred_cap = ntoken, fpos, s_pred_cap
        self.trans = bool(trans)
        self.cmr = float(cmr)
        self.tm = dict(tm or {"use": False})
        self.kernels_enabled = any(c.pallas for c in self.block_cfgs)
        self.register_buffer("vids", torch.as_tensor(np.asarray(vids, np.int32)), persistent=False)
        self.register_buffer("nids", torch.as_tensor(np.asarray(nids, np.int32)), persistent=False)
        a_dim = self.block_cfgs[0].a_dim
        if self.trans:
            self.verb_embed = nn.Embedding(n_classes1, a_dim // 2)
            self.noun_embed = nn.Embedding(n_classes2, a_dim // 2)
        else:
            self.action_query = nn.Parameter(torch.empty(ntoken, 1, a_dim))
        blocks = []
        for c in self.block_cfgs:
            if c.kind == "I":
                blocks.append(InputBlockTDUVN(c, in_dim, n_classes1, n_classes2, s_pred_cap))
            elif c.kind == "U":
                blocks.append(UpdateBlockTDUVN(c, n_classes1, n_classes2, s_pred_cap))
            else:
                raise ValueError(f"verb/noun model only supports 'I'/'U' blocks, got {c.kind!r}")
        self.block_list = nn.ModuleList(blocks)

    def init_with(self, g):
        with torch.no_grad():
            tables = ([self.verb_embed.weight, self.noun_embed.weight] if self.trans
                      else [self.action_query])
            for t in tables:
                t.copy_(torch.randn(t.shape, generator=g))

    def embed_transcript(self, transcript):
        return torch.cat([self.verb_embed(self.vids[transcript].long()),
                          self.noun_embed(self.nids[transcript].long())], dim=-1)

    set_kernels = FACT.set_kernels

    def forward(self, feats, mask, lengths, train: bool = False, generator=None,
                transcript=None, seg_mask=None):
        """feats (B, T, D) f32, mask (B, T) bool valid-frame prefix, lengths (B,);
        in transcript mode also transcript (B, M) action ids and seg_mask (B, M).

        ``train`` puts the model in train mode for the call, as
        ``FACT.forward`` does: the masks and dropout draw from ``generator``,
        a ``torch.Generator`` on the model's device."""
        self.train(train)
        B, T, _ = feats.shape
        bi = self.block_cfgs[0]
        lengths = lengths.to(device=feats.device, dtype=torch.int32)
        mask = torch.arange(T, device=feats.device)[None, :] < lengths[:, None]
        if train:
            feats = augment(feats, lengths, self.cmr, self.tm, generator)
        frame_pos = L.positional_encoding_table(T, bi.hid_dim, empty=not self.fpos,
                                                device=feats.device)
        action_feature, action_pos, token_len = token_inputs(self, B, transcript, seg_mask,
                                                             feats)
        frame_feature = feats
        saves_list = []
        for block in self.block_list:
            frame_feature, action_feature, saves = block(
                frame_feature, action_feature, frame_pos, action_pos, lengths, token_len, mask,
                self.vids, self.nids, generator)
            saves_list.append(saves)
        return saves_list, frame_feature


def build_verbnoun_fact(cfg: dict, in_dim: int, vids, nids, s_pred_cap: int,
                        n_classes1: int = 98, n_classes2: int = 301, *, device=None,
                        generator: torch.Generator | None = None) -> VerbNounFACT:
    """The verb/noun model of a config (``configs.epic_cfg()``), as
    ``build_fact`` builds FACT: on ``device`` (the CUDA card when None;
    ``device="cpu"`` for the plain path on the CPU), initialised from
    ``generator`` (a CPU torch.Generator; seed 0 if None), in eval mode."""
    if compute_dtype(cfg):
        raise NotImplementedError("TPU.compute_dtype bfloat16: the verb/noun model in bf16 is "
                                  "ROADMAP M7 item 4")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("build_verbnoun_fact: no CUDA card is available; pass "
                               "device='cpu' to build the model on the CPU")
        device = "cuda"
    with torch.device("meta"):
        model = VerbNounFACT(resolve_block_cfgs(cfg), in_dim, n_classes1, n_classes2, vids, nids,
                             cfg["FACT"]["ntoken"], cfg["FACT"]["fpos"], s_pred_cap,
                             cmr=cfg["FACT"].get("cmr", 0.0), tm=cfg.get("TM"),
                             trans=bool(cfg["FACT"].get("trans")))
    model = model.to_empty(device=device)
    model.vids = torch.as_tensor(np.asarray(vids, np.int32), device=device)
    model.nids = torch.as_tensor(np.asarray(nids, np.int32), device=device)
    L.init_parameters(model, generator or torch.Generator().manual_seed(0))
    return model.eval()
