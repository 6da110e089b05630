"""FACT blocks and model over batched, padded videos (PyTorch).

Counterpart of ``fact_clip_tpu/models/blocks.py:150-522``: InputBlock (frame
tower + SCA decoder), UpdateBlock (f2a X2Y -> SA decoder -> a2f X2Y -> frame
tower) and UpdateBlockTDU (the same at predicted-segment granularity with a
static segment cap).  Each block returns (frame_feature, action_feature,
saves); ``FACT.forward`` returns the list of saves and the final frame
feature.  With ``train=True`` it runs in train mode: channel and time masks
on the input features (blocks.py:460-465) and dropout in the layers, every
draw from the ``generator`` passed in.  Transcript mode and the CLIP head
are not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from ..configs import BlockCfg, resolve_block_cfgs
from ..ops import masking, segments
from . import layers as L


def process_feature(feature, nclass: int):
    """Split the trailing ``nclass`` dims off as logits and put their softmax
    back in their place (blocks.py:150-175)."""
    clogit = feature[..., -nclass:]
    out = torch.cat([feature[..., :-nclass], torch.softmax(clogit, dim=-1)], dim=-1)
    return out, clogit


def make_fbranch(c: BlockCfg, in_dim: int | None):
    if c.f != "m":
        raise ValueError(f"frame branch {c.f!r} is not ported (only 'm')")
    return L.MSTCN(in_dim if in_dim is not None else c.f_dim, c.f_dim, c.hid_dim, c.f_layers,
                   ln=c.f_ln, ngroup=c.f_ngp, in_map=in_dim is not None, use_kernel=c.pallas,
                   dropout=c.dropout)


def make_abranch(c: BlockCfg):
    if c.a == "sa":
        return L.SADecoder(c.a_dim, c.a_dim, c.hid_dim, c.a_layers, c.a_nhead, c.a_ffdim,
                           use_kernel=c.pallas and c.pallas_sa, dropout=c.dropout)
    if c.a == "sca":
        return L.SCADecoder(c.a_dim, c.a_dim, c.hid_dim, c.hid_dim, c.a_layers, c.a_nhead,
                            c.a_ffdim, use_kernel_sa=c.pallas and c.pallas_sa,
                            use_kernel_attn=c.pallas and c.pallas_attn, dropout=c.dropout)
    raise ValueError(f"action branch {c.a!r} is not ported")


def make_x2y(c: BlockCfg, outdim: int):
    return L.X2YMap(c.hid_dim, c.hid_dim, outdim, c.hid_dim, kq_pos=True, use_kernel=c.pallas,
                    dropout=c.dropout)


def _apply_abranch(branch, c, action_feature, action_pos, generator, memory=None,
                   memory_pos=None, memory_len=None):
    if c.a == "sa":
        return branch(action_feature, pos=action_pos, generator=generator)
    return branch(action_feature, memory, pos=memory_pos, query_pos=action_pos,
                  memory_len=memory_len, generator=generator)


class InputBlock(nn.Module):
    def __init__(self, c: BlockCfg, in_dim: int, nclass: int):
        super().__init__()
        self.c, self.nclass = c, nclass
        self.frame_branch = make_fbranch(c, in_dim)
        self.action_branch = make_abranch(c)

    def forward(self, frame_feature, action_feature, frame_pos, action_pos, lengths,
                token_len, generator=None):
        frame_feature = self.frame_branch(frame_feature, lengths, generator)
        frame_feature, frame_clogit = process_feature(frame_feature, self.nclass)
        action_feature = _apply_abranch(self.action_branch, self.c, action_feature, action_pos,
                                        generator, memory=frame_feature, memory_pos=frame_pos,
                                        memory_len=lengths)
        action_feature, action_clogit = process_feature(action_feature, self.nclass + 1)
        saves = {"frame_clogit": frame_clogit, "action_clogit": action_clogit,
                 "action_feature": action_feature[..., : -(self.nclass + 1)], "kind": "i"}
        return frame_feature, action_feature, saves


class UpdateBlock(nn.Module):
    def __init__(self, c: BlockCfg, nclass: int):
        super().__init__()
        self.c, self.nclass = c, nclass
        self.f2a_layer = make_x2y(c, c.a_dim)
        self.action_branch = make_abranch(c)
        self.a2f_layer = make_x2y(c, c.f_dim)
        self.frame_branch = make_fbranch(c, None)

    def forward(self, frame_feature, action_feature, frame_pos, action_pos, lengths,
                token_len, generator=None):
        # f -> a: queries are the action tokens, keys/values the frames
        action_feature, f2a_attn, f2a_logit = self.f2a_layer(
            frame_feature, action_feature, x_pos=frame_pos, y_pos=action_pos, x_len=lengths,
            generator=generator)
        action_feature = _apply_abranch(self.action_branch, self.c, action_feature, action_pos,
                                        generator)
        action_feature, action_clogit = process_feature(action_feature, self.nclass + 1)
        # a -> f: queries are the frames, keys/values the action tokens
        frame_feature, a2f_attn, a2f_logit = self.a2f_layer(
            action_feature, frame_feature, x_pos=action_pos, y_pos=frame_pos, x_len=token_len,
            generator=generator)
        frame_feature = self.frame_branch(frame_feature, lengths, generator)
        frame_feature, frame_clogit = process_feature(frame_feature, self.nclass)
        saves = {"frame_clogit": frame_clogit, "action_clogit": action_clogit,
                 "action_feature": action_feature[..., : -(self.nclass + 1)],
                 "f2a_attn": f2a_attn, "f2a_attn_logit": f2a_logit,
                 "a2f_attn": a2f_attn, "a2f_attn_logit": a2f_logit, "kind": "u"}
        return frame_feature, action_feature, saves


class UpdateBlockTDU(nn.Module):
    def __init__(self, c: BlockCfg, nclass: int, s_pred_cap: int):
        super().__init__()
        self.c, self.nclass, self.s_pred_cap = c, nclass, s_pred_cap
        self.seg_update = L.BiGRU(c.hid_dim, c.hid_dim // 2, c.s_layers)
        self.seg_combine = nn.Linear(c.hid_dim, c.hid_dim)
        self.f2a_layer = make_x2y(c, c.a_dim)
        self.action_branch = make_abranch(c)
        self.a2f_layer = make_x2y(c, c.f_dim)
        self.sf_merge = nn.Sequential(nn.Linear(c.f_dim + c.hid_dim, c.f_dim), nn.ReLU())
        self.frame_branch = make_fbranch(c, None)

    def forward(self, frame_feature, action_feature, frame_pos, action_pos, lengths,
                token_len, generator=None):
        S = self.s_pred_cap
        T = frame_feature.shape[1]
        mask = torch.arange(T, device=lengths.device)[None, :] < lengths[:, None]

        # temporal downsample, on the device
        pred = frame_feature[..., -self.nclass:].argmax(dim=-1)
        seg_id, _ = segments.segment_ids_from_pred(pred, mask, S)
        P = segments.assignment_matrix(seg_id, mask, S)  # (B, T, S)
        seg_len = (segments.segment_lengths(P) > 0).sum(dim=1).to(torch.int32)  # valid prefix
        seg_feature = segments.pool_mean(P, frame_feature)
        seg_feature = torch.relu(self.seg_update(seg_feature, seg_len))
        seg_feature, seg_clogit = process_feature(self.seg_combine(seg_feature), self.nclass)
        seg_pos = frame_pos[segments.segment_centers(P, S)]  # (B, S, P)

        action_feature, f2a_attn_seg, f2a_logit = self.f2a_layer(
            seg_feature, action_feature, x_pos=seg_pos, y_pos=action_pos, x_len=seg_len,
            generator=generator)
        action_feature = _apply_abranch(self.action_branch, self.c, action_feature, action_pos,
                                        generator)
        action_feature, action_clogit = process_feature(action_feature, self.nclass + 1)
        seg_out, a2f_attn_seg, a2f_logit = self.a2f_layer(
            action_feature, seg_feature, x_pos=action_pos, y_pos=seg_pos, x_len=token_len,
            generator=generator)

        # temporal upsample: P rows are one-hot, so the gather is P @ seg_out
        s2f = P @ seg_out
        frame_feature = self.sf_merge(torch.cat([s2f, frame_feature], dim=-1))
        frame_feature = self.frame_branch(frame_feature, lengths, generator)
        frame_feature, frame_clogit = process_feature(frame_feature, self.nclass)

        saves = {"frame_clogit": frame_clogit, "seg_clogit": seg_clogit,
                 "action_clogit": action_clogit,
                 "action_feature": action_feature[..., : -(self.nclass + 1)],
                 "f2a_attn": f2a_attn_seg @ P.transpose(1, 2),  # (B, M, T)
                 "f2a_attn_logit": f2a_logit,  # (B, M, S)
                 "a2f_attn": P @ a2f_attn_seg,  # (B, T, M)
                 "a2f_attn_logit": a2f_logit,  # (B, S, M)
                 "tdu_P": P, "tdu_seg_valid": segments.segment_lengths(P) > 0, "kind": "U"}
        return frame_feature, action_feature, saves


class FACT(nn.Module):
    """The dual-branch model; forward returns (per-block saves, final frame feature)."""

    def __init__(self, block_cfgs, in_dim: int, n_classes: int, ntoken: int, fpos: bool,
                 s_pred_cap: int, cmr: float = 0.0, tm: dict | None = None):
        super().__init__()
        self.block_cfgs = tuple(block_cfgs)
        self.in_dim, self.n_classes, self.ntoken = in_dim, n_classes, ntoken
        self.fpos, self.s_pred_cap = fpos, s_pred_cap
        self.cmr = float(cmr)
        self.tm = dict(tm or {"use": False})
        self.kernels_enabled = any(c.pallas for c in self.block_cfgs)
        bi = self.block_cfgs[0]
        self.action_query = nn.Parameter(torch.empty(ntoken, 1, bi.a_dim))
        blocks = []
        for c in self.block_cfgs:
            if c.kind == "i":
                blocks.append(InputBlock(c, in_dim, n_classes))
            elif c.kind == "u":
                blocks.append(UpdateBlock(c, n_classes))
            elif c.kind == "U":
                blocks.append(UpdateBlockTDU(c, n_classes, s_pred_cap))
            else:
                raise ValueError(c.kind)
        self.block_list = nn.ModuleList(blocks)

    def init_with(self, g):
        with torch.no_grad():
            self.action_query.copy_(torch.randn(self.action_query.shape, generator=g))

    def set_kernels(self, enabled: bool) -> None:
        """Hand-written kernels on (as configured) or the plain path everywhere
        (the losses follow ``kernels_enabled``)."""
        self.kernels_enabled = enabled and any(c.pallas for c in self.block_cfgs)
        for m in self.modules():
            if hasattr(m, "kernel_allowed"):
                m.use_kernel = enabled and m.kernel_allowed

    def forward(self, feats, mask, lengths, train: bool = False, generator=None):
        """feats (B, T, D) f32, mask (B, T) bool valid-frame prefix, lengths (B,).

        ``train`` puts the model in train mode for the call (as the JAX
        ``apply(train=...)``): the channel / time masks and dropout draw from
        ``generator``, a ``torch.Generator`` on the model's device."""
        self.train(train)
        B, T, _ = feats.shape
        bi = self.block_cfgs[0]
        lengths = lengths.to(device=feats.device, dtype=torch.int32)
        if train and (self.cmr > 0 or self.tm.get("use")) and generator is None:
            raise ValueError("train mode needs a generator")
        if train and self.cmr > 0:
            feats = masking.channel_mask(generator, feats, self.cmr)
        if train and self.tm.get("use"):
            feats = masking.time_mask(generator, feats, lengths, self.tm["t"], self.tm["m"],
                                      self.tm["p"])
        frame_pos = L.positional_encoding_table(T, bi.hid_dim, empty=not self.fpos,
                                                device=feats.device)
        # one (1, M, E) table shared by the batch: the fused sublayers' layout
        action_pos = self.action_query.transpose(0, 1)
        action_feature = feats.new_zeros((B, self.ntoken, bi.a_dim))
        token_len = torch.full((B,), self.ntoken, dtype=torch.int32, device=feats.device)
        frame_feature = feats
        saves_list = []
        for block in self.block_list:
            frame_feature, action_feature, saves = block(
                frame_feature, action_feature, frame_pos, action_pos, lengths, token_len,
                generator)
            saves_list.append(saves)
        return saves_list, frame_feature


def build_fact(cfg: dict, in_dim: int, n_classes: int, s_pred_cap: int, *, device=None,
               generator: torch.Generator | None = None) -> FACT:
    """Construct FACT from a config; parameters are allocated on ``device`` and
    initialised from ``generator`` (a CPU torch.Generator; seed 0 if None)."""
    if cfg["FACT"].get("trans"):
        raise ValueError("transcript mode is not ported")
    with torch.device("meta"):
        model = FACT(resolve_block_cfgs(cfg), in_dim, n_classes, cfg["FACT"]["ntoken"],
                     cfg["FACT"]["fpos"], s_pred_cap, cmr=cfg["FACT"].get("cmr", 0.0),
                     tm=cfg.get("TM"))
    model = model.to_empty(device=device or "cpu")
    L.init_parameters(model, generator or torch.Generator().manual_seed(0))
    return model.eval()
