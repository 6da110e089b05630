"""FACT blocks and model over batched, padded videos (PyTorch).

Counterpart of ``fact_clip_tpu/models/blocks.py:150-522``: InputBlock (frame
tower + SCA decoder), UpdateBlock (f2a X2Y -> SA decoder -> a2f X2Y -> frame
tower) and UpdateBlockTDU (the same at predicted-segment granularity with a
static segment cap).  Each block returns (frame_feature, action_feature,
saves); ``FACT.forward`` returns the list of saves and the final frame
feature.  With ``train=True`` it runs in train mode: channel and time masks
on the input features (blocks.py:460-465) and dropout in the layers, every
draw from the ``generator`` passed in.  In transcript mode (``FACT.trans``,
blocks.py:475-484) the tokens are the video's transcript, embedded
(``action_embed``) plus the sinusoid table of the token axis, their
positions zeros and their mask the transcript's; the GRU action branch
(``a: gru`` / ``gru_om``) runs only there.  The CLIP head is
``models/clip_model.py``'s subclass.  Under mixed precision (``BlockCfg.dtype
== "bfloat16"``) the frame stream between blocks and the segment stream of
the TDU are bf16 and every saved logit and probability f32, as in JAX
(blocks.py:150-175, :265, :311, :359, :386, :399).
"""

from __future__ import annotations

import torch
from torch import nn

from ..configs import BlockCfg, resolve_block_cfgs
from ..ops import masking, segments
from ..ops.bf16 import BF16
from . import layers as L


def process_feature(feature, nclass: int, dtype=None):
    """Split the trailing ``nclass`` dims off as logits and put their softmax
    back in their place (blocks.py:150-175).  The logits are f32; the stream
    is cast to ``dtype`` (the block's compute dtype: JAX's frame and segment
    sites) or, where None, promoted to f32 (the action-token sites)."""
    clogit = feature[..., -nclass:].float()
    out_dtype = dtype or torch.promote_types(feature.dtype, torch.float32)
    out = torch.cat([feature[..., :-nclass].to(out_dtype),
                     torch.softmax(clogit, dim=-1).to(out_dtype)], dim=-1)
    return out, clogit


def _dtype(c: BlockCfg):
    """The block's compute dtype as a torch dtype (None: float32)."""
    return BF16 if c.dtype == "bfloat16" else None


def make_fbranch(c: BlockCfg, in_dim: int | None):
    """The frame tower (blocks.py:182-197): the in map only in the input block;
    ``c.quantize`` reaches the MSTCN and MS-TCN++ towers, the X2Y maps and
    the SCA decoder, as in JAX (blocks.py:189, 195, 212, 230)."""
    f_in = in_dim if in_dim is not None else c.f_dim
    if c.f == "m":
        return L.MSTCN(f_in, c.f_dim, c.hid_dim, c.f_layers, ln=c.f_ln, ngroup=c.f_ngp,
                       in_map=in_dim is not None, use_kernel=c.pallas, dropout=c.dropout,
                       quantize=c.quantize, dtype=_dtype(c))
    if c.f == "m2":
        return L.MSTCN2(f_in, c.f_dim, c.hid_dim, c.f_layers, ngroup=c.f_ngp,
                        in_map=in_dim is not None, use_kernel=c.pallas, dropout=c.dropout,
                        quantize=c.quantize, dtype=_dtype(c))
    raise ValueError(f"frame branch {c.f!r} is not ported (only 'm' and 'm2')")


def make_abranch(c: BlockCfg):
    """The action branch (blocks.py:200-223); ``resolve_block_cfgs`` lets the
    GRU branch through in transcript mode only."""
    if c.a in ("gru", "gru_om"):
        return L.ActionUpdateGRU(c.a_dim, c.a_dim, c.hid_dim, c.a_layers, dropout=c.dropout,
                                 out_map=c.a == "gru_om")
    if c.a == "sa":
        return L.SADecoder(c.a_dim, c.a_dim, c.hid_dim, c.a_layers, c.a_nhead, c.a_ffdim,
                           use_kernel=c.pallas and c.pallas_sa, dropout=c.dropout,
                           dtype=_dtype(c))
    if c.a == "sca":
        return L.SCADecoder(c.a_dim, c.a_dim, c.hid_dim, c.hid_dim, c.a_layers, c.a_nhead,
                            c.a_ffdim, use_kernel_sa=c.pallas and c.pallas_sa,
                            use_kernel_attn=c.pallas and c.pallas_attn, dropout=c.dropout,
                            quantize=c.quantize, dtype=_dtype(c))
    raise ValueError(f"action branch {c.a!r} is not ported")


def make_x2y(c: BlockCfg, outdim: int):
    return L.X2YMap(c.hid_dim, c.hid_dim, outdim, c.hid_dim, kq_pos=True, use_kernel=c.pallas,
                    dropout=c.dropout, quantize=c.quantize, dtype=_dtype(c))


def _apply_abranch(branch, c, action_feature, action_pos, token_len, generator, memory=None,
                   memory_pos=None, memory_len=None):
    if c.a in ("gru", "gru_om"):  # over the valid tokens only (blocks.py:243)
        return branch(action_feature, token_len, generator)
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
        frame_feature, frame_clogit = process_feature(frame_feature, self.nclass, _dtype(self.c))
        action_feature = _apply_abranch(self.action_branch, self.c, action_feature, action_pos,
                                        token_len, generator, memory=frame_feature,
                                        memory_pos=frame_pos, memory_len=lengths)
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
                                        token_len, generator)
        action_feature, action_clogit = process_feature(action_feature, self.nclass + 1)
        # a -> f: queries are the frames, keys/values the action tokens
        frame_feature, a2f_attn, a2f_logit = self.a2f_layer(
            action_feature, frame_feature, x_pos=action_pos, y_pos=frame_pos, x_len=token_len,
            generator=generator)
        frame_feature = self.frame_branch(frame_feature, lengths, generator)
        frame_feature, frame_clogit = process_feature(frame_feature, self.nclass, _dtype(self.c))
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
        # a bf16 stream is pooled in f32 (JAX promotes P^T @ frames)
        seg_feature = segments.pool_mean(P, frame_feature.float())
        seg_feature = torch.relu(self.seg_update(seg_feature, seg_len))
        seg_feature, seg_clogit = process_feature(self.seg_combine(seg_feature), self.nclass,
                                                  _dtype(self.c))
        seg_pos = frame_pos[segments.segment_centers(P, S)]  # (B, S, P)

        action_feature, f2a_attn_seg, f2a_logit = self.f2a_layer(
            seg_feature, action_feature, x_pos=seg_pos, y_pos=action_pos, x_len=seg_len,
            generator=generator)
        action_feature = _apply_abranch(self.action_branch, self.c, action_feature, action_pos,
                                        token_len, generator)
        action_feature, action_clogit = process_feature(action_feature, self.nclass + 1)
        seg_out, a2f_attn_seg, a2f_logit = self.a2f_layer(
            action_feature, seg_feature, x_pos=action_pos, y_pos=seg_pos, x_len=token_len,
            generator=generator)

        # temporal upsample: P rows are one-hot, so the gather is P @ seg_out
        # (exact: a bf16 seg_out comes back bf16, blocks.py:386); the merge
        # is f32 (JAX's SplitTorchDense has no compute dtype)
        s2f = (P @ seg_out.float()).to(seg_out.dtype)
        frame_feature = self.sf_merge(torch.cat([s2f, frame_feature], dim=-1).float())
        frame_feature = self.frame_branch(frame_feature, lengths, generator)
        frame_feature, frame_clogit = process_feature(frame_feature, self.nclass, _dtype(self.c))

        saves = {"frame_clogit": frame_clogit, "seg_clogit": seg_clogit,
                 "action_clogit": action_clogit,
                 "action_feature": action_feature[..., : -(self.nclass + 1)],
                 "f2a_attn": f2a_attn_seg @ P.transpose(1, 2),  # (B, M, T)
                 "f2a_attn_logit": f2a_logit,  # (B, M, S)
                 "a2f_attn": P @ a2f_attn_seg,  # (B, T, M)
                 "a2f_attn_logit": a2f_logit,  # (B, S, M)
                 "tdu_P": P, "tdu_seg_valid": segments.segment_lengths(P) > 0, "kind": "U"}
        return frame_feature, action_feature, saves


def augment(feats, lengths, cmr: float, tm: dict, generator):
    """The train-time masks of the input features (blocks.py:460-465): whole
    channels at rate ``cmr``, then time spans when ``tm["use"]``, every draw
    from ``generator``."""
    if (cmr > 0 or tm.get("use")) and generator is None:
        raise ValueError("train mode needs a generator")
    if cmr > 0:
        feats = masking.channel_mask(generator, feats, cmr)
    if tm.get("use"):
        feats = masking.time_mask(generator, feats, lengths, tm["t"], tm["m"], tm["p"])
    return feats


class FACT(nn.Module):
    """The dual-branch model; forward returns (per-block saves, final frame
    feature).  With ``trans`` the model has no learned queries but the
    transcript embedding ``action_embed`` (n_classes x a_dim), and forward
    takes the transcript."""

    def __init__(self, block_cfgs, in_dim: int, n_classes: int, ntoken: int, fpos: bool,
                 s_pred_cap: int, cmr: float = 0.0, tm: dict | None = None, trans: bool = False):
        super().__init__()
        self.block_cfgs = tuple(block_cfgs)
        self.in_dim, self.n_classes, self.ntoken = in_dim, n_classes, ntoken
        self.fpos, self.s_pred_cap, self.trans = fpos, s_pred_cap, bool(trans)
        self.cmr = float(cmr)
        self.tm = dict(tm or {"use": False})
        self.kernels_enabled = any(c.pallas for c in self.block_cfgs)
        bi = self.block_cfgs[0]
        if self.trans:
            self.action_embed = nn.Embedding(n_classes, bi.a_dim)
        else:
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
            tokens = self.action_embed.weight if self.trans else self.action_query
            tokens.copy_(torch.randn(tokens.shape, generator=g))

    def embed_transcript(self, transcript):
        return self.action_embed(transcript)

    def set_kernels(self, enabled: bool) -> None:
        """Hand-written kernels on (as configured) or the plain path everywhere
        (the losses follow ``kernels_enabled``)."""
        self.kernels_enabled = enabled and any(c.pallas for c in self.block_cfgs)
        for m in self.modules():
            if hasattr(m, "kernel_allowed"):
                m.use_kernel = enabled and m.kernel_allowed

    def forward(self, feats, mask, lengths, train: bool = False, generator=None,
                transcript=None, seg_mask=None):
        """feats (B, T, D) f32, mask (B, T) bool valid-frame prefix, lengths (B,);
        in transcript mode also transcript (B, M) class ids and seg_mask (B, M)
        bool, its valid prefix (M, the segment cap, is the token count).

        ``train`` puts the model in train mode for the call (as the JAX
        ``apply(train=...)``): the channel / time masks and dropout draw from
        ``generator``, a ``torch.Generator`` on the model's device."""
        self.train(train)
        B, T, _ = feats.shape
        bi = self.block_cfgs[0]
        lengths = lengths.to(device=feats.device, dtype=torch.int32)
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
                frame_feature, action_feature, frame_pos, action_pos, lengths, token_len,
                generator)
            saves_list.append(saves)
        return saves_list, frame_feature


def token_inputs(model, B: int, transcript, seg_mask, feats):
    """(action_feature (B, M, a_dim), action_pos (1, M, a_dim), token_len (B,))
    of FACT or the verb/noun model (blocks.py:468-484, verbnoun.py:290-307):
    zero features at the learned queries, or in transcript mode the embedded
    transcript plus the M-row sinusoid table at zero positions, the valid
    tokens the transcript's.  One positional table is shared by the batch:
    the fused sublayers' layout."""
    a_dim, dev = model.block_cfgs[0].a_dim, feats.device
    if not model.trans:
        if transcript is not None:
            raise ValueError("a transcript was given to a model not in transcript mode")
        return (feats.new_zeros((B, model.ntoken, a_dim), dtype=torch.float32),
                model.action_query.transpose(0, 1),
                torch.full((B,), model.ntoken, dtype=torch.int32, device=dev))
    if transcript is None or seg_mask is None:
        raise ValueError("transcript mode: pass transcript= and seg_mask=")
    transcript = transcript.to(device=dev, dtype=torch.int64)
    M = transcript.shape[1]
    pe = L.positional_encoding_table(M, a_dim, device=dev)
    action_feature = model.embed_transcript(transcript) + pe[None]
    return (action_feature, feats.new_zeros((1, M, a_dim), dtype=torch.float32),
            seg_mask.to(dev).sum(dim=1).to(torch.int32))


def build_fact(cfg: dict, in_dim: int, n_classes: int, s_pred_cap: int, *, device=None,
               generator: torch.Generator | None = None) -> FACT:
    """Construct FACT from a config; parameters are allocated on ``device``
    (the CUDA card when None: the port is written for it; pass
    ``device="cpu"`` for its plain PyTorch path on the CPU) and initialised
    from ``generator`` (a CPU torch.Generator; seed 0 if None)."""
    return place_model(lambda: FACT(*fact_args(cfg, in_dim, n_classes, s_pred_cap)),
                       "build_fact", device, generator)


def fact_args(cfg: dict, in_dim: int, n_classes: int, s_pred_cap: int) -> tuple:
    """FACT's constructor arguments of ``cfg``."""
    return (resolve_block_cfgs(cfg), in_dim, n_classes, cfg["FACT"]["ntoken"],
            cfg["FACT"]["fpos"], s_pred_cap, cfg["FACT"].get("cmr", 0.0), cfg.get("TM"),
            bool(cfg["FACT"].get("trans")))


def place_model(make, who: str, device, generator):
    """``make()`` built on the meta device, then allocated on ``device`` (the
    CUDA card when None; it raises without one) and initialised from
    ``generator`` (seed 0 if None), in eval mode."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(f"{who}: no CUDA card is available; pass device='cpu' to "
                               "build the model on the CPU")
        device = "cuda"
    with torch.device("meta"):
        model = make()
    model = model.to_empty(device=device)
    L.init_parameters(model, generator or torch.Generator().manual_seed(0))
    return model.eval()
