"""The eval step and the train step.

Counterpart of ``fact_clip_tpu/engine/steps.py``:
``eval_step`` (:149-152) is the forward through every block and the
two-branch decode (the composed one of the verb/noun model, :47-62);
``train_step_fn`` (:128-142) is the forward in train mode,
the host match, all FACT losses, the backward, the optimizer update
and the train-time decode of the pre-update forward; for a ``VerbNounFACT``
(``verbnoun=True`` there) the match runs on exp(action_logp), the losses
are the verb/noun ones and the decode is the composed one.  Given a clip
bundle (``engine/setup.py::build_clip_bundle``; FACT_CLIP, :41, :68-72,
:107-126) the per-video loss is ``fact_w`` x the FACT loss + ``cont_w`` x
the InfoNCE loss on the labels remapped to the seen classes (frames of a
held-out class masked out), and the decode is the CLIP decode against every
class's embedding; without one a FACT_CLIP model trains and decodes as FACT.
In transcript mode (a model built with ``FACT.trans``, :20-23, :52-66, :97)
the model takes the batch's transcript and seg_mask, the matching is
``seq``, the update blocks' attention smoothing masks the padded tokens,
and the decode is the transcript's (``decode_with_transcript``; the
verb/noun model's ``decode_transcript_attn_only``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..models import decode, losses, matching
from ..models.verbnoun import VerbNounFACT
from ..ops.verbnoun_compose import composed_decode
from .state import build_optimizer


def _decode(saves, mwt: float, frame_emb=None, clip_bundle=None):
    """The two-branch decode, every token valid; with a clip bundle the
    zero-shot decode of ``frame_emb`` against every class's text embedding."""
    last = saves[-1]
    token_mask = torch.ones(last["action_clogit"].shape[:2], dtype=torch.bool,
                            device=last["action_clogit"].device)
    if clip_bundle is not None:
        return decode.decode_with_clip(last["action_clogit"], last["a2f_attn"], frame_emb,
                                       clip_bundle["text_emb"], clip_bundle["temp"], mwt,
                                       token_mask)
    return decode.decode_two_branch(last["action_clogit"], last["a2f_attn"],
                                    last["frame_clogit"], mwt, token_mask)


def _decode_verbnoun(model, saves, mwt: float):
    """The composed two-branch decode (JAX ``engine/steps.py:47-62``), every
    token valid; K7's blend when the model's kernels are on."""
    last = saves[-1]
    token_mask = torch.ones(last["action_logp"].shape[:2], dtype=torch.bool,
                            device=last["action_logp"].device)
    return composed_decode(last["action_logp"], last["a2f_attn"], last["frame_vlogp"],
                           last["frame_nlogp"], model.vids, model.nids, mwt, token_mask,
                           kernel=model.kernels_enabled)


def _decode_transcript(model, saves, mwt: float, transcript, seg_mask):
    last = saves[-1]
    if isinstance(model, VerbNounFACT):
        return decode.decode_transcript_attn_only(transcript, seg_mask, last["a2f_attn"])
    return decode.decode_with_transcript(transcript, seg_mask, last["a2f_attn"],
                                         last["frame_clogit"], mwt)


def _decode_any(model, saves, tail, mwt: float, clip_bundle, transcript=None, seg_mask=None):
    if model.trans:
        return _decode_transcript(model, saves, mwt, transcript, seg_mask)
    if isinstance(model, VerbNounFACT):
        return _decode_verbnoun(model, saves, mwt)
    return _decode(saves, mwt, tail, clip_bundle)


def make_eval_step(model, mwt: float, clip_bundle=None):
    """eval_step(feats (B, T, D), mask (B, T) bool, lengths (B,)) -> (B, T)
    class ids (int64), or action ids in [0, n_act) (int32) for a
    ``VerbNounFACT``.  With a clip bundle (a FACT_CLIP model) the CLIP
    decode gives the class ids.  A model in transcript mode also takes
    ``transcript`` (B, S) and ``seg_mask`` (B, S) and gives ids (int64) out
    of each video's transcript."""

    def eval_step(feats, mask, lengths, transcript=None, seg_mask=None):
        with torch.inference_mode():
            saves, tail = model(feats, mask, lengths, **_token_kwargs(model, transcript,
                                                                      seg_mask))
            return _decode_any(model, saves, tail, mwt, clip_bundle, transcript, seg_mask)

    return eval_step


def _token_kwargs(model, transcript, seg_mask) -> dict:
    """The model's transcript arguments: given in transcript mode only."""
    return dict(transcript=transcript, seg_mask=seg_mask) if model.trans else {}


class TrainStep:
    """``step(batch, generator)`` -> {"loss", "per_video_loss", "pred", "seg2tok"}, and
    with a clip bundle also the per-video "fact_loss" and "contrastive_loss".

    ``batch``: the ``Batch.device_arrays`` dict as tensors on the model's
    device; ``generator``: a ``torch.Generator`` on that device for the
    masks and dropout.  ``times``, when given a dict, collects per-phase
    milliseconds (forward, match, losses, backward, optimizer, decode), each
    phase closed by a device synchronisation."""

    def __init__(self, model, cfg: dict, nclasses: int, cweight, steps_per_epoch: int = 1,
                 clip_bundle=None):
        if any(c.dtype for c in model.block_cfgs) and any(
                c.dropout > 0 for c in model.block_cfgs):
            raise NotImplementedError("TrainStep: training in bf16 (TPU.compute_dtype) with "
                                      "dropout > 0 is ROADMAP M7 item 5")
        self.nclasses = nclasses
        self.matcher = matching.resolve_matcher(cfg["TPU"].get("matcher", "auto"))
        self.auction_phases = int(cfg["TPU"].get("auction_phases", 1) or 1)
        self.match_stats = {}  # the last step's auction iterations (matcher: auction)
        if bool(cfg["FACT"].get("trans")) != model.trans:
            raise ValueError("FACT.trans differs between the config and the model")
        self.verbnoun = isinstance(model, VerbNounFACT)
        cweight = np.asarray(cweight, np.float32)
        if cweight.shape != (nclasses + 1,):
            raise ValueError(f"cweight must be (nclasses + 1,) = ({nclasses + 1},)")
        self.model, self.cfg, self.clip_bundle = model, cfg, clip_bundle
        self.device = next(model.parameters()).device
        self.cweight = torch.as_tensor(cweight, device=self.device)
        self.sw = float(cfg["Loss"]["sw"])
        self.mwt = float(cfg["FACT"]["mwt"])
        self.optimizer = build_optimizer(model, cfg, steps_per_epoch)

    def _now(self, times) -> float:
        if times is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def _mark(self, times, name, t0) -> float:
        if times is None:
            return t0
        t = self._now(times)
        times[name] = times.get(name, 0.0) + (t - t0) * 1e3
        return t

    def loss(self, batch: dict, generator=None, times=None, seg2tok=None, aux=None):
        """Forward in train mode, match and losses: (per-video loss (B,), seg2tok, saves).
        Given ``seg2tok``, the losses take that matching instead of a new one
        (two paths of one model held to one discrete choice).  ``aux``, when
        given a dict, receives the per-video "fact_loss" and, with a clip
        bundle, "contrastive_loss" and the frame embedding "frame_emb"."""
        t0 = self._now(times)
        saves, tail = self.model(batch["feats"], batch["mask"], batch["lengths"], train=True,
                                 generator=generator,
                                 **_token_kwargs(self.model, batch["transcript"],
                                                 batch["seg_mask"]))
        t0 = self._mark(times, "forward", t0)
        if seg2tok is None:
            last = saves[-1]
            cprob = (torch.exp(last["action_logp"]) if self.verbnoun
                     else torch.softmax(last["action_clogit"], dim=-1))
            seg2tok = matching.match(self.cfg["Loss"], cprob, last["a2f_attn"],
                                     batch["transcript"], batch["seg_label"], batch["seg_mask"],
                                     batch["mask"], matcher=self.matcher,
                                     nclasses=self.nclasses, phases=self.auction_phases,
                                     stats=self.match_stats)
        t0 = self._mark(times, "match", t0)
        if self.verbnoun:
            per_video = losses.verbnoun_fact_loss(saves, batch, seg2tok, self.cweight, self.sw,
                                                  self.model.vids, self.model.nids)
        else:
            per_video = losses.fact_loss(
                saves, batch, seg2tok, self.cweight, self.sw,
                token_mask=batch["seg_mask"] if self.model.trans else None,
                ref_weight_order=bool(self.cfg["Loss"].get("ref_weight_order", False)),
                use_kernel=self.model.kernels_enabled)
        if aux is not None:
            aux["fact_loss"] = per_video
        bundle = self.clip_bundle
        if bundle is not None:
            labels = bundle["label_map"][batch["labels"].long()]  # global -> seen, -1 held out
            contrastive = losses.infonce_contrastive_loss(
                tail, bundle["seen_text_emb"], labels.clamp(min=0),
                batch["mask"] & (labels >= 0), bundle["temp"])
            per_video = bundle["fact_w"] * per_video + bundle["cont_w"] * contrastive
            if aux is not None:
                aux.update(contrastive_loss=contrastive, frame_emb=tail)
        self._mark(times, "losses", t0)
        return per_video, seg2tok, saves

    def __call__(self, batch: dict, generator=None, times=None) -> dict:
        aux = {}
        per_video, seg2tok, saves = self.loss(batch, generator, times=times, aux=aux)
        t0 = self._now(times)
        loss = per_video.mean()
        self.optimizer.zero_grad()
        loss.backward()
        t0 = self._mark(times, "backward", t0)
        self.optimizer.step()
        t0 = self._mark(times, "optimizer", t0)
        with torch.no_grad():
            pred = _decode_any(self.model, saves, aux.get("frame_emb"), self.mwt,
                               self.clip_bundle, batch["transcript"], batch["seg_mask"])
        self._mark(times, "decode", t0)
        out = {"loss": loss.detach(), "per_video_loss": per_video.detach(), "pred": pred,
               "seg2tok": seg2tok}
        if self.clip_bundle is not None:
            out.update(fact_loss=aux["fact_loss"].detach(),
                       contrastive_loss=aux["contrastive_loss"].detach())
        return out


def make_train_step(model, cfg: dict, nclasses: int, cweight, steps_per_epoch: int = 1,
                    clip_bundle=None):
    """The train step with its optimizer (``cfg``'s optimizer keys).  For a
    ``VerbNounFACT`` ``nclasses`` is the action count (3,806 at epic scale)
    and ``cweight`` is (nclasses + 1,); for FACT_CLIP ``clip_bundle`` adds
    the contrastive loss and the CLIP decode."""
    return TrainStep(model, cfg, nclasses, cweight, steps_per_epoch, clip_bundle)
