"""The eval step and the train step.

Counterpart of the vanilla branch of ``fact_clip_tpu/engine/steps.py``:
``eval_step`` (:149-152) is the forward through every block and the
two-branch decode; ``train_step_fn`` (:128-142) is the forward in train mode,
the host Hungarian match, all FACT losses, the backward, the optimizer update
and the train-time decode of the pre-update forward.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..models import decode, losses, matching
from .state import build_optimizer


def _decode(saves, mwt: float):
    last = saves[-1]
    token_mask = torch.ones(last["action_clogit"].shape[:2], dtype=torch.bool,
                            device=last["action_clogit"].device)
    return decode.decode_two_branch(last["action_clogit"], last["a2f_attn"],
                                    last["frame_clogit"], mwt, token_mask)


def make_eval_step(model, mwt: float):
    """eval_step(feats (B, T, D), mask (B, T) bool, lengths (B,)) -> (B, T) int64."""

    def eval_step(feats, mask, lengths):
        with torch.inference_mode():
            saves, _ = model(feats, mask, lengths)
            return _decode(saves, mwt)

    return eval_step


class TrainStep:
    """``step(batch, generator)`` -> {"loss", "per_video_loss", "pred", "seg2tok"}.

    ``batch``: the ``Batch.device_arrays`` dict as tensors on the model's
    device; ``generator``: a ``torch.Generator`` on that device for the
    masks and dropout.  ``times``, when given a dict, collects per-phase
    milliseconds (forward, match, losses, backward, optimizer, decode), each
    phase closed by a device synchronisation."""

    def __init__(self, model, cfg: dict, nclasses: int, cweight, steps_per_epoch: int = 1):
        if cfg["TPU"].get("matcher", "auto") not in ("auto", "host"):
            raise ValueError("the port matches on the host (scipy): matcher 'auto' or 'host'")
        if cfg["FACT"].get("trans"):
            raise ValueError("transcript mode is not ported")
        cweight = np.asarray(cweight, np.float32)
        if cweight.shape != (nclasses + 1,):
            raise ValueError(f"cweight must be (nclasses + 1,) = ({nclasses + 1},)")
        self.model, self.cfg = model, cfg
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

    def loss(self, batch: dict, generator=None, times=None):
        """Forward in train mode, match and losses: (per-video loss (B,), seg2tok, saves)."""
        t0 = self._now(times)
        saves, _ = self.model(batch["feats"], batch["mask"], batch["lengths"], train=True,
                              generator=generator)
        t0 = self._mark(times, "forward", t0)
        last = saves[-1]
        seg2tok = matching.match(self.cfg["Loss"], torch.softmax(last["action_clogit"], dim=-1),
                                 last["a2f_attn"], batch["transcript"], batch["seg_label"],
                                 batch["seg_mask"], batch["mask"])
        t0 = self._mark(times, "match", t0)
        per_video = losses.fact_loss(
            saves, batch, seg2tok, self.cweight, self.sw,
            ref_weight_order=bool(self.cfg["Loss"].get("ref_weight_order", False)),
            use_kernel=self.model.kernels_enabled)
        self._mark(times, "losses", t0)
        return per_video, seg2tok, saves

    def __call__(self, batch: dict, generator=None, times=None) -> dict:
        per_video, seg2tok, saves = self.loss(batch, generator, times=times)
        t0 = self._now(times)
        loss = per_video.mean()
        self.optimizer.zero_grad()
        loss.backward()
        t0 = self._mark(times, "backward", t0)
        self.optimizer.step()
        t0 = self._mark(times, "optimizer", t0)
        with torch.no_grad():
            pred = _decode(saves, self.mwt)
        self._mark(times, "decode", t0)
        return {"loss": loss.detach(), "per_video_loss": per_video.detach(), "pred": pred,
                "seg2tok": seg2tok}


def make_train_step(model, cfg: dict, nclasses: int, cweight, steps_per_epoch: int = 1):
    """The train step with its optimizer (``cfg``'s optimizer keys)."""
    return TrainStep(model, cfg, nclasses, cweight, steps_per_epoch)
