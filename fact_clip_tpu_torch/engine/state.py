"""Optimizer construction: the reference's SGD / Adam, clipping and LR decay.

Counterpart of ``fact_clip_tpu/engine/state.py:88-118``: global-norm gradient
clipping, then torch-style L2 (the decay added to the gradient), then SGD
with momentum or Adam, at the learning rate of ``lr_schedule``.  The LR decay
is the reference's single step: from epoch ``lr_decay`` on the LR is 0.1x the
base.  ``torch.optim.Adam`` divides by sqrt(v_hat) + eps exactly where
``optax.scale_by_adam`` does (a test holds one step to optax).
"""

from __future__ import annotations

import torch
from torch.autograd.graph import increment_version


def lr_schedule(base_lr: float, lr_decay_epochs: int, steps_per_epoch: int):
    """LR at optimizer step ``step`` (0-based)."""

    def fn(step: int) -> float:
        if lr_decay_epochs <= 0:
            return base_lr
        epoch = step // max(steps_per_epoch, 1)
        return base_lr * 0.1 if epoch >= lr_decay_epochs else base_lr

    return fn


class Optimizer:
    """``step()`` clips the gradients' global norm, then updates the
    parameters with the scheduled LR."""

    def __init__(self, params, cfg: dict, steps_per_epoch: int = 1):
        self.params = [p for p in params if p.requires_grad]
        self.clip = float(cfg.get("clip_grad_norm") or 0.0)
        self.schedule = lr_schedule(float(cfg["lr"]), int(cfg["lr_decay"]), steps_per_epoch)
        wd = float(cfg.get("weight_decay") or 0.0)
        lr = self.schedule(0)
        if cfg["optimizer"] == "Adam":
            # on the card one fused update kernel instead of per-tensor launches
            self.opt = torch.optim.Adam(self.params, lr=lr, weight_decay=wd,
                                        fused=all(p.is_cuda for p in self.params) or None)
        elif cfg["optimizer"] == "SGD":
            self.opt = torch.optim.SGD(self.params, lr=lr, momentum=float(cfg["momentum"] or 0.0),
                                       weight_decay=wd)
        else:
            raise ValueError(f"Unknown optimizer {cfg['optimizer']!r}")
        self.count = 0

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    def step(self) -> None:
        # a parameter the loss does not reach (FACT_CLIP's projection without
        # text embeddings) takes a zero gradient, as optax hands it one, so
        # that weight decay and the moments move it as JAX's update does
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.clip > 0:
            torch.nn.utils.clip_grad_norm_(self.params, self.clip)
        for group in self.opt.param_groups:
            group["lr"] = self.schedule(self.count)
        self.opt.step()
        # the fused update writes the parameters without bumping their
        # version counters, which the kernels' packed-weight caches key on
        # (models/layers.py::KernelLayout): without this an eval after a
        # step would run on the packs of the weights the last eval saw
        increment_version(self.params)
        self.count += 1


def build_optimizer(model: torch.nn.Module, cfg: dict, steps_per_epoch: int = 1) -> Optimizer:
    return Optimizer(model.parameters(), cfg, steps_per_epoch)
