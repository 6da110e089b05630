"""Checkpoints and the auto-resume contract (the port's counterpart of
``fact_clip_tpu/engine/checkpoint.py``).

Weights live at ``<logdir>/ckpts/network.iter-<N>.net``: ``torch.save`` of
the model's ``state_dict``, whose keys and layouts are the reference's torch
ones (the layout ``utils/torch_export.py`` emits), so the JAX package's
``utils/torch_import.py::convert_fact_state_dict`` reads a port checkpoint and
the reference's released ``.net`` / ``.pth`` files load here.  With
``TPU.save_opt_state`` an optimizer sidecar ``state.iter-<N>.state`` beside it
holds ``optimizer.state_dict()`` and the step count, so that a resumed run
continues the optimizer (moments, step and the LR schedule).  ``resume:
"max"`` loads the latest iteration and exits early when a FINISH_PROOF marker
exists; ``resume: <path>`` loads an explicit file (with the split-name check).
"""

from __future__ import annotations

import os
import sys

import torch


def already_finished(logdir: str) -> bool:
    return os.path.exists(logdir) and os.path.exists(os.path.join(logdir, "FINISH_PROOF"))


def check_backend(backend: str) -> None:
    if backend != "msgpack":
        raise NotImplementedError(f"TPU.checkpoint_backend {backend!r}: the port writes one "
                                  "weights file per checkpoint (ROADMAP Queue 1 item 5)")


def save_model_path(ckptdir: str, iteration: int) -> str:
    return os.path.join(ckptdir, f"network.iter-{iteration}.net")


def _state_path(ckpt_file: str) -> str:
    """Sidecar optimizer-state file for a weights checkpoint path."""
    stem = ckpt_file.rsplit(".", 1)[0]
    return stem.replace("network.iter-", "state.iter-") + ".state"


def save_model(model: torch.nn.Module, ckptdir: str, iteration: int) -> str:
    """Write ``network.iter-<N>.net`` (the state_dict, on the CPU)."""
    fname = save_model_path(ckptdir, iteration)
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()}, fname)
    return fname


def load_model(model: torch.nn.Module, path: str) -> None:
    """Load a weights file into ``model`` strictly.  The reference's files
    may also hold the positional tables (``*pe.pe``), which the port
    computes, and FACT_CLIP's ``text_embeddings``, which travel in the clip
    bundle; they are dropped, as the reference's own loader and the JAX
    package's importer drop them."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    own = model.state_dict()
    sd = {k: v for k, v in sd.items()
          if k in own or not (k.endswith("pe.pe") or k == "text_embeddings")}
    model.load_state_dict(sd, strict=True)


def save_train_state(optimizer, ckptdir: str, iteration: int) -> str:
    """Write the optimizer sidecar of ``network.iter-<N>.net``."""
    fname = _state_path(save_model_path(ckptdir, iteration))
    torch.save({"step": optimizer.count, "optimizer": optimizer.opt.state_dict()}, fname)
    return fname


def load_train_state(optimizer, ckpt_file: str) -> bool:
    """Restore the optimizer from the sidecar of ``ckpt_file``; False when
    there is none (a weights-only resume restarts the optimizer)."""
    fname = _state_path(ckpt_file)
    if not os.path.exists(fname):
        return False
    state = torch.load(fname, map_location="cpu", weights_only=True)
    optimizer.opt.load_state_dict(state["optimizer"])
    optimizer.count = int(state["step"])
    return True


def resume_ckpt(cfg, logdir: str):
    """(global_step, ckpt_file or None) by the reference's rules."""
    if cfg.aux.resume == "" or not os.path.exists(logdir):
        print("No resume, Train from Scratch")
        return 0, None

    if cfg.aux.resume == "max":
        if already_finished(logdir):
            print("----------------------------------------")
            print("Exp %s %s already finished, Skip it!" % (cfg.aux.exp, cfg.aux.runid))
            print("----------------------------------------")
            sys.exit()

        ckptdir = os.path.join(logdir, "ckpts")
        files = ([f for f in os.listdir(ckptdir) if f.startswith("network.iter-")]
                 if os.path.isdir(ckptdir) else [])
        if not files:
            print("No resume, Train from Scratch")
            return 0, None

        def it_of(f):
            return int(f.rsplit(".", 1)[0].split("-")[-1])

        latest = max(files, key=it_of)
        ckpt_file = os.path.join(ckptdir, latest)
        print("Resume from", ckpt_file)
        return it_of(latest), ckpt_file

    if not os.path.exists(cfg.aux.resume):
        raise FileNotFoundError(cfg.aux.resume)
    if cfg.split.lower() not in cfg.aux.resume.lower():
        raise ValueError(f"Checkpoint path {cfg.aux.resume} does not mention split {cfg.split}")
    base = os.path.basename(cfg.aux.resume)
    it = int(base.split(".")[1].split("-")[1])
    print("Resume from", cfg.aux.resume)
    return it, cfg.aux.resume


def write_finish_proof(logdir: str) -> None:
    open(os.path.join(logdir, "FINISH_PROOF"), "w").close()
