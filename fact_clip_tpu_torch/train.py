"""Training entry point of the port (counterpart of ``scripts/train.py``).

    python -m fact_clip_tpu_torch.train --cfg <yaml...> [--device cpu] --set k v ...

The YAML files (e.g. ``fact_clip_tpu/configs/havid.yaml``) are read as data
(``configs/yaml_lite.py``); ``--set`` takes dotted keys and swallows the rest
of the line, so it comes last.  It trains on the CUDA card and refuses to
start without one; ``--device cpu`` runs the plain PyTorch path on the CPU.
Logs and checkpoints go to ``<project>/<aux.logdir>``.  A ``use_clip``
recipe (FACT_CLIP, e.g. ``openvocab_havid_view0_lh_pt.yaml``) reads its
text embeddings from ``CLIP.text_emb_path`` (or the dataset's default
cache); where there are none it trains without the contrastive loss.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from .configs import setup_cfg
from .data.io import load_action_mapping
from .engine.setup import resolve_device
from .engine.train_loop import run_train
from .home import get_project_base


def parse_args(argv=None, ckpt: bool = False):
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg", dest="cfg_file", nargs="*", help="config file(s)", default=[])
    if ckpt:
        parser.add_argument("--ckpt", dest="ckpt_file", required=True,
                            help="checkpoint file to evaluate")
    parser.add_argument("--device", default=None,
                        help="'cpu' for the CPU; the CUDA card when not given")
    parser.add_argument("--set", dest="set_cfgs", help="set config keys", default=None,
                        nargs=argparse.REMAINDER)
    return parser.parse_args(argv)


def start(args):
    """(device, cfg) of a CLI call: the device first, so that a run without a
    card stops before it reads anything."""
    device = resolve_device(args.device)
    cfg = setup_cfg(args.cfg_file, args.set_cfgs)
    print("============")
    print(cfg)
    print("============")
    return device, cfg


def resolve_text_embeddings(cfg, base: str):
    """The class text embeddings of a ``use_clip`` run (``scripts/train.py:31``):
    read from the cache (computed with the HF CLIP text tower where the cache
    is missing); None, with a warning, where there is no mapping file or
    neither works, and the run then trains without the contrastive loss."""
    from .data.text_embeddings import get_or_compute_text_embeddings

    if cfg.map_fname:
        map_fname = cfg.map_fname
    elif cfg.dataset.startswith("havid"):
        variant = cfg.dataset.replace("havid_", "")
        map_fname = os.path.join(base, "data", "HAViD", "ActionSegmentation", "data", variant,
                                 "mapping.txt")
    else:
        map_fname = None

    if map_fname and os.path.exists(map_fname):
        label2index, index2label = load_action_mapping(map_fname)
        try:
            return get_or_compute_text_embeddings(cfg, label2index, index2label, base=base)
        except Exception as e:  # noqa: BLE001
            print(f"Warning: Failed to load/compute text embeddings: {e}")
            print("Continuing without text embeddings (contrastive loss will be disabled)")
    else:
        print(f"Warning: Mapping file not found at {map_fname if map_fname else 'default path'}")
        print("Continuing without text embeddings (contrastive loss will be disabled)")
    return None


def clip_text_embeddings(cfg, base: str):
    """``resolve_text_embeddings`` for a ``use_clip`` config, None otherwise."""
    if not cfg.use_clip:
        return None
    print("=" * 60)
    print("CREATING FACT_CLIP MODEL (Open-Vocabulary)")
    print("=" * 60)
    if cfg.dataset == "epic":
        raise ValueError("FACT_CLIP not yet supported for epic dataset")
    return resolve_text_embeddings(cfg, base)


def main(argv=None):
    device, cfg = start(parse_args(argv))
    if cfg.aux.debug:
        np.random.seed(1)
    base = get_project_base()
    run_train(cfg, device=device, base_dir=base,
              text_embeddings=clip_text_embeddings(cfg, base))


if __name__ == "__main__":
    main()
