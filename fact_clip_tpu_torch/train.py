"""Training entry point of the port (counterpart of ``scripts/train.py``).

    python -m fact_clip_tpu_torch.train --cfg <yaml...> [--device cpu] --set k v ...

The YAML files (e.g. ``fact_clip_tpu/configs/havid.yaml``) are read as data
(``configs/yaml_lite.py``); ``--set`` takes dotted keys and swallows the rest
of the line, so it comes last.  It trains on the CUDA card and refuses to
start without one; ``--device cpu`` runs the plain PyTorch path on the CPU.
Logs and checkpoints go to ``<project>/<aux.logdir>``.
"""

from __future__ import annotations

import argparse

import numpy as np

from .configs import setup_cfg
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


def main(argv=None):
    device, cfg = start(parse_args(argv))
    if cfg.aux.debug:
        np.random.seed(1)
    run_train(cfg, device=device, base_dir=get_project_base())


if __name__ == "__main__":
    main()
