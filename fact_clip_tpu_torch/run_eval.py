"""Checkpoint evaluation entry point of the port (counterpart of
``scripts/run_eval.py``).

    python -m fact_clip_tpu_torch.run_eval --cfg <yaml...> --ckpt <file> [--device cpu] [--set k v ...]

Loads ``network.iter-<N>.net`` (or a reference ``.net`` / ``.pth`` state_dict)
into the config's model, runs the test split and writes
``eval_results/eval_result.gz`` beside the checkpoint's directory.  Runs on the
CUDA card and refuses to start without one unless given ``--device cpu``.  A
``use_clip`` recipe reads its text embeddings as the train CLI does and
decodes FACT_CLIP with them (zero-shot over every class).  A mixed-precision
recipe (``TPU.compute_dtype: bfloat16``, e.g. ``fact_clip_tpu/configs/
havid_tpu.yaml``) evaluates on the bf16 forms of the kernels, its features
crossing to the card in bf16.
"""

from __future__ import annotations

import os

from .engine import checkpoint as ckpt_io
from .engine.setup import build_experiment
from .engine.steps import make_eval_step
from .engine.train_loop import check_loop_cfg, evaluate
from .home import get_project_base
from .train import clip_text_embeddings, parse_args, start


def main(argv=None):
    args = parse_args(argv, ckpt=True)
    device, cfg = start(args)
    check_loop_cfg(cfg, train=False)
    exp = build_experiment(cfg, device,
                           text_embeddings=clip_text_embeddings(cfg, get_project_base()))
    print("Test dataset ", exp.test_dataset)
    print(f"Loading checkpoint: {args.ckpt_file}")
    ckpt_io.load_model(exp.model, args.ckpt_file)
    print("Checkpoint loaded.")
    ckpt = evaluate(-2, exp, make_eval_step(exp.model, cfg.FACT.mwt, exp.clip_bundle), None,
                    None)
    savedir = os.path.join(os.path.dirname(args.ckpt_file), "../eval_results")
    os.makedirs(savedir, exist_ok=True)
    ckpt.save(os.path.join(savedir, "eval_result.gz"))
    if len(exp.test_dataset.holdout_classes) > 0:
        ckpt.save_detailed_results(os.path.join(savedir, "eval_detailed.json"))
    return ckpt


if __name__ == "__main__":
    main()
