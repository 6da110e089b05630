"""Experiment logging (the port's counterpart of
``fact_clip_tpu/engine/logging.py``, its path without wandb).

Each ``log`` call appends one JSON object, ``{"step": N, <metric>: value,
...}``, to ``<logdir>/metrics.jsonl``, the records the JAX package writes
when wandb is absent, under the reference's namespaces (train-loss/*,
train-metric/*, test-metric-{all,seen,unseen}/*).  wandb is not on the card's
machine and is not ported (ROADMAP Queue 1 item 5).
"""

from __future__ import annotations

import json
import os


class Logger:
    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")

    def log(self, metrics: dict, step: int) -> None:
        rec = {"step": int(step)}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = str(v)
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def finish(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None


def split_metric_namespace(metrics: dict) -> dict:
    """Route metrics into test-metric-{all,seen,unseen}/* namespaces."""
    out = {}
    for k, v in metrics.items():
        if "-seen" in k:
            out[f"test-metric-seen/{k.replace('-seen', '')}"] = v
        elif "-unseen" in k:
            out[f"test-metric-unseen/{k.replace('-unseen', '')}"] = v
        else:
            out[f"test-metric-all/{k}"] = v
    return out
