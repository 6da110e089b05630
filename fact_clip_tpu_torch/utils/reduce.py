"""Recursive metric reduction over nested lists, tuples, dicts and arrays
(the port's copy of ``fact_clip_tpu/utils/reduce.py``).
"""

from __future__ import annotations

import numpy as np


def easy_reduce(scores, mode: str = "mean", skip_nan: bool = False):
    assert isinstance(scores, list), type(scores)

    if len(scores) == 0:
        return np.nan

    first = scores[0]
    if isinstance(first, list):
        return [easy_reduce([s[i] for s in scores], mode=mode, skip_nan=skip_nan) for i in range(len(first))]

    if isinstance(first, np.ndarray):
        assert first.ndim == 1
        return np.stack(scores, axis=0).mean(0)

    if isinstance(first, tuple):
        return tuple(
            easy_reduce([s[i] for s in scores], mode=mode, skip_nan=skip_nan) for i in range(len(first))
        )

    if isinstance(first, dict):
        return {k: easy_reduce([s[k] for s in scores], mode=mode, skip_nan=skip_nan) for k in first}

    if isinstance(first, (float, int, np.floating, np.integer)):
        if skip_nan:
            scores = [x for x in scores if not np.isnan(x)]
        if mode == "mean":
            return np.mean(scores)
        if mode == "max":
            return np.max(scores)
        if mode == "median":
            return np.median(scores)
        raise ValueError(f"Unknown reduce mode {mode!r}")

    raise TypeError("Unsupported data type %s" % type(first))

