"""Segmentation metrics (the port's copy of ``fact_clip_tpu/utils/metrics.py``):
the Edit score (a row-vectorized Levenshtein distance) and segmental F1@k.
"""

from __future__ import annotations

import numpy as np

from .segments import Segment  # noqa: F401  (re-exported for convenience)


def levenstein(p, y, norm: bool = False) -> float:
    """Edit distance between label sequences ``p`` and ``y``."""
    m_row = len(p)
    n_col = len(y)
    if m_row == 0 or n_col == 0:
        d = float(max(m_row, n_col))
        if norm:
            return (1 - d / max(m_row, n_col, 1)) * 100
        return d

    p = np.asarray(p)
    y = np.asarray(y)
    js = np.arange(n_col, dtype=np.float64)
    prev = np.arange(n_col + 1, dtype=np.float64)
    for i in range(1, m_row + 1):
        sub = prev[:-1] + (y != p[i - 1])
        # deletion and substitution/match candidates from the previous row
        cand = np.minimum(prev[1:] + 1, sub)
        # insertion transitions propagate along the row; closed form:
        # cur[j+1] = min(i + j + 1, j + min_{k<=j}(cand[k] - k))
        g = np.minimum.accumulate(cand - js)
        cur = np.empty(n_col + 1, dtype=np.float64)
        cur[0] = i
        cur[1:] = np.minimum(i + js + 1, js + g)
        prev = cur

    if norm:
        return (1 - prev[-1] / max(m_row, n_col)) * 100
    return float(prev[-1])


def segs_to_labels_start_end_time(seg_list, bg_class):
    seg_list = [s for s in seg_list if s.action not in bg_class]
    labels = [s.action for s in seg_list]
    start = [s.start for s in seg_list]
    end = [s.end + 1 for s in seg_list]
    return labels, start, end


def edit_score(pred_segs, gt_segs, norm: bool = True, bg_class=("background",)) -> float:
    P, _, _ = segs_to_labels_start_end_time(pred_segs, bg_class)
    Y, _, _ = segs_to_labels_start_end_time(gt_segs, bg_class)
    return levenstein(P, Y, norm)


def f_score(pred_segs, gt_segs, overlap: float, bg_class=("background",)):
    """Greedy IoU matching of predicted to GT segments -> (tp, fp, fn)."""
    p_label, p_start, p_end = segs_to_labels_start_end_time(pred_segs, bg_class)
    y_label, y_start, y_end = segs_to_labels_start_end_time(gt_segs, bg_class)

    if len(y_label) == 0:
        return 0.0, float(len(p_label)), 0.0
    if len(p_label) == 0:
        return 0.0, 0.0, float(len(y_label))

    y_start = np.asarray(y_start)
    y_end = np.asarray(y_end)
    y_label_arr = np.asarray(y_label)

    tp = 0
    fp = 0
    hits = np.zeros(len(y_label))
    for j in range(len(p_label)):
        intersection = np.minimum(p_end[j], y_end) - np.maximum(p_start[j], y_start)
        union = np.maximum(p_end[j], y_end) - np.minimum(p_start[j], y_start)
        iou = (1.0 * intersection / union) * (y_label_arr == p_label[j])
        idx = int(np.argmax(iou))
        if iou[idx] >= overlap and not hits[idx]:
            tp += 1
            hits[idx] = 1
        else:
            fp += 1

    fn = len(y_label) - hits.sum()
    return float(tp), float(fp), float(fn)
