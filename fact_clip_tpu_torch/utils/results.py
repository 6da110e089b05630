"""Results store: per-video predictions and the metric suite (the port's
copy of ``fact_clip_tpu/utils/results.py``).

``Checkpoint`` computes MoF (``Acc``, ``AccB``), ``Edit`` and F1@{10,25,50}
with the seen / unseen holdout splits, and saves and loads itself as a
gzipped pickle, as the JAX package's does; ``save_results`` wraps a batch's
predictions into ``Video`` records.
"""

from __future__ import annotations

import gzip
import json
import pickle
from collections import OrderedDict

import numpy as np

from .metrics import edit_score, f_score
from .reduce import easy_reduce
from .segments import expand_frame_label, parse_label


class Video:
    def __init__(self, vname="", **kwargs):
        self.vname = vname
        for k, v in kwargs.items():
            setattr(self, k, v)

    def __str__(self):
        return "< Video %s >" % self.vname

    def __repr__(self):
        return str(self)


class Checkpoint:
    """Accumulates per-video results and computes the metric suite."""

    def __init__(self, iteration, bg_class=(), eval_edit=True, holdout_classes=(), seen_classes=None):
        self.iteration = iteration
        self.videos = {}
        self.bg_class = list(bg_class)
        self.eval_edit = eval_edit
        self.holdout_classes = list(holdout_classes) if holdout_classes is not None else []
        self.seen_classes = list(seen_classes) if seen_classes is not None else []
        self.per_class_metrics = {}

    def add_videos(self, videos: list):
        for v in videos:
            self.videos[v.vname] = v

    @staticmethod
    def load(fname) -> "Checkpoint":
        with gzip.open(fname, "rb") as fp:
            return pickle.load(fp)

    def save(self, fname):
        self.fname = fname
        with gzip.open(fname, "wb") as fp:
            pickle.dump(self, fp)

    def __str__(self):
        return "< Checkpoint[%d] %d videos >" % (self.iteration, len(self.videos))

    def __repr__(self):
        return str(self)

    def average_losses(self):
        losses = [v.loss for v in self.videos.values()]
        self.loss = easy_reduce(losses, mode="mean")

    def _per_video_metrics(self, gt_label, pred_label):
        M = OrderedDict()
        if self.eval_edit:
            pred_segs = parse_label(pred_label)
            gt_segs = parse_label(gt_label)
            M["Edit"] = edit_score(pred_segs, gt_segs, bg_class=self.bg_class)
        return M

    def _joint_metrics(self, gt_list, pred_list):
        M = OrderedDict()

        gt_ = np.concatenate(gt_list)
        pred_ = np.concatenate(pred_list)

        correct = gt_ == pred_
        fg_loc = ~np.isin(gt_, list(self.bg_class)) if self.bg_class else np.ones_like(correct, dtype=bool)
        M["AccB"] = correct.mean() * 100  # accuracy including background frames
        M["Acc"] = correct[fg_loc].mean() * 100  # accuracy excluding background

        overlap = [0.1, 0.25, 0.5]
        tp, fp, fn = np.zeros(3), np.zeros(3), np.zeros(3)
        seg_cache = [(parse_label(gt), parse_label(pred)) for gt, pred in zip(gt_list, pred_list)]
        for gt_segs, pred_segs in seg_cache:
            for s, ov in enumerate(overlap):
                tp1, fp1, fn1 = f_score(pred_segs, gt_segs, ov, bg_class=self.bg_class)
                tp[s] += tp1
                fp[s] += fp1
                fn[s] += fn1

        for s, ov in enumerate(overlap):
            precision = tp[s] / float(tp[s] + fp[s] + 1e-5)
            recall = tp[s] / float(tp[s] + fn[s] + 1e-5)
            f1 = 2.0 * (precision * recall) / (precision + recall + 1e-5)
            M["F1@%0.2f" % ov] = np.nan_to_num(f1) * 100

        # per-class accuracy
        for cls in np.unique(gt_):
            cls_mask = gt_ == cls
            if cls_mask.sum() > 0:
                c = correct[cls_mask].sum()
                t = cls_mask.sum()
                self.per_class_metrics[int(cls)] = {
                    "correct": int(c),
                    "total": int(t),
                    "accuracy": float(c / t * 100),
                }

        # holdout: separate metric groups for seen / unseen classes
        if len(self.holdout_classes) > 0:
            seen_mask = np.isin(gt_, self.seen_classes)
            if seen_mask.sum() > 0:
                M["Acc-seen"] = correct[seen_mask].mean() * 100
                seen_fg = seen_mask & fg_loc
                if seen_fg.sum() > 0:
                    M["AccFG-seen"] = correct[seen_fg].mean() * 100

            unseen_mask = np.isin(gt_, self.holdout_classes)
            if unseen_mask.sum() > 0:
                M["Acc-unseen"] = correct[unseen_mask].mean() * 100
                unseen_fg = unseen_mask & fg_loc
                if unseen_fg.sum() > 0:
                    M["AccFG-unseen"] = correct[unseen_fg].mean() * 100

            for class_type, class_list in (("seen", self.seen_classes), ("unseen", self.holdout_classes)):
                tp_c, fp_c, fn_c = np.zeros(3), np.zeros(3), np.zeros(3)
                for gt_segs_all, pred_segs_all in seg_cache:
                    gt_segs = [s for s in gt_segs_all if s.action in class_list]
                    pred_segs = [s for s in pred_segs_all if s.action in class_list]
                    if len(gt_segs) > 0:
                        for s, ov in enumerate(overlap):
                            tp1, fp1, fn1 = f_score(pred_segs, gt_segs, ov, bg_class=self.bg_class)
                            tp_c[s] += tp1
                            fp_c[s] += fp1
                            fn_c[s] += fn1
                for s, ov in enumerate(overlap):
                    if tp_c[s] + fp_c[s] + fn_c[s] > 0:
                        precision = tp_c[s] / float(tp_c[s] + fp_c[s] + 1e-5)
                        recall = tp_c[s] / float(tp_c[s] + fn_c[s] + 1e-5)
                        f1 = 2.0 * (precision * recall) / (precision + recall + 1e-5)
                        M[f"F1@{ov:.2f}-{class_type}"] = np.nan_to_num(f1) * 100

        return M

    def compute_metrics(self):
        gt_list, pred_list = [], []
        for vname, video in self.videos.items():
            video.pred_label = expand_frame_label(video.pred, len(video.gt_label))
            video.metrics = self._per_video_metrics(video.gt_label, video.pred_label)
            gt_list.append(video.gt_label)
            pred_list.append(video.pred_label)

        metrics = [video.metrics for video in self.videos.values()]
        self.metrics = easy_reduce(metrics, skip_nan=True)
        self.metrics.update(self._joint_metrics(gt_list, pred_list))
        return self.metrics

    def save_detailed_results(self, fname):
        """Detailed per-class and per-video JSON report (same layout as ref)."""
        results = {
            "iteration": self.iteration,
            "metrics": {k: float(v) for k, v in dict(self.metrics).items()},
            "per_class_metrics": self.per_class_metrics,
            "holdout_classes": self.holdout_classes,
            "seen_classes": self.seen_classes,
            "per_video_results": {},
        }
        for vname, video in self.videos.items():
            results["per_video_results"][vname] = {
                "gt_label": _to_list(video.gt_label),
                "pred_label": _to_list(video.pred_label),
                "metrics": {k: float(v) for k, v in video.metrics.items()} if hasattr(video, "metrics") else {},
            }
        with open(fname, "w") as f:
            json.dump(results, f, indent=2)
        print(f"Detailed results saved to: {fname}")


def _to_list(x):
    if hasattr(x, "tolist"):
        return x.tolist()
    return list(x)


def save_results(ckpt: Checkpoint, vnames: list, label_list: list, attrs_saves: list) -> list:
    """Wrap raw predictions into Video objects and add them to ``ckpt``."""
    videos = []
    for i in range(len(vnames)):
        video = Video(vnames[i], gt_label=np.asarray(label_list[i]), **attrs_saves[i])
        videos.append(video)
    ckpt.add_videos(videos)
    return videos
