"""The dataset registry and the lazy per-video cache (the port's copy of
``fact_clip_tpu/data/dataset.py``).

The same per-dataset path conventions (breakfast, gtea, ego, epic, havid_*),
sr downsampling with the majority-vote label shrink for the train labels
while the eval labels keep the full rate, the feature / label length-mismatch
truncation, debug mode (training on the test split) and holdout video
filtering.  Each loaded video also carries its transcript and per-frame
segment index, so that the train step never computes them.  Features and
headers are read with NumPy (``TPU.cache_features: false`` reads them per
batch, ``data/batching.py``).
"""

from __future__ import annotations

import os

import numpy as np

from ..home import get_project_base
from ..utils.segments import class_label_to_segment_data, shrink_frame_label
from .io import (
    load_action_mapping,
    load_feature,
    npy_shape,
    read_groundtruth_lines,
    read_split_list,
    video_contains_holdout_classes,
)

BASE = get_project_base()

class VideoItem:
    """All host-side artifacts for one video.

    ``feature`` is None in streaming mode (cfg.TPU.cache_features=false):
    labels stay resident, features are read per batch by the assembler
    (data/batching.py) instead of living in the cache.
    """

    __slots__ = ("feature", "train_label", "eval_label", "transcript", "seg_label")

    def __init__(self, feature, train_label, eval_label):
        self.feature = feature
        self.train_label = np.asarray(train_label, dtype=np.int64)
        self.eval_label = np.asarray(eval_label, dtype=np.int64)
        self.transcript, self.seg_label = class_label_to_segment_data(self.train_label)


class Dataset:
    """Lazy per-video cache keyed by video name.

    ``feature_source`` (set in streaming mode) describes how to read features
    per batch: dict(feature_path, transpose, sr, input_dimension).
    """

    def __init__(self, video_list, nclasses, load_video_func, bg_class, feature_source=None):
        self.video_list = video_list
        self.load_video = load_video_func
        self.nclasses = nclasses
        self.bg_class = bg_class
        self.feature_source = feature_source
        self.data = {}
        first = self[video_list[0]]
        if feature_source is not None:
            self.input_dimension = feature_source["input_dimension"]
        else:
            self.input_dimension = first.feature.shape[1]
        # attributes attached by create_dataset
        self.average_transcript_len = 0.0
        self.label2index = {}
        self.index2label = {}
        self.holdout_classes = []
        self.seen_classes = []

    def __str__(self):
        return "< Dataset %d videos, %d feat-size, %d classes >" % (
            len(self.video_list),
            self.input_dimension,
            self.nclasses,
        )

    def __repr__(self):
        return str(self)

    def get_vnames(self):
        return self.video_list[:]

    def __getitem__(self, video) -> VideoItem:
        if video not in self.video_list:
            raise ValueError(video)
        if video not in self.data:
            self.data[video] = self.load_video(video)
        return self.data[video]

    def __len__(self):
        return len(self.video_list)

    def max_stats(self):
        """(max_train_len, max_gt_segments) over all videos (loads them all)."""
        max_len, max_segs = 0, 0
        for v in self.video_list:
            item = self[v]
            max_len = max(max_len, len(item.train_label))
            max_segs = max(max_segs, len(item.transcript))
        return max_len, max_segs


def _registry_paths(cfg):
    """Per-dataset directory conventions."""
    if cfg.dataset == "breakfast":
        root = BASE + "data/breakfast/"
        return dict(
            map_fname=root + "mapping.txt",
            groundTruth_path=root + "groundTruth",
            feature_path=root + "features",
            train_split=root + f"splits/train.{cfg.split}.bundle",
            test_split=root + f"splits/test.{cfg.split}.bundle",
            feature_transpose=True,
            average_transcript_len=6.9,
            bg_class=[0],
        )
    if cfg.dataset == "gtea":
        root = BASE + "data/gtea/"
        return dict(
            map_fname=root + "mapping.txt",
            groundTruth_path=root + "groundTruth",
            feature_path=root + "features/",
            train_split=root + f"splits/train.{cfg.split}.bundle",
            test_split=root + f"splits/test.{cfg.split}.bundle",
            feature_transpose=True,
            average_transcript_len=32.9,
            bg_class=[10],
        )
    if cfg.dataset == "ego":
        root = BASE + "data/egoprocel/"
        return dict(
            map_fname=root + "mapping.txt",
            groundTruth_path=root + "groundTruth",
            feature_path=root + "features/",
            train_split=root + ("%s.train" % cfg.split),
            test_split=root + ("%s.test" % cfg.split),
            feature_transpose=False,
            average_transcript_len=(21.5 if cfg.Loss.match == "o2o" else 7.4),
            bg_class=[0],
        )
    if cfg.dataset == "epic":
        root = BASE + "data/epic-kitchens/processed/"
        return dict(
            map_fname=root + "mapping.txt",
            groundTruth_path=root + "groundTruth",
            feature_path=root + "features",
            train_split=root + ("%s.train" % cfg.split),
            test_split=root + ("%s.test" % cfg.split),
            feature_transpose=False,
            average_transcript_len=(165 if cfg.Loss.match == "o2o" else 52),
            bg_class=[0],
        )
    if cfg.dataset.startswith("havid"):
        variant = cfg.dataset.replace("havid_", "")
        havid_base = BASE + "data/HAViD/ActionSegmentation/data"
        root = f"{havid_base}/{variant}/"
        if variant.endswith("_pt"):
            atl = 8.0
        elif variant.endswith("_aa"):
            atl = 15.0
        else:
            atl = 10.0
        return dict(
            map_fname=f"{root}mapping.txt",
            groundTruth_path=root + "groundTruth",
            feature_path=f"{havid_base}/features",
            train_split=f"{root}splits/train.{cfg.split}.bundle",
            test_split=f"{root}splits/test.{cfg.split}.bundle",
            feature_transpose=True,  # HAViD features are (D, T)
            average_transcript_len=atl,
            bg_class=[0],
        )
    raise ValueError(f"Unknown dataset {cfg.dataset!r}")


def _apply_cfg_overrides(paths: dict, cfg) -> dict:
    """Explicit cfg paths override the registry."""
    if cfg.feature_path:
        paths["feature_path"] = cfg.feature_path
    if cfg.groundTruth_path:
        paths["groundTruth_path"] = cfg.groundTruth_path
    if cfg.map_fname:
        paths["map_fname"] = cfg.map_fname
    if cfg.split_path:
        if cfg.dataset in ("epic", "ego"):
            paths["train_split"] = os.path.join(cfg.split_path, f"{cfg.split}.train")
            paths["test_split"] = os.path.join(cfg.split_path, f"{cfg.split}.test")
        else:
            paths["train_split"] = os.path.join(cfg.split_path, f"train.{cfg.split}.bundle")
            paths["test_split"] = os.path.join(cfg.split_path, f"test.{cfg.split}.bundle")
    if cfg.bg_class is not None:
        bg = cfg.bg_class
        paths["bg_class"] = list(bg) if isinstance(bg, (list, tuple)) else [bg]
    if cfg.feature_transpose:
        paths["feature_transpose"] = True
    if cfg.average_transcript_len:
        paths["average_transcript_len"] = cfg.average_transcript_len
    return paths


def _clean_video_names(video_list, dataset_name):
    if dataset_name in ["breakfast", "50salads", "gtea"]:
        return [v[:-4] for v in video_list]
    if dataset_name.startswith("havid"):
        return [v[:-4] for v in video_list if v.endswith(".txt")]
    return video_list


def create_dataset(cfg):
    """Build (train_dataset, test_dataset) from the config."""
    paths = _apply_cfg_overrides(_registry_paths(cfg), cfg)
    groundTruth_path = paths["groundTruth_path"]
    feature_path = paths["feature_path"]
    bg_class = paths["bg_class"]

    print("Loading Feature from", feature_path)
    print("Loading Label from", groundTruth_path)

    label2index, index2label = load_action_mapping(paths["map_fname"])
    nclasses = len(label2index)

    sr = cfg.sr
    cache_features = bool(cfg.TPU.cache_features) if "TPU" in cfg else True

    def _feature_rows(vname) -> int:
        """Frame count of the feature file from its npy header only."""
        shape = npy_shape(os.path.join(feature_path, vname + ".npy"))
        return shape[1] if paths["feature_transpose"] else shape[0]

    def load_video(vname) -> VideoItem:
        gt_label = [label2index[line] for line in read_groundtruth_lines(groundTruth_path, vname)]

        if cache_features:
            feature = load_feature(feature_path, vname, paths["feature_transpose"])
            if feature.shape[0] != len(gt_label):
                l = min(feature.shape[0], len(gt_label))
                feature = feature[:l]
                gt_label = gt_label[:l]
            if sr > 1:
                feature = feature[::sr]
                train_label = shrink_frame_label(gt_label, sr)
            else:
                train_label = gt_label
            return VideoItem(feature, train_label, gt_label)

        # streaming: labels only; features are batch-loaded by the assembler
        t_feat = _feature_rows(vname)
        l = min(t_feat, len(gt_label))
        gt_label = gt_label[:l]
        train_label = shrink_frame_label(gt_label, sr) if sr > 1 else gt_label
        return VideoItem(None, train_label, gt_label)

    def _feature_dim(vname) -> int:
        shape = npy_shape(os.path.join(feature_path, vname + ".npy"))
        return shape[0] if paths["feature_transpose"] else shape[1]

    test_video_list = _clean_video_names(read_split_list(paths["test_split"]), cfg.dataset)

    feature_source = None
    if not cache_features:
        feature_source = dict(
            feature_path=feature_path,
            transpose=bool(paths["feature_transpose"]),
            sr=sr,
            input_dimension=_feature_dim(test_video_list[0]),
        )

    test_dataset = Dataset(test_video_list, nclasses, load_video, bg_class,
                           feature_source=feature_source)

    if cfg.aux.debug:
        dataset = test_dataset
    else:
        video_list = _clean_video_names(read_split_list(paths["train_split"]), cfg.dataset)

        if cfg.holdout_mode and len(cfg.holdout_classes) > 0:
            original_count = len(video_list)
            holdout_classes = list(cfg.holdout_classes)
            print(f"HOLDOUT MODE: holding out classes {holdout_classes} "
                  f"({[index2label[c] for c in holdout_classes if c in index2label]})")
            video_list = [
                v for v in video_list
                if not video_contains_holdout_classes(v, groundTruth_path, label2index, holdout_classes)
            ]
            print(f"Training videos after holdout filtering: {len(video_list)}/{original_count}")
            if len(video_list) == 0:
                raise ValueError("No training videos remaining after holdout filtering!")

        dataset = Dataset(video_list, nclasses, load_video, bg_class,
                          feature_source=feature_source)

    for ds in (dataset, test_dataset):
        ds.average_transcript_len = paths["average_transcript_len"]
        ds.label2index = label2index
        ds.index2label = index2label
        if cfg.holdout_mode and len(cfg.holdout_classes) > 0:
            ds.holdout_classes = list(cfg.holdout_classes)
            ds.seen_classes = [c for c in range(nclasses) if c not in ds.holdout_classes]
        else:
            ds.holdout_classes = []
            ds.seen_classes = list(range(nclasses))

    return dataset, test_dataset
