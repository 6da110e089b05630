"""Host-side file IO for the dataset directory conventions (the port's copy
of ``fact_clip_tpu/data/io.py``): ``.npy`` feature arrays (optionally
transposed), ``mapping.txt`` (``idx label`` lines), ``groundTruth/<video>.txt``
per-frame label files (with CRLF / latin-1 fallbacks) and split bundle files.
Features are read with NumPy, the JAX package's path when its native reader
is not built.
"""

from __future__ import annotations

import os

import numpy as np


def load_feature(feature_dir: str, video: str, transpose: bool) -> np.ndarray:
    """Load a (T, D) float32 feature array for one video."""
    feature = np.load(os.path.join(feature_dir, video + ".npy"))
    if transpose:
        feature = feature.T
    if feature.dtype != np.float32:
        feature = feature.astype(np.float32)
    return feature


def npy_shape(path: str) -> tuple:
    """The shape in a ``.npy`` file's header, without reading its data."""
    with open(path, "rb") as f:
        version = np.lib.format.read_magic(f)
        shape, _, _ = np.lib.format._read_array_header(f, version)
    return shape


def load_action_mapping(map_fname: str, sep: str = " "):
    """Parse ``mapping.txt`` into (label2index, index2label)."""
    label2index, index2label = {}, {}
    with open(map_fname, "r") as f:
        for line in f.read().split("\n")[:-1]:
            tokens = line.split(sep)
            label = sep.join(tokens[1:])
            idx = int(tokens[0])
            label2index[label] = idx
            index2label[idx] = label
    return label2index, index2label


def read_groundtruth_lines(groundTruth_path: str, vname: str) -> list:
    """Read per-frame label strings with CRLF and latin-1 fallbacks."""
    with open(os.path.join(groundTruth_path, vname + ".txt"), "rb") as f:
        raw = f.read().replace(b"\r\n", b"\n")
    try:
        content = raw.decode("utf-8")
    except UnicodeDecodeError:
        content = raw.decode("latin-1")
    return content.split("\n")[:-1]


def read_split_list(split_fname: str) -> list:
    with open(split_fname, "r") as f:
        return f.read().split("\n")[0:-1]


def video_contains_holdout_classes(vname, groundTruth_path, label2index, holdout_classes) -> bool:
    """True if any frame of the video belongs to a holdout class; a video
    whose labels cannot be read counts as holding none, as in JAX."""
    try:
        lines = read_groundtruth_lines(groundTruth_path, vname)
    except (OSError, UnicodeDecodeError) as e:
        print(f"Warning: Could not read labels for video {vname}: {e}")
        return False
    holdout = set(holdout_classes)
    return any(line in label2index and label2index[line] in holdout for line in lines)
