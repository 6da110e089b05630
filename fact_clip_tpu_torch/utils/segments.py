"""Host-side segment and frame-label utilities (the port's copy of
``fact_clip_tpu/utils/segments.py``): ``Segment``, ``parse_label``,
``expand_frame_label``, ``shrink_frame_label`` and
``class_label_to_segment_data``, NumPy only.
"""

from __future__ import annotations

from collections import Counter

import numpy as np


class Segment:
    """A contiguous run of one action label: [start, end] inclusive."""

    __slots__ = ("action", "start", "end", "len")

    def __init__(self, action, start, end):
        assert start >= 0
        self.action = action
        self.start = start
        self.end = end
        self.len = end - start + 1

    def __repr__(self):
        return "<%r %d-%d>" % (self.action, self.start, self.end)

    def intersect(self, other: "Segment") -> int:
        s = max(self.start, other.start)
        e = min(self.end, other.end)
        return max(0, e - s + 1)

    def union(self, other: "Segment") -> int:
        s = min(self.start, other.start)
        e = max(self.end, other.end)
        return e - s + 1


def parse_label(label) -> list:
    """Run-length decode a frame-label array into a list of Segments."""
    if not isinstance(label, np.ndarray):
        label = np.array(label)

    change = np.where(label[:-1] != label[1:])[0]
    if len(change) == 0:
        return [Segment(label[0], 0, len(label) - 1)]

    segs = []
    start = 0
    for c in change:
        segs.append(Segment(label[start], start, int(c)))
        start = int(c) + 1
    segs.append(Segment(label[start], start, len(label) - 1))
    return segs


def expand_frame_label(label, target_len: int):
    """Nearest-neighbor re-expansion of a downsampled label sequence.

    Matches torch ``F.interpolate(mode="nearest")`` used by the reference
    (utils.py:52-72): output[i] = input[floor(i * len(input) / target_len)].
    """
    if len(label) == target_len:
        return label

    label = np.asarray(label)
    src_len = len(label)
    idx = np.floor(np.arange(target_len) * (src_len / target_len)).astype(np.int64)
    idx = np.clip(idx, 0, src_len - 1)
    return label[idx].astype(np.int64)


def shrink_frame_label(label: list, clip_len: int) -> list:
    """Majority-vote downsampling of a frame-label sequence by ``clip_len``."""
    num_clip = ((len(label) - 1) // clip_len) + 1
    new_label = []
    for i in range(num_clip):
        s = i * clip_len
        counts = Counter(label[s : s + clip_len])
        new_label.append(counts.most_common()[0][0])
    return new_label


def class_label_to_segment_data(label: np.ndarray):
    """Transcript and per-frame segment index from a frame-label array.

    Equivalent to the reference's ``torch_class_label_to_segment_label``, vectorized:
    returns (transcript, segment_label) where transcript[k] is the class of
    the k-th segment and segment_label[t] is the segment index of frame t.
    """
    label = np.asarray(label)
    change = np.concatenate([[False], label[1:] != label[:-1]])
    segment_label = np.cumsum(change).astype(np.int64)
    starts = np.concatenate([[0], np.where(change)[0]])
    transcript = label[starts].astype(np.int64)
    return transcript, segment_label
