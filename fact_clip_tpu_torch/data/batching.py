"""Bucketed, padded batch assembly (the port's copy of
``fact_clip_tpu/data/batching.py``).

Videos are padded to a small ladder of bucket lengths and stacked into dense
(B, L, D) arrays with frame masks; per-video transcripts and segment indices
are padded to a static segment cap.  The losses stay per video (masked), so a
batch is equivalent to the reference's one-video loop.  The last partial
training batch is completed with videos from the end of the shuffled order.
One process feeds one card: ``process_count > 1`` (multi-host data
parallelism) is not ported (ROADMAP M13).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .dataset import Dataset
from .io import load_feature

def make_bucket_lengths(max_len: int, multiple: int = 128, growth: float = 1.26) -> list:
    """Geometric ladder of padded lengths, each a multiple of ``multiple``."""
    buckets = []
    cur = multiple
    while cur < max_len:
        buckets.append(cur)
        nxt = int(np.ceil(cur * growth / multiple)) * multiple
        cur = max(nxt, cur + multiple)
    buckets.append(int(np.ceil(max_len / multiple)) * multiple)
    return buckets


def bucket_for(length: int, buckets: list) -> int:
    for b in buckets:
        if length <= b:
            return b
    raise ValueError(f"Length {length} exceeds largest bucket {buckets[-1]}")


@dataclasses.dataclass
class Batch:
    """One padded batch; array members are what ships to the device."""

    feats: np.ndarray       # (B, L, D) float32
    mask: np.ndarray        # (B, L) bool — valid frames
    labels: np.ndarray      # (B, L) int32 — train labels, 0 at padding
    seg_label: np.ndarray   # (B, L) int32 — GT segment index per frame
    transcript: np.ndarray  # (B, S) int32 — GT segment classes, 0 at padding
    seg_mask: np.ndarray    # (B, S) bool — valid GT segments
    lengths: np.ndarray     # (B,) int32
    vnames: list            # host-side
    eval_labels: list       # host-side full-rate labels for metrics

    @property
    def device_arrays(self) -> dict:
        return dict(
            feats=self.feats,
            mask=self.mask,
            labels=self.labels,
            seg_label=self.seg_label,
            transcript=self.transcript,
            seg_mask=self.seg_mask,
            lengths=self.lengths,
        )


class BatchAssembler:
    """Pads and stacks VideoItems into fixed-shape Batches."""

    def __init__(self, dataset: Dataset, seg_cap: int, buckets: list):
        self.dataset = dataset
        self.seg_cap = seg_cap
        self.buckets = buckets

    def assemble(self, vnames: list) -> Batch:
        items = [self.dataset[v] for v in vnames]
        B = len(items)
        D = self.dataset.input_dimension
        L = bucket_for(max(len(it.train_label) for it in items), self.buckets)
        S = self.seg_cap

        streaming = self.dataset.feature_source is not None
        feats = (self._stream_features(vnames, items, L, D) if streaming
                 else np.zeros((B, L, D), dtype=np.float32))
        mask = np.zeros((B, L), dtype=bool)
        labels = np.zeros((B, L), dtype=np.int32)
        seg_label = np.zeros((B, L), dtype=np.int32)
        transcript = np.zeros((B, S), dtype=np.int32)
        seg_mask = np.zeros((B, S), dtype=bool)
        lengths = np.zeros((B,), dtype=np.int32)
        eval_labels = []

        for i, it in enumerate(items):
            t = len(it.train_label)
            s = len(it.transcript)
            if s > S:
                raise ValueError(
                    f"Video {vnames[i]} has {s} GT segments > static cap {S}; "
                    f"raise cfg.TPU.max_gt_segs"
                )
            if not streaming:
                feats[i, :t] = it.feature[:t]
            mask[i, :t] = True
            labels[i, :t] = it.train_label
            seg_label[i, :t] = it.seg_label
            # padding frames keep the last valid segment id so downstream
            # gathers stay in-range; the frame mask removes their contribution
            if t < L:
                labels[i, t:] = it.train_label[-1]
                seg_label[i, t:] = it.seg_label[-1]
            transcript[i, :s] = it.transcript
            seg_mask[i, :s] = True
            lengths[i] = t
            eval_labels.append(it.eval_label)

        return Batch(feats, mask, labels, seg_label, transcript, seg_mask, lengths, list(vnames), eval_labels)

    def _stream_features(self, vnames, items, L, D):
        """Streaming mode: read this batch's features from disk."""
        src = self.dataset.feature_source
        feats = np.zeros((len(vnames), L, D), np.float32)
        for i, (v, it) in enumerate(zip(vnames, items)):
            t = len(it.train_label)
            f = load_feature(src["feature_path"], v, src["transpose"])
            f = f[:: src["sr"]] if src["sr"] > 1 else f
            feats[i, :t] = f[:t]
        return feats


class TrainLoader:
    """Shuffled, bucket-sorted epoch iterator with wrap-around tail batch.

    The shuffle draws from one ``default_rng(seed)`` made here, so that the
    n-th epoch of a loader is the n-th shuffle of that stream.
    """

    def __init__(self, dataset: Dataset, batch_size: int, assembler: BatchAssembler,
                 seed: int = 0, process_id: int = 0, process_count: int = 1):
        if process_count != 1 or process_id != 0:
            raise NotImplementedError(
                f"process_count {process_count}: the port loads for one process (ROADMAP M13)")
        self.dataset = dataset
        self.batch_size = batch_size
        self.assembler = assembler
        self._rng = np.random.default_rng(seed)
        self.videos = list(dataset.get_vnames())
        self.num_batch = int(np.ceil(len(self.videos) / batch_size))

    def __len__(self):
        return self.num_batch

    def __iter__(self):
        order = list(range(len(self.videos)))
        self._rng.shuffle(order)
        # group videos of similar length together (stable sort by bucket)
        # so batches pad to the same bucket; order within a bucket stays random
        lens = [len(self.dataset[self.videos[i]].train_label) for i in order]
        bucket_ids = [bucket_for(l, self.assembler.buckets) for l in lens]
        order = [o for _, o in sorted(zip(bucket_ids, order), key=lambda x: x[0])]

        batches = []
        for b in range(self.num_batch):
            idx = order[b * self.batch_size : (b + 1) * self.batch_size]
            if len(idx) < self.batch_size:
                # complete the tail batch from the *end* of the order: those
                # are same-bucket (longest) videos, so a short video never
                # gets dragged through the largest bucket's padded compute
                pool = order[-self.batch_size :]
                while len(idx) < self.batch_size:
                    idx = idx + pool[: self.batch_size - len(idx)]
            batches.append(idx)
        self._rng.shuffle(batches)

        for idx in batches:
            yield self.assembler.assemble([self.videos[i] for i in idx])


class EvalLoader:
    """Sequential iterator over the full dataset (no shuffling).

    Partial tail batches are padded by repeating the last video so every
    batch has a static shape; the results store is keyed by video name, so
    duplicate entries overwrite harmlessly (the reference's wrap-around
    loader relies on the same property).
    """

    def __init__(self, dataset: Dataset, batch_size: int, assembler: BatchAssembler):
        self.dataset = dataset
        self.batch_size = batch_size
        self.assembler = assembler
        self.videos = list(dataset.get_vnames())
        # group by bucket so eval batches are densely packed
        lens = [len(dataset[v].train_label) for v in self.videos]
        bids = [bucket_for(l, assembler.buckets) for l in lens]
        self.videos = [v for _, v in sorted(zip(bids, self.videos), key=lambda x: x[0])]
        self.num_batch = int(np.ceil(len(self.videos) / batch_size))

    def __len__(self):
        return self.num_batch

    def __iter__(self):
        for b in range(self.num_batch):
            vnames = self.videos[b * self.batch_size : (b + 1) * self.batch_size]
            if len(vnames) < self.batch_size:
                vnames = vnames + [vnames[-1]] * (self.batch_size - len(vnames))
            yield self.assembler.assemble(vnames)


def scan_dataset_caps(datasets: list, cfg) -> tuple:
    """Determine (bucket list, gt segment cap) from the data + config."""
    max_len, max_segs = 0, 0
    for ds in datasets:
        l, s = ds.max_stats()
        max_len = max(max_len, l)
        max_segs = max(max_segs, s)

    buckets = make_bucket_lengths(max_len, cfg.TPU.bucket_multiple, cfg.TPU.bucket_growth)

    seg_cap = cfg.TPU.max_gt_segs
    if seg_cap is None or seg_cap <= 0:
        seg_cap = max_segs
    elif seg_cap < max_segs:
        raise ValueError(f"cfg.TPU.max_gt_segs={seg_cap} < observed max segments {max_segs}")
    return buckets, int(seg_cap)
