"""Serving: bucketed, padded batches of variable-length videos.

Counterpart of ``fact_clip_tpu/engine/export.py:189-260``
(``ServingModel.predict``), on the bucket ladder of the port's
``data/batching.py::make_bucket_lengths``.  A model in transcript mode
serves with each video's transcript, padded to the predictor's
``seg_cap`` (export.py:73-76, :246-254).
"""

from __future__ import annotations

import numpy as np
import torch

from ..data.batching import make_bucket_lengths
from .steps import make_eval_step


class Predictor:
    """``predict(feats_list)`` buckets the requests by length, pads each
    group to ``batch_size`` by repeating its last video, runs the eval step
    and trims every prediction to its video's length.  ``model`` is a FACT
    (class ids), a VerbNounFACT (composed action ids in [0, n_act)) or a
    FACT_CLIP with its ``clip_bundle`` (class ids of the zero-shot decode
    over every class's text embedding; ``engine/export.py:139, 159-166`` of
    the JAX package).  A model in transcript mode (``FACT.trans``) needs
    ``seg_cap``, the token count it serves at (the longest transcript it
    takes), and returns ids out of each request's transcript.  A model in
    mixed precision (its blocks' ``dtype`` bfloat16) takes its requests in
    bf16 (cast on the host: half the copy; its in map casts them anyway)."""

    def __init__(self, model, mwt: float, batch_size: int = 8, max_len: int = 3072,
                 bucket_multiple: int = 128, bucket_growth: float = 1.26, device=None,
                 clip_bundle=None, seg_cap: int | None = None):
        if model.trans and not seg_cap:
            raise ValueError("a model in transcript mode serves at a seg_cap: pass seg_cap=")
        self.model, self.seg_cap = model, seg_cap
        self.step = make_eval_step(model, mwt, clip_bundle)
        self.batch_size = batch_size
        self.buckets = make_bucket_lengths(max_len, bucket_multiple, bucket_growth)
        self.device = torch.device(device) if device is not None else next(
            model.parameters()).device
        self.feats_dtype = (torch.bfloat16 if any(c.dtype == "bfloat16" for c in model.block_cfgs)
                            else torch.float32)

    def bucket_for(self, length: int) -> int:
        for b in self.buckets:
            if length <= b:
                return b
        raise ValueError(f"length {length} exceeds the largest bucket {self.buckets[-1]}")

    def predict(self, feats_list, transcripts=None) -> list:
        """feats_list: (T_i, D) float arrays -> list of (T_i,) int32 predictions.
        ``transcripts`` (a sequence of (n_i,) int arrays, n_i <= seg_cap) is
        required exactly when the model is in transcript mode."""
        if self.model.trans != (transcripts is not None):
            raise ValueError("transcripts= is required exactly when the model is in "
                             "transcript mode")
        n = len(feats_list)
        order = sorted(range(n), key=lambda i: self.bucket_for(len(feats_list[i])))
        out = [None] * n
        B, D = self.batch_size, self.model.in_dim
        i = 0
        while i < n:
            bucket = self.bucket_for(len(feats_list[order[i]]))
            idx = [order[i]]
            while (len(idx) < B and i + len(idx) < n
                   and self.bucket_for(len(feats_list[order[i + len(idx)]])) == bucket):
                idx.append(order[i + len(idx)])
            i += len(idx)
            # pad on the device: each request crosses to it once, unpadded,
            # and the repeats of the last video are copied there
            feats = torch.zeros((B, bucket, D), dtype=self.feats_dtype, device=self.device)
            lengths = np.zeros((B,), np.int32)
            for r, j in enumerate(idx):
                f = torch.from_numpy(np.asarray(feats_list[j], np.float32)).to(self.feats_dtype)
                feats[r, : len(f)].copy_(f)
                lengths[r] = len(f)
            feats[len(idx):] = feats[len(idx) - 1]
            lengths[len(idx):] = lengths[len(idx) - 1]
            mask = np.arange(bucket)[None, :] < lengths[:, None]
            extra = {}
            if transcripts is not None:
                extra = {k: torch.from_numpy(v).to(self.device) for k, v in zip(
                    ("transcript", "seg_mask"),
                    self._pad_transcripts([transcripts[j] for j in idx], B))}
            pred = self.step(feats, torch.from_numpy(mask).to(self.device),
                             torch.from_numpy(lengths).to(self.device), **extra).cpu().numpy()
            for r, j in enumerate(idx):
                out[j] = pred[r, : lengths[r]].astype(np.int32)
        return out

    def _pad_transcripts(self, transcripts, B: int):
        """(B, seg_cap) int32 transcripts and their bool seg_mask, the rows past
        the requests repeating the last one (as the features do)."""
        S = self.seg_cap
        tr, sm = np.zeros((B, S), np.int32), np.zeros((B, S), bool)
        for r in range(B):
            t = np.asarray(transcripts[min(r, len(transcripts) - 1)], np.int32).reshape(-1)
            if not 0 < len(t) <= S:
                raise ValueError(f"a transcript of {len(t)} entries: the predictor serves "
                                 f"1 to seg_cap = {S}")
            tr[r, :len(t)], sm[r, :len(t)] = t, True
        return tr, sm
