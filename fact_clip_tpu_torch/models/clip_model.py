"""FACT_CLIP: open-vocabulary FACT with a CLIP text-embedding head (the
port's counterpart of ``fact_clip_tpu/models/clip_model.py``).

The vanilla FACT stack plus a ``FeatureProjection`` that maps the last
block's raw frame feature (its class-probability dims stripped) into the
text embeddings' space.  ``FACTCLIP`` is a ``FACT`` with one more submodule,
so its ``state_dict`` holds FACT's keys unprefixed plus
``frame_projection.projection.{0,1,4}.*``: the reference's layout, which the
JAX package's exporter writes and its importer reads.  The frozen text
embeddings are not parameters: they travel in the clip bundle
(``engine/setup.py::build_clip_bundle``) to the steps.
"""

from __future__ import annotations

import torch

from .blocks import FACT, fact_args, place_model
from .layers import FeatureProjection


class FACTCLIP(FACT):
    """forward returns (per-block saves, the frame embedding (B, T, clip_dim),
    L2-normalised)."""

    def __init__(self, block_cfgs, in_dim: int, n_classes: int, ntoken: int, fpos: bool,
                 s_pred_cap: int, cmr: float = 0.0, tm: dict | None = None, trans: bool = False,
                 clip_dim: int = 512, projection_hidden_dim: int = 512,
                 projection_dropout: float = 0.1):
        super().__init__(block_cfgs, in_dim, n_classes, ntoken, fpos, s_pred_cap, cmr, tm,
                         trans)
        self.clip_dim = clip_dim
        raw_dim = self.block_cfgs[-1].hid_dim - n_classes
        self.frame_projection = FeatureProjection(raw_dim, clip_dim, projection_hidden_dim,
                                                  projection_dropout)

    def forward(self, feats, mask, lengths, train: bool = False, generator=None,
                transcript=None, seg_mask=None):
        saves_list, frame_feature = super().forward(feats, mask, lengths, train=train,
                                                    generator=generator, transcript=transcript,
                                                    seg_mask=seg_mask)
        raw = frame_feature[..., : frame_feature.shape[-1] - self.n_classes]
        return saves_list, self.frame_projection(raw, generator)


def build_fact_clip(cfg: dict, in_dim: int, n_classes: int, s_pred_cap: int,
                    clip_dim: int = 512, *, device=None,
                    generator: torch.Generator | None = None) -> FACTCLIP:
    """FACT_CLIP of ``cfg`` (its ``CLIP`` section sizes the projection), on
    ``device`` (the CUDA card when None; it raises without one), initialised
    from ``generator`` (a CPU torch.Generator; seed 0 if None)."""
    clip = cfg["CLIP"]
    return place_model(
        lambda: FACTCLIP(*fact_args(cfg, in_dim, n_classes, s_pred_cap), clip_dim=clip_dim,
                         projection_hidden_dim=clip["projection_hidden_dim"],
                         projection_dropout=clip["projection_dropout"]),
        "build_fact_clip", device, generator)
