"""Experiment assembly for the train and eval entry points (the port's
counterpart of ``fact_clip_tpu/engine/setup.py``).

Builds the datasets, the length buckets and segment caps, the model (FACT,
FACT_CLIP for ``use_clip``, or the verb/noun model for ``dataset: epic``)
with weights initialised from ``aux.seed``, the class weights and, for
FACT_CLIP given text embeddings, the clip bundle: the part of training that
precedes the loop.  In transcript mode (``FACT.trans``) the model has no
token count of its own: it takes as many tokens as the batches' segment cap
(``TPU.max_gt_segs``, or the longest transcript of the data), which the
assemblers pad every transcript to.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..data.batching import BatchAssembler, EvalLoader, TrainLoader, scan_dataset_caps
from ..data.dataset import create_dataset
from ..home import get_project_base
from ..models import losses as losses_mod
from ..models.blocks import build_fact
from ..models.clip_model import build_fact_clip
from ..models.verbnoun import build_verbnoun_fact, load_vids_nids


@dataclasses.dataclass
class Experiment:
    cfg: object
    dataset: object
    test_dataset: object
    buckets: list
    seg_cap: int
    s_pred_cap: int
    model: torch.nn.Module
    cweight: np.ndarray
    assembler: BatchAssembler
    test_assembler: BatchAssembler
    clip_bundle: dict | None = None

    def train_loader(self, seed=0):
        return TrainLoader(self.dataset, self.cfg.batch_size, self.assembler, seed=seed)

    def test_loader(self):
        return EvalLoader(self.test_dataset, self.cfg.batch_size, self.test_assembler)


def auto_pred_seg_cap(cfg, seg_cap: int, max_len: int) -> int:
    cap = cfg.TPU.max_pred_segs
    if cap is None or cap <= 0:
        cap = max(2 * seg_cap, 64)
        cap = int(np.ceil(cap / 32)) * 32
    return int(min(cap, max_len))


def build_clip_bundle(cfg, text_embeddings: np.ndarray, holdout_classes, device="cpu") -> dict:
    """FACT_CLIP's bundle (``fact_clip_tpu/engine/setup.py:55``): all-class
    embeddings (decode), the seen classes' (the training loss), the global ->
    seen ``label_map`` with -1 at held-out classes, as tensors on ``device``,
    and the temperature and loss weights."""
    n = text_embeddings.shape[0]
    holdout = set(holdout_classes or [])
    seen = np.array([i for i in range(n) if i not in holdout], np.int64)
    label_map = np.full((n,), -1, np.int64)
    label_map[seen] = np.arange(len(seen))
    emb = np.asarray(text_embeddings, np.float32)
    return {
        "text_emb": torch.as_tensor(emb, device=device),
        "seen_text_emb": torch.as_tensor(emb[seen], device=device),
        "label_map": torch.as_tensor(label_map, device=device),
        "temp": float(cfg["CLIP"]["temp"]),
        "fact_w": float(cfg["CLIP"]["fact_loss_weight"]),
        "cont_w": float(cfg["CLIP"]["contrastive_weight"]),
    }


def build_experiment(cfg, device, seed: int = 0, text_embeddings=None) -> Experiment:
    """The experiment of ``cfg`` with its model on ``device`` (as
    ``resolve_device`` takes it), initialised from
    ``torch.Generator().manual_seed(seed)``.  With ``use_clip`` the model is
    FACT_CLIP, its projection as wide as ``text_embeddings`` (n_classes, E)
    (512 without them); the clip bundle is built only when they are given:
    without them FACT_CLIP trains and decodes as FACT, as in JAX."""
    device = resolve_device(device)
    dataset, test_dataset = create_dataset(cfg)
    buckets, seg_cap = scan_dataset_caps([dataset, test_dataset], cfg)
    s_pred_cap = auto_pred_seg_cap(cfg, seg_cap, buckets[-1])

    if cfg.Loss.nullw == -1:
        losses_mod.compute_null_weight(cfg, dataset)

    clip_bundle = None
    if cfg.use_clip and text_embeddings is not None:
        holdout = cfg.holdout_classes if cfg.holdout_mode else []
        clip_bundle = build_clip_bundle(cfg, text_embeddings, holdout, device)

    generator = torch.Generator().manual_seed(int(seed))
    if cfg.use_clip:
        clip_dim = int(text_embeddings.shape[1]) if text_embeddings is not None else 512
        model = build_fact_clip(cfg, dataset.input_dimension, dataset.nclasses, s_pred_cap,
                                clip_dim, device=device, generator=generator)
    elif cfg.dataset == "epic":
        processed_dir = (os.path.dirname(cfg.map_fname) if cfg.map_fname
                         else get_project_base() + "data/epic-kitchens/processed")
        vids, nids = load_vids_nids(processed_dir)
        model = build_verbnoun_fact(cfg, dataset.input_dimension, vids, nids, s_pred_cap,
                                    n_classes1=int(vids.max()) + 1,
                                    n_classes2=int(nids.max()) + 1,
                                    device=device, generator=generator)
    else:
        model = build_fact(cfg, dataset.input_dimension, dataset.nclasses, s_pred_cap,
                           device=device, generator=generator)

    cweight = losses_mod.build_class_weights(cfg, dataset.nclasses, dataset.bg_class)
    return Experiment(
        cfg=cfg, dataset=dataset, test_dataset=test_dataset, buckets=buckets,
        seg_cap=seg_cap, s_pred_cap=s_pred_cap, model=model, cweight=cweight,
        assembler=BatchAssembler(dataset, seg_cap, buckets),
        test_assembler=BatchAssembler(test_dataset, seg_cap, buckets), clip_bundle=clip_bundle,
    )


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: the CUDA card when ``device`` is
    None (there is no CPU fallback: without a card it raises); the CPU only
    when asked for.  It also turns TF32 off for torch's matmuls and cuDNN
    (the BiGRU): the port computes in float32, as its kernels do."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA card is available; pass device='cpu' (the CLIs: "
                               "--device cpu) to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
