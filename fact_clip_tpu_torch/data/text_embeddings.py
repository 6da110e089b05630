"""CLIP text embeddings of the class names (the port's counterpart of
``fact_clip_tpu/data/text_embeddings.py``).

Prompts are built from HA-ViD codes (or ``"a person <label>"`` for other
datasets), embedded with the HF CLIP text tower, L2-normalised and cached.
The model consumes only the cached ``(n_classes, E)`` float32 array.  A
cache is a torch ``.pt`` file (the reference's format) or a ``.npy``
file.  ``precompute_text_embeddings`` imports ``transformers`` when it is
called, and fails where that package or the model's files are missing;
the CLIs catch that and train without the contrastive loss.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from .text_prompts import generate_action_prompt, is_havid_label


def generate_text_descriptions(cfg, label2index: Dict[str, int],
                               index2label: Dict[int, str]) -> List[str]:
    descriptions = []
    for i in range(len(index2label)):
        label = index2label.get(i, f"action_{i}")
        if cfg.dataset.startswith("havid") and is_havid_label(label):
            desc = generate_action_prompt(label) if cfg.CLIP.use_prompt else label
        else:
            desc = label.replace("_", " ")
            if cfg.CLIP.use_prompt:
                desc = f"a person {desc}"
        descriptions.append(desc)
    return descriptions


def precompute_text_embeddings(text_descriptions: List[str],
                               clip_model_name: str = "openai/clip-vit-base-patch32",
                               save_path: Optional[str] = None) -> np.ndarray:
    """Embed prompts with the HF CLIP text tower on the CPU."""
    from transformers import CLIPModel, CLIPTokenizer

    name_map = {
        "openai/clip-vit-b-32": "openai/clip-vit-base-patch32",
        "ViT-B/32": "openai/clip-vit-base-patch32",
        "clip-vit-b-32": "openai/clip-vit-base-patch32",
    }
    model_name = name_map.get(clip_model_name, clip_model_name)
    print(f"Pre-computing text embeddings for {len(text_descriptions)} classes with {model_name}")

    clip_model = CLIPModel.from_pretrained(model_name).eval()
    tokenizer = CLIPTokenizer.from_pretrained(model_name)
    with torch.no_grad():
        inputs = tokenizer(text_descriptions, padding=True, truncation=True, max_length=77,
                           return_tensors="pt")
        emb = torch.nn.functional.normalize(clip_model.get_text_features(**inputs), dim=-1)
    emb_np = emb.cpu().numpy().astype(np.float32)

    if save_path is not None:
        d = os.path.dirname(save_path)
        if d:
            os.makedirs(d, exist_ok=True)
        save_text_embeddings(emb_np, save_path)
    return emb_np


def save_text_embeddings(emb: np.ndarray, path: str) -> None:
    if path.endswith(".npy"):
        np.save(path, emb)
        return
    torch.save(torch.from_numpy(np.ascontiguousarray(emb, np.float32)), path)
    print(f"Saved text embeddings to {path}")


def load_text_embeddings(emb_path: str) -> np.ndarray:
    if not os.path.exists(emb_path):
        raise FileNotFoundError(f"Text embeddings file not found: {emb_path}")
    if emb_path.endswith(".npy"):
        emb = np.load(emb_path)
    else:
        emb = torch.load(emb_path, map_location="cpu", weights_only=True)
        if isinstance(emb, torch.Tensor):
            emb = emb.detach().numpy()
    emb = np.asarray(emb, np.float32)
    print(f"Loaded text embeddings from {emb_path}: shape {emb.shape}")
    return emb


def default_emb_path(cfg, base: str) -> str:
    if cfg.CLIP.text_emb_path is not None:
        return cfg.CLIP.text_emb_path
    if cfg.dataset.startswith("havid"):
        variant = cfg.dataset.replace("havid_", "")
        return os.path.join(base, "data", "HAViD", "ActionSegmentation", "data", variant,
                            f"{cfg.dataset}_text_embeddings.pt")
    return os.path.join(base, "data", f"{cfg.dataset}_text_embeddings.pt")


def get_or_compute_text_embeddings(cfg, label2index, index2label,
                                   base: Optional[str] = None) -> np.ndarray:
    """Load the cached embedding array, computing and caching it if missing."""
    if base is None:
        from ..home import get_project_base

        base = get_project_base()
    emb_path = default_emb_path(cfg, base)

    if os.path.exists(emb_path) and cfg.CLIP.precompute_text:
        try:
            return load_text_embeddings(emb_path)
        except Exception as e:  # noqa: BLE001
            print(f"Warning: failed to load embeddings from {emb_path}: {e}; recomputing")

    descriptions = generate_text_descriptions(cfg, label2index, index2label)
    print(f"Generated {len(descriptions)} text descriptions, e.g.:")
    for d in descriptions[:5]:
        print(" ", d)
    return precompute_text_embeddings(descriptions, clip_model_name=cfg.CLIP.model_name,
                                      save_path=emb_path if cfg.CLIP.precompute_text else None)
