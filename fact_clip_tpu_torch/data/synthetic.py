"""Synthetic fixture datasets in the standard on-disk layout (the port's copy
of ``fact_clip_tpu/data/synthetic.py``, byte-equal to its files for the same
arguments).

Piecewise-constant frame labels and class-conditioned noisy features, so a
model can learn, written as ``mapping.txt`` + ``groundTruth/*.txt`` +
``splits/*.bundle`` + ``features/*.npy``: the directory conventions of the
dataset registry (``data/dataset.py``).
"""

from __future__ import annotations

import os

import numpy as np


def make_fixture_dataset(
    root: str,
    name: str = "gtea",
    n_classes: int = 6,
    n_train: int = 8,
    n_test: int = 4,
    feat_dim: int = 32,
    min_len: int = 120,
    max_len: int = 400,
    min_segs: int = 3,
    max_segs: int = 7,
    bg_class: int = 0,
    split: str = "split1",
    seed: int = 0,
    transpose: bool = True,
    label_names: list | None = None,
    class_sep: float = 2.0,
):
    """Write a synthetic dataset under ``root/data/<name>/`` and return its dir."""
    rng = np.random.default_rng(seed)
    base = os.path.join(root, "data", name)
    os.makedirs(os.path.join(base, "groundTruth"), exist_ok=True)
    os.makedirs(os.path.join(base, "splits"), exist_ok=True)
    os.makedirs(os.path.join(base, "features"), exist_ok=True)

    if label_names is None:
        label_names = [f"act_{i}" for i in range(n_classes)]
        label_names[bg_class] = "background"
    with open(os.path.join(base, "mapping.txt"), "w") as f:
        for i, l in enumerate(label_names):
            f.write(f"{i} {l}\n")

    # class prototype directions in feature space
    protos = rng.normal(size=(n_classes, feat_dim)).astype(np.float32)

    def gen_video(vname):
        n_seg = int(rng.integers(min_segs, max_segs + 1))
        T = int(rng.integers(min_len, max_len + 1))
        # random segment boundaries
        cuts = np.sort(rng.choice(np.arange(1, T), size=n_seg - 1, replace=False))
        bounds = np.concatenate([[0], cuts, [T]])
        labels = np.zeros(T, dtype=np.int64)
        prev = -1
        for k in range(n_seg):
            c = int(rng.integers(0, n_classes))
            while c == prev:  # no adjacent duplicate segments
                c = int(rng.integers(0, n_classes))
            labels[bounds[k] : bounds[k + 1]] = c
            prev = c
        feats = protos[labels] * class_sep + rng.normal(size=(T, feat_dim)).astype(np.float32)
        with open(os.path.join(base, "groundTruth", vname + ".txt"), "w") as f:
            for l in labels:
                f.write(label_names[l] + "\n")
        arr = feats.T if transpose else feats
        np.save(os.path.join(base, "features", vname + ".npy"), arr.astype(np.float32))
        return labels

    train_names = [f"train_vid_{i:03d}" for i in range(n_train)]
    test_names = [f"test_vid_{i:03d}" for i in range(n_test)]
    for v in train_names + test_names:
        gen_video(v)

    with open(os.path.join(base, "splits", f"train.{split}.bundle"), "w") as f:
        for v in train_names:
            f.write(v + ".txt\n")
    with open(os.path.join(base, "splits", f"test.{split}.bundle"), "w") as f:
        for v in test_names:
            f.write(v + ".txt\n")

    return base


# GTEA's shape (28 videos of ~1,100 frames at 15 fps with ~20 actions each,
# 11 classes, background class 10, I3D features): videos of 600-2,100 frames
# and 10-35 segments, so that a transcript fits a segment cap of at most 64
GTEA_SHAPE = dict(name="gtea", n_classes=11, bg_class=10, feat_dim=2048, min_len=600,
                  max_len=2100, min_segs=10, max_segs=35)


def make_gtea_fixture(root: str, n_train: int = 8, n_test: int = 4, seed: int = 0, **kwargs):
    """A GTEA-shaped set (``GTEA_SHAPE``; ``kwargs`` override it) under
    ``root/data/gtea/``; returns its directory."""
    return make_fixture_dataset(root, **dict(GTEA_SHAPE, n_train=n_train, n_test=n_test,
                                             seed=seed, **kwargs))


def make_epic_fixture(
    root: str,
    n_verbs: int = 4,
    n_nouns: int = 5,
    n_actions: int = 8,
    split: str = "split1",
    seed: int = 0,
    **kwargs,
):
    """Epic-Kitchens-style fixture: action classes are ``verb,noun`` pairs
    plus verb_mapping.txt / noun_mapping.txt, ego-style split files
    (``<split>.train`` / ``<split>.test``), features not transposed."""
    rng = np.random.default_rng(seed + 1)
    verbs = [f"verb{v}" for v in range(n_verbs)]
    nouns = [f"noun{n}" for n in range(n_nouns)]
    # the reference asserts the action vocabulary SPANS the verb/noun
    # vocabularies (max(_VIDS)+1 == n_verbs, blocks_SepVerbNoun.py:206-207),
    # so one action always uses the last verb and last noun
    pairs = [(0, 0), (n_verbs - 1, n_nouns - 1)]  # background-ish + span pin
    seen = set(pairs)
    while len(pairs) < n_actions:
        p = (int(rng.integers(0, n_verbs)), int(rng.integers(0, n_nouns)))
        if p not in seen:
            seen.add(p)
            pairs.append(p)
    label_names = [f"{verbs[v]},{nouns[n]}" for v, n in pairs]

    base = make_fixture_dataset(
        root, name="epic-kitchens/processed", n_classes=n_actions, split=split, seed=seed,
        transpose=False, label_names=label_names, **kwargs,
    )
    with open(os.path.join(base, "verb_mapping.txt"), "w") as f:
        for i, v in enumerate(verbs):
            f.write(f"{i} {v}\n")
    with open(os.path.join(base, "noun_mapping.txt"), "w") as f:
        for i, n in enumerate(nouns):
            f.write(f"{i} {n}\n")
    # epic/ego split naming: <split>.train / <split>.test, no .txt suffixes
    for kind in ("train", "test"):
        src = os.path.join(base, "splits", f"{kind}.{split}.bundle")
        with open(src) as f:
            names = [l[:-len(".txt")] if l.endswith(".txt") else l for l in f.read().splitlines()]
        with open(os.path.join(base, f"{split}.{kind}"), "w") as f:
            f.write("\n".join(names) + "\n")
    return base
