"""FACT_CLIP's zero-shot holdout workflow through the port's loop and CLIs on
the CPU, on ``tests/test_clip.py``'s fixture shape (a HAViD-coded set of 6
classes, one held out) written by the JAX package's
``make_fixture_dataset``, with seeded random unit text embeddings in a
``.pt`` cache.  Class 4 is held out: 5 of the 10 training videos lack it
(class 3, ``tests/test_clip.py``'s choice, leaves 2), and 3 test videos hold
it.

* ``run_train`` feeds, step by step, the training videos JAX's ``run_train``
  feeds after the holdout filter (the JAX steps stubbed: the order does not
  depend on them), and both datasets agree on the seen and held-out classes.
* ``run_train(text_embeddings=...)`` writes ``Acc-seen`` / ``Acc-unseen``, the
  ``_detailed.json`` results and the loss split (``fact_loss``,
  ``contrastive_loss``) in ``metrics.jsonl``.
* A port checkpoint of FACT_CLIP read by JAX's ``convert_fact_state_dict``
  gives JAX's eval predictions with the bundle (>= 0.999 of the frames, the
  rule of ``tests/test_torch_port_loop.py``).
* Both CLIs run with ``--device cpu`` on ``openvocab_havid_view0_lh_pt.yaml``
  and ``havid_view0_lh_pt_holdout.yaml`` (narrowed by an overlay) and the
  fixture's cache: ``run_eval`` on the last checkpoint gives the run's own
  test metrics and predictions.  Without a cache ``resolve_text_embeddings``
  warns and returns None, as JAX's.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from fact_clip_tpu.configs.utils import setup_cfg as jax_setup_cfg
from fact_clip_tpu.data.dataset import create_dataset as jax_create_dataset
from fact_clip_tpu.data.synthetic import make_fixture_dataset
from fact_clip_tpu.engine import setup as jsetup
from fact_clip_tpu.engine import train_loop as jtl
from fact_clip_tpu.engine.steps import make_step_fns
from fact_clip_tpu.models import blocks as jblocks
from fact_clip_tpu.models.clip_model import build_fact_clip as jax_build_fact_clip
from fact_clip_tpu.utils.results import Checkpoint as JaxCheckpoint
from fact_clip_tpu.utils.torch_import import convert_fact_state_dict
from fact_clip_tpu_torch import train as tcli
from fact_clip_tpu_torch.configs import setup_cfg
from fact_clip_tpu_torch.data.dataset import create_dataset
from fact_clip_tpu_torch.engine import checkpoint as ckpt_io
from fact_clip_tpu_torch.engine import train_loop as tl
from fact_clip_tpu_torch.engine.setup import build_experiment
from fact_clip_tpu_torch.engine.steps import make_eval_step, make_train_step

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MIN_AGREE = 0.999  # share of frames whose prediction equals JAX's
CLIP_DIM = 32
LABELS = ["null", "gnt", "sshc1dh", "iglft", "pntbx", "rhdcb"]  # tests/test_clip.py's
# tests/test_clip.py::clip_cfg as a recipe, 3 epochs of 2 steps (5 videos
# survive the filter of class 4), tests and checkpoints every 3 steps
RECIPE = """dataset: havid_view0_lh_pt
feature_path: {base}/features
groundTruth_path: {base}/groundTruth
map_fname: {base}/mapping.txt
split_path: {base}/splits
feature_transpose: true
bg_class: 0
average_transcript_len: 4.0
use_clip: true
holdout_mode: true
holdout_classes: [4]
batch_size: 3
optimizer: Adam
lr: 0.002
epoch: 3
FACT:
  block: iu
  ntoken: 8
  fpos: false
  cmr: 0.0
Bi:
  hid_dim: 48
  a_dim: 24
  a_ffdim: 48
  a_layers: 2
  a_nhead: 4
  f: m
  f_dim: 32
  f_layers: 3
  f_ln: false
  f_ngp: 1
  dropout: 0.1
Bu:
  f_layers: 2
Loss:
  sw: 1.0
  pc: 0.2
CLIP:
  temp: 0.1
  projection_hidden_dim: 32
  text_emb_path: {emb}
TM:
  use: false
aux:
  print_every: 3
  eval_every: 3
TPU:
  bucket_multiple: 64
  num_data_shards: 1
"""
# the two recipes narrowed for the CPU, an overlay given as a second --cfg
# (a file's keys stay out of the experiment's name, --set's would not): the
# fixture's paths and classes, the widths of RECIPE, three epochs
OVERLAY = """feature_path: {base}/features
groundTruth_path: {base}/groundTruth
map_fname: {base}/mapping.txt
split_path: {base}/splits
feature_transpose: true
bg_class: 0
average_transcript_len: 4.0
holdout_mode: true
holdout_classes: [4]
batch_size: 3
epoch: 3
FACT:
  ntoken: 8
Bi:
  hid_dim: 48
  a_dim: 24
  a_ffdim: 48
  a_layers: 1
  a_nhead: 4
  f_dim: 32
  f_layers: 3
Bu:
  a_nhead: 4
  f_layers: 2
BU:
  a_nhead: 4
  f_layers: 2
CLIP:
  projection_hidden_dim: 32
  text_emb_path: {emb}
aux:
  eval_every: 3
  print_every: 3
TPU:
  bucket_multiple: 64
"""


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    root = tmp_path_factory.mktemp("clipds")
    base = make_fixture_dataset(str(root), name="havid_view0_lh_pt", n_classes=6, n_train=10,
                                n_test=4, feat_dim=16, min_len=60, max_len=150, class_sep=3.0,
                                label_names=LABELS)
    emb = np.random.default_rng(0).normal(size=(6, CLIP_DIM)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    pt = root / "havid_text_embeddings.pt"
    torch.save(torch.from_numpy(emb), str(pt))
    recipe, overlay = root / "clip.yaml", root / "narrow.yaml"
    recipe.write_text(RECIPE.format(base=base, emb=pt))
    overlay.write_text(OVERLAY.format(base=base, emb=pt))
    return dict(base=base, emb=emb, pt=str(pt), recipe=str(recipe), overlay=str(overlay))


def _cfgs(fixture, *sets):
    sets = list(sets)
    return jax_setup_cfg([fixture["recipe"]], sets), setup_cfg([fixture["recipe"]], sets)


def test_holdout_filter_keeps_jaxs_videos(fixture, tmp_path, monkeypatch):
    jcfg, cfg = _cfgs(fixture)
    (jtrain, jtest), (train, test) = jax_create_dataset(jcfg), create_dataset(cfg)
    assert list(train.video_list) == list(jtrain.video_list)
    assert len(train.video_list) == 5  # the filter removed the videos of class 4
    for a, b in ((train, jtrain), (test, jtest)):
        assert a.holdout_classes == b.holdout_classes == [4]
        assert a.seen_classes == b.seen_classes == [0, 1, 2, 3, 5]

    def make_step_fns_stub(model, cfg, nclasses, cweight, clip_bundle, verbnoun=False):
        assert clip_bundle is not None

        def train_step(state, arrays, rng):
            B, L = arrays["mask"].shape
            return state, {"pred": np.zeros((B, L), np.int64),
                           "per_video_loss": np.zeros((B,), np.float32)}

        return train_step, lambda params, arrays: np.zeros(arrays["mask"].shape, np.int64)

    monkeypatch.setattr(jtl, "make_step_fns", make_step_fns_stub)
    seen = {"jax": [], "port": []}
    for side, module in (("jax", jtl), ("port", tl)):
        real = module.save_results

        def spy(ckpt, vnames, labels, saves, side=side, real=real):
            seen[side].append((ckpt.iteration, list(vnames)))
            return real(ckpt, vnames, labels, saves)

        monkeypatch.setattr(module, "save_results", spy)
    jtl.run_train(jcfg, text_embeddings=fixture["emb"], base_dir=str(tmp_path / "jax"))
    tl.run_train(cfg, device="cpu", base_dir=str(tmp_path / "port"),
                 text_embeddings=fixture["emb"])
    assert seen["port"] == seen["jax"] and len(seen["port"]) == 6 + 2 * 2


def test_run_train_holdout_writes_seen_unseen_and_the_loss_split(fixture, tmp_path):
    _, cfg = _cfgs(fixture)
    step, best = tl.run_train(cfg, device="cpu", base_dir=str(tmp_path),
                              text_embeddings=fixture["emb"])
    assert step.clip_bundle is not None and best is not None
    for key in ("Acc-seen", "Acc-unseen", "F1@0.50-seen", "F1@0.50-unseen"):
        assert np.isfinite(best.metrics[key]), key
    logdir = os.path.join(str(tmp_path), cfg.aux.logdir)
    assert os.path.exists(os.path.join(logdir, "saves", "3_detailed.json"))
    with open(os.path.join(logdir, "saves", "6_detailed.json")) as f:
        assert json.load(f)
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    train = [r for r in recs if "train-loss/loss" in r]
    assert len(train) == 2
    for r in train:
        assert r["train-loss/contrastive_loss"] > 0 and np.isfinite(r["train-loss/fact_loss"])
        # the weights of the default config: loss = 0.5 fact + 0.5 contrastive, per video
        assert r["train-loss/loss"] == pytest.approx(
            0.5 * r["train-loss/fact_loss"] + 0.5 * r["train-loss/contrastive_loss"], rel=1e-5)
    assert any(k.startswith("test-metric-unseen") or "unseen" in k for r in recs for k in r)


def test_clip_checkpoint_reads_into_the_jax_model(fixture, tmp_path):
    jcfg, cfg = _cfgs(fixture)
    exp = build_experiment(cfg, "cpu", seed=2, text_embeddings=fixture["emb"])
    step = make_train_step(exp.model, cfg, exp.dataset.nclasses, exp.cweight,
                           clip_bundle=exp.clip_bundle)
    batch = next(iter(exp.train_loader(seed=2)))
    step(tl.batch_to_device(batch.device_arrays, "cpu"), tl.step_generator(2, 0, "cpu"))
    path = ckpt_io.save_model(exp.model, str(tmp_path), 1)

    sd = {k: v.numpy() for k, v in torch.load(path, weights_only=True).items()}
    params = convert_fact_state_dict(sd, jblocks.resolve_block_cfgs(jcfg))
    assert set(params) == {"fact", "frame_projection"}
    jmodel = jax_build_fact_clip(jcfg, exp.dataset.input_dimension, exp.dataset.nclasses,
                                 exp.s_pred_cap, CLIP_DIM)
    bundle = jsetup.build_clip_bundle(jcfg, fixture["emb"], [4])
    _, jeval = make_step_fns(jmodel, jcfg, exp.dataset.nclasses, exp.cweight, bundle)
    eval_step = make_eval_step(exp.model, cfg.FACT.mwt, exp.clip_bundle)
    agree = []
    for b in exp.test_loader():
        want = np.asarray(jeval(params, b.device_arrays))
        x = tl.batch_to_device(b.device_arrays, "cpu")
        got = eval_step(x["feats"], x["mask"], x["lengths"]).numpy()
        agree.append((got == want)[b.device_arrays["mask"]])
    agree = np.concatenate(agree)
    assert agree.mean() >= MIN_AGREE, agree.mean()


def test_resolve_text_embeddings_soft_fails(fixture, tmp_path, monkeypatch, capsys):
    _, cfg = _cfgs(fixture)
    np.testing.assert_array_equal(tcli.resolve_text_embeddings(cfg, str(tmp_path)),
                                  fixture["emb"])

    def no_model(*args, **kwargs):
        raise ImportError("No module named 'transformers'")

    from fact_clip_tpu_torch.data import text_embeddings as tte

    monkeypatch.setattr(tte, "precompute_text_embeddings", no_model)
    _, cfg = _cfgs(fixture, "CLIP.text_emb_path", str(tmp_path / "missing.pt"))
    assert tcli.resolve_text_embeddings(cfg, str(tmp_path)) is None
    assert "contrastive loss will be disabled" in capsys.readouterr().out
    _, cfg = _cfgs(fixture, "map_fname", str(tmp_path / "nothing.txt"))
    assert tcli.resolve_text_embeddings(cfg, str(tmp_path)) is None
    assert "Mapping file not found" in capsys.readouterr().out


def _cli(root, module, *args):
    env = dict(os.environ, PYTHONPATH=str(root), OMP_NUM_THREADS="2", CUDA_VISIBLE_DEVICES="",
               HF_HUB_OFFLINE="1", TRANSFORMERS_OFFLINE="1")
    return subprocess.run([sys.executable, "-m", module, *args], capture_output=True, text=True,
                          env=env, cwd=str(root), timeout=300)


@pytest.mark.parametrize("yaml_name", ["openvocab_havid_view0_lh_pt.yaml",
                                       "havid_view0_lh_pt_holdout.yaml"])
def test_clis_run_the_clip_recipes_on_the_cpu(fixture, tmp_path, yaml_name):
    """The recipes as given, narrowed by an overlay, on a copy of the package
    (the CLIs log under its project base)."""
    shutil.copytree(os.path.join(REPO, "fact_clip_tpu_torch"), tmp_path / "fact_clip_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    yaml_path = os.path.join(REPO, "fact_clip_tpu", "configs", yaml_name)
    cfgs = [yaml_path, fixture["overlay"]]
    sets = ["aux.seed", "3"]
    cfg = setup_cfg(cfgs, sets)
    assert cfg.use_clip and cfg.holdout_mode and cfg.CLIP.text_emb_path == fixture["pt"]
    logdir = tmp_path / cfg.aux.logdir
    train = _cli(tmp_path, "fact_clip_tpu_torch.train", "--cfg", *cfgs, "--device", "cpu",
                 "--set", *sets)
    assert train.returncode == 0, train.stderr[-3000:]
    assert "CREATING FACT_CLIP MODEL" in train.stdout and "HOLDOUT EVALUATION" in train.stdout
    with open(logdir / "metrics.jsonl") as f:
        assert any("train-loss/contrastive_loss" in json.loads(line) for line in f)
    ckpt = logdir / "ckpts" / "network.iter-6.net"
    assert ckpt.exists() and (logdir / "saves" / "6_detailed.json").exists()

    ev = _cli(tmp_path, "fact_clip_tpu_torch.run_eval", "--cfg", *cfgs, "--ckpt", str(ckpt),
              "--device", "cpu", "--set", *sets)
    assert ev.returncode == 0, ev.stderr[-3000:]
    got = JaxCheckpoint.load(str(logdir / "eval_results" / "eval_result.gz"))
    want = JaxCheckpoint.load(str(logdir / "saves" / "6.gz"))
    assert got.metrics == want.metrics and "Acc-unseen" in got.metrics
    for v in want.videos:
        np.testing.assert_array_equal(got.videos[v].pred, want.videos[v].pred)
    assert (logdir / "eval_results" / "eval_detailed.json").exists()
