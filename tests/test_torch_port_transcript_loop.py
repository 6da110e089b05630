"""Transcript mode through the port's training loop and CLIs against the JAX
package's, on the CPU: ``gtea_transcript.yaml`` narrowed by a second
``--cfg`` overlay (``iuU`` with its ``seq`` matching, transcript tokens,
time masking and channel masking; towers 24 wide) over a GTEA-shaped
fixture (``data/synthetic.py::make_gtea_fixture``: 11 classes, background
10) at narrow features and short videos.

* ``make_gtea_fixture`` writes what JAX's ``make_fixture_dataset`` writes
  for the same arguments, byte for byte, at GTEA's lengths and segment counts.
* ``build_experiment`` sizes the token axis by the batches' segment cap (the
  longest transcript, or ``TPU.max_gt_segs``), as JAX's does.
* ``run_train(device="cpu")`` trains 4 steps, writes every file of a run and
  logs finite losses; its batches, step by step, are JAX ``run_train``'s.
* 2 steps, a save, a model and optimizer rebuilt from the files and 2 more
  steps give parameters and Adam moments bit-equal to 4 unbroken steps
  (dropout, channel and time masking on).
* ``evaluate`` decodes with the test videos' transcripts: on weights
  bridged from JAX's init it predicts as JAX's ``evaluate`` on >= 0.999 of
  the frames (every prediction a class of the video's transcript), its
  metrics within 0.1 points; a port checkpoint read by JAX's importer
  (``trans=True``) gives JAX's forward within 1e-4.
* Both CLIs in subprocesses with ``--device cpu``: ``run_eval`` on the last
  checkpoint gives the metrics and predictions of the run's own test pass.
"""

import filecmp
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from fact_clip_tpu.configs.utils import setup_cfg as jax_setup_cfg
from fact_clip_tpu.data.synthetic import make_fixture_dataset as jax_fixture
from fact_clip_tpu.engine import train_loop as jtl
from fact_clip_tpu.models import blocks as jblocks
from fact_clip_tpu.utils.results import Checkpoint as JaxCheckpoint
from fact_clip_tpu.utils.torch_import import convert_fact_state_dict
from fact_clip_tpu_torch.configs import setup_cfg
from fact_clip_tpu_torch.data.synthetic import GTEA_SHAPE, make_gtea_fixture
from fact_clip_tpu_torch.engine import checkpoint as ckpt_io
from fact_clip_tpu_torch.engine import train_loop as tl
from fact_clip_tpu_torch.engine.setup import build_experiment
from fact_clip_tpu_torch.engine.steps import make_eval_step, make_train_step
from fact_clip_tpu_torch.utils.bridge import load_jax_params

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML = os.path.join(REPO, "fact_clip_tpu", "configs", "gtea_transcript.yaml")
ATOL = 1e-4  # forward parity, float32 both sides (tests/test_torch_port_model.py)
MIN_AGREE = 0.999  # share of test frames whose prediction equals JAX's
METRIC_TOL = 0.1  # points, each metric of the test pass
FIXTURE = dict(n_train=4, n_test=2, feat_dim=16, min_len=80, max_len=200, min_segs=3,
               max_segs=8, class_sep=3.0)
# narrows the recipe: paths, 4 steps of batch 2 with test passes at 2 and 4
OVERLAY = """feature_path: {base}/features
groundTruth_path: {base}/groundTruth
map_fname: {base}/mapping.txt
split_path: {base}/splits
feature_transpose: true
bg_class: 10
batch_size: 2
lr: 0.002
epoch: 2
FACT:
  cmr: 0.3
Bi:
  hid_dim: 32
  a_dim: 16
  a_ffdim: 32
  a_layers: 2
  a_nhead: 4
  f_dim: 24
  f_layers: 3
  dropout: 0.1
Bu:
  a_nhead: 4
  f_layers: 2
BU:
  a_nhead: 4
  f_layers: 2
TM:
  t: 8
aux:
  print_every: 1
  eval_every: 2
TPU:
  bucket_multiple: 64
"""


@pytest.fixture(scope="module")
def recipe(tmp_path_factory):
    root = tmp_path_factory.mktemp("trans_loop")
    base = make_gtea_fixture(str(root), **FIXTURE)
    path = root / "narrow.yaml"
    path.write_text(OVERLAY.format(base=base))
    return [YAML, str(path)]


def _cfgs(recipe, *sets):
    sets = list(sets)
    return jax_setup_cfg(recipe, sets), setup_cfg(recipe, sets)


def _logdir(base, cfg):
    return os.path.join(base, cfg.aux.logdir)


def test_gtea_fixture_is_jaxs(tmp_path):
    """At GTEA's lengths and segment counts (narrow features): the files JAX
    writes for the same arguments, every transcript within 10-35 segments."""
    got = make_gtea_fixture(str(tmp_path / "port"), n_train=3, n_test=1, feat_dim=8, seed=2)
    want = jax_fixture(str(tmp_path / "jax"), **dict(GTEA_SHAPE, n_train=3, n_test=1,
                                                     feat_dim=8, seed=2))
    assert GTEA_SHAPE["n_classes"] == 11 and GTEA_SHAPE["bg_class"] == 10
    for sub in ("", "groundTruth", "splits", "features"):
        names = sorted(os.listdir(os.path.join(want, sub)))
        assert names == sorted(os.listdir(os.path.join(got, sub)))
        for n in names:
            if os.path.isfile(os.path.join(want, sub, n)):
                assert filecmp.cmp(os.path.join(got, sub, n), os.path.join(want, sub, n),
                                   shallow=False), n
    for n in os.listdir(os.path.join(got, "groundTruth")):
        with open(os.path.join(got, "groundTruth", n)) as f:
            labels = f.read().split()
        runs = 1 + sum(a != b for a, b in zip(labels, labels[1:]))
        assert 600 <= len(labels) <= 2100 and 10 <= runs <= 35, (n, len(labels), runs)


@pytest.mark.parametrize("cap", ["scan", "12"])
def test_the_token_axis_is_the_segment_cap(recipe, cap):
    """The model takes as many tokens as the batches' transcripts hold: the
    longest of the data (as JAX's ``scan_dataset_caps``) or TPU.max_gt_segs."""
    from fact_clip_tpu.engine.setup import build_experiment as jax_build_experiment

    sets = [] if cap == "scan" else ["TPU.max_gt_segs", cap]
    jcfg, cfg = _cfgs(recipe, *sets)
    exp = build_experiment(cfg, "cpu")
    jexp = jax_build_experiment(jcfg, seed=0)
    assert exp.seg_cap == jexp.seg_cap and exp.s_pred_cap == jexp.s_pred_cap
    if cap != "scan":
        assert exp.seg_cap == 12
    batch = next(iter(exp.train_loader()))
    x = tl.batch_to_device(batch.device_arrays, "cpu")
    assert x["transcript"].shape[1] == exp.seg_cap
    with torch.no_grad():
        saves, _ = exp.model(x["feats"], x["mask"], x["lengths"], transcript=x["transcript"],
                             seg_mask=x["seg_mask"])
    assert saves[0]["action_clogit"].shape[1] == exp.seg_cap
    assert cfg.Loss.nullw == 0.0  # -1 resolved: no token is null in transcript mode


def test_run_train_writes_every_file_and_logs_its_losses(recipe, tmp_path):
    _, cfg = _cfgs(recipe)
    step, best = tl.run_train(cfg, device="cpu", base_dir=str(tmp_path))
    logdir = _logdir(str(tmp_path), cfg)
    for f in ("args.json", "metrics.jsonl", "ckpts/network.iter-2.net",
              "ckpts/network.iter-4.net", "saves/2.gz", "saves/4.gz", "best_ckpt.gz",
              "FINISH_PROOF"):
        assert os.path.exists(os.path.join(logdir, f)), f
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    losses = [r["train-loss/loss"] for r in recs if "train-loss/loss" in r]
    assert len(losses) == 4 and all(np.isfinite(v) and v > 0 for v in losses)
    assert step.model.trans and step.optimizer.count == 4 and best is not None


def _record(monkeypatch, module, seen):
    real = module.save_results

    def spy(ckpt, vnames, labels, saves):
        seen.append((ckpt.iteration, list(vnames), [np.asarray(s["pred"]).shape for s in saves]))
        return real(ckpt, vnames, labels, saves)

    monkeypatch.setattr(module, "save_results", spy)


def test_run_train_feeds_the_batches_jax_feeds(recipe, tmp_path, monkeypatch):
    def make_step_fns(model, cfg, nclasses, cweight, clip_bundle, verbnoun=False):
        def train_step(state, arrays, rng):
            B, L = arrays["mask"].shape
            return state, {"pred": np.zeros((B, L), np.int64),
                           "per_video_loss": np.zeros((B,), np.float32)}

        return train_step, lambda params, arrays: np.zeros(arrays["mask"].shape, np.int64)

    monkeypatch.setattr(jtl, "make_step_fns", make_step_fns)
    got, want = [], []
    _record(monkeypatch, tl, got)
    _record(monkeypatch, jtl, want)
    jcfg, cfg = _cfgs(recipe, "aux.seed", "5")
    jcfg.aux.logdir = cfg.aux.logdir = "log/feed"
    jtl.run_train(jcfg, base_dir=str(tmp_path / "jax"))
    tl.run_train(cfg, device="cpu", base_dir=str(tmp_path / "port"))
    assert got == want and len([g for g in got if g[0] == -1]) == 4


def test_transcript_resume_continues_bit_equal(recipe, tmp_path):
    """Adam, dropout 0.1, channel masking 0.3 and time masking on."""
    _, cfg = _cfgs(recipe)
    seed = cfg.aux.seed
    whole = build_experiment(cfg, "cpu", seed=seed)
    loader = whole.train_loader(seed=seed)
    batches = [b.device_arrays for _ in range(2) for b in loader]
    nclasses = whole.dataset.nclasses

    def train(exp, step, steps):
        for g in steps:
            step(tl.batch_to_device(batches[g], "cpu"), tl.step_generator(seed, g, "cpu"))

    step_a = make_train_step(whole.model, cfg, nclasses, whole.cweight, len(loader))
    train(whole, step_a, range(4))
    part = build_experiment(cfg, "cpu", seed=seed)
    step_b = make_train_step(part.model, cfg, nclasses, part.cweight, len(loader))
    train(part, step_b, range(2))
    ckpt_io.save_model(part.model, str(tmp_path), 2)
    ckpt_io.save_train_state(step_b.optimizer, str(tmp_path), 2)
    again = build_experiment(cfg, "cpu", seed=seed + 1)  # other weights until the load
    step_c = make_train_step(again.model, cfg, nclasses, again.cweight, len(loader))
    ckpt_io.load_model(again.model, str(tmp_path / "network.iter-2.net"))
    assert ckpt_io.load_train_state(step_c.optimizer, str(tmp_path / "network.iter-2.net"))
    train(again, step_c, range(2, 4))
    for (name, a), c in zip(whole.model.named_parameters(), again.model.parameters()):
        assert torch.equal(a, c), name
    sa, sc = step_a.optimizer.opt.state_dict(), step_c.optimizer.opt.state_dict()
    for i, st in sa["state"].items():
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(st[k], sc["state"][i][k]), (i, k)


class _NoLog:
    def log(self, metrics, step):
        pass


def test_transcript_evaluate_matches_jax(recipe, tmp_path):
    from fact_clip_tpu.engine.setup import build_experiment as jax_build_experiment
    from fact_clip_tpu.engine.steps import make_step_fns

    jcfg, cfg = _cfgs(recipe)
    jexp = jax_build_experiment(jcfg, seed=4)
    _, jeval = make_step_fns(jexp.model, jcfg, jexp.dataset.nclasses, jexp.cweight, None)
    want = jtl.evaluate(5, jexp, jeval, jexp.params, _NoLog(), str(tmp_path))

    exp = build_experiment(cfg, "cpu")
    load_jax_params(exp.model, jexp.params)
    got = tl.evaluate(5, exp, make_eval_step(exp.model, cfg.FACT.mwt), None, None)
    assert list(got.videos) == list(want.videos)
    agree = np.concatenate([got.videos[v].pred == want.videos[v].pred for v in got.videos])
    assert agree.mean() >= MIN_AGREE, agree.mean()
    for k in want.metrics:
        assert abs(got.metrics[k] - want.metrics[k]) <= METRIC_TOL, k
    # every prediction is a class of the video's transcript
    for v, video in got.videos.items():
        assert set(np.unique(video.pred)) <= set(exp.test_dataset[v].transcript.tolist()), v


def test_a_transcript_checkpoint_reads_into_the_jax_model(recipe, tmp_path):
    jcfg, cfg = _cfgs(recipe)
    exp = build_experiment(cfg, "cpu", seed=2)
    step = make_train_step(exp.model, cfg, exp.dataset.nclasses, exp.cweight)
    batch = next(iter(exp.train_loader(seed=2)))
    step(tl.batch_to_device(batch.device_arrays, "cpu"), tl.step_generator(2, 0, "cpu"))
    path = ckpt_io.save_model(exp.model, str(tmp_path), 1)
    sd = {k: v.numpy() for k, v in torch.load(path, weights_only=True).items()}
    assert "action_embed.weight" in sd and "action_query" not in sd
    params = convert_fact_state_dict(sd, jblocks.resolve_block_cfgs(jcfg), trans=True)
    jmodel = jblocks.build_fact(jcfg, exp.dataset.input_dimension, exp.dataset.nclasses,
                                s_pred_cap=exp.s_pred_cap)
    a = batch.device_arrays
    jsaves, _ = jmodel.apply({"params": params}, a["feats"], a["mask"], a["lengths"],
                             a["transcript"], a["seg_mask"], train=False)
    x = tl.batch_to_device(a, "cpu")
    with torch.no_grad():
        saves, _ = exp.model(x["feats"], x["mask"], x["lengths"], transcript=x["transcript"],
                             seg_mask=x["seg_mask"])
    for i, (sp, sj) in enumerate(zip(saves, jsaves)):
        np.testing.assert_allclose(sp["frame_clogit"].numpy()[a["mask"]],
                                   np.asarray(sj["frame_clogit"])[a["mask"]], atol=ATOL,
                                   err_msg=f"block {i}")
        np.testing.assert_allclose(sp["action_clogit"].numpy(), np.asarray(sj["action_clogit"]),
                                   atol=ATOL, err_msg=f"block {i}")


def _cli(root, module, *args):
    env = dict(os.environ, PYTHONPATH=str(root), OMP_NUM_THREADS="2", CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-m", module, *args[:-1], "--device", "cpu",
                           *args[-1]], capture_output=True, text=True, env=env, cwd=str(root),
                          timeout=300)


def test_clis_run_gtea_transcript_on_the_cpu(recipe, tmp_path):
    shutil.copytree(os.path.join(REPO, "fact_clip_tpu_torch"), tmp_path / "fact_clip_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    _, cfg = _cfgs(recipe, "aux.seed", "3")
    logdir = tmp_path / cfg.aux.logdir
    cfgs = ["--cfg", *recipe]
    train = _cli(tmp_path, "fact_clip_tpu_torch.train", *cfgs, ["--set", "aux.seed", "3"])
    assert train.returncode == 0, train.stderr[-3000:]
    ckpt = logdir / "ckpts" / "network.iter-4.net"
    assert ckpt.exists() and (logdir / "FINISH_PROOF").exists()
    ev = _cli(tmp_path, "fact_clip_tpu_torch.run_eval", *cfgs, "--ckpt", str(ckpt),
              ["--set", "aux.seed", "3"])
    assert ev.returncode == 0, ev.stderr[-3000:]
    got = JaxCheckpoint.load(str(logdir / "eval_results" / "eval_result.gz"))
    want = JaxCheckpoint.load(str(logdir / "saves" / "4.gz"))
    assert got.metrics == want.metrics
    for v in want.videos:
        np.testing.assert_array_equal(got.videos[v].pred, want.videos[v].pred)
