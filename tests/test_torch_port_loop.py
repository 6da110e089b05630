"""The port's training loop, checkpoints and entry points against the JAX
package's, on the CPU, on ``tests/test_train_smoke.py``'s narrow gtea
configuration (``iuU``, towers 32 wide) over a fixture written by the JAX
package's ``make_fixture_dataset``.

* ``run_train(device="cpu")`` writes every file of a run (``args.json``
  equal to JAX's ``cfg2flatdict``, ``metrics.jsonl``, the weights and
  optimizer sidecars, ``saves/<N>.gz``, ``best_ckpt.gz``, FINISH_PROOF); a
  second call with ``resume: max`` exits without training; without a card
  and without ``device="cpu"`` it raises; what it has no path for raises;
  in transcript mode it trains and logs its losses.
* Its batches, step by step, are JAX ``run_train``'s (the JAX steps stubbed:
  the batch order does not depend on them), also across a resume, where
  both restart the epoch at the loader's first shuffle.
* With Adam, dropout, channel and time masking on, 2 steps, a save, a model
  and optimizer rebuilt from the files and 2 more steps give parameters and
  Adam moments bit-equal to 4 unbroken steps.
* A port ``network.iter-N.net`` read by JAX's ``convert_fact_state_dict``
  gives JAX's forward, equal to the port's within 1e-4 (the model-parity
  tolerance of ``tests/test_torch_port_model.py``).
* ``evaluate`` on weights bridged from JAX's init predicts as JAX's
  ``evaluate`` on >= 0.999 of the frames, its metrics within 0.1 points.
* Both CLIs run in subprocesses with ``--device cpu``: ``run_eval`` on the
  last checkpoint gives the metrics of the run's own test pass, a repeated
  ``train`` prints "already finished", and without a card they exit non-zero.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from fact_clip_tpu.configs.utils import cfg2flatdict as jax_flat
from fact_clip_tpu.configs.utils import setup_cfg as jax_setup_cfg
from fact_clip_tpu.data.synthetic import make_fixture_dataset
from fact_clip_tpu.engine import train_loop as jtl
from fact_clip_tpu.models import blocks as jblocks
from fact_clip_tpu.utils.results import Checkpoint as JaxCheckpoint
from fact_clip_tpu.utils.torch_import import convert_fact_state_dict
from fact_clip_tpu_torch.configs import setup_cfg
from fact_clip_tpu_torch.engine import checkpoint as ckpt_io
from fact_clip_tpu_torch.engine import train_loop as tl
from fact_clip_tpu_torch.engine.setup import build_experiment
from fact_clip_tpu_torch.engine.steps import make_eval_step, make_train_step
from fact_clip_tpu_torch.utils.bridge import load_jax_params

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-4  # forward parity, float32 both sides (tests/test_torch_port_model.py)
MIN_AGREE = 0.999  # share of test frames whose prediction equals JAX's
METRIC_TOL = 0.1  # points, each metric of the test pass
# tests/test_train_smoke.py::smoke_cfg as a recipe: 6 train videos in batches
# of 3 (2 steps an epoch), evaluated and checkpointed every 2 steps
RECIPE = """dataset: gtea
feature_path: {base}/features
groundTruth_path: {base}/groundTruth
map_fname: {base}/mapping.txt
split_path: {base}/splits
feature_transpose: true
bg_class: 0
average_transcript_len: 4.0
batch_size: 3
optimizer: Adam
lr: 0.002
epoch: 2
FACT:
  block: iuU
  ntoken: 10
  fpos: false
  cmr: 0.3
  mwt: 0.3
Bi:
  hid_dim: 48
  a_dim: 24
  a_ffdim: 48
  a_layers: 2
  a_nhead: 4
  f: m
  f_dim: 32
  f_layers: 4
  f_ln: false
  f_ngp: 1
  dropout: 0.1
Bu:
  f_layers: 3
BU:
  f_layers: 3
Loss:
  sw: 1.0
  pc: 0.2
TM:
  use: true
  t: 8
aux:
  print_every: 2
  eval_every: 2
TPU:
  bucket_multiple: 64
  num_data_shards: 1
"""


@pytest.fixture(scope="module")
def recipe(tmp_path_factory):
    root = tmp_path_factory.mktemp("loop")
    base = make_fixture_dataset(str(root), name="gtea", n_classes=5, n_train=6, n_test=3,
                                feat_dim=16, min_len=80, max_len=200, min_segs=3, max_segs=5,
                                class_sep=3.0)
    path = root / "smoke.yaml"
    path.write_text(RECIPE.format(base=base))
    return str(path)


def _cfgs(recipe, *sets):
    sets = list(sets)
    return jax_setup_cfg([recipe], sets), setup_cfg([recipe], sets)


def _logdir(base, cfg):
    return os.path.join(base, cfg.aux.logdir)


def test_run_train_writes_every_file_then_skips(recipe, tmp_path):
    jcfg, cfg = _cfgs(recipe)
    step, best = tl.run_train(cfg, device="cpu", base_dir=str(tmp_path))
    logdir = _logdir(str(tmp_path), cfg)
    for f in ("args.json", "metrics.jsonl", "ckpts/network.iter-2.net", "ckpts/state.iter-2.state",
              "ckpts/network.iter-4.net", "ckpts/state.iter-4.state", "saves/2.gz", "saves/4.gz",
              "best_ckpt.gz", "FINISH_PROOF"):
        assert os.path.exists(os.path.join(logdir, f)), f
    with open(os.path.join(logdir, "args.json")) as f:
        assert json.load(f) == json.loads(json.dumps(jax_flat(jcfg)))
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs] == [2, 2, 4, 4]
    assert all(np.isfinite(v) for r in recs for v in r.values())
    assert {k.split("/")[0] for r in recs for k in r if k != "step"} == \
        {"train-loss", "train-metric", "test-metric-all"}
    assert best is not None and best.iteration in (2, 4) and step.optimizer.count == 4
    back = JaxCheckpoint.load(os.path.join(logdir, "best_ckpt.gz"))
    assert back.metrics == best.metrics and "Edit" in back.metrics
    before = sorted(os.listdir(os.path.join(logdir, "ckpts")))
    with pytest.raises(SystemExit):
        tl.run_train(cfg, device="cpu", base_dir=str(tmp_path))
    assert sorted(os.listdir(os.path.join(logdir, "ckpts"))) == before


def _record(monkeypatch, module, seen):
    real = module.save_results

    def spy(ckpt, vnames, labels, saves):
        seen.append((ckpt.iteration, list(vnames)))
        return real(ckpt, vnames, labels, saves)

    monkeypatch.setattr(module, "save_results", spy)


def _stub_jax_steps(monkeypatch):
    def make_step_fns(model, cfg, nclasses, cweight, clip_bundle, verbnoun=False):
        def train_step(state, arrays, rng):
            B, L = arrays["mask"].shape
            return state, {"pred": np.zeros((B, L), np.int64),
                           "per_video_loss": np.zeros((B,), np.float32)}

        def eval_step(params, arrays):
            return np.zeros(arrays["mask"].shape, np.int64)

        return train_step, eval_step

    monkeypatch.setattr(jtl, "make_step_fns", make_step_fns)


def test_run_train_feeds_the_batches_jax_feeds(recipe, tmp_path, monkeypatch):
    """Step by step the same videos as JAX's ``run_train``, then after a cut
    at step 4 and a resume with ``epoch: 3`` the same again: both start the
    resumed epoch at the loader's first shuffle (ROADMAP Queue 3)."""
    _stub_jax_steps(monkeypatch)
    got, want = [], []
    _record(monkeypatch, tl, got)
    _record(monkeypatch, jtl, want)
    for epoch in ("2", "3"):
        jcfg, cfg = _cfgs(recipe, "epoch", epoch, "aux.seed", "5")
        jcfg.aux.logdir = cfg.aux.logdir = "log/feed"
        jtl.run_train(jcfg, base_dir=str(tmp_path / "jax"))
        tl.run_train(cfg, device="cpu", base_dir=str(tmp_path / "port"))
        for side in ("jax", "port"):  # the first run stands for a run cut at step 4
            proof = os.path.join(str(tmp_path / side), "log/feed/FINISH_PROOF")
            if epoch == "2":
                os.remove(proof)
    assert got == want
    train = [v for it, v in got if it == -1]
    assert len(train) == 6 and train[4:] == train[:2]  # the resumed epoch: the first shuffle


def _train(exp, step, batches, steps, seed):
    for g in steps:
        step(tl.batch_to_device(batches[g], "cpu"), tl.step_generator(seed, g, "cpu"))


def test_resume_continues_bit_equal(recipe, tmp_path):
    """Adam, dropout 0.1, channel masking 0.3 and time masking on, the LR
    decayed from step 2 (``lr_decay: 1``, 2 steps an epoch)."""
    _, cfg = _cfgs(recipe, "lr_decay", "1")
    seed = cfg.aux.seed
    whole = build_experiment(cfg, "cpu", seed=seed)
    loader = whole.train_loader(seed=seed)
    batches = [b.device_arrays for _ in range(2) for b in loader]
    nclasses = whole.dataset.nclasses
    step_a = make_train_step(whole.model, cfg, nclasses, whole.cweight, len(loader))
    _train(whole, step_a, batches, range(4), seed)

    part = build_experiment(cfg, "cpu", seed=seed)
    step_b = make_train_step(part.model, cfg, nclasses, part.cweight, len(loader))
    _train(part, step_b, batches, range(2), seed)
    ckpt_io.save_model(part.model, str(tmp_path), 2)
    ckpt_io.save_train_state(step_b.optimizer, str(tmp_path), 2)

    again = build_experiment(cfg, "cpu", seed=seed + 1)  # other weights until the load
    step_c = make_train_step(again.model, cfg, nclasses, again.cweight, len(loader))
    ckpt_io.load_model(again.model, str(tmp_path / "network.iter-2.net"))
    assert ckpt_io.load_train_state(step_c.optimizer, str(tmp_path / "network.iter-2.net"))
    assert step_c.optimizer.count == 2
    _train(again, step_c, batches, range(2, 4), seed)

    for (name, a), c in zip(whole.model.named_parameters(), again.model.parameters()):
        assert torch.equal(a, c), name
    sa, sc = step_a.optimizer.opt.state_dict(), step_c.optimizer.opt.state_dict()
    assert sa["param_groups"] == sc["param_groups"] and sa["param_groups"][0]["lr"] < cfg.lr
    for i, st in sa["state"].items():
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(st[k], sc["state"][i][k]), (i, k)


def test_checkpoint_reads_into_the_jax_model(recipe, tmp_path):
    jcfg, cfg = _cfgs(recipe)
    exp = build_experiment(cfg, "cpu", seed=2)
    step = make_train_step(exp.model, cfg, exp.dataset.nclasses, exp.cweight)
    batch = next(iter(exp.train_loader(seed=2)))
    step(tl.batch_to_device(batch.device_arrays, "cpu"), tl.step_generator(2, 0, "cpu"))
    path = ckpt_io.save_model(exp.model, str(tmp_path), 1)

    sd = {k: v.numpy() for k, v in torch.load(path, weights_only=True).items()}
    jblock_cfgs = jblocks.resolve_block_cfgs(jcfg)
    params = convert_fact_state_dict(sd, jblock_cfgs)
    jmodel = jblocks.build_fact(jcfg, exp.dataset.input_dimension, exp.dataset.nclasses,
                                s_pred_cap=exp.s_pred_cap)
    arrays = batch.device_arrays
    jsaves, _ = jmodel.apply({"params": params}, arrays["feats"], arrays["mask"],
                             arrays["lengths"], train=False)
    x = tl.batch_to_device(arrays, "cpu")
    with torch.no_grad():
        saves, _ = exp.model(x["feats"], x["mask"], x["lengths"])
    mask = arrays["mask"]
    for i, (sp, sj) in enumerate(zip(saves, jsaves)):
        for key in ("frame_clogit", "action_clogit"):
            got, ref = sp[key].numpy(), np.asarray(sj[key])
            if key == "frame_clogit":
                got, ref = got[mask], ref[mask]
            np.testing.assert_allclose(got, ref, atol=ATOL, err_msg=f"block {i} {key}")


class _NoLog:
    def log(self, metrics, step):
        pass


def test_evaluate_matches_jax(recipe, tmp_path):
    from fact_clip_tpu.engine.setup import build_experiment as jax_build_experiment
    from fact_clip_tpu.engine.steps import make_step_fns

    jcfg, cfg = _cfgs(recipe)
    jexp = jax_build_experiment(jcfg, seed=4)
    _, jeval = make_step_fns(jexp.model, jcfg, jexp.dataset.nclasses, jexp.cweight, None)
    want = jtl.evaluate(5, jexp, jeval, jexp.params, _NoLog(), str(tmp_path))

    exp = build_experiment(cfg, "cpu")
    load_jax_params(exp.model, jexp.params)
    got = tl.evaluate(5, exp, make_eval_step(exp.model, cfg.FACT.mwt), None, None)
    assert got.iteration == want.iteration == 6 and list(got.videos) == list(want.videos)
    agree = np.concatenate([got.videos[v].pred == want.videos[v].pred for v in got.videos])
    assert agree.mean() >= MIN_AGREE, agree.mean()
    assert list(got.metrics) == list(want.metrics)
    for k in want.metrics:
        assert abs(got.metrics[k] - want.metrics[k]) <= METRIC_TOL, k


def test_run_train_needs_a_card(recipe, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = _cfgs(recipe)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tl.run_train(cfg)


def test_the_experiment_turns_tf32_off(recipe, monkeypatch):
    """Whoever builds the experiment gets float32 matmuls and cuDNN calls
    (the BiGRU), not TF32: the device's owner sets it, not each CLI."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    _, cfg = _cfgs(recipe)
    build_experiment(cfg, "cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_run_train_with_use_clip_trains_and_logs_contrastive_loss(recipe, tmp_path):
    """FACT_CLIP (ROADMAP M10) on the CPU: given text embeddings the run
    trains on the contrastive loss too and logs it beside the loss."""
    _, cfg = _cfgs(recipe, "use_clip", "true")
    emb = np.random.default_rng(0).normal(size=(5, 16)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    step, best = tl.run_train(cfg, device="cpu", base_dir=str(tmp_path), text_embeddings=emb)
    assert step.clip_bundle is not None and step.optimizer.count == 4 and best is not None
    with open(os.path.join(_logdir(str(tmp_path), cfg), "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f if "train-loss/loss" in line]
    assert len(recs) == 2
    assert all(r["train-loss/contrastive_loss"] > 0 and np.isfinite(r["train-loss/fact_loss"])
               for r in recs)


def test_run_train_in_transcript_mode_logs_its_losses(recipe, tmp_path):
    """``FACT.trans`` (ROADMAP M11) trains: the tokens are the transcripts,
    ``seq`` matching, the transcript decode; 4 steps log finite losses."""
    _, cfg = _cfgs(recipe, "FACT.trans", "true", "FACT.ntoken", "0", "Loss.match", "seq",
                   "FACT.mwt", "0.0")
    step, best = tl.run_train(cfg, device="cpu", base_dir=str(tmp_path))
    assert step.model.trans and step.optimizer.count == 4 and best is not None
    with open(os.path.join(_logdir(str(tmp_path), cfg), "metrics.jsonl")) as f:
        losses = [json.loads(line)["train-loss/loss"] for line in f if "train-loss/loss" in line]
    assert len(losses) == 2 and all(np.isfinite(v) and v > 0 for v in losses)


@pytest.mark.parametrize("sets, match", [
    (("TPU.num_data_shards", "2"), "M13"), (("TPU.num_seq_shards", "2"), "M13"),
    (("TPU.profile_dir", "trace"), "profile_dir"),
    (("TPU.checkpoint_backend", "orbax"), "orbax"),
    (("TPU.feature_dtype", "bfloat16"), "feature_dtype")])
def test_run_train_refuses_what_it_has_no_path_for(recipe, tmp_path, sets, match):
    _, cfg = _cfgs(recipe, *sets)
    with pytest.raises(NotImplementedError, match=match):
        tl.run_train(cfg, device="cpu", base_dir=str(tmp_path))
    assert not os.path.exists(_logdir(str(tmp_path), cfg))


def _cli(root, module, *args, device="cpu"):
    env = dict(os.environ, PYTHONPATH=str(root), OMP_NUM_THREADS="2", CUDA_VISIBLE_DEVICES="")
    dev = ["--device", device] if device else []
    return subprocess.run([sys.executable, "-m", module, *args[:-1], *dev, *args[-1]],
                          capture_output=True, text=True, env=env, cwd=str(root), timeout=300)


def test_clis_on_the_cpu(recipe, tmp_path):
    """The CLIs log under the package's project base: a copy of the package
    in a temporary directory keeps the run there."""
    shutil.copytree(os.path.join(REPO, "fact_clip_tpu_torch"), tmp_path / "fact_clip_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    _, cfg = _cfgs(recipe)
    logdir = tmp_path / cfg.aux.logdir
    train = _cli(tmp_path, "fact_clip_tpu_torch.train", "--cfg", recipe, ["--set", "aux.seed", "3"])
    assert train.returncode == 0, train.stderr[-3000:]
    ckpt = logdir / "ckpts" / "network.iter-4.net"
    assert ckpt.exists() and (logdir / "FINISH_PROOF").exists()

    ev = _cli(tmp_path, "fact_clip_tpu_torch.run_eval", "--cfg", recipe, "--ckpt", str(ckpt),
              ["--set", "aux.seed", "3"])
    assert ev.returncode == 0, ev.stderr[-3000:]
    got = JaxCheckpoint.load(str(logdir / "eval_results" / "eval_result.gz"))
    want = JaxCheckpoint.load(str(logdir / "saves" / "4.gz"))
    assert got.metrics == want.metrics
    for v in want.videos:
        np.testing.assert_array_equal(got.videos[v].pred, want.videos[v].pred)

    before = sorted(os.listdir(logdir / "ckpts"))
    again = _cli(tmp_path, "fact_clip_tpu_torch.train", "--cfg", recipe, ["--set", "aux.seed", "3"])
    assert again.returncode == 0 and "already finished" in again.stdout, again.stderr[-3000:]
    assert sorted(os.listdir(logdir / "ckpts")) == before

    for module, extra in (("fact_clip_tpu_torch.train", []),
                          ("fact_clip_tpu_torch.run_eval", ["--ckpt", str(ckpt)])):
        proc = _cli(tmp_path, module, "--cfg", recipe, *extra, [], device=None)
        assert proc.returncode != 0 and "no CUDA card" in proc.stderr, proc.stderr[-2000:]


@pytest.mark.parametrize("case", ["scratch", "max_empty", "max_latest", "explicit"])
def test_resume_ckpt_follows_the_jax_rules(recipe, tmp_path, case):
    from fact_clip_tpu.engine import checkpoint as jckpt_io

    logdir = tmp_path / "log" / "split1" / "run"
    (logdir / "ckpts").mkdir(parents=True)
    if case in ("max_latest", "explicit"):
        for n in (2, 10, 4):
            (logdir / "ckpts" / f"network.iter-{n}.net").write_bytes(b"")
    resume = {"scratch": "", "explicit": str(logdir / "ckpts" / "network.iter-4.net")}
    jcfg, cfg = _cfgs(recipe, "aux.resume", resume.get(case, "max"))
    got = ckpt_io.resume_ckpt(cfg, str(logdir))
    assert got == jckpt_io.resume_ckpt(jcfg, str(logdir))
    assert got[0] == {"scratch": 0, "max_empty": 0, "max_latest": 10, "explicit": 4}[case]
