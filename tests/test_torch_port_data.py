"""The port's data path, metrics and results against the JAX package's, on
the CPU.

* The port's fixture writers (``data/synthetic.py``) write files
  byte-equal to JAX's for the same arguments.
* ``create_dataset`` on one fixture (gtea; sr = 1 and 2; a holdout set;
  debug mode; features cached and streamed) gives the same video names,
  classes, background ids, features (bit-equal), labels and transcripts.
* Over 2 epochs ``TrainLoader`` with one seed gives the same video names per
  batch and bit-equal ``device_arrays``; ``EvalLoader``,
  ``scan_dataset_caps`` and the bucket ladder are equal.
* ``Checkpoint.compute_metrics`` agrees within 1e-9 on seeded predictions
  with a background class and seen / unseen splits, and a port ``.gz``
  reads back through JAX's ``Checkpoint.load``.
"""

import filecmp
import os

import numpy as np
import pytest

from fact_clip_tpu.configs.utils import setup_cfg as jax_setup_cfg
from fact_clip_tpu.data import batching as jbatching
from fact_clip_tpu.data import io as jio
from fact_clip_tpu.data import synthetic as jsynthetic
from fact_clip_tpu.data.dataset import create_dataset as jax_create_dataset
from fact_clip_tpu.utils import metrics as jmetrics
from fact_clip_tpu.utils import results as jresults
from fact_clip_tpu.utils import segments as jsegments
from fact_clip_tpu_torch.configs import setup_cfg
from fact_clip_tpu_torch.data import batching, io, synthetic
from fact_clip_tpu_torch.data.dataset import create_dataset
from fact_clip_tpu_torch.data.prefetch import prefetch
from fact_clip_tpu_torch.utils import metrics, results, segments

HOLDOUT = [5]  # keeps train videos 1, 2 and 5


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("ds")
    return jsynthetic.make_fixture_dataset(str(root), name="gtea", n_classes=6, n_train=7,
                                           n_test=4, feat_dim=12, min_len=60, max_len=300,
                                           min_segs=2, max_segs=6, seed=3)


def _sets(base, *extra):
    return ["dataset", "gtea", "feature_path", os.path.join(base, "features"),
            "groundTruth_path", os.path.join(base, "groundTruth"),
            "map_fname", os.path.join(base, "mapping.txt"),
            "split_path", os.path.join(base, "splits"), "feature_transpose", "true",
            "bg_class", "0", "TPU.bucket_multiple", "32", *extra]


def _both(base, *extra):
    return jax_setup_cfg([], _sets(base, *extra)), setup_cfg([], _sets(base, *extra))


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("kind", ["gtea", "havid_transposed", "epic"])
def test_fixture_writers_are_byte_equal(tmp_path, kind):
    a, b = tmp_path / "jax", tmp_path / "port"
    if kind == "epic":
        jsynthetic.make_epic_fixture(str(a), seed=5, feat_dim=8, n_train=3, n_test=2)
        synthetic.make_epic_fixture(str(b), seed=5, feat_dim=8, n_train=3, n_test=2)
    else:
        kw = dict(name="gtea", seed=1, n_classes=5, feat_dim=8, n_train=3, n_test=2)
        if kind == "havid_transposed":
            kw.update(name="havid", n_classes=9, min_segs=4, max_segs=8, bg_class=0)
        jsynthetic.make_fixture_dataset(str(a), **kw)
        synthetic.make_fixture_dataset(str(b), **kw)
    files = _tree(a)
    assert files == _tree(b) and len(files) > 5
    _, mismatch, errors = filecmp.cmpfiles(a, b, files, shallow=False)
    assert not mismatch and not errors


def test_io_readers_equal_jax(fixture_dir, tmp_path):
    mp = os.path.join(fixture_dir, "mapping.txt")
    assert io.load_action_mapping(mp) == jio.load_action_mapping(mp)
    gt = os.path.join(fixture_dir, "groundTruth")
    assert io.read_groundtruth_lines(gt, "train_vid_000") == \
        jio.read_groundtruth_lines(gt, "train_vid_000")
    (tmp_path / "crlf.txt").write_bytes("caf\xe9\r\nbackground\r\n".encode("latin-1"))
    assert io.read_groundtruth_lines(str(tmp_path), "crlf") == ["caf\xe9", "background"]
    assert io.read_groundtruth_lines(str(tmp_path), "crlf") == \
        jio.read_groundtruth_lines(str(tmp_path), "crlf")
    split = os.path.join(fixture_dir, "splits", "train.split1.bundle")
    assert io.read_split_list(split) == jio.read_split_list(split)
    feats = os.path.join(fixture_dir, "features")
    np.testing.assert_array_equal(io.load_feature(feats, "test_vid_001", True),
                                  jio.load_feature(feats, "test_vid_001", True))


def _assert_datasets_equal(a, b):
    assert a.video_list == b.video_list and len(a) == len(b)
    assert (a.nclasses, a.bg_class, a.input_dimension) == (b.nclasses, b.bg_class,
                                                           b.input_dimension)
    assert (a.label2index, a.index2label) == (b.label2index, b.index2label)
    assert (a.holdout_classes, a.seen_classes) == (b.holdout_classes, b.seen_classes)
    assert a.average_transcript_len == b.average_transcript_len
    for v in a.video_list:
        x, y = a[v], b[v]
        if x.feature is None:
            assert y.feature is None
        else:
            assert x.feature.dtype == y.feature.dtype == np.float32
            np.testing.assert_array_equal(x.feature, y.feature)
        for k in ("train_label", "eval_label", "transcript", "seg_label"):
            np.testing.assert_array_equal(getattr(x, k), getattr(y, k))
            assert getattr(x, k).dtype == getattr(y, k).dtype


@pytest.mark.parametrize("extra", [(), ("sr", "2"), ("sr", "3", "TPU.cache_features", "false"),
                                   ("holdout_mode", "true", "holdout_classes", str(HOLDOUT)),
                                   ("aux.debug", "true")],
                         ids=["sr1", "sr2", "sr3_streamed", "holdout", "debug"])
def test_create_dataset_equals_jax(fixture_dir, extra):
    jcfg, cfg = _both(fixture_dir, *extra)
    for a, b in zip(create_dataset(cfg), jax_create_dataset(jcfg)):
        _assert_datasets_equal(a, b)


def _assert_batches_equal(a, b):
    assert a.vnames == b.vnames
    for k, v in b.device_arrays.items():
        w = a.device_arrays[k]
        assert w.dtype == v.dtype and w.shape == v.shape, k
        np.testing.assert_array_equal(w, v, err_msg=k)
    for x, y in zip(a.eval_labels, b.eval_labels):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("extra", [(), ("sr", "2", "TPU.cache_features", "false")],
                         ids=["cached", "streamed_sr2"])
def test_loaders_equal_jax(fixture_dir, extra):
    jcfg, cfg = _both(fixture_dir, *extra)
    (ds, test), (jds, jtest) = create_dataset(cfg), jax_create_dataset(jcfg)
    caps = batching.scan_dataset_caps([ds, test], cfg)
    assert caps == jbatching.scan_dataset_caps([jds, jtest], jcfg)
    buckets, seg_cap = caps
    loader = batching.TrainLoader(ds, 3, batching.BatchAssembler(ds, seg_cap, buckets), seed=7)
    jloader = jbatching.TrainLoader(jds, 3, jbatching.BatchAssembler(jds, seg_cap, buckets),
                                    seed=7)
    assert len(loader) == len(jloader) == 3
    for _ in range(2):  # two epochs: the second shuffle of the same stream
        got, want = list(loader), list(jloader)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _assert_batches_equal(a, b)
    ev = batching.EvalLoader(test, 3, batching.BatchAssembler(test, seg_cap, buckets))
    jev = jbatching.EvalLoader(jtest, 3, jbatching.BatchAssembler(jtest, seg_cap, buckets))
    for a, b in zip(prefetch(ev, 2), jev):
        _assert_batches_equal(a, b)


@pytest.mark.parametrize("max_len", [1, 100, 128, 1000, 3072, 24576])
@pytest.mark.parametrize("multiple, growth", [(128, 1.26), (64, 1.5), (32, 1.0)])
def test_bucket_ladder_equals_jax(max_len, multiple, growth):
    got = batching.make_bucket_lengths(max_len, multiple, growth)
    assert got == jbatching.make_bucket_lengths(max_len, multiple, growth)
    assert batching.bucket_for(max_len, got) == jbatching.bucket_for(max_len, got)


def test_train_loader_refuses_many_processes(fixture_dir):
    _, cfg = _both(fixture_dir)
    ds, test = create_dataset(cfg)
    buckets, seg_cap = batching.scan_dataset_caps([ds, test], cfg)
    with pytest.raises(NotImplementedError, match="M13"):
        batching.TrainLoader(ds, 2, batching.BatchAssembler(ds, seg_cap, buckets),
                             process_count=2)


def _random_labels(rng, n_classes, lengths, min_seg=5):
    out = []
    for t in lengths:
        cuts = np.sort(rng.choice(np.arange(1, t), size=int(rng.integers(1, 8)), replace=False))
        lab = np.zeros(t, np.int64)
        for s, e in zip(np.concatenate([[0], cuts]), np.concatenate([cuts, [t]])):
            lab[s:e] = rng.integers(0, n_classes)
        out.append(lab)
    return out


@pytest.mark.parametrize("holdout", [False, True], ids=["all", "holdout"])
@pytest.mark.parametrize("sr", [1, 3])
def test_checkpoint_metrics_equal_jax(holdout, sr, tmp_path):
    rng = np.random.default_rng(11 + sr)
    n_classes, lengths = 7, [90, 151, 40, 233, 77]
    gts = _random_labels(rng, n_classes, lengths)
    preds = []
    for g in gts:  # a noisy, downsampled copy: some segments right, some not
        p = g[::sr].copy()
        flip = rng.random(len(p)) < 0.15
        p[flip] = rng.integers(0, n_classes, int(flip.sum()))
        preds.append(p)
    kw = dict(bg_class=[0], holdout_classes=[3, 5] if holdout else [],
              seen_classes=[0, 1, 2, 4, 6] if holdout else list(range(n_classes)))
    names = [f"v{i}" for i in range(len(gts))]
    saves = [{"pred": p, "loss": {"loss": float(i)}} for i, p in enumerate(preds)]
    port, ref = results.Checkpoint(4, **kw), jresults.Checkpoint(4, **kw)
    results.save_results(port, names, gts, saves)
    jresults.save_results(ref, names, gts, saves)
    got, want = port.compute_metrics(), ref.compute_metrics()
    assert list(got) == list(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-9, k
    assert port.per_class_metrics == ref.per_class_metrics
    port.average_losses()
    ref.average_losses()
    assert port.loss == ref.loss
    port.save(str(tmp_path / "4.gz"))
    back = jresults.Checkpoint.load(str(tmp_path / "4.gz"))
    assert back.iteration == 4 and back.metrics == got
    for v in names:
        np.testing.assert_array_equal(back.videos[v].pred_label, ref.videos[v].pred_label)


def test_segment_helpers_equal_jax():
    rng = np.random.default_rng(5)
    lab = _random_labels(rng, 4, [97])[0]
    assert [(s.action, s.start, s.end) for s in segments.parse_label(lab)] == \
        [(s.action, s.start, s.end) for s in jsegments.parse_label(lab)]
    for sr in (2, 3, 7):
        assert segments.shrink_frame_label(list(lab), sr) == \
            jsegments.shrink_frame_label(list(lab), sr)
        short = lab[::sr]
        np.testing.assert_array_equal(segments.expand_frame_label(short, len(lab)),
                                      jsegments.expand_frame_label(short, len(lab)))
    for a, b in zip(segments.class_label_to_segment_data(lab),
                    jsegments.class_label_to_segment_data(lab)):
        np.testing.assert_array_equal(a, b)
    p, y = segments.parse_label(lab[::-1].copy()), segments.parse_label(lab)
    jp, jy = jsegments.parse_label(lab[::-1].copy()), jsegments.parse_label(lab)
    assert metrics.edit_score(p, y, bg_class=[0]) == jmetrics.edit_score(jp, jy, bg_class=[0])
    for ov in (0.1, 0.25, 0.5):
        assert metrics.f_score(p, y, ov, bg_class=[0]) == jmetrics.f_score(jp, jy, ov,
                                                                          bg_class=[0])
