"""The port's serving entry and its boundaries, on the CPU.

``Predictor.predict`` must give what an unbatched per-video eval gives; its
bucket ladder must be the JAX package's; the port must import and serve with
JAX, flax and PyYAML absent; ``chip_smoke.py`` must refuse to run without a
card.  No kernel launches on CPU tensors.
"""

import ast
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import fact_clip_tpu_torch
from fact_clip_tpu.data.batching import make_bucket_lengths as jax_bucket_lengths
from fact_clip_tpu_torch.configs import small_cfg
from fact_clip_tpu_torch.data.batching import make_bucket_lengths
from fact_clip_tpu_torch.engine.serve import Predictor
from fact_clip_tpu_torch.engine.steps import make_eval_step
from fact_clip_tpu_torch.models.blocks import build_fact

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "fact_clip_tpu_torch")
D, C = 12, 5


def _requests(seed=0, lengths=(50, 100, 30, 128, 77, 12, 64)):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((n, D)).astype(np.float32) for n in lengths]


@pytest.mark.parametrize("batch_size", [1, 3])
def test_predict_equals_unbatched_eval(batch_size):
    model = build_fact(small_cfg(), D, C, 24, device="cpu",
                       generator=torch.Generator().manual_seed(3))
    feats = _requests()
    got = Predictor(model, 0.1, batch_size=batch_size, max_len=128).predict(feats)
    step = make_eval_step(model, 0.1)
    for f, g in zip(feats, got):
        n = len(f)
        ref = step(torch.from_numpy(f[None]), torch.ones(1, n, dtype=torch.bool),
                   torch.tensor([n])).numpy()[0]
        assert g.dtype == np.int32 and g.shape == (n,)
        np.testing.assert_array_equal(g, ref)
    assert all(v == 0 for v in fact_clip_tpu_torch.kernel_counters().values())


@pytest.mark.parametrize("max_len", [100, 128, 3000, 3072, 24576])
def test_bucket_ladder_is_the_jax_packages(max_len):
    assert make_bucket_lengths(max_len) == jax_bucket_lengths(max_len)
    assert make_bucket_lengths(max_len, 64, 1.5) == jax_bucket_lengths(max_len, 64, 1.5)


def test_predict_rejects_too_long_requests():
    model = build_fact(small_cfg(), D, C, 24, device="cpu")
    with pytest.raises(ValueError):
        Predictor(model, 0.1, batch_size=2, max_len=64).predict(_requests(lengths=(129,)))


_GUARD = """
import sys
sys.modules["jax"] = sys.modules["flax"] = sys.modules["yaml"] = None
import numpy as np, torch
import fact_clip_tpu_torch
from fact_clip_tpu_torch.configs import small_cfg
from fact_clip_tpu_torch.engine.serve import Predictor
from fact_clip_tpu_torch.models.blocks import build_fact
torch.set_num_threads(1)
model = build_fact(small_cfg(), 12, 5, 24, device="cpu")
out = Predictor(model, 0.1, batch_size=2, max_len=64).predict(
    [np.ones((40, 12), np.float32), np.zeros((9, 12), np.float32)])
assert [o.shape for o in out] == [(40,), (9,)]
# the verb/noun model, narrowed, with its K7 entries
from fact_clip_tpu_torch.configs import epic_cfg, epic_vocab
from fact_clip_tpu_torch.models.verbnoun import build_verbnoun_fact
cfg = epic_cfg()
cfg["FACT"]["ntoken"] = 6
cfg["Bi"].update(hid_dim=64, a_dim=16, a_ffdim=16, a_nhead=2, a_layers=1, f_dim=16, f_layers=3)
cfg["Bu"].update(a_nhead=2, f_layers=2)
cfg["BU"].update(a_nhead=2, f_layers=2)
vn = build_verbnoun_fact(cfg, 12, *epic_vocab(13, 29, 97), 16, 13, 29, device="cpu")
out = Predictor(vn, 0.1, batch_size=1, max_len=64).predict([np.ones((40, 12), np.float32)])
assert out[0].shape == (40,) and 0 <= out[0].min() and out[0].max() < 97
# int8 evaluation (ops/quant_conv.py), narrowed
cfg8 = small_cfg()
cfg8["TPU"]["quantize_infer"] = "int8"
m8 = build_fact(cfg8, 12, 5, 24, device="cpu")
assert "fact_clip_tpu_torch.ops.quant_conv" in sys.modules
out = Predictor(m8, 0.1, batch_size=2, max_len=64).predict([np.ones((40, 12), np.float32)])
assert out[0].shape == (40,)
# int8 MS-TCN++ towers (K8e) and the single-layer K1, narrowed
cfg8["Bi"]["f"] = "m2"
m82 = build_fact(cfg8, 12, 5, 24, device="cpu")
out = Predictor(m82, 0.1, batch_size=2, max_len=64).predict([np.ones((40, 12), np.float32)])
assert out[0].shape == (40,)
from fact_clip_tpu_torch.models.layers import DilatedResidualLayer
y = DilatedResidualLayer(2, 16, True, use_kernel=True)(torch.ones(1, 9, 16),
                                                       torch.ones(1, 9, dtype=torch.bool))
assert y.shape == (1, 9, 16)
assert not [m for m in sys.modules if m.startswith("fact_clip_tpu.") or m == "fact_clip_tpu"]
print("GUARD_OK")
"""


def test_import_guard_no_jax_flax_yaml():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _GUARD], capture_output=True, text=True,
                          env=env, cwd=REPO, timeout=120)
    assert proc.returncode == 0 and "GUARD_OK" in proc.stdout, proc.stderr[-2000:]


def test_no_module_of_the_port_imports_jax_flax_or_yaml():
    """Nor the JAX package, not even lazily; chip_smoke.py neither."""
    banned = {"jax", "flax", "yaml", "fact_clip_tpu"}
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    for f in paths:
        for node in ast.walk(ast.parse(open(f).read())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in banned, (f, n)


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """No CUDA here: the smoke test exits non-zero and prints no result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                          capture_output=True, text=True, env=env, cwd=REPO, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "torch.cuda.is_available() is False" in proc.stderr
    # alone in a directory, without the package, it fails as well
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True, text=True,
                          env=env, cwd=tmp_path, timeout=120)
    assert proc.returncode != 0 and '"ok": true' not in proc.stdout
