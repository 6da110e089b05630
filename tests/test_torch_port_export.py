"""The port's own FACT exporter and its entry defaults, on the CPU.

``fact_clip_tpu_torch/utils/torch_export.py`` is the port's copy of the JAX
package's numpy-only exporter, so that the port imports nothing of the JAX
package: it must give the same state_dict, key for key and value for value,
for the small config, the flagship's block config and the small config
with MS-TCN++ towers (``f: m2``).  A fresh interpreter that imports the
port, builds a model and loads numpy parameters through the bridge, and
builds and runs a narrowed Breakfast model, must end with no ``jax`` and no
``fact_clip_tpu`` module loaded.
``build_fact`` without a device builds on the card, and without a card it
raises instead of landing on the CPU.
"""

import dataclasses
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from __graft_entry__ import _make_cfg
from fact_clip_tpu.models import blocks as jblocks
from fact_clip_tpu.utils.torch_export import export_fact_state_dict as jax_export
from fact_clip_tpu.utils.torch_import import convert_fact_state_dict
from fact_clip_tpu_torch.configs import flagship_cfg, small_cfg
from fact_clip_tpu_torch.models.blocks import build_fact
from fact_clip_tpu_torch.utils.torch_export import export_fact_state_dict

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _flax_params(cfg, small: bool, D: int, C: int, seed: int = 0, f: str = "m"):
    """Seeded parameters in the flax layout (the port's init through the JAX
    package's importer) and the JAX block configs."""
    port = build_fact(cfg, D, C, 24, device="cpu", generator=torch.Generator().manual_seed(seed))
    jcfg = _make_cfg(small)
    jcfg.Bi.f = f
    bcfgs = jblocks.resolve_block_cfgs(jcfg)
    return convert_fact_state_dict({k: v.numpy() for k, v in port.state_dict().items()},
                                   bcfgs), bcfgs


@pytest.mark.parametrize("small,f", [(True, "m"), (False, "m"), (True, "m2")],
                         ids=["True", "False", "m2"])
def test_exporter_equals_the_jax_packages(small, f):
    cfg = small_cfg() if small else flagship_cfg()
    cfg["Bi"]["f"] = f
    params, bcfgs = _flax_params(cfg, small, 12 if small else 64, 5 if small else 10, f=f)
    ref = jax_export(params, bcfgs)
    got = export_fact_state_dict(params, bcfgs)
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert got[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_exporter_refuses_what_the_port_does_not_build():
    params, bcfgs = _flax_params(small_cfg(), True, 12, 5)
    with pytest.raises(ValueError):
        export_fact_state_dict({"fact": params, "frame_projection": {}}, bcfgs)
    other = [dataclasses.replace(c, f="cnn") for c in bcfgs]
    with pytest.raises(ValueError, match="'cnn' is not ported"):
        export_fact_state_dict(params, other)


_GUARD = """
import pickle, sys
import torch
from fact_clip_tpu_torch.configs import breakfast_cfg, small_cfg
from fact_clip_tpu_torch.models.blocks import build_fact
from fact_clip_tpu_torch.utils.bridge import load_jax_params
torch.set_num_threads(1)
params = pickle.load(open(sys.argv[1], "rb"))
model = build_fact(small_cfg(), 12, 5, 24, device="cpu")
load_jax_params(model, params)
assert float(model.state_dict()["action_query"].abs().sum()) > 0
cfg = breakfast_cfg()  # narrowed: MS-TCN++ towers, SCA and SA decoders, TDU
cfg["FACT"]["ntoken"] = 6
cfg["Bi"].update(hid_dim=16, a_dim=16, a_ffdim=16, a_nhead=2, a_layers=1, f_dim=16, f_layers=3)
cfg["Bu"].update(a_nhead=2, f_layers=2)
cfg["BU"].update(a_nhead=2, f_layers=2)
bf = build_fact(cfg, 12, 5, 24, device="cpu")
lens = torch.tensor([40, 29], dtype=torch.int32)
with torch.no_grad():
    saves, _ = bf(torch.randn(2, 40, 12), torch.arange(40)[None] < lens[:, None], lens)
assert len(saves) == 4 and bool(torch.isfinite(saves[-1]["frame_clogit"]).all())
# mixed precision: the bf16 forms' plain versions and the layers' cast sites
c16 = small_cfg()
c16["TPU"]["compute_dtype"] = "bfloat16"
m16 = build_fact(c16, 12, 5, 24, device="cpu")
load_jax_params(m16, params)
with torch.no_grad():
    s16, tail = m16(torch.randn(2, 40, 12), torch.arange(40)[None] < lens[:, None], lens)
assert tail.dtype == torch.bfloat16 and bool(torch.isfinite(s16[-1]["frame_clogit"]).all())
from fact_clip_tpu_torch.configs import havid_tpu_cfg
assert havid_tpu_cfg()["TPU"]["compute_dtype"] == "bfloat16"
assert "fact_clip_tpu_torch.ops.bf16" in sys.modules
# the training loop, its entry points and everything they import
import fact_clip_tpu_torch.run_eval, fact_clip_tpu_torch.train  # noqa: E401
import fact_clip_tpu_torch.data.synthetic, fact_clip_tpu_torch.utils.reduce  # noqa: E401
from fact_clip_tpu_torch.configs import setup_cfg
for mod in ("configs.yaml_lite", "configs.node", "configs.default", "configs.utils", "home",
            "utils.segments", "utils.metrics", "utils.results", "data.io", "data.dataset",
            "data.batching", "data.prefetch", "engine.checkpoint", "engine.logging",
            "engine.setup", "engine.train_loop"):
    assert "fact_clip_tpu_torch." + mod in sys.modules, mod
cfg = setup_cfg([sys.argv[2] + "/fact_clip_tpu/configs/havid_tpu.yaml"], ["lr", "0.001"])
assert cfg.TPU.compute_dtype == "bfloat16" and cfg.TPU.matcher == "auction" and cfg.lr == 0.001
bad = [m for m in sys.modules
       if m in ("jax", "flax", "yaml") or m.split(".")[0] in ("fact_clip_tpu", "jax", "flax", "yaml")]
assert not bad, bad
print("GUARD_OK")
"""


def test_bridge_loads_numpy_params_without_the_jax_package(tmp_path):
    params, _ = _flax_params(small_cfg(), True, 12, 5, seed=4)
    path = tmp_path / "params.pkl"
    with open(path, "wb") as f:
        pickle.dump(params, f)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _GUARD, str(path), REPO], capture_output=True,
                          text=True, env=env, cwd=str(tmp_path), timeout=120)
    assert proc.returncode == 0 and "GUARD_OK" in proc.stdout, proc.stderr[-2000:]


def test_build_fact_without_a_device_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_fact(small_cfg(), 12, 5, 24)
    assert build_fact(small_cfg(), 12, 5, 24, device="cpu").action_query.device.type == "cpu"
