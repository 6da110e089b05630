"""The port's config tree against the JAX package's, on the CPU.

* ``configs/yaml_lite.py`` reads every ``fact_clip_tpu/configs/*.yaml`` to
  exactly what ``yaml.safe_load`` reads, and resolves ``--set`` value strings
  (YAML 1.1's quirks: ``yes`` / ``on``, ``~``, ``0x10``, ``012``, ``1_000``,
  ``1.5e-4`` a float and ``1e-4`` a string, ``None`` a string) as it does;
  what it does not cover raises.
* The port's ``setup_cfg`` gives, as a plain dict, exactly JAX's
  (``node.py::_to_plain_dict``) for every YAML with and without overrides,
  ``aux.exp`` and ``aux.logdir`` included, and the same KeyError for an
  unknown key.
* ``default_cfg()`` is the JAX default tree.
"""

import glob
import json
import math
import os

import pytest
import yaml

from fact_clip_tpu.configs.node import _to_plain_dict as jax_plain
from fact_clip_tpu.configs.utils import cfg2flatdict as jax_flat
from fact_clip_tpu.configs.utils import setup_cfg as jax_setup_cfg
from fact_clip_tpu.configs.utils import update_from as jax_update_from
from fact_clip_tpu_torch.configs import (CfgNode, cfg2flatdict, default_cfg, resolve_block_cfgs,
                                         setup_cfg, update_from, yaml_lite)
from fact_clip_tpu_torch.configs.node import _to_plain_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAMLS = sorted(glob.glob(os.path.join(REPO, "fact_clip_tpu", "configs", "*.yaml")))
OVERRIDES = ["lr", "0.0005", "batch_size", "3", "FACT.ntoken", "12", "Bu.hid_dim", "None",
             "aux.mark", "run-a", "TM.use", "off", "holdout_classes", "[1, 2]", "momentum", "1",
             "aux.runid", "2", "TPU.matcher", "host", "Loss.nullw", "0x10"]
SET_VALUES = ["true", "True", "yes", "On", "off", "NO", "y", "n", "~", "null", "NULL", "None",
              "none", "", "0x10", "-0x1F", "0b101", "012", "08", "0", "-0", "+5", "1_000",
              "0_", "1:30", "-1:30", "190:20:30", "1:3:5.5", "12:70", "1.5e-4", "1e-4", "1.5e4",
              "1.5E+4", "1e3", ".5", "-.5", "1.", "3.", "0.", "1_0.5_", ".inf", "-.Inf",
              "+.inf", "0.0001", "-1.0", "abc", "a b", "foo-bar", "/tmp/a-b/c.npy", "a:b",
              "x # comment", "a #b #c", "'quoted'", "'it''s'", "it's", '"dq \\n \\u00e9"',
              '"\\L\\P\\x41\\N\\_"',
              '"a#b"', "'a #b'", "[1, 2]", "[1,2]", "[ 1 , 2 ]", "[a, 'b', 1.0, [3, 4]]", "[]",
              "[a, ]", "a: b", "- 1", "-", "  spaced  ", "  # only a comment", "bfloat16",
              "openai/clip-vit-base-patch32"]
UNSUPPORTED = ["&a 1", "*a", "!!str 1", "|\n  text", ">\n  text", "{a: 1}", "[1, {a: 2}]",
               "a: 1\n  b: 2", "key: [1,\n  2]", "- a: 1", "2001-12-14", "---\na: 1", "<<"]


def _same(a, b) -> bool:
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("path", YAMLS, ids=os.path.basename)
def test_yaml_lite_reads_every_config_as_pyyaml_does(path):
    with open(path) as f:
        text = f.read()
    assert yaml_lite.safe_load(text) == yaml.safe_load(text)
    assert yaml_lite.load_file(path) == yaml.safe_load(text)


@pytest.mark.parametrize("value", SET_VALUES)
def test_yaml_lite_resolves_set_values_as_pyyaml_does(value):
    want, got = yaml.safe_load(value), yaml_lite.safe_load(value)
    if isinstance(want, list):
        assert len(got) == len(want) and all(map(_same, want, got)), (want, got)
    elif isinstance(want, dict):
        assert got == want
    else:
        assert _same(want, got), (want, got)


@pytest.mark.parametrize("text", UNSUPPORTED)
def test_yaml_lite_refuses_what_it_does_not_cover(text):
    with pytest.raises(yaml_lite.YamlError):
        yaml_lite.safe_load(text)


@pytest.mark.parametrize("sets", [None, OVERRIDES], ids=["plain", "overrides"])
@pytest.mark.parametrize("path", YAMLS, ids=os.path.basename)
def test_setup_cfg_equals_the_jax_packages(path, sets):
    want = jax_setup_cfg([path], list(sets) if sets else None)
    got = setup_cfg([path], list(sets) if sets else None)
    assert isinstance(got, CfgNode)
    assert _to_plain_dict(got) == jax_plain(want)
    assert (got.aux.exp, got.aux.logdir) == (want.aux.exp, want.aux.logdir)
    assert cfg2flatdict(got) == jax_flat(want)


def test_setup_cfg_layers_two_files_and_base():
    """``havid_tpu.yaml`` names ``havid.yaml`` as its ``_BASE_``; two files
    merge in order; both name the experiment as JAX does."""
    files = [os.path.join(REPO, "fact_clip_tpu", "configs", f)
             for f in ("havid_tpu.yaml", "havid_view0_lh_pt_holdout.yaml")]
    assert _to_plain_dict(setup_cfg(files)) == jax_plain(jax_setup_cfg(files))


@pytest.mark.parametrize("sets, exc", [(["FACT.nope", "1"], KeyError), (["nope", "1"], KeyError),
                                       (["lr", "1e-4"], TypeError),
                                       (["batch_size", "x"], TypeError)])
def test_setup_cfg_refuses_as_the_jax_package_does(sets, exc):
    with pytest.raises(exc):
        jax_setup_cfg([YAMLS[0]], list(sets))
    with pytest.raises(exc):
        setup_cfg([YAMLS[0]], list(sets))


def test_odd_set_list_drops_the_last_token_as_jax_does():
    sets = ["lr", "0.001", "batch_size"]
    assert _to_plain_dict(setup_cfg([YAMLS[0]], sets)) == jax_plain(jax_setup_cfg([YAMLS[0]], sets))


def test_base_cycle_is_refused(tmp_path):
    (tmp_path / "a.yaml").write_text("_BASE_: b.yaml\nlr: 0.1\n")
    (tmp_path / "b.yaml").write_text("_BASE_: a.yaml\n")
    with pytest.raises(ValueError, match="Circular"):
        setup_cfg([str(tmp_path / "a.yaml")])


def test_default_cfg_is_the_jax_default_tree():
    from fact_clip_tpu.configs.default import get_cfg_defaults

    assert default_cfg() == jax_plain(get_cfg_defaults())


def test_update_from_equals_jax():
    cfg = setup_cfg([YAMLS[0]], ["aux.mark", "a #b: c", "Bu.hid_dim", "None"])
    jcfg = jax_setup_cfg([YAMLS[0]], ["aux.mark", "a #b: c", "Bu.hid_dim", "None"])
    want = jax_plain(jax_update_from(jcfg.Bu, jcfg.Bi))
    assert _to_plain_dict(update_from(cfg.Bu, cfg.Bi)) == want
    assert json.loads(str(cfg)) == _to_plain_dict(cfg)


@pytest.mark.parametrize("name", ["havid.yaml", "breakfast.yaml", "egoprocel.yaml", "gtea.yaml"])
def test_block_cfgs_take_the_tree(name, monkeypatch):
    """``resolve_block_cfgs`` takes the ``setup_cfg`` tree and its plain dict
    alike, and resolves as JAX resolves its own tree."""
    import dataclasses

    from fact_clip_tpu.models import blocks as jblocks

    monkeypatch.setattr(jblocks, "_PALLAS_PLATFORM_OVERRIDE", "tpu")
    path = os.path.join(REPO, "fact_clip_tpu", "configs", name)
    cfg = setup_cfg([path])
    got = resolve_block_cfgs(cfg)
    assert got == resolve_block_cfgs(_to_plain_dict(cfg))
    assert [dataclasses.asdict(c) for c in got] == \
        [dataclasses.asdict(c) for c in jblocks.resolve_block_cfgs(jax_setup_cfg([path]))]
