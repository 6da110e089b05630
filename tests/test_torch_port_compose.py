"""K7 and the lazy verb/noun composition in the port, on the CPU.

* The plain versions (``ops/compose_decode.py``, reached through
  ``ops/verbnoun_compose.py``) equal the JAX package's XLA functions
  exactly: ``composed_argmax``, ``composed_argmax_factored``,
  ``composed_gather``, ``build_factored_tables`` and the dense
  ``composed_decode`` at weights 0, 0.5 and 1 with an all-null video, which
  also equals ``decode_two_branch_logp`` on the dense composition.
* They agree on at least 0.999 of the frames with the Pallas kernels
  (``mxu_argmax``, ``blend_argmax``, ``factored_argmax``) in interpret mode
  at tile 64, the threshold of the JAX package's own kernel tests.
* ``configs.epic_vocab()`` is ``scripts/bench_epic.py::epic_recipe``'s draw.
* The wrappers refuse what their kernels do not take before any launch.

Inputs are log-Dirichlet rows from a seeded numpy generator, as the JAX
package's ``_vn_fixture`` makes them, plus normal rows (wider gaps).
"""

import importlib.util
import os
import unittest.mock as mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fact_clip_tpu_torch
from fact_clip_tpu.models import decode as jdecode
from fact_clip_tpu.ops import verbnoun_compose as jvc
from fact_clip_tpu.ops.pallas import compose_decode as jcd
from fact_clip_tpu_torch import _build
from fact_clip_tpu_torch.configs import epic_vocab
from fact_clip_tpu_torch.models import decode as pdecode
from fact_clip_tpu_torch.ops import compose_decode as k7
from fact_clip_tpu_torch.ops import verbnoun_compose as pvc

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N1, N2, N_ACT, B, T, M = 13, 29, 97, 2, 200, 7


def _fixture(seed=0, dirichlet=True):
    rng = np.random.default_rng(seed)
    vids, nids = epic_vocab(N1, N2, N_ACT, seed=seed)
    if dirichlet:
        lv = np.log(rng.dirichlet(np.ones(N1), size=(B, T))).astype(np.float32)
        ln = np.log(rng.dirichlet(np.ones(N2), size=(B, T))).astype(np.float32)
    else:
        lv = rng.standard_normal((B, T, N1)).astype(np.float32)
        ln = rng.standard_normal((B, T, N2)).astype(np.float32)
    alogp = np.log(rng.dirichlet(np.ones(N_ACT + 1), size=(B, M))).astype(np.float32)
    attn = rng.standard_normal((B, T, M)).astype(np.float32)
    alogp[1, :, :-1] -= 50.0  # video 1: every token predicts null -> the fallback
    return dict(vids=vids, nids=nids, lv=lv, ln=ln, alogp=alogp, attn=attn)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _j(a):
    return jnp.asarray(a)


@pytest.mark.parametrize("dirichlet", [True, False])
def test_plain_composed_argmax_equals_jax(dirichlet):
    f = _fixture(1, dirichlet)
    ref = np.asarray(jvc.composed_argmax(_j(f["lv"]), _j(f["ln"]), _j(f["vids"]), _j(f["nids"])))
    for kernel in (False, True):  # the kernel wrapper runs the plain version on CPU tensors
        got = pvc.composed_argmax(_t(f["lv"]), _t(f["ln"]), _t(f["vids"]), _t(f["nids"]),
                                  kernel=kernel)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), ref)
    assert fact_clip_tpu_torch.kernel_counters()["compose_argmax"] == 0


@pytest.mark.parametrize("dirichlet", [True, False])
def test_plain_factored_argmax_and_tables_equal_jax(dirichlet):
    f = _fixture(2, dirichlet)
    mvn, at = pvc.build_factored_tables(f["vids"], f["nids"], N1, N2)
    jmvn, jat = jvc.build_factored_tables(f["vids"], f["nids"], N1, N2)
    np.testing.assert_array_equal(mvn, jmvn)
    np.testing.assert_array_equal(at, jat)
    ref = np.asarray(jvc.composed_argmax_factored(_j(f["lv"]), _j(f["ln"]), _j(jmvn), _j(jat)))
    got = pvc.composed_argmax_factored(_t(f["lv"]), _t(f["ln"]), _t(mvn), _t(at))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert fact_clip_tpu_torch.kernel_counters()["factored_argmax"] == 0
    # exact, with ties broken verb first: equal to the composed argmax but at ties
    dense = pvc.composed_argmax(_t(f["lv"]), _t(f["ln"]), _t(f["vids"]), _t(f["nids"]))
    assert float((got == dense).float().mean()) >= 0.999


def test_composed_gather_equals_jax():
    f = _fixture(3)
    idx = np.random.default_rng(3).integers(0, N_ACT, (B, T)).astype(np.int32)
    ref = jvc.composed_gather(_j(f["lv"]), _j(f["ln"]), _j(f["vids"]), _j(f["nids"]), _j(idx))
    got = pvc.composed_gather(_t(f["lv"]), _t(f["ln"]), _t(f["vids"]), _t(f["nids"]), _t(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("weight", [0.0, 0.5, 1.0])
def test_plain_composed_decode_equals_jax(weight):
    f = _fixture(4)
    tm = np.ones((B, M), bool)
    args = ("alogp", "attn", "lv", "ln", "vids", "nids")
    ref = np.asarray(jvc.composed_decode(*[_j(f[k]) for k in args], weight, _j(tm)))
    assert (np.asarray(jnp.argmax(_j(f["alogp"][1]), -1)) == N_ACT).all()  # all null
    for kernel in (False, True):
        got = pvc.composed_decode(*[_t(f[k]) for k in args], weight, _t(tm), kernel=kernel)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), ref)
    # the dense verb/noun decode, in both packages, on the composed frame log-probs
    dense = f["lv"][..., f["vids"]] + f["ln"][..., f["nids"]]
    jref = jdecode.decode_two_branch_logp(_j(f["alogp"]), _j(f["attn"]), _j(dense), weight,
                                          _j(tm))
    pref = pdecode.decode_two_branch_logp(_t(f["alogp"]), _t(f["attn"]), _t(dense), weight,
                                          _t(tm))
    np.testing.assert_array_equal(pref.numpy(), np.asarray(jref))
    np.testing.assert_array_equal(pref.numpy(), ref)


def test_plain_argmax_agrees_with_the_pallas_mxu_kernel():
    f = _fixture(5)
    got = jcd.mxu_argmax(_j(f["lv"]), _j(f["ln"]), _j(f["vids"]), _j(f["nids"]), tile=64,
                         interpret=True)
    plain = k7.compose_argmax_reference(_t(f["lv"]), _t(f["ln"]), _t(f["vids"]), _t(f["nids"]))
    assert float((plain.numpy() == np.asarray(got)).mean()) >= 0.999


def test_plain_factored_argmax_agrees_with_the_pallas_kernel():
    f = _fixture(6)
    mvn, at = pvc.build_factored_tables(f["vids"], f["nids"], N1, N2)
    got = jcd.factored_argmax(_j(f["lv"]), _j(f["ln"]), _j(mvn), _j(at), tile=64,
                              interpret=True)
    plain = k7.factored_argmax_reference(_t(f["lv"]), _t(f["ln"]), _t(mvn), _t(at))
    assert float((plain.numpy() == np.asarray(got)).mean()) >= 0.999


@pytest.mark.parametrize("weight", [0.5, 0.0, 1.0])
def test_plain_decode_agrees_with_the_pallas_blend_kernel(weight):
    f = _fixture(7)
    tm = np.ones((B, M), bool)
    args = ("alogp", "attn", "lv", "ln", "vids", "nids")

    def interp(orig):
        def fn(*a, **kw):
            return orig(*a, **dict(kw, interpret=True, tile=64))
        return fn

    with mock.patch.object(jcd, "blend_argmax", interp(jcd.blend_argmax)):
        got = jvc.composed_decode(*[_j(f[k]) for k in args], weight, _j(tm), pallas=True)
    plain = pvc.composed_decode(*[_t(f[k]) for k in args], weight, _t(tm))
    assert float((plain.numpy() == np.asarray(got)).mean()) >= 0.999


def test_epic_vocab_is_bench_epics_draw():
    spec = importlib.util.spec_from_file_location(
        "bench_epic", os.path.join(REPO, "scripts", "bench_epic.py"))
    bench_epic = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench_epic)
    _, vids, nids, n1, n2, n_act, D = bench_epic.epic_recipe(False)
    got_v, got_n = epic_vocab()
    assert (n1, n2, n_act, D) == (98, 301, 3806, 1024)
    assert got_v.dtype == np.int32 and got_n.dtype == np.int32
    np.testing.assert_array_equal(got_v, vids)
    np.testing.assert_array_equal(got_n, nids)
    assert got_v.max() == 97 and got_n.max() == 300


def test_wrappers_refuse_what_the_kernels_do_not_take_before_any_launch(monkeypatch):
    def no_lib():
        raise AssertionError("the kernel library was asked for")

    monkeypatch.setattr(_build, "lib", no_lib)
    meta = lambda *s, dt=torch.float32: torch.empty(s, device="meta", dtype=dt)  # noqa: E731
    ids = meta(3806, dt=torch.int32)
    lv, ln = meta(1, 64, 98), meta(1, 64, 301)
    with pytest.raises(ValueError, match="int32"):
        k7.compose_argmax(lv, ln, meta(3806, dt=torch.int64), ids)
    with pytest.raises(ValueError, match="lv"):
        k7.compose_argmax(lv, meta(2, 64, 301), ids, ids)
    with pytest.raises(NotImplementedError, match="n_act=60000"):
        k7.compose_argmax(lv, ln, meta(60000, dt=torch.int32), meta(60000, dt=torch.int32))
    with pytest.raises(ValueError, match="act_idx"):
        k7.compose_blend(lv, ln, ids, ids, meta(1, 300, 3806), meta(1, 64, dt=torch.int64), 0.1)
    with pytest.raises(NotImplementedError, match="n1=300"):
        k7.factored_argmax(meta(1, 64, 300), meta(1, 64, 1000), meta(300, 1000),
                           meta(300, 1000, dt=torch.int32))
    # epic's shapes fit
    assert k7.compose_smem(98, 301, 3806) <= _build.MAX_SMEM
    assert k7.factored_smem(98, 301) <= _build.MAX_SMEM
