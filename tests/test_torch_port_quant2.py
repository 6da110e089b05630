"""K8e, the port's int8 MS-TCN++ tower (``f: m2`` with ``TPU.quantize_infer:
"int8"``), against the JAX package on the CPU.

``fact_clip_tpu_torch/ops/quant_conv.py::mstcn2_stack_q8`` runs its plain
PyTorch version on CPU tensors; here it is held against
``fact_clip_tpu/ops/pallas/quant_conv.py::dilated_residual2_stack_q8`` in
interpret mode on inputs made with numpy from a seed.  The integer products
are exact on both sides and the plain version rounds as XLA's CPU backend
computes JAX's kernel (each dequantization's product-plus-bias one FMA, the
fuse ``fma(h1, s1 swt, h2 (s2 swb))``), so >= 99.9 % of the output is
bit-equal with a relative L2 error <= 1e-4, and padded frames are exactly 0.
The tile scales s1 and s2 are read out of JAX's kernel as it runs and held
equal to the plain version's, on a tile that a video ends inside.  The
Breakfast and Epic-Kitchens int8 configurations resolve as JAX's do.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from fact_clip_tpu.configs.utils import setup_cfg
from fact_clip_tpu.models import blocks as jblocks
from fact_clip_tpu.ops.pallas import quant_conv as jqc
from fact_clip_tpu_torch.configs import (breakfast_cfg, breakfast_int8_cfg, epic_cfg,
                                         epic_int8_cfg, resolve_block_cfgs)
from fact_clip_tpu_torch.ops import quant_conv as qc

torch.set_num_threads(2)
CFG_DIR = "fact_clip_tpu/configs/"


def _pair(rng, shape, scale=1.0):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _tower2_inputs(rng, B, T, C, dil_pairs, lengths):
    x_j, x_t = _pair(rng, (B, T, C))
    layers_j, layers_t = [], []
    for _ in dil_pairs:
        parts = [_pair(rng, s, sc) for s, sc in [((3, C, C), 0.08), ((C,), 0.3), ((3, C, C), 0.08),
                                                 ((C,), 0.3), ((C, C), 0.1), ((C, C), 0.1),
                                                 ((C,), 0.05)]]
        layers_j.append(tuple(p[0] for p in parts))
        layers_t.append(tuple(p[1] for p in parts))
    lengths = np.array(lengths, np.int32)
    mask = np.arange(T)[None] < lengths[:, None]
    return x_j, x_t, layers_j, layers_t, lengths, mask


# (T, tile, dilation pairs, lengths): a pair past the tile of 32; the default
# tile of 512 at T = 1100 (three JAX tiles, the d = 512 window of a tile
# reaching across its neighbours)
CASES = {"t70_tile32": (70, 32, ((64, 1), (8, 2), (2, 8), (1, 64)), (70, 50)),
         "t1100_tile512": (1100, 512, ((512, 1), (64, 8), (1, 512)), (1100, 700))}


@pytest.mark.parametrize("case", list(CASES))
def test_k8e_tower_matches_pallas_interpret(case):
    T, tile, dil, lens = CASES[case]
    rng = np.random.default_rng(7)
    B, C = 2, 32 if T < 512 else 16
    x_j, x_t, lj, lt, lengths, mask = _tower2_inputs(rng, B, T, C, dil, lens)
    ref = np.asarray(jqc.dilated_residual2_stack_q8(x_j, jnp.asarray(mask), lj, dil, tile=tile,
                                                    interpret=True))
    got = qc.mstcn2_stack_q8(x_t, torch.from_numpy(lengths), qc.quantize_tower2(lt), dil,
                             tile=tile).numpy()
    assert got.shape == (B, T, C) and np.isfinite(got).all()
    np.testing.assert_array_equal(got[1, lens[1]:], 0.0)  # padded frames exactly 0
    assert np.mean(got == ref) >= 0.999, np.mean(got == ref)
    assert _rel(got, ref) <= 1e-4


def test_k8e_layout_equals_jax_quantizers():
    """quantize_tower2 keeps JAX's int8 weights and scales, once each, in the
    kernel's (out, in) layout."""
    rng = np.random.default_rng(8)
    _, _, lj, lt, _, _ = _tower2_inputs(rng, 1, 8, 24, ((1, 1),), (8,))
    (k1, b1, k2, b2, wt, wb, bf), = lj
    ql, = qc.quantize_tower2(lt)
    for (q, s), qkt, sk in [(jqc.quantize_weight_joint(k1), ql.qk1t, ql.sk1),
                            (jqc.quantize_weight_joint(k2), ql.qk2t, ql.sk2)]:
        np.testing.assert_array_equal(qkt.numpy(),
                                      np.asarray(q).transpose(2, 0, 1).reshape(24, 72))
        np.testing.assert_array_equal(sk.numpy(), np.asarray(s))
    for (q, s), qt, sc in [(jqc.quantize_weight(wt), ql.qwtt, ql.swt),
                           (jqc.quantize_weight(wb), ql.qwbt, ql.swb)]:
        np.testing.assert_array_equal(qt.numpy(), np.asarray(q).T)
        np.testing.assert_array_equal(sc.numpy(), np.asarray(s))
    assert ql.qk1t.dtype == ql.qwtt.dtype == torch.int8 and ql.qwtt.is_contiguous()


class _MaxSpy:
    """Stands in for ``jnp`` inside ``quant_conv.py`` and records each
    whole-array ``jnp.max`` of the tile-mode kernel with its grid cell: per
    cell the window scale s_x, then s1 and s2 (before the 1e-12 floor).  The
    kernel is traced once per layer, so the trace-time count of calls names
    the layer and the scale."""

    def __init__(self):
        self.calls, self.seen = 0, {}

    def __getattr__(self, name):
        return getattr(jnp, name)

    def _record(self, layer, which, b, t, v):
        self.seen[(layer, which, int(b), int(t))] = float(v)

    def max(self, v, *args, **kw):
        m = jnp.max(v, *args, **kw)
        if args or kw:  # the weight quantizers' per-channel maxima, outside the kernel
            return m
        layer, which = divmod(self.calls, 3)
        self.calls += 1
        jax.debug.callback(functools.partial(self._record, layer, which), pl.program_id(0),
                           pl.program_id(1), m)
        return m


def _valid_tile_max(x, lengths, ql, pair, tile, T_pad):
    """max |c_k| of video 1's tile 1 over its valid rows only (k = 1, 2), as
    the plain version computes c_k."""
    B, T, C = x.shape
    xp = torch.zeros((B, T_pad, C))
    xp[:, :T] = x
    rows = xp.abs().amax(dim=-1)
    halo = -(-max(pair) // 8) * 8
    s_x = rows[1, max(0, tile - halo): min(T_pad, 2 * tile + halo)].amax().clamp_min(1e-12)
    out = []
    for qkt, sk, b, d in ((ql.qk1t, ql.sk1, ql.b1, pair[0]), (ql.qk2t, ql.sk2, ql.b2, pair[1])):
        taps = [torch.round(qc._shift(xp, (k - 1) * d) * qc._div(127.0, s_x)) for k in range(3)]
        c = qc._fma(qc._idot(torch.cat(taps, dim=-1), qkt.t()), s_x * sk, b)
        out.append(c[1, tile: int(lengths[1])].abs().max())
    return torch.stack(out)


def test_k8e_tile_scales_equal_jax_where_a_video_ends_inside_a_tile(monkeypatch):
    """Video 1 ends at frame 50, inside the second tile of 32 (rows 32-63):
    s1 and s2 of that tile take its padded rows too (there c_k is b_k plus the
    taps of the valid frames within d_k; the third tile, 64-71, lies wholly
    past the video).  The inputs make a padded row hold a tile's maximum:
    the video's last frame is large and layer 0's d2 = 1 conv weighs its
    left tap most, so row 50 (whose left tap is frame 49) outgrows every
    valid row of the tile."""
    T, tile, dil, lens = CASES["t70_tile32"]
    rng = np.random.default_rng(9)
    x_j, _, lj, _, lengths, mask = _tower2_inputs(rng, 2, T, 32, dil, lens)
    x = np.array(x_j)
    x[1, lens[1] - 1] *= 20.0
    k2 = np.array(lj[0][2])
    k2[0] *= 10.0
    lj[0] = lj[0][:2] + (jnp.asarray(k2),) + lj[0][3:]
    lt = [tuple(torch.from_numpy(np.array(p)) for p in layer) for layer in lj]
    x_t = torch.from_numpy(x)
    spy = _MaxSpy()
    monkeypatch.setattr(jqc, "jnp", spy)
    jax.block_until_ready(jqc.dilated_residual2_stack_q8(jnp.asarray(x), jnp.asarray(mask), lj,
                                                         dil, tile=tile, interpret=True))
    monkeypatch.undo()
    L, n_tiles = len(dil), 3
    assert spy.calls == 3 * L and len(spy.seen) == 3 * L * 2 * n_tiles
    jax_s = np.zeros((L, 3, 2, n_tiles), np.float32)  # (layer, s_x / s1 / s2, video, tile)
    for (i, which, b, t), v in spy.seen.items():
        jax_s[i, which, b, t] = v
    ql = qc.quantize_tower2(lt)
    lens_t = torch.from_numpy(lengths)
    _, _, tile_max = qc.mstcn2_stack_q8_reference(x_t, lens_t, ql, dil, tile=tile, scales=True)
    np.testing.assert_array_equal(tile_max.numpy(), jax_s[:, 1:])
    # over its valid rows only, layer 0's c2 of video 1's tile 1 has a smaller max
    c_valid = _valid_tile_max(x_t * torch.from_numpy(mask)[..., None], lengths, ql[0], dil[0],
                              tile, 72)
    assert c_valid[1] < tile_max[0, 1, 1, 1], (c_valid, tile_max[0, :, 1, 1])


@pytest.mark.parametrize("name", ["breakfast", "epic"])
def test_m2_int8_configs_equal_the_jax_package_field_for_field(monkeypatch, name):
    """``breakfast_int8_cfg()`` / ``epic_int8_cfg()`` resolve as JAX resolves
    its YAML with ``TPU.quantize_infer: "int8"`` and Pallas on: every block
    quantizes; and each is its f32 configuration with the one key."""
    monkeypatch.setattr(jblocks, "_PALLAS_PLATFORM_OVERRIDE", "tpu")
    yaml, int8_cfg, f32_cfg = {"breakfast": ("breakfast.yaml", breakfast_int8_cfg, breakfast_cfg),
                               "epic": ("epic-kitchens.yaml", epic_int8_cfg, epic_cfg)}[name]
    jcfg = setup_cfg([CFG_DIR + yaml])
    jcfg.TPU.quantize_infer = "int8"
    ref = jblocks.resolve_block_cfgs(jcfg)
    got = resolve_block_cfgs(int8_cfg())
    assert [dataclasses.asdict(c) for c in got] == [dataclasses.asdict(c) for c in ref]
    assert {c.quantize for c in got} == {"int8"} and {c.f for c in got} == {"m2"}
    a, b = int8_cfg(), f32_cfg()
    assert a["TPU"].pop("quantize_infer") == "int8" and b["TPU"].pop("quantize_infer") == ""
    assert a == b


def test_k8e_refuses_gradients_and_odd_widths():
    """A gradient is refused; a width of no multiple of 32 (C = 48) is taken:
    the card's packs pad each tap's K segment to whole 32-byte steps (64)
    with zeros and keep the weights of the plain layout."""
    x = torch.ones(1, 8, 16, requires_grad=True)
    k, v = torch.ones(3, 16, 16), torch.zeros(16)
    ql = qc.quantize_tower2([(k, v, k, v, torch.ones(16, 16), torch.ones(16, 16), v)])
    lens = torch.tensor([8], dtype=torch.int32)
    with pytest.raises(NotImplementedError):
        qc.mstcn2_stack_q8(x, lens, ql, [(1, 1)])
    rng = np.random.default_rng(12)
    _, _, _, lt, _, _ = _tower2_inputs(rng, 1, 8, 48, ((1, 1),), (8,))
    q48, = qc.quantize_tower2(lt)
    assert qc.k8e_layout(48) == (64, 192, 128, 128)
    assert q48.kpack.shape == (2, 48, 192) and q48.fpack.shape == (2, 48, 128)
    for k in range(3):
        np.testing.assert_array_equal(q48.kpack[0, :, 64 * k:64 * k + 48].numpy(),
                                      q48.qk1t[:, 48 * k:48 * k + 48].numpy())
        assert not q48.kpack[:, :, 64 * k + 48:64 * k + 64].any()
    assert not q48.fpack[:, :, 48:].any()
