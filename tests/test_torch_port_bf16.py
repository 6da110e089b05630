"""Mixed precision (``TPU.compute_dtype: bfloat16``) in the port, on the CPU.

The port's plain bf16 path (what its kernel wrappers run on CPU tensors, the
plain versions of K1-K4's bf16 forms, and the layers' cast sites) is held
against JAX's bf16 path: JAX's Pallas kernels in interpret mode, as
``tests/test_pallas_kernels.py`` runs them, on inputs made with numpy from a
seed.  Module by module (the K1 tower, K2's small-X and flash forms, K3, K4's
two sublayers, ``process_feature``), then a narrow ``iuUU`` (``small_cfg()``
with ``compute_dtype: bfloat16``) through the exporter's weights, its
``Predictor`` and ``evaluate``; the bf16 path against the port's own f32
path; each refusal of what this slice has no bf16 path for.

Tolerances:
* a bf16 output of one call or one tower layer: within 2 bf16 ulps of JAX's
  (both round the same f32 sums, summed in another order);
* a whole 10-layer tower's logits, and f32 outputs: within 1e-2 of their
  scale (max |ref|): one-ulp flips of the bf16 stream compound over layers;
* the narrow model's f32 logits: within 2e-2 of scale, and at least 95 % of
  the frame predictions equal (argmaxes over bf16 probabilities tie);
* bf16 against the port's f32 path: 0.05 of scale, JAX's own bound
  (``tests/test_mixed_precision.py:48-65``).
"""

import types
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _make_cfg
from fact_clip_tpu.models import blocks as jblocks
from fact_clip_tpu.models import decode as jdecode
from fact_clip_tpu.ops.pallas import dilated_conv as jdc
from fact_clip_tpu.ops.pallas import mha_attn as jmha
from fact_clip_tpu.ops.pallas import sa_layer as jsa
from fact_clip_tpu.ops.pallas import x2y_attn as jx2y
from fact_clip_tpu_torch import kernel_counters
from fact_clip_tpu_torch.configs import (bf16_refusal, epic_cfg, havid_tpu_cfg,
                                         openvocab_cfg, resolve_block_cfgs, small_cfg)
from fact_clip_tpu_torch.engine.serve import Predictor
from fact_clip_tpu_torch.configs import setup_cfg
from fact_clip_tpu_torch.engine import train_loop as tl
from fact_clip_tpu_torch.engine.steps import make_eval_step, make_train_step
from fact_clip_tpu_torch.models import blocks as pblocks
from fact_clip_tpu_torch.models.blocks import build_fact
from fact_clip_tpu_torch.ops import dilated_conv as dc
from fact_clip_tpu_torch.ops import mha_attn as ma
from fact_clip_tpu_torch.ops import sa_layer as sl
from fact_clip_tpu_torch.ops import x2y_attn as xa
from fact_clip_tpu_torch.utils.bridge import load_jax_params

torch.set_num_threads(2)
BF = jnp.bfloat16
ULPS = 2  # bf16 outputs of one call or layer
TOWER_TOL = 1e-2  # a whole tower's logits, and f32 outputs, of their scale
MODEL_TOL = 2e-2  # the narrow model's f32 logits, of their scale
MIN_AGREE = 0.95  # the narrow model's frame predictions
F32_TOL = 0.05  # bf16 against f32, of scale (test_mixed_precision.py)


def _ulps(got, ref):
    """Largest distance in bf16 ulps (of the reference's magnitude) between two
    bf16 arrays given as float32."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 2.0 ** -126))) - 7)
    return float(np.max(np.abs(got - ref) / ulp))


def _rel(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _pair16(rng, shape, scale=1.0):
    """The same bf16 values as a JAX array and a torch tensor."""
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    j = jnp.asarray(a).astype(BF)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)


def _pair(rng, shape, scale=1.0):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        jnp.asarray(t).astype(jnp.float32))


# ---------------------------------------------------------------------------
# module by module against JAX's kernels in interpret mode


def _tower(rng, C, O, L):
    """L layers (wd, bd, w1, b1, gamma, beta) and the out projection, f32."""
    layers = []
    for _ in range(L):
        layers.append([_pair(rng, (3, C, C), 1.0 / np.sqrt(3 * C)), _pair(rng, (C,), 0.1),
                       _pair(rng, (C, C), 1.0 / np.sqrt(C)), _pair(rng, (C,), 0.1),
                       (jnp.ones(C), torch.ones(C)), (jnp.zeros(C), torch.zeros(C))])
    return layers, _pair(rng, (C, O), 1.0 / np.sqrt(C)), _pair(rng, (O,), 0.1)


@pytest.mark.parametrize("L,C", [(1, 32), (10, 32), (3, 24)])
def test_k1_tower_matches_jax_interpret(L, C):
    """K1's plain bf16 tower against ``dilated_residual_stack`` with bf16
    x and weights (``layers.py:404-412``): one layer's bf16 stream within 2
    ulps (through an identity out projection, exact), the logits of L layers
    within 1e-2 of scale; padded frames of the stream zero."""
    rng = np.random.default_rng(L)
    B, T, O = 2, 200, 16
    x_j, x_t = _pair16(rng, (B, T, C))
    lengths = np.array([T, 133], np.int32)
    mask = np.arange(T)[None] < lengths[:, None]
    layers, (ow_j, ow_t), (ob_j, ob_t) = _tower(rng, C, O, L)
    dil = [2 ** i for i in range(L)]
    jl = [(wd[0].astype(BF), bd[0], w1[0].astype(BF), b1[0], g[0], be[0])
          for wd, bd, w1, b1, g, be in layers]
    tl = [tuple(p[1] for p in layer) for layer in layers]
    lens = torch.from_numpy(lengths)
    ref = jdc.dilated_residual_stack(x_j, jnp.asarray(mask), jl, dil, use_ln=False,
                                     out_params=(ow_j.astype(BF), ob_j), interpret=True)
    got = dc.mstcn_stack16(x_t, lens, tl, dil, out_w=ow_t, out_b=ob_t)
    assert got.dtype == torch.float32 and ref.dtype == jnp.float32
    assert _rel(got.numpy(), ref) <= TOWER_TOL, _rel(got.numpy(), ref)
    if L == 1:  # the layer's bf16 stream, through the identity
        stream_j = jdc.dilated_residual_stack(x_j, jnp.asarray(mask), jl, dil, use_ln=False,
                                              interpret=True)
        assert stream_j.dtype == BF
        eye = torch.eye(C)
        stream_t = dc.mstcn_stack16(x_t, lens, tl, dil, out_w=eye, out_b=torch.zeros(C))
        assert _ulps(stream_t.numpy(), _np(stream_j)) <= ULPS
        assert not stream_t.numpy()[~mask].any()


@pytest.mark.parametrize("X,batched", [(40, False), (17, True), (1100, False)])
def test_k2_forms_match_jax_interpret(X, batched):
    """Both of K2's forms (X <= 1024: small X; X = 1100: flash) in bf16
    against ``x2y_attention`` with bf16 y, x, positional terms and weights:
    attn, probs and logits f32 within 1e-2 of scale.  A video with x_len 0
    takes the small-X form only: JAX's flash kernel attends to its padded key
    rows there, the port (as JAX's plain version) to the X frames."""
    rng = np.random.default_rng(X)
    B, Y, C, d = 3, 96 if X < 1024 else 40, 32, 32
    y_j, y_t = _pair16(rng, (B, Y, C))
    x_j, x_t = _pair16(rng, (B, X, C))
    yp_j, yp_t = _pair16(rng, (B if batched else 1, Y, C), 0.5)
    xp_j, xp_t = _pair16(rng, (1, X, C), 0.5)
    w = [_pair(rng, s, sc) for s, sc in (((C, d), 0.2), ((d,), 0.1), ((C, d), 0.2), ((d,), 0.1),
                                         ((C, d), 0.2), ((d,), 0.1))]
    x_len = np.array([X, X // 2 + 1, 0 if X < 1024 else 7], np.int32)
    jw = [w[i][0].astype(BF) if i % 2 == 0 else w[i][0] for i in range(6)]
    ref = jx2y.x2y_attention(y_j, yp_j, x_j, xp_j, *jw, jnp.asarray(x_len), interpret=True)
    got = xa.x2y_attention16(y_t, yp_t, x_t, xp_t, *[p[1] for p in w], torch.from_numpy(x_len))
    for g, r, name in zip(got, ref, ("attn", "probs", "logits")):
        assert g.dtype == torch.float32 and r.dtype == jnp.float32, name
        assert _rel(g.numpy(), r) <= TOWER_TOL, (name, _rel(g.numpy(), r))


@pytest.mark.parametrize("M,X", [(11, 300), (40, 1100)])
def test_k3_matches_jax_interpret(M, X):
    """K3's plain bf16 version against ``mha_cross_attention`` with bf16 q,
    x, positional table and weights: the f32 output within 1e-2 of scale.
    (JAX's kernel pads the keys to its tile and a video with x_len 0 attends
    to the padding too; the port, as JAX's plain version, to the X frames.)"""
    rng = np.random.default_rng(M)
    B, Cx, E, H = 3, 64, 64, 2
    q_j, q_t = _pair16(rng, (B, M, E))
    x_j, x_t = _pair16(rng, (B, X, Cx))
    p_j, p_t = _pair16(rng, (1, X, Cx), 0.5)
    wk, bk, wv, bv = (_pair(rng, (Cx, E), 0.15), _pair(rng, (E,), 0.1),
                      _pair(rng, (Cx, E), 0.15), _pair(rng, (E,), 0.1))
    x_len = np.array([X, X // 3, 5], np.int32)
    ref = jmha.mha_cross_attention(q_j, x_j, p_j, wk[0].astype(BF), bk[0], wv[0].astype(BF),
                                   bv[0], jnp.asarray(x_len), num_heads=H, interpret=True)
    got = ma.mha_cross16_fwd(q_t, x_t, p_t, wk[1], bk[1], wv[1], bv[1], torch.from_numpy(x_len),
                             num_heads=H)
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), ref) <= TOWER_TOL, _rel(got.numpy(), ref)


def _sa_inputs(seed, B, M, E):
    rng = np.random.default_rng(seed)
    w = lambda *s: _pair(rng, s, 1.0 / np.sqrt(s[0]))  # noqa: E731
    parts = [_pair(rng, (B, M, E)), _pair(rng, (1, M, E), 0.5), w(E, E), _pair(rng, (E,), 0.05),
             w(E, E), _pair(rng, (E,), 0.05), w(E, E), _pair(rng, (E,), 0.05), w(E, E),
             _pair(rng, (E,), 0.05), _pair(rng, (E,), 0.1, ), _pair(rng, (E,), 0.1)]
    parts[10] = (parts[10][0] + 1.0, parts[10][1] + 1.0)
    return [p[0] for p in parts], [p[1] for p in parts]


@pytest.mark.parametrize("B,M,E,H", [(3, 11, 64, 2), (2, 40, 128, 4)])
def test_k4_sublayers_match_jax_interpret(B, M, E, H):
    """K4's plain bf16 SA and FFN sublayers against ``sa_sublayer`` /
    ``ffn_sublayer`` with ``bf16=True``: f32 outputs within 1e-2 of scale."""
    j, t = _sa_inputs(B + M, B, M, E)
    ref = jsa.sa_sublayer(*j, num_heads=H, bf16=True, interpret=True)
    got = sl.sa_sublayer16_fwd(*t, num_heads=H)
    assert _rel(got.numpy(), ref) <= TOWER_TOL, _rel(got.numpy(), ref)
    rng = np.random.default_rng(M)
    Fd = 2 * E
    w1, b1, w2, b2 = (_pair(rng, (E, Fd), E ** -0.5), _pair(rng, (Fd,), 0.1),
                      _pair(rng, (Fd, E), Fd ** -0.5), _pair(rng, (E,), 0.1))
    ref = jsa.ffn_sublayer(j[0], w1[0], b1[0], w2[0], b2[0], j[10], j[11], bf16=True,
                           interpret=True)
    got = sl.ffn_sublayer16_fwd(t[0], w1[1], b1[1], w2[1], b2[1], t[10], t[11])
    assert _rel(got.numpy(), ref) <= TOWER_TOL, _rel(got.numpy(), ref)


def test_process_feature_matches_jax():
    """The stream cast to bf16 with its softmax tail, the logits f32; with no
    dtype a bf16 stream promotes to f32 (JAX's action-token sites)."""
    rng = np.random.default_rng(5)
    f_j, f_t = _pair(rng, (2, 30, 24))
    for dtype_j, dtype_t in ((BF, torch.bfloat16), (None, None)):
        out_j, lg_j = jblocks.process_feature(f_j, 5, dtype_j)
        out_t, lg_t = pblocks.process_feature(f_t, 5, dtype_t)
        assert lg_t.dtype == torch.float32 and str(out_t.dtype).endswith(str(out_j.dtype))
        # the softmaxes differ by an f32 ulp, which may move a bf16 rounding
        if dtype_t is None:
            np.testing.assert_allclose(_np(out_t), _np(out_j), atol=1e-6)
        else:
            assert _ulps(_np(out_t), _np(out_j)) <= 1
        np.testing.assert_array_equal(lg_t.numpy(), np.asarray(lg_j))
    out_j, _ = jblocks.process_feature(f_j.astype(BF), 5)
    out_t, _ = pblocks.process_feature(f_t.to(torch.bfloat16), 5)
    assert out_j.dtype == jnp.float32 and out_t.dtype == torch.float32
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-7)


# ---------------------------------------------------------------------------
# the narrow model


D, C, S_CAP, B, T = 12, 5, 24, 2, 96


def _interp(fn):
    def f(*a, **kw):
        return fn(*a, **dict(kw, interpret=True))
    return f


def _bf16_cfg():
    cfg = small_cfg()
    cfg["TPU"]["compute_dtype"] = "bfloat16"
    return cfg


@pytest.fixture(scope="module")
def jax_run():
    """The JAX model under mixed precision with its Pallas kernels in
    interpret mode (the path the port's bf16 forms model)."""
    jcfg = _make_cfg(small=True)
    jcfg.TPU.compute_dtype = "bfloat16"
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((B, T, D)).astype(np.float32)
    lengths = np.array([96, 61], np.int32)
    mask = np.arange(T)[None] < lengths[:, None]
    feats[~mask] = 0.0
    args = (jnp.asarray(feats), jnp.asarray(mask), jnp.asarray(lengths))
    with mock.patch.object(jblocks, "_PALLAS_PLATFORM_OVERRIDE", "tpu"), \
            mock.patch.object(jdc, "dilated_residual_stack", _interp(jdc.dilated_residual_stack)), \
            mock.patch.object(jx2y, "x2y_attention", _interp(jx2y.x2y_attention)), \
            mock.patch.object(jmha, "mha_cross_attention", _interp(jmha.mha_cross_attention)), \
            mock.patch.object(jsa, "sa_sublayer", _interp(jsa.sa_sublayer)), \
            mock.patch.object(jsa, "ffn_sublayer", _interp(jsa.ffn_sublayer)):
        model = jblocks.build_fact(jcfg, D, C, s_pred_cap=S_CAP)
        assert {c.dtype for c in model.block_cfgs} == {"bfloat16"}
        assert all(c.pallas for c in model.block_cfgs)
        params = model.init({"params": jax.random.PRNGKey(0)}, *args, train=False)
        saves, _ = model.apply(params, *args, train=False)
    last = saves[-1]
    pred = jdecode.decode_two_branch(last["action_clogit"], last["a2f_attn"],
                                     last["frame_clogit"], float(jcfg.FACT.mwt),
                                     jnp.ones(last["action_clogit"].shape[:2], bool))
    return dict(params=jax.tree_util.tree_map(np.asarray, params["params"]), feats=feats,
                mask=mask, lengths=lengths, pred=np.asarray(pred),
                saves=[{k: np.asarray(v) for k, v in s.items() if k != "kind"} for s in saves])


def _port(jax_run, cfg=None):
    model = build_fact(cfg or _bf16_cfg(), D, C, S_CAP, device="cpu")
    load_jax_params(model, jax_run["params"])
    return model


def _inputs(jax_run):
    return [torch.from_numpy(jax_run[k]) for k in ("feats", "mask", "lengths")]


@pytest.mark.parametrize("kernels", [True, False])
def test_narrow_model_matches_jax(jax_run, kernels):
    """Every block's f32 frame and action logits within 2e-2 of scale, the
    decoded frames at least 95 % equal; no kernel launches on CPU tensors."""
    model = _port(jax_run)
    model.set_kernels(kernels)
    x = _inputs(jax_run)
    mask = jax_run["mask"]
    before = kernel_counters()
    with torch.no_grad():
        saves, tail = model(*x)
    assert kernel_counters() == before
    assert tail.dtype == torch.bfloat16
    for i, (sp, sj) in enumerate(zip(saves, jax_run["saves"])):
        for key in ("frame_clogit", "action_clogit"):
            got, ref = sp[key], sj[key]
            assert got.dtype == torch.float32
            got, ref = (got.numpy()[mask], ref[mask]) if key == "frame_clogit" else (
                got.numpy(), ref)
            assert _rel(got, ref) <= MODEL_TOL, (i, key, _rel(got, ref))
    pred = make_eval_step(model, 0.1)(*x).numpy()
    agree = float(np.mean(pred[mask] == jax_run["pred"][mask]))
    assert agree >= MIN_AGREE, agree


def test_predictor_matches_jax(jax_run):
    """The bf16 model served through ``Predictor`` (its requests cross in
    bf16): the decoded frames of each request at least 95 % equal to JAX's."""
    model = _port(jax_run)
    pred = Predictor(model, 0.1, batch_size=2, max_len=128, bucket_multiple=32)
    assert pred.feats_dtype == torch.bfloat16
    feats = [jax_run["feats"][i, :n] for i, n in enumerate(jax_run["lengths"])]
    out = pred.predict(feats)
    for i, n in enumerate(jax_run["lengths"]):
        agree = float(np.mean(out[i] == jax_run["pred"][i, :n]))
        assert out[i].shape == (n,) and agree >= MIN_AGREE, (i, agree)


def test_evaluate_matches_jax(jax_run, monkeypatch):
    """``evaluate`` (the test pass of the loop and ``run_eval``) on the bf16
    model: the features cross as bf16 (``TPU.feature_dtype`` "" follows the
    compute dtype), and each test video's saved predictions are at least 95 %
    JAX's."""
    model = _port(jax_run)
    cfg = setup_cfg([], ["TPU.compute_dtype", "bfloat16", "eval_bg", "true"])
    tl.check_loop_cfg(cfg, train=False)
    assert tl.feats_dtype(cfg) == torch.bfloat16
    n = len(jax_run["lengths"])
    labels = [np.zeros(int(t), np.int64) for t in jax_run["lengths"]]
    arrays = dict(feats=jax_run["feats"], mask=jax_run["mask"], lengths=jax_run["lengths"],
                  labels=np.zeros((B, T), np.int64), seg_label=np.zeros((B, 4), np.int64),
                  transcript=np.zeros((B, 4), np.int64), seg_mask=np.zeros((B, 4), bool))
    batch = types.SimpleNamespace(device_arrays=arrays, vnames=[f"v{i}" for i in range(n)],
                                  eval_labels=labels, lengths=jax_run["lengths"])
    crossed = []
    real = tl.batch_to_device

    def spy(a, device, fdt=torch.float32):
        crossed.append(fdt)
        return real(a, device, fdt)

    monkeypatch.setattr(tl, "batch_to_device", spy)
    exp = types.SimpleNamespace(cfg=cfg, model=model, test_loader=lambda: [batch],
                                test_dataset=types.SimpleNamespace(
                                    bg_class=[], holdout_classes=[], seen_classes=[]))
    ckpt = tl.evaluate(-2, exp, make_eval_step(model, 0.1), None, None)
    assert crossed == [torch.bfloat16]
    for i in range(n):
        got = np.asarray(ckpt.videos[f"v{i}"].pred)
        ref = jax_run["pred"][i, :jax_run["lengths"][i]]
        assert got.shape == ref.shape and float(np.mean(got == ref)) >= MIN_AGREE


def test_bf16_close_to_the_ports_f32(jax_run):
    """The bf16 path against the port's f32 path on the same weights: every
    block's logits within 0.05 of scale (JAX's own bound)."""
    m16 = _port(jax_run)
    m32 = _port(jax_run, small_cfg())
    x = _inputs(jax_run)
    with torch.no_grad():
        s16, _ = m16(*x)
        s32, _ = m32(*x)
    mask = jax_run["mask"]
    for a, b in zip(s16, s32):
        for key in ("frame_clogit", "action_clogit"):
            got, ref = a[key].numpy(), b[key].numpy()
            if key == "frame_clogit":
                got, ref = got[mask], ref[mask]
            assert _rel(got, ref) <= F32_TOL, (key, _rel(got, ref))


# ---------------------------------------------------------------------------
# the recipe and the refusals


def test_havid_tpu_cfg_is_the_yaml():
    """``havid_tpu_cfg()`` is havid_tpu.yaml over havid.yaml: the flagship's
    widths under bf16, every block's dtype bfloat16."""
    cfg = havid_tpu_cfg()
    assert cfg["TPU"]["compute_dtype"] == "bfloat16" and cfg["TPU"]["matcher"] == "auction"
    assert cfg["TPU"]["pallas"] and cfg["TPU"]["pallas_sa"]
    c = resolve_block_cfgs(cfg)
    assert [b.kind for b in c] == list("iuUU") and {b.dtype for b in c} == {"bfloat16"}
    assert (c[0].hid_dim, c[0].a_dim, c[0].f_dim, c[0].a_layers, c[0].a_nhead) == \
        (512, 256, 256, 6, 8)
    assert [b.f_layers for b in c] == [10, 10, 10, 10] and cfg["FACT"]["ntoken"] == 40
    assert bf16_refusal(cfg) is None


def _refused(cfg, match):
    with pytest.raises(NotImplementedError, match=match):
        resolve_block_cfgs(cfg)
    with pytest.raises(NotImplementedError, match=match):
        build_fact(cfg, D, C, S_CAP, device="cpu")


@pytest.mark.parametrize("case", ["m2", "int8", "clip", "trans", "verbnoun", "f_ln", "groups"])
def test_bf16_refuses_what_it_has_no_path_for(case):
    """Each config the port has no bf16 path for raises at build time, on
    either device, naming its ROADMAP item (no kernel can launch).  The
    MS-TCN++ tower (``m2``, K6's bf16 form) and grouped towers (``groups``,
    JAX's computation outside the kernels) have one: they resolve, build and
    run in bf16, giving finite f32 logits (``tests/test_torch_port_bf16_m2.py``
    holds them against JAX)."""
    cfg = _bf16_cfg()
    match = "M7 item"
    if case in ("m2", "groups"):
        if case == "m2":
            cfg["Bi"]["f"] = "m2"
        else:
            cfg["Bi"]["f_ngp"] = 2
        cfg["Bi"]["dropout"] = 0.0
        assert bf16_refusal(cfg) is None
        blocks = resolve_block_cfgs(cfg)
        assert {b.dtype for b in blocks} == {"bfloat16"}
        model = build_fact(cfg, D, C, S_CAP, device="cpu")
        rng = np.random.default_rng(1)
        lengths = np.array([T, 61], np.int32)
        feats = torch.from_numpy(rng.standard_normal((B, T, D)).astype(np.float32))
        mask = torch.from_numpy(np.arange(T)[None] < lengths[:, None])
        with torch.no_grad():
            saves, _ = model(feats.to(torch.bfloat16), mask, torch.from_numpy(lengths))
        for sv in saves:
            assert sv["frame_clogit"].dtype == torch.float32
            assert torch.isfinite(sv["frame_clogit"]).all()
        return
    if case == "int8":
        cfg["TPU"]["quantize_infer"] = "int8"
    elif case == "clip":
        cfg = openvocab_cfg()
    elif case == "trans":
        cfg["FACT"].update(trans=True, ntoken=0)
    elif case == "verbnoun":
        cfg = epic_cfg()
    else:
        cfg["Bi"]["f_ln"] = True
    cfg["TPU"]["compute_dtype"] = "bfloat16"
    _refused(cfg, match)
    if case == "verbnoun":
        from fact_clip_tpu_torch.configs import epic_vocab
        from fact_clip_tpu_torch.models.verbnoun import build_verbnoun_fact

        vids, nids = epic_vocab(4, 5, 10)
        cfg2 = _bf16_cfg()
        with pytest.raises(NotImplementedError, match="verb/noun"):
            build_verbnoun_fact(cfg2, D, vids, nids, S_CAP, 4, 5, device="meta")


def test_bf16_training_is_refused(jax_run):
    """What stays refused of bf16 training: dropout above 0 (small_cfg()'s
    0.1).  The train step, a train-mode forward and the loop's check refuse
    it before any launch (ROADMAP M7 item 5); bf16 trains at rate 0
    (``tests/test_torch_port_bf16_train.py``)."""
    model = _port(jax_run)
    cfg = _bf16_cfg()
    assert cfg["Bi"]["dropout"] > 0
    with pytest.raises(NotImplementedError, match="M7 item 5"):
        make_train_step(model, cfg, C, np.ones(C + 1, np.float32))
    x = _inputs(jax_run)
    before = kernel_counters()
    with pytest.raises(NotImplementedError, match="M7 item 5"):
        model(*x, train=True, generator=torch.Generator().manual_seed(0))
    assert kernel_counters() == before
    with pytest.raises(NotImplementedError, match="M7 item 5"):
        tl.check_loop_cfg(setup_cfg([], ["TPU.compute_dtype", "bfloat16", "Bi.dropout", "0.1"]))
