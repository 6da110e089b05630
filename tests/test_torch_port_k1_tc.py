"""K1 on the towers' tensor-core GEMM (``csrc/mstcn.cu``, ``csrc/tc_tower.cuh``) on the CPU.

K1's forward is two GEMMs a layer (the conv3 with the kRelu epilogue, the
1x1 with kResid: bias, the dropout hash, the residual, the write mask), a
LayerNorm row pass when ``use_ln`` and K6's kLogits GEMM for the out
projection; its backward is ``k1_dz`` (the LayerNorm backward, the keep mask
re-hashed), the kGate and kDx GEMMs and K6's weight-gradient products.  Here,
without a card, ``FakeK6Lib`` (``test_torch_port_k6_tc.py``: a model of the
kernels' C interface on the raw memory of CPU tensors, with their 3xTF32
arithmetic, tile skips and epilogues) stands in for the library, and the
port's own launch sequences (``_mstcn_fwd_card``, ``_mstcn_bwd_card``,
``_dr_layer_fwd_card``) are held against JAX's ``dilated_residual_stack``
with ``out_params`` and ``dilated_residual_layer`` in interpret mode, JAX's
VJP, and the f32 plain versions (dropout: on the port's mask).  Every
packed weight operand of K1 unpacks back to the JAX layout.

Tolerances: 1e-5 of max(1, the reference's largest value) on forward
values (without LayerNorm the residual stream grows to ~10 over three
layers) and 1e-5 of each gradient's largest value, as for K6: the split
keeps ~2^-22 of each product, f32 sums in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_k6_tc import FakeK6Lib, _bits, _close_split, _rna, _unpack  # noqa: F401

from fact_clip_tpu.ops.pallas.dilated_conv import dilated_residual_layer, dilated_residual_stack
from fact_clip_tpu_torch import _build
from fact_clip_tpu_torch.ops import dilated_conv as dc

torch.set_num_threads(2)
C, O = 64, 24
# lengths per T: tiles wholly past a video (T=300) and a video shorter than
# the largest dilation (3 and 41 frames at T=70; 100 at T=300)
RAGGED = {70: [70, 41, 3], 300: [300, 100, 129]}
DILATIONS = [1, 16, 128]


def _layer(rng, ln=True):
    def r(*s, scale=0.1):
        return torch.from_numpy((rng.standard_normal(s) * scale).astype(np.float32))

    gamma = 1.0 + r(C, scale=0.2) if ln else torch.ones(C)
    beta = r(C, scale=0.2) if ln else torch.zeros(C)
    return (r(3, C, C), r(C), r(C, C, scale=0.15), r(C), gamma, beta)


def _case(seed, T, lengths, n_layers=3, ln=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((len(lengths), T, C)).astype(np.float32)  # non-zero past each video
    layers = [_layer(rng, ln) for _ in range(n_layers)]
    ow = (rng.standard_normal((C, O)) * 0.2).astype(np.float32)
    ob = (rng.standard_normal(O) * 0.1).astype(np.float32)
    return torch.from_numpy(x), layers, torch.from_numpy(ow), torch.from_numpy(ob)


def _jax(t):
    return jnp.asarray(t.numpy())


@pytest.fixture
def fake(monkeypatch):
    lib = FakeK6Lib()
    monkeypatch.setattr(_build, "lib", lambda: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    return lib


def _close(got, ref, tol=1e-5):
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_allclose(got, ref, atol=tol * max(1.0, float(np.abs(ref).max())), rtol=0)


def _layer_calls(use_ln):
    return [("gemm", dc._RELU), ("gemm", dc._RESID)] + ([("ln",)] if use_ln else [])


@pytest.mark.parametrize("role", ["conv", "w1", "out_proj", "dc", "dx", "g_logits"])
def test_k1_packed_operands_unpack_to_the_jax_layout(role):
    rng = np.random.default_rng(1)
    wd, bd, w1, b1, gamma, beta = layer = _layer(rng)
    ow = torch.from_numpy(rng.standard_normal((C, O)).astype(np.float32))
    tol = 2.0 ** -22 * 0.6  # |weights| < 0.6
    if role == "conv":  # (hi / lo, out, tap * C + in)
        conv = dc.k1_fwd_weights(layer)[0]
        assert conv.shape == (2, C, 3 * C)
        _close_split(conv, wd.reshape(3 * C, C), transpose=True)
        back = _unpack(conv, True).reshape(3, C, C)  # (tap, in, out)
        assert float((back - wd).abs().max()) <= tol
        assert abs(float(conv[0, 5, 2 * C + 7] - wd[2, 7, 5])) <= 2.0 ** -11 * 0.6
    elif role == "w1":  # the 1x1: (hi / lo, out, in)
        w1p = dc.k1_fwd_weights(layer)[1]
        assert w1p.shape == (2, C, C)
        _close_split(w1p, w1, transpose=True)
    elif role == "out_proj":
        _close_split(dc.k6_pack(ow, True), ow, transpose=True)
    elif role == "dc":  # dc = dh W1^T: the rows of W1 are the GEMM's columns
        w1n = dc.k1_bwd_weights(layer)[0]
        assert w1n.shape == (2, C, C)
        _close_split(w1n, w1)
    elif role == "dx":  # dx = sum_k dc[s - (k-1)d] Wd[k]^T: (hi / lo, in, tap * C + out)
        taps = dc.k1_bwd_weights(layer)[1]
        assert taps.shape == (2, C, 3 * C)
        back = _unpack(taps).reshape(C, 3, C).permute(1, 0, 2)
        assert float((back - wd).abs().max()) <= tol
        _close_split(taps, torch.cat([wd[0], wd[1], wd[2]], dim=1))
    else:  # g = g_logits Wo^T
        _close_split(dc.k6_pack(ow), ow)


@pytest.mark.parametrize("use_ln", [True, False])
@pytest.mark.parametrize("form", ["serving", "training"])
@pytest.mark.parametrize("T", [70, 300])
def test_emulated_tower_matches_jax_interpret(fake, T, form, use_ln):
    """Three narrow K1 layers (C=64, dilations 1, 16, 128: taps past both
    ends of the short videos) with the out projection: the port's launches
    on the kernels' 3xTF32 arithmetic against JAX's kernel in interpret
    mode and the f32 plain version."""
    lengths = RAGGED[T]
    x, layers, ow, ob = _case(3, T, lengths, ln=use_ln)
    mask = np.arange(T)[None] < np.array(lengths)[:, None]
    ref_j = np.asarray(dilated_residual_stack(
        _jax(x), jnp.asarray(mask), [tuple(_jax(p) for p in layer) for layer in layers],
        DILATIONS, use_ln=use_ln, tile=32, interpret=True, out_params=(_jax(ow), _jax(ob))))
    lens = torch.tensor(lengths, dtype=torch.int32)
    save = form == "training"
    got = dc._mstcn_fwd_card(x, lens, layers, DILATIONS, use_ln, 1e-5, ow, ob, None, None, save)
    ref = dc.mstcn_stack_reference(x, lens, layers, DILATIONS, use_ln=use_ln, out_w=ow, out_b=ob,
                                   save=save)
    # two GEMMs a layer (and the LN pass), then the out projection
    assert fake.calls == _layer_calls(use_ln) * 3 + [("gemm", dc._LOGITS)]
    if save:
        valid = dc._frame_mask(x, lens)
        assert len(got[1]) == len(got[2]) == 3 and got[1][0] is x
        for g_, r_ in zip(got[1] + got[2], ref[1] + ref[2]):  # streams, then ReLU outputs
            _close((g_ * valid).numpy(), (r_ * valid).numpy())
        for h in got[2]:  # the saved h is zero past each video
            assert not (h * (1 - valid)).any()
        got, ref = got[0], ref[0]
    _close(got.numpy()[mask], ref_j[mask])
    _close(got.numpy()[mask], ref.numpy()[mask])
    # padded frames carry the bias row
    np.testing.assert_allclose(got.numpy()[~mask], np.broadcast_to(ob, (int((~mask).sum()), O)),
                               atol=1e-6)


@pytest.mark.parametrize("use_ln", [True, False])
def test_emulated_training_form_with_dropout(fake, use_ln):
    """Three layers, dropout 0.3 on the first and last (the hash in the 1x1's
    epilogue): the logits and every save against the plain version with the
    port's mask on the same seeds."""
    T, lengths = 300, RAGGED[300]
    x, layers, ow, ob = _case(4, T, lengths, ln=use_ln)
    lens = torch.tensor(lengths, dtype=torch.int32)
    rates, seeds = (0.3, 0.0, 0.3), torch.tensor([123457, 99, -5], dtype=torch.int32)
    got = dc._mstcn_fwd_card(x, lens, layers, DILATIONS, use_ln, 1e-5, ow, ob, rates, seeds, True)
    ref = dc.mstcn_stack_reference(x, lens, layers, DILATIONS, use_ln=use_ln, out_w=ow, out_b=ob,
                                   rates=rates, seeds=seeds, save=True)
    nodrop = dc.mstcn_stack_reference(x, lens, layers, DILATIONS, use_ln=use_ln, out_w=ow,
                                      out_b=ob)
    valid = dc._frame_mask(x, lens)
    _close((got[0] * valid).numpy(), (ref[0] * valid).numpy())
    assert float(((got[0] - nodrop) * valid).abs().max()) > 0.1  # the mask did act
    for g_list, r_list in zip(got[1:], ref[1:]):
        for g_, r_ in zip(g_list, r_list):
            _close((g_ * valid).numpy(), (r_ * valid).numpy())


def _flat(r):
    dx, dlayers, dow, dob = r
    return [dx, *[t for d in dlayers for t in d], dow, dob]


def _close_grads(got, ref, tol=1e-5):
    for i, (a, b) in enumerate(zip(_flat(got), _flat(ref))):
        assert a.shape == b.shape, i
        scale = max(float(b.abs().max()), 1e-6)
        assert float((a - b).abs().max()) <= tol * scale, (i, float((a - b).abs().max()) / scale)


@pytest.mark.parametrize("use_ln", [True, False])
def test_emulated_backward_matches_plain(fake, use_ln):
    """Three layers (the last layer's g = g_logits Wo^T, its recomputed
    output and dWo; middle layers), dropout 0.3 on two: dx and every weight
    gradient from the same saves against ``mstcn_stack_bwd_reference``; the
    keep masks are re-hashed in ``k1_dz`` (no mask kernel launches)."""
    T, lengths = 300, RAGGED[300]
    x, layers, ow, ob = _case(5, T, lengths, ln=use_ln)
    lens = torch.tensor(lengths, dtype=torch.int32)
    rates, seeds = (0.3, 0.0, 0.3), torch.tensor([7, 11, 13], dtype=torch.int32)
    kw = dict(use_ln=use_ln, out_w=ow, out_b=ob, rates=rates, seeds=seeds)
    _, streams, acts = dc.mstcn_stack_reference(x, lens, layers, DILATIONS, save=True, **kw)
    acts = [a.contiguous() for a in acts]  # the plain conv's output is (B, C, T) transposed
    g = torch.from_numpy(np.random.default_rng(6).standard_normal((3, T, O)).astype(np.float32))
    got = dc._mstcn_bwd_card(g, streams, acts, lens, layers, DILATIONS, use_ln, 1e-5, ow, ob,
                             rates, seeds)
    ref = dc.mstcn_stack_bwd_reference(g, streams, acts, lens, layers, DILATIONS, **kw)
    _close_grads(got, ref)
    # k1_dz once a layer; the LN output y for dWo on the last layer with LN only
    assert fake.calls.count(("dz", True)) == int(use_ln)
    assert fake.calls.count(("dz", False)) == 3 - int(use_ln)
    # the recompute of z: on the last layer, and on every layer with LN
    assert fake.calls.count(("gemm", dc._RESID)) == (3 if use_ln else 1)
    assert fake.calls.count(("gemm", dc._GATE)) == fake.calls.count(("gemm", dc._DX)) == 3
    assert fake.calls.count(("gemm", dc._MASKED)) == 1  # g = g_logits Wo^T, the last layer


def test_emulated_backward_matches_jax_vjp(fake):
    """The port's forward and backward launch sequences (LN, no dropout,
    ragged lengths, d=128 beyond the short videos) against ``jax.vjp`` of
    JAX's tower with its out projection in interpret mode: dx on valid
    frames and every parameter gradient."""
    T, lengths = 70, RAGGED[70]
    x, layers, ow, ob = _case(7, T, lengths)
    lens = torch.tensor(lengths, dtype=torch.int32)
    mask = jnp.asarray(np.arange(T)[None] < np.array(lengths)[:, None])
    g = np.random.default_rng(8).standard_normal((3, T, O)).astype(np.float32)

    def f(x_, layers_, ow_, ob_):
        return dilated_residual_stack(x_, mask, layers_, DILATIONS, use_ln=True, tile=32,
                                      interpret=True, out_params=(ow_, ob_))

    layers_j = [tuple(_jax(p) for p in layer) for layer in layers]
    _, vjp = jax.vjp(f, _jax(x), layers_j, _jax(ow), _jax(ob))
    dx_j, dl_j, dow_j, dob_j = vjp(jnp.asarray(g))
    _, streams, acts = dc._mstcn_fwd_card(x, lens, layers, DILATIONS, True, 1e-5, ow, ob, None,
                                          None, True)
    got = dc._mstcn_bwd_card(torch.from_numpy(g), streams, acts, lens, layers, DILATIONS, True,
                             1e-5, ow, ob, None, None)
    valid = dc._frame_mask(x, lens)
    ref = (torch.from_numpy(np.asarray(dx_j)) * valid,
           [tuple(torch.from_numpy(np.asarray(p)) for p in d) for d in dl_j],
           torch.from_numpy(np.asarray(dow_j)), torch.from_numpy(np.asarray(dob_j)))
    _close_grads(got, ref)


@pytest.mark.parametrize("use_ln,rate", [(True, 0.0), (False, 0.0), (True, 0.2)])
def test_emulated_single_layer_matches_jax_interpret(fake, use_ln, rate):
    """The single-layer K1 (every frame valid, dropout stream 0, d=16)
    through its launches: against JAX's ``dilated_residual_layer`` in
    interpret mode without dropout, against the plain version with the
    port's mask with dropout."""
    B, T, d = 2, 70, 16
    x, layers, _, _ = _case(9, T, [T] * B, n_layers=1, ln=use_ln)
    layer = layers[0]
    seed = torch.tensor([31337], dtype=torch.int32)
    kw = dict(dilation=d, use_ln=use_ln, eps=1e-5, rate=rate, seed=seed if rate else None)
    got = dc._dr_layer_fwd_card(x, *layer, d, use_ln, 1e-5, rate, seed if rate else None)
    assert fake.calls == _layer_calls(use_ln)
    ref = dc.dilated_residual_layer_reference(x, *layer, **kw)
    _close(got.numpy(), ref.numpy())
    if rate == 0.0:
        ref_j = dilated_residual_layer(_jax(x), *(_jax(p) for p in layer), dilation=d,
                                       use_ln=use_ln, tile=32, interpret=True)
        _close(got.numpy(), ref_j)


@pytest.mark.parametrize("entry", ["forward", "backward", "single_layer", "autograd"])
def test_k1_refuses_a_width_before_any_launch(monkeypatch, entry):
    """Off the CPU, a width outside ``has_tower_kernels`` (C % 4, O % 4: TMA
    row strides of 16 bytes) raises NotImplementedError naming it before the
    kernel library is built or loaded (meta tensors stand in for the card's);
    the zoo's MSTCN widths (f_dim 256 and 128, O = 512 on the flagship) and
    the narrow twin's 24 pass."""
    assert dc.has_tower_kernels(256, 512) and dc.has_tower_kernels(128)
    assert dc.has_tower_kernels(512, 48) and dc.has_tower_kernels(24, 32)
    assert not dc.has_tower_kernels(1002) and not dc.has_tower_kernels(256, 50)

    def no_lib():
        raise AssertionError("the kernel library was asked for")

    monkeypatch.setattr(_build, "lib", no_lib)
    meta = lambda *s: torch.empty(s, device="meta")  # noqa: E731
    lens = torch.empty((2,), dtype=torch.int32, device="meta")
    Cw, Ow = (1002, 8) if entry != "autograd" else (256, 50)
    layer = (meta(3, Cw, Cw), meta(Cw), meta(Cw, Cw), meta(Cw), meta(Cw), meta(Cw))
    x = meta(2, 50, Cw)
    kw = dict(use_ln=False, out_w=meta(Cw, Ow), out_b=meta(Ow))
    with pytest.raises(NotImplementedError, match=f"C={Cw}, O={Ow}" if entry != "single_layer"
                       else f"C={Cw}"):
        if entry == "forward":
            dc.mstcn_stack_fwd(x, lens, [layer], [1], **kw)
        elif entry == "backward":
            dc.mstcn_stack_bwd(meta(2, 50, Ow), [x], [meta(2, 50, Cw)], lens, [layer], [1], **kw)
        elif entry == "single_layer":
            dc.dilated_residual_layer_fwd(x, *layer, dilation=1)
        else:
            dc.mstcn_stack(x, lens, [tuple(p.requires_grad_() for p in layer)], [1], **kw)


def _narrow_tower(seed, tower, T, lengths):
    """A tower at ``configs.small_cfg()``'s widths (f_dim 24, hid_dim 32):
    K1 (f: m, no LN) or K6 (f: m2) layers, dilations past the short videos."""
    from fact_clip_tpu_torch import configs

    cfg = configs.small_cfg()["Bi"]
    Cn, On = cfg["f_dim"], cfg["hid_dim"]
    rng = np.random.default_rng(seed)

    def r(*s, scale=0.15):
        return torch.from_numpy((rng.standard_normal(s) * scale).astype(np.float32))

    x = r(len(lengths), T, Cn, scale=1.0)
    if tower == "m":
        layers = [(r(3, Cn, Cn), r(Cn, scale=0.1), r(Cn, Cn), r(Cn, scale=0.1), torch.ones(Cn),
                   torch.zeros(Cn)) for _ in DILATIONS]
        dil = DILATIONS
    else:
        dil = [(16, 1), (1, 16)]
        layers = [(r(3, Cn, Cn, scale=0.12), r(Cn, scale=0.1), r(3, Cn, Cn, scale=0.12),
                   r(Cn, scale=0.1), r(Cn, Cn), r(Cn, Cn), r(Cn, scale=0.1)) for _ in dil]
    return x, layers, dil, r(Cn, On, scale=0.2), r(On, scale=0.1)


@pytest.mark.parametrize("tower", ["m", "m2"])
@pytest.mark.parametrize("mode", ["eval", "train"])
def test_narrow_twin_tower_is_refused_on_the_card(fake, mode, tower):
    """``configs.small_cfg()`` (the narrow twin of ``_make_cfg(small=True)``:
    towers with f_dim 24 and hid_dim 32) is no longer refused on the card:
    24 channels are not a whole number of 32-float K steps, and the pack pads
    each tap's K segment to 32 with zeros.  The port's launch sequences of K1
    (``f: m``) and K6 (``f: m2``) at C=24, O=32 on the kernels' model against
    JAX's towers in interpret mode: the serving form (eval), and the training
    form with its backward against ``jax.vjp`` (train)."""
    from fact_clip_tpu.ops.pallas.dilated_conv import dilated_residual2_stack

    T, lengths = 70, RAGGED[70]
    x, layers, dil, ow, ob = _narrow_tower(10, tower, T, lengths)
    assert (x.shape[2], ow.shape[1]) == (24, 32) and dc.has_tower_kernels(24, 32)
    lens = torch.tensor(lengths, dtype=torch.int32)
    mask = np.arange(T)[None] < np.array(lengths)[:, None]
    layers_j = [tuple(_jax(p) for p in layer) for layer in layers]

    def f(x_, layers_, ow_, ob_):
        if tower == "m":
            return dilated_residual_stack(x_, jnp.asarray(mask), layers_, dil, use_ln=False,
                                          tile=32, interpret=True, out_params=(ow_, ob_))
        return dilated_residual2_stack(x_, jnp.asarray(mask), layers_, dil, tile=32,
                                       interpret=True, out_params=(ow_, ob_))

    fwd = (lambda save: dc._mstcn_fwd_card(x, lens, layers, dil, False, 1e-5, ow, ob, None,
                                           None, save)) if tower == "m" else (
        lambda save: dc._mstcn2_fwd_card(x, lens, layers, dil, ow, ob, None, None, save, None))
    if mode == "eval":
        got = fwd(False)
        _close(got.numpy()[mask], np.asarray(f(_jax(x), layers_j, _jax(ow), _jax(ob)))[mask])
        assert ("gemm", dc._FOLDED if tower == "m2" else dc._RELU) in fake.calls
        return
    g = np.random.default_rng(11).standard_normal((3, T, 32)).astype(np.float32)
    g[~mask] = 0.0  # the JAX vjp sees the padded logits; the losses never read them
    out_j, vjp = jax.vjp(f, _jax(x), layers_j, _jax(ow), _jax(ob))
    dx_j, dl_j, dow_j, dob_j = vjp(jnp.asarray(g))
    logits, *saves = fwd(True)
    _close(logits.numpy()[mask], np.asarray(out_j)[mask])
    bwd = dc._mstcn_bwd_card if tower == "m" else dc._mstcn2_bwd_card
    extra = (False, 1e-5) if tower == "m" else ()
    got = bwd(torch.from_numpy(g), *saves, lens, layers, dil, *extra, ow, ob, None, None)
    valid = dc._frame_mask(x, lens)
    ref = (torch.from_numpy(np.asarray(dx_j)) * valid,
           [tuple(torch.from_numpy(np.asarray(p)) for p in d) for d in dl_j],
           torch.from_numpy(np.asarray(dow_j)), torch.from_numpy(np.asarray(dob_j)))
    _close_grads((got[0] * valid, *got[1:]), ref)
