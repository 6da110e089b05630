"""K8: int8 evaluation (``TPU.quantize_infer: "int8"``), eval-only.

Counterpart of ``fact_clip_tpu/ops/pallas/quant_conv.py``: the port's own
copies of its quantizers (``quantize_weight`` :42, ``quantize_weight_joint``
:57, ``_quantize_rows`` :93), of ``dense_q8`` (:72, the towers' in map) and
of JAX's tower layout (``dilated_conv.py::_tiling`` :89 and
``_stack_layout`` :454), and the five kernels' entries beside their plain
versions:

* K8a ``mstcn_stack_q8`` (``f: m``): ``dilated_residual_stack_q8``
  (``_stack_layer_q8`` :217) -> ``csrc/quant2.cu``, both activation
  scales: ``act_scale="tile"`` (one scale per video and JAX tile, joint-tap
  conv weights) and ``"row"`` (one scale per frame, per-tap conv weights);
* K8e ``mstcn2_stack_q8`` (``f: m2``, Breakfast and Epic-Kitchens):
  ``dilated_residual2_stack_q8`` (``_stack2_layer_q8`` :390) ->
  ``csrc/quant2.cu``, both activation scales;
* K8b ``x2y_small_x_q8``: ``_x2y_small_x_q8_impl`` (:594) -> one library
  call, ``csrc/x2y_attn.cu::fk_x2y_sx_q8_fwd``: K2's small-X split with the
  q projection on the int8 ``wgmma`` core of ``csrc/q8_proj.cu``;
* K8c ``x2y_flash_q8``: ``_x2y_flash_q8_impl`` (:519) -> one library call,
  ``csrc/flash_attn.cu::fk_x2y_flash_q8_fwd``: K8d's row quantizer and int8
  [xk | xv] projection at one head (``csrc/q8_proj.cu``) feeding K2's flash
  attention; ``x2y_attention_q8`` picks K8b or K8c at JAX's threshold (X >
  1024, :639);
* K8d ``mha_cross_q8``: ``mha_cross_attention_q8`` (:715) -> the int8 K / V
  projection of ``csrc/q8_proj.cu``, then K3's attention
  (``csrc/mha_attn.cu``).

No configuration sets ``act_scale="row"``: a tower module takes it as a
plain attribute (``models/layers.py``), as JAX's tests bind it.

Quantization is JAX's: weights symmetric per output channel with the two
1/127 factors folded into the scale (``s / 16129``); activations
``round(x * (127 / s))`` (half to even) with ``s = max(absmax, 1e-12)`` per
row, or for the towers one scalar per video and JAX tile of frames (see
``csrc/quant2.cu``).  Every integer product of a plain
version is exact (an f64 product of int8 values: every partial sum is an
integer below 2^53), so a kernel's integer parts equal its plain version's
bit for bit and only the f32 epilogue can differ.  The epilogues follow
JAX's order of operations as its kernels compute on the CPU, where XLA
contracts each product-plus-bias of a dequantization (``acc * scale + b``,
and the LayerNorm's ``* g + beta``) into one fused multiply-add: the plain
versions take that FMA (``_fma``) and the kernels write it (``__fmaf_rn``),
every other step rounded on its own (K8e's fuse: fma(h1, s1 * swt, h2 * (s2
* swb)), the bias added after; the row forms' taps: fma(a0 s0, sw0, (a1 s1)
sw1), then fma(a2 s2, sw2, .), the bias added after).  The entries take their weights quantized
(``quantize_tower`` / ``quantize_tower2`` / ``quantize_x2y`` /
``quantize_kv``, which a module caches), launch the kernel on CUDA tensors
and run the plain version on CPU tensors, count their launches, and refuse
inputs that want a gradient: JAX's int8 path is never differentiated.
"""

from __future__ import annotations

import functools
import math
from types import SimpleNamespace
from typing import NamedTuple

import torch

from .. import _build
from .mha_attn import FWD_KEY_TILE, _check_strides, attn_smem, has_forward
from .pos import add_pos, kernel_pos
from .x2y_attn import FLASH_MIN_KEYS, _offsets, _view, flash_rows, sx_rows, sx_smem

_NEG = -1e9


# ---------------------------------------------------------------------------
# quantizers (JAX's, quant_conv.py:42-102)


def _div(a: float, b):
    """a / b, correctly rounded (``scalar / tensor`` is a reciprocal times the
    scalar in PyTorch, and on the card ``tensor / scalar`` multiplies by the
    reciprocal: both can differ from JAX's division by one rounding)."""
    return torch.full_like(b, a) / b


def _over(b, a: float):
    """b / a, correctly rounded."""
    return b / torch.full_like(b, a)


def quantize_weight(w, axis: int = -2):
    """Symmetric per-output-channel int8 weights: (q, s / 127^2), the scale the
    absmax over ``axis`` (C_in) floored at 1e-12."""
    w = w.float()
    s = w.abs().amax(dim=axis, keepdim=True).clamp_min(1e-12)
    q = torch.round(w * _div(127.0, s)).to(torch.int8)
    return q, _over(s.squeeze(axis), 127.0 * 127.0)


def quantize_weight_joint(w):
    """Conv weights (K, C_in, C_out): one scale per output channel over all
    taps and inputs, so the taps' int32 products share one dequantization."""
    w = w.float()
    s = w.abs().amax(dim=(0, 1), keepdim=True).clamp_min(1e-12)
    q = torch.round(w * _div(127.0, s)).to(torch.int8)
    return q, _over(s.squeeze(1).squeeze(0), 127.0 * 127.0)


def _quantize_rows(x):
    """Dynamic symmetric per-row int8: (q, raw row absmax (..., 1))."""
    s = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12)
    return torch.round(x * _div(127.0, s)).to(torch.int8), s


def _fma(a, b, c):
    """a * b + c rounded once, as a fused multiply-add (the f64 product of two
    f32 values is exact)."""
    return (a.double() * b.double() + c.double()).float()


def _idot(a, b):
    """The exact integer product of two int8 tensors, as f32 (the f32 nearest
    to the exact sum, as an int32 accumulator converts)."""
    return torch.matmul(a.double(), b.double()).float()


def dense_q8(x, w, b, *, library: bool = True):
    """JAX's ``dense_q8``: (x, w (in, out), b) -> f32, with per-row activation
    and per-output-channel weight scales (not folded: ``(y * (s / 127)) *
    (sw / 127) + b``).  The int8 product is a library call on the card
    (``torch._int_mm``, s8 x s8 -> s32; it raises where its shape rules fail)
    and the exact plain product on the CPU or with ``library=False``."""
    _build.no_grad_inputs("dense_q8", [x, w, b])
    qx, s = _quantize_rows(x.float())
    wf = w.float()
    sw = wf.abs().amax(dim=0, keepdim=True).clamp_min(1e-12)
    qw = torch.round(wf * _div(127.0, sw)).to(torch.int8)
    if library and x.device.type == "cuda":
        y = torch._int_mm(qx.reshape(-1, qx.shape[-1]), qw).float().view(*qx.shape[:-1], -1)
    else:
        y = _idot(qx, qw)
    return y * _over(s, 127.0) * _over(sw, 127.0) + b


class QWeight(NamedTuple):
    """An int8 projection weight in the kernels' layout: qt (out, in) int8,
    s (out,) folded scale."""

    qt: torch.Tensor
    s: torch.Tensor


def quantize_proj(w) -> QWeight:
    q, s = quantize_weight(w)
    return QWeight(q.t().contiguous(), s)


def _proj_q8(x, qw: QWeight, b):
    """x @ W + b with per-row int8 activations: ((idot * s_row) * sw) + b, the
    last product and sum one FMA."""
    q, s = _quantize_rows(x)
    return _fma(_idot(q, qw.qt.t()) * s, qw.s, b)


# ---------------------------------------------------------------------------
# K8a: the int8 MSTCN tower


class K8eLayout(NamedTuple):
    """The int8 towers' padded widths at C channels (csrc/quant2.cu, K8a's
    and K8e's): kseg = ceil32(C), a tap's K segment in whole 32-byte wgmma
    steps; Kc and Kf the rows of the conv and fuse (or 1x1) packs (3 kseg and
    kseg, at least one 128-byte TMA box); Cw the rows of the int8 activation
    buffers (ceil16(C), at least 128)."""

    kseg: int
    Kc: int
    Kf: int
    Cw: int


def k8e_layout(C: int) -> K8eLayout:
    kseg = -(-C // 32) * 32
    return K8eLayout(kseg, max(3 * kseg, 128), max(kseg, 128), max(-(-C // 16) * 16, 128))


def _pad_cols(w, n: int):
    return torch.nn.functional.pad(w, (0, n - w.shape[-1]))


def _tiling(T: int, tile: int, dilation: int):
    """``dilated_conv.py::_tiling``: (8-aligned halo, tile, n_tiles)."""
    halo = -(-dilation // 8) * 8
    tile = min(tile, max(-(-T // 8) * 8, 8))
    return halo, tile, -(-T // tile)


def _stack_layout(T: int, dilations, tile: int):
    """``dilated_conv.py::_stack_layout``: (tile, n_tiles, T_pad, buffer halo)."""
    _, tile, n_tiles = _tiling(T, tile, 1)
    halo_req = -(-max(dilations) // 8) * 8
    return tile, n_tiles, n_tiles * tile, -(-halo_req // tile) * tile


ACT_SCALES = ("tile", "row")


def _act_scale(name: str, act_scale: str) -> None:
    if act_scale not in ACT_SCALES:
        raise ValueError(f"{name}: act_scale must be one of {ACT_SCALES}, not {act_scale!r}")


def _conv_weight(wd, act_scale: str):
    """The conv's int8 taps (3, C, C) and their scales: one per output channel
    over all taps (tile, (C,)) or one per tap and output channel (row, (3, C))."""
    return quantize_weight_joint(wd) if act_scale == "tile" else quantize_weight(wd)


class Q8Layer(NamedTuple):
    """One quantized tower layer: qwdt (C_out, 3 C_in) int8 (tap k's inputs at
    k C_in) with its scales swd, (C,) joint over the taps (act_scale "tile") or
    (3, C) per tap ("row"), qw1t (C_out, C_in) int8 with sw1
    (C,), the f32 vectors, and the int8 weights in the card's layout
    (``k8e_layout``, K8e's): kpack (C_out, Kc), tap k at columns k kseg, and
    wpack (C_out, Kf), each zero past C_in."""

    qwdt: torch.Tensor
    swd: torch.Tensor
    bd: torch.Tensor
    qw1t: torch.Tensor
    sw1: torch.Tensor
    b1: torch.Tensor
    gamma: torch.Tensor
    beta: torch.Tensor
    kpack: torch.Tensor
    wpack: torch.Tensor


def quantize_tower(layers, act_scale: str = "tile") -> list:
    """(wd (3, C, C), bd, w1 (C, C), b1, gamma, beta) per layer -> Q8Layer
    (``dilated_residual_stack_q8``'s per-step weight pass: the conv's taps
    quantized jointly for ``act_scale="tile"``, each on its own for "row")."""
    _act_scale("quantize_tower", act_scale)
    out = []
    for wd, bd, w1, b1, gamma, beta in layers:
        C = w1.shape[0]
        lay = k8e_layout(C)
        qwd, swd = _conv_weight(wd, act_scale)
        qw1, sw1 = quantize_weight(w1)
        ones = torch.ones(C, device=w1.device)
        kpack = _pad_cols(_pad_cols(qwd.permute(2, 0, 1), lay.kseg).reshape(C, -1), lay.Kc)
        out.append(Q8Layer(qwd.permute(2, 0, 1).reshape(C, 3 * C).contiguous(), swd,
                           bd.float(), qw1.t().contiguous(), sw1, b1.float(),
                           gamma if gamma is not None else ones,
                           beta if beta is not None else torch.zeros_like(ones),
                           kpack.contiguous(), _pad_cols(qw1.t(), lay.Kf).contiguous()))
    return out


def _lane_sum(v):
    """Sum over the last dim in the order of the kernel's warp reduction
    (csrc/quant2.cu's pass N): lane l sums channels l, l + 32, ... in turn,
    then five xor-shuffle steps add the lanes.  The lanes past the last
    channel add zeros, which changes no sum."""
    v = _pad_cols(v, -(-v.shape[-1] // 32) * 32)
    lanes = v[..., :32]
    for j in range(1, v.shape[-1] // 32):
        lanes = lanes + v[..., 32 * j: 32 * j + 32]
    idx = torch.arange(32, device=v.device)
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[..., idx ^ o]
    return lanes[..., :1]


def _layer_norm(out, gamma, beta, eps: float):
    """JAX's two-pass LayerNorm (quant_conv.py::_ln_normalize), its sums in
    the kernel's order and 1 / sqrt correctly rounded, so that the kernel and
    this version round alike."""
    C = out.shape[-1]
    mean = _over(_lane_sum(out), float(C))
    d = out - mean
    inv = _div(1.0, torch.sqrt(_over(_lane_sum(d * d), float(C)) + eps))
    return _fma(d * inv, gamma, beta)


def _shift(x, s: int):
    """y[:, t] = x[:, t + s] inside [0, T), zero outside."""
    if s == 0:
        return x
    y = torch.zeros_like(x)
    T = x.shape[1]
    if abs(s) < T:
        if s > 0:
            y[:, : T - s] = x[:, s:]
        else:
            y[:, -s:] = x[:, : T + s]
    return y


def mstcn_stack_q8_reference(x, lengths, qlayers, dilations, *, use_ln: bool,
                             eps: float = 1e-5, tile: int = 512, scales: bool = False,
                             act_scale: str = "tile"):
    """Plain PyTorch version of ``dilated_residual_stack_q8``: x (B, T, C) ->
    (B, T, C), frames at or past ``lengths`` zero; ``act_scale="row"`` is
    ``_mstcn_q8_row_plain``.  With ``scales`` (tile mode) also what the
    activation scales are made of, per layer: the 8-frame group maxima of
    |input| (L, B, T_pad / 8), from which each tile's window takes s_x, and
    each tile's max of the ReLU output (L, B, n_tiles), before the 1e-12
    floor."""
    _check_scales("mstcn_stack_q8", qlayers, ("swd",), act_scale)
    if act_scale == "row":
        return _mstcn_q8_row_plain(x, lengths, qlayers, dilations, use_ln=use_ln, eps=eps,
                                   tile=tile, scales=scales)
    B, T, C = x.shape
    tile, n_tiles, T_pad, _ = _stack_layout(T, dilations, tile)
    dev = x.device
    valid = (torch.arange(T_pad, device=dev)[None, :] < lengths[:, None]).float()[..., None]
    cur = torch.zeros((B, T_pad, C), device=dev)
    cur[:, :T] = x
    cur = cur * valid
    tile_of = torch.arange(T_pad, device=dev) // tile
    groups, tile_max = [], []
    for ql, d in zip(qlayers, dilations):
        halo = -(-d // 8) * 8
        rows = cur.abs().amax(dim=-1)  # (B, T_pad)
        groups.append(rows.view(B, T_pad // 8, 8).amax(dim=-1))
        s_x = torch.stack([rows[:, max(0, t * tile - halo): min(T_pad, t * tile + tile + halo)]
                           .amax(dim=-1) for t in range(n_tiles)], dim=1).clamp_min(1e-12)
        sx = s_x[:, tile_of][..., None]  # (B, T_pad, 1): each row's tile scale
        taps = [torch.round(_shift(cur, (k - 1) * d) * _div(127.0, sx)) for k in range(3)]
        acc = _idot(torch.cat(taps, dim=-1), ql.qwdt.t())
        a = torch.relu(_fma(acc, sx * ql.swd, ql.bd))
        tile_max.append(a.abs().view(B, n_tiles, tile * C).amax(dim=-1))
        sa = tile_max[-1].clamp_min(1e-12)[:, tile_of][..., None]
        qa = torch.round(a * _div(127.0, sa))
        out = _fma(_idot(qa, ql.qw1t.t()), sa * ql.sw1, ql.b1) + cur
        if use_ln:
            out = _layer_norm(out, ql.gamma, ql.beta, eps)
        cur = out * valid
    if scales:
        return cur[:, :T], torch.stack(groups), torch.stack(tile_max)
    return cur[:, :T]


def _row_taps(qx, sx, qkt, sk, d: int):
    """The row form's dilated conv (``_stack_kernel_q8``'s ``else:`` branch):
    each tap's int8 product dequantized with its rows' scales and its own
    column scales, as XLA's CPU backend contracts JAX's three sums: fma(a0
    s0, sw0, (a1 s1) sw1), then fma(a2 s2, sw2, .).  qx (B, T_pad, C) int8
    and sx (B, T_pad, 1) the rows; a tap reading outside [0, T_pad) reads a
    zero row of scale 0."""
    C = sk.shape[1]
    p = [(_idot(_shift(qx, (k - 1) * d), qkt[:, k * C:(k + 1) * C].t())
          * _shift(sx, (k - 1) * d), sk[k]) for k in range(3)]
    return _fma(p[2][0], p[2][1], _fma(p[0][0], p[0][1], p[1][0] * p[1][1]))


def _check_scales(name: str, qlayers, fields, act_scale: str) -> None:
    """The conv scales must be the form's: (C,) for "tile", (3, C) for "row"."""
    _act_scale(name, act_scale)
    want = 1 if act_scale == "tile" else 2
    if any(getattr(ql, f).dim() != want for ql in qlayers for f in fields):
        raise ValueError(f"{name}: weights not quantized for act_scale={act_scale!r}; use "
                         f"quantize_tower{'2' if len(fields) > 1 else ''}(..., "
                         f"act_scale={act_scale!r})")


def _mstcn_q8_row_plain(x, lengths, qlayers, dilations, *, use_ln: bool, eps: float = 1e-5,
                        tile: int = 512, scales: bool = False):
    """Plain PyTorch version of ``dilated_residual_stack_q8(..., act_scale="row")``:
    x (B, T, C) -> (B, T, C), frames at or past ``lengths`` zero.  Per layer:
    each frame's row quantized with its own absmax (``_quantize_rows``), the
    three taps' products dequantized one by one (``_row_taps``), a =
    relu(. + bd), a's rows quantized, out = fma(idot * s_a, sw1, b1) + x, the
    LayerNorm, the mask.  ``tile`` matters only through T_pad: a tap past
    T_pad reads zeros.  With ``scales`` also the integer parts of the
    scales, per layer, on valid frames (0 elsewhere): each input row's scale
    (L, B, T_pad) and each row's max of a (L, B, T_pad), before the floor."""
    B, T, C = x.shape
    _, _, T_pad, _ = _stack_layout(T, dilations, tile)
    valid = (torch.arange(T_pad, device=x.device)[None, :] < lengths[:, None]).float()[..., None]
    cur = torch.zeros((B, T_pad, C), device=x.device)
    cur[:, :T] = x
    cur = cur * valid
    srows, amax = [], []
    for ql, d in zip(qlayers, dilations):
        qx, sx = _quantize_rows(cur)
        a = torch.relu(_row_taps(qx, sx, ql.qwdt, ql.swd, d) + ql.bd)
        qa, sa = _quantize_rows(a)
        srows.append(sx[..., 0] * valid[..., 0])
        amax.append(a.amax(dim=-1) * valid[..., 0])
        out = _fma(_idot(qa, ql.qw1t.t()) * sa, ql.sw1, ql.b1) + cur
        if use_ln:
            out = _layer_norm(out, ql.gamma, ql.beta, eps)
        cur = out * valid
    if scales:
        return cur[:, :T], torch.stack(srows), torch.stack(amax)
    return cur[:, :T]


def mstcn_stack_q8(x, lengths, qlayers, dilations, *, use_ln: bool, eps: float = 1e-5,
                   tile: int = 512, scales: bool = False, act_scale: str = "tile"):
    """K8a: the int8 tower (``csrc/quant2.cu``, one library call a layer,
    four launches and a fifth with the LayerNorm, and for the tile form one
    for the input's group maxima) on CUDA tensors, the plain version of the
    form on CPU tensors.  ``qlayers`` from ``quantize_tower(..., act_scale)``;
    ``scales`` as in the plain version (the kernels' own maxima).  Any
    width: the packs and buffers pad C (``k8e_layout``).  The row form
    counts its launches apart (``mstcn_q8_row_count``, ``kernel_counters()``'s
    ``mstcn_stack_q8_row``)."""
    _build.no_grad_inputs("mstcn_stack_q8", [x] + [t for ql in qlayers
                                                   for t in (ql.bd, ql.b1, ql.gamma, ql.beta)])
    if x.device.type == "cpu":
        return mstcn_stack_q8_reference(x, lengths, qlayers, dilations, use_ln=use_ln, eps=eps,
                                        tile=tile, scales=scales, act_scale=act_scale)
    _check_scales("mstcn_stack_q8", qlayers, ("swd",), act_scale)
    if act_scale == "row":
        out = _mstcn_q8_row_card(x, lengths, qlayers, dilations, use_ln, eps, tile, scales)
        mstcn_q8_row_count.launches += 1
        return out
    out = _mstcn_q8_card(x, lengths, qlayers, dilations, use_ln, eps, tile, scales)
    mstcn_stack_q8.launches += 1
    return out


def _mstcn_q8_card(x, lengths, qlayers, dilations, use_ln: bool, eps: float, tile: int,
                   scales: bool):
    """The card's launch sequence (also run on CPU tensors against a model of
    the library in the tests)."""
    B, T, C = x.shape
    tile, n_tiles, T_pad, _ = _stack_layout(T, dilations, tile)
    if lengths.dtype != torch.int32 or lengths.shape != (B,):
        raise ValueError("mstcn_stack_q8: lengths must be (B,) int32")
    lay = k8e_layout(C)
    if any(ql.kpack.shape != (C, lay.Kc) or ql.wpack.shape != (C, lay.Kf) for ql in qlayers):
        raise ValueError("mstcn_stack_q8: packs not in k8e_layout(C); use quantize_tower")
    x = x.contiguous()
    _build.check_tensors("mstcn_stack_q8", [x, lengths, *[t for ql in qlayers for t in ql]],
                         x.device)
    dev = x.device
    L = len(qlayers)
    halos = [-(-d // 8) * 8 for d in dilations]
    # the tiles' int8 windows (the widest halo's size, each layer lays out its own),
    # a in f32 and as int8, the window scales; group maxima zeroed
    qwin = torch.empty(B * n_tiles * (tile + 2 * max(halos, default=0)) * lay.Cw, device=dev,
                       dtype=torch.int8)
    a = torch.empty((B, T_pad, lay.Cw), device=dev, dtype=torch.float32)
    qa = torch.empty((B, T_pad, lay.Cw), device=dev, dtype=torch.int8)
    sx = torch.empty((B, n_tiles), device=dev, dtype=torch.float32)
    ys = [torch.empty((B, T, C), device=dev, dtype=torch.float32) for _ in range(min(2, L))]
    gmax = torch.zeros((L + 1, B, T_pad // 8), device=dev, dtype=torch.float32)
    smax = torch.zeros((L, B, n_tiles), device=dev, dtype=torch.int32)  # a's tile maxima
    lib, stream = _build.lib(), _build.stream_ptr(dev)
    _build.check("fk_q8_group_max", lib.fk_q8_group_max(
        x.data_ptr(), lengths.data_ptr(), gmax[0].data_ptr(), B, T, T_pad, C, stream))
    cur = x
    for i, (ql, d, halo) in enumerate(zip(qlayers, dilations, halos)):
        y = ys[i % 2]
        _build.check("fk_q8_tower_layer", lib.fk_q8_tower_layer(
            cur.data_ptr(), lengths.data_ptr(), gmax[i].data_ptr(), ql.kpack.data_ptr(), lay.Kc,
            ql.swd.data_ptr(), ql.bd.data_ptr(), ql.wpack.data_ptr(), lay.Kf, ql.sw1.data_ptr(),
            ql.b1.data_ptr(), ql.gamma.data_ptr(), ql.beta.data_ptr(), int(use_ln), float(eps),
            qwin.data_ptr(), sx.data_ptr(), a.data_ptr(), qa.data_ptr(), smax[i].data_ptr(),
            y.data_ptr(), gmax[i + 1].data_ptr(), B, T, C, lay.Cw, int(d), halo, tile, n_tiles,
            T_pad, stream))
        cur = y
    if scales:  # the tile maxima are the int bits of non-negative floats
        return cur, gmax[:L], smax.view(torch.float32)
    return cur


mstcn_stack_q8.launches = 0
mstcn_q8_row_count = SimpleNamespace(launches=0)  # the row form's count (kernel_counters)


def _row_buffers(name, x, lengths, qlayers, dmax: int, T_pad: int, nconv: int):
    """The row forms' checks and buffers: the frames' int8 rows (B, H + T_pad
    + H, Cw) and their scales (L, B, H + T_pad + H), zeros in the halos of H =
    ceil8(max d) rows on each side (what a tap past [0, T_pad) reads); the
    conv outputs in f32 and as int8 (nconv, B, T_pad, Cw) and their rows'
    maxima (L, nconv, B, T_pad) as int bits, zeroed."""
    B, T, C = x.shape
    if lengths.dtype != torch.int32 or lengths.shape != (B,):
        raise ValueError(f"{name}: lengths must be (B,) int32")
    lay = k8e_layout(C)
    H = -(-dmax // 8) * 8
    dev = x.device
    L = len(qlayers)
    qrow = torch.zeros((B, T_pad + 2 * H, lay.Cw), device=dev, dtype=torch.int8)
    srow = torch.zeros((L, B, T_pad + 2 * H), device=dev, dtype=torch.float32)
    c = torch.empty((nconv, B, T_pad, lay.Cw), device=dev, dtype=torch.float32)
    qc_ = torch.empty((nconv, B, T_pad, lay.Cw), device=dev, dtype=torch.int8)
    rmax = torch.zeros((L, nconv, B, T_pad), device=dev, dtype=torch.int32)
    ys = [torch.empty((B, T, C), device=dev, dtype=torch.float32) for _ in range(min(2, L))]
    return lay, H, qrow, srow, c, qc_, rmax, ys


def _row_scales(cur, lengths, srow, rmax, H: int, T_pad: int):
    """The kernels' integer parts as the plain row version returns them: the
    input rows' scales and the rows' maxima on valid frames, 0 elsewhere."""
    valid = torch.arange(T_pad, device=cur.device)[None, :] < lengths[:, None]
    return cur, srow[:, :, H:H + T_pad] * valid, rmax.view(torch.float32) * valid


def _mstcn_q8_row_card(x, lengths, qlayers, dilations, use_ln: bool, eps: float, tile: int,
                       scales: bool):
    """K8a's row form on the card (also run on CPU tensors against a model of
    the library in the tests): one library call a layer, ``fk_q8_tower_row_layer``
    (passes R, A, Q, B and N with the LayerNorm: csrc/quant2.cu)."""
    B, T, C = x.shape
    tile, n_tiles, T_pad, _ = _stack_layout(T, dilations, tile)
    lay, H, qrow, srow, a, qa, rmax, ys = _row_buffers("mstcn_stack_q8", x, lengths, qlayers,
                                                       max(dilations), T_pad, 1)
    if any(ql.kpack.shape != (C, lay.Kc) or ql.wpack.shape != (C, lay.Kf) for ql in qlayers):
        raise ValueError("mstcn_stack_q8: packs not in k8e_layout(C); use quantize_tower")
    x = x.contiguous()
    _build.check_tensors("mstcn_stack_q8", [x, lengths, *[t for ql in qlayers for t in ql]],
                         x.device)
    lib, stream = _build.lib(), _build.stream_ptr(x.device)
    cur = x
    for i, (ql, d) in enumerate(zip(qlayers, dilations)):
        y = ys[i % 2]
        _build.check("fk_q8_tower_row_layer", lib.fk_q8_tower_row_layer(
            cur.data_ptr(), lengths.data_ptr(), ql.kpack.data_ptr(), lay.Kc, ql.swd.data_ptr(),
            ql.bd.data_ptr(), ql.wpack.data_ptr(), lay.Kf, ql.sw1.data_ptr(), ql.b1.data_ptr(),
            ql.gamma.data_ptr(), ql.beta.data_ptr(), int(use_ln), float(eps), qrow.data_ptr(),
            srow[i].data_ptr(), a.data_ptr(), qa.data_ptr(), rmax[i].data_ptr(), y.data_ptr(),
            B, T, C, lay.Cw, int(d), H, tile, n_tiles, T_pad, stream))
        cur = y
    if scales:
        return _row_scales(cur, lengths, srow, rmax[:, 0], H, T_pad)
    return cur


# ---------------------------------------------------------------------------
# K8e: the int8 MS-TCN++ tower


class Q8Layer2(NamedTuple):
    """One quantized MS-TCN++ layer: the two convs' qk1t, qk2t (C_out, 3 C_in)
    int8 (tap k's inputs at k C_in) with their scales sk1, sk2 ((C,) joint
    over the taps, act_scale "tile"; (3, C) per tap, "row"), the
    fuse halves qwtt, qwbt (C_out, C_in) int8 with swt, swb (C,), the f32
    biases, and the same int8 weights in the card's layout (``k8e_layout``):
    kpack (2, C_out, Kc), conv k's tap t at columns t kseg, and fpack (2,
    C_out, Kf), Wt then Wb, each zero past C_in."""

    qk1t: torch.Tensor
    sk1: torch.Tensor
    b1: torch.Tensor
    qk2t: torch.Tensor
    sk2: torch.Tensor
    b2: torch.Tensor
    qwtt: torch.Tensor
    swt: torch.Tensor
    qwbt: torch.Tensor
    swb: torch.Tensor
    bf: torch.Tensor
    kpack: torch.Tensor
    fpack: torch.Tensor


def quantize_tower2(layers, act_scale: str = "tile") -> list:
    """(k1 (3, C, C), b1, k2, b2, wt (C, C), wb, bf) per layer -> Q8Layer2
    (``dilated_residual2_stack_q8``'s per-step weight pass: the convs' taps
    quantized jointly for ``act_scale="tile"``, each on its own for "row";
    per-column scales for the fuse halves)."""
    _act_scale("quantize_tower2", act_scale)
    out = []
    for k1, b1, k2, b2, wt, wb, bf in layers:
        C = wt.shape[0]
        lay = k8e_layout(C)
        (qk1, sk1), (qk2, sk2) = _conv_weight(k1, act_scale), _conv_weight(k2, act_scale)
        (qwt, swt), (qwb, swb) = quantize_weight(wt), quantize_weight(wb)
        kpack = torch.stack([_pad_cols(_pad_cols(q.permute(2, 0, 1), lay.kseg).reshape(C, -1),
                                       lay.Kc) for q in (qk1, qk2)]).contiguous()
        fpack = torch.stack([_pad_cols(q.t(), lay.Kf) for q in (qwt, qwb)]).contiguous()
        out.append(Q8Layer2(qk1.permute(2, 0, 1).reshape(C, 3 * C).contiguous(), sk1, b1.float(),
                            qk2.permute(2, 0, 1).reshape(C, 3 * C).contiguous(), sk2, b2.float(),
                            qwt.t().contiguous(), swt, qwb.t().contiguous(), swb, bf.float(),
                            kpack, fpack))
    return out


def _tile_max(v, B: int, n_tiles: int):
    """Each (video, JAX tile)'s max of |v| over every row of the tile."""
    return v.abs().view(B, n_tiles, -1).amax(dim=-1)


def mstcn2_stack_q8_reference(x, lengths, qlayers, dil_pairs, *, tile: int = 512,
                              scales: bool = False, act_scale: str = "tile"):
    """Plain PyTorch version of ``dilated_residual2_stack_q8``: x (B, T, C) ->
    (B, T, C), frames at or past ``lengths`` zero; ``act_scale="row"`` is
    ``_mstcn2_q8_row_plain``.  Tile mode, per layer
    (d1, d2) and JAX tile of frames: s_x the absmax of the layer input over
    the tile's window [t tile - h, (t + 1) tile + h) within [0, T_pad), h =
    ceil8(max(d1, d2)); each conv's three taps of round(x * (127 / s_x)) in
    one integer sum, dequantized as fma(acc, s_x * sk, b); s1 and s2 the max
    of |c1| and |c2| over every row of the tile, padded rows included; then
    h = fma(h1, s1 * swt, h2 * (s2 * swb)) of the two int8 fuse products,
    out = (relu(h + bf) + x) * mask, as XLA's CPU backend computes JAX's
    kernel.  With ``scales`` also the integer parts of the scales, per
    layer: the 8-frame group maxima of |input| (L, B, T_pad / 8) and each
    tile's max of |c1| and |c2| (L, 2, B, n_tiles), before the 1e-12 floor."""
    _check_scales("mstcn2_stack_q8", qlayers, ("sk1", "sk2"), act_scale)
    if act_scale == "row":
        return _mstcn2_q8_row_plain(x, lengths, qlayers, dil_pairs, tile=tile, scales=scales)
    B, T, C = x.shape
    _, tile, n_tiles = _tiling(T, tile, 1)
    T_pad = n_tiles * tile
    dev = x.device
    valid = (torch.arange(T_pad, device=dev)[None, :] < lengths[:, None]).float()[..., None]
    cur = torch.zeros((B, T_pad, C), device=dev)
    cur[:, :T] = x
    cur = cur * valid
    tile_of = torch.arange(T_pad, device=dev) // tile
    groups, tile_max = [], []
    for ql, (d1, d2) in zip(qlayers, dil_pairs):
        halo = -(-max(d1, d2) // 8) * 8
        rows = cur.abs().amax(dim=-1)  # (B, T_pad)
        groups.append(rows.view(B, T_pad // 8, 8).amax(dim=-1))
        s_x = torch.stack([rows[:, max(0, t * tile - halo): min(T_pad, t * tile + tile + halo)]
                           .amax(dim=-1) for t in range(n_tiles)], dim=1).clamp_min(1e-12)
        sx = s_x[:, tile_of][..., None]  # (B, T_pad, 1): each row's tile scale
        inv = _div(127.0, sx)

        def conv(qkt, sk, b, d):
            taps = [torch.round(_shift(cur, (k - 1) * d) * inv) for k in range(3)]
            return _fma(_idot(torch.cat(taps, dim=-1), qkt.t()), sx * sk, b)

        c1, c2 = conv(ql.qk1t, ql.sk1, ql.b1, d1), conv(ql.qk2t, ql.sk2, ql.b2, d2)
        tile_max.append(torch.stack([_tile_max(c1, B, n_tiles), _tile_max(c2, B, n_tiles)]))
        s1, s2 = (m.clamp_min(1e-12)[:, tile_of][..., None] for m in tile_max[-1])
        h1 = _idot(torch.round(c1 * _div(127.0, s1)), ql.qwtt.t())
        h2 = _idot(torch.round(c2 * _div(127.0, s2)), ql.qwbt.t())
        h = _fma(h1, s1 * ql.swt, h2 * (s2 * ql.swb))
        cur = (torch.relu(h + ql.bf) + cur) * valid
    if scales:
        return cur[:, :T], torch.stack(groups), torch.stack(tile_max)
    return cur[:, :T]


def _mstcn2_q8_row_plain(x, lengths, qlayers, dil_pairs, *, tile: int = 512,
                         scales: bool = False):
    """Plain PyTorch version of ``dilated_residual2_stack_q8(..., act_scale="row")``:
    x (B, T, C) -> (B, T, C), frames at or past ``lengths`` zero.  Per layer
    (d1, d2): each frame's row quantized with its own absmax, both convs'
    taps dequantized one by one (``_row_taps``) plus their biases, c1 and c2
    quantized per row, h = fma(h1 s1, swt, (h2 s2) swb) as XLA's CPU backend
    computes JAX's kernel, out = (relu(h + bf) + x) * mask.  ``tile`` matters
    only through T_pad.  With ``scales`` also, per layer and on valid frames
    (0 elsewhere), each input row's scale (L, B, T_pad) and each row's max of
    |c1| and |c2| (L, 2, B, T_pad), before the floor."""
    B, T, C = x.shape
    _, tile, n_tiles = _tiling(T, tile, 1)
    T_pad = n_tiles * tile
    valid = (torch.arange(T_pad, device=x.device)[None, :] < lengths[:, None]).float()[..., None]
    cur = torch.zeros((B, T_pad, C), device=x.device)
    cur[:, :T] = x
    cur = cur * valid
    srows, cmax = [], []
    for ql, (d1, d2) in zip(qlayers, dil_pairs):
        qx, sx = _quantize_rows(cur)
        c1 = _row_taps(qx, sx, ql.qk1t, ql.sk1, d1) + ql.b1
        c2 = _row_taps(qx, sx, ql.qk2t, ql.sk2, d2) + ql.b2
        srows.append(sx[..., 0] * valid[..., 0])
        cmax.append(torch.stack([c.abs().amax(dim=-1) * valid[..., 0] for c in (c1, c2)]))
        (q1, s1), (q2, s2) = _quantize_rows(c1), _quantize_rows(c2)
        h = _fma(_idot(q1, ql.qwtt.t()) * s1, ql.swt, (_idot(q2, ql.qwbt.t()) * s2) * ql.swb)
        cur = (torch.relu(h + ql.bf) + cur) * valid
    if scales:
        return cur[:, :T], torch.stack(srows), torch.stack(cmax)
    return cur[:, :T]


def mstcn2_stack_q8(x, lengths, qlayers, dil_pairs, *, tile: int = 512, scales: bool = False,
                    act_scale: str = "tile"):
    """K8e: the int8 MS-TCN++ tower (``csrc/quant2.cu``, one library call a
    layer, four launches, and for the tile form one for the input's group
    maxima) on CUDA tensors, the plain version of the form on CPU tensors.
    ``qlayers`` from ``quantize_tower2(..., act_scale)``; ``scales`` as in the
    plain version (the kernels' own maxima).  Any width: the packs and
    buffers pad C (``k8e_layout``).  The row form counts its launches apart
    (``mstcn2_q8_row_count``, ``kernel_counters()``'s ``mstcn2_stack_q8_row``)."""
    _build.no_grad_inputs("mstcn2_stack_q8", [x] + [t for ql in qlayers
                                                    for t in (ql.b1, ql.b2, ql.bf)])
    if x.device.type == "cpu":
        return mstcn2_stack_q8_reference(x, lengths, qlayers, dil_pairs, tile=tile,
                                         scales=scales, act_scale=act_scale)
    _check_scales("mstcn2_stack_q8", qlayers, ("sk1", "sk2"), act_scale)
    if act_scale == "row":
        out = _mstcn2_q8_row_card(x, lengths, qlayers, dil_pairs, tile, scales)
        mstcn2_q8_row_count.launches += 1
        return out
    out = _mstcn2_q8_card(x, lengths, qlayers, dil_pairs, tile, scales)
    mstcn2_stack_q8.launches += 1
    return out


def _mstcn2_q8_card(x, lengths, qlayers, dil_pairs, tile: int, scales: bool):
    """The card's launch sequence (also run on CPU tensors against a model of
    the library in the tests)."""
    B, T, C = x.shape
    _, tile, n_tiles = _tiling(T, tile, 1)
    T_pad = n_tiles * tile
    if lengths.dtype != torch.int32 or lengths.shape != (B,):
        raise ValueError("mstcn2_stack_q8: lengths must be (B,) int32")
    lay = k8e_layout(C)
    if any(ql.kpack.shape != (2, C, lay.Kc) or ql.fpack.shape != (2, C, lay.Kf)
           for ql in qlayers):
        raise ValueError("mstcn2_stack_q8: packs not in k8e_layout(C); use quantize_tower2")
    x = x.contiguous()
    _build.check_tensors("mstcn2_stack_q8", [x, lengths, *[t for ql in qlayers for t in ql]],
                         x.device)
    dev = x.device
    L = len(qlayers)
    halos = [-(-max(d1, d2) // 8) * 8 for d1, d2 in dil_pairs]
    # the tiles' int8 windows (the widest halo's size, each layer lays out its own),
    # c1 | c2 in f32 and as int8, the window scales; group maxima zeroed
    qwin = torch.empty(B * n_tiles * (tile + 2 * max(halos, default=0)) * lay.Cw, device=dev,
                       dtype=torch.int8)
    c = torch.empty((2, B, T_pad, lay.Cw), device=dev, dtype=torch.float32)
    qc = torch.empty((2, B, T_pad, lay.Cw), device=dev, dtype=torch.int8)
    sx = torch.empty((B, n_tiles), device=dev, dtype=torch.float32)
    ys = [torch.empty((B, T, C), device=dev, dtype=torch.float32) for _ in range(min(2, L))]
    gmax = torch.zeros((L + 1, B, T_pad // 8), device=dev, dtype=torch.float32)
    smax = torch.zeros((L, 2, B, n_tiles), device=dev, dtype=torch.int32)  # |c|'s tile maxima
    lib, stream = _build.lib(), _build.stream_ptr(dev)
    _build.check("fk_q8_group_max", lib.fk_q8_group_max(
        x.data_ptr(), lengths.data_ptr(), gmax[0].data_ptr(), B, T, T_pad, C, stream))
    cur = x
    for i, (ql, (d1, d2), halo) in enumerate(zip(qlayers, dil_pairs, halos)):
        y = ys[i % 2]
        _build.check("fk_q8_tower2_layer", lib.fk_q8_tower2_layer(
            cur.data_ptr(), lengths.data_ptr(), gmax[i].data_ptr(), ql.kpack.data_ptr(), lay.Kc,
            ql.sk1.data_ptr(), ql.b1.data_ptr(), ql.sk2.data_ptr(), ql.b2.data_ptr(),
            ql.fpack.data_ptr(), lay.Kf, ql.swt.data_ptr(), ql.swb.data_ptr(), ql.bf.data_ptr(),
            qwin.data_ptr(), sx.data_ptr(), c.data_ptr(), qc.data_ptr(), smax[i].data_ptr(),
            y.data_ptr(), gmax[i + 1].data_ptr(), B, T, C, lay.Cw, int(d1), int(d2), halo, tile,
            n_tiles, T_pad, stream))
        cur = y
    if scales:  # the tile maxima are the int bits of non-negative floats
        return cur, gmax[:L], smax.view(torch.float32)
    return cur


mstcn2_stack_q8.launches = 0
mstcn2_q8_row_count = SimpleNamespace(launches=0)  # the row form's count (kernel_counters)


def _mstcn2_q8_row_card(x, lengths, qlayers, dil_pairs, tile: int, scales: bool):
    """K8e's row form on the card (also run on CPU tensors against a model of
    the library in the tests): one library call a layer,
    ``fk_q8_tower2_row_layer`` (passes R, A, Q, F: csrc/quant2.cu)."""
    B, T, C = x.shape
    _, tile, n_tiles = _tiling(T, tile, 1)
    T_pad = n_tiles * tile
    dmax = max(max(p) for p in dil_pairs)
    lay, H, qrow, srow, c, qc_, rmax, ys = _row_buffers("mstcn2_stack_q8", x, lengths, qlayers,
                                                        dmax, T_pad, 2)
    if any(ql.kpack.shape != (2, C, lay.Kc) or ql.fpack.shape != (2, C, lay.Kf)
           for ql in qlayers):
        raise ValueError("mstcn2_stack_q8: packs not in k8e_layout(C); use quantize_tower2")
    x = x.contiguous()
    _build.check_tensors("mstcn2_stack_q8", [x, lengths, *[t for ql in qlayers for t in ql]],
                         x.device)
    lib, stream = _build.lib(), _build.stream_ptr(x.device)
    cur = x
    for i, (ql, (d1, d2)) in enumerate(zip(qlayers, dil_pairs)):
        y = ys[i % 2]
        _build.check("fk_q8_tower2_row_layer", lib.fk_q8_tower2_row_layer(
            cur.data_ptr(), lengths.data_ptr(), ql.kpack.data_ptr(), lay.Kc, ql.sk1.data_ptr(),
            ql.b1.data_ptr(), ql.sk2.data_ptr(), ql.b2.data_ptr(), ql.fpack.data_ptr(), lay.Kf,
            ql.swt.data_ptr(), ql.swb.data_ptr(), ql.bf.data_ptr(), qrow.data_ptr(),
            srow[i].data_ptr(), c.data_ptr(), qc_.data_ptr(), rmax[i].data_ptr(), y.data_ptr(),
            B, T, C, lay.Cw, int(d1), int(d2), H, tile, n_tiles, T_pad, stream))
        cur = y
    if scales:
        return _row_scales(cur, lengths, srow, rmax, H, T_pad)
    return cur


# ---------------------------------------------------------------------------
# K8b / K8c: X2Y with int8 projections over the large axis


def x2y_attention_q8_reference(y_in, y_pos, x_in, x_pos, wk, bk, wv, bv, wq, bq, x_len,
                               qweights=None):
    """Plain PyTorch version of ``x2y_attention_q8`` (both forms): returns
    (attn, probs, logits) as ``x2y_attention`` does.  ``qweights``: the
    ``quantize_proj`` of (wk, wv, wq) first (``quantize_x2y``'s), quantized
    here when None."""
    qk, qv, qq = (qweights or (quantize_proj(wk), quantize_proj(wv), quantize_proj(wq)))[:3]
    X, d = x_in.shape[1], wq.shape[1]
    if X >= FLASH_MIN_KEYS:  # the frames are the keys: int8 K/V projections
        yq = add_pos(y_in, y_pos) @ wq + bq
        xk = _proj_q8(add_pos(x_in, x_pos), qk, bk)
        xv = _proj_q8(x_in, qv, bv)
    else:  # the frames are the queries: int8 q projection
        xk = add_pos(x_in, x_pos) @ wk + bk
        xv = x_in @ wv + bv
        yq = _proj_q8(add_pos(y_in, y_pos), qq, bq)
    logits = (yq @ xk.transpose(1, 2)) * (1.0 / math.sqrt(d))
    valid = torch.arange(X, device=x_in.device)[None, None, :] < x_len[:, None, None]
    logits = logits.masked_fill(~valid, _NEG)
    probs = torch.softmax(logits, dim=-1)
    return probs @ xv, probs, logits


class QX2Y(NamedTuple):
    """K8b's and K8c's weights: the ``quantize_proj`` of Wk, Wv and Wq, which
    the plain version reads, and [qWk^T ; qWv^T] in K8c's layout
    (``k8d_layout(Cx)``): kvpack (2d, Kw) int8, Wk's out channel n at row n
    and Wv's at d + n, zeros past Cx."""

    qk: QWeight
    qv: QWeight
    qq: QWeight
    kvpack: torch.Tensor


def quantize_x2y(wk, wv, wq) -> QX2Y:
    """The X2Y layer's int8 weights, made once while the layer serves."""
    kv = quantize_kv(wk, wv)
    return QX2Y(kv.qk, kv.qv, quantize_proj(wq), kv.pack)


def _x2y_shapes(name, y_in, x_in, wk, bk, wv, bv, wq, bq, x_len):
    _build.no_grad_inputs(name, [y_in, x_in, wk, bk, wv, bv, wq, bq])
    B, _, Cy = y_in.shape
    Cx = x_in.shape[2]
    d = wq.shape[1]
    if (x_in.shape[0] != B or wk.shape != (Cx, d) or wv.shape != (Cx, d) or wq.shape != (Cy, d)
            or bk.shape != (d,) or bv.shape != (d,) or bq.shape != (d,)):
        raise ValueError(f"{name}: inconsistent shapes")
    if x_len.dtype != torch.int32 or x_len.shape != (B,):
        raise ValueError(f"{name}: x_len must be (B,) int32")


def x2y_small_x_q8(y_in, y_pos, x_in, x_pos, wk, bk, wv, bv, wq, bq, x_len, qweights=None):
    """K8b: the frames are the queries (X <= 1024 keys).  The key / value
    projections over the short axis stay f32, as in JAX; the q projection of
    every frame runs on the int8 tensor cores."""
    if x_in.device.type == "cpu":
        _build.no_grad_inputs("x2y_small_x_q8", [y_in, x_in, wk, bk, wv, bv, wq, bq])
        return x2y_attention_q8_reference(y_in, y_pos, x_in, x_pos, wk, bk, wv, bv, wq, bq,
                                          x_len, qweights)
    out = _x2y_sx_q8_card(y_in, y_pos, x_in, x_pos, wk, bk, wv, bv, wq, bq, x_len, qweights)
    x2y_small_x_q8.launches += 1
    return out


@functools.lru_cache(maxsize=64)
def _sx_q8_plan(B: int, Y: int, X: int, Cy: int, Cx: int, d: int, Px: int, with_xpos: bool):
    """K8b's limits and layout at one shape, before any launch: the key
    side's GEMM takes 16-byte rows (Cx, d and Px multiples of 4), the
    attention X <= 1024 keys and a block of ``sx_smem`` bytes; any Cy (the
    rows and Wq's pack padded to ``k8d_layout(Cy)``).  Returns the
    workspace's offsets in floats (read only) and size and the layout: asked
    once a shape, so that a call's host time stays small."""
    name = "x2y_small_x_q8"
    _check_strides(name, Cx, d, Px)
    if X >= FLASH_MIN_KEYS or sx_smem(X, d) > _build.MAX_SMEM:
        raise NotImplementedError(f"{name}: no kernel for X={X}, d={d} (X <= 1024, the "
                                  f"attention's block {sx_smem(X, d)} bytes of shared memory, "
                                  f"{_build.MAX_SMEM} at most)")
    lay = k8d_layout(Cy)
    offsets, total = _offsets(dict(
        lens=2 * B + 1, xin=B * X * 2 * Cx if with_xpos else None, wkvp=4 * d * Cx,
        kv=B * X * 2 * d, yq=B * Y * d, sy=B * Y, qy=-(-B * Y * lay.Cw // 4)))
    return offsets, total, lay


def _x2y_sx_q8_card(y_in, y_pos, x_in, x_pos, wk, bk, wv, bv, wq, bq, x_len, qweights=None,
                    inspect=None):
    """``x2y_small_x_q8``'s one library call (``csrc/x2y_attn.cu::
    fk_x2y_sx_q8_fwd``; CPU tensors reach it only in the tests, against a
    model of the library): the key side [xk | xv] in f32 on the 3xTF32 GEMM,
    the rows q(y + y_pos) and yq on the int8 core, then the attention per
    tile of 8-32 query rows, into one workspace.  ``qweights`` as the plain
    version's (only Wq's is read).  ``inspect`` (a dict) receives the
    quantized rows "qy" (B, Y, Cw), their scales "sy" (B, Y), "yq" (B, Y, d)
    and "kv" (B, X, 2d), views of the workspace."""
    name = "x2y_small_x_q8"
    _x2y_shapes(name, y_in, x_in, wk, bk, wv, bv, wq, bq, x_len)
    y_in, x_in = y_in.contiguous(), x_in.contiguous()
    B, Y, Cy = y_in.shape
    X, Cx = x_in.shape[1], x_in.shape[2]
    d = wq.shape[1]
    qq = quantize_proj(wq) if qweights is None else qweights[2]
    ypos, ystride, Py = kernel_pos(y_pos, B, Y, Cy)
    xpos, xstride, Px = kernel_pos(x_pos, B, X, Cx)
    offsets, total, lay = _sx_q8_plan(B, Y, X, Cy, Cx, d, Px, xpos is not None)
    _build.check_tensors(name, [y_in, ypos, x_in, xpos, wk, bk, wv, bv, bq, x_len, *qq],
                         x_in.device)
    pack = qq.qt if qq.qt.shape[1] == lay.Kw else _pad_cols(qq.qt, lay.Kw).contiguous()
    f32 = dict(device=x_in.device, dtype=torch.float32)
    work = torch.empty((total,), **f32)
    base = work.data_ptr()
    w = {k: None if o is None else base + 4 * o for k, o in offsets.items()}
    attn = torch.empty((B, Y, d), **f32)
    probs = torch.empty((B, Y, X), **f32)
    logits = torch.empty((B, Y, X), **f32)
    _build.check(name, _build.lib().fk_x2y_sx_q8_fwd(
        y_in.data_ptr(), ypos.data_ptr() if ypos is not None else None, ystride, Py,
        x_in.data_ptr(), xpos.data_ptr() if xpos is not None else None, xstride, Px,
        pack.data_ptr(), lay.Kw, qq.s.data_ptr(), bq.data_ptr(), wk.data_ptr(), bk.data_ptr(),
        wv.data_ptr(), bv.data_ptr(), x_len.data_ptr(), B, Y, X, Cy, Cx, lay.Cw, d,
        1.0 / math.sqrt(d), w["lens"], w["xin"], w["wkvp"], w["kv"], w["qy"], w["sy"], w["yq"],
        logits.data_ptr(), probs.data_ptr(), attn.data_ptr(), sx_rows(B, Y, X, d),
        _build.stream_ptr(x_in.device)))
    if inspect is not None:
        inspect["qy"] = work[offsets["qy"]:].view(torch.int8)[:B * Y * lay.Cw].view(B, Y, lay.Cw)
        inspect["sy"] = _view(work, w["sy"], (B, Y))
        inspect["yq"] = _view(work, w["yq"], (B, Y, d))
        inspect["kv"] = _view(work, w["kv"], (B, X, 2 * d))
    return attn, probs, logits


x2y_small_x_q8.launches = 0


def x2y_flash_q8(y_in, y_pos, x_in, x_pos, wk, bk, wv, bv, wq, bq, x_len, qweights=None):
    """K8c: the frames are the keys (X > 1024).  The q projection over the
    token axis stays f32 and outside the TPU kernel, as in JAX; the key /
    value projections of every frame run on the int8 tensor cores."""
    if x_in.device.type == "cpu":
        _build.no_grad_inputs("x2y_flash_q8", [y_in, x_in, wk, bk, wv, bv, wq, bq])
        return x2y_attention_q8_reference(y_in, y_pos, x_in, x_pos, wk, bk, wv, bv, wq, bq,
                                          x_len, qweights)
    out = _x2y_flash_q8_card(y_in, y_pos, x_in, x_pos, wk, bk, wv, bv, wq, bq, x_len, qweights)
    x2y_flash_q8.launches += 1
    return out


@functools.lru_cache(maxsize=64)
def _flash_q8_plan(B: int, M: int, X: int, Cx: int, d: int):
    """K8c's limits and layout at one shape, before any launch: the
    attention reads 16-byte rows of yq and [xk | xv] (d a multiple of 4);
    any Cx (the rows and the pack padded to ``k8d_layout(Cx)``).  Returns
    K8d's buffers at one head ({name: (offset, shape, dtype)}, bytes), the
    layout and the query rows a block: asked once a shape, so that a call's
    host time stays small."""
    if d % 4:
        raise NotImplementedError(f"x2y_flash_q8: no kernel for d={d} (a multiple of 4)")
    lay = k8d_layout(Cx)
    bufs, nbytes = _k8d_buffers(B, X, lay.Cw, M, d, 1)
    return bufs, nbytes, lay, flash_rows(M)


def _x2y_flash_q8_card(y_in, y_pos, x_in, x_pos, wk, bk, wv, bv, wq, bq, x_len, qweights=None,
                       inspect=None):
    """``x2y_flash_q8``'s one library call (``csrc/flash_attn.cu::
    fk_x2y_flash_q8_fwd``; CPU tensors reach it only in the tests, against a
    model of the library): the frame rows quantized (q(x + x_pos), q(x)),
    [xk | xv] on the int8 core, then the attention partials per (group of
    query rows, 64-key tile, video) and the combine, into one workspace.
    ``qweights``: ``quantize_x2y``'s, made here when None.  ``inspect``
    (a dict) receives the quantized rows "qx" (2, B, X, Cw), their scales
    "sx" (2, B, X) and "kv" (B, X, 2d), views of the workspace."""
    name = "x2y_flash_q8"
    _x2y_shapes(name, y_in, x_in, wk, bk, wv, bv, wq, bq, x_len)
    x_in = x_in.contiguous()
    B, M, _ = y_in.shape
    X, Cx = x_in.shape[1], x_in.shape[2]
    d = wq.shape[1]
    bufs, nbytes, lay, rows = _flash_q8_plan(B, M, X, Cx, d)
    qw = quantize_x2y(wk, wv, wq) if qweights is None else qweights
    if qw.kvpack.shape != (2 * d, lay.Kw):
        raise ValueError(f"{name}: pack not in k8d_layout(Cx); use quantize_x2y")
    pos, p_stride, P = kernel_pos(x_pos, B, X, Cx)
    yq = (add_pos(y_in, y_pos) @ wq + bq).contiguous()  # f32, outside, as in JAX
    _build.check_tensors(name, [x_in, pos, qw.kvpack, qw.qk.s, bk, qw.qv.s, bv, yq, x_len],
                         x_in.device)
    ws = torch.empty(nbytes, device=x_in.device, dtype=torch.uint8)
    at = {k: ws.data_ptr() + off for k, (off, _, _) in bufs.items()}
    f32 = dict(device=x_in.device, dtype=torch.float32)
    attn = torch.empty((B, M, d), **f32)
    probs = torch.empty((B, M, X), **f32)
    logits = torch.empty((B, M, X), **f32)
    _build.check(name, _build.lib().fk_x2y_flash_q8_fwd(
        x_in.data_ptr(), pos.data_ptr() if pos is not None else None, p_stride, P,
        qw.kvpack.data_ptr(), lay.Kw, qw.qk.s.data_ptr(), bk.data_ptr(), qw.qv.s.data_ptr(),
        bv.data_ptr(), yq.data_ptr(), x_len.data_ptr(), B, X, Cx, lay.Cw, M, d,
        1.0 / math.sqrt(d), at["qx"], at["sx"], at["kv"], at["part_acc"], at["part_ml"],
        logits.data_ptr(), probs.data_ptr(), attn.data_ptr(), rows,
        _build.stream_ptr(x_in.device)))
    if inspect is not None:
        for k in ("qx", "sx", "kv"):
            off, shape, dtype = bufs[k]
            inspect[k] = ws[off:off + math.prod(shape) * dtype.itemsize].view(dtype).view(shape)
    return attn, probs, logits


x2y_flash_q8.launches = 0


def x2y_attention_q8(y_in, y_pos, x_in, x_pos, wk, bk, wv, bv, wq, bq, x_len, qweights=None):
    """The int8 X2Y entry: K8c when X > 1024 (the frames are the keys), else
    K8b (the frames are the queries), as JAX dispatches."""
    fn = x2y_flash_q8 if x_in.shape[1] >= FLASH_MIN_KEYS else x2y_small_x_q8
    return fn(y_in, y_pos, x_in, x_pos, wk, bk, wv, bv, wq, bq, x_len, qweights)


# ---------------------------------------------------------------------------
# K8d: SCA cross-attention with int8 K/V projections


class QKV(NamedTuple):
    """K8d's weights: the ``quantize_proj`` of Wk and Wv, and both in the
    card's layout (``k8d_layout``): pack (2E, Kw) int8, Wk's out channel n at
    row n and Wv's at E + n, zeros past Cx."""

    qk: QWeight
    qv: QWeight
    pack: torch.Tensor


class K8dLayout(NamedTuple):
    """K8d's padded widths at Cx input channels (csrc/q8_proj.cu): kseg =
    ceil32(Cx) in whole 32-byte wgmma steps, Kw the rows of the weight pack
    and Cw those of the int8 frame rows (ceil16(Cx)), each at least one
    128-byte TMA box."""

    kseg: int
    Kw: int
    Cw: int


def k8d_layout(Cx: int) -> K8dLayout:
    kseg = -(-Cx // 32) * 32
    return K8dLayout(kseg, max(kseg, 128), max(-(-Cx // 16) * 16, 128))


def quantize_kv(wk, wv) -> QKV:
    qk, qv = quantize_proj(wk), quantize_proj(wv)
    Kw = k8d_layout(wk.shape[0]).Kw
    return QKV(qk, qv, torch.cat([_pad_cols(qk.qt, Kw), _pad_cols(qv.qt, Kw)]).contiguous())


def mha_cross_q8_reference(q, x_in, x_pos, wk, bk, wv, bv, x_len, *, num_heads: int,
                           qweights=None):
    """Plain PyTorch version of ``mha_cross_attention_q8``: q (B, M, E)
    projected queries -> (B, M, E), the heads side by side.  ``qweights``:
    ``quantize_kv(wk, wv)``, made here when None."""
    qk, qv = (qweights or (quantize_proj(wk), quantize_proj(wv)))[:2]
    B, X, _ = x_in.shape
    M, E = q.shape[1], wk.shape[1]
    H = num_heads
    hd = E // H
    k = _proj_q8(add_pos(x_in, x_pos), qk, bk).view(B, X, H, hd)
    v = _proj_q8(x_in, qv, bv).view(B, X, H, hd)
    qh = (q * (1.0 / math.sqrt(hd))).view(B, M, H, hd)  # _arrange_queries
    logits = torch.einsum("bmhd,bxhd->bhmx", qh, k)
    valid = torch.arange(X, device=x_in.device)[None, None, None, :] < x_len[:, None, None, None]
    p = torch.softmax(logits.masked_fill(~valid, _NEG), dim=-1)
    return torch.einsum("bhmx,bxhd->bmhd", p, v).reshape(B, M, E)


def mha_cross_q8(q, x_in, x_pos, wk, bk, wv, bv, x_len, *, num_heads: int, qweights=None):
    """K8d on CUDA tensors, the plain version on CPU tensors.  ``qweights``
    as the plain version's."""
    _build.no_grad_inputs("mha_cross_q8", [q, x_in, x_pos, wk, bk, wv, bv])
    if x_in.device.type == "cpu":
        return mha_cross_q8_reference(q, x_in, x_pos, wk, bk, wv, bv, x_len,
                                      num_heads=num_heads, qweights=qweights)
    out = _mha_q8_card(q, x_in, x_pos, wk, bk, wv, bv, x_len, num_heads, qweights)
    mha_cross_q8.launches += 1
    return out


def _k8d_buffers(B: int, X: int, Cw: int, M: int, E: int, H: int):
    """K8d's buffers in one workspace, each at a 256-byte offset: the rows qx
    (2, B, X, Cw) int8 and their scales sx (2, B, X), kv (B, X, 2E), K3's
    partials over 64-key tiles.  ({name: (offset, shape, dtype)}, bytes)."""
    n_t = -(-X // FWD_KEY_TILE)
    parts = {"qx": ((2, B, X, Cw), torch.int8), "sx": ((2, B, X), torch.float32),
             "kv": ((B, X, 2 * E), torch.float32),
             "part_acc": ((B, n_t, H * M, E // H), torch.float32),
             "part_ml": ((B, n_t, H * M, 2), torch.float32)}
    out, off = {}, 0
    for name, (shape, dtype) in parts.items():
        out[name] = (off, shape, dtype)
        off += -(-math.prod(shape) * dtype.itemsize // 256) * 256
    return out, off


def _mha_q8_card(q, x_in, x_pos, wk, bk, wv, bv, x_len, num_heads, qweights, inspect=None):
    """``mha_cross_q8``'s one library call (csrc/q8_proj.cu): the frame rows
    quantized, the int8 [K | V] projection into K3's layout, then K3's
    attention and combine, into one workspace (CPU tensors reach it only in
    the tests, against a model of the library).  ``inspect`` (a dict)
    receives the quantized rows, their scales and the projection."""
    B, X, Cx = x_in.shape
    M, E = q.shape[1], wk.shape[1]
    H = num_heads
    if (q.shape != (B, M, E) or E % H or wk.shape != (Cx, E) or wv.shape != (Cx, E)
            or bk.shape != (E,) or bv.shape != (E,)):
        raise ValueError("mha_cross_q8: inconsistent shapes")
    if x_len.dtype != torch.int32 or x_len.shape != (B,):
        raise ValueError("mha_cross_q8: x_len must be (B,) int32")
    hd = E // H
    if E % 4 or not has_forward(M, E, H):
        raise NotImplementedError(f"mha_cross_q8: no kernel for M={M}, E={E}, H={H} (E a "
                                  f"multiple of 4, the attention's block {attn_smem(M, hd)} "
                                  f"bytes of shared memory, {_build.MAX_SMEM} at most)")
    qkv = quantize_kv(wk, wv) if qweights is None else qweights
    lay = k8d_layout(Cx)
    if qkv.pack.shape != (2 * E, lay.Kw):
        raise ValueError("mha_cross_q8: pack not in k8d_layout(Cx); use quantize_kv")
    x_in = x_in.contiguous()
    pos, p_stride, P = kernel_pos(x_pos, B, X, Cx)
    qs = (q * (1.0 / math.sqrt(hd))).contiguous()  # _arrange_queries folds the scale
    _build.check_tensors("mha_cross_q8", [qs, x_in, pos, bk, bv, x_len, *qkv.qk, *qkv.qv,
                                          qkv.pack], x_in.device)
    bufs, nbytes = _k8d_buffers(B, X, lay.Cw, M, E, H)
    ws = torch.empty(nbytes, device=x_in.device, dtype=torch.uint8)
    out = torch.empty((B, M, E), device=x_in.device, dtype=torch.float32)
    at = {name: ws.data_ptr() + off for name, (off, _, _) in bufs.items()}
    _build.check("fk_q8_mha_cross", _build.lib().fk_q8_mha_cross(
        x_in.data_ptr(), pos.data_ptr() if pos is not None else None, p_stride, P,
        qkv.pack.data_ptr(), lay.Kw, qkv.qk.s.data_ptr(), bk.data_ptr(), qkv.qv.s.data_ptr(),
        bv.data_ptr(), qs.data_ptr(), x_len.data_ptr(), B, X, Cx, lay.Cw, M, H, hd, at["qx"],
        at["sx"], at["kv"], at["part_acc"], at["part_ml"], out.data_ptr(),
        _build.stream_ptr(x_in.device)))
    if inspect is not None:
        for name in ("qx", "sx", "kv"):
            off, shape, dtype = bufs[name]
            inspect[name] = ws[off:off + math.prod(shape) * dtype.itemsize].view(dtype).view(shape)
    return out


mha_cross_q8.launches = 0
