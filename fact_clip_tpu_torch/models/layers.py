"""Network layers of FACT as PyTorch modules over batched, padded sequences.

Counterpart of ``fact_clip_tpu/models/layers.py``.  Attribute paths follow
the reference's torch modules, so ``state_dict()`` has exactly the keys that
``fact_clip_tpu/utils/torch_export.py::export_fact_state_dict`` emits (Conv1d
weights (out, in, k), Linear weights (out, in), packed ``in_proj_weight``
when kdim == E).  Each module that reaches a kernel keeps the kernel's
(in, out) layouts in a cache that is rebuilt when a weight changes.

``use_kernel`` (set from the block's ``pallas`` flags) sends the work to the
hand-written kernels, which themselves run their plain version on CPU
tensors; False is the plain PyTorch path everywhere.  Valid frames, keys and
segments are prefixes, so masks travel as lengths.

Train mode (``module.train()``) turns on dropout where the JAX modules have
it: every MSTCN layer (K1's in-kernel mask, seeded per layer) and every
MS-TCN++ layer but the last (K6's, the same mask), the attention
probabilities (K3's and K4's in-kernel masks on the fused paths), the X2Y
out map's two inputs, and the residual branches and FFN of the SA / SCA
layers.  Every draw comes from the ``generator`` passed down (a
``torch.Generator`` on the model's device); a kernel that drops out gets one
int32 seed per call, drawn on the device (as the JAX modules draw one per
fused call).  With gradients, the kernel layouts (and the LayerNorm
parameters of the fused sublayers) are the live parameters, so that autograd
reaches every one of them through the kernels' autograd entries (K1-K4, K6).

``quantize="int8"`` (``BlockCfg.quantize``) takes, in eval mode only, the
int8 paths of JAX's modules (ops/quant_conv.py): the MSTCN and MS-TCN++ in
maps and towers (K8a, K8e; the out projection a plain f32 dense), the X2Y
projection over the frame axis (K8b / K8c) and the fused SCA
cross-attention's K / V projections (K8d).  Their quantized weights sit in
the modules' caches.  Under ``set_kernels(False)`` those paths run the int8
plain versions (never f32), and the fused SCA branch is still chosen by the
configured kernel flag.  The towers' ``act_scale`` attribute ("tile", the
default, or "row") picks the activation scales of JAX's tower kernels; no
configuration sets it, and each form keeps its own quantized weights.

``dtype=torch.bfloat16`` (``BlockCfg.dtype``, ``TPU.compute_dtype:
bfloat16``) takes JAX's mixed-precision cast sites, each at the same point
(``fact_clip_tpu/models/layers.py``): the tower's in map a bf16 dense, its
stream bf16 and its logits f32 (K1's and K6's bf16 forms; a grouped tower
JAX's computation outside the kernels); the X2Y maps' and the
fused cross-attention's projections on bf16 operands (K2's and K3's bf16
forms), the out maps' stream bf16; the fused SA / FFN sublayers with bf16
operands (K4's bf16 form), the unfused attention's q / k / v and the FFN's
first dense bf16; softmax, LayerNorm, probabilities and logits f32.  The
bf16 weight layouts sit in the modules' caches.  Where a gradient is
wanted the kernels' bf16 training forms run (each a ``torch.autograd.
Function`` with its bf16 backward); the bf16 denses, the BiGRU and the TDU
go through PyTorch's autograd, whose cotangents of bf16 tensors are bf16,
as JAX's.  A bf16 module in train mode with dropout above 0 raises (ROADMAP
M7 item 5).  Under ``set_kernels(False)`` the bf16 paths run the kernels'
plain bf16 versions (forward and backward), the fused branches still
chosen by the configured kernel flags, as the int8 paths do.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.bf16 import BF16, dense16, mm
from ..ops.dilated_conv import (dilated_residual_layer, mstcn2_b16_pack, mstcn2_fold,
                                mstcn2_grouped16, mstcn2_stack, mstcn2_stack16,
                                mstcn2_stack16_reference, mstcn2_stack16_train,
                                mstcn2_stack_reference, mstcn_b16_pack, mstcn_grouped16,
                                mstcn_stack, mstcn_stack16, mstcn_stack16_reference,
                                mstcn_stack16_train, mstcn_stack_reference)
from ..ops.masking import dropout
from ..ops.mha_attn import (k3_b16_pack, k3_pack, mha_cross16_fwd, mha_cross16_reference,
                            mha_cross16_train, mha_cross_attention)
from ..ops.pos import add_pos, positional_encoding_table  # noqa: F401  (re-exported)
from ..ops.quant_conv import (dense_q8, mha_cross_q8, mha_cross_q8_reference, mstcn2_stack_q8,
                              mstcn2_stack_q8_reference, mstcn_stack_q8,
                              mstcn_stack_q8_reference, quantize_kv, quantize_tower, quantize_tower2,
                              quantize_x2y, x2y_attention_q8, x2y_attention_q8_reference)
from ..ops.sa_layer import (ffn_sublayer, ffn_sublayer16_fwd, ffn_sublayer16_reference,
                            ffn_sublayer16_train, sa_b16_pack, sa_sublayer, sa_sublayer16_fwd,
                            sa_sublayer16_reference, sa_sublayer16_train)
from ..ops.x2y_attn import (x2y_attention, x2y_attention16, x2y_attention16_reference,
                            x2y_attention16_train, x2y_attention_reference, x2y_b16_pack)

LN_EPS_ATTN = 1e-6  # flax LayerNorm default: SA/SCA sublayers and decoder norm
LN_EPS_TOWER = 1e-5  # the MSTCN tower's LayerNorm


def _uniform_(t, bound, g):
    with torch.no_grad():
        t.copy_(torch.empty(t.shape).uniform_(-bound, bound, generator=g))


def init_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded init that mirrors the JAX initializers (torch-default Linear /
    Conv1d bounds, xavier q/k/v, N(0, 1) action queries).  Children first, so
    a module's own rule overrides its children's defaults."""
    for m in reversed(list(model.modules())):
        if hasattr(m, "init_with"):
            m.init_with(generator)
        elif isinstance(m, (nn.Linear, nn.Conv1d)):
            fan_in = m.weight[0].numel()
            _uniform_(m.weight, 1.0 / math.sqrt(fan_in), generator)
            _uniform_(m.bias, 1.0 / math.sqrt(fan_in), generator)
        elif isinstance(m, nn.LayerNorm):
            with torch.no_grad():
                m.weight.fill_(1.0)
                m.bias.zero_()


class KernelLayout:
    """Mixin: ``kernel_layout()`` returns the tensors ``_make_kernel_layout``
    derives from the module's parameters, recomputed only after a parameter
    changed (moved, reloaded or updated in place).  ``layout()`` is that
    cache, or, when autograd must reach the parameters, the same tensors
    derived from the live parameters (``_make_kernel_layout(live=True)``)."""

    def kernel_layout(self):
        return self.cached("layout", self._make_kernel_layout)

    def cached(self, name: str, make):
        """``make()`` (under no_grad), recomputed only after a parameter changed."""
        key = tuple((p.data_ptr(), p._version) for p in self.parameters())
        cached = self.__dict__.get("_cached_" + name)
        if cached is None or cached[0] != key:
            with torch.no_grad():
                cached = (key, make())
            self.__dict__["_cached_" + name] = cached
        return cached[1]

    def layout(self):
        if torch.is_grad_enabled() and any(p.requires_grad for p in self.parameters()):
            return self._make_kernel_layout(live=True)
        return self.kernel_layout()


def _t(w, live: bool = False):
    return (w if live else w.detach()).t().contiguous()


def _d(w, live: bool = False):
    return w if live else w.detach()


def _drop(module, generator, x, rate: float):
    """Dropout in train mode, identity in eval mode."""
    if not module.training or rate <= 0.0:
        return x
    if generator is None:
        raise ValueError("train mode with dropout needs a generator")
    return dropout(generator, x, rate)


def _check16(module, *rates):
    """A bf16 module trains at rate 0 only: in train mode with dropout above
    0 it raises before any launch (ROADMAP M7 item 5)."""
    if module.training and any(r > 0.0 for r in (module.dropout, *rates)):
        raise NotImplementedError(f"{type(module).__name__}: training in bf16 (TPU.compute_dtype) "
                                  "with dropout > 0 is ROADMAP M7 item 5")


def _wants_grad(module, *tensors) -> bool:
    """A gradient must reach the module's parameters or these inputs: the
    bf16 forms' training entries run (their serving forms record nothing)."""
    return torch.is_grad_enabled() and (
        any(t is not None and t.requires_grad for t in tensors)
        or any(p.requires_grad for p in module.parameters()))


def _seeds(generator, n: int, device):
    """(n,) int32 seeds of in-kernel dropout, drawn on the device."""
    if generator is None:
        raise ValueError("train mode with dropout needs a generator")
    return torch.randint(0, 2 ** 31 - 1, (n,), generator=generator, device=device,
                         dtype=torch.int32)


# ---------------------------------------------------------------------------
# dilated temporal convolution tower


class DilatedResidualLayer(nn.Module, KernelLayout):
    """Dilated conv3 -> ReLU -> 1x1 -> dropout -> residual (-> LayerNorm).

    ``forward`` runs one layer alone, as JAX's ``DilatedResidualLayer.__call__``
    (layers.py:289-330): the single-layer K1 (``ops/dilated_conv.py::
    dilated_residual_layer``) when ungrouped with kernels on, else the plain
    layer.  The MSTCN tower does not call it: it runs its layers through the
    stack, as JAX's does."""

    def __init__(self, dilation: int, channels: int, ln: bool, ngroup: int = 1,
                 use_kernel: bool = False, dropout: float = 0.0):
        super().__init__()
        self.dilation = dilation
        self.dropout = dropout
        self.conv_dilated = nn.Conv1d(channels, channels, 3, padding=dilation,
                                      dilation=dilation, groups=ngroup)
        self.conv_1x1 = nn.Conv1d(channels, channels, 1)
        self.norm = nn.LayerNorm(channels, eps=LN_EPS_TOWER) if ln else None
        # the fused layer is ungrouped (layers.py:301)
        self.kernel_allowed = use_kernel and ngroup == 1
        self.use_kernel = self.kernel_allowed

    def forward(self, x, mask, generator=None):
        """x (B, T, C), mask (B, T) bool: the layer on the masked input, every
        frame written (no write mask); dropout in train mode from
        ``generator`` (the kernel path draws one int32 seed on the device)."""
        xm = x * mask[:, :, None].to(x.dtype)
        rate = self.dropout if self.training else 0.0
        if self.use_kernel:
            seed = _seeds(generator, 1, x.device) if rate > 0.0 else None
            return dilated_residual_layer(xm, *self.layout(), dilation=self.dilation,
                                          use_ln=self.norm is not None, eps=LN_EPS_TOWER,
                                          rate=rate, seed=seed)
        out = torch.relu(self.conv_dilated(xm.transpose(1, 2))).transpose(1, 2)
        out = _drop(self, generator, F.linear(out, self.conv_1x1.weight[:, :, 0],
                                              self.conv_1x1.bias), self.dropout)
        z = xm + out
        return self.norm(z) if self.norm is not None else z

    def _make_kernel_layout(self, live: bool = False):
        C = self.conv_1x1.weight.shape[0]
        ones = torch.ones(C, device=self.conv_1x1.weight.device)
        return (_d(self.conv_dilated.weight, live).permute(2, 1, 0).contiguous(),  # (k, in, out)
                _d(self.conv_dilated.bias, live), _t(self.conv_1x1.weight[:, :, 0], live),
                _d(self.conv_1x1.bias, live),
                _d(self.norm.weight, live) if self.norm is not None else ones,
                _d(self.norm.bias, live) if self.norm is not None else torch.zeros_like(ones))


class MSTCN(nn.Module, KernelLayout):
    """1x1 in map -> dilated residual layers -> 1x1 out map (f32 logits)."""

    act_scale = "tile"  # the int8 tower's activation scales (ops/quant_conv.py)

    def __init__(self, in_dim, hid_dim, out_dim, num_layers, ln, ngroup=1, in_map=False,
                 use_kernel=True, dropout=0.0, quantize="", dtype=None):
        super().__init__()
        self.dropout = dropout
        self.quantize = quantize
        self.dtype = dtype
        if in_map:
            self.conv_1x1 = nn.Conv1d(in_dim, hid_dim, 1)
        elif in_dim != hid_dim:
            raise ValueError("MSTCN without in_map needs in_dim == hid_dim")
        self.in_map = in_map
        self.ln = ln
        self.ngroup = ngroup
        self.layers = nn.ModuleList(
            DilatedResidualLayer(2 ** i, hid_dim, ln, ngroup, use_kernel, dropout)
            for i in range(num_layers))
        self.conv_out = nn.Conv1d(hid_dim, out_dim, 1)
        self.kernel_allowed = ngroup == 1  # the fused tower is ungrouped (layers.py:372)
        self.use_kernel = use_kernel and self.kernel_allowed

    def _make_kernel_layout(self, live: bool = False):
        return _t(self.conv_out.weight[:, :, 0], live), _d(self.conv_out.bias, live)

    def forward(self, x, lengths, generator=None):
        if self.quantize == "int8" and not self.training and self.kernel_allowed:
            return self._forward_q8(x, lengths)
        if self.dtype == BF16:
            return self._forward16(x, lengths)
        if self.in_map:
            x = F.linear(x, self.conv_1x1.weight[:, :, 0], self.conv_1x1.bias)
        ow, ob = self.layout()
        L = len(self.layers)
        rates = seeds = None
        if self.training and self.dropout > 0.0:
            # one seed per layer, drawn on the device (layers.py:391-395)
            rates = (float(self.dropout),) * L
            seeds = _seeds(generator, L, x.device)
        fn = mstcn_stack if self.use_kernel else mstcn_stack_reference
        return fn(x.contiguous(), lengths, [l.layout() for l in self.layers],
                  [l.dilation for l in self.layers], use_ln=self.ln, eps=LN_EPS_TOWER,
                  out_w=ow, out_b=ob, rates=rates, seeds=seeds)

    def _forward16(self, x, lengths):
        """JAX's mixed-precision path (layers.py:353-421): the in map a bf16
        dense, the stream bf16, the tower (K1's bf16 form, its out projection
        inside) giving f32 logits."""
        _check16(self)
        if self.in_map:
            x = dense16(x, self.conv_1x1.weight[:, :, 0], self.conv_1x1.bias)
        dil = [l.dilation for l in self.layers]
        if not self.kernel_allowed:  # grouped: JAX's unfused layers (layers.py:290-331)
            ow, ob = self.layout()
            return mstcn_grouped16(x.to(BF16).contiguous(), lengths,
                                   [l.layout() for l in self.layers], dil, out_w=ow, out_b=ob)
        train = _wants_grad(self, x)
        layers = [l.layout() if train else l.kernel_layout() for l in self.layers]
        ow, ob = self.layout() if train else self.kernel_layout()
        args = (x.to(BF16).contiguous(), lengths, layers, dil)
        packed = (self.cached("b16", lambda: mstcn_b16_pack(layers, ow))
                  if x.is_cuda and self.use_kernel else None)
        if train:  # the training form (K1's bf16 backward, or its plain version)
            return mstcn_stack16_train(*args, out_w=ow, out_b=ob, plain=not self.use_kernel,
                                       packed=packed)
        if not self.use_kernel:
            return mstcn_stack16_reference(*args, out_w=ow, out_b=ob)
        return mstcn_stack16(*args, out_w=ow, out_b=ob, packed=packed)

    def _forward_q8(self, x, lengths):
        """JAX's int8 eval path (layers.py:353-385): the in map through
        ``dense_q8``, the tower through K8a, then the out projection as a
        plain f32 dense (JAX does not fuse it on this path)."""
        if self.in_map:
            x = dense_q8(x, self.conv_1x1.weight[:, :, 0].t(), self.conv_1x1.bias,
                         library=self.use_kernel)
        form = self.act_scale
        qlayers = self.cached("q8_" + form, lambda: quantize_tower(
            [l.kernel_layout() for l in self.layers], form))
        fn = mstcn_stack_q8 if self.use_kernel else mstcn_stack_q8_reference
        y = fn(x.contiguous(), lengths, qlayers, [l.dilation for l in self.layers], use_ln=self.ln,
               eps=LN_EPS_TOWER, act_scale=form)
        return F.linear(y, self.conv_out.weight[:, :, 0], self.conv_out.bias)


class MSTCN2(nn.Module, KernelLayout):
    """MS-TCN++ dual-dilation tower (``layers.py:424-514``): 1x1 in map (the
    input block's), then per layer two dilated conv3s of the masked stream
    (d1 = 2^(L-1-i), d2 = 2^i), a 1x1 fuse of their concatenation, ReLU,
    dropout (all but the last layer) and the residual, then the 1x1 out map
    (f32 logits).  The in map is a plain ``F.linear`` (a bf16 dense under
    mixed precision): JAX computes it outside any kernel.  Module paths are the reference's torch keys
    (``conv_1x1_in``, ``conv_dilated_1.{i}``, ``conv_dilated_2.{i}``,
    ``conv_fusion.{i}``, ``conv_out``)."""

    act_scale = "tile"  # the int8 tower's activation scales (ops/quant_conv.py)

    def __init__(self, in_dim, hid_dim, out_dim, num_layers, ngroup=1, in_map=True,
                 use_kernel=True, dropout=0.0, quantize="", dtype=None):
        super().__init__()
        self.dropout = dropout
        self.quantize = quantize
        self.dtype = dtype
        if in_map:
            self.conv_1x1_in = nn.Conv1d(in_dim, hid_dim, 1)
        elif in_dim != hid_dim:
            raise ValueError("MSTCN2 without in_map needs in_dim == hid_dim")
        self.in_map = in_map
        L = num_layers
        self.dil_pairs = [(2 ** (L - 1 - i), 2 ** i) for i in range(L)]

        def dilated(d):
            return nn.Conv1d(hid_dim, hid_dim, 3, padding=d, dilation=d, groups=ngroup)

        self.conv_dilated_1 = nn.ModuleList(dilated(d1) for d1, _ in self.dil_pairs)
        self.conv_dilated_2 = nn.ModuleList(dilated(d2) for _, d2 in self.dil_pairs)
        self.conv_fusion = nn.ModuleList(nn.Conv1d(2 * hid_dim, hid_dim, 1) for _ in range(L))
        self.conv_out = nn.Conv1d(hid_dim, out_dim, 1)
        self.kernel_allowed = ngroup == 1  # the fused tower is ungrouped (layers.py:465)
        self.use_kernel = use_kernel and self.kernel_allowed

    def _layers(self, live: bool = False):
        """[(k1, b1, k2, b2, wt, wb, bf)] per layer in the JAX layout."""
        layers = []
        for c1, c2, fu in zip(self.conv_dilated_1, self.conv_dilated_2, self.conv_fusion):
            C = fu.weight.shape[0]
            layers.append((_d(c1.weight, live).permute(2, 1, 0).contiguous(), _d(c1.bias, live),
                           _d(c2.weight, live).permute(2, 1, 0).contiguous(), _d(c2.bias, live),
                           _t(fu.weight[:, :C, 0], live), _t(fu.weight[:, C:, 0], live),
                           _d(fu.bias, live)))
        return layers

    def _make_kernel_layout(self, live: bool = False):
        """(layers, ow, ob) in the JAX layout, and the folded weights of K6's
        serving form when the tower serves on the card (None otherwise: the
        forward then folds them per call if it needs them)."""
        layers = self._layers(live)
        folded = (mstcn2_fold(layers) if not live and self.use_kernel and self.dtype != BF16
                  and self.conv_out.weight.is_cuda else None)
        return (layers, _t(self.conv_out.weight[:, :, 0], live), _d(self.conv_out.bias, live),
                folded)

    def forward(self, x, lengths, generator=None):
        if self.quantize == "int8" and not self.training and self.kernel_allowed:
            return self._forward_q8(x, lengths)
        if self.dtype == BF16:
            return self._forward16(x, lengths)
        if self.in_map:
            x = F.linear(x, self.conv_1x1_in.weight[:, :, 0], self.conv_1x1_in.bias)
        layers, ow, ob, folded = self.layout()
        L = len(layers)
        rates = seeds = None
        if self.training and self.dropout > 0.0:
            # one seed per layer, drawn on the device; the last layer keeps
            # every value (layers.py:480-489)
            rates = (float(self.dropout),) * (L - 1) + (0.0,)
            seeds = _seeds(generator, L, x.device)
        if not self.use_kernel:
            return mstcn2_stack_reference(x.contiguous(), lengths, layers, self.dil_pairs,
                                          out_w=ow, out_b=ob, rates=rates, seeds=seeds)
        return mstcn2_stack(x.contiguous(), lengths, layers, self.dil_pairs, out_w=ow, out_b=ob,
                            rates=rates, seeds=seeds, folded=folded)

    def _forward16(self, x, lengths):
        """JAX's mixed-precision path (layers.py:442-513): the in map a bf16
        dense, the stream bf16, the tower (K6's bf16 form, its out projection
        inside; a grouped tower JAX's computation outside the kernel) giving
        f32 logits."""
        _check16(self)
        if self.in_map:
            x = dense16(x, self.conv_1x1_in.weight[:, :, 0], self.conv_1x1_in.bias)
        x = x.to(BF16).contiguous()
        train = _wants_grad(self, x)
        layers, ow, ob, _ = self.layout() if train else self.kernel_layout()
        if not self.kernel_allowed:  # grouped (layers.py:494-513)
            return mstcn2_grouped16(x, lengths, layers, self.dil_pairs, out_w=ow, out_b=ob)
        args = (x, lengths, layers, self.dil_pairs)
        packed = (self.cached("b16", lambda: mstcn2_b16_pack(layers, ow))
                  if x.is_cuda and self.use_kernel else None)
        if train:  # the training form (K6's bf16 backward, or its plain version)
            return mstcn2_stack16_train(*args, out_w=ow, out_b=ob, plain=not self.use_kernel,
                                        packed=packed)
        if not self.use_kernel:
            return mstcn2_stack16_reference(*args, out_w=ow, out_b=ob)
        return mstcn2_stack16(*args, out_w=ow, out_b=ob, packed=packed)

    def _forward_q8(self, x, lengths):
        """JAX's int8 eval path (layers.py:441-476): the in map through
        ``dense_q8``, the tower through K8e, then the out projection as a
        plain f32 dense (JAX does not fuse it on this path; its parameters
        keep the f32 path's names)."""
        if self.in_map:
            x = dense_q8(x, self.conv_1x1_in.weight[:, :, 0].t(), self.conv_1x1_in.bias,
                         library=self.use_kernel)
        form = self.act_scale
        qlayers = self.cached("q8_" + form, lambda: quantize_tower2(self._layers(), form))
        fn = mstcn2_stack_q8 if self.use_kernel else mstcn2_stack_q8_reference
        y = fn(x.contiguous(), lengths, qlayers, self.dil_pairs, act_scale=form)
        return F.linear(y, self.conv_out.weight[:, :, 0], self.conv_out.bias)


# ---------------------------------------------------------------------------
# attention


class MultiheadAttention(nn.Module, KernelLayout):
    """torch ``nn.MultiheadAttention`` parameter layout (batch-first), prefix
    key masks.  With ``use_kernel``, long-key cross-attention to raw memory
    runs K3 under the JAX fuse conditions (layers.py:649-655)."""

    def __init__(self, embed_dim: int, num_heads: int, kdim: int | None = None,
                 use_kernel: bool = False, kernel_min_keys: int = 1024, dropout: float = 0.0,
                 quantize: str = "", dtype=None):
        super().__init__()
        self.dropout = dropout
        self.quantize = quantize
        self.dtype = dtype
        E = embed_dim
        kdim = kdim or E
        self.embed_dim, self.num_heads, self.kdim = E, num_heads, kdim
        self.packed = kdim == E
        if self.packed:
            self.in_proj_weight = nn.Parameter(torch.empty(3 * E, E))
        else:
            self.q_proj_weight = nn.Parameter(torch.empty(E, E))
            self.k_proj_weight = nn.Parameter(torch.empty(E, kdim))
            self.v_proj_weight = nn.Parameter(torch.empty(E, kdim))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * E))
        self.out_proj = nn.Linear(E, E)
        self.kernel_allowed = use_kernel
        self.use_kernel = use_kernel
        self.kernel_min_keys = kernel_min_keys

    def init_with(self, g):
        E = self.embed_dim
        for w in self.proj_weights():
            _uniform_(w, math.sqrt(6.0 / (w.shape[0] + w.shape[1])), g)
        with torch.no_grad():
            self.in_proj_bias.zero_()
            self.out_proj.bias.zero_()
        _uniform_(self.out_proj.weight, 1.0 / math.sqrt(E), g)

    def proj_weights(self):
        """(Wq, Wk, Wv) in (out, in) layout (views of the packed weight)."""
        if self.packed:
            return self.in_proj_weight.chunk(3)
        return self.q_proj_weight, self.k_proj_weight, self.v_proj_weight

    def _make_kernel_layout(self, live: bool = False):
        wq, wk, wv = self.proj_weights()
        bq, bk, bv = _d(self.in_proj_bias, live).chunk(3)
        return (_t(wq, live), bq.contiguous(), _t(wk, live), bk.contiguous(), _t(wv, live),
                bv.contiguous(), _t(self.out_proj.weight, live), _d(self.out_proj.bias, live))

    def _fuses(self, key, value) -> bool:
        """JAX's conditions for the fused cross-attention (layers.py:649-655)."""
        return (key.shape[1] >= self.kernel_min_keys and key is value
                and self.embed_dim % 128 == 0 and key.shape[-1] % 128 == 0)

    def forward(self, query, key, value, key_len=None, key_pos=None, generator=None):
        if self.dtype == BF16:
            return self._forward16(query, key, value, key_len, key_pos)
        E, H = self.embed_dim, self.num_heads
        hd = E // H
        wq, wk, wv = self.proj_weights()
        bq, bk, bv = self.in_proj_bias.chunk(3)
        q = F.linear(query, wq, bq)
        B, M, _ = q.shape
        Nk = key.shape[1]
        q8 = self.quantize == "int8" and not self.training
        fuse = (self.kernel_allowed if q8 else self.use_kernel) and self._fuses(key, value)
        if fuse:
            _, _, wk_t, bk_c, wv_t, bv_c, _, _ = self.layout()
            if key_len is None:
                key_len = torch.full((B,), Nk, dtype=torch.int32, device=key.device)
            if q8:  # K8d: int8 K / V projections (layers.py:673-681)
                qw = self.cached("q8", lambda: quantize_kv(wk_t, wv_t))
                fn = mha_cross_q8 if self.use_kernel else mha_cross_q8_reference
                return self.out_proj(fn(q, key, key_pos, wk_t, bk_c, wv_t, bv_c, key_len,
                                        num_heads=H, qweights=qw))
            rate = self.dropout if self.training else 0.0
            # one seed per call (layers.py:662-665)
            seed = _seeds(generator, 1, key.device) if rate > 0.0 else None
            # serving keeps the projection's packed weights while the weights do
            # not change; a training step packs them in the kernels (nothing kept)
            packed = (self.cached("k3", lambda: k3_pack(wk_t, bk_c, wv_t, bv_c))
                      if key.device.type == "cuda" and not torch.is_grad_enabled() else None)
            out = mha_cross_attention(q, key, key_pos, wk_t, bk_c, wv_t, bv_c, key_len,
                                      num_heads=H, rate=rate, seed=seed, packed=packed)
            return self.out_proj(out)
        k = F.linear(add_pos(key, key_pos), wk, bk).view(B, Nk, H, hd)
        v = F.linear(value, wv, bv).view(B, Nk, H, hd)
        logits = torch.einsum("bmhd,bnhd->bhmn", q.view(B, M, H, hd), k) / math.sqrt(hd)
        if key_len is not None:
            valid = torch.arange(Nk, device=key.device)[None, :] < key_len[:, None]
            logits = logits.masked_fill(~valid[:, None, None, :], float("-inf"))
        probs = _drop(self, generator, torch.softmax(logits, dim=-1), self.dropout)
        out = torch.einsum("bhmn,bnhd->bmhd", probs, v)
        return self.out_proj(out.reshape(B, M, E))

    def _forward16(self, query, key, value, key_len, key_pos):
        """JAX's mixed-precision attention (layers.py:627-720): q a bf16
        dense; fused (K3's bf16 form, or its plain version without kernels)
        where the configured kernel flag and JAX's conditions hold, else k and
        v bf16 denses (k of x + pos in f32), the logits, softmax and the
        attend sum over bf16 probabilities in f32; the out projection f32."""
        _check16(self)
        E, H = self.embed_dim, self.num_heads
        hd = E // H
        wq, wk, wv = self.proj_weights()
        bq, bk, bv = self.in_proj_bias.chunk(3)
        q = dense16(query, wq, bq)
        B, M, _ = q.shape
        Nk = key.shape[1]
        if self.kernel_allowed and self._fuses(key, value):
            train = _wants_grad(self, q, value)
            _, _, wk_t, bk_c, wv_t, bv_c, _, _ = self.layout() if train else self.kernel_layout()
            if key_len is None:
                key_len = torch.full((B,), Nk, dtype=torch.int32, device=key.device)
            args = (q, value.to(BF16).contiguous(), None if key_pos is None else key_pos.to(BF16),
                    wk_t, bk_c, wv_t, bv_c, key_len)
            packed = (self.cached("k3_16", lambda: k3_b16_pack(wk_t, wv_t))
                      if key.is_cuda and self.use_kernel else None)
            if train:  # the training form (K3's bf16 backward, or its plain version)
                return self.out_proj(mha_cross16_train(*args, num_heads=H,
                                                       plain=not self.use_kernel, packed=packed))
            if not self.use_kernel:
                return self.out_proj(mha_cross16_reference(*args, num_heads=H))
            return self.out_proj(mha_cross16_fwd(*args, num_heads=H, packed=packed))
        k = dense16(add_pos(key.float(), key_pos), wk, bk).float().view(B, Nk, H, hd)
        v = dense16(value, wv, bv).float().view(B, Nk, H, hd)
        logits = torch.einsum("bmhd,bnhd->bhmn", q.float().view(B, M, H, hd), k) / math.sqrt(hd)
        if key_len is not None:
            valid = torch.arange(Nk, device=key.device)[None, :] < key_len[:, None]
            logits = logits.masked_fill(~valid[:, None, None, :], float("-inf"))
        probs = torch.softmax(logits, dim=-1).to(BF16).float()
        return self.out_proj(torch.einsum("bhmn,bnhd->bmhd", probs, v).reshape(B, M, E))


class X2YMap(nn.Module, KernelLayout):
    """Single-head cross-attention: K/V from X, Q from Y, out map of
    concat(Y, attended); returns (y_out, probs, logits), probs/logits (B, Y, X)."""

    def __init__(self, x_dim, y_dim, y_outdim, head_dim, kq_pos=False, use_kernel=True,
                 dropout=0.0, quantize="", dtype=None):
        super().__init__()
        self.dropout = dropout
        self.quantize = quantize
        self.dtype = dtype
        self.X_K = nn.Linear(x_dim, head_dim)
        self.X_V = nn.Linear(x_dim, head_dim)
        self.Y_Q = nn.Linear(y_dim, head_dim)
        self.Y_W = nn.Linear(y_dim + head_dim, y_outdim)
        self.kq_pos = kq_pos
        self.kernel_allowed = use_kernel
        self.use_kernel = use_kernel

    def _make_kernel_layout(self, live: bool = False):
        return (_t(self.X_K.weight, live), _d(self.X_K.bias, live), _t(self.X_V.weight, live),
                _d(self.X_V.bias, live), _t(self.Y_Q.weight, live), _d(self.Y_Q.bias, live))

    def forward(self, x, y, x_pos=None, y_pos=None, x_len=None, generator=None):
        if not self.kq_pos:
            x_pos = y_pos = None
        if x_len is None:
            x_len = torch.full((x.shape[0],), x.shape[1], dtype=torch.int32, device=x.device)
        if self.dtype == BF16:
            return self._forward16(x, y, x_pos, y_pos, x_len)
        if self.quantize == "int8" and not self.training:
            # K8b / K8c: int8 projection over the frame axis (layers.py:762-765)
            layout = self.layout()
            qw = self.cached("q8", lambda: quantize_x2y(*layout[0:6:2]))
            fn = x2y_attention_q8 if self.use_kernel else x2y_attention_q8_reference
            attn, probs, logits = fn(y.contiguous(), y_pos, x.contiguous(), x_pos, *layout, x_len,
                                     qw)
        else:
            fn = x2y_attention if self.use_kernel else x2y_attention_reference
            attn, probs, logits = fn(y.contiguous(), y_pos, x.contiguous(), x_pos, *self.layout(),
                                     x_len)
        # out map as a split dense of the dropped-out inputs: concat([y, attn])
        # never materializes
        W = self.Y_W.weight
        Cy = y.shape[-1]
        y_out = (F.linear(_drop(self, generator, y, self.dropout), W[:, :Cy])
                 + F.linear(_drop(self, generator, attn, self.dropout), W[:, Cy:], self.Y_W.bias))
        return y_out, probs, logits

    def _forward16(self, x, y, x_pos, y_pos, x_len):
        """JAX's mixed-precision map (layers.py:762-825): K2's bf16 form (or
        its plain version without kernels) on bf16 x and y, then the split
        out map on bf16 operands in f32, emitted as the bf16 stream;
        probabilities and logits f32."""
        _check16(self)
        train = _wants_grad(self, x, y)
        layout = self.layout() if train else self.kernel_layout()
        args = (y.to(BF16).contiguous(), y_pos, x.to(BF16).contiguous(), x_pos, *layout, x_len)
        packed = (self.cached("b16", lambda: x2y_b16_pack(*layout[0:6:2]))
                  if x.is_cuda and self.use_kernel else None)
        if train:  # the training form (K2's bf16 backwards, or their plain version)
            attn, probs, logits = x2y_attention16_train(*args, plain=not self.use_kernel,
                                                        packed=packed)
        elif self.use_kernel:
            attn, probs, logits = x2y_attention16(*args, packed=packed)
        else:
            attn, probs, logits = x2y_attention16_reference(*args)
        W = self.Y_W.weight
        Cy = y.shape[-1]
        y_out = mm(y, W[:, :Cy].t()) + mm(attn, W[:, Cy:].t()) + self.Y_W.bias
        return y_out.to(BF16), probs, logits


def _shared_pos(pos):
    """One positional table for the whole batch (the fused sublayers' layout)."""
    return pos is None or pos.dim() == 2 or pos.shape[0] == 1


def _ffn_layout(layer, live: bool = False):
    """(W1, b1, W2, b2) of a post-norm layer in the kernel's (in, out) layout."""
    return (_t(layer.linear1.weight, live), _d(layer.linear1.bias, live),
            _t(layer.linear2.weight, live), _d(layer.linear2.bias, live))


def _fused_sublayers(layer, attn, tgt, pos, norm_sa, norm_ffn, generator, between=None):
    """K4: the self-attention sublayer, then (after ``between``) the FFN one,
    on the live parameters (differentiable); in train mode each sublayer
    drops out in-kernel from its own seed (layers.py:899, :904)."""
    sa, ffn = layer.layout()
    rate = layer.dropout if layer.training else 0.0
    rate_attn = attn.dropout if layer.training else 0.0
    seeds = _seeds(generator, 2, tgt.device) if rate > 0.0 or rate_attn > 0.0 else None
    y = sa_sublayer(tgt, pos, *sa, norm_sa.weight, norm_sa.bias, num_heads=attn.num_heads,
                    eps=norm_sa.eps, rate_attn=rate_attn, rate=rate,
                    seed=seeds[:1] if seeds is not None else None)
    if between is not None:
        y = between(y)
    return ffn_sublayer(y, *ffn, norm_ffn.weight, norm_ffn.bias, eps=norm_ffn.eps, rate=rate,
                        seed=seeds[1:] if seeds is not None else None)


def _fused_sublayers16(layer, attn, tgt, pos, norm_sa, norm_ffn, between=None):
    """K4's bf16 form (or its plain version without kernels): the SA and FFN
    sublayers on f32 x with bf16 operands inside (JAX's ``bf16=True``,
    layers.py:894-906)."""
    _check16(layer, attn.dropout)
    train = _wants_grad(layer, tgt)
    sa, ffn = layer.layout() if train else layer.kernel_layout()
    cuda = tgt.is_cuda and layer.use_kernel
    packs = layer.cached("b16", lambda: (sa_b16_pack(*sa[0:6:2]), ffn[0].to(BF16))) \
        if cuda else (None, None)
    if train:  # the training forms (K4's bf16 backwards, or their plain versions)
        plain = not layer.use_kernel
        sa_fn = lambda *a, **k: sa_sublayer16_train(  # noqa: E731
            *a, **k, plain=plain, packed=packs[0])
        ffn_fn = lambda *a, **k: ffn_sublayer16_train(  # noqa: E731
            *a, **k, plain=plain, packed=packs[1])
    elif layer.use_kernel:
        sa_fn = lambda *a, **k: sa_sublayer16_fwd(*a, **k, packed=packs[0])  # noqa: E731
        ffn_fn = lambda *a, **k: ffn_sublayer16_fwd(*a, **k, packed=packs[1])  # noqa: E731
    else:
        sa_fn, ffn_fn = sa_sublayer16_reference, ffn_sublayer16_reference
    y = sa_fn(tgt.float().contiguous(), pos, *sa, norm_sa.weight, norm_sa.bias,
              num_heads=attn.num_heads, eps=norm_sa.eps)
    if between is not None:
        y = between(y)
    return ffn_fn(y.contiguous(), *ffn, norm_ffn.weight, norm_ffn.bias, eps=norm_ffn.eps)


def _ffn(layer, tgt, norm, generator):
    """norm(tgt + drop(linear2(drop(relu(linear1(tgt)))))); under bf16 the
    first dense is a bf16 one and the second f32 (layers.py:916-918)."""
    if layer.dtype == BF16:
        ff = torch.relu(dense16(tgt, layer.linear1.weight, layer.linear1.bias)).float()
        return norm(tgt + layer.linear2(ff))
    ff = _drop(layer, generator, torch.relu(layer.linear1(tgt)), layer.dropout)
    return norm(tgt + _drop(layer, generator, layer.linear2(ff), layer.dropout))


class SALayer(nn.Module, KernelLayout):
    """Post-norm self-attention + FFN over action tokens (K4 when fused)."""

    def __init__(self, dim, nhead, ffdim, use_kernel=True, dropout=0.0, dtype=None):
        super().__init__()
        self.dropout = dropout
        self.dtype = dtype
        self.multihead_attn = MultiheadAttention(dim, nhead, dropout=dropout, dtype=dtype)
        self.linear1 = nn.Linear(dim, ffdim)
        self.linear2 = nn.Linear(ffdim, dim)
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS_ATTN)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS_ATTN)
        self.nhead = nhead
        self.kernel_allowed = use_kernel and dim % nhead == 0
        self.use_kernel = self.kernel_allowed

    def _make_kernel_layout(self, live: bool = False):
        return self.multihead_attn._make_kernel_layout(live), _ffn_layout(self, live)

    def forward(self, tgt, pos=None, generator=None):
        if self.dtype == BF16 and self.kernel_allowed and _shared_pos(pos):
            return _fused_sublayers16(self, self.multihead_attn, tgt, pos, self.norm1,
                                      self.norm2)
        if self.use_kernel and _shared_pos(pos):
            return _fused_sublayers(self, self.multihead_attn, tgt, pos, self.norm1, self.norm2,
                                    generator)
        q = add_pos(tgt, pos)
        t2 = self.multihead_attn(q, q, tgt, generator=generator)
        tgt = self.norm1(tgt + _drop(self, generator, t2, self.dropout))
        return _ffn(self, tgt, self.norm2, generator)


class SCALayer(nn.Module, KernelLayout):
    """Token self-attention, cross-attention to the frame memory, FFN."""

    def __init__(self, dim, frame_dim, nhead, ffdim, use_kernel_sa=True, use_kernel_attn=True,
                 dropout=0.0, quantize="", dtype=None):
        super().__init__()
        self.dropout = dropout
        self.dtype = dtype
        self.self_attn = MultiheadAttention(dim, nhead, dropout=dropout, dtype=dtype)
        self.multihead_attn = MultiheadAttention(dim, nhead, kdim=frame_dim,
                                                 use_kernel=use_kernel_attn, dropout=dropout,
                                                 quantize=quantize, dtype=dtype)
        self.linear1 = nn.Linear(dim, ffdim)
        self.linear2 = nn.Linear(ffdim, dim)
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS_ATTN)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS_ATTN)
        self.norm3 = nn.LayerNorm(dim, eps=LN_EPS_ATTN)
        self.nhead = nhead
        self.kernel_allowed = use_kernel_sa and dim % nhead == 0
        self.use_kernel = self.kernel_allowed

    def _make_kernel_layout(self, live: bool = False):
        return self.self_attn._make_kernel_layout(live), _ffn_layout(self, live)

    def forward(self, tgt, memory, pos=None, query_pos=None, memory_len=None, generator=None):
        def cross(t):
            t2 = self.multihead_attn(add_pos(t, query_pos), memory, memory,
                                     key_len=memory_len, key_pos=pos, generator=generator)
            return self.norm2(t + _drop(self, generator, t2, self.dropout))

        if self.dtype == BF16 and self.kernel_allowed and _shared_pos(query_pos):
            return _fused_sublayers16(self, self.self_attn, tgt, query_pos, self.norm1,
                                      self.norm3, between=cross)
        if self.use_kernel and _shared_pos(query_pos):
            return _fused_sublayers(self, self.self_attn, tgt, query_pos, self.norm1,
                                    self.norm3, generator, between=cross)
        q = add_pos(tgt, query_pos)
        t2 = self.self_attn(q, q, tgt, generator=generator)
        tgt = cross(self.norm1(tgt + _drop(self, generator, t2, self.dropout)))
        return _ffn(self, tgt, self.norm3, generator)


class SADecoder(nn.Module):
    """N self-attention layers + output linear."""

    def __init__(self, in_dim, hid_dim, out_dim, num_layers, nhead, ffdim, use_kernel=True,
                 dropout=0.0, dtype=None):
        super().__init__()
        if in_dim != hid_dim:
            raise ValueError("SADecoder needs in_dim == hid_dim")
        self.layers = nn.ModuleList(SALayer(hid_dim, nhead, ffdim, use_kernel, dropout, dtype)
                                    for _ in range(num_layers))
        self.out_linear = nn.Linear(hid_dim, out_dim)

    def forward(self, tgt, pos=None, generator=None):
        for layer in self.layers:
            tgt = layer(tgt, pos, generator=generator)
        return self.out_linear(tgt)


class SCADecoder(nn.Module):
    """N SCA layers + final LayerNorm + output linear."""

    def __init__(self, in_dim, hid_dim, out_dim, frame_dim, num_layers, nhead, ffdim,
                 use_kernel_sa=True, use_kernel_attn=True, dropout=0.0, quantize="", dtype=None):
        super().__init__()
        if in_dim != hid_dim:
            raise ValueError("SCADecoder needs in_dim == hid_dim")
        self.layers = nn.ModuleList(
            SCALayer(hid_dim, frame_dim, nhead, ffdim, use_kernel_sa, use_kernel_attn, dropout,
                     quantize, dtype)
            for _ in range(num_layers))
        self.norm = nn.LayerNorm(hid_dim, eps=LN_EPS_ATTN)
        self.out_linear = nn.Linear(hid_dim, out_dim)

    def forward(self, tgt, memory, pos=None, query_pos=None, memory_len=None, generator=None):
        for layer in self.layers:
            tgt = layer(tgt, memory, pos=pos, query_pos=query_pos, memory_len=memory_len,
                        generator=generator)
        return self.out_linear(self.norm(tgt))


# ---------------------------------------------------------------------------
# GRU


class BiGRU(nn.Module):
    """Bidirectional GRU over prefix-valid sequences (``nn.GRU`` parameter
    names).  Matches the JAX masked scan (``layers.py:1111-1183``) on every
    step: the forward direction runs over the padded sequence (padding only
    follows the valid steps) and its state is held at the last valid step's
    over the padding; the backward direction runs over each sequence's valid
    prefix reversed in place, so it enters the valid region from the last
    valid step with a zero state, and it is 0 over the padding.  In train
    mode every layer's output but the last's is dropped out at ``dropout``
    (torch's inter-layer dropout) from the ``generator`` passed in.  Plain
    PyTorch: no Pallas kernel exists for it."""

    def __init__(self, input_size: int, hidden: int, num_layers: int, dropout: float = 0.0):
        super().__init__()
        self.hidden, self.num_layers, self.dropout = hidden, num_layers, dropout
        for layer in range(num_layers):
            in_dim = input_size if layer == 0 else 2 * hidden
            for sfx in ("", "_reverse"):
                self.register_parameter(f"weight_ih_l{layer}{sfx}",
                                        nn.Parameter(torch.empty(3 * hidden, in_dim)))
                self.register_parameter(f"weight_hh_l{layer}{sfx}",
                                        nn.Parameter(torch.empty(3 * hidden, hidden)))
                self.register_parameter(f"bias_ih_l{layer}{sfx}",
                                        nn.Parameter(torch.empty(3 * hidden)))
                self.register_parameter(f"bias_hh_l{layer}{sfx}",
                                        nn.Parameter(torch.empty(3 * hidden)))

    def init_with(self, g):
        for p in self.parameters():
            _uniform_(p, 1.0 / math.sqrt(self.hidden), g)

    def _run(self, x, layer, sfx):
        params = [getattr(self, f"{n}_l{layer}{sfx}")
                  for n in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")]
        h0 = x.new_zeros((1, x.shape[0], self.hidden))
        # train=True when a backward will run (cuDNN's RNN backward needs it)
        return torch.gru(x, h0, params, True, 1, 0.0, torch.is_grad_enabled(), False, True)[0]

    def forward(self, x, lengths, generator=None):
        B, N, _ = x.shape
        s = torch.arange(N, device=x.device)[None, :]
        n = lengths[:, None].to(s.dtype)
        valid = (s < n)[..., None]
        rev = torch.where(s < n, n - 1 - s, s)[..., None]  # an involution
        last = (n - 1).clamp(min=0)[..., None].expand(-1, -1, self.hidden)
        out = x
        for layer in range(self.num_layers):
            if layer:
                out = _drop(self, generator, out, self.dropout)
            fwd = self._run(out, layer, "")
            # the state is held over the padding (0 for a sequence with no valid step)
            fwd = torch.where(valid, fwd, fwd.gather(1, last) * (n > 0)[..., None])
            r_in = out.gather(1, rev.expand(-1, -1, out.shape[-1]))
            bwd = self._run(r_in.contiguous(), layer, "_reverse")
            bwd = torch.where(valid, bwd.gather(1, rev.expand(-1, -1, self.hidden)), 0.0)
            out = torch.cat([fwd, bwd], dim=-1)
        return out


class ActionUpdateGRU(nn.Module):
    """The GRU action branch of transcript mode (``layers.py:1186-1206``,
    the reference's ``ActionUpdate_GRU``): a masked ``BiGRU`` of ``a_dim //
    2`` a direction and ``n_layers`` layers over the tokens, dropout between
    its layers, LayerNorm (eps 1e-5), then with ``out_map`` (``a: gru_om``) a
    dense to ``out_dim``; without it ``hid_dim`` must equal ``out_dim``."""

    def __init__(self, in_dim: int, hid_dim: int, out_dim: int, n_layers: int,
                 dropout: float = 0.0, out_map: bool = False):
        super().__init__()
        if not out_map and hid_dim != out_dim:
            raise ValueError("a: gru needs a_dim == hid_dim (a: gru_om maps to hid_dim)")
        self.gru = BiGRU(in_dim, hid_dim // 2, n_layers, dropout)
        self.layernorm = nn.LayerNorm(hid_dim // 2 * 2, eps=LN_EPS_TOWER)
        self.out_map = nn.Linear(hid_dim // 2 * 2, out_dim) if out_map else None

    def forward(self, action_feature, token_len, generator=None):
        out = self.layernorm(self.gru(action_feature, token_len, generator))
        return self.out_map(out) if self.out_map is not None else out


# ---------------------------------------------------------------------------
# FACT_CLIP's frame projection


class FeatureProjection(nn.Module):
    """Linear -> LayerNorm -> ReLU -> dropout -> Linear, L2-normalised with
    the norm clamped at 1e-12 (``fact_clip_tpu/models/layers.py:1209``).  The
    reference's ``nn.Sequential`` indices name the parameters
    (``projection.{0,1,4}``); the LayerNorm is flax's default, eps 1e-6.
    Dropout in train mode draws from the ``generator`` passed in."""

    def __init__(self, in_dim: int, clip_dim: int = 512, hidden_dim: int = 512,
                 dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.projection = nn.Sequential(nn.Linear(in_dim, hidden_dim),
                                        nn.LayerNorm(hidden_dim, eps=LN_EPS_ATTN), nn.ReLU(),
                                        nn.Dropout(dropout), nn.Linear(hidden_dim, clip_dim))

    def forward(self, feature, generator=None):
        lin1, norm, _, _, lin2 = self.projection
        h = _drop(self, generator, torch.relu(norm(lin1(feature))), self.dropout)
        h = lin2(h)
        return h / h.norm(dim=-1, keepdim=True).clamp(min=1e-12)
