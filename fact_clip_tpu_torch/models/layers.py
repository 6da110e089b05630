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
it: every MSTCN layer (K1's in-kernel mask, seeded per layer), the attention
probabilities, the X2Y out map's two inputs, and the residual branches and
FFN of the SA / SCA layers.  Every draw comes from the ``generator`` passed
down (a ``torch.Generator`` on the model's device).  In train mode with
gradients, the kernel layouts are taken from the live parameters so that
autograd reaches them; K1 and K2 run through their autograd entries, while
K3 and K4 stay forward-only and refuse.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.dilated_conv import mstcn_stack, mstcn_stack_reference
from ..ops.masking import dropout
from ..ops.mha_attn import mha_cross_fwd
from ..ops.pos import add_pos, positional_encoding_table  # noqa: F401  (re-exported)
from ..ops.sa_layer import ffn_sublayer, sa_sublayer
from ..ops.x2y_attn import x2y_attention, x2y_attention_reference

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
        key = tuple((p.data_ptr(), p._version) for p in self.parameters())
        cached = self.__dict__.get("_kernel_layout")
        if cached is None or cached[0] != key:
            with torch.no_grad():
                cached = (key, self._make_kernel_layout())
            self.__dict__["_kernel_layout"] = cached
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


# ---------------------------------------------------------------------------
# dilated temporal convolution tower


class DilatedResidualLayer(nn.Module, KernelLayout):
    """Dilated conv3 -> ReLU -> 1x1 -> residual (-> LayerNorm)."""

    def __init__(self, dilation: int, channels: int, ln: bool, ngroup: int = 1):
        super().__init__()
        self.dilation = dilation
        self.conv_dilated = nn.Conv1d(channels, channels, 3, padding=dilation,
                                      dilation=dilation, groups=ngroup)
        self.conv_1x1 = nn.Conv1d(channels, channels, 1)
        self.norm = nn.LayerNorm(channels, eps=LN_EPS_TOWER) if ln else None

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

    def __init__(self, in_dim, hid_dim, out_dim, num_layers, ln, ngroup=1, in_map=False,
                 use_kernel=True, dropout=0.0):
        super().__init__()
        self.dropout = dropout
        if in_map:
            self.conv_1x1 = nn.Conv1d(in_dim, hid_dim, 1)
        elif in_dim != hid_dim:
            raise ValueError("MSTCN without in_map needs in_dim == hid_dim")
        self.in_map = in_map
        self.ln = ln
        self.ngroup = ngroup
        self.layers = nn.ModuleList(
            DilatedResidualLayer(2 ** i, hid_dim, ln, ngroup) for i in range(num_layers))
        self.conv_out = nn.Conv1d(hid_dim, out_dim, 1)
        self.kernel_allowed = ngroup == 1  # the fused tower is ungrouped (layers.py:372)
        self.use_kernel = use_kernel and self.kernel_allowed

    def _make_kernel_layout(self, live: bool = False):
        return _t(self.conv_out.weight[:, :, 0], live), _d(self.conv_out.bias, live)

    def forward(self, x, lengths, generator=None):
        if self.in_map:
            x = F.linear(x, self.conv_1x1.weight[:, :, 0], self.conv_1x1.bias)
        ow, ob = self.layout()
        L = len(self.layers)
        rates = seeds = None
        if self.training and self.dropout > 0.0:
            if generator is None:
                raise ValueError("train mode with dropout needs a generator")
            # one seed per layer, drawn on the device (layers.py:391-395)
            rates = (float(self.dropout),) * L
            seeds = torch.randint(0, 2 ** 31 - 1, (L,), generator=generator, device=x.device,
                                  dtype=torch.int32)
        fn = mstcn_stack if self.use_kernel else mstcn_stack_reference
        return fn(x.contiguous(), lengths, [l.layout() for l in self.layers],
                  [l.dilation for l in self.layers], use_ln=self.ln, eps=LN_EPS_TOWER,
                  out_w=ow, out_b=ob, rates=rates, seeds=seeds)


# ---------------------------------------------------------------------------
# attention


class MultiheadAttention(nn.Module, KernelLayout):
    """torch ``nn.MultiheadAttention`` parameter layout (batch-first), prefix
    key masks.  With ``use_kernel``, long-key cross-attention to raw memory
    runs K3 under the JAX fuse conditions (layers.py:649-655)."""

    def __init__(self, embed_dim: int, num_heads: int, kdim: int | None = None,
                 use_kernel: bool = False, kernel_min_keys: int = 1024, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
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

    def forward(self, query, key, value, key_len=None, key_pos=None, generator=None):
        E, H = self.embed_dim, self.num_heads
        hd = E // H
        wq, wk, wv = self.proj_weights()
        bq, bk, bv = self.in_proj_bias.chunk(3)
        q = F.linear(query, wq, bq)
        B, M, _ = q.shape
        Nk = key.shape[1]
        fuse = (self.use_kernel and Nk >= self.kernel_min_keys and key is value
                and E % 128 == 0 and key.shape[-1] % 128 == 0)
        if fuse:
            _, _, wk_t, bk_c, wv_t, bv_c, _, _ = self.kernel_layout()
            if key_len is None:
                key_len = torch.full((B,), Nk, dtype=torch.int32, device=key.device)
            rate = self.dropout if self.training else 0.0
            out = mha_cross_fwd(q.contiguous(), key.contiguous(), key_pos, wk_t, bk_c, wv_t,
                                bv_c, key_len, num_heads=H, rate=rate)
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


class X2YMap(nn.Module, KernelLayout):
    """Single-head cross-attention: K/V from X, Q from Y, out map of
    concat(Y, attended); returns (y_out, probs, logits), probs/logits (B, Y, X)."""

    def __init__(self, x_dim, y_dim, y_outdim, head_dim, kq_pos=False, use_kernel=True,
                 dropout=0.0):
        super().__init__()
        self.dropout = dropout
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


def _shared_pos(pos):
    """One positional table for the whole batch (the fused sublayers' layout)."""
    return pos is None or pos.dim() == 2 or pos.shape[0] == 1


def _ffn_layout(layer, live: bool = False):
    """(W1, b1, W2, b2) of a post-norm layer in the kernel's (in, out) layout."""
    return (_t(layer.linear1.weight, live), _d(layer.linear1.bias, live),
            _t(layer.linear2.weight, live), _d(layer.linear2.bias, live))


def _fused_sublayers(layer, attn, tgt, pos, norm_sa, norm_ffn, between=None):
    """K4: the self-attention sublayer, then (after ``between``) the FFN one.
    Forward-only: in train mode it refuses (its dropout and backward come
    with the next slice)."""
    sa, ffn = layer.kernel_layout()
    rate = layer.dropout if layer.training else 0.0
    y = sa_sublayer(tgt.contiguous(), pos, *sa, norm_sa.weight.detach(), norm_sa.bias.detach(),
                    num_heads=attn.num_heads, eps=norm_sa.eps, rate_attn=rate, rate=rate)
    if between is not None:
        y = between(y)
    return ffn_sublayer(y, *ffn, norm_ffn.weight.detach(), norm_ffn.bias.detach(),
                        eps=norm_ffn.eps, rate=rate)


def _ffn(layer, tgt, norm, generator):
    """norm(tgt + drop(linear2(drop(relu(linear1(tgt))))))."""
    ff = _drop(layer, generator, torch.relu(layer.linear1(tgt)), layer.dropout)
    return norm(tgt + _drop(layer, generator, layer.linear2(ff), layer.dropout))


class SALayer(nn.Module, KernelLayout):
    """Post-norm self-attention + FFN over action tokens (K4 when fused)."""

    def __init__(self, dim, nhead, ffdim, use_kernel=True, dropout=0.0):
        super().__init__()
        self.dropout = dropout
        self.multihead_attn = MultiheadAttention(dim, nhead, dropout=dropout)
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
        if self.use_kernel and _shared_pos(pos):
            return _fused_sublayers(self, self.multihead_attn, tgt, pos, self.norm1, self.norm2)
        q = add_pos(tgt, pos)
        t2 = self.multihead_attn(q, q, tgt, generator=generator)
        tgt = self.norm1(tgt + _drop(self, generator, t2, self.dropout))
        return _ffn(self, tgt, self.norm2, generator)


class SCALayer(nn.Module, KernelLayout):
    """Token self-attention, cross-attention to the frame memory, FFN."""

    def __init__(self, dim, frame_dim, nhead, ffdim, use_kernel_sa=True, use_kernel_attn=True,
                 dropout=0.0):
        super().__init__()
        self.dropout = dropout
        self.self_attn = MultiheadAttention(dim, nhead, dropout=dropout)
        self.multihead_attn = MultiheadAttention(dim, nhead, kdim=frame_dim,
                                                 use_kernel=use_kernel_attn, dropout=dropout)
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

        if self.use_kernel and _shared_pos(query_pos):
            return _fused_sublayers(self, self.self_attn, tgt, query_pos, self.norm1,
                                    self.norm3, between=cross)
        q = add_pos(tgt, query_pos)
        t2 = self.self_attn(q, q, tgt, generator=generator)
        tgt = cross(self.norm1(tgt + _drop(self, generator, t2, self.dropout)))
        return _ffn(self, tgt, self.norm3, generator)


class SADecoder(nn.Module):
    """N self-attention layers + output linear."""

    def __init__(self, in_dim, hid_dim, out_dim, num_layers, nhead, ffdim, use_kernel=True,
                 dropout=0.0):
        super().__init__()
        if in_dim != hid_dim:
            raise ValueError("SADecoder needs in_dim == hid_dim")
        self.layers = nn.ModuleList(SALayer(hid_dim, nhead, ffdim, use_kernel, dropout)
                                    for _ in range(num_layers))
        self.out_linear = nn.Linear(hid_dim, out_dim)

    def forward(self, tgt, pos=None, generator=None):
        for layer in self.layers:
            tgt = layer(tgt, pos, generator=generator)
        return self.out_linear(tgt)


class SCADecoder(nn.Module):
    """N SCA layers + final LayerNorm + output linear."""

    def __init__(self, in_dim, hid_dim, out_dim, frame_dim, num_layers, nhead, ffdim,
                 use_kernel_sa=True, use_kernel_attn=True, dropout=0.0):
        super().__init__()
        if in_dim != hid_dim:
            raise ValueError("SCADecoder needs in_dim == hid_dim")
        self.layers = nn.ModuleList(
            SCALayer(hid_dim, frame_dim, nhead, ffdim, use_kernel_sa, use_kernel_attn, dropout)
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
    names).  Matches the JAX masked scan on valid steps: the forward
    direction runs over the padded sequence (padding only follows the valid
    steps) and the backward direction over each sequence's valid prefix
    reversed in place, so it enters the valid region from the last valid
    step with a zero state.  Plain PyTorch: no Pallas kernel exists for it."""

    def __init__(self, input_size: int, hidden: int, num_layers: int):
        super().__init__()
        self.hidden, self.num_layers = hidden, num_layers
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

    def forward(self, x, lengths):
        B, N, _ = x.shape
        s = torch.arange(N, device=x.device)[None, :]
        n = lengths[:, None].to(s.dtype)
        rev = torch.where(s < n, n - 1 - s, s)[..., None]  # an involution
        out = x
        for layer in range(self.num_layers):
            fwd = self._run(out, layer, "")
            r_in = out.gather(1, rev.expand(-1, -1, out.shape[-1]))
            bwd = self._run(r_in.contiguous(), layer, "_reverse")
            bwd = bwd.gather(1, rev.expand(-1, -1, self.hidden))
            out = torch.cat([fwd, bwd], dim=-1)
        return out
