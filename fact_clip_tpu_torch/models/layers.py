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
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.dilated_conv import mstcn_stack_fwd, mstcn_stack_reference
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
    changed (moved, reloaded or updated in place)."""

    def kernel_layout(self):
        key = tuple((p.data_ptr(), p._version) for p in self.parameters())
        cached = self.__dict__.get("_kernel_layout")
        if cached is None or cached[0] != key:
            with torch.no_grad():
                cached = (key, self._make_kernel_layout())
            self.__dict__["_kernel_layout"] = cached
        return cached[1]


def _t(w):
    return w.detach().t().contiguous()


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

    def _make_kernel_layout(self):
        C = self.conv_1x1.weight.shape[0]
        ones = torch.ones(C, device=self.conv_1x1.weight.device)
        return (self.conv_dilated.weight.detach().permute(2, 1, 0).contiguous(),  # (k, in, out)
                self.conv_dilated.bias.detach(), _t(self.conv_1x1.weight[:, :, 0]),
                self.conv_1x1.bias.detach(),
                self.norm.weight.detach() if self.norm is not None else ones,
                self.norm.bias.detach() if self.norm is not None else torch.zeros_like(ones))


class MSTCN(nn.Module, KernelLayout):
    """1x1 in map -> dilated residual layers -> 1x1 out map (f32 logits)."""

    def __init__(self, in_dim, hid_dim, out_dim, num_layers, ln, ngroup=1, in_map=False,
                 use_kernel=True):
        super().__init__()
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

    def _make_kernel_layout(self):
        return _t(self.conv_out.weight[:, :, 0]), self.conv_out.bias.detach()

    def forward(self, x, lengths):
        if self.in_map:
            x = F.linear(x, self.conv_1x1.weight[:, :, 0], self.conv_1x1.bias)
        ow, ob = self.kernel_layout()
        fn = mstcn_stack_fwd if self.use_kernel else mstcn_stack_reference
        return fn(x.contiguous(), lengths, [l.kernel_layout() for l in self.layers],
                  [l.dilation for l in self.layers], use_ln=self.ln, eps=LN_EPS_TOWER,
                  out_w=ow, out_b=ob)


# ---------------------------------------------------------------------------
# attention


class MultiheadAttention(nn.Module, KernelLayout):
    """torch ``nn.MultiheadAttention`` parameter layout (batch-first), prefix
    key masks.  With ``use_kernel``, long-key cross-attention to raw memory
    runs K3 under the JAX fuse conditions (layers.py:649-655)."""

    def __init__(self, embed_dim: int, num_heads: int, kdim: int | None = None,
                 use_kernel: bool = False, kernel_min_keys: int = 1024):
        super().__init__()
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

    def _make_kernel_layout(self):
        wq, wk, wv = self.proj_weights()
        bq, bk, bv = self.in_proj_bias.detach().chunk(3)
        return (_t(wq), bq.contiguous(), _t(wk), bk.contiguous(), _t(wv), bv.contiguous(),
                _t(self.out_proj.weight), self.out_proj.bias.detach())

    def forward(self, query, key, value, key_len=None, key_pos=None):
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
            out = mha_cross_fwd(q.contiguous(), key.contiguous(), key_pos, wk_t, bk_c, wv_t,
                                bv_c, key_len, num_heads=H)
            return self.out_proj(out)
        k = F.linear(add_pos(key, key_pos), wk, bk).view(B, Nk, H, hd)
        v = F.linear(value, wv, bv).view(B, Nk, H, hd)
        logits = torch.einsum("bmhd,bnhd->bhmn", q.view(B, M, H, hd), k) / math.sqrt(hd)
        if key_len is not None:
            valid = torch.arange(Nk, device=key.device)[None, :] < key_len[:, None]
            logits = logits.masked_fill(~valid[:, None, None, :], float("-inf"))
        out = torch.einsum("bhmn,bnhd->bmhd", torch.softmax(logits, dim=-1), v)
        return self.out_proj(out.reshape(B, M, E))


class X2YMap(nn.Module, KernelLayout):
    """Single-head cross-attention: K/V from X, Q from Y, out map of
    concat(Y, attended); returns (y_out, probs, logits), probs/logits (B, Y, X)."""

    def __init__(self, x_dim, y_dim, y_outdim, head_dim, kq_pos=False, use_kernel=True):
        super().__init__()
        self.X_K = nn.Linear(x_dim, head_dim)
        self.X_V = nn.Linear(x_dim, head_dim)
        self.Y_Q = nn.Linear(y_dim, head_dim)
        self.Y_W = nn.Linear(y_dim + head_dim, y_outdim)
        self.kq_pos = kq_pos
        self.kernel_allowed = use_kernel
        self.use_kernel = use_kernel

    def _make_kernel_layout(self):
        return (_t(self.X_K.weight), self.X_K.bias.detach(), _t(self.X_V.weight),
                self.X_V.bias.detach(), _t(self.Y_Q.weight), self.Y_Q.bias.detach())

    def forward(self, x, y, x_pos=None, y_pos=None, x_len=None):
        if not self.kq_pos:
            x_pos = y_pos = None
        if x_len is None:
            x_len = torch.full((x.shape[0],), x.shape[1], dtype=torch.int32, device=x.device)
        fn = x2y_attention if self.use_kernel else x2y_attention_reference
        attn, probs, logits = fn(y.contiguous(), y_pos, x.contiguous(), x_pos,
                                 *self.kernel_layout(), x_len)
        # out map as a split dense: concat([y, attn]) never materializes
        W = self.Y_W.weight
        Cy = y.shape[-1]
        y_out = F.linear(y, W[:, :Cy]) + F.linear(attn, W[:, Cy:], self.Y_W.bias)
        return y_out, probs, logits


def _shared_pos(pos):
    """One positional table for the whole batch (the fused sublayers' layout)."""
    return pos is None or pos.dim() == 2 or pos.shape[0] == 1


def _ffn_layout(layer):
    """(W1, b1, W2, b2) of a post-norm layer in the kernel's (in, out) layout."""
    return (_t(layer.linear1.weight), layer.linear1.bias.detach(), _t(layer.linear2.weight),
            layer.linear2.bias.detach())


def _fused_sublayers(layer, attn, tgt, pos, norm_sa, norm_ffn, between=None):
    """K4: the self-attention sublayer, then (after ``between``) the FFN one."""
    sa, ffn = layer.kernel_layout()
    y = sa_sublayer(tgt.contiguous(), pos, *sa, norm_sa.weight.detach(), norm_sa.bias.detach(),
                    num_heads=attn.num_heads, eps=norm_sa.eps)
    if between is not None:
        y = between(y)
    return ffn_sublayer(y, *ffn, norm_ffn.weight.detach(), norm_ffn.bias.detach(),
                        eps=norm_ffn.eps)


class SALayer(nn.Module, KernelLayout):
    """Post-norm self-attention + FFN over action tokens (K4 when fused)."""

    def __init__(self, dim, nhead, ffdim, use_kernel=True):
        super().__init__()
        self.multihead_attn = MultiheadAttention(dim, nhead)
        self.linear1 = nn.Linear(dim, ffdim)
        self.linear2 = nn.Linear(ffdim, dim)
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS_ATTN)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS_ATTN)
        self.nhead = nhead
        self.kernel_allowed = use_kernel and dim % nhead == 0
        self.use_kernel = self.kernel_allowed

    def _make_kernel_layout(self):
        return self.multihead_attn.kernel_layout(), _ffn_layout(self)

    def forward(self, tgt, pos=None):
        if self.use_kernel and _shared_pos(pos):
            return _fused_sublayers(self, self.multihead_attn, tgt, pos, self.norm1, self.norm2)
        q = add_pos(tgt, pos)
        tgt = self.norm1(tgt + self.multihead_attn(q, q, tgt))
        return self.norm2(tgt + self.linear2(torch.relu(self.linear1(tgt))))


class SCALayer(nn.Module, KernelLayout):
    """Token self-attention, cross-attention to the frame memory, FFN."""

    def __init__(self, dim, frame_dim, nhead, ffdim, use_kernel_sa=True, use_kernel_attn=True):
        super().__init__()
        self.self_attn = MultiheadAttention(dim, nhead)
        self.multihead_attn = MultiheadAttention(dim, nhead, kdim=frame_dim,
                                                 use_kernel=use_kernel_attn)
        self.linear1 = nn.Linear(dim, ffdim)
        self.linear2 = nn.Linear(ffdim, dim)
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS_ATTN)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS_ATTN)
        self.norm3 = nn.LayerNorm(dim, eps=LN_EPS_ATTN)
        self.nhead = nhead
        self.kernel_allowed = use_kernel_sa and dim % nhead == 0
        self.use_kernel = self.kernel_allowed

    def _make_kernel_layout(self):
        return self.self_attn.kernel_layout(), _ffn_layout(self)

    def forward(self, tgt, memory, pos=None, query_pos=None, memory_len=None):
        def cross(t):
            t2 = self.multihead_attn(add_pos(t, query_pos), memory, memory,
                                     key_len=memory_len, key_pos=pos)
            return self.norm2(t + t2)

        if self.use_kernel and _shared_pos(query_pos):
            return _fused_sublayers(self, self.self_attn, tgt, query_pos, self.norm1,
                                    self.norm3, between=cross)
        q = add_pos(tgt, query_pos)
        tgt = cross(self.norm1(tgt + self.self_attn(q, q, tgt)))
        return self.norm3(tgt + self.linear2(torch.relu(self.linear1(tgt))))


class SADecoder(nn.Module):
    """N self-attention layers + output linear."""

    def __init__(self, in_dim, hid_dim, out_dim, num_layers, nhead, ffdim, use_kernel=True):
        super().__init__()
        if in_dim != hid_dim:
            raise ValueError("SADecoder needs in_dim == hid_dim")
        self.layers = nn.ModuleList(SALayer(hid_dim, nhead, ffdim, use_kernel)
                                    for _ in range(num_layers))
        self.out_linear = nn.Linear(hid_dim, out_dim)

    def forward(self, tgt, pos=None):
        for layer in self.layers:
            tgt = layer(tgt, pos)
        return self.out_linear(tgt)


class SCADecoder(nn.Module):
    """N SCA layers + final LayerNorm + output linear."""

    def __init__(self, in_dim, hid_dim, out_dim, frame_dim, num_layers, nhead, ffdim,
                 use_kernel_sa=True, use_kernel_attn=True):
        super().__init__()
        if in_dim != hid_dim:
            raise ValueError("SCADecoder needs in_dim == hid_dim")
        self.layers = nn.ModuleList(
            SCALayer(hid_dim, frame_dim, nhead, ffdim, use_kernel_sa, use_kernel_attn)
            for _ in range(num_layers))
        self.norm = nn.LayerNorm(hid_dim, eps=LN_EPS_ATTN)
        self.out_linear = nn.Linear(hid_dim, out_dim)

    def forward(self, tgt, memory, pos=None, query_pos=None, memory_len=None):
        for layer in self.layers:
            tgt = layer(tgt, memory, pos=pos, query_pos=query_pos, memory_len=memory_len)
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
        return torch.gru(x, h0, params, True, 1, 0.0, False, False, True)[0]

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
