"""A flax FACT or VerbNounFACT parameter tree -> the reference torch
``state_dict`` (numpy).

The port's own copy of ``fact_clip_tpu/utils/torch_export.py::
export_fact_state_dict`` (the FACT part) and ``::export_verbnoun_state_dict``
(numpy only), so that the port imports nothing of the JAX package.  It
covers what the port builds: MSTCN and MS-TCN++ frame towers (``f: m``,
``f: m2``), SA, SCA and GRU action branches (``a: gru`` / ``gru_om``), the
X2Y maps and the TDU blocks' BiGRU and dense layers, FACT_CLIP's frame
projection (the ``{"fact", "frame_projection"}`` tree,
``export_fact_state_dict``'s CLIP branch) and transcript mode's token
embeddings (``action_embed``; the verb/noun model's ``verb_embed`` and
``noun_embed``), found by their keys where the JAX exporter takes
``trans=``.  Tests hold it equal to the JAX package's exporter key for key
and value for value.

Layouts (flax -> torch):

  Dense      kernel (in, out)          -> Linear weight (out, in)
  1x1 conv   kernel (in, out)          -> Conv1d weight (out, in, 1)
  dilated    kernel (k, in/g, out)     -> Conv1d weight (out, in/g, k)
  MHA        q/k/v kernels             -> packed in_proj_weight (3E, E) when
                                          kdim == E, else {q,k,v}_proj_weight
  BiGRU      l{k}_{dir}[_w_ih] (in,3H) -> weight_ih_l{k}[_reverse] (3H, in)

The conversion only transposes and reshapes, so it maps a gradient tree too.
"""

from __future__ import annotations

import numpy as np


def _f32(a):
    return np.ascontiguousarray(np.asarray(a), dtype=np.float32)


def _t(k):  # kernel (in, out) -> weight (out, in)
    return np.ascontiguousarray(_f32(k).T)


def _conv(k):  # kernel (k, in/g, out) -> weight (out, in/g, k)
    return np.ascontiguousarray(_f32(k).transpose(2, 1, 0))


def _conv1x1(k):  # dense kernel (in, out) -> Conv1d weight (out, in, 1)
    return np.ascontiguousarray(_f32(k).T[:, :, None])


def _dense(out, prefix, node):
    d = node["Dense_0"]
    out[prefix + ".weight"] = _t(d["kernel"])
    out[prefix + ".bias"] = _f32(d["bias"])


def _layernorm(out, prefix, node):
    out[prefix + ".weight"] = _f32(node["scale"])
    out[prefix + ".bias"] = _f32(node["bias"])


def _mha(out, prefix, node):
    """q/k/v/out projections -> torch ``nn.MultiheadAttention`` entries
    (packed when the key and value widths equal the embedding width)."""
    qk = _f32(node["q_proj"]["kernel"])  # (E, E)
    kk = _f32(node["k_proj"]["kernel"])  # (kdim, E)
    vk = _f32(node["v_proj"]["kernel"])  # (vdim, E)
    E = qk.shape[0]
    bias = np.concatenate([_f32(node["q_proj"]["bias"]), _f32(node["k_proj"]["bias"]),
                           _f32(node["v_proj"]["bias"])])
    if kk.shape[0] == E and vk.shape[0] == E:
        out[prefix + ".in_proj_weight"] = np.concatenate([qk.T, kk.T, vk.T])
    else:
        out[prefix + ".q_proj_weight"] = _t(qk)
        out[prefix + ".k_proj_weight"] = _t(kk)
        out[prefix + ".v_proj_weight"] = _t(vk)
    out[prefix + ".in_proj_bias"] = bias
    out[prefix + ".out_proj.weight"] = _t(node["out_proj"]["kernel"])
    out[prefix + ".out_proj.bias"] = _f32(node["out_proj"]["bias"])


def _mstcn(out, prefix, node, in_map):
    idx = 0
    if in_map:
        d = node[f"TorchDense_{idx}"]["Dense_0"]
        out[prefix + ".conv_1x1.weight"] = _conv1x1(d["kernel"])
        out[prefix + ".conv_1x1.bias"] = _f32(d["bias"])
        idx += 1
    i = 0
    while f"DilatedResidualLayer_{i}" in node:
        layer, p = node[f"DilatedResidualLayer_{i}"], f"{prefix}.layers.{i}"
        out[p + ".conv_dilated.weight"] = _conv(layer["conv_dilated_kernel"])
        out[p + ".conv_dilated.bias"] = _f32(layer["conv_dilated_bias"])
        out[p + ".conv_1x1.weight"] = _conv1x1(layer["conv_1x1_kernel"])
        out[p + ".conv_1x1.bias"] = _f32(layer["conv_1x1_bias"])
        if "ln_scale" in layer:
            out[p + ".norm.weight"] = _f32(layer["ln_scale"])
            out[p + ".norm.bias"] = _f32(layer["ln_bias"])
        i += 1
    d = node[f"TorchDense_{idx}"]["Dense_0"]
    out[prefix + ".conv_out.weight"] = _conv1x1(d["kernel"])
    out[prefix + ".conv_out.bias"] = _f32(d["bias"])


def _mstcn2(out, prefix, node, in_map):
    idx = 0
    if in_map:
        d = node[f"TorchDense_{idx}"]["Dense_0"]
        out[prefix + ".conv_1x1_in.weight"] = _conv1x1(d["kernel"])
        out[prefix + ".conv_1x1_in.bias"] = _f32(d["bias"])
        idx += 1
    i = 0
    while f"conv_dilated_1_{i}_kernel" in node:
        for j in (1, 2):
            out[f"{prefix}.conv_dilated_{j}.{i}.weight"] = _conv(node[f"conv_dilated_{j}_{i}_kernel"])
            out[f"{prefix}.conv_dilated_{j}.{i}.bias"] = _f32(node[f"conv_dilated_{j}_{i}_bias"])
        out[f"{prefix}.conv_fusion.{i}.weight"] = _conv1x1(node[f"fuse_{i}_kernel"])
        out[f"{prefix}.conv_fusion.{i}.bias"] = _f32(node[f"fuse_{i}_bias"])
        i += 1
    d = node[f"TorchDense_{idx}"]["Dense_0"]
    out[prefix + ".conv_out.weight"] = _conv1x1(d["kernel"])
    out[prefix + ".conv_out.bias"] = _f32(d["bias"])


_FBRANCH = {"m": _mstcn, "m2": _mstcn2}


def _abranch(out, prefix, node, c):
    if c.a == "sa":
        for i in range(c.a_layers):
            p, layer = f"{prefix}.layers.{i}", node[f"layer{i}"]
            _mha(out, p + ".multihead_attn", layer["MultiHeadAttention_0"])
            _dense(out, p + ".linear1", layer["TorchDense_0"])
            _dense(out, p + ".linear2", layer["TorchDense_1"])
            _layernorm(out, p + ".norm1", layer["LayerNorm_0"])
            _layernorm(out, p + ".norm2", layer["LayerNorm_1"])
    elif c.a == "sca":
        for i in range(c.a_layers):
            p, layer = f"{prefix}.layers.{i}", node[f"layer{i}"]
            _mha(out, p + ".self_attn", layer["self_attn"])
            _mha(out, p + ".multihead_attn", layer["cross_attn"])
            _dense(out, p + ".linear1", layer["TorchDense_0"])
            _dense(out, p + ".linear2", layer["TorchDense_1"])
            _layernorm(out, p + ".norm1", layer["LayerNorm_0"])
            _layernorm(out, p + ".norm2", layer["LayerNorm_1"])
            _layernorm(out, p + ".norm3", layer["LayerNorm_2"])
        _layernorm(out, prefix + ".norm", node["LayerNorm_0"])
    elif c.a in ("gru", "gru_om"):  # ActionUpdateGRU (layers.py:1186)
        _gru(out, prefix + ".gru", node["BiGRU_0"])
        _layernorm(out, prefix + ".layernorm", node["LayerNorm_0"])
        if c.a == "gru_om":
            _dense(out, prefix + ".out_map", node["TorchDense_0"])
        return
    else:
        raise ValueError(f"action branch {c.a!r} is not ported")
    _dense(out, prefix + ".out_linear", node["TorchDense_0"])


def _gru(out, prefix, node):
    layer = 0
    while f"l{layer}_fwd" in node:
        for tag, suffix in (("fwd", ""), ("bwd", "_reverse")):
            out[f"{prefix}.weight_hh_l{layer}{suffix}"] = _t(node[f"l{layer}_{tag}"]["w_hh"])
            out[f"{prefix}.bias_hh_l{layer}{suffix}"] = _f32(node[f"l{layer}_{tag}"]["b_hh"])
            out[f"{prefix}.weight_ih_l{layer}{suffix}"] = _t(node[f"l{layer}_{tag}_w_ih"])
            out[f"{prefix}.bias_ih_l{layer}{suffix}"] = _f32(node[f"l{layer}_{tag}_b_ih"])
        layer += 1


def _x2y(out, prefix, node):
    for name, key in (("X_K", "xk"), ("X_V", "xv"), ("Y_Q", "yq"), ("Y_W", "out")):
        out[f"{prefix}.{name}.weight"] = _t(node[f"{key}_kernel"])
        out[f"{prefix}.{name}.bias"] = _f32(node[f"{key}_bias"])


def export_fact_state_dict(params, block_cfgs) -> dict:
    """The flax FACT tree (``variables["params"]``, numpy or array leaves),
    or FACT_CLIP's ``{"fact": ..., "frame_projection": ...}``, -> {reference
    state_dict key: float32 numpy array}."""
    params = _as_plain_dict(params)
    fact = params.get("fact", params)
    if "action_embed" in fact:  # transcript mode
        out = {"action_embed.weight": _f32(fact["action_embed"]["embedding"])}
    else:
        out = {"action_query": _f32(fact["action_query"])[:, None, :]}  # (M, E) -> (M, 1, E)
    for idx, c in enumerate(block_cfgs):
        if c.f not in _FBRANCH:
            raise ValueError(f"frame branch {c.f!r} is not ported (only 'm' and 'm2')")
        p, blk = f"block_list.{idx}", fact[f"block{idx}"]
        _FBRANCH[c.f](out, p + ".frame_branch", blk["frame_branch"], in_map=c.kind == "i")
        _abranch(out, p + ".action_branch", blk["action_branch"], c)
        if c.kind in ("u", "U"):
            _x2y(out, p + ".f2a_layer", blk["f2a_layer"])
            _x2y(out, p + ".a2f_layer", blk["a2f_layer"])
        if c.kind == "U":
            _gru(out, p + ".seg_update", blk["seg_update"])
            _dense(out, p + ".seg_combine", blk["seg_combine"])
            _dense(out, p + ".sf_merge.0", blk["sf_merge"])
        elif c.kind not in ("i", "u"):
            raise ValueError(f"unexpected block kind {c.kind!r} in FACT export")
    if "frame_projection" in params:  # FACT_CLIP (layers.py:1209, blocks.py:141-175)
        proj = params["frame_projection"]
        missing = sorted({"TorchDense_0", "LayerNorm_0", "TorchDense_1"} - set(proj))
        if missing:
            raise ValueError(f"FACT_CLIP's frame_projection lacks {missing}")
        _dense(out, "frame_projection.projection.0", proj["TorchDense_0"])
        _layernorm(out, "frame_projection.projection.1", proj["LayerNorm_0"])
        _dense(out, "frame_projection.projection.4", proj["TorchDense_1"])
    return out


def export_verbnoun_state_dict(params, block_cfgs) -> dict:
    """The flax VerbNounFACT tree (``models/verbnoun.py``) -> {reference
    ``blocks_SepVerbNoun.py`` state_dict key: float32 numpy array}."""
    params = _as_plain_dict(params)
    if "verb_embed" in params:  # transcript mode
        out = {f"{k}.weight": _f32(params[k]["embedding"]) for k in ("verb_embed", "noun_embed")}
    else:
        out = {"action_query": _f32(params["action_query"])[:, None, :]}
    for idx, c in enumerate(block_cfgs):
        if c.kind not in ("I", "U"):
            raise ValueError(f"unexpected block kind {c.kind!r} in verbnoun export")
        if c.f not in _FBRANCH:
            raise ValueError(f"frame branch {c.f!r} is not ported (only 'm' and 'm2')")
        p, blk = f"block_list.{idx}", params[f"block{idx}"]
        _FBRANCH[c.f](out, p + ".frame_branch", blk["frame_branch"], in_map=c.kind == "I")
        _abranch(out, p + ".action_branch", blk["action_branch"], c)
        if c.kind == "U":
            _x2y(out, p + ".f2a_layer", blk["f2a_layer"])
            _x2y(out, p + ".a2f_layer", blk["a2f_layer"])
        _gru(out, p + ".seg_update", blk["tdu"]["seg_update"])
        _dense(out, p + ".seg_combine", blk["tdu"]["seg_combine"])
        if c.kind == "U":
            _dense(out, p + ".sf_merge.0", blk["sf_merge"])
    return out


def _as_plain_dict(tree):
    """A FrozenDict or other nested mapping -> a plain nested dict."""
    if hasattr(tree, "items") and not isinstance(tree, dict):
        tree = dict(tree)
    if isinstance(tree, dict):
        return {k: _as_plain_dict(v) for k, v in tree.items()}
    return tree
