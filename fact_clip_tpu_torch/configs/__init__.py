"""Model and training configuration.

Counterpart of ``fact_clip_tpu/configs/`` (``default.py``: the default
tree; ``node.py``: ``CfgNode``; ``utils.py``: ``setup_cfg`` and the
experiment name; the YAML files are read as data by ``yaml_lite``, the
port's own reader), ``fact_clip_tpu/models/blocks.py:40-143`` (BlockCfg
and the Bi -> Bu -> BU inheritance) and ``__graft_entry__._make_cfg``.
``resolve_block_cfgs`` and ``build_fact`` take a ``CfgNode`` tree from
``setup_cfg`` or a plain nested dict; ``default_cfg()`` is the default
tree as a plain dict, ``flagship_cfg()`` is the repository's flagship (HAViD-scale, ``iuUU``),
``small_cfg()`` its narrow test twin and ``train_cfg()`` the flagship as the
port trains it; ``breakfast_cfg()`` mirrors ``fact_clip_tpu/configs/
breakfast.yaml`` (MS-TCN++ towers, 512 wide) and ``breakfast_train_cfg()``
is it as the port trains it; ``epic_cfg()`` mirrors ``epic-kitchens.yaml``
(the verb/noun model, ``IUUU``), ``epic_train_cfg()`` is it as the port
trains it, and ``epic_vocab()`` draws its 3,806-action vocabulary;
``egoprocel_cfg()`` mirrors ``egoprocel.yaml`` (``iUUU``, 200 action tokens)
and ``egoprocel_train_cfg()`` is it as the port trains it;
``flagship_int8_cfg()``, ``breakfast_int8_cfg()`` and ``epic_int8_cfg()``
are those three evaluated with int8 towers and projections
(``TPU.quantize_infer: "int8"``); ``openvocab_cfg()`` mirrors
``openvocab_havid_view0_lh_pt.yaml`` (FACT_CLIP, MS-TCN++ towers 512 wide)
and ``openvocab_train_cfg()`` is it as the port trains it, with the holdout
recipes' held-out classes; ``gtea_cfg()`` mirrors ``gtea.yaml`` (``iuU``,
attention at a_dim 128 with 8 heads, towers 128 wide) and
``gtea_train_cfg()`` is it as the port trains it; ``gtea_transcript_cfg()``
mirrors ``gtea_transcript.yaml`` (transcript mode, ``FACT.trans``: the
tokens are the transcript, ``seq`` matching); ``havid_tpu_cfg()`` is
``havid_tpu.yaml`` as read (the flagship recipe under mixed precision,
``TPU.compute_dtype: bfloat16``), which the port serves, evaluates and trains,
and ``breakfast_bf16_cfg()`` is Breakfast under mixed precision.

``dtype`` is ``"bfloat16"`` under ``TPU.compute_dtype: bfloat16`` (JAX's
mixed-precision policy, ``fact_clip_tpu/models/layers.py:31-35``): heavy
products and the tower stream on bf16 operands with f32 accumulation,
softmax, LayerNorm statistics, probabilities and logits in f32.  The port
has that path for serving and training FACT with ``f: m`` and ``f: m2``
towers without a LayerNorm; ``bf16_refusal`` names what it refuses, before
any launch.

``BlockCfg`` keeps the JAX field names.  ``pallas`` / ``pallas_attn`` /
``pallas_sa`` select the hand-written CUDA kernels here, as they select the
Pallas kernels there; False is the plain PyTorch path.  ``quantize`` is
``"int8"`` when ``TPU.quantize_infer`` asks for it and ``TPU.pallas`` is on
(JAX drops quantization without its Pallas kernels,
``fact_clip_tpu/models/blocks.py:124-127``); a grouped tower (``f_ngp > 1``)
keeps the field but quantizes nothing, as in JAX (``layers.py:443``).
"""

from __future__ import annotations

import copy
import dataclasses
import os

from .default import get_cfg_defaults
from .node import CfgNode, _to_plain_dict
from .utils import cfg2flatdict, setup_cfg, update_from


@dataclasses.dataclass(frozen=True)
class BlockCfg:
    """Static per-block hyperparameters (one of Bi/Bu/BU after inheritance)."""

    kind: str  # 'i' input block, 'u' update block, 'U' update block with TDU, 'I' verb/noun input
    hid_dim: int
    dropout: float
    a: str
    a_nhead: int
    a_ffdim: int
    a_layers: int
    a_dim: int
    f: str
    f_layers: int
    f_ln: bool
    f_dim: int
    f_ngp: int
    s_layers: int = 1
    pallas: bool = False
    pallas_attn: bool = True
    pallas_sa: bool = True
    quantize: str = ""
    dtype: str = ""


def default_cfg() -> dict:
    """The JAX config tree's defaults (``configs/default.py``) as a plain dict."""
    return _to_plain_dict(get_cfg_defaults())


def flagship_cfg() -> dict:
    """FACT iuUU at HAViD scale (``__graft_entry__._make_cfg(small=False)``)."""
    cfg = _graft_training(default_cfg())
    cfg["FACT"].update(ntoken=40, fpos=False, cmr=0.3)
    cfg["Bi"].update(hid_dim=512, a_dim=256, a_ffdim=512, a_layers=6, a_nhead=8, f="m",
                     f_dim=256, f_layers=10, f_ln=False, f_ngp=1, dropout=0.2)
    return cfg


def flagship_int8_cfg() -> dict:
    """The flagship with int8 evaluation (``TPU.quantize_infer: "int8"``):
    in eval mode its MSTCN towers and their in map, the X2Y projections over
    the frame axis and the SCA key / value projections run on int8 operands
    (ops/quant_conv.py); training is unchanged."""
    return _int8(flagship_cfg())


def _int8(cfg: dict) -> dict:
    cfg["TPU"]["quantize_infer"] = "int8"
    return cfg


def _graft_training(cfg: dict) -> dict:
    """The training keys ``__graft_entry__._make_cfg`` sets for both sizes."""
    cfg["Loss"].update(sw=5.0, pc=0.2, nullw=0.1)
    cfg.update(optimizer="Adam", lr=1e-4)
    return cfg


def small_cfg() -> dict:
    """The narrow twin (``__graft_entry__._make_cfg(small=True)``)."""
    cfg = _graft_training(default_cfg())
    cfg["FACT"].update(ntoken=8, fpos=False, cmr=0.3)
    cfg["Bi"].update(hid_dim=32, a_dim=16, a_ffdim=32, a_layers=2, a_nhead=4, f="m",
                     f_dim=24, f_layers=3, f_ln=False, f_ngp=1, dropout=0.1)
    cfg["Bu"]["f_layers"] = 2
    cfg["BU"]["f_layers"] = 2
    return cfg


def train_cfg() -> dict:
    """The flagship as the port trains it: ``_make_cfg(small=False)``
    (dropout 0.2, cmr 0.3, sw 5, pc 0.2, nullw 0.1, Adam at lr 1e-4,
    clip_grad_norm 10, every kernel on) with the host Hungarian matcher in
    place of the ``"auction"`` of ``_make_cfg`` (a TPU workaround).
    ``model.set_kernels(False)`` gives its plain PyTorch path."""
    cfg = flagship_cfg()
    cfg["TPU"]["matcher"] = "host"
    return cfg


def breakfast_cfg() -> dict:
    """``fact_clip_tpu/configs/breakfast.yaml`` over the defaults: vanilla
    FACT ``iuUU`` with MS-TCN++ frame towers (``f: m2``, 10 layers), every
    width 512, 60 action tokens, SCA input decoder, TDU blocks, o2o matching,
    time masking on; ``nullw = -1`` is resolved from the data by
    ``models/losses.py::compute_null_weight``.  Every kernel is on."""
    cfg = default_cfg()
    cfg.update(dataset="breakfast", optimizer="Adam", lr=1e-4, lr_decay=80, momentum=0.0,
               weight_decay=0.0, clip_grad_norm=10.0)
    cfg["FACT"].update(block="iuUU", ntoken=60, trans=False, fpos=False, cmr=0.3, mwt=0.1)
    cfg["Bi"].update(hid_dim=512, dropout=0.0, a="sca", a_nhead=8, a_ffdim=512, a_layers=6,
                     a_dim=512, f="m2", f_layers=10, f_ln=False, f_dim=512, f_ngp=1)
    cfg["Bu"].update(a="sa", a_nhead=8, a_layers=1, f_layers=10)
    cfg["BU"].update(a="sa", a_nhead=8, a_layers=1, f_layers=10, s_layers=1)
    cfg["Loss"].update(pc=0.2, a2fc=1.0, match="o2o", bgw=1.0, nullw=-1.0, sw=5.0)
    cfg["TM"].update(use=True, t=30, p=0.05, m=5)
    return cfg


def breakfast_int8_cfg() -> dict:
    """``breakfast_cfg()`` with int8 evaluation (``TPU.quantize_infer:
    "int8"``): in eval mode its MS-TCN++ towers (K8e) and the input block's
    in map (``dense_q8``), the X2Y projections over the frame axis (K8b /
    K8c) and the SCA key / value projections (K8d) run on int8 operands."""
    return _int8(breakfast_cfg())


def breakfast_bf16_cfg() -> dict:
    """``breakfast_cfg()`` under mixed precision (``TPU.compute_dtype:
    bfloat16``, as ``breakfast.yaml --set TPU.compute_dtype bfloat16``) with
    the host Hungarian matcher: K6's bf16 form in every tower, K2-K4's at
    Breakfast's widths, served, evaluated and trained at its dropout 0."""
    cfg = breakfast_train_cfg()
    cfg["TPU"]["compute_dtype"] = "bfloat16"
    return cfg


def breakfast_train_cfg() -> dict:
    """``breakfast_cfg()`` with the host Hungarian matcher, as the port
    trains it.  ``model.set_kernels(False)`` gives its plain PyTorch path."""
    cfg = breakfast_cfg()
    cfg["TPU"]["matcher"] = "host"
    return cfg


def epic_cfg() -> dict:
    """``fact_clip_tpu/configs/epic-kitchens.yaml`` over the defaults: the
    verb/noun model ``IUUU`` (every block at predicted-segment granularity),
    300 action tokens, sinusoid frame positions, a 6-layer SCA input decoder,
    ``f: m2`` 10-layer towers 256 wide in a 512-wide stream, o2m matching,
    batch size 1.  Every kernel is on; ``model.set_kernels(False)`` gives
    its plain PyTorch path.  Build it with ``models.verbnoun.
    build_verbnoun_fact(epic_cfg(), 1024, *epic_vocab(), 256)``."""
    cfg = default_cfg()
    cfg.update(dataset="epic", split="split1", sr=4, batch_size=1, optimizer="Adam", lr=1e-4,
               lr_decay=600, momentum=0.0, weight_decay=0.0, clip_grad_norm=10.0)
    cfg["FACT"].update(block="IUUU", ntoken=300, trans=False, fpos=True, cmr=0.3, mwt=0.1)
    cfg["Bi"].update(hid_dim=512, dropout=0.0, a="sca", a_nhead=8, a_ffdim=512, a_layers=6,
                     a_dim=256, f="m2", f_layers=10, f_ln=False, f_dim=256, f_ngp=1)
    cfg["Bu"].update(a="sa", a_nhead=8, a_layers=1, f_layers=10)
    cfg["BU"].update(a="sa", a_nhead=8, a_layers=1, f_layers=10, s_layers=1)
    cfg["Loss"].update(pc=0.2, a2fc=1.0, match="o2m", bgw=0.5, nullw=0.05, sw=5.0)
    cfg["TM"]["use"] = False
    return cfg


def epic_int8_cfg() -> dict:
    """``epic_cfg()`` with int8 evaluation: in eval mode its MS-TCN++ towers
    (K8e), the input block's in map and the X2Y projections (K8b) run on int8
    operands; its SCA stays f32 (256 segment keys are below
    ``kernel_min_keys``, as in JAX)."""
    return _int8(epic_cfg())


def epic_train_cfg() -> dict:
    """``epic_cfg()`` with the host matcher (scipy: o2m's Hungarian stage and
    its per-class picks), as the port trains it.  ``model.set_kernels(False)``
    gives its plain PyTorch path.  Train it with ``engine.steps.
    make_train_step(model, epic_train_cfg(), 3806, cweight)``, cweight
    (3,807,)."""
    cfg = epic_cfg()
    cfg["TPU"]["matcher"] = "host"
    return cfg


def egoprocel_cfg() -> dict:
    """``fact_clip_tpu/configs/egoprocel.yaml`` over the defaults, uncut:
    ``iUUU`` (the input block, then three TDU update blocks), 200 action
    tokens, no frame positions, a 6-layer SCA input decoder (8 heads, a_dim
    256) over the 512-wide stream, ``f: m2`` 10-layer towers 256 wide, o2o
    matching with bgw 0.5 and the reference's weight order, ``nullw = -1``
    resolved from the data (``models/losses.py::compute_null_weight``), sw 5,
    Adam at 1e-4, clip 10, batch size 1.  Every kernel is on: the SCA's 200
    queries over 1,024 frames or more run K3.  The repository holds no
    EgoProceL features (JAX reads D from them, ``data/dataset.py:289``); the
    port's runs take D = 2048, as for the other I3D-fed configurations."""
    cfg = default_cfg()
    cfg.update(dataset="ego", split="split1", sr=3, batch_size=1, optimizer="Adam", lr=1e-4,
               lr_decay=250, momentum=0.0, weight_decay=0.0, clip_grad_norm=10.0)
    cfg["FACT"].update(block="iUUU", ntoken=200, trans=False, fpos=False, cmr=0.3, mwt=0.9)
    cfg["Bi"].update(hid_dim=512, dropout=0.0, a="sca", a_nhead=8, a_ffdim=512, a_layers=6,
                     a_dim=256, f="m2", f_layers=10, f_ln=False, f_dim=256, f_ngp=1)
    cfg["Bu"].update(a="sa", a_nhead=8, a_layers=1, f_layers=10)
    cfg["BU"].update(a="sa", a_nhead=8, a_layers=1, f_layers=10, s_layers=1)
    cfg["Loss"].update(pc=0.2, a2fc=1.0, match="o2o", bgw=0.5, nullw=-1.0, sw=5.0,
                       ref_weight_order=True)
    cfg["TM"]["use"] = False
    return cfg


def egoprocel_train_cfg() -> dict:
    """``egoprocel_cfg()`` with the host Hungarian matcher, as the port
    trains it.  ``model.set_kernels(False)`` gives its plain PyTorch path."""
    cfg = egoprocel_cfg()
    cfg["TPU"]["matcher"] = "host"
    return cfg


def openvocab_cfg() -> dict:
    """``fact_clip_tpu/configs/openvocab_havid_view0_lh_pt.yaml`` over the
    defaults, uncut: FACT_CLIP (``use_clip``) on ``iuUU``, 40 action tokens,
    a 6-layer 8-head SCA input decoder and ``f: m2`` 10-layer towers, every
    width 512, the projection's hidden layer 1024 (dropout 0.1), InfoNCE at
    temperature 0.07, o2o matching, ``nullw = -1`` resolved from the data,
    sw 5, time masking on, Adam at 1e-4, batch size 2.  Every kernel is on.
    Build it with ``models.clip_model.build_fact_clip(openvocab_cfg(), 2048,
    75, s_pred_cap, clip_dim)``."""
    cfg = breakfast_cfg()
    cfg.update(dataset="havid_view0_lh_pt", split="split1", sr=1, eval_bg=True, batch_size=2,
               epoch=150, use_clip=True)
    cfg["FACT"].update(ntoken=40)
    cfg["CLIP"].update(model_name="openai/clip-vit-base-patch32", text_trainable=True, temp=0.07,
                       precompute_text=True, use_prompt=True, projection_hidden_dim=1024,
                       projection_dropout=0.1)
    cfg["aux"].update(eval_every=2000, print_every=1000, wandb_project="FACT-OpenVocab")
    return cfg


def gtea_cfg() -> dict:
    """``fact_clip_tpu/configs/gtea.yaml`` over the defaults, uncut: FACT
    ``iuU``, 60 action tokens, a 6-layer SCA input decoder of 8 heads at
    a_dim 128 (a head 16 wide) over the 512-wide stream, ``f: m`` towers
    128 wide (10 layers in every block), dropout
    0.2, o2o matching with pc 0.2, ``nullw = -1`` resolved from the data,
    sw 5, channel masking 0.5 and time masking on, Adam at 1e-4, batch
    size 1.  Every kernel is on.  Build it with ``models.blocks.
    build_fact(gtea_cfg(), 2048, 11, s_pred_cap)``."""
    cfg = default_cfg()
    cfg.update(dataset="gtea", split="split1", sr=1, eval_bg=False, batch_size=1,
               optimizer="Adam", epoch=400, lr=1e-4, lr_decay=250, momentum=0.0,
               weight_decay=0.0, clip_grad_norm=10.0)
    cfg["FACT"].update(block="iuU", ntoken=60, trans=False, fpos=False, cmr=0.5, mwt=0.1)
    cfg["Bi"].update(hid_dim=512, dropout=0.2, a="sca", a_nhead=8, a_ffdim=512, a_layers=6,
                     a_dim=128, f="m", f_layers=10, f_ln=False, f_dim=128, f_ngp=1)
    cfg["Bu"].update(a="sa", a_nhead=8, a_layers=1, f_layers=10)
    cfg["BU"].update(a="sa", a_nhead=8, a_layers=1, f_layers=10, s_layers=1)
    cfg["Loss"].update(pc=0.2, a2fc=1.0, match="o2o", bgw=1.0, nullw=-1.0, sw=5.0)
    cfg["TM"].update(use=True, t=60, p=0.1, m=5)
    cfg["aux"].update(eval_every=300, print_every=100)
    return cfg


def gtea_train_cfg() -> dict:
    """``gtea_cfg()`` with the host Hungarian matcher, as the port trains
    it.  ``model.set_kernels(False)`` gives its plain PyTorch path."""
    cfg = gtea_cfg()
    cfg["TPU"]["matcher"] = "host"
    return cfg


def gtea_transcript_cfg() -> dict:
    """``fact_clip_tpu/configs/gtea_transcript.yaml`` over the defaults,
    uncut: transcript mode (``FACT.trans``, no learned tokens: the tokens
    are the video's transcript, embedded, and the model is built with M =
    the batches' segment cap), ``iuU`` with a 3-layer SCA input decoder at
    a_dim 128 and ``f: m`` towers 128 wide (10 / 3 / 5 layers), ``seq``
    matching (token k is segment k), the transcript decode at mwt 0, pc 1,
    sw 5, ``nullw = -1`` (0 here: no token is null), channel masking 0.5
    and time masking on, Adam at 1e-4, batch size 1.  Every kernel is on."""
    cfg = gtea_cfg()
    cfg.update(epoch=2000, lr_decay=-1)
    cfg["FACT"].update(ntoken=0, trans=True, mwt=0.0)
    cfg["Bi"].update(a_layers=3)
    cfg["Bu"]["f_layers"] = 3
    cfg["BU"]["f_layers"] = 5
    cfg["Loss"].update(pc=1.0, match="seq")
    cfg["aux"].update(eval_every=900, print_every=400)
    return cfg


HOLDOUT_CLASSES = [51, 53, 61, 67, 56]  # the havid_view*_pt_holdout.yaml recipes'


def openvocab_train_cfg() -> dict:
    """``openvocab_cfg()`` with the host Hungarian matcher and the holdout
    recipes' zero-shot split (``holdout_mode``, classes 51, 53, 61, 67 and
    56 held out), as the port trains it.  ``model.set_kernels(False)`` gives
    its plain PyTorch path."""
    cfg = openvocab_cfg()
    cfg.update(holdout_mode=True, holdout_classes=list(HOLDOUT_CLASSES))
    cfg["TPU"]["matcher"] = "host"
    return cfg


def havid_tpu_cfg() -> dict:
    """``fact_clip_tpu/configs/havid_tpu.yaml`` read as it stands (its
    ``_BASE_: havid.yaml``, through ``setup_cfg`` and ``yaml_lite``): the
    HAViD flagship recipe (``iuUU``, D=2048, 40 tokens, ``f: m`` towers 256
    wide with 10 layers, a 6-layer SCA input decoder of 8 heads at a_dim 256)
    with ``TPU.compute_dtype: bfloat16``, ``pallas``, ``pallas_sa`` and the
    ``auction`` matcher.  The port serves, evaluates and trains it in bf16
    (``Predictor``, ``make_eval_step``, ``run_eval``, ``TrainStep``,
    ``run_train``), its matching on the device (``ops/assignment.py``)."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "fact_clip_tpu", "configs", "havid_tpu.yaml")
    return _to_plain_dict(setup_cfg([path]))


def compute_dtype(cfg: dict) -> str:
    """``"bfloat16"`` under mixed precision, else ``""`` (float32), as JAX's
    ``blocks.py::_compute_dtype``; any other value raises."""
    d = cfg["TPU"].get("compute_dtype", "")
    if d in ("", "float32", None):
        return ""
    if d != "bfloat16":
        raise ValueError(f"unsupported TPU.compute_dtype {d!r}")
    return d


def bf16_refusal(cfg: dict) -> str | None:
    """Why the port has no bf16 path for ``cfg`` (None where it has one): the
    port serves and trains FACT with ``f: m`` and ``f: m2`` towers (grouped
    ones too) without a LayerNorm; the rest is queued in ROADMAP.md's M7
    items."""
    if not compute_dtype(cfg):
        return None
    nodes = [cfg["Bi"], cfg["Bu"], cfg["BU"]]
    if cfg.get("use_clip"):
        return "FACT_CLIP (use_clip) in bf16 is ROADMAP M7 item 4"
    if cfg["FACT"].get("trans"):
        return "transcript mode (FACT.trans) in bf16 is ROADMAP M7 item 4"
    if "I" in cfg["FACT"]["block"]:
        return "the verb/noun model in bf16 is ROADMAP M7 item 4"
    if cfg["TPU"].get("quantize_infer"):
        return "int8 evaluation (TPU.quantize_infer) under bf16 is ROADMAP M7 item 3"
    if any(n.get("f_ln") for n in nodes):
        return "the MSTCN tower's LayerNorm (f_ln) in bf16 is ROADMAP M7 item 2"
    return None


def epic_vocab(n1: int = 98, n2: int = 301, n_act: int = 3806, seed: int = 0) -> tuple:
    """(vids, nids): the repository's epic-scale action vocabulary, ``n_act``
    distinct (verb, noun) pairs drawn from ``default_rng(seed)`` and sorted
    (the draw of ``scripts/bench_epic.py::epic_recipe``; the repo holds no
    epic mapping files), as int32 action -> verb / noun ids."""
    import numpy as np

    rng = np.random.default_rng(seed)
    pairs = set()
    while len(pairs) < n_act:
        pairs.add((int(rng.integers(0, n1)), int(rng.integers(0, n2))))
    pairs = sorted(pairs)
    return np.array([p[0] for p in pairs], np.int32), np.array([p[1] for p in pairs], np.int32)


def _block(node: dict, kind: str, tpu: dict, quant: str, dtype: str) -> BlockCfg:
    return BlockCfg(
        kind=kind, hid_dim=node["hid_dim"], dropout=float(node["dropout"]), a=node["a"],
        a_nhead=node["a_nhead"], a_ffdim=node["a_ffdim"], a_layers=node["a_layers"],
        a_dim=node["a_dim"], f=node["f"], f_layers=node["f_layers"], f_ln=bool(node["f_ln"]),
        f_dim=node["f_dim"], f_ngp=node["f_ngp"], s_layers=node.get("s_layers", 1) or 1,
        pallas=bool(tpu["pallas"]), pallas_attn=bool(tpu["pallas_attn"]),
        pallas_sa=bool(tpu["pallas_sa"]), quantize=quant, dtype=dtype,
    )


def resolve_block_cfgs(cfg: dict) -> tuple:
    """Sequential Bi -> Bu -> BU None-inheritance, one BlockCfg per block."""
    tpu = cfg["TPU"]
    dtype = compute_dtype(cfg)
    why = bf16_refusal(cfg)
    if why is not None:
        raise NotImplementedError(f"TPU.compute_dtype bfloat16: {why}")
    quant = str(tpu.get("quantize_infer") or "")
    if quant not in ("", "int8"):
        raise ValueError(f"unsupported TPU.quantize_infer {quant!r}")
    quant = quant if tpu["pallas"] else ""  # int8 runs in the kernels only (blocks.py:126)
    trans = bool(cfg["FACT"].get("trans"))
    cfg = copy.deepcopy(cfg)
    base = cfg["Bi"]
    out = []
    for kind in cfg["FACT"]["block"]:
        if kind in ("i", "I"):  # 'I': the verb/noun model's input block (blocks.py:131)
            node = cfg["Bi"]
        elif kind in ("u", "U"):
            node = cfg["Bu" if kind == "u" else "BU"]
            for k in node:
                if node[k] is None and base.get(k) is not None:
                    node[k] = base[k]
            base = node
        else:
            raise ValueError(f"unsupported block type {kind!r}")
        if node["a"] in ("gru", "gru_om") and not trans:  # blocks.py:217-218
            raise ValueError("the GRU action branch needs transcript mode (FACT.trans)")
        out.append(_block(node, kind, tpu, quant, dtype))
    return tuple(out)
