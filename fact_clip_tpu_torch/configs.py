"""Model and training configuration without YAML.

Counterpart of ``fact_clip_tpu/configs/default.py`` (the optimizer keys and
the FACT, Bi, Bu, BU, Loss, TM and TPU sections),
``fact_clip_tpu/models/blocks.py:40-143`` (BlockCfg and the Bi -> Bu -> BU
inheritance) and ``__graft_entry__._make_cfg``.  A config is a plain nested
dict; ``flagship_cfg()`` is the repository's flagship (HAViD-scale, ``iuUU``),
``small_cfg()`` its narrow test twin and ``train_cfg()`` the flagship as the
port trains it.

``BlockCfg`` keeps the JAX field names.  ``pallas`` / ``pallas_attn`` /
``pallas_sa`` select the hand-written CUDA kernels here, as they select the
Pallas kernels there; False is the plain PyTorch path.
"""

from __future__ import annotations

import copy
import dataclasses


@dataclasses.dataclass(frozen=True)
class BlockCfg:
    """Static per-block hyperparameters (one of Bi/Bu/BU after inheritance)."""

    kind: str  # 'i' input block, 'u' update block, 'U' update block with TDU
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


_BLOCK_KEYS = ("hid_dim", "dropout", "a", "a_nhead", "a_ffdim", "a_layers", "a_dim",
               "f", "f_layers", "f_ln", "f_dim", "f_ngp")


def default_cfg() -> dict:
    """The defaults of the JAX config tree's model sections."""
    inherit = dict.fromkeys(_BLOCK_KEYS)
    return {
        "FACT": {"ntoken": 30, "block": "iuUU", "trans": False, "fpos": True, "cmr": 0.3,
                 "mwt": 0.1},
        "Bi": {"hid_dim": 512, "dropout": 0.5, "a": "sca", "a_nhead": 8, "a_ffdim": 2048,
               "a_layers": 6, "a_dim": 512, "f": "cnn", "f_layers": 10, "f_ln": True,
               "f_dim": 512, "f_ngp": 4},
        "Bu": {**inherit, "a": "sa", "a_layers": 1, "f_layers": 5},
        "BU": {**inherit, "a": "sa", "a_layers": 1, "f_layers": 5, "s_layers": 1},
        "TPU": {"pallas": True, "pallas_attn": True, "pallas_sa": True,
                "compute_dtype": "float32", "quantize_infer": "", "matcher": "auto"},
        "Loss": {"pc": 1.0, "a2fc": 1.0, "match": "o2o", "bgw": 1.0, "nullw": -1.0,
                 "sw": 0.0, "ref_weight_order": False},
        "TM": {"use": False, "t": 30, "p": 0.05, "m": 5, "inplace": True},
        "optimizer": "SGD", "lr": 0.1, "lr_decay": -1, "momentum": 0.009,
        "weight_decay": 0.0, "clip_grad_norm": 10.0,
    }


def flagship_cfg() -> dict:
    """FACT iuUU at HAViD scale (``__graft_entry__._make_cfg(small=False)``)."""
    cfg = _graft_training(default_cfg())
    cfg["FACT"].update(ntoken=40, fpos=False, cmr=0.3)
    cfg["Bi"].update(hid_dim=512, a_dim=256, a_ffdim=512, a_layers=6, a_nhead=8, f="m",
                     f_dim=256, f_layers=10, f_ln=False, f_ngp=1, dropout=0.2)
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
    clip_grad_norm 10) with the SCA cross-attention and the SA sublayers on
    their plain autograd paths (``pallas_attn`` and ``pallas_sa`` off: their
    backward kernels come later) and the host Hungarian matcher (the
    ``"auction"`` of ``_make_cfg`` is a TPU workaround)."""
    cfg = flagship_cfg()
    cfg["TPU"].update(pallas_attn=False, pallas_sa=False, matcher="host")
    return cfg


def _block(node: dict, kind: str, tpu: dict) -> BlockCfg:
    return BlockCfg(
        kind=kind, hid_dim=node["hid_dim"], dropout=float(node["dropout"]), a=node["a"],
        a_nhead=node["a_nhead"], a_ffdim=node["a_ffdim"], a_layers=node["a_layers"],
        a_dim=node["a_dim"], f=node["f"], f_layers=node["f_layers"], f_ln=bool(node["f_ln"]),
        f_dim=node["f_dim"], f_ngp=node["f_ngp"], s_layers=node.get("s_layers", 1) or 1,
        pallas=bool(tpu["pallas"]), pallas_attn=bool(tpu["pallas_attn"]),
        pallas_sa=bool(tpu["pallas_sa"]),
    )


def resolve_block_cfgs(cfg: dict) -> tuple:
    """Sequential Bi -> Bu -> BU None-inheritance, one BlockCfg per block."""
    tpu = cfg["TPU"]
    if tpu.get("compute_dtype", "float32") not in ("", "float32", None):
        raise ValueError("the port runs float32 only")
    if tpu.get("quantize_infer"):
        raise ValueError("int8 towers are not ported")
    cfg = copy.deepcopy(cfg)
    base = cfg["Bi"]
    out = []
    for kind in cfg["FACT"]["block"]:
        if kind == "i":
            node = cfg["Bi"]
        elif kind in ("u", "U"):
            node = cfg["Bu" if kind == "u" else "BU"]
            for k in node:
                if node[k] is None and base.get(k) is not None:
                    node[k] = base[k]
            base = node
        else:
            raise ValueError(f"unsupported block type {kind!r}")
        out.append(_block(node, kind, tpu))
    return tuple(out)
