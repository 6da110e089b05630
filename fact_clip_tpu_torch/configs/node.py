"""A small hierarchical config node (the port's copy of
``fact_clip_tpu/configs/node.py``).

``CfgNode`` is a ``dict`` with attribute access, ``clone``, ``freeze`` /
``defrost``, ``merge_from_file`` (with ``_BASE_`` and its cycle check),
``merge_from_other_cfg``, ``merge_from_list`` and ``load_cfg``.  YAML is read
by ``yaml_lite`` (the card's machine has no PyYAML), which resolves scalars
as ``yaml.safe_load`` does; a node prints as JSON.
"""

from __future__ import annotations

import copy
import json
import os
from typing import Any

from . import yaml_lite

_IMMUTABLE = "__immutable__"
_VALID_LEAF_TYPES = (int, float, bool, str, list, tuple, type(None))


class CfgNode(dict):
    """Hierarchical configuration node with attribute access."""

    def __init__(self, init_dict: dict | None = None):
        super().__init__()
        object.__setattr__(self, _IMMUTABLE, False)
        if init_dict:
            for k, v in init_dict.items():
                if isinstance(v, dict) and not isinstance(v, CfgNode):
                    v = CfgNode(v)
                self[k] = v

    def __getattr__(self, name: str) -> Any:
        if name in self:
            return self[name]
        raise AttributeError(f"CfgNode has no attribute {name!r}")

    def __setattr__(self, name: str, value: Any) -> None:
        if object.__getattribute__(self, _IMMUTABLE):
            raise AttributeError(
                f"Attempted to set {name!r} on an immutable CfgNode; call defrost() first")
        _check_leaf_type(name, value)
        self[name] = value

    def __setitem__(self, name, value):
        if object.__getattribute__(self, _IMMUTABLE):
            raise AttributeError(
                f"Attempted to set {name!r} on an immutable CfgNode; call defrost() first")
        super().__setitem__(name, value)

    def __delattr__(self, name):
        if object.__getattribute__(self, _IMMUTABLE):
            raise AttributeError("Cannot delete from an immutable CfgNode")
        del self[name]

    def is_frozen(self) -> bool:
        return object.__getattribute__(self, _IMMUTABLE)

    def freeze(self) -> None:
        self._set_immutable(True)

    def defrost(self) -> None:
        self._set_immutable(False)

    def _set_immutable(self, flag: bool) -> None:
        object.__setattr__(self, _IMMUTABLE, flag)
        for v in self.values():
            if isinstance(v, CfgNode):
                v._set_immutable(flag)

    def clone(self) -> "CfgNode":
        return copy.deepcopy(self)

    def __deepcopy__(self, memo):
        out = CfgNode()
        memo[id(self)] = out
        for k, v in self.items():
            dict.__setitem__(out, copy.deepcopy(k, memo), copy.deepcopy(v, memo))
        object.__setattr__(out, _IMMUTABLE, False)
        return out

    def merge_from_other_cfg(self, other: "CfgNode") -> None:
        _merge_into(other, self, [])

    def merge_from_file(self, fname: str, _seen: tuple = ()) -> None:
        real = os.path.realpath(fname)  # a symlinked alias still trips the cycle check
        if real in _seen:
            chain = " -> ".join(list(_seen) + [real])
            raise ValueError(f"Circular _BASE_ chain in config files: {chain}")
        with open(fname, "r") as fp:
            loaded = CfgNode.load_cfg(fp)
        # `_BASE_: other.yaml` (relative to this file) merges the base first
        base = dict.pop(loaded, "_BASE_", None)
        if base is not None:
            base_path = os.path.join(os.path.dirname(os.path.abspath(fname)), base)
            if not os.path.exists(base_path):
                raise FileNotFoundError(
                    f"_BASE_ file {base!r} (referenced by {fname}) not found at {base_path}")
            self.merge_from_file(base_path, _seen=_seen + (real,))
        self.merge_from_other_cfg(loaded)

    def merge_from_list(self, cfg_list: list) -> None:
        if len(cfg_list) % 2:
            raise ValueError(f"Override list must have even length: {cfg_list}")
        for k, v in zip(cfg_list[0::2], cfg_list[1::2]):
            keys = k.split(".")
            node = self
            for sub in keys[:-1]:
                if sub not in node:
                    raise KeyError(f"Non-existent config key: {k}")
                node = node[sub]
            leaf = keys[-1]
            if leaf not in node:
                raise KeyError(f"Non-existent config key: {k}")
            node[leaf] = _coerce_value(v, node[leaf], k)

    @classmethod
    def load_cfg(cls, fp) -> "CfgNode":
        content = fp if isinstance(fp, str) else fp.read()
        data = yaml_lite.safe_load(content)
        if data is None:
            data = {}
        if not isinstance(data, dict):
            raise TypeError(f"Config file must contain a mapping, got {type(data)}")
        return cls(data)

    def __str__(self) -> str:
        return json.dumps(_to_plain_dict(self), indent=1, sort_keys=True)

    def __repr__(self) -> str:
        return f"CfgNode({dict.__repr__(self)})"


def _check_leaf_type(name, value):
    if not isinstance(value, _VALID_LEAF_TYPES + (CfgNode, dict)):
        raise TypeError(f"Invalid type {type(value)} for config key {name!r}")


def _to_plain_dict(node: CfgNode) -> dict:
    out = {}
    for k, v in node.items():
        out[k] = _to_plain_dict(v) if isinstance(v, CfgNode) else v
    return out


def _coerce_value(new: Any, old: Any, full_key: str) -> Any:
    """Coerce a (possibly string) override value to the type of the default."""
    if new == "None" and not isinstance(old, str):
        # YAML reads a bare ``None`` as the string "None"; some recipes
        # (gtea_transcript.yaml) spell null that way
        return None
    if isinstance(new, str) and not isinstance(old, str):
        new = yaml_lite.safe_load(new)
    if old is None or new is None:
        return new
    if isinstance(old, float) and isinstance(new, int):
        return float(new)
    if isinstance(old, bool) != isinstance(new, bool) and {type(old), type(new)} == {bool, int}:
        return bool(new) if isinstance(old, bool) else int(new)
    if isinstance(old, (list, tuple)) and isinstance(new, (list, tuple)):
        return type(old)(new)
    if type(old) is not type(new) and not isinstance(old, CfgNode):
        raise TypeError(f"Type mismatch for key {full_key}: default {type(old).__name__} "
                        f"vs override {type(new).__name__}")
    return new


def _merge_into(src: CfgNode, dst: CfgNode, key_path: list) -> None:
    for k, v in src.items():
        full_key = ".".join(key_path + [str(k)])
        if k not in dst:
            raise KeyError(f"Non-existent config key: {full_key}")
        old = dst[k]
        if isinstance(old, CfgNode):
            if not isinstance(v, (dict, CfgNode)):
                raise TypeError(f"Cannot merge leaf into subtree at {full_key}")
            _merge_into(CfgNode(v) if not isinstance(v, CfgNode) else v, old, key_path + [str(k)])
        else:
            dict.__setitem__(dst, k, _coerce_value(v, old, full_key))
