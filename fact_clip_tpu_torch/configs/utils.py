"""Config assembly (the port's copy of ``fact_clip_tpu/configs/utils.py``).

``setup_cfg`` merges default <- YAML file(s) <- ``--set k v`` overrides,
names the experiment from its difference to the defaults and lays out the
log directory as ``log/<dataset>/<split>/<expname>/<runid>`` with ``-``
replaced by ``_``; ``update_from`` is the Bi -> Bu -> BU None-inheritance.
"""

from __future__ import annotations

import os

from .default import get_cfg_defaults
from .node import CfgNode


def _cfg2flatdict_helper(cfg: CfgNode) -> dict:
    out = {}
    for k, v in cfg.items():
        if not isinstance(v, CfgNode):
            out[k] = v
        else:
            sub = _cfg2flatdict_helper(v)
            out.update({f"{k}.{k2}": v2 for k2, v2 in sub.items()})
    return out


def type_convert_helper(x):
    if type(x) in (int, float, bool, str):
        return x
    return str(x)


def cfg2flatdict(cfg: CfgNode, type_convert: bool = True) -> dict:
    """Flatten a nested cfg into dotted keys (for experiment loggers)."""
    flat = _cfg2flatdict_helper(cfg)
    if type_convert:
        flat = {k: type_convert_helper(v) for k, v in flat.items()}
    return flat


def generate_diff_dict(default: CfgNode, cfg: CfgNode, include_missing: bool = False) -> dict:
    """Keys in ``cfg`` whose values differ from ``default`` (recursively)."""
    diff = {}
    for k, v in cfg.items():
        if k not in default and not include_missing:
            continue
        if isinstance(v, CfgNode):
            sub = generate_diff_dict(default[k], cfg[k], include_missing=include_missing)
            if sub:
                diff[k] = sub
        else:
            if v != default.get(k):
                diff[k] = v
    return diff


def capitalize(string: str) -> str:
    return string[0].upper() + string[1:]


def diff2expname(diff: dict, remove_leaf: bool = False) -> str:
    """Render a diff dict into the compact experiment-name fragment."""
    string = ""
    for k, v in diff.items():
        if k.lower() == "aux":
            continue  # exclude auxiliary config
        if k.lower() == "split":
            continue  # exclude split name
        if isinstance(v, dict):
            v = diff2expname(v, remove_leaf=False)
            string += "%s[%s]-" % (k, v)
        elif not remove_leaf:
            if isinstance(v, bool):
                v = str(v)[0]
            string += "%s:%s-" % (k, v)
    return string[:-1]  # strip trailing dash


def generate_expname(cfg: CfgNode, cfg_file=None, default: CfgNode | None = None) -> str:
    """Experiment name = joined config-file stems + diff-vs-default fragment."""
    if cfg_file is None:
        cfg_file = cfg.aux.cfg_file

    expname = []
    if default is None:
        default = get_cfg_defaults()
    else:
        default = default.clone()

    for f in cfg_file:
        # merge_from_file (not a raw load_cfg) so `_BASE_:` overlay recipes
        # resolve their base file here too
        default.merge_from_file(f)
        stem = ".".join(os.path.basename(f).split(".")[:-1])
        expname.append(stem)

    diff = generate_diff_dict(default, cfg)
    prune = {capitalize(k): v for k, v in diff.items()}
    diff_string = diff2expname(prune)
    if diff_string:
        expname.append(diff_string)
    if cfg.aux.mark:
        expname.append(cfg.aux.mark)

    return "-".join(expname)


def int2float_check(x: str, tgt):
    """Append '.0' to integer-looking strings targeting float keys."""
    if isinstance(tgt, float) and "." not in x:
        try:
            int(x)
            x = x + ".0"
        except ValueError:
            pass
    return x


def _get_var(c, ks: list, delete: bool = False):
    if len(ks) == 1:
        v = c[ks[0]]
        if delete:
            del c[ks[0]]
        return v
    return _get_var(c[ks[0]], ks[1:], delete=delete)


def setup_cfg(cfg_file=(), set_cfgs=None, default: CfgNode | None = None, logdir: str = "log/") -> CfgNode:
    """Build the run config from the default, YAML file(s), and CLI overrides."""
    cfg = get_cfg_defaults() if default is None else default.clone()

    # preprocess set_cfgs to convert int->float where the target key is a float
    cfg_file = list(cfg_file)
    L = len(set_cfgs) if set_cfgs else 0
    new_set_cfgs = []
    for i in range(L // 2):
        k = set_cfgs[i * 2]
        v = set_cfgs[i * 2 + 1]
        keys = k if isinstance(k, list) else [k]
        for k_ in keys:
            try:
                tgt = _get_var(cfg, k_.split("."))
            except KeyError:
                raise KeyError(f"Non-existent config key in --set: {k_}") from None
            new_set_cfgs.extend([k_, int2float_check(v, tgt)])

    for f in cfg_file:
        cfg.merge_from_file(f)
    if set_cfgs is not None:
        cfg.merge_from_list(new_set_cfgs)
    cfg.aux.cfg_file = cfg_file
    cfg.aux.set_cfgs = list(set_cfgs) if set_cfgs is not None else None

    cfg.aux.exp = generate_expname(cfg, default=default)

    logdir = logdir if not cfg.aux.debug else "log_test/"
    logdir = os.path.join(logdir, cfg.dataset, cfg.split, cfg.aux.exp, str(cfg.aux.runid))
    logdir = logdir.replace("-", "_")
    cfg.aux.logdir = logdir
    return cfg


def update_from(cfg: CfgNode, ref: CfgNode, inplace: bool = False) -> CfgNode:
    """Fill None-valued keys of ``cfg`` from ``ref`` (block config inheritance)."""
    if not inplace:
        cfg = cfg.clone()
    cfg.defrost()
    for k in cfg:
        if k not in ref:
            continue
        if cfg[k] is None and ref[k] is not None:
            cfg[k] = ref[k]
    return cfg
