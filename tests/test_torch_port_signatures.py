"""The ctypes signatures of the kernel library (``_build.SIGNATURES``)
against the C definitions in ``csrc/``: every entry the table binds is
defined once with ``extern "C"``, with as many parameters, each of the
bound type.  A mismatch shows on the card only, as a ctypes error or a
garbled argument, so it is checked here from the sources."""

import glob
import os
import re

import pytest

from fact_clip_tpu_torch import _build

_DEF = re.compile(r'extern "C" int (\w+)\(([^)]*)\)\s*\{', re.S)


def _kind(param: str):
    """The ctypes type a C parameter binds to."""
    words = param.replace("__restrict__", "").split()
    if "*" in param:
        return _build.P
    kind = " ".join(w for w in words[:-1] if w != "const")
    return {"int": _build.I, "long long": _build.L, "float": _build.F,
            "unsigned": _build.U}[kind]


def _definitions():
    found = {}
    for path in sorted(glob.glob(os.path.join(_build.CSRC_DIR, "*.cu*"))):
        for name, params in _DEF.findall(open(path).read()):
            assert name not in found, f"{name} is defined twice"
            found[name] = [_kind(p) for p in params.split(",")]
    return found


DEFINITIONS = _definitions()


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_signature_matches_the_c_definition(name):
    assert name in DEFINITIONS, f"{name} has no extern \"C\" definition in csrc/"
    assert _build.SIGNATURES[name] == DEFINITIONS[name]
