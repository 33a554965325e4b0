"""The port's kernels' C interface, checked on the CPU (no nvcc needed).

``hydragnn_tpu_torch.ops._build.SOURCES`` gives each ``extern "C"``
function of ``hydragnn_tpu_torch/csrc/*.cu`` its ctypes argtypes. ctypes
checks a wrapper's argument count against those at the call, but nothing
checks them against the C signature: a pointer passed where the C function
takes an int, or one argument too few in the table, would only corrupt
memory on the card. So: every function's argtypes against the parameters
parsed from its source, and every call of it in the package
(``load().name(...)``, ``lib.name(...)``) with exactly as many arguments.
"""

import ast
import ctypes
import re
from pathlib import Path

import pytest

from hydragnn_tpu_torch.ops import _build

PKG = Path(_build.__file__).resolve().parents[1]
FUNCTIONS = [(src, fn) for src, fns in _build.SOURCES.items() for fn in fns]


def _c_params(source: str, fn: str) -> list:
    """The ctypes type of each parameter of ``extern "C" int fn(...)``."""
    text = (_build.CSRC / source).read_text()
    m = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", text)
    assert m, f"{source} defines no extern \"C\" int {fn}"
    params = [p.strip() for p in m.group(1).split(",") if p.strip() not in ("", "void")]
    kinds = []
    for p in params:
        if "*" in p:
            kinds.append(ctypes.c_void_p)
        elif re.match(r"(const )?int \w+$", p):
            kinds.append(ctypes.c_int)
        elif re.match(r"(const )?float \w+$", p):
            kinds.append(ctypes.c_float)
        else:
            raise AssertionError(f"{source}:{fn}: no ctypes type for parameter {p!r}")
    return kinds


def _wrapper_calls() -> dict:
    """``{function: [argument count of each call]}``: every call of a C
    function as an attribute (``load().name(...)``, ``lib.name(...)``) over
    the package's modules."""
    names = {fn for _, fn in FUNCTIONS}
    calls: dict = {}
    for path in PKG.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr in names):
                assert not any(isinstance(a, ast.Starred) for a in node.args), path
                calls.setdefault(node.func.attr, []).append(len(node.args))
    return calls


@pytest.mark.parametrize("source,fn", FUNCTIONS, ids=[fn for _, fn in FUNCTIONS])
def test_argtypes_match_the_c_signature(source, fn):
    assert _build.SOURCES[source][fn] == _c_params(source, fn)


@pytest.mark.parametrize("source,fn", FUNCTIONS, ids=[fn for _, fn in FUNCTIONS])
def test_wrappers_pass_every_argument(source, fn):
    calls = _wrapper_calls().get(fn)
    assert calls, f"no wrapper calls {fn}"
    assert set(calls) == {len(_build.SOURCES[source][fn])}, calls
