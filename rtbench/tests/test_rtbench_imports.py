"""No module of rtbench imports JAX, the JAX package or its oracle, and the
reference imports nothing of the program either (an AST scan; top-level
names are compared whole, so refraction_tpu_torch is not
refraction_tpu)."""

import ast
import glob
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = sorted(glob.glob(os.path.join(ROOT, "**", "*.py"), recursive=True))
FORBIDDEN = {"jax", "jaxlib", "flax", "refraction_tpu", "oracle"}


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return {n.split(".")[0] for n in names}


@pytest.mark.parametrize("path", [os.path.relpath(p, ROOT) for p in FILES])
def test_no_jax(path):
    assert not _imports(os.path.join(ROOT, path)) & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    ref = [p for p in FILES if os.sep + "reference" + os.sep in p]
    assert ref
    for path in ref:
        assert "refraction_tpu_torch" not in _imports(path), path
    assert {"refraction_tpu_torch"} & set().union(*map(_imports, FILES))


def test_scan_compares_whole_names():
    assert "refraction_tpu_torch" not in FORBIDDEN
