"""No module under perfbench/ imports JAX, its relatives or the JAX
package; nothing under perfbench/reference/ imports the port. Top-level
module names are compared whole (the port's name begins with the JAX
package's)."""

import ast
import os

from conftest import PERFBENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "c2m_tpu"}


def top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def python_files(folder):
    for dirpath, _, files in os.walk(folder):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_nothing_imports_jax_or_the_jax_package():
    bad = {(p, m) for p in python_files(PERFBENCH)
           for m in top_level_imports(p) if m in FORBIDDEN}
    assert not bad


def test_the_reference_imports_nothing_of_the_port():
    ref = os.path.join(PERFBENCH, "reference")
    bad = {(p, m) for p in python_files(ref)
           for m in top_level_imports(p) if m == "c2m_tpu_torch"}
    assert not bad
    assert any(True for _ in python_files(ref))


def test_the_check_compares_whole_names():
    assert "c2m_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "c2m_tpu.models".split(".")[0] in FORBIDDEN
