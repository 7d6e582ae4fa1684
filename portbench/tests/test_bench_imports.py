"""What the benchmark's modules import, by top-level name taken whole:
``dt4image_restoration_tpu_torch`` begins with the JAX package's name, so
a prefix match would wrongly flag it."""
import ast
from pathlib import Path

import pytest

from portbench.spec import PACKAGE

JAX = {"jax", "jaxlib", "flax", "dt4image_restoration_tpu"}
PORT = "dt4image_restoration_tpu_torch"


def top_level_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _sources(sub=""):
    return sorted((PACKAGE / sub).rglob("*.py"))


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_nothing_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & JAX


@pytest.mark.parametrize("path", _sources("reference"), ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_port(path):
    assert PORT not in top_level_imports(path)


def test_the_whole_name_is_compared():
    src = PACKAGE / "system.py"
    assert PORT in top_level_imports(src)          # the port is allowed
    assert not top_level_imports(src) & JAX


def test_only_system_imports_the_port():
    importers = {p.name for p in _sources() if "tests" not in p.parts
                 and PORT in top_level_imports(p)}
    assert importers == {"system.py"}


def test_a_run_refuses_a_process_that_loaded_jax(monkeypatch):
    import sys
    import types
    from portbench.run import loaded_forbidden
    import dt4image_restoration_tpu_torch  # noqa: F401 - whole names
    assert PORT not in loaded_forbidden()
    monkeypatch.setitem(sys.modules, "dt4image_restoration_tpu.config",
                        types.ModuleType("dt4image_restoration_tpu.config"))
    assert "dt4image_restoration_tpu" in loaded_forbidden()
