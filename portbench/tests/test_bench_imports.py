"""What the benchmark's modules import, by top-level name taken whole:
``dt4image_restoration_tpu_torch`` begins with the JAX package's name, so
a prefix match would wrongly flag it."""
import ast
import json
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
    """``system.py`` and the priors' ``system`` functions (see below)."""
    importers = {p.relative_to(PACKAGE).as_posix() for p in _sources()
                 if "tests" not in p.parts and PORT in top_level_imports(p)}
    assert "system.py" in importers
    assert all(n == "system.py" or n.startswith("priors/")
               for n in importers), importers


def test_a_run_refuses_a_process_that_loaded_jax(monkeypatch):
    import sys
    import types
    from portbench.run import loaded_forbidden
    import dt4image_restoration_tpu_torch  # noqa: F401 - whole names
    assert PORT not in loaded_forbidden()
    monkeypatch.setitem(sys.modules, "dt4image_restoration_tpu.config",
                        types.ModuleType("dt4image_restoration_tpu.config"))
    assert "dt4image_restoration_tpu" in loaded_forbidden()


def _port_imports(node):
    return {id(n) for n in ast.walk(node)
            if isinstance(n, ast.Import)
            and any(a.name.split(".")[0] == PORT for a in n.names)
            or isinstance(n, ast.ImportFrom) and n.level == 0
            and n.module.split(".")[0] == PORT}


@pytest.mark.parametrize("path", _sources("priors"), ids=lambda p: p.name)
def test_a_prior_imports_the_port_only_inside_system(path):
    tree = ast.parse(path.read_text())
    inside = set().union(*(_port_imports(f) for f in tree.body
                           if isinstance(f, ast.FunctionDef)
                           and f.name == "system"))
    assert _port_imports(tree) == inside


def test_a_priors_weights_reference_and_counts_load_nothing_of_the_port():
    import subprocess
    import sys
    from portbench.spec import ROOT
    code = (
        "import json, sys, torch\n"
        "from portbench.spec import PACKAGE, load_prior\n"
        "cfg = json.loads((PACKAGE / 'configs' / 'dt4ir-csmri-f32.json')"
        ".read_text())\n"
        "prior = load_prior(cfg['prior'])\n"
        "sd = prior.state_dict(cfg, torch.Generator().manual_seed(0), 'cpu')\n"
        "out = prior.reference(sd, torch.rand(2, 1, 16, 16),"
        " torch.full((2,), 0.1), 'float32')\n"
        "assert out.shape == (2, 1, 16, 16) and prior.flops(cfg) > 0\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "portbench" in loaded and "torch" in loaded
    assert not loaded & ({PORT} | JAX)
