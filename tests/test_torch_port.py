"""Package-level properties of the PyTorch port: it imports nothing of JAX
or of the JAX package, its entry points refuse to fall back to the CPU, and
its command line evaluates .mat directories."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_port_common import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PORT_MODULES = [
    "dt4image_restoration_tpu_torch",
    "dt4image_restoration_tpu_torch.__main__",
    "dt4image_restoration_tpu_torch.config",
    "dt4image_restoration_tpu_torch.data",
    "dt4image_restoration_tpu_torch.env",
    "dt4image_restoration_tpu_torch.inference",
    "dt4image_restoration_tpu_torch.models",
    "dt4image_restoration_tpu_torch.ops",
    "dt4image_restoration_tpu_torch.ops.kernels",
    "dt4image_restoration_tpu_torch.ops.kernels._build",
    "dt4image_restoration_tpu_torch.utils.convert",
    "dt4image_restoration_tpu_torch.utils.loaders",
]


def _run(code_or_args, cwd=REPO, timeout=300):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = "1"   # see torch_port_common.one_torch_thread
    return subprocess.run([sys.executable, *code_or_args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_port_imports_no_jax():
    """Importing every port module pulls in no JAX and builds no kernel."""
    code = (
        "import importlib, sys\n"
        f"for m in {PORT_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'dt4image_restoration_tpu'))\n"
        "assert not bad, bad\n"
        "from dt4image_restoration_tpu_torch.ops.kernels import _build\n"
        "assert not _build._libs, 'a kernel was built at import'\n"
        "print('ok')\n")
    r = _run(["-c", code])
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


@pytest.mark.parametrize("entry", ["reset", "loader", "evaluator", "env"])
def test_entry_points_refuse_missing_cuda(monkeypatch, tmp_path, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from dt4image_restoration_tpu_torch.config import ModelConfig
    from dt4image_restoration_tpu_torch.data import make_mat_record
    from dt4image_restoration_tpu_torch.env import PnPEnv, reset_from_mat
    from dt4image_restoration_tpu_torch.inference import Evaluator
    from dt4image_restoration_tpu_torch.models import (DecisionTransformer,
                                                       UNetDenoiser)
    from dt4image_restoration_tpu_torch.utils.loaders import load_denoiser
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        if entry == "reset":
            reset_from_mat(make_mat_record(size=16))
        elif entry == "loader":
            load_denoiser(str(tmp_path / "missing.pt"))
        elif entry == "evaluator":
            cfg = ModelConfig(embed_dim=32, n_blocks=1, image_size=48)
            Evaluator(dt=DecisionTransformer(cfg), denoise=UNetDenoiser(8),
                      cfg=cfg)
        else:
            PnPEnv(UNetDenoiser(8)).reset(make_mat_record(size=16))


def test_cli_eval_on_cpu(tmp_path):
    from dt4image_restoration_tpu_torch.data import write_eval_dir
    d = write_eval_dir(str(tmp_path / "4_10"), "4_10", n=1, size=128)
    r = _run(["-m", "dt4image_restoration_tpu_torch", "--block_size", "18",
              "--device", "cpu", "eval", "--rtg", "10", "--max_timesteps",
              "6", "--checkpoint", str(tmp_path / "none.pt"),
              "--denoiser_ckpt", str(tmp_path / "none.pt"),
              "--data_dirs", d, str(tmp_path / "missing")], cwd=tmp_path)
    assert r.returncode == 0, r.stderr
    assert "random weights" in r.stderr
    assert "skipping missing/empty eval directory" in r.stderr
    lines = dict(ln.rsplit(",", 1) for ln in r.stdout.splitlines()
                 if "," in ln)
    assert 1 <= float(lines["Average iter"]) <= 6
    assert np.isfinite(float(lines["Average reward"]))


def test_cli_flex_on_cpu(tmp_path):
    """flex evaluates every RTG target of the flexible experiment and ends
    with the reference's total line."""
    from dt4image_restoration_tpu_torch.data import write_eval_dir
    d = write_eval_dir(str(tmp_path / "8_5"), "8_5", n=1, size=128)
    r = _run(["-m", "dt4image_restoration_tpu_torch", "--block_size", "18",
              "--n_embeds", "6", "--device", "cpu", "flex",
              "--max_timesteps", "6", "--checkpoint", str(tmp_path / "n.pt"),
              "--denoiser_ckpt", str(tmp_path / "n.pt"), "--data_dirs", d],
             cwd=tmp_path)
    assert r.returncode == 0, r.stderr
    out = r.stdout.splitlines()
    assert sum(ln.startswith("Test for reward increment") for ln in out) == 5
    assert sum(ln.startswith("Average increment") for ln in out) == 5
    assert np.isfinite(float(out[-1].split(":", 1)[1])), out[-1]
    assert out[-1].startswith("Total MCTS reward:")
