"""Package-level properties of the PyTorch port: it imports nothing of JAX
or of the JAX package, its entry points refuse to fall back to the CPU, and
its command line evaluates and searches .mat directories, printing the JAX
command line's labels."""
import functools
import os
import re
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
    "dt4image_restoration_tpu_torch.bench",
    "dt4image_restoration_tpu_torch.config",
    "dt4image_restoration_tpu_torch.data",
    "dt4image_restoration_tpu_torch.data.expert",
    "dt4image_restoration_tpu_torch.env",
    "dt4image_restoration_tpu_torch.inference",
    "dt4image_restoration_tpu_torch.inference.mcts",
    "dt4image_restoration_tpu_torch.inference.mcts_device",
    "dt4image_restoration_tpu_torch.models",
    "dt4image_restoration_tpu_torch.models.arniqa",
    "dt4image_restoration_tpu_torch.ops",
    "dt4image_restoration_tpu_torch.ops.kernels",
    "dt4image_restoration_tpu_torch.ops.kernels._build",
    "dt4image_restoration_tpu_torch.serving",
    "dt4image_restoration_tpu_torch.tools",
    "dt4image_restoration_tpu_torch.tools.export_checkpoint",
    "dt4image_restoration_tpu_torch.tools.make_dataset",
    "dt4image_restoration_tpu_torch.tools.validate_parity",
    "dt4image_restoration_tpu_torch.utils.convert",
    "dt4image_restoration_tpu_torch.utils.loaders",
    "dt4image_restoration_tpu_torch.utils.torch_oracle",
    "dt4image_restoration_tpu_torch.utils.torch_reference",
]


# The labels of the lines the JAX command line prints (main.py cmd_flex and
# cmd_mcts, inference/evaluator.py Evaluator.run, inference/mcts.py
# MCTS.run_batch); print() puts a space between its arguments.
JAX_LABELS = {
    "flex": {"Test for reward increment: ", "Average iter,  ",
             "Average reward,  ", "PSNR increment  ", "Average increment: "},
    "mcts": {"MCTS Reward:  ", "Total MCTS reward: "},
}


def _labels(stdout):
    """The label of every non-blank output line: its text up to the first
    digit or minus sign."""
    return {re.split(r"[-\d]", ln, maxsplit=1)[0] for ln in
            stdout.splitlines() if ln.strip()}


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


@pytest.mark.parametrize("entry", ["reset", "loader", "evaluator", "env",
                                   "search", "arniqa", "device_search",
                                   "service", "record", "rollout_expert",
                                   "make_dataset", "validate_parity"])
def test_entry_points_refuse_missing_cuda(monkeypatch, tmp_path, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from dt4image_restoration_tpu_torch.config import MCTSConfig, ModelConfig
    from dt4image_restoration_tpu_torch.data import make_mat_record
    from dt4image_restoration_tpu_torch.env import PnPEnv, reset_from_mat
    from dt4image_restoration_tpu_torch.inference import (DeviceMCTS, MCTS,
                                                          Evaluator)
    from dt4image_restoration_tpu_torch.models import (DecisionTransformer,
                                                       UNetDenoiser,
                                                       proxy_value_fn)
    from dt4image_restoration_tpu_torch.utils.loaders import (load_arniqa,
                                                              load_denoiser)
    cfg = ModelConfig(embed_dim=32, n_blocks=1, image_size=48)
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        if entry == "reset":
            reset_from_mat(make_mat_record(size=16))
        elif entry == "loader":
            load_denoiser(str(tmp_path / "missing.pt"))
        elif entry == "evaluator":
            Evaluator(dt=DecisionTransformer(cfg), denoise=UNetDenoiser(8),
                      cfg=cfg)
        elif entry == "search":
            MCTS(dt=DecisionTransformer(cfg), denoise=UNetDenoiser(8),
                 model_cfg=cfg, cfg=MCTSConfig(), value_fn=proxy_value_fn)
        elif entry == "device_search":
            DeviceMCTS(dt=DecisionTransformer(cfg), denoise=UNetDenoiser(8),
                       model_cfg=cfg, cfg=MCTSConfig(),
                       value_fn=proxy_value_fn)
        elif entry == "service":
            from dt4image_restoration_tpu_torch.serving import (
                RestorationService)
            RestorationService(denoise=UNetDenoiser(8), mode="fixed")
        elif entry == "arniqa":
            load_arniqa(str(tmp_path / "missing.pt"))
        elif entry == "record":
            from dt4image_restoration_tpu_torch.data.expert import (
                record_expert_corpus)
            record_expert_corpus(str(tmp_path), lambda x, s: x, n_traj=1,
                                 ep_len=1, size=16)
        elif entry == "rollout_expert":
            from dt4image_restoration_tpu_torch.data.expert import (
                rollout_expert)
            rollout_expert(lambda s, a: s, make_mat_record(size=16), 1)
        elif entry == "make_dataset":
            from dt4image_restoration_tpu_torch.tools import make_dataset
            make_dataset.main(["--out", str(tmp_path / "synth"),
                               "--n_traj", "1"])
        elif entry == "validate_parity":
            from dt4image_restoration_tpu_torch.tools import validate_parity
            # Raises before a checkpoint is loaded or the oracle runs.
            validate_parity.main(["--selftest", "--device", "cuda"])
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


def test_cli_eval_block_size_36_on_cpu(tmp_path):
    """At --block_size 36 (36 tokens, past the fused kernel K3's 32) eval
    says on stderr that it runs the per-op forward and prints what it
    prints at 18; at 18 it says the fused one."""
    from dt4image_restoration_tpu_torch.data import write_eval_dir
    d = write_eval_dir(str(tmp_path / "4_10"), "4_10", n=1, size=128)
    outs = {}
    for block in ("36", "18"):
        r = _run(["-m", "dt4image_restoration_tpu_torch", "--block_size",
                  block, "--device", "cpu", "eval", "--rtg", "10",
                  "--max_timesteps", "12",
                  "--checkpoint", str(tmp_path / "none.pt"),
                  "--denoiser_ckpt", str(tmp_path / "none.pt"),
                  "--data_dirs", d], cwd=tmp_path)
        assert r.returncode == 0, r.stderr
        outs[block] = r
    forward = {b: [ln for ln in r.stderr.splitlines()
                   if ln.startswith("policy forward:")]
               for b, r in outs.items()}
    assert len(forward["36"]) == 1 and "per-op (kernels K4, K5)" \
        in forward["36"][0] and "36 tokens" in forward["36"][0]
    assert forward["18"] == ["policy forward: fused (kernel K3); dtype "
                             "float32, U-Net mode pallas"]
    lines = dict(ln.rsplit(",", 1) for ln in outs["36"].stdout.splitlines()
                 if "," in ln)
    assert 1 <= float(lines["Average iter"]) <= 12
    assert np.isfinite(float(lines["Average reward"]))
    assert _labels(outs["36"].stdout) == _labels(outs["18"].stdout)


def test_cli_flex_on_cpu(tmp_path):
    """flex evaluates every RTG target of the flexible experiment and, like
    the JAX command line, prints no search total."""
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
    assert np.isfinite(float(out[-2].split(":", 1)[1])), out[-2]
    assert out[-2].startswith("Average increment:")
    assert not any("MCTS" in ln for ln in out)
    assert _labels(r.stdout) == JAX_LABELS["flex"]


def _cli_mcts(tmp_path, monkeypatch, capsys, *flags, images=2):
    """Run the mcts verb in-process on ``images`` slices with the search
    cut to two rounds, which keeps the full-width models quick on the CPU;
    check its output and return the search class (and node dtype) of each
    run_batch call."""
    from dt4image_restoration_tpu_torch import __main__ as cli
    from dt4image_restoration_tpu_torch import config
    from dt4image_restoration_tpu_torch.data import write_eval_dir
    from dt4image_restoration_tpu_torch.inference import MCTS, DeviceMCTS
    d = write_eval_dir(str(tmp_path / "4_15"), "4_15", n=images, size=128)
    monkeypatch.setattr(config, "MCTSConfig",
                        functools.partial(config.MCTSConfig, iterations=2))
    ran = []
    for cls in (MCTS, DeviceMCTS):
        def run_batch(self, *a, _run=cls.run_batch, **kw):
            ran.append((type(self).__name__,
                        getattr(self, "node_dtype", None)))
            return _run(self, *a, **kw)
        monkeypatch.setattr(cls, "run_batch", run_batch)
    cli.main(["--block_size", "18", "--n_embeds", "9", "--device", "cpu",
              "mcts", "--rtg", "5", "--max_timesteps", "6",
              "--checkpoint", str(tmp_path / "n.pt"),
              "--denoiser_ckpt", str(tmp_path / "n.pt"), "--data_dirs", d,
              *flags])
    r = capsys.readouterr()
    assert "no ARNIQA checkpoint; using the documented no-ref proxy" \
        in r.err
    out = r.out.splitlines()
    per_image = [float(ln.split(":", 1)[1]) for ln in out
                 if ln.startswith("MCTS Reward: ")]
    assert len(per_image) == images
    assert all(0 < v < 60 for v in per_image)
    assert out[-1].startswith("Total MCTS reward:")
    assert float(out[-1].split(":", 1)[1]) == pytest.approx(sum(per_image))
    assert _labels(r.out) == JAX_LABELS["mcts"]
    return ran


def test_cli_mcts_on_cpu(tmp_path, monkeypatch, capsys):
    """mcts searches every image of the directory with the proxy scorer
    (no ARNIQA weights) and prints a reward per image and the total. As in
    the JAX command line, the search's tree lives on the device by
    default (DeviceMCTS, float32 nodes)."""
    ran = _cli_mcts(tmp_path, monkeypatch, capsys)
    assert ran == [("DeviceMCTS", "float32")]


@pytest.mark.parametrize("flags,want", [
    (("--tree_backend", "host"), ("BatchedMCTS", None)),
    (("--node_dtype", "bfloat16"), ("DeviceMCTS", "bfloat16")),
    (("--dtype", "bfloat16", "--unet_packed", "s2d"),
     ("DeviceMCTS", "float32")),
])
def test_cli_mcts_backends_on_cpu(tmp_path, monkeypatch, capsys, flags,
                                  want):
    """--tree_backend host runs the host-tree search; --node_dtype reaches
    the device search, and so do --dtype bfloat16 and --unet_packed."""
    assert _cli_mcts(tmp_path, monkeypatch, capsys, *flags,
                     images=1) == [want]


@pytest.mark.parametrize("flags,want", [
    ([], "cuda"), (["--platform", "default"], "cuda"),
    (["--platform", "cpu"], "cpu"), (["--device", "cpu"], "cpu"),
    (["--device", "cpu", "--platform", "cpu"], "cpu"),
    (["--device", "cuda:0", "--platform", "default"], "cuda:0"),
])
def test_platform_is_an_alias_of_device(flags, want):
    """--platform {default,cpu}, the JAX command line's flag, names the
    device as --device does; --help says which flag is the port's own."""
    from dt4image_restoration_tpu_torch import __main__ as cli
    parser = cli.build_parser()
    args = parser.parse_args(["--block_size", "18", *flags, "eval",
                              "--rtg", "10"])
    assert cli._device_flags(parser, args) == want
    assert "the port's own flag" in parser.format_help()


@pytest.mark.parametrize("flags", [["--device", "cpu", "--platform",
                                    "default"],
                                   ["--device", "cuda", "--platform", "cpu"]])
def test_conflicting_device_flags_are_refused(flags, capsys):
    from dt4image_restoration_tpu_torch import __main__ as cli
    with pytest.raises(SystemExit) as e:
        cli.main(["--block_size", "18", *flags, "eval", "--rtg", "10"])
    assert e.value.code == 2
    assert "name different devices" in capsys.readouterr().err


def test_cli_platform_cpu_runs_like_device_cpu(tmp_path, capsys):
    """eval with --platform cpu prints what it prints with --device cpu."""
    from dt4image_restoration_tpu_torch import __main__ as cli
    from dt4image_restoration_tpu_torch.data import write_eval_dir
    d = write_eval_dir(str(tmp_path / "4_10"), "4_10", n=1, size=128)
    outs = []
    for flag in ("--platform", "--device"):
        cli.main(["--block_size", "18", flag, "cpu", "eval", "--rtg", "10",
                  "--max_timesteps", "6",
                  "--checkpoint", str(tmp_path / "none.pt"),
                  "--denoiser_ckpt", str(tmp_path / "none.pt"),
                  "--data_dirs", d])
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and "Average reward" in outs[0]
