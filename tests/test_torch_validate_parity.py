"""The port's parity harness (``tools/validate_parity.py``) and its copy of
the reference oracle (``utils/torch_oracle.py``, ``utils/torch_reference.py``)
against the JAX package's, on the CPU.

  * The two oracles are held bit for bit: the same fixture tensors, the
    same greedy episodes, the same tree search.
  * The port's ``--selftest`` passes at a small depth (2 slices, 8
    timesteps, 2 search iterations, flex RTG 3) with rows for every mode.
  * The slice as a whole: the JAX harness on the fixture files the port's
    selftest writes (``write_selftest_fixtures``, deterministic from its
    seeds) gives the same oracle dB in every row, and the port's dB lies
    within 0.05 dB of JAX's: the rollout band of ``tests/test_torch_eval.py``
    (``PARITY.md``).
  * A port that diverges fails, and missing arguments are refused.
"""
import contextlib
import io
import json

import numpy as np
import pytest
import torch
from scipy.io import loadmat

import tools.validate_parity as jax_vp
from dt4image_restoration_tpu.data.synthetic import (
    make_mat_record as j_make_mat_record)
from dt4image_restoration_tpu.utils import torch_oracle as j_oracle
from dt4image_restoration_tpu.utils import torch_reference as j_reference
from dt4image_restoration_tpu_torch.data.synthetic import make_mat_record
from dt4image_restoration_tpu_torch.models.arniqa import proxy_value_fn
from dt4image_restoration_tpu_torch.tools import validate_parity as port_vp
from dt4image_restoration_tpu_torch.utils import torch_oracle as oracle
from dt4image_restoration_tpu_torch.utils import torch_reference as reference
from torch_port_common import one_torch_thread  # noqa: F401

SMALL = ["--limit", "2", "--max_timesteps", "8", "--iterations", "2",
         "--flex_rtgs", "3"]
ROLLOUT_DB = 0.05      # the rollout band (tests/test_torch_eval.py)


def _assert_same_tensors(a, b):
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def _dt_sd(module, mode):
    """The selftest's DT of ``mode`` from ``module``'s oracle."""
    seed, n_embeds, stop = (0, 9, 0) if mode == "norm" else (1, 6, 2)
    sd = module.make_dt_state_dict(torch.Generator().manual_seed(seed),
                                   n_embeds=n_embeds)
    sd["predict_action.0.bias"][stop] -= 0.5
    return sd


# --- (a) the port's oracle is the JAX package's, bit for bit ---------------

@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("n_embeds", [9, 6])
def test_dt_state_dict_equals_jax_oracle(seed, n_embeds):
    _assert_same_tensors(
        oracle.make_dt_state_dict(torch.Generator().manual_seed(seed),
                                  n_embeds=n_embeds),
        j_oracle.make_dt_state_dict(torch.Generator().manual_seed(seed),
                                    n_embeds=n_embeds))


@pytest.mark.parametrize("seed", [0, 1])
def test_unet_state_dict_equals_jax_reference(seed):
    _assert_same_tensors(reference.random_unet_state_dict(seed),
                         j_reference.random_unet_state_dict(seed))


def test_mat_record_equals_jax():
    a, b = make_mat_record(seed=0), j_make_mat_record(seed=0)
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])


def test_admm_rollout_equals_jax_reference():
    sd = reference.random_unet_state_dict(0)
    mat = make_mat_record(seed=0)
    x, psnr = reference.torch_admm_rollout(sd, mat, 0.5, 15 / 255, 2)
    jx, jpsnr = j_reference.torch_admm_rollout(sd, mat, 0.5, 15 / 255, 2)
    np.testing.assert_array_equal(x, jx)
    assert psnr == jpsnr


@pytest.mark.parametrize("mode", ["norm", "flex"])
def test_eval_episode_equals_jax_oracle(mode):
    dt_sd, unet_sd = _dt_sd(oracle, mode), reference.random_unet_state_dict(0)
    mat = make_mat_record(seed=0)
    x, t = oracle.torch_eval_episode(dt_sd, unet_sd, mat, 0.5, 2,
                                     max_timesteps=6, mode=mode)
    jx, jt = j_oracle.torch_eval_episode(dt_sd, unet_sd, mat, 0.5, 2,
                                         max_timesteps=6, mode=mode)
    assert t == jt
    np.testing.assert_array_equal(x, jx)
    assert oracle.torch_psnr(x, mat["gt"]) == j_oracle.torch_psnr(
        jx, mat["gt"])


def test_run_mcts_equals_jax_oracle():
    dt_sd, unet_sd = _dt_sd(oracle, "norm"), \
        reference.random_unet_state_dict(0)
    mat = make_mat_record(seed=0)
    kw = dict(seed=3, iterations=2, max_timesteps=6,
              value_fn=proxy_value_fn)
    reward, trace = oracle.torch_run_mcts(dt_sd, unet_sd, mat, 0.5, 2, **kw)
    j_reward, j_trace = j_oracle.torch_run_mcts(dt_sd, unet_sd, mat, 0.5, 2,
                                                **kw)
    assert len(trace) == 2
    assert trace == j_trace
    assert reward == j_reward


# --- (b) the port's selftest ------------------------------------------------

@pytest.fixture(scope="module")
def selftest(tmp_path_factory):
    """The port's ``--selftest`` on the CPU at the small depth: (exit code,
    printed table, JSON report)."""
    path = tmp_path_factory.mktemp("selftest") / "report.json"
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = port_vp.main(["--selftest", "--device", "cpu", *SMALL,
                           "--json_out", str(path)])
    return rc, out.getvalue(), json.loads(path.read_text())


def test_selftest_passes_on_cpu(selftest):
    rc, out, report = selftest
    assert "Overall: PASS" in out, out
    assert rc == 0
    assert [r["mode"] for r in report["rows"]] == ["norm", "flex(rtg=3.0)",
                                                   "mcts"]
    assert report["ok"] and report["device"] == "cpu"
    for r in report["rows"]:
        assert {"oracle_db", "port_db", "delta_db", "pass"} <= set(r)
        assert r["n"] == 2 and r["pass"]


# --- (c) the slice as a whole against the JAX harness -----------------------

@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    return port_vp.write_selftest_fixtures(
        str(tmp_path_factory.mktemp("fixtures")), 2)


def test_fixtures_are_the_jax_selftests(fixtures):
    """The files hold what the JAX harness's ``--selftest`` builds from the
    same seeds."""
    for name, mode in (("dt", "norm"), ("dt_flex", "flex")):
        _assert_same_tensors(torch.load(fixtures[name]),
                             _dt_sd(j_oracle, mode))
    _assert_same_tensors(torch.load(fixtures["unet"]),
                         j_reference.random_unet_state_dict(seed=0))
    for i in range(2):
        got = loadmat(f"{fixtures['dir']}/img_4_15_s{i}.mat")
        for k, v in j_make_mat_record(seed=i).items():
            np.testing.assert_array_equal(got[k], v)


def test_harness_rows_match_jax_harness(fixtures, selftest):
    args = jax_vp.build_parser().parse_args(SMALL)
    args.dt, args.dt_flex, args.unet = (fixtures["dt"], fixtures["dt_flex"],
                                        fixtures["unet"])
    args.dirs = [fixtures["dir"]]
    with contextlib.redirect_stdout(io.StringIO()):
        jax_rows = jax_vp.validate(args)["rows"]
    port_rows = selftest[2]["rows"]
    assert [r["mode"] for r in port_rows] == [r["mode"] for r in jax_rows]
    for p, j in zip(port_rows, jax_rows):
        assert p["n"] == j["n"]
        assert p["oracle_db"] == j["torch_db"], (p, j)
        assert abs(p["port_db"] - j["jax_db"]) <= ROLLOUT_DB, (p, j)


# --- (d) a diverging port fails ---------------------------------------------

def test_perturbed_port_policy_fails(fixtures, monkeypatch, capsys):
    load = port_vp._load_checkpoints

    def perturbed(args, device):
        ckpts = load(args, device)
        with torch.no_grad():   # the port stops at once, the oracle not
            ckpts["dt"].predict_action.bias[0] += 10.0
        return ckpts

    monkeypatch.setattr(port_vp, "_load_checkpoints", perturbed)
    rc = port_vp.main(["--device", "cpu", "--dt", fixtures["dt"],
                       "--unet", fixtures["unet"], "--dirs", fixtures["dir"],
                       "--modes", "eval", "--limit", "1",
                       "--max_timesteps", "6"])
    out = capsys.readouterr().out
    assert rc == 1
    assert "Overall: FAIL" in out, out


# --- (e) missing arguments --------------------------------------------------

@pytest.mark.parametrize("left_out", ["--dt", "--unet", "--dirs"])
def test_missing_arguments_are_refused(left_out, capsys):
    given = {"--dt": "dt.pt", "--unet": "unet.pt", "--dirs": "d"}
    argv = [a for k, v in given.items() if k != left_out for a in (k, v)]
    with pytest.raises(SystemExit) as e:
        port_vp.main(["--device", "cpu", *argv])
    assert e.value.code == 2
    assert left_out in capsys.readouterr().err
