"""The port's multi-process inference: two Gloo ranks spawned as in
test_torch_train.py's data-parallel test, each with a mesh of 2 CPU shards
(a data axis of 4), against one process (tests/test_multihost.py and
tests/test_cli_multihost.py of the JAX package). One pair of ranks runs
every check in turn (tests/torch_mesh_worker.py:rank_main), so that the
file starts two processes once.

  * ``Evaluator.run`` on 5 records (wrap-padded to 8, 4 per rank) prints
    the one-process aggregates on both ranks;
  * ``evaluate_records(return_global=True)`` returns the 8 gathered rows;
  * ``DeviceMCTS.run_global_batches`` returns the one-process rewards;
  * a detailed ``DeviceMCTS.run_batch`` returns each rank's own rows
    without gathering them;
  * unequal local counts raise the ``local_output_offset`` error on both
    ranks, and the host-tree search refuses to span processes;
  * the ``eval`` and ``mcts`` verbs run under the ``torchrun`` environment
    (``WORLD_SIZE``, ``RANK``, ``MASTER_*``) with ``--device cpu``, one CPU
    shard a rank, and print the one-process output on both ranks.

Bands: rewards within rtol/atol 1e-4 of one process, episode lengths
equal; the two ranks print the same text."""
import re
import socket

import numpy as np
import pytest
import torch

from dt4image_restoration_tpu_torch.config import MCTSConfig
from dt4image_restoration_tpu_torch.data import write_eval_dir
from dt4image_restoration_tpu_torch.inference import DeviceMCTS, Evaluator
from dt4image_restoration_tpu_torch.models import proxy_value_fn
from torch_mesh_worker import (MAXT, SIZE, cli_run, policy, rank_main,
                               records, stub_denoise, wrap_pad)
from torch_port_common import one_torch_thread  # noqa: F401

JOIN_S = 240


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("localhost", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _numbers(text):
    return [float(x) for x in re.findall(
        r"(?:Average iter|Average reward|PSNR increment|MCTS Reward|"
        r"Total MCTS reward)[,: ]+(-?[\d.e+-]+)", text)]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Spawn the two ranks once; returns (rank results, eval dirs, the
    command lines they ran)."""
    root = tmp_path_factory.mktemp("multiprocess")
    dirs = [write_eval_dir(str(root / tok), tok, n=n, size=SIZE,
                           seed=10 * i)
            for i, (tok, n) in enumerate((("4_15", 3), ("8_5", 2)))]
    cli_dir = write_eval_dir(str(root / "cli" / "4_15"), "4_15", n=2,
                             size=128)
    none = str(root / "none.pt")
    common = ["--block_size", "18", "--n_embeds", "9", "--device", "cpu"]
    paths = ["--max_timesteps", "6", "--checkpoint", none,
             "--denoiser_ckpt", none, "--data_dirs", cli_dir]
    jobs = [(common + ["eval", "--rtg", "10"] + paths, None),
            (common + ["mcts", "--rtg", "5", "--search_batch", "2"]
             + paths, 2)]
    out_path = str(root / "rank")
    ports = _free_ports(1 + len(jobs))
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=rank_main,
                         args=(r, 2, ports, dirs, jobs, out_path))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=JOIN_S)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join(5)
    assert not alive, f"a rank did not finish within {JOIN_S} s"
    assert [p.exitcode for p in procs] == [0, 0]
    ranks = [torch.load(f"{out_path}.{r}", weights_only=False)
             for r in range(2)]
    return ranks, dirs, jobs


def test_mesh_spans_both_ranks(run):
    ranks, _, _ = run
    assert [r["api"]["shape"] for r in ranks] \
        == [{"data": 4, "model": 1}] * 2


def test_evaluator_run_prints_one_process_aggregates(run, capsys):
    ranks, dirs, _ = run
    dt = policy()
    ev = Evaluator(dt=dt, denoise=stub_denoise, cfg=dt.cfg,
                   max_timesteps=MAXT, device="cpu")
    total = ev.run(dirs)
    want = _numbers(capsys.readouterr().out)
    assert len(want) == 6
    assert ranks[0]["api"]["run_printed"] == ranks[1]["api"]["run_printed"]
    for r in ranks:
        api = r["api"]
        np.testing.assert_allclose(_numbers(api["run_printed"]), want,
                                   rtol=1e-4, atol=1e-4)
        assert api["run_total"] == pytest.approx(total, rel=1e-4, abs=1e-4)
        assert api["run_metrics"]["reward"].shape == (5,)
        # Each rank evaluated its own 4 of the 8 wrap-padded records.
        assert api["run_local_counts"] == [4]
        np.testing.assert_array_equal(api["run_metrics"]["episode_len"],
                                      ev.last_metrics["episode_len"])


def test_evaluate_records_returns_the_global_batch(run):
    ranks, _, _ = run
    dt = policy()
    want = Evaluator(dt=dt, denoise=stub_denoise, cfg=dt.cfg,
                     max_timesteps=MAXT, device="cpu").evaluate_records(
        wrap_pad(records(5), 8))
    for r in ranks:
        got = r["api"]["global"]
        assert got["reward"].shape == (8,)
        np.testing.assert_allclose(got["reward"], want["reward"],
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(got["episode_len"],
                                      want["episode_len"])


def test_run_global_batches_matches_one_process(run):
    ranks, _, _ = run
    dt = policy()
    want = DeviceMCTS(dt=dt, denoise=stub_denoise, model_cfg=dt.cfg,
                      cfg=MCTSConfig(iterations=3, max_timesteps=MAXT),
                      value_fn=proxy_value_fn, device="cpu").run_batch(
        records(5), seeds=list(range(5)), verbose=False)
    for r in ranks:
        np.testing.assert_allclose(r["api"]["search"], want, rtol=1e-4,
                                   atol=1e-4)


def test_detailed_search_returns_each_ranks_own_rows(run):
    """A detailed search on each rank returns that rank's rows of the
    one-process search (reward, image, episode length) from its own
    shards, without gathering the images over the processes."""
    ranks, _, _ = run
    dt = policy()
    want = DeviceMCTS(dt=dt, denoise=stub_denoise, model_cfg=dt.cfg,
                      cfg=MCTSConfig(iterations=3, max_timesteps=MAXT),
                      value_fn=proxy_value_fn, device="cpu").run_batch(
        records(4), seeds=list(range(4)), detailed=True, verbose=False)
    for rank, r in enumerate(ranks):
        got = r["api"]["detailed"]
        assert r["api"]["detailed_gathers"] == []
        assert len(got) == 2
        for g, w in zip(got, want[2 * rank:2 * rank + 2]):
            assert g["reward"] == pytest.approx(w["reward"], rel=1e-4,
                                                abs=1e-4)
            np.testing.assert_allclose(g["image"], w["image"], rtol=1e-4,
                                       atol=1e-4)
            assert g["episode_len"] == w["episode_len"]


def test_unequal_local_counts_raise_on_every_rank(run):
    ranks, _, _ = run
    for r in ranks:
        assert "needs equal per-process record counts; got [2, 4]" \
            in r["api"]["offset_error"]


def test_host_search_refuses_several_processes(run):
    ranks, _, _ = run
    for r in ranks:
        assert "cannot span processes" in r["api"]["host_error"]


@pytest.mark.parametrize("job", [0, 1], ids=["eval", "mcts"])
def test_cli_two_ranks_print_one_process_output(run, job):
    ranks, _, jobs = run
    argv, iterations = jobs[job]
    want, counts = cli_run(argv, iterations)
    labels = ("Average iter", "Average reward", "PSNR increment") \
        if job == 0 else ("MCTS Reward", "MCTS Reward", "Total MCTS reward")
    assert len(_numbers(want)) == 3
    assert all(label in want for label in labels)
    # One process runs both records; each rank runs its own one.
    assert counts == [2]
    assert [r["cli"][job][1] for r in ranks] == [[1], [1]]
    assert ranks[0]["cli"][job][0] == ranks[1]["cli"][job][0]
    np.testing.assert_allclose(_numbers(ranks[0]["cli"][job][0]),
                               _numbers(want), rtol=1e-4, atol=1e-4)
