"""Shared fixtures of the benchmark's tests.

CPU tests run the port's plain kernels at small sizes; tests marked
``cuda`` run on a card (``python -m pytest -m cuda portbench/tests``) and
skip without one, decided inside the ``card`` fixture."""
import pytest
import torch


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 4))
    yield
    torch.set_num_threads(before)


def tiny(name: str):
    """Cell ``name`` cut to a size the CPU runs in seconds: 2 tasks, 6
    steps, small pools and samples (the widths stay)."""
    from portbench.spec import load_cell
    cell = load_cell(name)
    cell.config.update(max_timesteps=6, tasks=cell.config["tasks"][:2])
    cell.traffic.update(pool_per_task=2, check_sample=4, check_block=4,
                        trace_calls=1, trace_requests=2, warmup_calls=1)
    if cell.traffic["kind"] == "eval_closed":
        cell.traffic["batch"] = min(cell.traffic["batch"], 2)
    else:
        cell.traffic.update(rate=40.0, warmup_batches=1, drain_s=120)
        # A fill window that holds the whole window's requests: on the
        # CPU a pipelined turn reads as no time, which leaves it at 10 ms.
        cell.traffic["service"] = dict(cell.traffic["service"],
                                       batch_size=4, max_delay_s=0.3)
    return cell


@pytest.fixture
def tiny_cell():
    return tiny
