"""``correct`` comes out false when the timed path is broken underneath:
the harness's look for a card is skipped, and a whole run drives the port
on the CPU at a tiny size with one fault planted where the port computes.
(The cells run on one card: there is no exchange between chips to leave
out.)"""
import time

import pytest
import torch

import dt4image_restoration_tpu_torch.inference.evaluator as evaluator
import dt4image_restoration_tpu_torch.serving as serving
from portbench.run import execute


def unchanged_step(monkeypatch):
    """Every ADMM step returns its state unchanged."""
    monkeypatch.setattr(evaluator, "admm_step",
                        lambda denoise, state, action, **kw: state)


def _wrap_rollout(monkeypatch, edit):
    real = evaluator.greedy_rollout

    def rollout(*args, **kw):
        final, reward, ep_len, bufs = real(*args, **kw)
        return (*edit(final, reward, ep_len), bufs)
    monkeypatch.setattr(evaluator, "greedy_rollout", rollout)
    monkeypatch.setattr(serving, "greedy_rollout", rollout)


def half_batch(monkeypatch):
    """The second half of a batch is left out: its rows carry the first
    half's results."""
    def edit(final, reward, ep_len):
        h = (final.batch + 1) // 2
        rows = torch.arange(final.batch) % h
        final = final.replace(x=final.x[rows])
        return final, reward[rows], ep_len[rows]
    _wrap_rollout(monkeypatch, edit)


def altered_answer(monkeypatch):
    """One answer is altered where it is produced: row 0's image."""
    def edit(final, reward, ep_len):
        x = final.x.clone()
        x[0] += 0.25
        return final.replace(x=x), reward, ep_len
    _wrap_rollout(monkeypatch, edit)


@pytest.mark.parametrize("fault", [None, unchanged_step, half_batch,
                                   altered_answer],
                         ids=["sound", "unchanged_step", "half_batch",
                              "altered_answer"])
@pytest.mark.parametrize("name", ["eval_b63_f32", "serve_policy_f32",
                                  "eval_b63_bf16"])
def test_a_fault_makes_the_run_incorrect(name, fault, tiny_cell,
                                         monkeypatch):
    cell = tiny_cell(name)
    cell.traffic["check_sample"] = 64      # every answer of the window
    if fault is not None:
        fault(monkeypatch)
    res = execute(cell, 4242, 0.1, False, "cpu", time.perf_counter())
    assert res["correct"] is (fault is None), res["checks"]
