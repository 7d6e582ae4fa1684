"""On the card: the control (the reference in the configuration's
``control_precision``, put in the port's place) fails the cell's limits
while the port passes them, at the cell's own size over a short window;
and one answer altered among 63 fails the bfloat16 cell.

    python -m pytest -m cuda -p no:cacheprovider portbench/tests
"""
import json
import time

import pytest

from portbench import correct
from portbench.run import execute
from portbench.spec import load_cell

pytestmark = pytest.mark.cuda

# A window that finishes and compares as many answers as a run does.
SECONDS = {"eval_b63_f32": 1.0, "eval_b63_bf16": 1.0, "eval_b1_f32": 8.0,
           "serve_policy_f32": 4.0}


@pytest.mark.parametrize("name", sorted(SECONDS))
def test_the_control_fails_where_the_port_passes(name, card):
    cell = load_cell(name)
    res = execute(cell, 77, SECONDS[name], False, card, time.perf_counter(),
                  control=cell.config["control_precision"])
    assert res["correct"], res["checks"]
    ok, checks = correct.judge(res["_control_numbers"], cell.limits)
    assert not ok, checks


@pytest.mark.parametrize("seed", [3800000001, 3800000002, 3800000003,
                                  3100000016])
def test_one_altered_answer_of_63_fails_in_bfloat16(seed, card, monkeypatch):
    """One answer of a 63-slice call shifted by 0.25 where it is produced,
    in a window of that one call, all 63 answers compared: the per-answer
    ratio fails, where the RMS pooled over the 63 would dilute it."""
    from portbench.tests.test_bench_faults import altered_answer
    cell = load_cell("eval_b63_bf16")
    altered_answer(monkeypatch)
    res = execute(cell, seed, 0.01, False, card, time.perf_counter())
    numbers = res["_numbers"]
    print(json.dumps({"seed": seed, "attempted": res["attempted"],
                      "numbers": numbers}))
    assert res["attempted"] == 63 and not res["correct"]
    limit = cell.limits["image_rms_ratio_max"]["limit"]
    assert numbers["image_rms_ratio_max"] > limit, res["checks"]
