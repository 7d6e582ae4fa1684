"""On the card: the control (the reference in the configuration's
``control_precision``, put in the port's place) fails the cell's limits
while the port passes them, at the cell's own size over a short window.

    python -m pytest -m cuda -p no:cacheprovider portbench/tests
"""
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
