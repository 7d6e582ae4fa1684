"""A whole run on the CPU at a tiny size: the result line's keys, and the
checks printed last."""
import json
import time

import pytest

from portbench.run import emit, execute

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("name,traced", [("eval_b63_f32", False),
                                         ("eval_b1_f32", True)])
def test_the_last_line_has_the_contracts_keys(name, traced, tiny_cell,
                                              capsys):
    cell = tiny_cell(name)
    res = execute(cell, 2 ** 31 + 17, 0.2, traced, "cpu", time.perf_counter())
    emit(res)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    want = KEYS + (["breakdown"] if traced else []) + ["checks"]
    assert list(line) == want
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= cell.traffic["batch"]
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    if traced:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert set(line["device"]) >= {"busy_s", "window_s"}
        # No device ran: only the host clock's per-layer metric reads.
        assert set(line["metrics"]) == {"evaluator.slice_p95_ms"}
    else:
        assert set(line["metrics"]) == {"slices_per_s", "setup_s"}
    checks = [ln for ln in err.strip().splitlines()][-len(line["checks"]):]
    assert [c.split(":")[0] for c in checks] == \
        [f"check {k}" for k in line["checks"]]
    for c in line["checks"].values():
        assert c["value"] <= c["limit"]


def test_the_same_seed_gives_the_same_inputs_and_answers(tiny_cell):
    cell = tiny_cell("eval_b1_f32")
    a, b = (execute(cell, 99, 0.2, False, "cpu", time.perf_counter())
            for _ in range(2))
    assert a["_numbers"] == b["_numbers"]
