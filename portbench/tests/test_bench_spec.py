"""BENCHMARK.json against the benchmark's contract, and the harness as
data: every part of a cell is a file found by name."""
import json
import re
import shutil

import pytest

from portbench.spec import PACKAGE, ROOT, load_cell

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "-m", "portbench"]
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # A full check of 24 cells fits its 43,200 s.
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_lines():
    entries = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] \
        + BENCH["per_layer"]
    for e in entries:
        assert NAME.fullmatch(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] \
                    and "\t" not in e[key]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower",
                                                             "higher")
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))


def test_entries_have_just_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        assert (ROOT / c["file"]).exists()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if "roofline" in m["name"]:
            assert m["unit"] == "%"
            assert m["name"].split(".")[0].endswith("_roofline")


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_loads_and_reports_enough(cell):
    c = load_cell(cell)
    e2e = [m.name for m in c.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in BENCH["per_layer"]:
        if cell in m.get("workloads", []):
            assert m["moves"] in e2e, (m["name"], cell)
    assert c.traffic["kind"] in ("eval_closed", "serve_open")
    # Images, rewards and episode lengths are compared, each limit
    # between the readings it was set from.
    assert set(c.limits) == {"episode_len_mismatches", "psnr_mean_gap_db",
                             "image_gap"}
    for name, lim in c.limits.items():
        if "lower" in lim:
            assert lim["lower"] < lim["limit"] < lim["upper"], name
            assert lim["upper"] >= 3 * lim["lower"], name


def test_every_config_is_used_and_every_metric_has_a_reader():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (PACKAGE / "metrics" / f"{m['name']}.py").exists()


def test_a_new_file_and_entry_make_a_new_cell(tmp_path):
    """A later change adds a traffic file, a limits file and an entry: the
    cell loads with no file of the harness edited."""
    pkg = tmp_path / "portbench"
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(PACKAGE / sub, pkg / sub)
    burst = json.loads((PACKAGE / "traffic" /
                        "open_poisson_policy.json").read_text())
    burst["rate"] = 12.0
    (pkg / "traffic" / "open_poisson_slow.json").write_text(
        json.dumps(burst))
    shutil.copy(PACKAGE / "limits" / "serve_policy_f32.json",
                pkg / "limits" / "serve_slow_f32.json")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "serve_slow_f32",
                               "config": "dt4ir-csmri-f32",
                               "traffic": "open_poisson_slow", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "serve_policy_f32" in m.get("workloads", []):
            m["workloads"].append("serve_slow_f32")
    cell = load_cell("serve_slow_f32", root=tmp_path, package=pkg,
                     bench=bench)
    assert cell.traffic["rate"] == 12.0
    assert [m.name for m in cell.end_to_end] == ["latency_p95_ms", "setup_s"]
    assert {m.name for m in cell.per_layer} == {"serve.padded_share",
                                                "serve.device_ms_per_batch"}


def test_an_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        load_cell("no_such_cell")
