"""The readers of the program's own spans (``portbench/spans.py``) on
hand-built profiler events: nesting, self time, idle time inside the
loop's iterations, and None where there is nothing to read."""
import pytest

from portbench import readers, spans, spec, trace
from portbench.drive import Run

DEVICE = (0, 7)

NEW = {"evaluator.syncs_per_step", "evaluator.issue_ms_per_step",
       "env.issue_ms_per_step", "models.unet_issue_ms",
       "evaluator.policy_issue_ms_per_step",
       "device.idle_share_in_steps.b1", "device.idle_share_in_steps.eval",
       "device.idle_share_in_steps.bf16"}
B63 = {"device.idle_share_in_steps.eval", "device.idle_share_in_steps.bf16"}


def X(name, cat, ts, dur, thread=(1, 10)):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": thread[0], "tid": thread[1]}


def U(name, ts, dur):
    return X(name, "user_annotation", ts, dur)


def R(name, ts, dur):
    return X(name, "cuda_runtime", ts, dur)


def events():
    """A 1,000 us window holding two loop iterations, 10-400 and 450-900.
    Each: a sync span around a cudaStreamSynchronize, an ADMM span around a
    U-Net span, a policy span. The second also holds a hidden
    cudaDeviceSynchronize (no sync span), and a cudaStreamSynchronize
    falls outside both. The device runs at 0-50, 300-480 and 600-950."""
    return [
        U(trace.WINDOW_SPAN, 0, 1000),
        U(spans.STEP, 10, 390),
        U(spans.SYNC, 20, 40), R("cudaStreamSynchronize", 30, 25),
        U(spans.ADMM, 70, 230), U(trace.UNET_SPAN, 95, 160),
        U(spans.UNET, 100, 150),
        U(spans.POLICY, 310, 80),
        U(spans.STEP, 450, 450),
        U(spans.SYNC, 460, 40), R("cudaStreamSynchronize", 470, 25),
        U(spans.ADMM, 510, 190), U(spans.UNET, 520, 130),
        U(spans.POLICY, 710, 140),
        R("cudaDeviceSynchronize", 860, 20),
        R("cudaStreamSynchronize", 950, 10),
        X("k_a", "kernel", 0, 50, DEVICE),
        X("k_b", "kernel", 300, 180, DEVICE),
        X("k_c", "kernel", 600, 350, DEVICE),
    ]


def run_of(evs):
    return Run(kind="eval_closed", config={}, traffic={},
               trace=trace.read_events(evs))


def test_syncs_are_every_wait_inside_the_iterations_over_admm_steps():
    # 30-55, 470-495 and the hidden 860-880; not 950-960.
    assert spans.syncs_per_step(run_of(events())) == pytest.approx(1.5)


def test_issue_time_is_the_iterations_less_their_waits():
    # 390 + 450 us less the sync spans (40 + 40) and the hidden 20.
    assert spans.issue_ms_per_step(run_of(events())) == \
        pytest.approx(0.370)


def test_env_self_time_leaves_out_the_unet_children():
    # ADMM 230 + 190 us, U-Net 150 + 130 inside: 140 over 2 steps.
    assert spans.env_issue_ms_per_step(run_of(events())) == \
        pytest.approx(0.070)


def test_unet_and_policy_lengths():
    run = run_of(events())
    assert spans.unet_issue_ms(run) == pytest.approx(0.140)
    assert spans.policy_issue_ms_per_step(run) == pytest.approx(0.110)


def test_the_children_fit_inside_the_iterations():
    run = run_of(events())
    parts = (spans.env_issue_ms_per_step(run) + spans.unet_issue_ms(run)
             + spans.policy_issue_ms_per_step(run))
    assert spans.issue_ms_per_step(run) >= parts


def test_idle_in_steps_is_the_device_gaps_inside_the_iterations():
    run = run_of(events())
    # Gaps 50-300, 480-600, 950-1000; inside the iterations 250 + 120.
    assert spans.idle_in_steps_pct(run) == pytest.approx(37.0)
    assert readers.idle_pct(run) == pytest.approx(42.0)


def test_covered_merges_overlaps_on_both_sides():
    xs = [(0, 4), (2, 6), (10, 12)]
    cover = [(1, 3), (3, 5), (11, 20)]
    # Union of xs: 0-6, 10-12; of cover: 1-5, 11-20; inside: 4 + 1.
    assert spans.covered_s(xs, cover) == pytest.approx(5.0)
    assert spans.covered_s(xs, []) == 0.0


def test_within_keeps_what_lies_inside_a_parent():
    parents = [(0, 10), (20, 30)]
    got = spans.within([(1, 2), (9, 11), (15, 16), (25, 30), (31, 32)],
                       parents)
    assert got == [(1, 2), (25, 30)]


READERS = [spans.syncs_per_step, spans.issue_ms_per_step,
           spans.env_issue_ms_per_step, spans.unet_issue_ms,
           spans.policy_issue_ms_per_step, spans.idle_in_steps_pct]


@pytest.mark.parametrize("read", READERS, ids=lambda f: f.__name__)
def test_none_without_a_trace_spans_or_device(read):
    assert read(Run(kind="eval_closed", config={}, traffic={})) is None
    # A program without the spans (the harness's own spans only).
    bare = [e for e in events() if not e["name"].startswith("dt4ir.")]
    assert read(run_of(bare)) is None
    # A run on the CPU: spans, but no device op.
    host_only = [e for e in events() if e["cat"] != "kernel"]
    assert read(run_of(host_only)) is None


@pytest.mark.parametrize("name", sorted(NEW))
def test_each_metric_file_reads_the_spans(name):
    read = spec.load_reader(name)
    assert read(run_of(events())) is not None
    assert read(Run(kind="eval_closed", config={}, traffic={})) is None


@pytest.mark.parametrize("cell,want", [
    ("eval_b1_f32", NEW - B63),
    ("eval_b63_f32", {"device.idle_share_in_steps.eval"}),
    ("eval_b63_bf16", {"device.idle_share_in_steps.bf16"}),
    ("serve_policy_f32", set())])
def test_the_cells_report_their_span_metrics(cell, want):
    names = {m.name for m in spec.load_cell(cell).per_layer}
    assert names & NEW == want


def test_the_names_are_the_programs():
    from dt4image_restoration_tpu_torch.utils import profiling
    assert (spans.STEP, spans.SYNC, spans.ADMM, spans.UNET, spans.POLICY) \
        == (profiling.EVAL_STEP, profiling.EVAL_SYNC, profiling.ENV_ADMM,
            profiling.UNET, profiling.POLICY_STEP)
