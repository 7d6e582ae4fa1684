"""The trace arithmetic on synthetic profiler events."""
import numpy as np
import pytest

from portbench import counts, readers, spec, trace
from portbench.drive import Run

MAIN, OTHER = (1, 10), (1, 11)


def X(name, cat, ts, dur, thread=MAIN, **args):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
         "pid": thread[0], "tid": thread[1]}
    if args:
        e["args"] = args
    return e


def events():
    """A 1,000 us window: two U-Net spans on the main thread whose launches
    (correlations 1, 2) run kernels at 100-300 and 250-400 us (they
    overlap), a kernel launched outside the spans (3) at 600-700, a copy
    at 690-750 and a kernel on another thread's launch (4) at 800-900
    whose launch time falls inside a span of the main thread."""
    return [
        X(trace.WINDOW_SPAN, "user_annotation", 0, 1000),
        X(trace.UNET_SPAN, "user_annotation", 10, 100),
        X(trace.UNET_SPAN, "user_annotation", 150, 100),
        X("cudaLaunchKernel", "cuda_runtime", 20, 5, correlation=1),
        X("cudaLaunchKernel", "cuda_runtime", 160, 5, correlation=2),
        X("cudaLaunchKernel", "cuda_runtime", 400, 5, correlation=3),
        X("cudaLaunchKernel", "cuda_runtime", 165, 5, OTHER, correlation=4),
        X("aten::conv", "cpu_op", 400, 400),
        X("aten::copy_", "cpu_op", 500, 100),
        X("k_conv", "kernel", 100, 200, (0, 7), correlation=1),
        X("k_up", "kernel", 250, 150, (0, 7), correlation=2),
        X("k_fft", "kernel", 600, 100, (0, 7), correlation=3),
        X("Memcpy DtoH", "gpu_memcpy", 690, 60, (0, 7)),
        X("k_other", "kernel", 800, 100, (0, 7), correlation=4),
        X("k_outside", "kernel", 1200, 100, (0, 7), correlation=9),
    ]


def test_busy_is_the_union_of_device_intervals():
    t = trace.read_events(events())
    # 100-400, 600-750, 800-900: 300 + 150 + 100 us.
    assert t.busy_s() == pytest.approx(550e-6)
    assert t.window_s == pytest.approx(1e-3)
    run = Run(kind="eval_closed", config={}, traffic={}, trace=t)
    assert readers.idle_pct(run) == pytest.approx(45.0)


def test_kernels_belong_to_a_span_by_their_launch_on_its_thread():
    t = trace.read_events(events())
    assert len(t.spans) == 2
    assert sorted(t.unet_device) == [pytest.approx((100e-6, 300e-6)),
                                     pytest.approx((250e-6, 400e-6))]
    assert t.unet_device_s() == pytest.approx(300e-6)


def test_idle_gaps_name_the_innermost_host_op():
    t = trace.read_events(events())
    gaps = dict(t.idle_gaps())
    # 0-100 (the first span's middle), 400-600 (conv 400-800 holds copy
    # 500-600, the gap's middle is 500), 750-800 (conv), 900-1000 (none).
    assert gaps["aten::copy_"] == pytest.approx(200e-6)
    assert gaps[trace.UNET_SPAN] == pytest.approx(100e-6)
    assert gaps["aten::conv"] == pytest.approx(50e-6)
    assert gaps["no host op"] == pytest.approx(100e-6)
    top = dict(t.top_ops())
    assert top["k_conv"] == pytest.approx(200e-6) and "k_outside" not in top


def test_a_trace_needs_one_window():
    with pytest.raises(ValueError):
        trace.read_events([e for e in events()
                           if e["name"] != trace.WINDOW_SPAN])


def _cfg():
    import json
    from portbench.spec import PACKAGE
    return json.loads((PACKAGE / "configs" /
                       "dt4ir-csmri-f32.json").read_text())


def test_roofline_and_mfu_from_known_counts():
    cfg = _cfg()
    t = trace.read_events(events())
    run = Run(kind="eval_closed", config=cfg, traffic={}, trace=t,
              per_call=1, traced_slices=2,
              prior=spec.load_prior(cfg["prior"]))
    bound = counts.unet_bound_s(cfg, 1)
    assert readers.unet_roofline_pct(run) == pytest.approx(
        100 * 2 * bound / 300e-6)
    assert readers.step_mfu_pct(run) == pytest.approx(
        100 * 2 * counts.slice_flops(cfg) / 1e-3 / (495e12 / 3))


def test_nothing_to_read_gives_no_number():
    cfg = _cfg()
    run = Run(kind="eval_closed", config=cfg, traffic={}, per_call=1)
    assert readers.unet_roofline_pct(run) is None
    assert readers.step_mfu_pct(run) is None
    assert readers.idle_pct(run) is None
    quiet = trace.read_events([e for e in events()
                               if e["cat"] not in trace.DEVICE_CATEGORIES])
    run.trace = quiet
    assert readers.idle_pct(run) is None
    assert readers.unet_roofline_pct(run) is None


def test_single_slice_rate_and_tail_of_a_one_slice_loop():
    """The rate counts every slice of the window; the tail leaves out the
    calls made under the profiler; a batched loop reports neither."""
    rate = spec.load_reader("single_slices_per_s")
    tail = spec.load_reader("evaluator.slice_p95_ms")
    lat = [1000.0] * 2 + [100.0] * 95 + [200.0] * 5
    run = Run(kind="eval_closed", config={}, traffic={}, per_call=1,
              slices=102, window_s=20.0, latencies_ms=lat, traced_slices=2)
    assert rate(run) == pytest.approx(102 / 20.0)
    assert tail(run) == pytest.approx(float(np.percentile(lat[2:], 95)))
    assert tail(run) < float(np.percentile(lat, 95))
    batched = Run(kind="eval_closed", config={}, traffic={}, per_call=63,
                  slices=630, window_s=20.0, latencies_ms=lat)
    assert rate(batched) is None and tail(batched) is None


def test_a_kernels_roofline_from_the_ops_its_name_matches():
    """The spans times the kernel's bound a call, over the device time of
    the window's ops whose name holds the match; None where none does."""
    run = Run(kind="eval_closed", config=_cfg(), traffic={},
              trace=trace.read_events(events()), per_call=3,
              prior=spec.load_prior("unet_nm"))
    seen = []

    def bound_s(cfg, batch):
        seen.append((cfg["prior"], batch))
        return 1e-6 * batch
    assert readers.ops_roofline_pct(run, "k_conv", bound_s) == \
        pytest.approx(100 * 2 * 3e-6 / 200e-6)
    # k_conv, k_up, k_fft and k_other: 100-400, 600-700, 800-900 us.
    assert readers.ops_roofline_pct(run, "k_", bound_s) == \
        pytest.approx(100 * 2 * 3e-6 / 500e-6)
    assert seen == [("unet_nm", 3)] * 2
    assert readers.ops_roofline_pct(run, "no_such_kernel", bound_s) is None
    run.trace = None
    assert readers.ops_roofline_pct(run, "k_", bound_s) is None
