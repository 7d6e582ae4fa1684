"""The port's spans (utils/profiling.py): where the evaluation loop, the
ADMM step, the U-Net (and its graph's replay), the policy step and the
service record them, how they
nest, that they cost nothing and record nothing while no profiler runs,
that they change no result, and that the operator's exporter reaches the
service's threads.

The policy's stop output T is biased to -3, so every episode runs to
``MAXT`` and the loop's iterations are known: t = 0 (before the start, one
host read), t = 1 .. MAXT (an ADMM step and two host reads each, a policy
step in all but the last), and the last's third read, which ends the loop."""
import contextlib
import json

import numpy as np
import pytest
import torch

from dt4image_restoration_tpu_torch.config import ModelConfig
from dt4image_restoration_tpu_torch.data import make_mat_record
from dt4image_restoration_tpu_torch.env import reset_from_mat
from dt4image_restoration_tpu_torch.inference import (Evaluator,
                                                      PolicyGraphs,
                                                      greedy_rollout,
                                                      initial_policy_setup)
from dt4image_restoration_tpu_torch.models import (DecisionTransformer,
                                                   PriorGraphs, UNetDenoiser,
                                                   make_dt_apply,
                                                   make_dt_embed_apply,
                                                   make_state_encode,
                                                   random_unet_state_dict)
from dt4image_restoration_tpu_torch.serving import (RestorationRequest,
                                                    RestorationService)
from dt4image_restoration_tpu_torch.utils import profiling
from dt4image_restoration_tpu_torch.utils.device import resolve_device
from dt4image_restoration_tpu_torch.utils.profiling import (
    ENV_ADMM, EVAL_STEP, EVAL_SYNC, POLICY_GRAPH, POLICY_STEP, PRIOR_GRAPH,
    SERVE_FILL,
    SERVE_LAUNCH, SERVE_PERMIT, SERVE_RESOLVE, SERVE_SETTLE, SERVE_WAIT,
    TRACE_FILE, UNET, annotate, trace_if_enabled)
from torch_port_common import one_torch_thread  # noqa: F401

SIZE = 48
MAXT = 6
BATCH = 2
WAIT = 120   # seconds any one future or thread may take
CFG = ModelConfig(block_size=18, n_embeds=9, embed_dim=32, n_heads=4,
                  n_blocks=2, image_size=SIZE)


@pytest.fixture(scope="module")
def models():
    torch.manual_seed(0)
    dt = DecisionTransformer(CFG).eval().requires_grad_(False)
    with torch.no_grad():
        dt.predict_action.bias[0] = -3.0   # norm mode: T is column 0
    den = UNetDenoiser(8)
    den.load_state_dict(random_unet_state_dict(seed=3, base_channels=8))
    return dt, den.eval().requires_grad_(False)


def _rollout(models, policy_graphs=None):
    dt, den = models
    recs = [make_mat_record(size=SIZE, seed=i) for i in range(BATCH)]
    mats = {k: np.concatenate([r[k] for r in recs])
            for k in ("x0", "y0", "mask", "gt")}
    x0 = torch.from_numpy(mats["x0"][..., 0].reshape(BATCH, -1)
                          .astype(np.float32))
    mats["x0"] = np.clip(mats["x0"], 0, None)
    apply, encode = make_dt_apply(dt), make_state_encode(dt)
    bufs, _, action_dict, pred_rtg = initial_policy_setup(
        apply, CFG, x0, torch.full((BATCH,), 0.6), torch.full((BATCH,), 2),
        MAXT, encode=encode)
    final, reward, ep_len, _ = greedy_rollout(
        apply, den, CFG, reset_from_mat(mats, device="cpu"), bufs,
        action_dict, pred_rtg, MAXT, encode=encode,
        dt_embed_apply=make_dt_embed_apply(apply),
        policy_graphs=policy_graphs)
    return final.x, reward, ep_len


def _profiled(fn, tmp_path, cuda=False):
    """``fn()``'s result and the Chrome trace events of a CPU profile of
    it (and of the card's activity, with ``cuda``)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        out = fn()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        return out, json.load(f)["traceEvents"]


def _spans(events, name):
    """(start, end) of the ``user_annotation`` spans named ``name``, in
    order, in us."""
    return sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                  for e in events if e.get("name") == name
                  and e.get("ph") == "X"
                  and e.get("cat") == "user_annotation")


def _inside(span, parents):
    return [p for p in parents if p[0] <= span[0] and span[1] <= p[1]]


def test_a_rollout_records_each_span_once_per_step_and_nested(models,
                                                              tmp_path):
    (_, _, ep_len), events = _profiled(lambda: _rollout(models), tmp_path)
    assert ep_len.tolist() == [MAXT] * BATCH
    steps = _spans(events, EVAL_STEP)
    admm, unet = _spans(events, ENV_ADMM), _spans(events, UNET)
    policy, syncs = _spans(events, POLICY_STEP), _spans(events, EVAL_SYNC)
    assert len(steps) == MAXT + 1          # t = 0 .. MAXT
    assert len(admm) == len(unet) == MAXT  # t = 1 .. MAXT
    assert len(policy) == MAXT - 1         # not after every slice ended
    for a in admm:
        assert len(_inside(a, steps)) == 1
    for u in unet:
        assert len(_inside(u, admm)) == 1
    for p in policy:
        assert len(_inside(p, steps)) == 1 and not _inside(p, admm)
    # The three read sites: the start test in every iteration, the live
    # test in every stepped one, the end test in the last.
    per_step = [sum(1 for s in syncs if _inside(s, [st])) for st in steps]
    assert per_step == [1] + [2] * (MAXT - 1) + [3]
    for s in syncs:
        assert not _inside(s, admm) and not _inside(s, policy)


def _policy_spans_nested(events):
    """The policy-step and policy-graph spans, each graph span inside one
    policy step and each policy step inside one loop iteration."""
    steps, admm = _spans(events, EVAL_STEP), _spans(events, ENV_ADMM)
    policy, graph = _spans(events, POLICY_STEP), _spans(events, POLICY_GRAPH)
    for p in policy:
        assert len(_inside(p, steps)) == 1 and not _inside(p, admm)
    for g in graph:
        assert len(_inside(g, policy)) == 1
    return policy, graph


def test_a_rollout_through_policy_graphs_nests_each_replay_in_its_step(
        models, tmp_path):
    """Through the evaluator's graph cache (uncaptured on the CPU) the
    policy step is still one span per step, nested as before, with the
    step's replay inside it; the outputs are those without a cache."""
    alone = _rollout(models)
    graphs = PolicyGraphs()
    out, events = _profiled(lambda: _rollout(models, graphs), tmp_path)
    for a, b in zip(alone, out):
        assert torch.equal(a, b)
    policy, graph = _policy_spans_nested(events)
    assert len(policy) == len(graph) == MAXT - 1
    assert len(_spans(events, EVAL_STEP)) == MAXT + 1
    assert graphs.stats()["eager_policy_steps"] == MAXT - 1


@pytest.mark.cuda
def test_each_policy_step_on_the_card_replays_its_graph_once(tmp_path):
    """On the card the evaluator's policy step is one span a step with one
    replay of its graph inside it, and the replayed kernels (K3's among
    them) are on the profiler's device trace."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    dev = resolve_device("cuda")
    cfg = ModelConfig(block_size=18)
    dt = DecisionTransformer(cfg).eval().requires_grad_(False)
    with torch.no_grad():
        dt.predict_action.bias[0] = -3.0   # T: no early stops
    den = UNetDenoiser()
    den.load_state_dict(random_unet_state_dict(seed=3))
    ev = Evaluator(dt=dt.to(dev), denoise=den.eval().requires_grad_(False)
                   .to(dev), cfg=cfg, max_timesteps=MAXT, device=dev)
    rec = make_mat_record(seed=0)
    records = [((rec["x0"][..., 0].reshape(1, -1).astype(np.float32),
                 np.full((1, 1), 0.6, np.float32), np.zeros(3, np.float32),
                 np.full((1, 1), 2)), rec)] * BATCH
    ev.evaluate_records(records)               # captures the graph
    m, events = _profiled(lambda: ev.evaluate_records(records), tmp_path,
                          cuda=True)
    assert m["episode_len"].tolist() == [MAXT] * BATCH
    policy, graph = _policy_spans_nested(events)
    assert len(policy) == len(graph) == MAXT - 1
    assert ev.policy_graph_stats() == {
        "captures": 1, "replays": 2 * (MAXT - 1), "eager_policy_steps": 0}
    k3 = [e for e in events if e.get("cat") == "kernel"
          and "dt_decode" in e.get("name", "")]
    # Two eager forwards of the setup, two replayed ones a policy step.
    assert len(k3) == 2 + 2 * (MAXT - 1)


@pytest.mark.cuda
def test_a_replayed_prior_keeps_its_kernels_under_the_benchmarks_span(
        tmp_path):
    """The benchmark reads the prior's device time from the kernels whose
    launch lies in its ``portbench.unet`` span (``portbench/trace.py:
    read_events``, by correlation id). A prior replayed from its graph
    launches them by one ``cudaGraphLaunch`` inside that span: they are
    attributed to it, with the eager calls' device time within 10 %, and
    each replay's ``dt4ir.prior.graph`` span lies inside its ``dt4ir.unet``
    span."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    from portbench.trace import WINDOW_SPAN, read_events, unet_span
    dev = resolve_device("cuda")
    den = UNetDenoiser()
    den.load_state_dict(random_unet_state_dict(seed=3))
    den = den.eval().requires_grad_(False).to(dev)
    x = torch.rand((1, 1, 128, 128), device=dev)
    sigma = torch.full((1,), 0.05, device=dev)
    graphs, calls = PriorGraphs(), 4

    def window(graphed):
        with torch.no_grad(), contextlib.ExitStack() as stack:
            if graphed:
                stack.enter_context(graphs.scope())
            with torch.profiler.record_function(WINDOW_SPAN):
                for _ in range(calls):
                    with unet_span():
                        den(x, sigma)
                torch.cuda.synchronize()

    with torch.no_grad():
        den(x, sigma)
        with graphs.scope():
            den(x, sigma)                      # captures the graph
    torch.cuda.synchronize()
    traced = {}
    for graphed in (False, True):
        _, events = _profiled(lambda: window(graphed), tmp_path, cuda=True)
        traced[graphed] = (read_events(events), events)
    eager, replayed = traced[False][0], traced[True][0]
    assert len(eager.spans) == len(replayed.spans) == calls
    assert eager.unet_device_s() > 0 and replayed.unet_device_s() > 0
    ratio = replayed.unet_device_s() / eager.unet_device_s()
    print(f"prior device s under the span: eager {eager.unet_device_s():.6f}"
          f", replayed {replayed.unet_device_s():.6f} ({ratio:.3f}x)")
    assert 0.9 <= ratio <= 1.1
    assert graphs.stats() == {"captures": 1, "replays": calls,
                              "eager_prior_calls": 0}
    events = traced[True][1]
    unet, graph = _spans(events, UNET), _spans(events, PRIOR_GRAPH)
    assert len(unet) == len(graph) == calls
    for g in graph:
        assert len(_inside(g, unet)) == 1


def test_outputs_are_bit_equal_with_the_profiler_on_and_off(models,
                                                            tmp_path):
    off = _rollout(models)
    on, _ = _profiled(lambda: _rollout(models), tmp_path)
    for a, b in zip(off, on):
        assert torch.equal(a, b)


def test_a_span_off_is_one_shared_no_op_and_leaves_nothing(tmp_path):
    assert not torch.autograd.profiler._is_profiler_enabled
    held = annotate("dt4ir.test.stale")
    assert held is annotate("dt4ir.test.other") is profiling._NO_SPAN
    with held:
        pass

    def work():
        with held:        # taken while off: stays a no-op when entered
            with annotate("dt4ir.test.fresh"):
                return torch.ones(3) + 1

    _, events = _profiled(work, tmp_path)
    assert _spans(events, "dt4ir.test.fresh")
    assert not _spans(events, "dt4ir.test.stale")
    assert annotate("dt4ir.test.after") is profiling._NO_SPAN


def test_the_exporter_reaches_the_services_threads(models, tmp_path):
    """The worker and resolver start with the service, before the
    profiler; their spans land in the trace, the evaluator's under the
    launch."""
    dt, den = models
    svc = RestorationService(denoise=den, dt=dt, mode="policy",
                             batch_size=2, max_timesteps=MAXT,
                             pipeline_depth=2, device="cpu")
    reqs = [RestorationRequest(mat=make_mat_record(size=SIZE, seed=i),
                               rtg=0.6, task=2) for i in range(3)]
    try:
        with trace_if_enabled(str(tmp_path)):
            results = svc.restore(reqs, timeout=WAIT)
    finally:
        svc.close(timeout=WAIT)
    assert [r.episode_len for r in results] == [MAXT] * 3
    with open(tmp_path / TRACE_FILE) as f:
        events = json.load(f)["traceEvents"]
    for name in (SERVE_WAIT, SERVE_FILL, SERVE_PERMIT, SERVE_LAUNCH,
                 SERVE_RESOLVE, SERVE_SETTLE):
        assert _spans(events, name), name
    launches = _spans(events, SERVE_LAUNCH)
    assert len(launches) >= 2      # 2 + 1, or 3 lone ones on a slow host
    steps = _spans(events, EVAL_STEP)
    assert len(steps) == len(launches) * (MAXT + 1)
    assert all(_inside(s, launches) for s in steps)


@pytest.mark.parametrize("verb", [
    ["eval", "--rtg", "10"], ["mcts", "--rtg", "5"],
    ["train", "--batch_size", "2", "--save_every", "1", "--max_epochs", "1"]],
    ids=lambda v: v[0])
def test_the_command_line_runs_its_verb_in_the_exporter(verb, tmp_path,
                                                        monkeypatch):
    """``DT4IR_TRACE_DIR`` makes the command line write the trace of the
    verb it ran."""
    from dt4image_restoration_tpu_torch import __main__ as cli

    def verb_body(args):
        with annotate("dt4ir.test.verb"):
            torch.ones(2) * 2

    for name in ("_evaluate", "_search", "_train"):
        monkeypatch.setattr(cli, name, verb_body)
    monkeypatch.setenv(profiling.TRACE_ENV_VAR, str(tmp_path))
    cli.main(["--block_size", "18", "--device", "cpu"] + verb)
    with open(tmp_path / TRACE_FILE) as f:
        assert _spans(json.load(f)["traceEvents"], "dt4ir.test.verb")
