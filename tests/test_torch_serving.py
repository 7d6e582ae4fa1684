"""The port's RestorationService (serving.py): batching, padding,
concurrency, pipelining, admission control, and agreement with the direct
calls it wraps (the port's greedy_rollout, fixed_param_rollout and
DeviceMCTS) and with the JAX package's greedy evaluation on shared weights
(JAX init carried over by utils/convert.py:dt_from_jax).

The policy's stop output T is biased to -3, so no episode's length sits at
the stop threshold. Every wait on a future or a thread has its own timeout,
so that a hang fails one test instead of the suite's time limit.
Bands: the service against the direct port calls on the same batch,
episode lengths equal and images within 1e-5; against JAX, episode lengths
equal and PSNR within 0.05 dB (PARITY.md)."""
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dt4image_restoration_tpu.config import ModelConfig as JModelConfig
from dt4image_restoration_tpu.inference import Evaluator as JEvaluator
from dt4image_restoration_tpu.models.decision_transformer import (
    init_dt_params as j_init_dt_params, make_dt_apply as j_make_dt_apply)
from dt4image_restoration_tpu_torch.config import MCTSConfig, ModelConfig
from dt4image_restoration_tpu_torch.data import make_mat_record
from dt4image_restoration_tpu_torch.env import (compute_reward,
                                                fixed_param_rollout,
                                                reset_from_mat)
from dt4image_restoration_tpu_torch.inference import (
    DeviceMCTS, greedy_rollout, initial_policy_setup)
from dt4image_restoration_tpu_torch.models import (DecisionTransformer,
                                                   make_dt_apply,
                                                   make_dt_embed_apply,
                                                   make_state_encode,
                                                   proxy_value_fn)
from dt4image_restoration_tpu_torch.serving import (RestorationRequest,
                                                    RestorationService,
                                                    ServiceOverloaded)
from dt4image_restoration_tpu_torch.utils.convert import (dt_from_jax,
                                                          load_strict)
from torch_port_common import one_torch_thread  # noqa: F401

SIZE = 36
CFG_KW = dict(block_size=18, n_embeds=9, embed_dim=32, n_heads=4,
              n_blocks=2, image_size=SIZE)
MAXT = 8
WAIT = 120   # seconds any one future or thread may take


def stub_denoise(img, sigma):
    return torch.clamp(0.8 * img + 0.1 + 0.1 * sigma[:, None, None, None],
                       0.0, 1.0)


def j_stub_denoise(img, sigma):
    return jnp.clip(0.8 * img + 0.1 + 0.1 * sigma[:, None, None, None],
                    0.0, 1.0)


def clip_denoise(img, sigma):
    return torch.clamp(img, 0.0, 1.0)


@pytest.fixture(scope="module")
def shared():
    """(jax cfg, jax params, port DT) on the same weights."""
    jcfg = JModelConfig(**CFG_KW)
    params = jax.tree.map(np.array, j_init_dt_params(jcfg, seed=0))
    params["predict_action"]["bias"][0] = -3.0   # norm mode: T is col 0
    cfg = ModelConfig(**CFG_KW, use_pallas=True)
    dt = load_strict(DecisionTransformer(cfg), dt_from_jax(params, cfg),
                     "dt").eval().requires_grad_(False)
    return jcfg, params, dt


def _requests(n, size=SIZE, offset=0):
    return [RestorationRequest(mat=make_mat_record(size=size, seed=i),
                               rtg=0.6, task=2)
            for i in range(offset, offset + n)]


def _service(**kw):
    kw.setdefault("max_timesteps", MAXT)
    return RestorationService(device="cpu", **kw)


def _restore(svc, requests):
    """Restore and close, each wait bounded."""
    try:
        return svc.restore(requests, timeout=WAIT)
    finally:
        svc.close(timeout=WAIT)


def _mats(requests, clip=True):
    mats = {k: np.concatenate([np.asarray(r.mat[k]) for r in requests])
            for k in ("x0", "y0", "mask", "gt")}
    if clip:
        mats["x0"] = np.clip(mats["x0"], 0, None)
    return mats


def test_fixed_mode_matches_fixed_param_rollout():
    """A partial batch (3 of 4, padded) against the rollout on the same
    three slices."""
    reqs = _requests(3)
    results = _restore(_service(denoise=stub_denoise, mode="fixed",
                                batch_size=4), reqs)
    final, _ = fixed_param_rollout(
        stub_denoise, reset_from_mat(_mats(reqs), device="cpu"), 0.5,
        15.0 / 255.0, MAXT)
    want = compute_reward(final)[:, 0].numpy()
    assert len(results) == 3
    for i, r in enumerate(results):
        assert r.image.shape == (SIZE, SIZE) and r.episode_len == MAXT
        np.testing.assert_allclose(r.image, np.clip(final.x[i, 0].numpy(),
                                                    0, 1), rtol=0, atol=1e-5)
        np.testing.assert_allclose(r.psnr_db, want[i], rtol=1e-6)


def _direct_policy(dt, reqs):
    """The port's greedy rollout on the requests' batch: the unclipped x0
    as the first observation, the clipped x0 in the env."""
    apply = make_dt_apply(dt)
    encode = make_state_encode(dt)
    policy_x0 = torch.from_numpy(np.stack(
        [np.asarray(r.mat["x0"], np.float32)[..., 0].reshape(-1)
         for r in reqs]))
    bufs, _, action_dict, pred_rtg = initial_policy_setup(
        apply, dt.cfg, policy_x0, torch.full((len(reqs),), 0.6),
        torch.full((len(reqs),), 2), MAXT, encode=encode)
    final, reward, ep_len, _ = greedy_rollout(
        apply, stub_denoise, dt.cfg, reset_from_mat(_mats(reqs),
                                                    device="cpu"),
        bufs, action_dict, pred_rtg, MAXT, encode=encode,
        dt_embed_apply=make_dt_embed_apply(apply))
    return final.x[:, 0].numpy(), reward[:, 0].numpy(), ep_len.numpy()


@pytest.mark.parametrize("n", [4, 3])
def test_policy_mode_matches_direct_rollout(shared, n):
    """A full batch and a padded one (the padding repeats the last
    request) against greedy_rollout on the live requests alone."""
    _, _, dt = shared
    reqs = _requests(n)
    results = _restore(_service(denoise=stub_denoise, dt=dt, mode="policy",
                                batch_size=4), reqs)
    images, reward, ep_len = _direct_policy(dt, reqs)
    np.testing.assert_array_equal([r.episode_len for r in results], ep_len)
    assert np.all(ep_len == MAXT)
    for i, r in enumerate(results):
        np.testing.assert_allclose(r.image, np.clip(images[i], 0, 1),
                                   rtol=0, atol=1e-5)
    np.testing.assert_allclose([r.psnr_db for r in results], reward,
                               rtol=1e-5)


def test_policy_mode_matches_jax_evaluation(shared):
    jcfg, params, dt = shared
    reqs = _requests(4)
    results = _restore(_service(denoise=stub_denoise, dt=dt, mode="policy",
                                batch_size=4), reqs)
    records = []
    for r in reqs:
        states = np.asarray(r.mat["x0"], np.float32)[..., 0].reshape(1, -1)
        records.append(((states, np.full((1, 1), 0.6, np.float32),
                         np.zeros(3, np.float32), np.asarray([2], np.int32)),
                        _mats([r])))
    want = JEvaluator(dt_apply=j_make_dt_apply(jcfg), dt_params=params,
                      denoise=j_stub_denoise, cfg=jcfg,
                      max_timesteps=MAXT).evaluate_records(records)
    np.testing.assert_array_equal([r.episode_len for r in results],
                                  np.asarray(want["episode_len"]))
    np.testing.assert_allclose([r.psnr_db for r in results],
                               np.asarray(want["reward"]), rtol=0, atol=0.05)


def test_service_without_ground_truth():
    """Production requests carry no gt: the slice is restored and its PSNR
    is None; a neighbour with gt keeps its own PSNR."""
    with_gt = RestorationRequest(mat=make_mat_record(size=SIZE, seed=0))
    no_gt = RestorationRequest(mat={
        k: v for k, v in make_mat_record(size=SIZE, seed=1).items()
        if k != "gt"})
    a, b = _restore(_service(denoise=clip_denoise, mode="fixed",
                             batch_size=2), [with_gt, no_gt])
    assert a.psnr_db is not None and np.isfinite(a.psnr_db)
    assert b.psnr_db is None and b.image.shape == (SIZE, SIZE)
    (c,) = _restore(_service(denoise=clip_denoise, mode="fixed",
                             batch_size=2), [no_gt])
    assert c.psnr_db is None
    np.testing.assert_array_equal(c.image, b.image)


def test_submit_after_close_raises():
    svc = _service(denoise=clip_denoise, mode="fixed", batch_size=2)
    svc.close(timeout=WAIT)
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit(_requests(1)[0])


def test_concurrent_submissions(shared):
    _, _, dt = shared
    svc = _service(denoise=stub_denoise, dt=dt, mode="policy", batch_size=4,
                   max_delay_s=0.2)
    outs = {}

    def client(i):
        fut = svc.submit(_requests(1, offset=i)[0])
        outs[i] = fut.result(timeout=WAIT)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(6)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT)
        assert not any(t.is_alive() for t in threads)
    finally:
        svc.close(timeout=WAIT)
    assert len(outs) == 6
    assert all(np.isfinite(v.psnr_db) for v in outs.values())
    assert svc.stats()["completed"] == 6


def test_mcts_mode_matches_direct_device_search(shared):
    """The service's search of a padded batch equals a direct DeviceMCTS
    search of the live requests (one seed for every tree): rewards, the
    best rollout's image and its episode length."""
    _, _, dt = shared
    search = MCTSConfig(iterations=2, max_timesteps=MAXT, seed=3)
    reqs = _requests(3)
    results = _restore(_service(denoise=stub_denoise, dt=dt, mode="mcts",
                                batch_size=4, search_cfg=search), reqs)
    direct = DeviceMCTS(dt=dt, denoise=stub_denoise, model_cfg=dt.cfg,
                        cfg=search, value_fn=proxy_value_fn, device="cpu")
    recs = [((None, np.float32(0.6), None, np.int32(2)), _mats([r]))
            for r in reqs]
    want = direct.run_batch(recs, seeds=[3] * 3, detailed=True,
                            verbose=False)
    assert len(results) == 3
    for got, ref in zip(results, want):
        assert got.psnr_db == ref["reward"]
        np.testing.assert_allclose(got.image, np.clip(ref["image"], 0, 1),
                                   rtol=0, atol=1e-6)
        assert got.episode_len == ref["episode_len"]


def test_mcts_mode_node_dtype_plumbs_through(shared):
    """node_dtype reaches the service's DeviceMCTS; bfloat16 node storage
    serves results within 0.05 dB of float32 storage."""
    _, _, dt = shared
    kw = dict(denoise=stub_denoise, dt=dt, mode="mcts", batch_size=2,
              search_cfg=MCTSConfig(iterations=2, max_timesteps=MAXT))
    reqs = _requests(2)
    f32 = _service(**kw)
    assert f32._mcts.node_dtype == "float32"
    want = _restore(f32, reqs)
    b16 = _service(node_dtype="bfloat16", **kw)
    assert b16._mcts.node_dtype == "bfloat16"
    got = _restore(b16, reqs)
    for a, b in zip(want, got):
        assert abs(a.psnr_db - b.psnr_db) <= 0.05


def test_pipelined_service_matches_unpipelined(shared):
    """pipeline_depth=2 returns what the inline path does, over several
    consecutive batches and a padded partial one."""
    _, _, dt = shared
    kw = dict(denoise=stub_denoise, dt=dt, mode="policy", batch_size=4)
    reqs = _requests(11)
    want = _restore(_service(**kw), reqs)
    got = _restore(_service(pipeline_depth=2, **kw), reqs)
    assert len(got) == len(want) == 11
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.image, w.image)
        assert g.episode_len == w.episode_len and g.psnr_db == w.psnr_db


def test_pipelined_close_resolves_in_flight():
    """close() drains the launched batches through the resolver: every
    submitted future is resolved or cancelled, none hangs."""
    svc = _service(denoise=clip_denoise, mode="fixed", batch_size=2,
                   max_timesteps=5, pipeline_depth=3)
    futs = [svc.submit(r) for r in _requests(6)]
    svc.close(timeout=WAIT)
    done = [f for f in futs if f.done() and not f.cancelled()]
    cancelled = [f for f in futs if f.cancelled()]
    assert len(done) + len(cancelled) == 6
    for f in done:
        assert f.result(timeout=0).image.shape == (SIZE, SIZE)


@pytest.mark.parametrize("pipeline_depth", [1, 2])
def test_run_error_settles_the_batch_with_it(pipeline_depth):
    """A failing run resolves its batch's futures with the exception (never
    with a result of some other path), counts them failed, and the
    service goes on serving."""
    calls = []

    def flaky(img, sigma):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("denoiser failed")
        return torch.clamp(img, 0.0, 1.0)

    svc = _service(denoise=flaky, mode="fixed", batch_size=2,
                   max_timesteps=2, pipeline_depth=pipeline_depth,
                   max_delay_s=1.0)
    try:
        bad = [svc.submit(r) for r in _requests(2)]
        for f in bad:
            with pytest.raises(RuntimeError, match="denoiser failed"):
                f.result(timeout=WAIT)
        good = svc.restore(_requests(2), timeout=WAIT)
    finally:
        svc.close(timeout=WAIT)
    assert all(r.image.shape == (SIZE, SIZE) for r in good)
    st = svc.stats()
    assert st["failed"] == 2 and st["completed"] == 2


def test_worker_threads_run_without_grad():
    """Grad mode is per thread: the worker and the resolver switch it off
    themselves."""
    seen = []

    def watch(img, sigma):
        seen.append(torch.is_grad_enabled())
        return torch.clamp(img, 0.0, 1.0)

    for depth in (1, 2):
        _restore(_service(denoise=watch, mode="fixed", batch_size=2,
                          max_timesteps=1, pipeline_depth=depth),
                 _requests(2))
    assert len(seen) >= 2 and not any(seen)


def test_pipeline_depth_and_knob_validation(shared):
    _, _, dt = shared
    with pytest.raises(ValueError, match="pipeline_depth"):
        _service(denoise=stub_denoise, mode="fixed", pipeline_depth=0)
    with pytest.raises(ValueError, match="policy/fixed"):
        _service(denoise=stub_denoise, dt=dt, mode="mcts", pipeline_depth=2)
    with pytest.raises(ValueError, match="unknown serving mode"):
        _service(denoise=stub_denoise, mode="mtcs")
    for mode in ("policy", "mcts"):
        with pytest.raises(ValueError, match="needs a DecisionTransformer"):
            _service(denoise=stub_denoise, mode=mode)
    with pytest.raises(ValueError, match="fill_window_frac"):
        _service(denoise=clip_denoise, mode="fixed", fill_window_frac=-0.1)
    with pytest.raises(ValueError, match="max_queue_depth"):
        _service(denoise=clip_denoise, mode="fixed", max_queue_depth=0)
    with pytest.raises(ValueError, match="node_dtype"):
        _service(denoise=stub_denoise, dt=dt, mode="mcts",
                 node_dtype="float16")


def test_cancelled_future_does_not_poison_batchmates():
    """A client's cancel() while its batch runs must not keep its
    batchmates' results from landing."""
    svc = _service(denoise=clip_denoise, mode="fixed", batch_size=4,
                   max_timesteps=5, pipeline_depth=2)
    try:
        for _ in range(3):  # the cancel races the batch's collection
            futs = [svc.submit(r) for r in _requests(4)]
            futs[1].cancel()
            for f in futs:
                if not f.cancelled():
                    assert f.result(timeout=WAIT).image.shape == (SIZE,
                                                                  SIZE)
    finally:
        svc.close(timeout=WAIT)
    assert svc.stats()["failed"] == 0


def test_service_stats_counters():
    svc = _service(denoise=clip_denoise, mode="fixed", batch_size=4,
                   max_timesteps=5, max_delay_s=1.0)
    try:
        st0 = svc.stats()
        assert "latency_sum_ms" not in st0
        assert st0["latency_mean_ms"] == 0.0 and st0["completed"] == 0
        svc.restore(_requests(6), timeout=WAIT)  # a full batch + 2 live
        st = svc.stats()
    finally:
        svc.close(timeout=WAIT)
    assert set(st0) == set(st) == {
        "submitted", "completed", "failed", "cancelled", "rejected",
        "batches", "padded_slots", "latency_max_ms", "latency_mean_ms",
        "queue_depth"}
    assert st["submitted"] == 6 and st["completed"] == 6
    assert st["failed"] == 0 and st["cancelled"] == 0
    assert st["batches"] == 2 and st["padded_slots"] == 2
    assert st["latency_mean_ms"] > 0
    assert st["latency_max_ms"] >= st["latency_mean_ms"]
    assert st["queue_depth"] == 0


def test_many_clients_counters_reconcile():
    """More client threads than cores, with the interpreter switching
    threads as often as it can: every request completes once and the
    counters add up (a lost update under the stats lock would break
    them)."""
    import sys
    n_clients, per_client = 2 * (os.cpu_count() or 4), 3
    svc = _service(denoise=clip_denoise, mode="fixed", batch_size=4,
                   max_timesteps=1, pipeline_depth=2)
    req = _requests(1, size=16)[0]
    done, lock = [], threading.Lock()

    def client():
        for _ in range(per_client):
            r = svc.submit(req).result(timeout=WAIT)
            with lock:
                done.append(r.episode_len)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=client)
                   for _ in range(n_clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        svc.close(timeout=WAIT)
    st = svc.stats()
    n = n_clients * per_client
    assert len(done) == n and st["submitted"] == st["completed"] == n
    assert st["failed"] == st["cancelled"] == 0
    assert st["batches"] * 4 - st["padded_slots"] == n


def test_pipelined_soak_with_random_cancels():
    """Sustained pipelined load with cancels sprinkled in: every future
    settles, the counters reconcile, nothing deadlocks."""
    import random
    rng = random.Random(0)
    recs = _requests(8, size=16)
    svc = _service(denoise=clip_denoise, mode="fixed", batch_size=4,
                   max_timesteps=3, pipeline_depth=3)
    futs = []
    try:
        for i in range(80):
            f = svc.submit(recs[i % len(recs)])
            futs.append(f)
            if rng.random() < 0.15:
                f.cancel()
        results = [f.result(timeout=WAIT) for f in futs
                   if not f.cancelled()]
    finally:
        svc.close(timeout=WAIT)
    assert all(r.image.shape == (16, 16) for r in results)
    st = svc.stats()
    assert st["submitted"] == 80
    assert st["completed"] + st["cancelled"] == 80
    assert st["failed"] == 0 and st["completed"] == len(results)


def test_admission_control_bounds_queue(monkeypatch):
    """max_queue_depth: submit sheds with ServiceOverloaded once the queue
    holds that many requests, counts the rejection, and leaves accepted
    requests alone; close() cancels them. The worker is stubbed to never
    collect, so the depth is deterministic."""
    monkeypatch.setattr(RestorationService, "_collect",
                        lambda self: time.sleep(0.01) or [])
    svc = _service(denoise=clip_denoise, mode="fixed", batch_size=2,
                   max_timesteps=2, max_queue_depth=3)
    req = _requests(1, size=16)[0]
    try:
        futs = [svc.submit(req) for _ in range(3)]
        with pytest.raises(ServiceOverloaded):
            svc.submit(req)
        st = svc.stats()
        assert st["rejected"] == 1 and st["submitted"] == 3
        assert st["queue_depth"] == 3
    finally:
        svc.close(timeout=WAIT)
    assert all(f.cancelled() for f in futs)
    assert svc.stats()["cancelled"] == 3


def test_fill_window_logic():
    """The fill window: max_delay_s before any turn is measured,
    fill_window_frac of the running mean turn after, capped at
    fill_window_max_s; frac=0 keeps the fixed patience."""
    svc = _service(denoise=clip_denoise, mode="fixed", batch_size=2,
                   max_timesteps=2)
    try:
        assert svc._fill_window_s() == pytest.approx(0.01)
        svc._turn_ema_s = 1.0
        assert svc._fill_window_s() == pytest.approx(0.1)
        svc._turn_ema_s = 100.0
        assert svc._fill_window_s() == pytest.approx(0.5)
        svc.fill_window_frac = 0.0
        assert svc._fill_window_s() == pytest.approx(0.01)
        svc._turn_ema_s = 0.0
        svc._note_turn(2.0)
        assert svc._turn_ema_s == pytest.approx(2.0)
        svc._note_turn(1.0)
        assert svc._turn_ema_s == pytest.approx(1.5)
    finally:
        svc.close(timeout=WAIT)


def test_adaptive_fill_window_coalesces_trickle():
    """Requests trickling in slower than max_delay_s but inside the
    adaptive window land in ONE batch."""
    svc = _service(denoise=clip_denoise, mode="fixed", batch_size=4,
                   max_timesteps=2, fill_window_max_s=5.0)
    svc._turn_ema_s = 60.0  # as if turns were long: window = the cap
    try:
        futs = [svc.submit(_requests(1, size=16)[0])]
        for i in range(1, 4):
            time.sleep(0.05)  # > max_delay_s, << the window
            futs.append(svc.submit(_requests(1, size=16, offset=i)[0]))
        for f in futs:
            f.result(timeout=WAIT)
        st = svc.stats()
    finally:
        svc.close(timeout=WAIT)
    assert st["batches"] == 1 and st["padded_slots"] == 0
