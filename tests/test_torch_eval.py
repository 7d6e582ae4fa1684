"""The port's evaluation data and greedy evaluator against the JAX
package's, on the same .mat records and weights.

With random weights the policy's stop output T sits at sigmoid(~0) = 0.5,
right at the stop threshold, so tiny numeric differences could flip episode
lengths. The evaluator cases therefore set the T column of the action
head's bias, identically in both frameworks, to +3 (every image stops at
once) or -3 (every image runs all 30 steps)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from dt4image_restoration_tpu.config import ModelConfig as JModelConfig
from dt4image_restoration_tpu.data.datasets import (
    EvaluationDataset as JEvaluationDataset)
from dt4image_restoration_tpu.env import pnp as jpnp
from dt4image_restoration_tpu.inference import Evaluator as JEvaluator
from dt4image_restoration_tpu.inference import evaluator as jev
from dt4image_restoration_tpu.models import decision_transformer as jdt
from dt4image_restoration_tpu.models.decision_transformer import (
    init_dt_params as j_init_dt_params, make_dt_apply as j_make_dt_apply)
from dt4image_restoration_tpu_torch.config import ModelConfig
from dt4image_restoration_tpu_torch.data import (EvaluationDataset,
                                                 EvaluationFlexibleDataset,
                                                 write_eval_dir)
from dt4image_restoration_tpu_torch.env import pnp
from dt4image_restoration_tpu_torch.inference import Evaluator
from dt4image_restoration_tpu_torch.inference import evaluator as tev
from dt4image_restoration_tpu_torch.models import decision_transformer as tdt
from dt4image_restoration_tpu_torch.models import DecisionTransformer
from dt4image_restoration_tpu_torch.utils.convert import (dt_from_jax,
                                                          load_strict)

from torch_port_common import one_torch_thread  # noqa: F401
from torch_port_common import shared_denoisers

SIZE = 48
CFG_KW = dict(block_size=18, n_embeds=9, embed_dim=64, n_heads=4,
              n_blocks=2, image_size=SIZE)


@pytest.fixture(scope="module")
def denoisers():
    return shared_denoisers(seed=4, base=8)


@pytest.fixture(scope="module")
def eval_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("evalsets")
    return [write_eval_dir(str(root / tok), tok, n=2, size=SIZE,
                           seed=10 * i) for i, tok in enumerate(["4_15",
                                                                 "8_5"])]


@pytest.mark.parametrize("kind", ["optimal", "flex"])
def test_evaluation_dataset_matches_jax(eval_dirs, kind):
    ours = EvaluationDataset(eval_dirs[1], rtg_target=3, kind=kind)
    theirs = JEvaluationDataset(eval_dirs[1], rtg_target=3, kind=kind)
    assert len(ours) == len(theirs) == 2
    for i in range(2):
        (s, r, a, t), rec = ours[i]
        (js, jr, ja, jt), jrec = theirs[i]
        for x, y in ((s, js), (r, jr), (a, ja), (t, jt)):
            np.testing.assert_array_equal(x, y)
        for k in rec:
            np.testing.assert_array_equal(rec[k], jrec[k])
        # The policy's first observation reads the unclipped x0.
        assert s.min() < 0 <= rec["x0"].min()
    flex = EvaluationFlexibleDataset(eval_dirs[0], rtg_target=4.5)
    assert flex[0][0][3][0] == flex.task_tokenizer["rtg_4.5"]


def test_reset_from_loaded_mat_is_contiguous(eval_dirs):
    """loadmat returns Fortran-ordered arrays; the state the kernels take
    must still be contiguous."""
    _, rec = EvaluationDataset(eval_dirs[0], rtg_target=10.0)[0]
    state = pnp.reset_from_mat(rec, device="cpu")
    for name in ("x", "z", "u", "mask", "y0", "gt"):
        assert getattr(state, name).is_contiguous(), name


@pytest.fixture(scope="module")
def jax_programs(denoisers):
    """One JAX evaluator program shared by the bias cases (the params are
    arguments, so both cases run the same compiled rollout)."""
    _, j_denoise = denoisers
    jcfg = JModelConfig(**CFG_KW)
    return jcfg, j_make_dt_apply(jcfg), j_denoise


@pytest.mark.parametrize("t_bias,expect_len", [(3.0, 1), (-3.0, 30)])
def test_evaluator_matches_jax(eval_dirs, denoisers, jax_programs,
                               t_bias, expect_len):
    model_den, _ = denoisers
    jcfg, j_dt_apply, j_denoise = jax_programs
    params = jax.tree.map(np.array, j_init_dt_params(jcfg, seed=2))
    params["predict_action"]["bias"][0] = t_bias   # norm mode: T is col 0
    records = [JEvaluationDataset(d, rtg_target=10.0)[i]
               for d in eval_dirs for i in range(2)]

    jm = JEvaluator(dt_apply=j_dt_apply, dt_params=params,
                    denoise=j_denoise, cfg=jcfg, max_timesteps=30,
                    rtg_target=10.0).evaluate_records(records)

    cfg = ModelConfig(**CFG_KW)
    dt = load_strict(DecisionTransformer(cfg), dt_from_jax(params, cfg),
                     "dt").eval().requires_grad_(False)
    ev = Evaluator(dt=dt, denoise=model_den, cfg=cfg, max_timesteps=30,
                   rtg_target=10.0, device="cpu")
    m = ev.evaluate_records(records)

    np.testing.assert_array_equal(m["episode_len"],
                                  np.asarray(jm["episode_len"]))
    assert np.all(m["episode_len"] == expect_len)
    np.testing.assert_allclose(m["reward"], np.asarray(jm["reward"]),
                               rtol=0, atol=0.05)
    np.testing.assert_allclose(m["increment"], np.asarray(jm["increment"]),
                               rtol=0, atol=0.05)
    assert m["final_state"].x.shape == (4, 1, SIZE, SIZE)


def test_evaluator_at_block_size_36_matches_jax(eval_dirs, denoisers,
                                                monkeypatch):
    """Past K3's 32 tokens (12-timestep windows, 36 tokens) the evaluator
    runs the per-op forward, never the fused one, and matches the JAX
    evaluator's per-op forward over 30 steps."""
    model_den, j_denoise = denoisers
    kw = dict(CFG_KW, block_size=36)
    jcfg = JModelConfig(**kw)
    params = jax.tree.map(np.array, j_init_dt_params(jcfg, seed=2))
    params["predict_action"]["bias"][0] = -3.0   # T: no early stops
    records = [JEvaluationDataset(d, rtg_target=10.0)[i]
               for d in eval_dirs for i in range(2)]
    jm = JEvaluator(dt_apply=j_make_dt_apply(jcfg), dt_params=params,
                    denoise=j_denoise, cfg=jcfg, max_timesteps=30,
                    rtg_target=10.0).evaluate_records(records)

    def refuse(model):
        raise AssertionError("the fused forward was built for 36 tokens")
    monkeypatch.setattr(tev, "make_fused_dt_apply", refuse)
    cfg = ModelConfig(**kw, use_pallas=True)
    dt = load_strict(DecisionTransformer(cfg), dt_from_jax(params, cfg),
                     "dt").eval().requires_grad_(False)
    m = Evaluator(dt=dt, denoise=model_den, cfg=cfg, max_timesteps=30,
                  rtg_target=10.0, device="cpu").evaluate_records(records)
    np.testing.assert_array_equal(m["episode_len"],
                                  np.asarray(jm["episode_len"]))
    assert np.all(m["episode_len"] == 30)
    np.testing.assert_allclose(m["reward"], np.asarray(jm["reward"]),
                               rtol=0, atol=0.05)


@pytest.mark.parametrize("block_size,fused", [(18, True), (33, False)])
def test_evaluator_picks_forward_from_config(eval_dirs, denoisers,
                                             monkeypatch, block_size,
                                             fused):
    """Without a ``dt_apply`` the evaluator builds the fused forward where
    K3 takes the config and the per-op forward where it does not."""
    model_den, _ = denoisers
    built = []
    for name in ("make_fused_dt_apply", "make_dt_apply"):
        def spy(model, name=name, real=getattr(tev, name)):
            built.append(name)
            return real(model)
        monkeypatch.setattr(tev, name, spy)
    cfg = ModelConfig(**dict(CFG_KW, block_size=block_size))
    dt = DecisionTransformer(cfg).eval().requires_grad_(False)
    Evaluator(dt=dt, denoise=model_den, cfg=cfg, max_timesteps=11,
              device="cpu").evaluate_records(
                  [EvaluationDataset(eval_dirs[0], 10.0)[0]])
    assert built == ["make_fused_dt_apply" if fused else "make_dt_apply"]


def test_evaluator_run_prints_per_directory(eval_dirs, denoisers,
                                            capsys):
    model_den, _ = denoisers
    cfg = ModelConfig(**CFG_KW)
    dt = DecisionTransformer(cfg).eval().requires_grad_(False)
    ev = Evaluator(dt=dt, denoise=model_den, cfg=cfg, max_timesteps=6,
                   rtg_target=10.0, report_every=1, device="cpu")
    total = ev.run(eval_dirs)
    out = capsys.readouterr().out
    assert out.count("Average iter, ") == 2
    assert len(ev.last_metrics["reward"]) == 2   # first image of each dir
    assert np.isfinite(total)


def test_uncached_encoder_matches_cached(eval_dirs, denoisers):
    model_den, _ = denoisers
    cfg = ModelConfig(**CFG_KW)
    torch.manual_seed(0)
    dt = DecisionTransformer(cfg).eval().requires_grad_(False)
    records = [EvaluationDataset(eval_dirs[0], 10.0)[0]]
    kw = dict(dt=dt, denoise=model_den, cfg=cfg, max_timesteps=8,
              device="cpu")
    a = Evaluator(**kw).evaluate_records(records)
    b = Evaluator(cached_encoder=False, **kw).evaluate_records(records)
    np.testing.assert_array_equal(a["episode_len"], b["episode_len"])
    np.testing.assert_allclose(a["reward"], b["reward"], rtol=1e-5)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_evaluator_per_op_apply_matches_fused(eval_dirs, denoisers,
                                              use_pallas):
    """The evaluator runs the forward it is given: the per-op forward (K4
    and K5, or plain ops) gives the default fused forward's (K3) result."""
    model_den, _ = denoisers
    cfg = ModelConfig(**CFG_KW, use_pallas=use_pallas)
    torch.manual_seed(1)
    dt = DecisionTransformer(cfg).eval().requires_grad_(False)
    dt.predict_action.bias[0] = -3.0     # T: no image stops early
    records = [EvaluationDataset(d, 10.0)[0] for d in eval_dirs]
    kw = dict(dt=dt, denoise=model_den, cfg=cfg, max_timesteps=8,
              device="cpu")
    fused = Evaluator(**kw).evaluate_records(records)
    per_op = Evaluator(dt_apply=tdt.make_dt_apply(dt),
                       **kw).evaluate_records(records)
    np.testing.assert_array_equal(per_op["episode_len"], 8)
    np.testing.assert_array_equal(fused["episode_len"], 8)
    np.testing.assert_allclose(per_op["reward"], fused["reward"], rtol=0,
                               atol=1e-4)


def _stub_policy(xp, module):
    """A deterministic stand-in for the DT, written once per framework:
    each image stops at a timestep set by its task token, and the other
    outputs depend on the RTG, state, action and timestep windows, so the
    evaluator's window and index reads all show in the result."""
    def apply(rtg, states, timesteps, task, actions):
        b = rtg.shape[0]
        ts = timesteps.reshape(b, -1)[..., None] * 1.0
        s_mean = states.mean(-1)[..., None]
        stop = 1.0 * (ts >= 3 + 2 * task[..., None])
        mu = 0.2 + 0.1 * xp.tanh(s_mean) + 0.01 * rtg
        sig = 0.3 + 0.1 * xp.tanh(rtg + 0.01 * ts)
        raw = xp.concatenate([stop, sig, mu], -1)
        pred_rtg = None
        if actions is not None:
            pred_rtg = rtg + 0.5 * actions[..., 2:3] - 0.01 * ts
        pred, adict = module.transform_actions(raw, "norm")
        return module.DTOutput(pred_actions=pred, pred_rtg=pred_rtg,
                               action_dict=adict)
    return apply


def test_greedy_rollout_mixed_stops_matches_jax(eval_dirs, denoisers):
    """Images finishing at different steps: per-image episode lengths,
    rewards and the final policy buffers match the JAX rollout."""
    import jax.numpy as jnp
    model_den, j_denoise = denoisers
    records = [EvaluationDataset(d, rtg_target=10.0)[i]
               for d in eval_dirs for i in range(2)]
    x0 = np.concatenate([r[0][0] for r in records])
    rtg0 = np.stack([r[0][1].reshape(()) for r in records])
    task = np.stack([r[0][3].reshape(()) for r in records])
    mats = {k: np.concatenate([r[1][k] for r in records])
            for k in ("x0", "y0", "mask", "gt")}
    maxt = 20

    jcfg = JModelConfig(**CFG_KW)
    stub_j = _stub_policy(jnp, jdt)
    j_apply = lambda params, *a: stub_j(*a)  # noqa: E731
    bufs, _, adict, prtg = jev.initial_policy_setup(
        j_apply, jcfg, None, jnp.asarray(x0), jnp.asarray(rtg0),
        jnp.asarray(task), maxt)
    jfinal, jreward, jlen, jbufs = jev.greedy_rollout(
        j_apply, j_denoise, jcfg, None, jpnp.reset_from_mat(mats), bufs,
        adict, prtg, maxt)

    cfg = ModelConfig(**CFG_KW)
    stub_t = _stub_policy(torch, tdt)
    bufs, _, adict, prtg = tev.initial_policy_setup(
        stub_t, cfg, torch.from_numpy(x0), torch.from_numpy(rtg0),
        torch.from_numpy(task), maxt)
    final, reward, ep_len, tbufs = tev.greedy_rollout(
        stub_t, model_den, cfg, pnp.reset_from_mat(mats, device="cpu"),
        bufs, adict, prtg, maxt)

    np.testing.assert_array_equal(ep_len.numpy(), np.asarray(jlen))
    assert len(set(ep_len.tolist())) > 1      # the stops really differ
    np.testing.assert_allclose(reward.numpy(), np.asarray(jreward),
                               rtol=0, atol=0.05)
    for name in ("actions", "rtg", "states"):
        np.testing.assert_allclose(getattr(tbufs, name).numpy(),
                                   np.asarray(getattr(jbufs, name)),
                                   rtol=1e-3, atol=1e-4)


def test_policy_step_gathers_the_rtg_and_state_windows_once():
    """Both forwards of a policy step read one RTG window and one state
    window, the same tensors; only the action window is gathered again.
    The step's outputs stay the JAX package's, with one window sliding."""
    import jax.numpy as jnp
    rng = np.random.default_rng(3)
    arrays = {"states": rng.uniform(0, 1, (2, 10, SIZE * SIZE)),
              "actions": rng.uniform(0, 1, (2, 10, 3)),
              "rtg": rng.uniform(0, 5, (2, 10, 1))}
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    task, t = np.array([1, 4]), np.array([3, 8])   # context length 6
    stub_j = _stub_policy(jnp, jdt)
    theirs = jev.make_policy_step(
        lambda params, *a: stub_j(*a), JModelConfig(**CFG_KW))(
        None, jev.EvalBuffers(**{k: jnp.asarray(v)
                                 for k, v in arrays.items()},
                              task=jnp.asarray(task)), jnp.asarray(t))
    stub_t, calls = _stub_policy(torch, tdt), []

    def spy(*args):
        calls.append(args)
        return stub_t(*args)
    ours = tev.make_policy_step(spy, ModelConfig(**CFG_KW))(
        tev.EvalBuffers(**{k: torch.from_numpy(v) for k, v in arrays.items()},
                        task=torch.from_numpy(task)), torch.from_numpy(t))
    assert len(calls) == 2
    assert calls[0][0] is calls[1][0] and calls[0][1] is calls[1][1]
    assert calls[0][4] is not calls[1][4]
    for a, b in ((ours[0], theirs[0]), (ours[2], theirs[2]),
                 (ours[3].actions, theirs[3].actions)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)
    for k, v in theirs[1].items():
        np.testing.assert_allclose(ours[1][k].numpy(), np.asarray(v),
                                   rtol=1e-5, atol=1e-6)


# --- the policy step through a graph cache (a CUDA graph on the card) ------

STATIC_MAXT = 14   # past both context lengths, so that the windows slide


def _static_case(denoisers, eval_dirs, block_size, batch, cached, t_bias,
                 policy_graphs=None):
    """One rollout of ``batch`` slices through ``greedy_rollout``, with or
    without the graph cache ``policy_graphs``; the policy's stop output
    biased by ``t_bias``."""
    model_den, _ = denoisers
    cfg = ModelConfig(**dict(CFG_KW, block_size=block_size))
    torch.manual_seed(0)
    dt = DecisionTransformer(cfg).eval().requires_grad_(False)
    with torch.no_grad():
        dt.predict_action.bias[0] = t_bias   # norm mode: T is column 0
    records = [EvaluationDataset(d, 10.0)[i] for d in eval_dirs
               for i in range(2)][:batch]
    x0 = torch.from_numpy(np.concatenate([r[0][0] for r in records]))
    rtg0 = torch.from_numpy(np.stack([r[0][1].reshape(())
                                      for r in records]))
    task = torch.from_numpy(np.stack([r[0][3].reshape(())
                                      for r in records]))
    mats = {k: np.concatenate([r[1][k] for r in records])
            for k in ("x0", "y0", "mask", "gt")}
    apply = tev.policy_forward(dt, cfg)
    encode = tdt.make_state_encode(dt) if cached else None
    embed = tdt.make_dt_embed_apply(apply) if cached else None
    bufs, _, adict, prtg = tev.initial_policy_setup(
        apply, cfg, x0, rtg0, task, STATIC_MAXT, encode=encode)
    return tev.greedy_rollout(
        apply, model_den, cfg, pnp.reset_from_mat(mats, device="cpu"),
        bufs, adict, prtg, STATIC_MAXT, encode=encode, dt_embed_apply=embed,
        policy_graphs=policy_graphs, graph_key="weights")


@pytest.mark.parametrize("t_bias", [-3.0, -1.0], ids=["no_stop", "stops"])
@pytest.mark.parametrize("cached", [True, False], ids=["cached", "uncached"])
@pytest.mark.parametrize("block_size", [18, 36])
@pytest.mark.parametrize("batch", [1, 3])
def test_rollout_through_a_policy_graph_cache_is_bit_equal_to_one_without(
        eval_dirs, denoisers, batch, block_size, cached, t_bias):
    """Two calls through one graph cache (uncaptured on the CPU: bound,
    then its static tensors reused and loaded again) give the final
    states, rewards, episode lengths and buffers of a rollout without a
    cache bit for bit, with sliding windows and with images stopping at
    different steps."""
    alone = _static_case(denoisers, eval_dirs, block_size, batch, cached,
                         t_bias)
    ep_len = alone[2].tolist()
    if t_bias < -2:
        assert ep_len == [STATIC_MAXT] * batch
    else:
        assert min(ep_len) < STATIC_MAXT
        assert batch == 1 or len(set(ep_len)) > 1
    graphs = tev.PolicyGraphs()
    for call in (1, 2):
        through = _static_case(denoisers, eval_dirs, block_size, batch,
                               cached, t_bias, graphs)
        assert torch.equal(through[2], alone[2])
        assert torch.equal(through[1], alone[1])
        for f in dataclasses.fields(pnp.CSMRIState):
            assert torch.equal(getattr(through[0], f.name),
                               getattr(alone[0], f.name)), f.name
        # The cache's own buffers, until the device's next call.
        assert through[3] is graphs.steps[torch.device("cpu")].bufs
        for f in dataclasses.fields(tev.EvalBuffers):
            got, want = getattr(through[3], f.name), getattr(alone[3],
                                                             f.name)
            assert (got is None) == (want is None), f.name
            assert got is None or torch.equal(got, want), f.name
        # One policy step at t = 1 .. the last live one, none captured.
        assert graphs.stats() == {"captures": 0, "replays": 0,
                                  "eager_policy_steps":
                                  call * (max(ep_len) - 1)}


def _seeded(b, dev="cpu", maxt=8, s=16, cached=True):
    bufs = tev.EvalBuffers(
        states=torch.rand(b, maxt, s), actions=torch.rand(b, maxt, 3),
        rtg=torch.rand(b, maxt, 1), task=torch.arange(b),
        state_embs=torch.rand(b, maxt, 4) if cached else None)
    return bufs, {"T": torch.rand(b), "mu": torch.rand(b)}, torch.rand(b)


def test_policy_graphs_keep_one_static_step_per_batch_and_weights():
    """A device keeps one static step, reused from call to call with the
    call's buffers copied in; a new batch shape, encoder cache or key
    (the weights) makes a new one in its place."""
    graphs = tev.PolicyGraphs()

    def bind(b, key="w0", cached=True):
        bufs, adict, prtg = _seeded(b, cached=cached)
        s = graphs.bind(key, None, bufs, adict, prtg)
        assert torch.equal(s.bufs.states, bufs.states)
        assert s.bufs.states.data_ptr() != bufs.states.data_ptr()
        assert torch.equal(s.action_dict["mu"], adict["mu"])
        assert torch.equal(s.pred_rtg, prtg)
        assert (s.bufs.state_embs is None) == (not cached)
        assert graphs.steps == {torch.device("cpu"): s}
        return s

    first = bind(3)
    assert bind(3) is first
    assert bind(3, cached=False) is not first
    third = bind(3, key="w1")
    assert third is not first
    fourth = bind(4, key="w1")
    assert bind(4, key="w1") is fourth
    assert bind(3, key="w1") is not third   # batch 4 took its place
    assert graphs.stats() == {"captures": 0, "replays": 0,
                              "eager_policy_steps": 0}


def test_cpu_evaluator_runs_the_policy_step_without_a_graph_cache(
        eval_dirs, denoisers, monkeypatch):
    """Without CUDA the evaluator hands ``greedy_rollout`` no graphs."""
    model_den, _ = denoisers
    handed = []
    real = tev.greedy_rollout

    def spy(*args, **kw):
        handed.append(kw.get("policy_graphs"))
        return real(*args, **kw)
    monkeypatch.setattr(tev, "greedy_rollout", spy)
    cfg = ModelConfig(**CFG_KW)
    dt = DecisionTransformer(cfg).eval().requires_grad_(False)
    ev = Evaluator(dt=dt, denoise=model_den, cfg=cfg, max_timesteps=6,
                   device="cpu")
    ev.evaluate_records([EvaluationDataset(eval_dirs[0], 10.0)[0]])
    assert handed == [None]
    assert ev.policy_graph_stats() == {"captures": 0, "replays": 0,
                                       "eager_policy_steps": 0}
