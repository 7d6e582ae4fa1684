"""The port's evaluation data and greedy evaluator against the JAX
package's, on the same .mat records and weights.

With random weights the policy's stop output T sits at sigmoid(~0) = 0.5,
right at the stop threshold, so tiny numeric differences could flip episode
lengths. The evaluator cases therefore set the T column of the action
head's bias, identically in both frameworks, to +3 (every image stops at
once) or -3 (every image runs all 30 steps)."""
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
