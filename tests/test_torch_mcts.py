"""The port's PUCB tree search against the JAX package's host-tree search:
its pieces exactly, and a whole lockstep search of two trees on shared
weights and records.

With random weights the policy's stop output T sits at sigmoid(~0) = 0.5,
at the stop threshold; as in test_torch_eval.py the T column of the action
head's bias is set to -3 in both frameworks, so no rollout stops early and
tiny numeric differences cannot flip an episode's length."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dt4image_restoration_tpu.config import MCTSConfig as JMCTSConfig
from dt4image_restoration_tpu.config import ModelConfig as JModelConfig
from dt4image_restoration_tpu.data.datasets import (
    EvaluationDataset as JEvaluationDataset)
from dt4image_restoration_tpu.inference import mcts as jmcts
from dt4image_restoration_tpu.inference.evaluator import (
    EvalBuffers as JEvalBuffers, make_policy_step as j_make_policy_step)
from dt4image_restoration_tpu.models.arniqa import (
    proxy_value_fn as j_proxy_value_fn)
from dt4image_restoration_tpu.models.decision_transformer import (
    init_dt_params as j_init_dt_params, make_dt_apply as j_make_dt_apply)
from dt4image_restoration_tpu_torch.config import MCTSConfig, ModelConfig
from dt4image_restoration_tpu_torch.data import (EvaluationDataset,
                                                 write_eval_dir)
from dt4image_restoration_tpu_torch.env import reset_from_mat
from dt4image_restoration_tpu_torch.inference import (MCTS, BatchedMCTS,
                                                      EvalBuffers, Node,
                                                      fold_and_sort,
                                                      greedy_rollout,
                                                      make_policy_step,
                                                      run_mcts,
                                                      sample_actions,
                                                      seed_buffers,
                                                      select_p_ucb)
from dt4image_restoration_tpu_torch.inference import mcts as tmcts
from dt4image_restoration_tpu_torch.models import (DecisionTransformer,
                                                   make_dt_apply,
                                                   proxy_value_fn)
from dt4image_restoration_tpu_torch.utils.convert import (dt_from_jax,
                                                          load_strict)
from torch_port_common import one_torch_thread  # noqa: F401
from torch_port_common import shared_denoisers

SIZE = 48
CFG_KW = dict(block_size=18, n_embeds=9, embed_dim=64, n_heads=4,
              n_blocks=2, image_size=SIZE)


# --- pieces ---------------------------------------------------------------

def _tree_pair(rng, n_children):
    """The same parent with random children in both frameworks."""
    parents = []
    probs = rng.uniform(50, 400, n_children)
    rewards = rng.uniform(-1, 1, n_children)
    visits = rng.integers(0, 4, n_children)
    for cls in (Node, jmcts.Node):
        parent = cls(0, 1.0, None, 0, 0, None, None, 0.5)
        parent.reward, parent.s_visits = 0.2, int(visits.sum()) + 1
        for i in range(n_children):
            c = cls(1, float(probs[i]), parent, i, 0, None, None, 0.5)
            c.reward, c.s_visits = float(rewards[i]), int(visits[i])
            parent.children.append(c)
        parents.append(parent)
    return parents


@pytest.mark.parametrize("seed", range(6))
def test_select_p_ucb_matches_jax(seed):
    ours, theirs = _tree_pair(np.random.default_rng(seed), 5)
    assert select_p_ucb(ours).edge == select_p_ucb(theirs).edge
    # Ties go to the first child, as in the reference loop.
    for c in ours.children:
        c.prob, c.reward, c.s_visits = 100.0, 0.0, 0
    assert select_p_ucb(ours) is ours.children[0]


@pytest.mark.parametrize("loc,std", [(0.27, 0.2), (0.05, 0.2),
                                     (0.3, 0.001), (0.0004, 0.001)])
def test_fold_and_sort_matches_jax(loc, std):
    rng = np.random.default_rng(42)
    raw = rng.normal(loc, std, 5)
    raw[1] = -abs(raw[1]) - 0.3 * std      # a folded draw
    ours, theirs = fold_and_sort(raw, loc, std), \
        jmcts.fold_and_sort(raw, loc, std)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    z = torch.from_numpy((raw - loc) / std)[None]
    samples, probs = tmcts.fold_sort_batch(
        torch.tensor([loc], dtype=torch.float64), z, std)
    np.testing.assert_allclose(samples[0].numpy(), ours[0], rtol=1e-6)
    np.testing.assert_allclose(probs[0].numpy(), ours[1], rtol=1e-6)


def test_sample_actions_stream_matches_jax():
    a, b = np.random.default_rng(7), np.random.default_rng(7)
    for loc, std in ((0.13, 0.2), (0.5, 0.001), (0.2, 0.2)):
        for x, y in zip(sample_actions(a, loc, std, 5),
                        jmcts.sample_actions(b, loc, std, 5)):
            np.testing.assert_array_equal(x, y)
    assert a.standard_normal() == b.standard_normal()


# --- the whole search -----------------------------------------------------

@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("mcts_sets")
    d = write_eval_dir(str(root / "4_15"), "4_15", n=2, size=SIZE, seed=3)
    model_den, j_denoise = shared_denoisers(seed=4, base=8)
    jcfg = JModelConfig(**CFG_KW)
    params = jax.tree.map(np.array, j_init_dt_params(jcfg, seed=2))
    params["predict_action"]["bias"][0] = -3.0   # norm mode: T is col 0
    cfg = ModelConfig(**CFG_KW, use_pallas=True)
    dt = load_strict(DecisionTransformer(cfg), dt_from_jax(params, cfg),
                     "dt").eval().requires_grad_(False)
    return dict(dir=d, model_den=model_den, j_denoise=j_denoise, jcfg=jcfg,
                params=params, cfg=cfg, dt=dt)


@pytest.mark.parametrize("iterations", [4, 8])
def test_search_matches_jax(setup, capsys, iterations):
    s = setup
    scfg = dict(iterations=iterations, max_timesteps=8)
    jrecords = [JEvaluationDataset(s["dir"], rtg_target=5.0)[i]
                for i in range(2)]
    jm = jmcts.MCTS(dt_apply=j_make_dt_apply(s["jcfg"]),
                    dt_params=s["params"], denoise=s["j_denoise"],
                    model_cfg=s["jcfg"], cfg=JMCTSConfig(**scfg),
                    value_fn=j_proxy_value_fn, record_trace=True)
    j_rewards = jm.run_batch(jrecords, seeds=[5, 6])

    records = [EvaluationDataset(s["dir"], rtg_target=5.0,
                                 image_size=SIZE)[i] for i in range(2)]
    m = BatchedMCTS(dt=s["dt"], denoise=s["model_den"], model_cfg=s["cfg"],
                    cfg=MCTSConfig(**scfg), value_fn=proxy_value_fn,
                    record_trace=True, device="cpu")
    rewards = m.run_batch(records, seeds=[5, 6])

    key = ("iter", "time", "edge", "index")
    for ours, theirs in zip(m.traces, jm.traces):
        assert [[e[k] for k in key] for e in ours] \
            == [[e[k] for k in key] for e in theirs]
        # Past the root's five children the search goes deeper.
        assert max(e["time"] for e in ours) == (1 if iterations == 4 else 2)
        for a, b in zip(ours, theirs):
            np.testing.assert_allclose(a["probs"], b["probs"], rtol=1e-4)
            np.testing.assert_allclose(a["reward"], b["reward"], rtol=0,
                                       atol=1e-3)
    np.testing.assert_allclose(rewards, j_rewards, rtol=0, atol=0.05)
    assert capsys.readouterr().out.count("MCTS Reward: ") == 4


@pytest.mark.parametrize("t", [8, 9])
def test_policy_step_past_horizon_matches_jax(setup, t):
    """A leaf at the horizon (t = max_timesteps = 8) or past it steps as in
    the JAX package: its action write is dropped, and window reads past the
    buffers' end are NaN. Row 0 sits one step before row 1."""
    s = setup
    rng = np.random.default_rng(t)
    arrays = {"states": rng.uniform(0, 1, (2, 8, SIZE * SIZE)),
              "actions": rng.uniform(0, 1, (2, 8, 3)),
              "rtg": rng.uniform(0, 5, (2, 8, 1))}
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    task, t_vec = np.array([2, 5]), np.array([t - 1, t])

    theirs = j_make_policy_step(j_make_dt_apply(s["jcfg"]), s["jcfg"])(
        s["params"], JEvalBuffers(**{k: jnp.asarray(v)
                                     for k, v in arrays.items()},
                                  task=jnp.asarray(task)),
        jnp.asarray(t_vec))
    ours = make_policy_step(make_dt_apply(s["dt"]), s["cfg"])(
        EvalBuffers(**{k: torch.from_numpy(v) for k, v in arrays.items()},
                    task=torch.from_numpy(task)), torch.from_numpy(t_vec))
    for a, b in ((ours[0], theirs[0]), (ours[2], theirs[2]),
                 (ours[3].actions, theirs[3].actions)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)
    np.testing.assert_array_equal(ours[3].actions[1].numpy(),
                                  arrays["actions"][1])
    assert np.isnan(ours[0][1].numpy()).all() == (t == 9)


def test_search_past_horizon_matches_jax(setup):
    """With a two-step horizon (and a two-step context) ten iterations
    expand leaves at the horizon, as the JAX search does."""
    s = setup
    kw = dict(CFG_KW, block_size=6)
    jcfg = JModelConfig(**kw)
    cfg = ModelConfig(**kw, use_pallas=True)
    dt = load_strict(DecisionTransformer(cfg),
                     dt_from_jax(s["params"], cfg), "dt").eval()
    scfg = dict(iterations=10, max_timesteps=2)
    jrecords = [JEvaluationDataset(s["dir"], rtg_target=5.0)[0]]
    jm = jmcts.MCTS(dt_apply=j_make_dt_apply(jcfg), dt_params=s["params"],
                    denoise=s["j_denoise"], model_cfg=jcfg,
                    cfg=JMCTSConfig(**scfg), value_fn=j_proxy_value_fn,
                    record_trace=True)
    j_rewards = jm.run_batch(jrecords, seeds=[5])
    m = MCTS(dt=dt, denoise=s["model_den"], model_cfg=cfg,
             cfg=MCTSConfig(**scfg), value_fn=proxy_value_fn,
             record_trace=True, device="cpu")
    rewards = m.run_batch([EvaluationDataset(s["dir"], rtg_target=5.0,
                                             image_size=SIZE)[0]], seeds=[5])

    key = ("iter", "time", "edge", "index")
    ours, theirs = m.traces[0], jm.traces[0]
    assert [[e[k] for k in key] for e in ours] \
        == [[e[k] for k in key] for e in theirs]
    assert max(e["time"] for e in ours) >= 2
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a["probs"], b["probs"], rtol=1e-4)
        np.testing.assert_allclose(a["reward"], b["reward"], rtol=0,
                                   atol=1e-3)
    np.testing.assert_allclose(rewards, j_rewards, rtol=0, atol=0.05)


def test_search_batch_equals_single_runs(setup):
    """A tree's search does not depend on its batch mates, and ``run`` /
    ``run_mcts`` are batches of one."""
    s = setup
    records = [EvaluationDataset(s["dir"], rtg_target=5.0,
                                 image_size=SIZE)[i] for i in range(2)]
    m = MCTS(dt=s["dt"], denoise=s["model_den"], model_cfg=s["cfg"],
             cfg=MCTSConfig(iterations=3, max_timesteps=8),
             value_fn=proxy_value_fn, record_trace=True, device="cpu")
    both = m.run_batch(records, seeds=[5, 6])
    traces = m.traces
    assert run_mcts(m, records[1], seed=6) == pytest.approx(both[1],
                                                            abs=1e-4)
    for a, b in zip(m.traces[0], traces[1], strict=True):
        assert {k: a[k] for k in ("iter", "time", "edge", "index")} \
            == {k: b[k] for k in ("iter", "time", "edge", "index")}
        assert a["probs"] == pytest.approx(b["probs"], rel=1e-5)
        assert a["reward"] == pytest.approx(b["reward"], abs=1e-4)
    uncached = dataclasses.replace(m, cached_encoder=False)
    assert uncached.run(records[1], seed=6) == pytest.approx(both[1],
                                                             abs=1e-4)


def test_rollout_leaves_shared_sibling_buffers_intact(setup):
    """Siblings hold one buffer snapshot; rolling one of them out must not
    write into it."""
    s = setup
    cfg, dt = s["cfg"], s["dt"]
    _, mat = EvaluationDataset(s["dir"], rtg_target=5.0, image_size=SIZE)[0]
    env = reset_from_mat(mat, device="cpu")
    bufs = seed_buffers(cfg, env.x.reshape(1, -1), torch.tensor([5.0]),
                        torch.tensor([2]), 8)
    snapshot = tmcts._rows(tmcts._cat([bufs, bufs], type(bufs)), 0, 1)
    siblings = [Node(1, 1.0, None, c, 0, env, env, 5.0) for c in range(2)]
    for node in siblings:
        node.bufs = snapshot
    before = {f.name: getattr(snapshot, f.name).clone()
              for f in dataclasses.fields(snapshot)
              if getattr(snapshot, f.name) is not None}

    apply = make_dt_apply(dt)
    _, action_dict, pred_rtg, upd = make_policy_step(apply, cfg)(
        siblings[0].bufs, 1)
    with torch.no_grad():
        greedy_rollout(apply, s["model_den"], cfg, env, upd, action_dict,
                       pred_rtg, 8, start_time=1)
        greedy_rollout(apply, s["model_den"], cfg, env, siblings[0].bufs,
                       action_dict, pred_rtg, 8, start_time=1)
    for name, t in before.items():
        assert torch.equal(getattr(siblings[1].bufs, name), t), name


# --- the single-node API: expand, beam_search, ancestry ------------------------

def _single_node_pair(s, iterations=4, max_timesteps=8):
    """One search object and one root in each framework on the setup's
    weights and first record, the root's buffers seeded as the JAX tests
    seed them (``_seed_bufs`` on the record's policy state)."""
    from dt4image_restoration_tpu.env import reset_from_mat as j_reset
    scfg = dict(iterations=iterations, max_timesteps=max_timesteps)
    (states0, rtg0, _, task0), mat = JEvaluationDataset(
        s["dir"], rtg_target=5.0)[0]
    jm = jmcts.MCTS(dt_apply=j_make_dt_apply(s["jcfg"]),
                    dt_params=s["params"], denoise=s["j_denoise"],
                    model_cfg=s["jcfg"], cfg=JMCTSConfig(**scfg),
                    value_fn=j_proxy_value_fn)
    jenv = j_reset(mat)
    jroot = jmcts.Node(0, 1.0, None, 0, 0, jenv, jenv, float(rtg0[0, 0]))
    jroot.bufs = jm._seed_bufs(jnp.asarray(states0),
                               jnp.asarray(rtg0).reshape(()),
                               jnp.asarray(task0))

    m = MCTS(dt=s["dt"], denoise=s["model_den"], model_cfg=s["cfg"],
             cfg=MCTSConfig(**scfg), value_fn=proxy_value_fn, device="cpu")
    env = reset_from_mat(mat, device="cpu")
    root = Node(0, 1.0, None, 0, 0, env, env, float(rtg0[0, 0]))
    root.bufs = m._seed_bufs(torch.from_numpy(states0),
                             torch.tensor(rtg0).reshape(()),
                             torch.from_numpy(np.asarray(task0)))
    return (m, root), (jm, jroot), int(np.asarray(task0).reshape(-1)[0])


def _hold_expansions(node, adict, pred, jnode, jadict, jpred):
    """One expansion against JAX's: action, RTG, priors, children."""
    assert set(adict) == set(jadict) == {"T", "sigma_d", "mu"}
    for k in adict:
        np.testing.assert_allclose(adict[k], jadict[k], rtol=2e-3)
    np.testing.assert_allclose(node.action, np.asarray(jnode.action),
                               rtol=2e-3, atol=1e-6)
    np.testing.assert_allclose(pred, jpred, rtol=2e-3, atol=1e-5)
    assert len(node.children) == len(jnode.children) == 5
    np.testing.assert_allclose([c.prob for c in node.children],
                               [c.prob for c in jnode.children], rtol=1e-6)
    np.testing.assert_allclose(node.policy_state.x.numpy(),
                               np.asarray(jnode.policy_state.x), rtol=1e-3,
                               atol=2e-4)
    for c, jc in zip(node.children, jnode.children):
        assert (c.time, c.edge, c.index) == (jc.time, jc.edge, jc.index)
        assert c.policy_rtg == pytest.approx(jc.policy_rtg, rel=2e-3)
        np.testing.assert_allclose(c.env_state.x.numpy(),
                                   np.asarray(jc.env_state.x), rtol=1e-3,
                                   atol=2e-4)
        assert not c.env_state.done.any()
        assert c.bufs is node.children[0].bufs      # one shared snapshot
        assert c.policy_state is node.policy_state


def test_expand_matches_jax(setup):
    """The root's expansion, then its first child's, against JAX's on the
    same weights and RNG seed: the model action within the DT band, priors
    within 1e-6, the children's states within the U-Net band."""
    (m, root), (jm, jroot), task = _single_node_pair(setup)
    before = {f.name: getattr(root.bufs, f.name).clone()
              for f in dataclasses.fields(root.bufs)
              if getattr(root.bufs, f.name) is not None}
    out = m.expand(root, task, np.random.default_rng(1), 0)
    jout = jm.expand(jroot, task, np.random.default_rng(1), 0)
    assert out[0] is root
    _hold_expansions(*out, *jout)
    # The node's own buffers are as they were; the children's hold its
    # action at its slot.
    for name, t in before.items():
        assert torch.equal(getattr(root.bufs, name), t), name
    np.testing.assert_allclose(
        root.children[0].bufs.actions[0, root.time].numpy(), root.action,
        rtol=1e-6)

    child, jchild = root.children[0], jroot.children[0]
    out = m.expand(child, task, np.random.default_rng(2), 1)
    jout = jm.expand(jchild, task, np.random.default_rng(2), 1)
    _hold_expansions(*out, *jout)
    grandchild = child.children[3]
    assert grandchild.ancestry() == [grandchild, child, root]
    assert [n.time for n in grandchild.ancestry()] == [2, 1, 0]
    np.testing.assert_allclose(
        grandchild.bufs.actions[0, :2].numpy(),
        np.stack([root.action, child.action]), rtol=1e-6)


def test_expand_draws_children_from_rng_as_jax(setup):
    """sigma_d samples first, then mu; priors are the mu densities (twin of
    tests/test_mcts.py::test_expand_creates_batched_children)."""
    (m, root), _, task = _single_node_pair(setup)
    node, adict, pred_rtg = m.expand(root, task, np.random.default_rng(1),
                                     0)
    assert node.action.shape == (3,) and np.isfinite(pred_rtg)
    rng = np.random.default_rng(1)
    sig, _ = sample_actions(rng, adict["sigma_d"], m.cfg.sigma_d_std, 5)
    mu, mu_probs = sample_actions(rng, adict["mu"], m.cfg.mu_std, 5)
    np.testing.assert_allclose([c.prob for c in node.children], mu_probs,
                               rtol=1e-6)
    assert max(c.prob for c in node.children) > 50
    for c in node.children:
        assert c.time == 1 and c.env_state.x.shape == (1, 1, SIZE, SIZE)
    x0 = node.children[0].env_state.x
    assert any(not torch.allclose(x0, c.env_state.x)
               for c in node.children[1:])
    # Slot 0 (the policy state) steps under the model's own action: the
    # same state as a one-slot step with it.
    single = m._expand_step(root.env_state, {k: torch.tensor([v])
                                             for k, v in adict.items()})
    torch.testing.assert_close(node.policy_state.x, single.x, rtol=1e-5,
                               atol=1e-6)
    # The children's sampled parameters are these draws, in this order:
    # one-slot steps with them give the children's states.
    for c, s_d, mu_c in zip(node.children, sig, mu):
        one = m._expand_step(root.env_state, {
            "T": torch.tensor([adict["T"]]), "sigma_d": torch.tensor([s_d]),
            "mu": torch.tensor([mu_c])})
        torch.testing.assert_close(c.env_state.x, one.x, rtol=1e-5,
                                   atol=1e-6)


def test_expansion_done_flag_is_transient_matches_jax(setup):
    """A stop action (T > 0.5) freezes the stepped slots and the done flag
    is cleared on the expansion's outputs (twin of
    tests/test_mcts.py::test_expansion_done_flag_is_transient)."""
    (m, root), (jm, jroot), _ = _single_node_pair(setup)
    action = {"T": np.asarray([0.9, 0.9], np.float32),
              "sigma_d": np.asarray([0.1, 0.1], np.float32),
              "mu": np.asarray([0.3, 0.3], np.float32)}
    tiled = tmcts._cat([root.env_state, root.env_state], type(root.env_state))
    stepped = m._expand_step(tiled, {k: torch.from_numpy(v)
                                     for k, v in action.items()})
    jstepped = jm._expand_step(
        jax.tree.map(lambda x: jnp.repeat(x, 2, axis=0), jroot.env_state),
        action)
    assert not stepped.done.any() and not np.asarray(jstepped.done).any()
    assert torch.equal(stepped.x[0], root.env_state.x[0])
    np.testing.assert_array_equal(stepped.x.numpy(),
                                  np.asarray(jstepped.x))


@pytest.mark.parametrize("expanded", [False, True])
def test_beam_search_matches_jax(setup, expanded):
    """The greedy rollout from the root, or from a child of the root's
    expansion, against JAX's: value, final image and episode length."""
    (m, root), (jm, jroot), task = _single_node_pair(setup)
    node, jnode = root, jroot
    if expanded:
        m.expand(root, task, np.random.default_rng(4), 0)
        jm.expand(jroot, task, np.random.default_rng(4), 0)
        node, jnode = root.children[2], jroot.children[2]
    value, x, ep_len = m.beam_search(node, task)
    jvalue, jx, jep_len = jm.beam_search(jnode, task)
    assert ep_len == jep_len == m.cfg.max_timesteps
    assert x.shape == np.asarray(jx).shape == (1, SIZE, SIZE)
    np.testing.assert_allclose(value, jvalue, rtol=0, atol=1e-3)
    np.testing.assert_allclose(x, np.asarray(jx), rtol=1e-3, atol=2e-4)
