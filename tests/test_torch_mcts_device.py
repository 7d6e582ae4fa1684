"""The port's device-resident tree search (inference/mcts_device.py) against
the JAX package's DeviceMCTS and against the port's own host-tree search,
on shared weights (JAX init carried over by utils/convert.py:dt_from_jax)
and shared RNG streams.

As in tests/test_mcts_device.py, the value functions quantize the mean of
the image, so that float reordering between implementations cannot flip a
PUCB decision and traces can be held equal; the hash scorer makes rewards
jump up and down, so max-backprop must reach ancestors for the traces to
agree. The stop output T of the random policy is biased to -3, so no
rollout's length sits at the stop threshold.

Bands: traces (depth, edge, round) identical; rollout rewards and final
PSNR within 1e-5 relative against JAX; the port's two backends equal.
Priors within 1e-4 relative against JAX, the band tests/test_torch_mcts.py
holds the host search to: the JAX device search draws its normals and
densities in float32 where both port backends use float64, and at the mu
std of 0.001 float32 rounding of loc + std z moves a prior by up to ~3e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dt4image_restoration_tpu.config import MCTSConfig as JMCTSConfig
from dt4image_restoration_tpu.config import ModelConfig as JModelConfig
from dt4image_restoration_tpu.inference.mcts_device import (
    DeviceMCTS as JDeviceMCTS, max_backprop as j_max_backprop)
from dt4image_restoration_tpu.models.arniqa import (
    proxy_value_fn_jax as j_proxy_value_fn_batched)
from dt4image_restoration_tpu.models.decision_transformer import (
    init_dt_params as j_init_dt_params, make_dt_apply as j_make_dt_apply)
from dt4image_restoration_tpu_torch.config import MCTSConfig, ModelConfig
from dt4image_restoration_tpu_torch.data import make_mat_record
from dt4image_restoration_tpu_torch.inference import (MCTS, DeviceMCTS,
                                                      max_backprop)
from dt4image_restoration_tpu_torch.models import (DecisionTransformer,
                                                   proxy_value_fn,
                                                   proxy_value_fn_batched)
from dt4image_restoration_tpu_torch.utils.convert import (dt_from_jax,
                                                          load_strict)
from torch_port_common import one_torch_thread  # noqa: F401

SIZE = 36
CFG_KW = dict(block_size=18, n_embeds=9, embed_dim=32, n_heads=4,
              n_blocks=2, image_size=SIZE)


def stub_denoise(img, sigma):
    return torch.clamp(0.85 * img + 0.05 + 0.1 * sigma[:, None, None, None],
                       0.0, 1.0)


def j_stub_denoise(img, sigma):
    return jnp.clip(0.85 * img + 0.05 + 0.1 * sigma[:, None, None, None],
                    0.0, 1.0)


def quantized(x):
    """(B, H, W) -> (B,): the mean, quantized."""
    return torch.round(x.mean(dim=(1, 2)) * 1e3) / 10.0


def hashed(x):
    """A deterministic score that jumps up and down between rollouts."""
    return torch.remainder(torch.round(x.mean(dim=(1, 2)) * 1e3) * 37.0,
                           97.0)


def big(x):
    """Scores ~1500: fresh children (reward 0) sit ~1500 under their
    parent, below the -1000 PUCB floor, until visits lift them over."""
    return 1500.0 + torch.remainder(torch.round(x.mean(dim=(1, 2)) * 1e3)
                                    * 37.0, 7.0)


def huge(x):
    """Scores ~1e9: floor recovery would take far more than the descent's
    bound of retries, so the device search gives up."""
    return 1e9 + torch.round(x.mean(dim=(1, 2)) * 1e3)


def host_scorer(batched):
    """The host search's (1, H, W) -> float twin of a batched scorer."""
    def value(x):
        x = torch.as_tensor(np.asarray(x, np.float32))
        return float(batched(x.reshape(1, *x.shape[-2:]))[0])
    return value


def _record(seed):
    mat = dict(make_mat_record(size=SIZE, seed=seed))
    mat["x0"] = np.clip(mat["x0"], 0, None)
    states = mat["x0"][..., 0].reshape(1, -1).astype(np.float32)
    return (states, np.full((1, 1), 0.6, np.float32), np.zeros(3, np.float32),
            np.asarray([2], np.int32)), mat


@pytest.fixture(scope="module")
def shared():
    """(jax cfg, jax params, port cfg, port DT) on the same weights."""
    jcfg = JModelConfig(**CFG_KW)
    params = jax.tree.map(np.array, j_init_dt_params(jcfg, seed=0))
    params["predict_action"]["bias"][0] = -3.0   # norm mode: T is col 0
    cfg = ModelConfig(**CFG_KW, use_pallas=True)
    dt = load_strict(DecisionTransformer(cfg), dt_from_jax(params, cfg),
                     "dt").eval().requires_grad_(False)
    return jcfg, params, cfg, dt


def _backends(shared, value, block_size=18, **search_kw):
    """The port's host and device searches on the same scorer."""
    cfg = ModelConfig(**dict(CFG_KW, block_size=block_size),
                      use_pallas=True)
    dt = load_strict(DecisionTransformer(cfg), shared[3].state_dict(),
                     "dt").eval().requires_grad_(False)
    kw = dict(dt=dt, denoise=stub_denoise, model_cfg=cfg,
              cfg=MCTSConfig(**search_kw), value_fn=host_scorer(value),
              record_trace=True, device="cpu")
    return MCTS(**kw), DeviceMCTS(value_fn_batched=value, **kw)


KEY = ("iter", "time", "edge", "index")


def _same_traces(a, b):
    for x, y in zip(a, b):
        assert [[e[k] for k in KEY] for e in x] \
            == [[e[k] for k in KEY] for e in y]


def test_device_search_matches_jax_device_search(shared):
    """Two trees, six rounds, a three-step horizon and context."""
    _, params, _, _ = shared
    jcfg = JModelConfig(**dict(CFG_KW, block_size=9))
    records, seeds = [_record(3), _record(8)], [21, 22]
    jm = JDeviceMCTS(
        dt_apply=j_make_dt_apply(jcfg), dt_params=params,
        denoise=j_stub_denoise, model_cfg=jcfg,
        cfg=JMCTSConfig(iterations=6, max_timesteps=3),
        value_fn=lambda x: 0.0,
        value_fn_jax=lambda x: jnp.mod(
            jnp.round(jnp.mean(x, axis=(1, 2)) * 1e3) * 37.0, 97.0),
        record_trace=True)
    want = jm.run_batch(records, seeds=seeds, verbose=False)
    _, m = _backends(shared, hashed, 9, iterations=6, max_timesteps=3)
    got = m.run_batch(records, seeds=seeds, verbose=False)
    assert len({e["reward"] for e in m.traces[0]}) > 1
    _same_traces(m.traces, jm.traces)
    for ours, theirs in zip(m.traces, jm.traces):
        for a, b in zip(ours, theirs):
            np.testing.assert_allclose(a["probs"], b["probs"], rtol=1e-4)
            np.testing.assert_allclose(a["reward"], b["reward"], rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("value,block_size,search_kw", [
    (quantized, 18, dict(iterations=4, max_timesteps=8)),
    (hashed, 9, dict(iterations=8, max_timesteps=3)),
    (hashed, 6, dict(iterations=10, max_timesteps=2)),
])
def test_device_search_matches_host_search(shared, capsys, value,
                                           block_size, search_kw):
    """Two trees on both backends: identical traces, rewards and results.
    With a two-step horizon (and a two-step context) the search expands
    leaves at the horizon."""
    host, device = _backends(shared, value, block_size, **search_kw)
    records, seeds = [_record(3), _record(8)], [21, 22]
    want = host.run_batch(records, seeds=seeds)
    got = device.run_batch(records, seeds=seeds)
    _same_traces(device.traces, host.traces)
    for ours, theirs in zip(device.traces, host.traces):
        for a, b in zip(ours, theirs):
            np.testing.assert_allclose(a["probs"], b["probs"], rtol=1e-6)
            assert a["reward"] == b["reward"]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    depth = max(e["time"] for e in device.traces[0])
    if search_kw["max_timesteps"] == 2:
        assert depth >= 2
    if value is hashed:
        rewards = [e["reward"] for e in host.traces[0]]
        assert any(b > a for a, b in zip(rewards, rewards[1:]))
    assert capsys.readouterr().out.count("MCTS Reward: ") == 4


def test_device_search_uncached_encoder_matches_host(shared):
    _, _, cfg, dt = shared
    kw = dict(dt=dt, denoise=stub_denoise, model_cfg=cfg,
              cfg=MCTSConfig(iterations=4, max_timesteps=8),
              value_fn=host_scorer(hashed), record_trace=True,
              cached_encoder=False, device="cpu")
    host, device = MCTS(**kw), DeviceMCTS(value_fn_batched=hashed, **kw)
    r = _record(12)
    want = host.run_batch([r], seeds=[17])
    got = device.run_batch([r], seeds=[17], verbose=False)
    _same_traces(device.traces, host.traces)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_floor_trip_recovery_matches_host(shared):
    """Rewards of ~1500 put fresh children under the -1000 floor: the host
    loop re-selects the node and inflates its visits until a child clears
    the floor, and the device's retry lanes must follow it."""
    host, device = _backends(shared, big, 9, iterations=5, max_timesteps=3)
    r = _record(9)
    want = host.run_batch([r], seeds=[41])
    got = device.run_batch([r], seeds=[41], verbose=False)
    _same_traces(device.traces, host.traces)
    assert max(e["time"] for e in device.traces[0]) >= 2
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_selection_give_up_warns(shared):
    """Past the descent's bound the device search gives up floor recovery,
    says on which trees, and still returns a finite score."""
    _, device = _backends(shared, huge, iterations=2, max_timesteps=8)
    with pytest.warns(RuntimeWarning,
                      match=r"gave up floor recovery on trees \[0, 1\]"):
        out = device.run_batch([_record(3), _record(4)], seeds=[7, 8],
                               verbose=False)
    assert np.isfinite(out).all()


def test_max_backprop_reaches_ancestors():
    """A reward that improves an interior ancestor propagates up the chain
    and stops at the first ancestor it does not improve."""
    parent = torch.tensor([[-1, 0, 1, -1], [-1, 0, 1, -1]])
    reward = torch.tensor([[5.0, 3.0, 0.0, 0.0], [1.0, 3.0, 0.0, 0.0]])
    out = max_backprop(reward, parent, torch.tensor([2, 2]),
                       torch.tensor([4.0, 4.0]))
    np.testing.assert_array_equal(out[0].numpy(), [5.0, 4.0, 4.0, 0.0])
    np.testing.assert_array_equal(out[1].numpy(), [4.0, 4.0, 4.0, 0.0])
    np.testing.assert_array_equal(reward[0].numpy(), [5.0, 3.0, 0.0, 0.0])


@pytest.mark.parametrize("seed", range(4))
def test_max_backprop_matches_jax_on_random_trees(seed):
    rng = np.random.default_rng(seed)
    n, n_nodes = 6, 16
    parent = np.full((n, n_nodes), -1, np.int32)
    for k in range(1, n_nodes):
        parent[:, k] = rng.integers(0, k, n)
    reward = rng.normal(size=(n, n_nodes)).astype(np.float32)
    leaf = rng.integers(0, n_nodes, n).astype(np.int32)
    r = rng.normal(size=n).astype(np.float32) + 1.0
    want = np.asarray(j_max_backprop(jnp.asarray(reward), jnp.asarray(parent),
                                     jnp.asarray(leaf), jnp.asarray(r)))
    got = max_backprop(torch.from_numpy(reward), torch.from_numpy(parent),
                       torch.from_numpy(leaf), torch.from_numpy(r))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not np.array_equal(want, reward)


def test_bfloat16_node_storage_within_band(shared):
    """Node states stored in bfloat16 (computed in float32 after the
    gather): the result within 0.05 dB of float32 storage."""
    _, _, cfg, dt = shared
    kw = dict(dt=dt, denoise=stub_denoise, model_cfg=cfg,
              cfg=MCTSConfig(iterations=4, max_timesteps=8),
              value_fn=host_scorer(quantized), value_fn_batched=quantized,
              device="cpu")
    records, seeds = [_record(2), _record(6)], [3, 4]
    f32 = DeviceMCTS(**kw).run_batch(records, seeds=seeds, verbose=False)
    b16 = DeviceMCTS(node_dtype="bfloat16", **kw).run_batch(
        records, seeds=seeds, verbose=False)
    assert np.isfinite(b16).all()
    np.testing.assert_allclose(b16, f32, rtol=0, atol=0.05)
    with pytest.raises(ValueError, match="node_dtype"):
        DeviceMCTS(node_dtype="float16", **kw)


def test_single_tree_equals_batched(shared):
    _, device = _backends(shared, hashed, iterations=4, max_timesteps=8)
    r = _record(4)
    solo = device.run_batch([r], seeds=[9], verbose=False)
    twins = device.run_batch([r, _record(1), r], seeds=[9, 2, 9],
                             verbose=False)
    assert twins[0] == twins[2]
    np.testing.assert_allclose(solo[0], twins[0], rtol=1e-6)


def test_detailed_results_and_chunked_batches(shared):
    """detailed=True returns the best rollout's image, whose PSNR is the
    reward, and its episode length; run_global_batches equals chunked
    run_batch calls in record order."""
    _, device = _backends(shared, quantized, iterations=2, max_timesteps=8)
    records, seeds = [_record(s) for s in range(3)], [0, 1, 2]
    detailed = device.run_batch(records, seeds=seeds, detailed=True,
                                verbose=False)
    for d, (_, mat) in zip(detailed, records):
        assert d["image"].shape == (SIZE, SIZE)
        assert 1 <= d["episode_len"] <= 8
        mse = np.mean((np.clip(d["image"], 0, 1)
                       - mat["gt"].reshape(SIZE, SIZE)) ** 2)
        np.testing.assert_allclose(d["reward"], 10 * np.log10(1 / mse),
                                   rtol=1e-5)
    want = [d["reward"] for d in detailed[:2]] + device.run_batch(
        records[2:], seeds=seeds[2:], verbose=False)
    assert device.run_global_batches(records, seeds, batch_size=2) == want


@pytest.mark.parametrize("seed", range(3))
def test_batched_proxy_matches_jax_and_host(seed):
    x = np.random.default_rng(seed).uniform(0, 1, (3, SIZE, SIZE)).astype(
        np.float32)
    want = np.asarray(j_proxy_value_fn_batched(jnp.asarray(x)))
    got = proxy_value_fn_batched(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(got, [proxy_value_fn(v[None]) for v in x],
                               rtol=1e-5)
