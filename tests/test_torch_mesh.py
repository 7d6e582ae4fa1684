"""The port's mesh (training/sharding.py: Mesh, make_mesh and the inference
helpers) and the sharded Evaluator, searches and RestorationService in one
process, against their unsharded runs and against the JAX package's
sharded ones on the same weights.

Two shards on the CPU come from a mesh that names the CPU twice
(``make_mesh(devices=["cpu", "cpu"])``); the JAX side runs on the 8
virtual CPU devices of tests/conftest.py. The stop output T of the random
policy is biased to -3, so no episode's length sits at the stop threshold.

Bands: the sharded port against the unsharded port, rewards within
rtol/atol 1e-4 and episode lengths equal (tests/test_sharded_eval.py);
against JAX, the rollout band of PARITY.md (0.05 dB, lengths equal); the
searches within 0.05 dB of the unsharded search, and the device search's
traces identical to the JAX sharded search's under a quantized scorer;
the service's images within 1e-5 of the unsharded service's
(tests/test_serving.py)."""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dt4image_restoration_tpu.config as jconfig
from dt4image_restoration_tpu.config import ModelConfig as JModelConfig
from dt4image_restoration_tpu.config import MCTSConfig as JMCTSConfig
from dt4image_restoration_tpu.inference import Evaluator as JEvaluator
from dt4image_restoration_tpu.inference.mcts import MCTS as JMCTS
from dt4image_restoration_tpu.inference.mcts_device import (
    DeviceMCTS as JDeviceMCTS)
from dt4image_restoration_tpu.models.decision_transformer import (
    init_dt_params as j_init_dt_params, make_dt_apply as j_make_dt_apply)
from dt4image_restoration_tpu.training import make_mesh as j_make_mesh
from dt4image_restoration_tpu.training.sharding import (
    padded_per_process as j_padded_per_process)
import dt4image_restoration_tpu_torch.config as config
import dt4image_restoration_tpu_torch.serving as serving
from dt4image_restoration_tpu_torch.config import MCTSConfig, ModelConfig
from dt4image_restoration_tpu_torch.data import make_mat_record
from dt4image_restoration_tpu_torch.inference import (BatchedMCTS,
                                                      DeviceMCTS, Evaluator)
from dt4image_restoration_tpu_torch.models import (DecisionTransformer,
                                                   proxy_value_fn,
                                                   proxy_value_fn_batched)
from dt4image_restoration_tpu_torch.serving import (RestorationRequest,
                                                    RestorationService)
from dt4image_restoration_tpu_torch.training import sharding
from dt4image_restoration_tpu_torch.training.sharding import (
    Mesh, gather_eval_outputs, local_output_offset, make_mesh,
    padded_per_process, prefetch_to_device, replicate, shard_eval_inputs,
    sync_processes)
from dt4image_restoration_tpu_torch.utils.convert import (dt_from_jax,
                                                          load_strict)
from torch_port_common import one_torch_thread  # noqa: F401
from torch_port_common import shared_denoisers

SIZE = 36
CFG_KW = dict(block_size=18, n_embeds=9, embed_dim=32, n_heads=4,
              n_blocks=2, image_size=SIZE)
MAXT = 8
WAIT = 120   # seconds any one future or thread may take
CPU2 = ["cpu", "cpu"]


def stub_denoise(img, sigma):
    return torch.clamp(0.85 * img + 0.05 + 0.1 * sigma[:, None, None, None],
                       0.0, 1.0)


def j_stub_denoise(img, sigma):
    return jnp.clip(0.85 * img + 0.05 + 0.1 * sigma[:, None, None, None],
                    0.0, 1.0)


def hashed(x):
    """A deterministic score that jumps up and down between rollouts and
    that float reordering cannot move: the quantized mean, hashed."""
    return torch.remainder(torch.round(x.mean(dim=(1, 2)) * 1e3) * 37.0,
                           97.0)


def _record(seed):
    mat = dict(make_mat_record(size=SIZE, seed=seed))
    states = mat["x0"][..., 0].reshape(1, -1).astype(np.float32)
    mat["x0"] = np.clip(mat["x0"], 0, None)
    return ((states, np.full((1, 1), 0.6, np.float32),
             np.zeros(3, np.float32), np.asarray([2], np.int32)), mat)


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


# -- configuration and arithmetic --------------------------------------------

@pytest.mark.parametrize("module", ["config", "training",
                                    "training.sharding"])
def test_port_has_the_documented_names(module):
    import importlib

    from test_api_surface import DOCUMENTED
    names = set(DOCUMENTED[f"dt4image_restoration_tpu.{module}"])
    port = importlib.import_module(f"dt4image_restoration_tpu_torch.{module}")
    assert sorted(n for n in names if not hasattr(port, n)) == []

@pytest.mark.parametrize("name", ["DenoiserConfig", "MeshConfig", "Config"])
def test_config_matches_jax(name):
    """The port's dataclass has the JAX one's field names and defaults."""
    ours, theirs = getattr(config, name), getattr(jconfig, name)
    assert [f.name for f in dataclasses.fields(ours)] \
        == [f.name for f in dataclasses.fields(theirs)]
    assert dataclasses.asdict(ours()) == dataclasses.asdict(theirs())


@pytest.mark.parametrize("n_data", [1, 2, 4])
def test_padding_arithmetic_matches_jax(n_data):
    """padded_per_process and local_padded_count on meshes of 1, 2 and 4
    data shards, as the JAX package computes them."""
    mesh = make_mesh(devices=["cpu"] * n_data)
    jmesh = j_make_mesh(n_data=n_data)
    assert mesh.shape == {"data": n_data, "model": 1} == dict(jmesh.shape)
    for n in range(1, 11):
        assert padded_per_process(n, mesh) \
            == j_padded_per_process(n, jmesh)
        want = JMCTS.local_padded_count(types.SimpleNamespace(mesh=jmesh), n)
        got = BatchedMCTS.local_padded_count(
            types.SimpleNamespace(mesh=mesh), n)
        assert got == want == n + (-n) % n_data


def test_make_mesh_validates():
    # One process holds no model axis: the port runs a model shard per
    # process (JAX's GSPMD splits one process's devices).
    with pytest.raises(ValueError, match="torchrun"):
        make_mesh(n_model=2, devices=CPU2)
    with pytest.raises(ValueError, match="must equal"):
        make_mesh(n_data=3, devices=CPU2)
    mesh = make_mesh(n_data=2, devices=CPU2)
    assert mesh.devices == (torch.device("cpu"),) * 2
    assert mesh.distinct_devices == [torch.device("cpu")]


def test_make_mesh_defaults_to_the_card(monkeypatch):
    """Without devices the mesh is every visible GPU: no quiet CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        make_mesh()


def test_shard_and_gather_round_trip():
    """shard_eval_inputs splits a tree over the local shards (numpy leaves
    become tensors); gather_eval_outputs joins the shards on the host, in
    order, along the axis asked for; without a mesh the tree is one shard
    on the device asked for."""
    mesh = make_mesh(devices=CPU2)
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    parts = shard_eval_inputs({"x": x, "t": (torch.arange(4), None)}, mesh)
    assert len(parts) == 2
    np.testing.assert_array_equal(parts[1]["x"].numpy(), x[2:])
    assert parts[0]["t"][1] is None
    joined = gather_eval_outputs([(p["x"], p["t"][0]) for p in parts], mesh)
    np.testing.assert_array_equal(joined[0], x)
    np.testing.assert_array_equal(joined[1], np.arange(4))
    cols = shard_eval_inputs(x.T.copy(), mesh, axis=1)
    np.testing.assert_array_equal(
        gather_eval_outputs(cols, mesh, axis=1), x.T)
    assert isinstance(gather_eval_outputs([torch.ones(2)]), np.ndarray)
    with pytest.raises(ValueError, match="does not split"):
        shard_eval_inputs(np.zeros(3), mesh)
    (whole,) = shard_eval_inputs({"x": x}, None, device="cpu")
    assert isinstance(whole["x"], torch.Tensor)
    np.testing.assert_array_equal(gather_eval_outputs([whole["x"]]), x)
    # One process: no barrier, offset 0.
    sync_processes("test")
    assert local_output_offset(4, mesh) == 0


def test_barrier_failure_names_the_barrier_and_the_cause(monkeypatch):
    """On several processes a failed barrier raises a RuntimeError naming
    dt4ir_<tag>_<n> and the desynced sequence, as the JAX message does."""
    def fail(group, timeout):
        assert timeout.total_seconds() == sharding.BARRIER_TIMEOUT_S
        raise RuntimeError("rank 1 failed to pass monitoredBarrier")
    monkeypatch.setattr(sharding, "process_count", lambda: 2)
    monkeypatch.setattr(sharding, "host_group", lambda: None)
    monkeypatch.setattr(sharding.dist, "monitored_barrier", fail)
    monkeypatch.setattr(sharding, "_SYNC_COUNTER", [6])
    with pytest.raises(RuntimeError, match=r"'dt4ir_eval_7' failed: rank 1 "
                       r".*desynced"):
        sync_processes("eval")


def test_gather_without_a_mesh_issues_no_collective(monkeypatch):
    """A per-process serving queue in a multi-process job (mesh=None)
    places its inputs and fetches its own outputs: no barrier, no gather,
    no offset."""
    def collective(*args, **kw):
        raise AssertionError("a collective was issued")
    monkeypatch.setattr(sharding, "process_count", lambda: 2)
    monkeypatch.setattr(sharding.dist, "all_gather_object", collective)
    monkeypatch.setattr(sharding.dist, "monitored_barrier", collective)
    (inputs,) = shard_eval_inputs((np.arange(3), np.ones(2)), None,
                                  device="cpu")
    out = gather_eval_outputs([inputs])
    np.testing.assert_array_equal(out[0], [0, 1, 2])
    assert local_output_offset(3) == 0


def test_mesh_shape_counts_every_process(monkeypatch):
    """A mesh's fields are its local devices, its model axis and that
    axis's groups; its data axis is those devices times the processes
    (over the model axis), however the mesh was built, so the padding unit
    and the per-process share agree with the split."""
    assert [f.name for f in dataclasses.fields(Mesh)] \
        == ["devices", "n_model", "data_group", "model_group"]
    monkeypatch.setattr(sharding, "process_count", lambda: 2)
    mesh = Mesh(devices=(torch.device("cpu"),) * 2)
    assert mesh.shape == {"data": 4, "model": 1}
    assert padded_per_process(5, mesh) == 4
    assert BatchedMCTS.local_padded_count(
        types.SimpleNamespace(mesh=mesh), 3) == 4


@pytest.mark.parametrize("grad", [False, True])
def test_run_sharded_threads_over_distinct_devices(grad):
    """Shards on distinct devices run on a host thread per device, in
    shard order within a device, with the caller's grad mode; results come
    back in shard order, and the first failing shard's error is raised."""
    import threading
    cpu, meta = torch.device("cpu"), torch.device("meta")
    devices = [cpu, meta, cpu, meta]
    seen = []

    def fn(i):
        seen.append((i, threading.current_thread().name,
                     torch.is_grad_enabled()))
        return 10 * i
    with torch.set_grad_enabled(grad):
        out = sharding.run_sharded(fn, devices, [(i,) for i in range(4)])
    assert out == [0, 10, 20, 30]
    assert all(g == grad for _, _, g in seen)
    thread = {i: name for i, name, _ in seen}
    assert thread[0] == thread[2] != thread[1] == thread[3]
    assert threading.current_thread().name not in thread.values()
    order = [i for i, _, _ in seen]
    assert order.index(0) < order.index(2) and \
        order.index(1) < order.index(3)

    def fail(i):
        if i >= 1:
            raise ValueError(f"shard {i}")
        return i
    with pytest.raises(ValueError, match="shard 1"):
        sharding.run_sharded(fail, devices, [(i,) for i in range(4)])


def test_prefetch_to_device_splits_each_batch():
    mesh = make_mesh(devices=CPU2)
    batches = [{"a": np.full((4, 2), i, np.float32)} for i in range(3)]
    out = list(prefetch_to_device(iter(batches), mesh, size=3))
    assert len(out) == 3 and all(len(b) == 2 for b in out)
    assert out[2][1]["a"].shape == (2, 2) and float(out[2][1]["a"][0, 0]) \
        == 2.0


def test_replicate_shares_a_device_and_passes_callables():
    mesh = make_mesh(devices=CPU2)
    module = torch.nn.Linear(2, 2)
    copies = replicate(module, mesh)
    assert copies[0] is module and copies[1] is module
    assert replicate(stub_denoise, mesh) == [stub_denoise] * 2


def test_replicate_copies_to_other_devices():
    """A module meets a device it is not on: a deep copy moved there, one
    per device, each with its own weight caches. (Two CPU devices cannot
    exist, so the mesh is built by hand with a fake second device.)"""
    module = torch.nn.Linear(2, 2)
    mesh = Mesh(devices=(torch.device("cpu"), torch.device("meta"),
                         torch.device("meta")))
    copies = replicate(module, mesh)
    assert copies[0] is module and copies[1] is copies[2]
    assert copies[1] is not module and copies[1].weight.device.type == "meta"


def test_cli_scores_each_shard_on_its_own_device(monkeypatch):
    """The mcts verb's batched ARNIQA scorer on a mesh: one scorer per
    local device, each on that device's copy of the model, picked by the
    device of the images it is given."""
    from dt4image_restoration_tpu_torch import __main__ as cli
    from dt4image_restoration_tpu_torch.models import arniqa
    made = []

    def make(model, image_size, dtype):
        made.append(model)
        return lambda x: model(x).sum(dim=(1, 2))
    monkeypatch.setattr(arniqa, "make_value_fn_batched", make)
    model = torch.nn.Identity()
    assert cli._value_fn_batched(model, None, 128, "float32") \
        is not None and made == [model]
    score = cli._value_fn_batched(model, make_mesh(devices=CPU2), 128,
                                  "float32")
    assert made == [model] * 2
    assert score(torch.ones(2, 3, 3)).tolist() == [9.0, 9.0]


# -- the Evaluator -----------------------------------------------------------

def test_sharded_evaluator_matches_unsharded_and_jax(shared):
    """7 records, padded to 8 over 2 CPU shards: the metrics of the
    unsharded run, and the JAX Evaluator's on its own 2-device mesh."""
    jcfg, params, dt = shared
    model_den, j_denoise = shared_denoisers(seed=4, base=8)
    records = [_record(i) for i in range(7)]
    kw = dict(dt=dt, denoise=model_den, cfg=dt.cfg, max_timesteps=MAXT,
              device="cpu")
    plain = Evaluator(**kw).evaluate_records(records)
    sharded = Evaluator(mesh=make_mesh(devices=CPU2),
                        **kw).evaluate_records(records)
    assert sharded["reward"].shape == (7,)
    assert sharded["final_state"].x.shape == (8, 1, SIZE, SIZE)
    np.testing.assert_allclose(sharded["reward"], plain["reward"],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(sharded["episode_len"],
                                  plain["episode_len"])
    np.testing.assert_array_equal(sharded["episode_len"], MAXT)

    jmesh = j_make_mesh(n_data=2)
    with jmesh:
        jm = JEvaluator(dt_apply=j_make_dt_apply(jcfg), dt_params=params,
                        denoise=j_denoise, cfg=jcfg, max_timesteps=MAXT,
                        mesh=jmesh).evaluate_records(records)
    np.testing.assert_array_equal(sharded["episode_len"],
                                  np.asarray(jm["episode_len"]))
    np.testing.assert_allclose(sharded["reward"], np.asarray(jm["reward"]),
                               rtol=0, atol=0.05)
    np.testing.assert_allclose(sharded["increment"],
                               np.asarray(jm["increment"]), rtol=0,
                               atol=0.05)


def test_sharded_evaluator_run_prints_the_unsharded_aggregates(
        shared, tmp_path, capsys):
    from dt4image_restoration_tpu_torch.data import write_eval_dir
    _, _, dt = shared
    dirs = [write_eval_dir(str(tmp_path / tok), tok, n=3, size=SIZE,
                           seed=10 * i) for i, tok in enumerate(["4_15",
                                                                 "8_5"])]
    outs = []
    for mesh in (None, make_mesh(devices=CPU2)):
        ev = Evaluator(dt=dt, denoise=stub_denoise, cfg=dt.cfg,
                       max_timesteps=MAXT, device="cpu", mesh=mesh)
        total = ev.run(dirs)
        lines = capsys.readouterr().out.splitlines()
        outs.append((total, [float(ln.split()[-1]) for ln in lines]))
    assert len(outs[0][1]) == 6
    np.testing.assert_allclose(outs[1][1], outs[0][1], rtol=1e-4, atol=1e-4)
    assert outs[1][0] == pytest.approx(outs[0][0], rel=1e-4, abs=1e-4)


# -- the searches --------------------------------------------------------------

def _search(cls, dt, mesh, **kw):
    return cls(dt=dt, denoise=stub_denoise, model_cfg=dt.cfg,
               cfg=MCTSConfig(iterations=3, max_timesteps=MAXT),
               value_fn=proxy_value_fn, device="cpu", mesh=mesh, **kw)


@pytest.mark.parametrize("cls", [BatchedMCTS, DeviceMCTS])
def test_sharded_search_drops_padding_and_matches_unsharded(
        shared, cls, capsys):
    """3 trees on 2 CPU shards (padded to 4): 3 rewards, two runs equal,
    and within the search band (0.05 dB) of the unsharded search."""
    _, _, dt = shared
    records, seeds = [_record(i) for i in range(3)], [5, 6, 7]
    mesh = make_mesh(devices=CPU2)
    kw = {"verbose": False} if cls is DeviceMCTS else {}
    a = _search(cls, dt, mesh).run_batch(records, seeds=seeds, **kw)
    b = _search(cls, dt, mesh).run_batch(records, seeds=seeds, **kw)
    plain = _search(cls, dt, None).run_batch(records, seeds=seeds, **kw)
    capsys.readouterr()
    assert len(a) == 3 and a == b
    np.testing.assert_allclose(a, plain, rtol=0, atol=0.05)


def test_sharded_device_search_matches_jax_sharded_search(shared):
    """The device search on 2 CPU shards against the JAX DeviceMCTS on a
    2-device mesh: 3 trees (padded to 4), 3 rounds, a three-step horizon
    and context, the hashed scorer. Traces identical, final PSNR within
    1e-5 relative; detailed results drop the padding too."""
    _, params, _ = shared
    jcfg = JModelConfig(**dict(CFG_KW, block_size=9))
    cfg = ModelConfig(**dict(CFG_KW, block_size=9), use_pallas=True)
    dt = load_strict(DecisionTransformer(cfg), dt_from_jax(params, cfg),
                     "dt").eval().requires_grad_(False)
    records, seeds = [_record(i) for i in (3, 8, 9)], [21, 22, 23]
    jmesh = j_make_mesh(n_data=2)
    jm = JDeviceMCTS(
        dt_apply=j_make_dt_apply(jcfg), dt_params=params,
        denoise=j_stub_denoise, model_cfg=jcfg,
        cfg=JMCTSConfig(iterations=3, max_timesteps=3),
        value_fn=lambda x: 0.0,
        value_fn_jax=lambda x: jnp.mod(
            jnp.round(jnp.mean(x, axis=(1, 2)) * 1e3) * 37.0, 97.0),
        record_trace=True, mesh=jmesh)
    with jmesh:
        want = jm.run_batch(records, seeds=seeds, verbose=False)
    m = DeviceMCTS(dt=dt, denoise=stub_denoise, model_cfg=cfg,
                   cfg=MCTSConfig(iterations=3, max_timesteps=3),
                   value_fn=proxy_value_fn, value_fn_batched=hashed,
                   record_trace=True, device="cpu",
                   mesh=make_mesh(devices=CPU2))
    got = m.run_batch(records, seeds=seeds, detailed=True, verbose=False)
    assert len(got) == len(m.traces) == 3
    key = ("iter", "time", "edge", "index")
    for ours, theirs in zip(m.traces, jm.traces):
        assert [[e[k] for k in key] for e in ours] \
            == [[e[k] for k in key] for e in theirs]
    np.testing.assert_allclose([g["reward"] for g in got], want, rtol=1e-5)
    assert got[2]["image"].shape == (SIZE, SIZE)


# -- the service ---------------------------------------------------------------

def _requests(n):
    return [RestorationRequest(mat=make_mat_record(size=SIZE, seed=i),
                               rtg=0.6, task=2) for i in range(n)]


def _restore(svc, requests):
    try:
        return svc.restore(requests, timeout=WAIT)
    finally:
        svc.close(timeout=WAIT)


@pytest.mark.parametrize("mode", ["fixed", "policy", "mcts"])
def test_sharded_service_matches_unsharded(shared, mode):
    """6 requests at batch 8 (padding and sharding together) on 2 CPU
    shards: the unsharded service's images, lengths and PSNRs."""
    _, _, dt = shared
    kw = dict(denoise=stub_denoise, mode=mode, batch_size=8,
              max_timesteps=MAXT, device="cpu")
    if mode != "fixed":
        kw["dt"] = dt
    if mode == "mcts":
        kw.update(search_cfg=MCTSConfig(iterations=2, max_timesteps=MAXT),
                  value_fn_batched=proxy_value_fn_batched)
    reqs = _requests(6)
    want = _restore(RestorationService(**kw), reqs)
    got = _restore(RestorationService(mesh=make_mesh(devices=CPU2), **kw),
                   reqs)
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.image, a.image, rtol=1e-4, atol=1e-5)
        assert a.episode_len == b.episode_len
        np.testing.assert_allclose(b.psnr_db, a.psnr_db, rtol=1e-4)


def test_service_mesh_checks(monkeypatch):
    mesh = make_mesh(devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="multiple of the mesh data axis"):
        RestorationService(denoise=stub_denoise, mode="fixed", batch_size=6,
                           device="cpu", mesh=mesh)
    monkeypatch.setattr(serving, "process_count", lambda: 2)
    with pytest.raises(ValueError, match="single-process only"):
        RestorationService(denoise=stub_denoise, mode="fixed", batch_size=8,
                           device="cpu", mesh=mesh)


def test_host_group_is_made_once_per_process_group(monkeypatch):
    """host_group creates its Gloo group once per default group (new_group
    is collective: a second creation on one rank would desync them)."""
    made = []
    monkeypatch.setattr(sharding.dist, "new_group",
                        lambda backend: made.append(backend) or object())
    world = object()
    monkeypatch.setattr(sharding.dist, "group",
                        types.SimpleNamespace(WORLD=world))
    monkeypatch.setattr(sharding, "_HOST_GROUP", {})
    g = sharding.host_group()
    assert sharding.host_group() is g and made == ["gloo"]
    sharding.dist.group.WORLD = object()
    assert sharding.host_group() is not g and made == ["gloo", "gloo"]
