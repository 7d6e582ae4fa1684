"""The port's training over a model axis against the JAX package's
tensor-parallel training. One spawn of 4 Gloo ranks on the CPU, a mesh of
data 2 x model 2 (tests/torch_tp_worker.py:rank_main), serves every case;
the JAX side runs here on 4 of the 8 virtual CPU devices of conftest.py.

  * ``param_partition_spec`` names the parameters that JAX's splits, and
    ``shard_params`` then ``gather_params`` returns the weights bit for
    bit;
  * 3 tensor-parallel updates (dropout off, warmup 2) against JAX's
    ``make_train_step`` on ``shard_params(tensor_parallel=True)`` over
    ``make_mesh(n_data=2, n_model=2)``, and again with the clip active;
  * at dropout 0.1, the tensor-parallel step against the port's unsharded
    step on the same rows (data-parallel over the mesh's data axis): equal
    only if every dropout mask is;
  * a tensor-parallel stop and resume equals a straight run, and its
    resume state loads into an unsharded trainer;
  * the multichip dry run's three stages (tools/dryrun_multichip.py).

Bands (PARITY.md, the training band): loss 1e-5 relative; every parameter
tensor within 2e-4 as the norm of its error over its norm; resume 1e-6.
"""
import dataclasses
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dt4image_restoration_tpu.config import ModelConfig as JModelConfig
from dt4image_restoration_tpu.config import TrainerConfig as JTrainerConfig
from dt4image_restoration_tpu.models.decision_transformer import (
    init_dt_params as j_init_dt_params, make_dt_apply as j_make_dt_apply)
from dt4image_restoration_tpu.training import TrainState as JTrainState
from dt4image_restoration_tpu.training import (
    make_mesh as j_make_mesh, make_optimizer as j_make_optimizer,
    make_train_step as j_make_train_step, shard_batch as j_shard_batch,
    shard_params as j_shard_params)
from dt4image_restoration_tpu.training.sharding import (
    param_partition_spec as j_param_partition_spec)
from dt4image_restoration_tpu.training.trainer import loss_fn as j_loss_fn
from dt4image_restoration_tpu_torch.config import ModelConfig, TrainerConfig
from dt4image_restoration_tpu_torch.models import DecisionTransformer
from dt4image_restoration_tpu_torch.training import (init_train_state,
                                                     param_partition_spec)
from dt4image_restoration_tpu_torch.utils.checkpoint import \
    restore_checkpoint
from dt4image_restoration_tpu_torch.utils.convert import (dt_from_jax,
                                                          load_strict)
from dt4image_restoration_tpu_torch.utils.loaders import load_dt
from torch_port_common import one_torch_thread  # noqa: F401
from torch_tp_worker import rank_main

SMALL = dict(block_size=18, n_embeds=9, embed_dim=32, n_heads=4,
             n_blocks=2, image_size=36)
T, B = 6, 4
WORLD, JOIN_S = 4, 240
CLIP = 1e-5       # per-element gradients near Adam's eps: the clip shows
JAX_SPECS = [(), (None, "model"), ("model", None)]


def _batch(rng, valid=(6, 4, 2, 5)):
    masks = np.zeros((B, T, 1), np.float32)
    for i in range(B):
        masks[i, :valid[i]] = 1.0
    return {
        "states": rng.uniform(0, 1, (B, T, 36 * 36)).astype(np.float32),
        "actions": (rng.uniform(0, 1, (B, T, 3)) * masks).astype(np.float32),
        "rtg": (rng.uniform(0, 1, (B, T, 1)) * masks).astype(np.float32),
        "traj_masks": masks,
        "timesteps": np.broadcast_to(
            np.arange(T, dtype=np.int32)[None, :, None], (B, T, 1)).copy(),
        "task": rng.integers(0, 9, (B, T)).astype(np.int32),
    }


def _jax_params(seed):
    return jax.tree.map(np.asarray, j_init_dt_params(
        JModelConfig(**SMALL, dropout=0.0, embd_dropout=0.0), seed))


def _inputs():
    cfg = ModelConfig(**SMALL, dropout=0.0, embd_dropout=0.0)
    rng = np.random.default_rng(7)
    return {
        "cfg": cfg,
        "cfg_dropout": dataclasses.replace(cfg, dropout=0.1,
                                           embd_dropout=0.1),
        "weights": dt_from_jax(_jax_params(0), cfg),
        "weights_other": dt_from_jax(_jax_params(1), cfg),
        "batches": [_batch(rng) for _ in range(3)],
        "batches4": [_batch(rng) for _ in range(4)],
        "tcfg": TrainerConfig(warmup_steps=2),
        "tcfg_clip": TrainerConfig(warmup_steps=2, grad_norm_clipping=CLIP),
        "tcfg_resume": TrainerConfig(max_epochs=1, warmup_steps=2,
                                     save_every=1),
    }


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Spawn the four ranks once: (inputs, rank results, their dir)."""
    root = tmp_path_factory.mktemp("tensor_parallel")
    data = _inputs()
    torch.save(data, root / "inputs.pt")
    ctx = torch.multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=rank_main,
                         args=(r, WORLD, port, str(root / "inputs.pt"),
                               str(root)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=JOIN_S)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join(5)
    assert not alive, f"a rank did not finish within {JOIN_S} s"
    assert [p.exitcode for p in procs] == [0] * WORLD
    ranks = [torch.load(root / f"rank.{r}", weights_only=False)
             for r in range(WORLD)]
    return data, ranks, root


def _leaf_close(got, ref, rtol, what):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    err = float(np.linalg.norm(got - ref))
    assert err <= rtol * float(np.linalg.norm(ref)), \
        f"{what}: error norm {err} over {rtol} x {np.linalg.norm(ref)}"


def _params_close(got, ref, rtol, what=""):
    assert set(got) == set(ref)
    for name in ref:
        _leaf_close(got[name], ref[name], rtol, f"{what} {name}")


def _jax_updates(data, tcfg):
    """JAX's tensor-parallel train step over a (data 2, model 2) mesh:
    (losses, the weights after the updates in the port's layout)."""
    jcfg = JModelConfig(**SMALL, dropout=0.0, embd_dropout=0.0)
    jt = JTrainerConfig(warmup_steps=2,
                        grad_norm_clipping=tcfg.grad_norm_clipping)
    params = jax.tree.map(jnp.asarray, _jax_params(0))
    optimizer = j_make_optimizer(jt, 10, params)
    mesh = j_make_mesh(n_data=2, n_model=2, devices=jax.devices()[:4])
    losses = []
    with mesh:
        tp = j_shard_params(params, mesh, tensor_parallel=True)
        state = JTrainState(params=tp, opt_state=optimizer.init(tp),
                            step=jnp.zeros((), jnp.int32))
        step = j_make_train_step(j_make_dt_apply(jcfg, train=True),
                                 optimizer)
        for i, b in enumerate(data["batches"]):
            state, loss = step(state, j_shard_batch(b, mesh),
                               jax.random.PRNGKey(i))
            losses.append(float(loss))
    cfg = data["cfg"]
    return losses, dt_from_jax(jax.tree.map(np.asarray, state.params), cfg)


def test_mesh_places_each_rank_row_major(run):
    _, ranks, _ = run
    assert [r["place"] for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert all(r["shape"] == {"data": 2, "model": 2} for r in ranks)


def test_partition_spec_names_the_jax_split_parameters(run):
    """(a) The same parameters split as in JAX's spec, each the transpose
    of JAX's (torch weights are (out, in)); the shards hold half of each
    split dim, the biases stay whole."""
    data, ranks, _ = run
    cfg = data["cfg"]
    params = _jax_params(0)
    jspec = j_param_partition_spec(params, tensor_parallel=True)
    # JAX's specs under the port's names: each leaf coded by its spec's
    # index in JAX_SPECS, carried through the weight converter.
    coded = jax.tree.map(
        lambda s, p: np.full(p.shape, JAX_SPECS.index(tuple(s)),
                             np.float32),
        jspec, params,
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    want = {k: JAX_SPECS[int(v.reshape(-1)[0])]
            for k, v in dt_from_jax(coded, cfg).items()}
    port = param_partition_spec(DecisionTransformer(cfg), True)
    assert set(port) == set(want)
    for name, spec in port.items():
        assert spec == tuple(reversed(want[name])), name
    assert sum(spec != () for spec in port.values()) == 4 * cfg.n_blocks
    assert set(param_partition_spec(data["weights"], False).values()) \
        == {()}
    shapes = ranks[0]["round_trip"]["shapes"]
    assert shapes["blocks.0.attn.qkv_proj.weight"] == (48, 32)
    assert shapes["blocks.0.attn.o_proj.weight"] == (32, 16)
    assert shapes["blocks.0.fc.weight"] == (64, 32)
    assert shapes["blocks.0.fc_proj.weight"] == (32, 64)
    assert shapes["blocks.0.attn.qkv_proj.bias"] == (96,)
    assert ranks[1]["round_trip"]["model_shapes"] == shapes


def test_shard_then_gather_returns_the_weights(run):
    data, ranks, _ = run
    for r in ranks:
        for got in (r["round_trip"]["from_dict"],
                    r["round_trip"]["from_model"]):
            assert set(got) == set(data["weights"])
            for k, v in data["weights"].items():
                assert torch.equal(got[k], v), k


@pytest.mark.parametrize("case", ["jax", "clip"])
def test_three_updates_match_jax_tensor_parallel_step(run, case):
    """(b) dropout off, warmup 2; (d) the same with the gradients' global
    norm clipped to CLIP, far below its value: after every step the
    clipped gradients' norm over the model axis is CLIP."""
    data, ranks, _ = run
    tcfg = data["tcfg" if case == "jax" else "tcfg_clip"]
    want_losses, want = _jax_updates(data, tcfg)
    got = ranks[0][case]
    np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-5)
    _params_close(got["params"], want, 2e-4, case)
    for r in ranks[1:]:
        _params_close(r[case]["params"], got["params"], 1e-6, "ranks")
    if case == "clip":
        assert _first_grad_norm(data) > 100 * CLIP
        for r in ranks:
            np.testing.assert_allclose(r[case]["norms"], [CLIP] * 3,
                                       rtol=1e-4)


def _first_grad_norm(data):
    """The gradients' global norm of the first batch at the JAX init."""
    jcfg = JModelConfig(**SMALL, dropout=0.0, embd_dropout=0.0)
    b = {k: jnp.asarray(v) for k, v in data["batches"][0].items()}
    grads = jax.jit(jax.grad(lambda p: j_loss_fn(
        j_make_dt_apply(jcfg, train=True), p, b, jax.random.PRNGKey(0))))(
        jax.tree.map(jnp.asarray, _jax_params(0)))
    return float(jnp.sqrt(sum(jnp.sum(g ** 2)
                              for g in jax.tree.leaves(grads))))


def test_dropout_masks_match_the_unsharded_step(run):
    """(c) At dropout 0.1 the tensor-parallel step equals the unsharded
    step on the same rows, within the band; the dropout moved the weights
    by far more than the band from the dropout-0 run."""
    _, ranks, _ = run
    for r in ranks:
        tp, ref = r["dropout"], r["dropout_unsharded"]
        np.testing.assert_allclose(tp["losses"], ref["losses"], rtol=1e-5)
        _params_close(tp["params"], ref["params"], 2e-4, "dropout")
    tp, off = ranks[0]["dropout"]["params"], ranks[0]["jax"]["params"]
    moved = max(np.linalg.norm((tp[k] - off[k]).numpy())
                / np.linalg.norm(off[k].numpy()) for k in off
                if k.endswith("weight"))
    assert moved > 10 * 2e-4


def test_resume_equals_a_straight_run_and_loads_unsharded(run):
    """(e) 2 updates, a stop, a resume of 2 more from weights of another
    seed: the straight run's weights and losses within 1e-6. The saved
    state is the unsharded layout: it loads into an unsharded trainer with
    the weights at the stop, and model_0.pt holds the straight run's."""
    data, ranks, root = run
    for r in ranks:
        res = r["resume"]
        assert res["steps"] == [2, 4]
        _params_close(res["resumed"], res["straight"], 1e-6, "resume")
        np.testing.assert_allclose(res["resumed_losses"],
                                   res["straight_losses"][2:], rtol=1e-6)
    saved = restore_checkpoint(str(root / "first" / "state_latest.pt"))
    assert saved["step"] == 2
    model = load_strict(DecisionTransformer(data["cfg_dropout"]),
                        data["weights_other"], "DT")
    state = init_train_state(model, data["tcfg_resume"], 8)
    state.load_state_dict(saved)
    at_stop = ranks[0]["resume"]["at_stop"]
    for name, p in model.named_parameters():
        assert torch.equal(p.detach(), at_stop[name]), name
    moments = state.optimizer.state
    assert all(moments[p]["exp_avg"].shape == p.shape
               for p in model.parameters())
    ckpt = load_dt(data["cfg_dropout"],
                   str(root / "straight" / "model_0.pt"), device="cpu")
    for name, p in ckpt.named_parameters():
        assert torch.equal(p, ranks[0]["resume"]["straight"][name]), name


def test_dryrun_runs_its_three_stages(run):
    """(f) The dry run over the 4 ranks: a (data 2, model 2) mesh, finite
    loss, rewards and trees, and the JAX run's OK lines with the rank."""
    _, ranks, _ = run
    for rank, r in enumerate(ranks):
        d = r["dryrun"]
        assert d["rank"] == rank and d["mesh"] == [2, 2]
        assert np.isfinite(d["train"]["loss"])
        for stage in ("eval", "mcts"):
            assert len(d[stage]["reward"]) == 2
            assert np.isfinite(d[stage]["reward"]).all()
        printed = r["dryrun_printed"]
        for line in ("dryrun_multichip OK: rank=", "dryrun_multichip eval "
                     "OK: rank=", "dryrun_multichip mcts OK: rank="):
            assert f"{line}{rank}" in printed
    # Every data index evaluates its own image and sees both; the model
    # ranks hold the same numbers.
    for stage in ("eval", "mcts"):
        assert len({tuple(r["dryrun"][stage]["reward"]) for r in ranks}) \
            == 1
    assert len({r["dryrun"]["train"]["loss"] for r in ranks}) == 1
