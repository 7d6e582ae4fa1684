"""The port's training path against the JAX package's on shared weights
(JAX init, carried over by utils/convert.py:dt_from_jax) and the same
batches: LR schedule, decay split, loss and gradients, three full updates,
dropout sites; then the port's Trainer (stop and resume, retention, async
saves), checkpoints read by the JAX loader, a 2-process data-parallel step
and the ``train`` verb.

Bands (PARITY.md, "Numerical tolerances achieved"): loss 1e-5 relative;
gradients 5e-3 relative elementwise with an absolute floor of 5e-4 of the
leaf's largest value, as tests/test_train.py holds the JAX trainer to the
torch reference; parameters after updates within 2e-4 relative, as the
norm of each leaf's error and, but for the QKV biases (``_close_leaf``), its
largest error against the leaf's largest value.
"""
import json
import os
import signal
import socket

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dt4image_restoration_tpu.config import ModelConfig as JModelConfig
from dt4image_restoration_tpu.config import TrainerConfig as JTrainerConfig
from dt4image_restoration_tpu.models.decision_transformer import (
    init_dt_params as j_init_dt_params, make_dt_apply as j_make_dt_apply)
from dt4image_restoration_tpu.training import TrainState as JTrainState
from dt4image_restoration_tpu.training import (
    make_lr_schedule as j_make_lr_schedule,
    make_optimizer as j_make_optimizer, make_train_step as j_make_train_step,
    masked_mse_loss as j_masked_mse_loss)
from dt4image_restoration_tpu.training.trainer import (_decay_mask,
                                                       loss_fn as j_loss_fn)
from dt4image_restoration_tpu.utils.checkpoint import load_dt_checkpoint
from dt4image_restoration_tpu_torch.__main__ import main as port_main
from dt4image_restoration_tpu_torch.config import ModelConfig, TrainerConfig
from dt4image_restoration_tpu_torch.models import DecisionTransformer
from dt4image_restoration_tpu_torch.training import (
    Trainer, init_train_state, make_lr_schedule, make_optimizer,
    make_train_step, masked_mse_loss)
from dt4image_restoration_tpu_torch.training.trainer import (
    ClippedAdamW, decay_split, loss_fn)
from dt4image_restoration_tpu_torch.utils.checkpoint import (
    AsyncCheckpointSaver, restore_checkpoint, save_dt_reference)
from dt4image_restoration_tpu_torch.utils.convert import (dt_from_jax,
                                                          load_strict)
from dt4image_restoration_tpu_torch.utils.loaders import load_dt
from torch_port_common import one_torch_thread  # noqa: F401
from torch_train_worker import dp_steps

SMALL = dict(block_size=18, n_embeds=9, embed_dim=32, n_heads=4,
             n_blocks=2, image_size=36)
T = 6   # timesteps of an 18-token window


def _shared(seed=0, dropout=0.0, embd_dropout=0.0, **kw):
    """(jax cfg, jax params as numpy, port cfg, port model) on the same
    weights."""
    kw = {**SMALL, "dropout": dropout, "embd_dropout": embd_dropout, **kw}
    jcfg = JModelConfig(**kw)
    params = jax.tree.map(np.asarray, j_init_dt_params(jcfg, seed))
    cfg = ModelConfig(**kw)
    model = load_strict(DecisionTransformer(cfg), dt_from_jax(params, cfg),
                        "DT")
    return jcfg, params, cfg, model


def _batch(rng, b=4, side=36, valid=(6, 4, 2, 5)):
    """A batch whose rows have zero-padded tails of different lengths."""
    masks = np.zeros((b, T, 1), np.float32)
    for i in range(b):
        masks[i, :valid[i % len(valid)]] = 1.0
    return {
        "states": rng.uniform(0, 1, (b, T, side * side)).astype(np.float32),
        "actions": (rng.uniform(0, 1, (b, T, 3)) * masks).astype(np.float32),
        "rtg": (rng.uniform(0, 1, (b, T, 1)) * masks).astype(np.float32),
        "traj_masks": masks,
        "timesteps": np.broadcast_to(
            np.arange(T, dtype=np.int32)[None, :, None], (b, T, 1)).copy(),
        "task": rng.integers(0, 9, (b, T)).astype(np.int32),
    }


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _close(got, ref, rtol, floor, what=""):
    """Elementwise ``|got - ref| <= rtol |ref| + floor * max|ref|``."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(
        got, ref, rtol=rtol,
        atol=floor * max(1e-3, float(np.abs(ref).max())), err_msg=what)


def _close_leaf(got, ref, rtol, what=""):
    """``||got - ref|| <= rtol * ||ref||`` over a parameter tensor (2-norms).

    The key third of each QKV bias has a gradient of zero in exact
    arithmetic (the softmax does not change when every score of a query
    moves by the same amount), so its computed gradient is rounding noise,
    and Adam turns that noise into updates of about lr * noise / eps. Its
    entries differ between any two implementations; the norm of the leaf's
    error stays small. Every other leaf is also held to
    ``max|got - ref| <= rtol * max|ref|``."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    err = float(np.linalg.norm(got - ref))
    assert err <= rtol * float(np.linalg.norm(ref)), \
        f"{what}: error norm {err} over {rtol} x {np.linalg.norm(ref)}"
    if not what.endswith("qkv_proj.bias"):
        assert float(np.abs(got - ref).max()) \
            <= rtol * float(np.abs(ref).max()), what


def _jax_to_port(tree, cfg):
    return {k: v.numpy() for k, v in
            dt_from_jax(jax.tree.map(np.asarray, tree), cfg).items()}


def test_lr_schedule_matches_jax():
    cfg, jcfg = TrainerConfig(), JTrainerConfig()
    max_steps = 5000
    port, ref = make_lr_schedule(cfg, max_steps), \
        j_make_lr_schedule(jcfg, max_steps)
    for step in (0, 1, 625, 1249, 1250, 3000, max_steps):
        assert abs(port(step) - float(ref(step))) <= 1e-7 * cfg.learning_rate
    assert port(0) == 0.0


def test_scheduler_runs_update_k_at_schedule_k_minus_1():
    """The first update runs at lr 0 (PARITY.md D12), update k at
    schedule(k - 1)."""
    _, _, _, model = _shared()
    cfg = TrainerConfig(warmup_steps=4)
    opt, sched = make_optimizer(cfg, 20, model)
    schedule = make_lr_schedule(cfg, 20)
    for k in range(1, 8):
        assert opt.param_groups[0]["lr"] == pytest.approx(
            schedule(k - 1), rel=1e-12, abs=1e-15)
        opt.step()
        sched.step()


def test_decay_split_matches_jax_mask():
    _, params, cfg, model = _shared()
    mask = _decay_mask(params)
    marked = jax.tree.map(lambda m, p: np.full(p.shape, float(m), np.float32),
                          mask, params)
    ref = {k for k, v in dt_from_jax(marked, cfg).items() if bool(v.all())}
    decayed, rest = decay_split(model)
    assert set(decayed) == ref
    assert set(decayed) | set(rest) == {n for n, _ in
                                        model.named_parameters()}
    assert "time_embed.weight" in rest and "blocks.0.ln1.weight" in rest


def test_masked_mse_loss_matches_jax(rng):
    preds = rng.normal(size=(3, T, 4)).astype(np.float32)
    targets = rng.normal(size=(3, T, 4)).astype(np.float32)
    masks = (rng.uniform(size=(3, T, 1)) < 0.6).astype(np.float32)
    for m in (masks, np.zeros_like(masks)):
        got = masked_mse_loss(torch.from_numpy(preds),
                              torch.from_numpy(targets), torch.from_numpy(m))
        ref = j_masked_mse_loss(jnp.asarray(preds), jnp.asarray(targets),
                                jnp.asarray(m))
        _close(float(got), float(ref), 1e-6, 1e-7)


def test_loss_and_gradients_match_jax(rng):
    jcfg, params, cfg, model = _shared()
    batch = _batch(rng)
    loss, grads = jax.jit(jax.value_and_grad(lambda p: j_loss_fn(
        j_make_dt_apply(jcfg, train=True), p,
        {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(0))))(jax.tree.map(jnp.asarray, params))
    model.train()
    port_loss = loss_fn(model, _torch(batch))
    port_loss.backward()
    _close(float(port_loss.detach()), float(loss), 1e-5, 0.0, "loss")
    ref = _jax_to_port(grads, cfg)
    assert len(ref) > 30
    for name, p in model.named_parameters():
        _close(p.grad.numpy(), ref[name], 5e-3, 5e-4, name)


def test_three_updates_match_jax_train_step():
    """Three full updates (forward, backward, clip, AdamW, schedule) with
    warmup 2, so the second and third run at real learning rates."""
    rng = np.random.default_rng(1)
    jcfg, params, cfg, model = _shared(seed=2)
    batches = [_batch(rng) for _ in range(3)]
    jt, tcfg, max_steps = JTrainerConfig(warmup_steps=2), \
        TrainerConfig(warmup_steps=2), 10
    optimizer = j_make_optimizer(jt, max_steps, params)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = JTrainState(params=jparams, opt_state=optimizer.init(jparams),
                         step=jnp.zeros((), jnp.int32))
    jstep = j_make_train_step(j_make_dt_apply(jcfg, train=True), optimizer)
    state = init_train_state(model, tcfg, max_steps)
    step = make_train_step()
    for i, b in enumerate(batches):
        jstate, jloss = jstep(jstate, {k: jnp.asarray(v)
                                       for k, v in b.items()},
                              jax.random.PRNGKey(i))
        loss = step(state, _torch(b))
        _close(float(loss), float(jloss), 1e-5, 0.0, f"loss {i}")
    assert state.step == 3 and int(jstate.step) == 3
    ref = _jax_to_port(jstate.params, cfg)
    moved = 0
    for name, p in model.named_parameters():
        _close_leaf(p.detach().numpy(), ref[name], 2e-4, name)
        moved += not np.array_equal(p.detach().numpy(),
                                    _jax_to_port(params, cfg)[name])
    assert moved > 30   # the updates changed the weights


def test_clipped_adamw_matches_optax_decoupled_decay():
    """On identical gradients (global norm above the clip), two steps of
    ClippedAdamW equal optax's clip + adamw: optax's ``p -= lr * (adam + wd
    * p)`` is PyTorch's ``p *= 1 - lr * wd; p -= lr * adam``."""
    gen = torch.Generator().manual_seed(5)
    shapes = {"w": (16, 8), "b": (8,), "v": (3, 4, 5)}
    p0 = {k: torch.randn(s, generator=gen) for k, s in shapes.items()}
    grads = [{k: 0.5 * torch.randn(s, generator=gen)
              for k, s in shapes.items()} for _ in range(2)]
    lr, wd = 1e-2, 0.1
    ps = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
    opt = ClippedAdamW([{"params": [ps["w"], ps["v"]], "weight_decay": wd},
                        {"params": [ps["b"]], "weight_decay": 0.0}],
                       max_grad_norm=1.0, lr=lr, betas=(0.9, 0.95),
                       eps=1e-8)
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adamw(lr, b1=0.9, b2=0.95, weight_decay=wd,
                                 mask={"w": True, "b": False, "v": True}))
    jp = {k: jnp.asarray(v.numpy()) for k, v in p0.items()}
    opt_state = tx.init(jp)
    for g in grads:
        assert float(torch.sqrt(sum((v ** 2).sum() for v in g.values()))) > 1
        for k, p in ps.items():
            p.grad = g[k].clone()
        opt.step()
        upd, opt_state = tx.update({k: jnp.asarray(v.numpy())
                                    for k, v in g.items()}, opt_state, jp)
        jp = optax.apply_updates(jp, upd)
    for k, p in ps.items():
        _close(p.detach().numpy(), np.asarray(jp[k]), 1e-6, 1e-7, k)
        # The decay is visible at this tolerance: without it the weights
        # differ by about lr * wd * |p| per step.
        if k != "b":
            assert np.abs(p.detach().numpy() - np.asarray(jp[k])).max() \
                < 0.1 * lr * wd * float(p0[k].abs().max())


@pytest.mark.parametrize("dropout,embd_dropout", [(1.0, 0.0), (0.0, 1.0)])
def test_dropout_sites_match_jax_at_rate_one(rng, dropout, embd_dropout):
    """At rate 1 dropout zeros deterministically in both frameworks, so the
    sites' placement decides the output."""
    jcfg, params, cfg, model = _shared(seed=3, dropout=dropout,
                                       embd_dropout=embd_dropout)
    b = _batch(rng, b=2)
    args = [b[k] for k in ("rtg", "states", "timesteps", "task", "actions")]
    ref = j_make_dt_apply(jcfg, train=True)(
        params, *map(jnp.asarray, args), jax.random.PRNGKey(0))
    model.train()
    with torch.no_grad():
        got = model(*map(torch.from_numpy, args))
    for g, r in ((got.pred_actions, ref.pred_actions),
                 (got.pred_rtg, ref.pred_rtg)):
        _close(g.numpy(), np.asarray(r), 1e-5, 1e-6)
    with torch.no_grad():   # the train-mode output differs from eval's
        assert not torch.allclose(model.eval()(*map(torch.from_numpy,
                                                    args)).pred_rtg,
                                  got.pred_rtg)


def test_dropout_only_in_train_mode(rng):
    _, _, _, plain = _shared(seed=4)
    _, _, _, model = _shared(seed=4, dropout=0.1, embd_dropout=0.1)
    args = [torch.from_numpy(_batch(rng, b=2)[k])
            for k in ("rtg", "states", "timesteps", "task", "actions")]
    with torch.no_grad():
        ref = plain.eval()(*args).pred_actions
        assert torch.equal(model.eval()(*args).pred_actions, ref)
        gen = torch.Generator().manual_seed(0)
        model.train().set_dropout_generator(gen)
        a = model(*args).pred_actions
        assert not torch.equal(a, ref)
        gen.manual_seed(0)
        assert torch.equal(model(*args).pred_actions, a)


# --- Trainer -------------------------------------------------------------

def _trainer(tmp_path, batches, seed=6, stop_after=None, **kw):
    _, _, cfg, model = _shared(seed=seed, dropout=0.1, embd_dropout=0.1)
    tcfg = TrainerConfig(max_epochs=kw.pop("max_epochs", 1), warmup_steps=2,
                         save_every=1)
    step = make_train_step()
    calls = []

    def counted(state, batch):
        loss = step(state, batch)
        calls.append(signal.getsignal(signal.SIGTERM))
        if stop_after is not None and len(calls) == stop_after:
            trainer.request_stop()
        return loss

    trainer = Trainer(train_step=counted,
                      state=init_train_state(model, tcfg, 8), config=tcfg,
                      batches=lambda epoch: iter(batches),
                      checkpoint_dir=str(tmp_path), **kw)
    return trainer, calls


def test_stop_request_saves_and_resume_equals_uninterrupted(tmp_path):
    rng = np.random.default_rng(2)
    batches = [_batch(rng) for _ in range(4)]
    straight, _ = _trainer(tmp_path / "a", batches)
    straight.train()
    ref = {n: p.detach().clone()
           for n, p in straight.state.model.named_parameters()}

    before = signal.getsignal(signal.SIGTERM)
    first, calls = _trainer(tmp_path / "b", batches, stop_after=2)
    first.train()
    assert first.state.step == 2 and len(calls) == 2
    # SIGTERM requested the stop during the run and is restored after it.
    assert calls[0] == first.request_stop
    assert signal.getsignal(signal.SIGTERM) == before
    saved = tmp_path / "b" / "state_latest.pt"
    assert saved.exists() and not (tmp_path / "b" / "model_0.pt").exists()
    assert restore_checkpoint(str(saved))["step"] == 2

    resumed, _ = _trainer(tmp_path / "c", batches[2:], seed=9,
                          resume_from=str(saved))
    resumed.train()
    assert resumed.state.step == 4
    for n, p in resumed.state.model.named_parameters():
        torch.testing.assert_close(p.detach(), ref[n], rtol=1e-6, atol=0)
    assert resumed.last_losses == pytest.approx(straight.last_losses[2:],
                                                rel=1e-6)


@pytest.mark.parametrize("async_save", [False, True])
def test_keep_last_keeps_newest_and_state(tmp_path, async_save):
    rng = np.random.default_rng(3)
    trainer, _ = _trainer(tmp_path, [_batch(rng, b=2)], max_epochs=4,
                          keep_last=2, async_save=async_save)
    trainer.train()
    assert sorted(os.listdir(tmp_path)) == ["model_2.pt", "model_3.pt",
                                            "state_latest.pt"]
    assert restore_checkpoint(str(tmp_path / "state_latest.pt"))["step"] == 4


def test_async_saver_reraises_failed_write(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    saver = AsyncCheckpointSaver()
    saver.submit(str(blocker / "sub" / "x.pt"), {"a": torch.ones(2)})
    with pytest.raises(OSError):
        saver.close()
    rng = np.random.default_rng(4)
    trainer, _ = _trainer(blocker, [_batch(rng, b=2)], async_save=True)
    with pytest.raises(OSError):
        trainer.train()


def test_watch_pass_logs_and_leaves_training_unchanged(tmp_path,
                                                       monkeypatch):
    """With wandb logging (WANDB_API_KEY set) the watch pass logs the
    parameter and gradient histograms every ``watch_every`` steps and puts
    the dropout generator back, so the weights equal a run without it."""
    import sys
    import types

    from dt4image_restoration_tpu_torch.training import make_watch_grad_fn
    logged = []
    fake = types.SimpleNamespace(init=lambda **kw: None, finish=lambda: None,
                                 log=logged.append,
                                 Histogram=lambda a: ("hist", a.size))
    monkeypatch.setitem(sys.modules, "wandb", fake)
    monkeypatch.setenv("WANDB_API_KEY", "test")
    rng = np.random.default_rng(6)
    batches = [_batch(rng) for _ in range(3)]
    plain, _ = _trainer(tmp_path / "plain", batches)
    plain.train()
    _, _, cfg, model = _shared(seed=6, dropout=0.1, embd_dropout=0.1)
    tcfg = TrainerConfig(max_epochs=1, warmup_steps=2, log_wandb=True,
                         watch_every=2)
    watched = Trainer(train_step=make_train_step(),
                      state=init_train_state(model, tcfg, 8), config=tcfg,
                      batches=lambda epoch: iter(batches),
                      watch_grad_fn=make_watch_grad_fn(model))
    watched.train()
    hists = [d for d in logged if any(k.startswith("gradients/")
                                      for k in d)]
    assert len(hists) == 2            # steps 0 and 2
    assert set(hists[0]) == {f"{kind}/{n}" for kind in ("parameters",
                                                        "gradients")
                             for n, _ in model.named_parameters()}
    assert sum("loss" in d for d in logged) == 3
    ref = dict(plain.state.model.named_parameters())
    for n, p in model.named_parameters():
        assert torch.equal(p, ref[n]), n


def test_trainer_refuses_kernel_model(tmp_path):
    _, _, _, model = _shared(use_pallas=True)
    with pytest.raises(ValueError, match="use_pallas"):
        init_train_state(model, TrainerConfig(), 4)
    _, _, _, plain = _shared()
    state = init_train_state(plain, TrainerConfig(), 4)
    state.model = model
    with pytest.raises(ValueError, match="use_pallas"):
        Trainer(train_step=make_train_step(), state=state,
                config=TrainerConfig(), batches=lambda e: iter(()))


def test_reference_checkpoint_loads_in_jax_and_port(tmp_path, rng):
    """A model_<epoch>.pt of the port, in the reference's layout: the JAX
    package's load_dt_checkpoint gives the same forward, and the port's
    eval loader the same weights. The weights come from a seeded JAX init,
    not from PyTorch's global generator, so they do not depend on the
    tests that ran before this one; the forward is held to the DT
    forward's band (PARITY.md: 2e-3 relative), at which a mis-mapped
    weight still shows as an O(1) error."""
    jcfg, _, cfg, model = _shared(seed=3, image_size=128)
    model.eval()
    path = str(tmp_path / "model_0.pt")
    save_dt_reference(path, model.state_dict(), cfg)
    params = load_dt_checkpoint(path)
    b = _batch(rng, b=2, side=128)
    args = [b[k] for k in ("rtg", "states", "timesteps", "task", "actions")]
    ref = j_make_dt_apply(jcfg)(params, *map(jnp.asarray, args))
    with torch.no_grad():
        got = model(*map(torch.from_numpy, args))
    np.testing.assert_allclose(got.pred_actions.numpy(),
                               np.asarray(ref.pred_actions), rtol=2e-3,
                               atol=1e-6)
    np.testing.assert_allclose(got.pred_rtg.numpy(),
                               np.asarray(ref.pred_rtg), rtol=2e-3,
                               atol=1e-5)
    loaded = load_dt(cfg, path, device="cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_gloo_step_equals_global_masked_mean(tmp_path):
    """Two Gloo ranks holding rows with different numbers of padded steps:
    their weighted all-reduce gives the gradients, loss and update of one
    process on the whole batch, which a plain mean of the ranks' own
    masked means does not."""
    rng = np.random.default_rng(5)
    _, _, cfg, model = _shared(seed=7)
    tcfg = TrainerConfig(warmup_steps=1)
    batches = [_torch(_batch(rng, valid=(1, 2, 6, 6))) for _ in range(2)]
    rows = [torch.tensor([0, 1]), torch.tensor([2, 3])]
    in_path, out_path = str(tmp_path / "in.pt"), str(tmp_path / "out.pt")
    torch.save({"cfg": cfg, "tcfg": tcfg, "rows": rows, "batches": batches,
                "weights": model.state_dict()}, in_path)
    ctx = torch.multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=dp_steps,
                         args=(r, 2, port, in_path, out_path))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=150)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join(5)
    assert not alive, "a rank did not finish within 150 s"
    assert all(p.exitcode == 0 for p in procs)
    got = torch.load(out_path, weights_only=False)

    state = init_train_state(model, tcfg, 10)
    step = make_train_step()
    losses = [float(step(state, b)) for b in batches]
    assert got["losses"] == pytest.approx(losses, rel=1e-5)
    for n, p in model.named_parameters():
        ref = p.grad.numpy()
        _close(got["grads"][n].numpy(), ref, 1e-4, 1e-5, n)
        _close_leaf(got["weights"][n].numpy(), p.detach().numpy(), 2e-4, n)

    # The mean of per-rank masked means is another gradient.
    per_rank = []
    for r in rows:
        m = DecisionTransformer(cfg)
        m.load_state_dict(torch.load(in_path, weights_only=False)["weights"])
        m.train()
        loss_fn(m, {k: v[r] for k, v in batches[-1].items()}).backward()
        per_rank.append(m.state_encoder.dense.weight.grad)
    ddp = (per_rank[0] + per_rank[1]) / 2
    ref = model.state_encoder.dense.weight.grad
    assert float((ddp - ref).abs().max()) > 0.05 * float(ref.abs().max())


def test_bfloat16_step_tracks_jax_bfloat16_loss(rng):
    """--dtype bfloat16: autocast forward and loss, float32 weights. The
    loss at init is within 2e-2 of the JAX package's bf16 loss and of the
    float32 loss (bf16 keeps 8 bits of mantissa)."""
    kw = {**SMALL, "dropout": 0.0, "embd_dropout": 0.0}
    jcfg = JModelConfig(**kw, dtype="bfloat16")
    params = jax.tree.map(np.asarray, j_init_dt_params(jcfg, 8))
    cfg = ModelConfig(**kw)
    model = load_strict(DecisionTransformer(cfg), dt_from_jax(params, cfg),
                        "DT")
    batch = _batch(rng)
    ref = float(jax.jit(lambda p, b: j_loss_fn(
        j_make_dt_apply(jcfg, train=True), p, b, jax.random.PRNGKey(0)))(
            params, {k: jnp.asarray(v) for k, v in batch.items()}))
    state = init_train_state(model, TrainerConfig(), 10)
    with torch.no_grad():
        f32 = float(loss_fn(model.train(), _torch(batch)))
    loss = float(make_train_step("bfloat16")(state, _torch(batch)))
    assert loss == pytest.approx(ref, rel=2e-2)
    assert loss == pytest.approx(f32, rel=2e-2)
    assert loss != f32                  # bfloat16 products did run
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in model.parameters())


@pytest.fixture
def train_fixture(tmp_path):
    rng = np.random.default_rng(0)
    h5_path = tmp_path / "states.h5"
    data_dir = tmp_path / "trajs"
    os.makedirs(data_dir)
    with h5py.File(h5_path, "w") as f:
        for i in range(4):
            paths = []
            for t in range(6):
                key = f"t{i}/s{t}"
                f.create_dataset(key, data=rng.integers(
                    0, 256, (128, 128)).astype(np.uint8))
                paths.append("0123456789" + key)
            traj = {"RTG": list(np.linspace(5, 0, 6)),
                    "Actions": {k: list(rng.uniform(0, 1, 6))
                                for k in ("T", "sigma_d", "mu")},
                    "State Paths": paths, "Task": "4x_10"}
            with open(data_dir / f"traj_{i}.json", "w") as jf:
                json.dump(traj, jf)
    return str(data_dir), str(h5_path)


def test_cli_train_on_cpu(train_fixture, tmp_path, capsys):
    """The train verb on the CPU: 1 epoch of batch 2 over 4 trajectories;
    its model_0.pt loads in the port's eval loader and in the JAX
    package's load_dt_checkpoint, and --resume continues from its
    state_latest.pt."""
    data_dir, h5_path = train_fixture
    ckpts = tmp_path / "ckpts"
    argv = ["--block_size", "18", "--device", "cpu", "train",
            "--batch_size", "2", "--save_every", "1", "--max_epochs", "1",
            "--data_dir", data_dir, "--state_file", h5_path,
            "--checkpoint_dir", str(ckpts)]
    port_main(argv)
    out = capsys.readouterr().out
    assert "Training complete; last losses:" in out
    losses = json.loads(out.split("last losses:")[1].strip())
    assert len(losses) == 2 and all(np.isfinite(losses))
    model_0 = str(ckpts / "model_0.pt")
    params = load_dt_checkpoint(model_0)
    assert params["block4"]["fc"]["kernel"].shape == (128, 512)
    cfg = ModelConfig(block_size=18, n_embeds=9)
    loaded = load_dt(cfg, model_0, device="cpu")
    state = restore_checkpoint(str(ckpts / "state_latest.pt"))
    assert state["step"] == 2
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, state["model"][k])
    port_main(argv + ["--resume", str(ckpts / "state_latest.pt"),
                      "--async_save", "--keep_last", "1",
                      "--preload_data"])
    assert "Training complete" in capsys.readouterr().out
    assert restore_checkpoint(str(ckpts / "state_latest.pt"))["step"] == 4


# --- profiling -----------------------------------------------------------

def test_step_timer_summary_keys_match_jax():
    from dt4image_restoration_tpu.utils.profiling import StepTimer as JTimer
    from dt4image_restoration_tpu_torch.utils.profiling import StepTimer
    port, ref = StepTimer("cpu"), JTimer()
    for timer in (port, ref):
        assert timer.summary() == {"steps": 0}
        for _ in range(3):
            with timer:
                pass
    assert set(port.summary()) == set(ref.summary())
    assert port.summary()["steps"] == 3


def test_trace_if_enabled_follows_env_var(tmp_path, monkeypatch):
    from dt4image_restoration_tpu_torch.utils.profiling import (
        TRACE_ENV_VAR, TRACE_FILE, annotate, trace_if_enabled)
    monkeypatch.delenv(TRACE_ENV_VAR, raising=False)
    with trace_if_enabled():
        torch.ones(4).sum()
    assert not os.listdir(tmp_path)
    monkeypatch.setenv(TRACE_ENV_VAR, str(tmp_path / "t"))
    with trace_if_enabled():
        with annotate("work"):
            torch.ones(4).sum()
    with open(tmp_path / "t" / TRACE_FILE) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "work" in names


def test_region_breakdown_counts_device_union():
    from dt4image_restoration_tpu_torch.utils.profiling import (
        region_breakdown)
    span = {"name": "r", "ph": "X", "cat": "user_annotation", "ts": 100,
            "dur": 100}
    kernels = [("a", 90, 20), ("a", 120, 10), ("b", 125, 20),
               ("c", 190, 50), ("d", 300, 5)]
    events = [span, {"name": "r", "ph": "X", "cat": "gpu_user_annotation",
                     "ts": 0, "dur": 1}] + [
        {"name": n, "ph": "X", "cat": "kernel", "ts": ts, "dur": dur}
        for n, ts, dur in kernels]
    out = region_breakdown(events, "r", top=2)
    # Inside [100, 200]: a [100,110] and [120,130], b [125,145], c
    # [190,200]; their union is 10 + 25 + 10 = 45 us.
    assert out["wall_ms"] == pytest.approx(0.1)
    assert out["device_ms"] == pytest.approx(0.045)
    assert out["device_idle_share"] == pytest.approx(0.55)
    assert out["device_ops"] == 4
    assert out["top_ops"] == [{"name": "a", "ms": pytest.approx(0.02),
                               "count": 2},
                              {"name": "b", "ms": pytest.approx(0.02),
                               "count": 1}]
    with pytest.raises(ValueError):
        region_breakdown(events, "missing")
