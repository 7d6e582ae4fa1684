"""The port's scripted-expert corpus (``data/expert.py``, ``data/synthetic.py:
cartesian_mask``, ``tools/make_dataset.py``) against the JAX package's, on
shared inputs and shared U-Net weights, and the record -> train -> evaluate
loop in the port.

The stub denoisers of the two frameworks compute the same arithmetic (the
JAX one sees NHWC images, the port's NCHW ones). Bands: PSNRs 1e-3 dB;
observations the U-Net band (1e-3 relative, 2e-4 absolute, PARITY.md);
stored uint8 states within 1 LSB (a float difference of 1e-7 can move a
state across a rounding boundary, the bound tests/test_expert.py holds the
JAX recorder to against its sequential rollout); RTG 2e-3.
"""
import json
import os
import sys

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import loadmat

from dt4image_restoration_tpu.data import expert as jexpert
from dt4image_restoration_tpu.data import synthetic as jsynth
from dt4image_restoration_tpu.env import admm_step as j_admm_step
from dt4image_restoration_tpu.models.decision_transformer import (
    init_dt_params as j_init_dt_params)
from dt4image_restoration_tpu_torch.config import (FLEX_TASKS,
                                                   OPTIMAL_RTG_RANGE,
                                                   OPTIMAL_TASKS, ModelConfig,
                                                   TrainerConfig)
from dt4image_restoration_tpu_torch.data import (EvaluationOptimalDataset,
                                                 TrainingDataset,
                                                 cartesian_mask,
                                                 make_mat_record)
from dt4image_restoration_tpu_torch.data import expert
from dt4image_restoration_tpu_torch.env import admm_step
from torch_port_common import one_torch_thread  # noqa: F401
from torch_port_common import shared_denoisers

SIZE = 48


def stub_denoise(img, sigma):
    del sigma
    return img.clamp(0.0, 1.0)


def j_stub_denoise(img, sigma):
    del sigma
    return jnp.clip(img, 0.0, 1.0)


def _traj(traj_dir, i):
    with open(os.path.join(traj_dir, f"traj_{i}.json")) as f:
        return json.load(f)


def _u8(ob, size):
    return (np.clip(ob.reshape(size, size), 0, 1) * 255).astype(np.uint8)


# --- pieces ------------------------------------------------------------------

@pytest.mark.parametrize("task", ["2x_5", "8x_15", "4_10", "rtg_3.5",
                                  "16x_2.5", "bogus"])
def test_task_physics_matches_jax(task):
    assert expert.task_physics(task) == jexpert.task_physics(task)


@pytest.mark.parametrize("t,ep_len", [(0, 8), (3, 8), (7, 8), (0, 1),
                                      (2, 3)])
def test_scripted_expert_action_matches_jax(t, ep_len):
    assert expert.scripted_expert_action(t, ep_len) \
        == jexpert.scripted_expert_action(t, ep_len)


@pytest.mark.parametrize("size,acceleration,center_fraction,seed", [
    (128, 4, 0.08, 0), (128, 8, 0.04, 3), (64, 2, 0.1, 7), (33, 16, 0.3, 1)])
def test_cartesian_mask_matches_jax(size, acceleration, center_fraction,
                                    seed):
    ours = cartesian_mask(size, acceleration, center_fraction, seed)
    theirs = jsynth.cartesian_mask(size, acceleration, center_fraction, seed)
    assert ours.dtype == theirs.dtype and ours.shape == (size, size)
    np.testing.assert_array_equal(ours, theirs)


def test_rollout_expert_matches_jax():
    """The sequential rollout with the real U-Net on shared weights."""
    model, j_denoise = shared_denoisers(seed=4, base=8)
    _, mat = expert.expert_record(1, OPTIMAL_TASKS, size=SIZE)
    obs, actions, psnrs = expert.rollout_expert(
        lambda s, a: admm_step(model, s, a), mat, 3, device="cpu")
    j_obs, j_actions, j_psnrs = jexpert.rollout_expert(
        jax.jit(lambda s, a: j_admm_step(j_denoise, s, a)), mat, 3)
    assert actions == j_actions
    assert len(obs) == len(j_obs) == 3 and len(psnrs) == 4
    np.testing.assert_allclose(psnrs, j_psnrs, rtol=0, atol=1e-3)
    for a, b in zip(obs, j_obs):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-3, atol=2e-4)
    assert psnrs[-1] > psnrs[0]


def test_record_expert_corpus_matches_jax(tmp_path):
    """Three trajectories over a chunk boundary (batch_chunk 2) on the
    stub: the same files, tasks, actions, RTGs and states as JAX's."""
    kw = dict(n_traj=3, ep_len=3, seed=0, experiment="optimal", size=SIZE,
              batch_chunk=2)
    ours = expert.record_expert_corpus(str(tmp_path / "port"), stub_denoise,
                                       device="cpu", **kw)
    theirs = jexpert.record_expert_corpus(str(tmp_path / "jax"),
                                          j_stub_denoise, **kw)
    assert set(ours) == set(theirs)
    assert ours["expert_increment_db"] == pytest.approx(
        theirs["expert_increment_db"], abs=2e-3)
    assert sorted(os.listdir(ours["traj_dir"])) \
        == sorted(os.listdir(theirs["traj_dir"]))
    with h5py.File(ours["h5_path"], "r") as f, \
            h5py.File(theirs["h5_path"], "r") as g:
        keys = []
        f.visit(keys.append)
        j_keys = []
        g.visit(j_keys.append)
        assert keys == j_keys
        for i in range(3):
            a, b = _traj(ours["traj_dir"], i), _traj(theirs["traj_dir"], i)
            assert a["Task"] == b["Task"] == OPTIMAL_TASKS[i]
            assert a["Actions"] == b["Actions"]
            assert a["State Paths"] == b["State Paths"]
            np.testing.assert_allclose(a["RTG"], b["RTG"], rtol=0,
                                       atol=2e-3)
            for p in a["State Paths"]:
                key = p[len(expert.STATE_PATH_PREFIX):]
                got, ref = f[key][:], g[key][:]
                assert got.dtype == ref.dtype == np.uint8
                assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1


# --- twins of tests/test_expert.py -------------------------------------------

def test_record_expert_corpus_feeds_training_dataset(tmp_path):
    stats = expert.record_expert_corpus(
        str(tmp_path), stub_denoise, n_traj=3, ep_len=2, seed=0,
        experiment="optimal", device="cpu")
    assert stats["n_traj"] == 3 and os.path.exists(stats["h5_path"])
    traj = _traj(stats["traj_dir"], 0)
    assert traj["Task"] in OPTIMAL_TASKS
    assert set(traj["Actions"]) == {"T", "sigma_d", "mu"}
    assert len(traj["RTG"]) == 2
    assert all(p.startswith("0123456789traj") for p in traj["State Paths"])

    lo, hi = OPTIMAL_RTG_RANGE
    ds = TrainingDataset(
        block_size=6, data_dir=stats["traj_dir"], action_dim=3,
        state_file_path=stats["h5_path"], tasks=OPTIMAL_TASKS,
        min_rtg=lo, max_rtg=hi, normalize_rtg=True,
        rng=np.random.default_rng(0))
    assert len(ds) == 3
    states, actions, rtg, masks, timesteps, task = ds[0]
    ds.close()
    assert states.shape == (6, 128 * 128) and actions.shape == (6, 3)
    np.testing.assert_array_equal(masks[:, 0], [1, 1, 0, 0, 0, 0])


def test_batched_recording_matches_sequential_rollout(tmp_path):
    """Each recorded trajectory (batch_chunk 2: a chunk boundary at
    trajectory 2) against rollout_expert on its own record."""
    stats = expert.record_expert_corpus(
        str(tmp_path), stub_denoise, n_traj=3, ep_len=3, seed=0,
        experiment="optimal", batch_chunk=2, device="cpu")
    for i, task in enumerate(["2x_5", "2x_10", "2x_15"]):
        acc, noise = expert.task_physics(task)
        mat = dict(make_mat_record(acceleration=acc, noise_sigma=noise,
                                   seed=i))
        mat["x0"] = np.clip(mat["x0"], 0, None)
        obs, actions, psnrs = expert.rollout_expert(
            lambda s, a: admm_step(stub_denoise, s, a), mat, 3,
            device="cpu")
        traj = _traj(stats["traj_dir"], i)
        assert traj["Task"] == task
        np.testing.assert_allclose(
            traj["RTG"], [psnrs[-1] - p for p in psnrs[:3]], atol=2e-3)
        for k in ("T", "sigma_d", "mu"):
            np.testing.assert_allclose(
                traj["Actions"][k], [a[k] for a in actions], rtol=1e-6)
        with h5py.File(stats["h5_path"], "r") as f:
            for t, ob in enumerate(obs):
                got = f[f"traj{i}/s{t}"][:]
                assert np.abs(got.astype(int)
                              - _u8(ob, 128).astype(int)).max() <= 1


@pytest.mark.parametrize("tasks", [None, list(FLEX_TASKS)])
def test_flex_labels_encode_achieved_gain(tmp_path, tasks):
    """With an rtg_* vocabulary, the default flex one or passed
    explicitly, each trajectory is labelled by the bucket nearest the gain
    it achieved; and the labels are JAX's."""
    kw = dict(n_traj=4, ep_len=2, seed=0, experiment="flex", tasks=tasks,
              size=SIZE)
    stats = expert.record_expert_corpus(str(tmp_path / "port"),
                                        stub_denoise, device="cpu", **kw)
    j_stats = jexpert.record_expert_corpus(str(tmp_path / "jax"),
                                           j_stub_denoise, **kw)
    for i in range(4):
        traj = _traj(stats["traj_dir"], i)
        gain = traj["RTG"][0]
        want = min(FLEX_TASKS,
                   key=lambda t: abs(float(t.split("_", 1)[1]) - gain))
        assert traj["Task"] == want == _traj(j_stats["traj_dir"], i)["Task"]


def test_rerun_clears_stale_trajectories(tmp_path):
    expert.record_expert_corpus(str(tmp_path), stub_denoise, n_traj=3,
                                ep_len=2, size=SIZE, device="cpu")
    foreign = os.path.join(str(tmp_path), "trajs", "real_corpus_0.json")
    with open(foreign, "w") as f:
        f.write("{}")
    stats = expert.record_expert_corpus(str(tmp_path), stub_denoise,
                                        n_traj=1, ep_len=2, size=SIZE,
                                        device="cpu")
    assert sorted(os.listdir(stats["traj_dir"])) == [
        "real_corpus_0.json", "traj_0.json"]
    with h5py.File(stats["h5_path"], "r") as f:
        assert list(f) == ["traj0"]


def test_eval_dirs_rerun_clears_stale_records(tmp_path):
    (full,) = expert.make_eval_dirs(str(tmp_path), per_dir=3, dirs=["4_15"],
                                    size=32, seed=0)
    with open(os.path.join(full, "real_slice.mat"), "wb") as f:
        f.write(b"\x00")
    expert.make_eval_dirs(str(tmp_path), per_dir=1, dirs=["4_15"], size=32,
                          seed=1)
    assert sorted(os.listdir(full)) == ["img_4_15_s0.mat", "real_slice.mat"]


@pytest.mark.parametrize("dirs", [None, ["4_15", "2_5"]])
def test_make_eval_dirs_matches_jax(tmp_path, dirs):
    """The same directories, file names and arrays as JAX's (compared
    through loadmat: savemat headers carry timestamps)."""
    kw = dict(per_dir=2, dirs=dirs, size=32, seed=3)
    ours = expert.make_eval_dirs(str(tmp_path / "port"), **kw)
    theirs = jexpert.make_eval_dirs(str(tmp_path / "jax"), **kw)
    assert [os.path.relpath(d, tmp_path / "port") for d in ours] \
        == [os.path.relpath(d, tmp_path / "jax") for d in theirs]
    assert len(ours) == (9 if dirs is None else 2)
    for a, b in zip(ours, theirs):
        assert sorted(os.listdir(a)) == sorted(os.listdir(b))
        for name in os.listdir(a):
            ma, mb = loadmat(os.path.join(a, name)), \
                loadmat(os.path.join(b, name))
            keys = {k for k in ma if not k.startswith("__")}
            assert keys == {k for k in mb if not k.startswith("__")}
            for k in keys:
                np.testing.assert_array_equal(ma[k], mb[k])


def test_make_eval_dirs_feed_eval_dataset(tmp_path):
    dirs = expert.make_eval_dirs(str(tmp_path), per_dir=2,
                                 dirs=["4_15", "2_5"])
    assert all("evaluation/image_dir/vanilla" in d for d in dirs)
    ds = EvaluationOptimalDataset(dirs[0], rtg_target=10.0)
    assert len(ds) == 2
    (_, _, _, task), mat = ds[0]
    assert int(task[0]) == OPTIMAL_TASKS.index("4x_15")
    assert mat["gt"].shape == (1, 128, 128)
    assert 0 < mat["mask"].mean() < 1


# --- the command line ----------------------------------------------------------

def test_make_dataset_tool_on_cpu(tmp_path, capsys):
    """The tool in-process on the CPU with the random-weight U-Net: one
    JSON line of stats, the corpus and the nine eval dirs."""
    from dt4image_restoration_tpu_torch.tools import make_dataset
    out_dir = tmp_path / "synth"
    rc = make_dataset.main(["--out", str(out_dir), "--device", "cpu",
                            "--n_traj", "2", "--ep_len", "2", "--eval",
                            "--per_dir", "1"])
    assert rc == 0
    r = capsys.readouterr()
    assert "random weights" in r.err and "recorded 2/2 trajectories" in r.err
    stats = json.loads(r.out.strip().splitlines()[-1])
    assert stats["n_traj"] == 2 and np.isfinite(stats["expert_increment_db"])
    assert sorted(os.listdir(stats["traj_dir"])) == ["traj_0.json",
                                                     "traj_1.json"]
    assert os.path.exists(stats["h5_path"])
    assert len(stats["eval_dirs"]) == 9
    for d in stats["eval_dirs"]:
        assert len(os.listdir(d)) == 1


def test_make_dataset_tool_refuses_without_h5py(tmp_path, monkeypatch,
                                                capsys):
    from dt4image_restoration_tpu_torch.tools import make_dataset
    monkeypatch.setitem(sys.modules, "h5py", None)   # import raises
    out_dir = tmp_path / "synth"
    assert make_dataset.main(["--out", str(out_dir), "--device", "cpu"]) == 2
    assert "h5py is not installed" in capsys.readouterr().err
    assert not out_dir.exists()


# --- twin of tests/test_learning.py ------------------------------------------

EP_LEN, N_TRAJ, STEPS = 6, 12, 120


def blur_denoise(img, sigma):
    """A denoiser with real effect: pull toward a smoothed image, scaled
    by sigma, so the expert's sigma_d schedule matters (the port's twin of
    tests/test_learning.py's stub, on NCHW images)."""
    blur = (img + torch.roll(img, 1, 2) + torch.roll(img, -1, 2)
            + torch.roll(img, 1, 3) + torch.roll(img, -1, 3)) / 5.0
    w = torch.clamp(4.0 * sigma[:, None, None, None], 0.0, 1.0)
    return torch.clamp((1 - w) * img + w * blur, 0.0, 1.0)


def learning_expert_action(t, ep_len=None):
    if t == EP_LEN - 1:
        return {"T": 0.9, "sigma_d": 8 / 255.0, "mu": 0.5}
    return {"T": 0.02 * t, "sigma_d": (25.0 - 3.0 * t) / 255.0, "mu": 0.5}


def test_pipeline_learns_expert_policy(tmp_path):
    """Record (stub) -> TrainingDataset -> the port's Trainer -> Evaluator
    on held-out slices: the loss falls tenfold, and the trained policy
    recovers over half the expert's gain and beats the untrained one by
    0.3 dB. Both start from the JAX test's initial weights (the JAX init
    of seed 0)."""
    from dt4image_restoration_tpu.config import ModelConfig as JModelConfig
    from dt4image_restoration_tpu_torch.inference import Evaluator
    from dt4image_restoration_tpu_torch.models import DecisionTransformer
    from dt4image_restoration_tpu_torch.training import (Trainer,
                                                         init_train_state,
                                                         make_train_step)
    from dt4image_restoration_tpu_torch.utils.convert import (dt_from_jax,
                                                              load_strict)

    stats = expert.record_expert_corpus(
        str(tmp_path), blur_denoise, n_traj=N_TRAJ, ep_len=EP_LEN, seed=0,
        tasks=["4x_15"], physics_from_task=False,
        expert_fn=learning_expert_action, device="cpu")
    expert_gain = stats["expert_increment_db"]
    assert expert_gain > 0.5

    cfg = ModelConfig(block_size=18, n_embeds=9, mode="norm")
    lo, hi = OPTIMAL_RTG_RANGE
    ds = TrainingDataset(
        block_size=cfg.context_length, data_dir=stats["traj_dir"],
        action_dim=3, state_file_path=stats["h5_path"], tasks=OPTIMAL_TASKS,
        min_rtg=lo, max_rtg=hi, normalize_rtg=True,
        rng=np.random.default_rng(0))
    batch = 6
    tcfg = TrainerConfig(warmup_steps=15, learning_rate=3e-4,
                         batch_size=batch,
                         max_epochs=STEPS // (N_TRAJ // batch))
    params0 = jax.tree.map(np.asarray, j_init_dt_params(
        JModelConfig(block_size=18, n_embeds=9, mode="norm"), seed=0))

    def initial_model():
        return load_strict(DecisionTransformer(cfg),
                           dt_from_jax(params0, cfg), "DT")

    model = initial_model()
    step, losses = make_train_step(), []

    def recorded_step(state, batch_):
        loss = step(state, batch_)
        losses.append(float(loss))
        return loss

    trainer = Trainer(train_step=recorded_step,
                      state=init_train_state(model, tcfg, STEPS),
                      config=tcfg,
                      batches=lambda epoch: ds.batches(batch, seed=epoch))
    trainer.train()
    ds.close()
    assert len(losses) == STEPS
    assert np.mean(losses[-10:]) < 0.1 * np.mean(losses[:10])

    target = (expert_gain - lo) / (hi - lo)
    records = []
    for i in range(4):                      # held-out slices
        mat = dict(make_mat_record(seed=10_000 + i))
        states = mat["x0"][..., 0].reshape(1, -1).astype(np.float32)
        mat["x0"] = np.clip(mat["x0"], 0, None)
        records.append(((states, np.full((1, 1), target, np.float32),
                         np.zeros(3, np.float32),
                         np.asarray([OPTIMAL_TASKS.index("4x_15")])), mat))
    inc = {}
    for tag, dt in (("trained", trainer.state.model),
                    ("random", initial_model())):
        ev = Evaluator(dt=dt.eval().requires_grad_(False),
                       denoise=blur_denoise, cfg=cfg, max_timesteps=12,
                       device="cpu")
        inc[tag] = float(np.mean(ev.evaluate_records(records)["increment"]))
    assert inc["trained"] > 0.5 * expert_gain, (inc, expert_gain)
    assert inc["trained"] > inc["random"] + 0.3, inc
