"""The port's PnP-ADMM environment against the JAX package's: reset from
.mat records, one masked ADMM step, and the 30-iteration fixed-parameter
rollout (PSNR within the 0.05 dB band), with one U-Net's weights shared by
both frameworks."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dt4image_restoration_tpu.data import make_mat_record as j_make_record
from dt4image_restoration_tpu.env import pnp as jpnp
from dt4image_restoration_tpu_torch.data import make_mat_record
from dt4image_restoration_tpu_torch.env import pnp
from torch_port_common import one_torch_thread  # noqa: F401
from torch_port_common import shared_denoisers

SIZE, BASE = 48, 8


def _records(n, size=SIZE):
    recs = [make_mat_record(size=size, acceleration=4, noise_sigma=10.0,
                            seed=s) for s in range(n)]
    return {k: np.concatenate([r[k] for r in recs]) for k in recs[0]}


def test_synthetic_record_matches_jax():
    ours = make_mat_record(size=32, acceleration=8, noise_sigma=5.0, seed=3)
    theirs = j_make_record(size=32, acceleration=8, noise_sigma=5.0, seed=3)
    assert set(ours) == set(theirs)
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k])


def test_reset_from_mat_matches_jax():
    mat = _records(2)
    s = pnp.reset_from_mat(mat, device="cpu")
    j = jpnp.reset_from_mat(mat)
    assert s.batch == 2 and s.z.dtype == torch.complex64
    np.testing.assert_array_equal(s.x.numpy(), np.asarray(j.x))
    np.testing.assert_array_equal(torch.view_as_real(s.z).numpy(),
                                  np.asarray(j.z))
    np.testing.assert_array_equal(torch.view_as_real(s.y0).numpy(),
                                  np.asarray(j.y0))
    np.testing.assert_array_equal(s.mask.numpy(), np.asarray(j.mask))
    np.testing.assert_array_equal(s.gt.numpy(), np.asarray(j.gt))
    assert not s.done.any() and not s.T.any() and not s.u.abs().any()


@pytest.fixture(scope="module")
def denoisers():
    return shared_denoisers(seed=4, base=BASE)


def test_admm_step_matches_jax(denoisers):
    model, j_denoise = denoisers
    mat = _records(3)
    # Slice 1 stops at once (T > 0.5) and must come back unchanged.
    action = {"T": np.asarray([0.1, 0.9, 0.2], np.float32),
              "mu": np.asarray([0.3, 0.5, 1.2], np.float32),
              "sigma_d": np.asarray([0.05, 0.1, 0.2], np.float32)}
    s0 = pnp.reset_from_mat(mat, device="cpu")
    s1 = pnp.admm_step(model, s0, {k: torch.from_numpy(v)
                                   for k, v in action.items()})
    j1 = jpnp.admm_step(j_denoise, jpnp.reset_from_mat(mat),
                        {k: jnp.asarray(v) for k, v in action.items()})
    np.testing.assert_allclose(s1.x.numpy(), np.asarray(j1.x), rtol=1e-4,
                               atol=2e-5)
    np.testing.assert_allclose(torch.view_as_real(s1.z).numpy(),
                               np.asarray(j1.z), rtol=1e-4, atol=2e-5)
    np.testing.assert_allclose(torch.view_as_real(s1.u).numpy(),
                               np.asarray(j1.u), rtol=1e-4, atol=2e-5)
    np.testing.assert_array_equal(s1.done.numpy(), [False, True, False])
    np.testing.assert_allclose(s1.T.numpy(), np.asarray(j1.T))
    assert torch.equal(s1.x[1], s0.x[1]) and torch.equal(s1.z[1], s0.z[1])


def test_fixed_param_rollout_psnr_matches_jax(denoisers):
    model, j_denoise = denoisers
    mat = _records(2)
    final, hist = pnp.fixed_param_rollout(
        model, pnp.reset_from_mat(mat, device="cpu"), mu=0.5, sigma_d=0.05,
        n_iters=30)
    jfinal, jhist = jax.jit(
        lambda s: jpnp.fixed_param_rollout(j_denoise, s, 0.5, 0.05, 30))(
        jpnp.reset_from_mat(mat))
    assert hist.shape == (30, 2, 1)
    ours = pnp.compute_reward(final).numpy()
    theirs = np.asarray(jpnp.compute_reward(jfinal))
    assert np.all(np.isfinite(ours))
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=0.05)
    np.testing.assert_allclose(hist.numpy(), np.asarray(jhist), rtol=0,
                               atol=0.05)
    # The rollout restores: PSNR rises above the zero-filled start.
    start = pnp.compute_reward(pnp.reset_from_mat(mat, device="cpu"))
    assert np.all(ours > start.numpy())


def test_env_wrapper_and_policy_ob(denoisers):
    model, _ = denoisers
    env = pnp.PnPEnv(model, device="cpu")
    s = env.reset(_records(1))
    s2, done = env.step(s, {"T": 0.0, "mu": 0.5, "sigma_d": 0.05})
    assert env.get_policy_ob(s2).shape == (1, SIZE * SIZE)
    assert env.compute_reward(s2).shape == (1, 1) and not done.any()
    np.testing.assert_allclose(s2.T.numpy(), [1.0 / 30.0])
