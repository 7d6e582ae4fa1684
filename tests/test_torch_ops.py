"""The port's numerics ops against the JAX package's, on the same numpy
inputs: FFT pair, k-space consistency, PSNR, bilinear upsampling."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dt4image_restoration_tpu import ops as jops
from dt4image_restoration_tpu_torch import ops as tops
from torch_port_common import one_torch_thread  # noqa: F401

RTOL = 1e-4


def _complex(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("fn", ["fft2c", "ifft2c"])
@pytest.mark.parametrize("shape", [(2, 1, 16, 16), (3, 1, 15, 20)])
def test_fourier_matches_jax(rng, fn, shape):
    x = _complex(rng, shape)
    got = getattr(tops, fn)(torch.from_numpy(x)).numpy()
    ref = np.asarray(getattr(jops, fn)(jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=1e-5)


def test_kspace_consistency_matches_jax(rng):
    b, h, w = 3, 16, 12
    z, y0 = _complex(rng, (b, 1, h, w)), _complex(rng, (b, 1, h, w))
    mask = rng.uniform(size=(b, 1, h, w)) < 0.3
    mu = rng.uniform(0.1, 2.0, (b,)).astype(np.float32)
    got = tops.kspace_consistency(torch.from_numpy(z), torch.from_numpy(y0),
                                  torch.from_numpy(mask),
                                  torch.from_numpy(mu)).numpy()
    ref = np.asarray(jops.kspace_consistency(
        jnp.asarray(z), jnp.asarray(y0), jnp.asarray(mask),
        jnp.asarray(mu)[:, None, None, None]))
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=1e-6)
    # Unsampled locations pass through untouched.
    np.testing.assert_array_equal(got[~mask], z[~mask])


def test_psnr_matches_jax(rng):
    out = rng.uniform(-0.2, 1.2, (4, 1, 16, 16)).astype(np.float32)
    gt = rng.uniform(0, 1, (4, 1, 16, 16)).astype(np.float32)
    got = tops.psnr(torch.from_numpy(out), torch.from_numpy(gt)).numpy()
    ref = np.asarray(jops.psnr(jnp.asarray(out), jnp.asarray(gt)))
    assert got.shape == (4, 1)
    np.testing.assert_allclose(got, ref, rtol=RTOL)
    # Complex input: the real part is used.
    gotc = tops.psnr(torch.from_numpy(out.astype(np.complex64) + 0.5j),
                     torch.from_numpy(gt)).numpy()
    np.testing.assert_allclose(gotc, ref, rtol=RTOL)


@pytest.mark.parametrize("hw", [(4, 4), (5, 7), (16, 16)])
def test_bilinear_upsample_matches_jax(rng, hw):
    x = rng.standard_normal((2, 3) + hw).astype(np.float32)   # NCHW
    got = tops.bilinear_upsample_2x(torch.from_numpy(x)).numpy()
    ref = np.asarray(jops.bilinear_upsample_2x(
        jnp.asarray(x.transpose(0, 2, 3, 1)))).transpose(0, 3, 1, 2)
    # JAX interpolates with two float32 matmuls, torch with a gather; near
    # zero the relative band is meaningless, so the absolute one is 1e-5
    # of the O(1) inputs.
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=1e-5)
