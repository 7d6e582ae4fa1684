"""The port's U-Net in every execution mode (``--unet_packed``) and compute
dtype against the JAX package's U-Net in the same mode and dtype, on the
same weights (a base-8 U-Net, as the JAX ``UNetDenoiser`` wraps it: the
sigma noise-map channel and the clamp) and inputs, at 32x32 and at an odd
size where the full-resolution blocks take the direct convs.

Float32 modes are held to the U-Net band of PARITY.md (1e-3 relative,
2e-4 absolute). Under bfloat16, elementwise agreement is not the point
(rounding of random-weight activations swings values across the clamp);
a mode is held to the JAX package's rule (tests/test_unet.py): its mean
distance from the float32 output at most 1.5x that of the direct bfloat16
forward, plus 1e-4, and within 2e-2 of the JAX model in the same mode."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dt4image_restoration_tpu.models.unet import UNet as JUNet
from dt4image_restoration_tpu_torch.models import (UNetDenoiser,
                                                   random_unet_state_dict)
from dt4image_restoration_tpu_torch.models.unet import UNET_MODES
from torch_port_common import jax_unet_params
from torch_port_common import one_torch_thread  # noqa: F401

BASE = 8
J_PACKED = {"none": False, "s2d": True, "pallas": "pallas",
            "winograd": "winograd", "winograd_deep": "winograd_deep"}
J_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
SIGMA = np.asarray([0.06, 0.1], np.float32)
BLOCKS = ("inc", "down1", "down2", "down3", "down4", "up1", "up2", "up3",
          "up4")


@pytest.fixture(scope="module")
def weights():
    sd = random_unet_state_dict(seed=4, base_channels=BASE)
    return sd, jax_unet_params(sd)


def _image(size):
    return np.random.default_rng(size).uniform(
        0, 1, (2, 1, size, size)).astype(np.float32)


_JAX_OUT = {}


def _jax(net, size, dtype, mode):
    """The JAX denoiser's output (NCHW float32), each computed once."""
    key = (size, dtype, mode)
    if key not in _JAX_OUT:
        jnet = JUNet(base_channels=BASE, dtype=J_DTYPES[dtype],
                     packed=J_PACKED[mode])

        def denoise(params, img, sigma):
            smap = jnp.broadcast_to(sigma.reshape(-1, 1, 1, 1), img.shape)
            out = jnet.apply({"params": params},
                             jnp.concatenate([img, smap], -1))
            return jnp.clip(out, 0.0, 1.0)

        out = jax.jit(denoise)(net, jnp.asarray(
            _image(size).transpose(0, 2, 3, 1)), jnp.asarray(SIGMA))
        _JAX_OUT[key] = np.asarray(out, np.float32).transpose(0, 3, 1, 2)
    return _JAX_OUT[key]


def _port(sd, size, dtype, mode):
    model = UNetDenoiser(BASE, dtype=dtype, packed=mode)
    model.load_state_dict(sd)
    model.eval().requires_grad_(False)
    out = model(torch.from_numpy(_image(size)), torch.from_numpy(SIGMA))
    assert out.dtype == torch.float32
    return out.numpy()


@pytest.mark.parametrize("mode", UNET_MODES)
@pytest.mark.parametrize("size", [32, 37])
def test_unet_mode_float32_matches_jax(weights, size, mode):
    sd, net = weights
    np.testing.assert_allclose(_port(sd, size, "float32", mode),
                               _jax(net, size, "float32", mode),
                               rtol=1e-3, atol=2e-4)


@pytest.mark.parametrize("mode", UNET_MODES)
@pytest.mark.parametrize("size", [32, 37])
def test_unet_mode_bfloat16_matches_jax(weights, size, mode):
    sd, net = weights
    got = _port(sd, size, "bfloat16", mode)
    f32 = _jax(net, size, "float32", "none")
    direct16 = _jax(net, size, "bfloat16", "none")
    err = float(np.mean(np.abs(got - f32)))
    assert err <= 1.5 * float(np.mean(np.abs(direct16 - f32))) + 1e-4
    np.testing.assert_allclose(got, _jax(net, size, "bfloat16", mode),
                               rtol=0, atol=2e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", UNET_MODES)
def test_block_modes_match_jax(mode, dtype):
    """Each block runs the mode the JAX U-Net gives it: s2d's shift on up4
    only in float32, pallas on inc and up4, winograd_deep on the five
    deep blocks."""
    port = UNetDenoiser(BASE, dtype=dtype, packed=mode).net
    jnet = JUNet(base_channels=BASE, dtype=J_DTYPES[dtype],
                 packed=J_PACKED[mode])
    for name in BLOCKS:
        assert getattr(port, name).packed == jnet._block_packed(name), name


def test_every_mode_runs_the_same_state_dict(weights):
    sd, _ = weights
    for dtype in ("float32", "bfloat16"):
        for mode in UNET_MODES:
            model = UNetDenoiser(BASE, dtype=dtype, packed=mode)
            assert set(model.state_dict()) == set(sd)
            model.load_state_dict(sd)
            for k, v in model.state_dict().items():
                assert v.dtype == torch.float32 and torch.equal(v, sd[k]), k


def test_unet_refuses_unknown_mode_and_dtype():
    with pytest.raises(ValueError, match="U-Net mode"):
        UNetDenoiser(BASE, packed="dense")
    with pytest.raises(ValueError, match="compute dtype"):
        UNetDenoiser(BASE, dtype="float16")


def test_packed_weights_follow_parameter_changes(weights):
    """A block's prepared weights (K1's pack, the cell or Winograd
    transforms) are remade after an in-place parameter update."""
    sd, _ = weights
    model = UNetDenoiser(BASE, dtype="bfloat16", packed="winograd")
    model.load_state_dict(sd)
    model.eval().requires_grad_(False)
    x, sigma = torch.from_numpy(_image(32)), torch.from_numpy(SIGMA)
    before = model(x, sigma)
    with torch.no_grad():
        model.net.up4.conv2.bias += 0.5
    after = model(x, sigma)
    assert not torch.equal(before, after)
    fresh = UNetDenoiser(BASE, dtype="bfloat16", packed="winograd")
    fresh.load_state_dict(model.state_dict())
    torch.testing.assert_close(fresh.eval()(x, sigma), after, rtol=0, atol=0)
