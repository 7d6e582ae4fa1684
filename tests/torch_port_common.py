"""Shared set-up of the port's tests: one random U-Net's weights in the
port's ``UNetDenoiser`` and in a JAX ``UNet`` of the same width, and a
fixture that keeps PyTorch to one CPU thread."""
import jax.numpy as jnp
import pytest
import torch

from dt4image_restoration_tpu.models.unet import UNet as JUNet
from dt4image_restoration_tpu_torch.models import (UNetDenoiser,
                                                   random_unet_state_dict)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run a test module's PyTorch ops on one thread. The suite runs in
    several worker processes at once; PyTorch's default of one OpenMP
    thread per core in each of them oversubscribes the cores and slows the
    whole run several-fold. Import this fixture into a test module to use
    it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def shared_denoisers(seed: int = 4, base: int = 8):
    """``(port UNetDenoiser, jax denoise(img NHWC, sigma (B,)))`` on the
    same He-scaled random weights."""
    sd = random_unet_state_dict(seed=seed, base_channels=base)
    model = UNetDenoiser(base)
    model.load_state_dict(sd)
    model.eval().requires_grad_(False)
    net = {}
    for key, v in sd.items():
        _, block, leaf = key.split(".", 2)           # net.<block>.<leaf>
        conv, kind = ("", leaf) if block == "outc" else leaf.split(".")
        v = v.numpy()
        dst = net.setdefault(block, {})
        if conv:
            dst = dst.setdefault(conv, {})
        dst["kernel" if kind == "weight" else "bias"] = \
            v.transpose(2, 3, 1, 0) if kind == "weight" else v
    jnet = JUNet(base_channels=base)

    def j_denoise(img, sigma):
        smap = jnp.broadcast_to(sigma.reshape(-1, 1, 1, 1), img.shape)
        out = jnet.apply({"params": net}, jnp.concatenate([img, smap], -1))
        return jnp.clip(out, 0.0, 1.0)

    return model, j_denoise
