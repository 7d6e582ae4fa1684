"""The port's remaining numerics ops against the JAX package's on the same
numpy inputs: the space-to-depth family and Winograd convolution that the
U-Net's execution modes run, bilinear resizing, the channel layouts,
SSIM, band-wise PSNR and the single-photon-imaging proximal operator.
Layout-only functions must agree exactly; the others within the PARITY.md
band of 1e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dt4image_restoration_tpu.ops import csmri as jcsmri
from dt4image_restoration_tpu.ops import image as jimage
from dt4image_restoration_tpu.ops import metrics as jmetrics
from dt4image_restoration_tpu.ops import winograd as jwinograd
from dt4image_restoration_tpu_torch.ops import (
    bandwise_psnr, complex2channel, depth_to_space, greyscale_to_rgb,
    pack_conv_bias, pack_conv_weights, repad_cells, resize_bilinear,
    space_to_depth, space_to_depth_shifted, spi_inverse, ssim,
    winograd_conv3x3_same, winograd_weights)
from torch_port_common import one_torch_thread  # noqa: F401


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("fn", ["space_to_depth", "space_to_depth_shifted"])
@pytest.mark.parametrize("shape", [(2, 8, 6, 3), (1, 4, 4, 1)])
def test_space_to_depth_matches_jax(rng, fn, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    ref = np.asarray(getattr(jimage, fn)(jnp.asarray(x)))
    got = {"space_to_depth": space_to_depth,
           "space_to_depth_shifted": space_to_depth_shifted}[fn](_nchw(x))
    np.testing.assert_array_equal(_nhwc(got), ref)


@pytest.mark.parametrize("fn", ["depth_to_space", "repad_cells"])
def test_cell_layouts_match_jax(rng, fn):
    y = rng.standard_normal((2, 3, 5, 12)).astype(np.float32)
    ref = np.asarray(getattr(jimage, fn)(jnp.asarray(y)))
    got = {"depth_to_space": depth_to_space,
           "repad_cells": repad_cells}[fn](_nchw(y))
    np.testing.assert_array_equal(_nhwc(got), ref)


def test_depth_to_space_inverts_space_to_depth(rng):
    x = torch.from_numpy(rng.standard_normal((2, 3, 6, 10)).astype(
        np.float32))
    torch.testing.assert_close(depth_to_space(space_to_depth(x)), x,
                               rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["dense", "shift"])
def test_pack_conv_weights_matches_jax(rng, mode):
    w = rng.standard_normal((3, 3, 4, 5)).astype(np.float32)   # HWIO
    ref = np.asarray(jimage.pack_conv_weights(jnp.asarray(w), mode))
    got = pack_conv_weights(torch.from_numpy(
        np.ascontiguousarray(w.transpose(3, 2, 0, 1))), mode)  # OIHW
    np.testing.assert_array_equal(got.numpy().transpose(2, 3, 1, 0), ref)
    b = rng.standard_normal(5).astype(np.float32)
    np.testing.assert_array_equal(
        pack_conv_bias(torch.from_numpy(b)).numpy(),
        np.asarray(jimage.pack_conv_bias(jnp.asarray(b))))


@pytest.mark.parametrize("mode", ["dense", "shift"])
def test_packed_cell_conv_is_the_pixel_conv(rng, mode):
    """Two chained layers in the cell domain (with the repad between
    shifted ones) equal the SAME 3x3 pixel convs they rewrite."""
    x = torch.from_numpy(rng.standard_normal((2, 3, 8, 12)).astype(
        np.float32))
    ws = [torch.from_numpy(rng.standard_normal((4, c, 3, 3)).astype(
        np.float32)) for c in (3, 4)]
    ref = F.conv2d(F.conv2d(x, ws[0], padding=1), ws[1], padding=1)
    y = space_to_depth(x) if mode == "dense" else space_to_depth_shifted(x)
    for i, w in enumerate(ws):
        if mode == "shift" and i:
            y = repad_cells(y)
        y = F.conv2d(y, pack_conv_weights(w, mode),
                     padding=1 if mode == "dense" else 0)
    torch.testing.assert_close(depth_to_space(y), ref, rtol=1e-4,
                               atol=1e-4)


def test_pack_conv_weights_refuses_unknown_mode():
    with pytest.raises(ValueError, match="unknown packing mode"):
        pack_conv_weights(torch.zeros((1, 1, 3, 3)), "bogus")


def test_winograd_weights_match_jax(rng):
    w = rng.standard_normal((3, 3, 4, 6)).astype(np.float32)   # HWIO
    ref = np.asarray(jwinograd.winograd_weights(jnp.asarray(w)))
    got = winograd_weights(torch.from_numpy(
        np.ascontiguousarray(w.transpose(3, 2, 0, 1))))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("shape", [(2, 8, 6, 3), (1, 16, 16, 8)])
def test_winograd_conv_matches_jax(rng, shape, bias):
    x = rng.standard_normal(shape).astype(np.float32)
    k = (rng.standard_normal((3, 3, shape[-1], 5)) * 0.3).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32) if bias else None
    ref = np.asarray(jax.jit(jwinograd.winograd_conv3x3_same)(
        jnp.asarray(x), jnp.asarray(k),
        None if b is None else jnp.asarray(b)))
    got = winograd_conv3x3_same(
        _nchw(x), torch.from_numpy(np.ascontiguousarray(
            k.transpose(3, 2, 0, 1))),
        None if b is None else torch.from_numpy(b))
    np.testing.assert_allclose(_nhwc(got), ref, rtol=1e-4, atol=1e-4)


def test_winograd_conv_bfloat16_is_the_rounded_direct_conv(rng):
    """On bfloat16 operands the result is the direct conv of the same
    bfloat16 values, computed in float32, rounded to bfloat16 once."""
    x = torch.from_numpy(rng.standard_normal((2, 4, 10, 8)).astype(
        np.float32)).to(torch.bfloat16)
    w = torch.from_numpy((rng.standard_normal((6, 4, 3, 3)) * 0.3).astype(
        np.float32))
    b = torch.from_numpy(rng.standard_normal(6).astype(np.float32))
    got = winograd_conv3x3_same(x, w, b)
    assert got.dtype == torch.bfloat16
    ref = F.conv2d(x.float(), w.to(torch.bfloat16).float(),
                   b.to(torch.bfloat16).float(), padding=1)
    torch.testing.assert_close(got.float(), ref, rtol=2 ** -7, atol=1e-4)


def test_winograd_conv_refuses_odd_sizes():
    with pytest.raises(ValueError, match="even H, W"):
        winograd_conv3x3_same(torch.zeros((1, 1, 5, 4)),
                              torch.zeros((1, 1, 3, 3)))


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("shape,out", [((2, 3, 8, 6), (16, 12)),
                                       ((1, 2, 128, 128), (64, 64)),
                                       ((1, 1, 5, 7), (1, 9))])
def test_resize_bilinear_matches_jax(rng, shape, out, align_corners):
    x = rng.uniform(0, 1, shape).astype(np.float32)
    ref = np.asarray(jimage.resize_bilinear(
        jnp.asarray(x.transpose(0, 2, 3, 1)), *out, align_corners))
    got = resize_bilinear(torch.from_numpy(x), *out, align_corners)
    np.testing.assert_allclose(_nhwc(got), ref, rtol=1e-4, atol=1e-5)


def test_complex2channel_and_greyscale_to_rgb_match_jax(rng):
    z = rng.standard_normal((2, 3, 4, 5, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        complex2channel(torch.from_numpy(z)).numpy(),
        np.asarray(jimage.complex2channel(jnp.asarray(z))))
    g = rng.uniform(0, 1, (1, 6, 7)).astype(np.float32)
    np.testing.assert_array_equal(
        greyscale_to_rgb(torch.from_numpy(g)).numpy(),
        np.asarray(jimage.greyscale_to_rgb(jnp.asarray(g))))


@pytest.mark.parametrize("shape", [(32, 40), (9, 6)])
def test_ssim_matches_jax(rng, shape):
    a = rng.uniform(0, 255, shape).astype(np.float32)
    b = np.clip(a + rng.normal(0, 20, shape), 0, 255).astype(np.float32)
    ref_map, ref_mean = jmetrics.ssim(jnp.asarray(a), jnp.asarray(b))
    got_map, got_mean = ssim(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got_map.numpy(), np.asarray(ref_map),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(got_mean), float(ref_mean), rtol=1e-4)


def test_bandwise_psnr_matches_jax(rng):
    x = rng.uniform(0, 255, (2, 4, 16, 16)).astype(np.float32)
    y = np.clip(x + rng.normal(0, 5, x.shape), 0, 255).astype(np.float32)
    ref = float(jmetrics.bandwise_psnr(jnp.asarray(x), jnp.asarray(y)))
    got = float(bandwise_psnr(torch.from_numpy(x), torch.from_numpy(y)))
    np.testing.assert_allclose(got, ref, rtol=1e-5)


@pytest.mark.parametrize("mu", [0.5, 3.0])
def test_spi_inverse_matches_jax(rng, mu):
    shape = (2, 16, 16)
    ztilde = rng.uniform(-0.2, 1.2, shape).astype(np.float32)
    k = rng.integers(0, 4, shape).astype(np.float32)
    k1 = np.where(rng.uniform(size=shape) < 0.3, 0.0,
                  rng.integers(1, 3, shape)).astype(np.float32)
    ref = np.asarray(jcsmri.spi_inverse(jnp.asarray(ztilde),
                                        jnp.asarray(k1), jnp.asarray(k),
                                        mu))
    got = spi_inverse(torch.from_numpy(ztilde), torch.from_numpy(k1),
                      torch.from_numpy(k), mu)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)
