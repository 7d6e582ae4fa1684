"""Numerics ops of the port. Kernels live in :mod:`.kernels`."""
from .csmri import kspace_consistency, spi_inverse
from .fourier import fft2c, ifft2c
from .image import (bilinear_upsample_2x, complex2channel, depth_to_space,
                    greyscale_to_rgb, pack_conv_bias, pack_conv_weights,
                    repad_cells, resize_bilinear, space_to_depth,
                    space_to_depth_shifted)
from .metrics import bandwise_psnr, psnr, ssim
from .winograd import (winograd_apply, winograd_conv3x3_same,
                       winograd_weights)

__all__ = ["bandwise_psnr", "bilinear_upsample_2x", "complex2channel",
           "depth_to_space", "fft2c", "greyscale_to_rgb", "ifft2c",
           "kspace_consistency", "pack_conv_bias", "pack_conv_weights",
           "psnr", "repad_cells", "resize_bilinear", "space_to_depth",
           "space_to_depth_shifted", "spi_inverse", "ssim",
           "winograd_apply", "winograd_conv3x3_same", "winograd_weights"]
