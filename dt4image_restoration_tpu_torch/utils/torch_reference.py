"""Plain functional restatement of the reference CSMRI pipeline's U-Net
prior and fixed-parameter PnP-ADMM loop, on state dicts in the reference
checkpoint's key layout, and of DPIR's DRUNet prior on its ``UNetRes``
layout, and of Restormer's on its ``restormer_arch.py`` layout.

The parity oracle (:mod:`.torch_oracle`) denoises through these functions.
They are written against the reference's documented behaviour
(evaluation/noise.py, evaluation/env.py, cited per function) and share no
code with the port's models (``models/unet.py``), so that the yardstick
the port is held to cannot move with the port. Counterpart of the JAX
package's ``utils/torch_reference.py``: the same functions on the same
seeds give the same tensors. The ARNIQA random state dict is
``models/arniqa.py:random_arniqa_state_dict``. DRUNet and Restormer have
no JAX twin: the port's ``models/drunet.py`` is held to
:func:`torch_drunet_forward`, its ``models/restormer.py`` to
:func:`torch_restormer_forward`.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F

UNET_CHANNELS = [32, 64, 128, 256, 512]


def random_unet_state_dict(seed: int = 0) -> Dict[str, torch.Tensor]:
    """Random U-Net weights in the reference checkpoint's key layout
    (noise.py:101-113 module structure).

    He-scaled (std = sqrt(2/fan_in)) so activations stay O(1) through the
    27-conv network: with exploding weights the 30-iteration ADMM feedback
    loop is numerically chaotic and cross-framework parity is meaningless.
    The residual head is further damped so the random denoiser is
    near-contractive, like a trained one.
    """
    gen = torch.Generator().manual_seed(seed)
    sd = {}

    def conv(name, c_out, c_in, k, gain=1.0):
        std = gain * (2.0 / (c_in * k * k)) ** 0.5
        sd[name + ".weight"] = std * torch.randn(c_out, c_in, k, k,
                                                 generator=gen)
        sd[name + ".bias"] = 0.01 * torch.randn(c_out, generator=gen)

    def add_block(prefix, c_in, c_out):
        chans = [c_in, c_out, c_out, c_out]
        for i in range(3):
            conv(f"{prefix}.conv-{i}.conv2d", chans[i + 1], chans[i], 3)

    add_block("inc.conv", 2, 32)
    for k in range(1, 5):
        add_block(f"down{k}.mpconv.1", UNET_CHANNELS[k - 1],
                  UNET_CHANNELS[k])
    for k in range(1, 5):
        c_skip = UNET_CHANNELS[4 - k]
        c_up = UNET_CHANNELS[5 - k]
        add_block(f"up{k}.conv", c_skip + c_up, c_skip)
    conv("outc.conv", 1, 32, 1, gain=0.1)
    return sd


def torch_unet_forward(sd, x):
    """Residual U-Net forward (noise.py:119-133) via torch.nn.functional."""
    def block(prefix, t):
        for i in range(3):
            t = F.conv2d(t, sd[f"{prefix}.conv-{i}.conv2d.weight"],
                         sd[f"{prefix}.conv-{i}.conv2d.bias"], padding=1)
            t = F.leaky_relu(t, 0.2)
        return t

    def up(prefix, t, skip):
        t = F.interpolate(t, scale_factor=2, mode="bilinear",
                          align_corners=True)
        return block(prefix, torch.cat([skip, t], dim=1))

    x1 = block("inc.conv", x)
    x2 = block("down1.mpconv.1", F.max_pool2d(x1, 2))
    x3 = block("down2.mpconv.1", F.max_pool2d(x2, 2))
    x4 = block("down3.mpconv.1", F.max_pool2d(x3, 2))
    x5 = block("down4.mpconv.1", F.max_pool2d(x4, 2))
    y = up("up1.conv", x5, x4)
    y = up("up2.conv", y, x3)
    y = up("up3.conv", y, x2)
    y = up("up4.conv", y, x1)
    residual = F.conv2d(y, sd["outc.conv.weight"], sd["outc.conv.bias"])
    return x[:, :1] + residual


def torch_denoise(sd, img, sigma: float):
    """UNetDenoiser2D wrapper (noise.py:155-164): sigma noise-map channel,
    clamp to [0,1]."""
    n, _, h, w = img.shape
    noise_map = torch.full((n, 1, h, w), float(sigma))
    return torch.clamp(torch_unet_forward(
        sd, torch.cat([img, noise_map], dim=1)), 0, 1)


@contextlib.contextmanager
def _no_tf32() -> Iterator[None]:
    """float32 products in float32 on a CUDA device too (TF32 off)."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def torch_drunet_forward(sd: Mapping[str, torch.Tensor], x: torch.Tensor
                         ) -> torch.Tensor:
    """DRUNet's forward (DPIR ``models/network_unet.py:UNetRes.forward``,
    ``drunet_gray``) on (B, in, H, W) float32 inputs, with TF32 off, on a
    state dict in DPIR's layout: ``m_head``, ``m_down{1,2,3}.{0..nb-1}``
    ResBlocks (``res.0``, ReLU, ``res.2``) then ``.{nb}`` the 2x2 stride-2
    conv, ``m_body.{0..nb-1}``, ``m_up{3,2,1}.0`` the 2x2 stride-2
    transposed conv then ``.{1..nb}`` ResBlocks, ``m_tail``; bias-free.
    Sides must be multiples of 8: DPIR pads other inputs outside the
    network, which is left out here."""
    nb = sum(1 for k in sd if k.startswith("m_body.")
             and k.endswith(".res.0.weight"))

    def blocks(prefix, h, first):
        for i in range(first, first + nb):
            r = F.relu(F.conv2d(h, sd[f"{prefix}.{i}.res.0.weight"],
                                padding=1))
            h = h + F.conv2d(r, sd[f"{prefix}.{i}.res.2.weight"], padding=1)
        return h

    def down(k, h):
        return F.conv2d(blocks(f"m_down{k}", h, 0),
                        sd[f"m_down{k}.{nb}.weight"], stride=2)

    def up(k, h):
        return blocks(f"m_up{k}", F.conv_transpose2d(
            h, sd[f"m_up{k}.0.weight"], stride=2), 1)

    with _no_tf32():
        x1 = F.conv2d(x, sd["m_head.weight"], padding=1)
        x2 = down(1, x1)
        x3 = down(2, x2)
        x4 = down(3, x3)
        y = blocks("m_body", x4, 0)
        y = up(3, y + x4)
        y = up(2, y + x3)
        y = up(1, y + x2)
        return F.conv2d(y + x1, sd["m_tail.weight"], padding=1)


def torch_drunet_denoise(sd, img, sigma):
    """DRUNet as a plug-in prior: the image and its sigma noise map (DPIR's
    second input channel; ``sigma`` a float or (B,)), the output clamped to
    [0, 1] as the DT4IR prior's wrapper clamps (noise.py:155-164; DPIR's
    own loop does not clamp inside the network)."""
    n, _, h, w = img.shape
    noise_map = torch.as_tensor(sigma, dtype=img.dtype,
                                device=img.device).reshape(
        -1, 1, 1, 1).expand(n, 1, h, w)
    return torch.clamp(torch_drunet_forward(
        sd, torch.cat([img, noise_map], dim=1)), 0, 1)


def torch_restormer_forward(sd: Mapping[str, torch.Tensor], x: torch.Tensor
                            ) -> torch.Tensor:
    """Restormer's forward (``swz30/Restormer``
    ``basicsr/models/archs/restormer_arch.py:Restormer.forward``, BiasFree
    LayerNorms, no biases, no dual-pixel task) on (B, in, H, W) float32
    inputs, with TF32 off, on a state dict in its layout:
    ``patch_embed.proj``; ``encoder_level{1,2,3}``, ``latent``,
    ``decoder_level{3,2,1}`` and ``refinement``, each a list of blocks
    (``norm1.body``, ``attn.{temperature,qkv,qkv_dwconv,project_out}``,
    ``norm2.body``, ``ffn.{project_in,dwconv,project_out}``);
    ``down{1_2,2_3,3_4}.body.0``; ``up{4_3,3_2,2_1}.body.0``;
    ``reduce_chan_level{3,2}``; ``output``. The head counts come from the
    temperatures' shapes. Departure: the global residual is the caller's
    (:func:`torch_restormer_denoise` adds the image channel), since the
    network's input holds the sigma map beside the image."""

    def layer_norm(p, t):             # BiasFree_LayerNorm over channels
        t3 = t.permute(0, 2, 3, 1)
        var = t3.var(-1, keepdim=True, unbiased=False)
        out = t3 / torch.sqrt(var + 1e-5) * sd[p + ".body.weight"]
        return out.permute(0, 3, 1, 2)

    def attention(p, t):
        b, c, h, w = t.shape
        temperature = sd[p + ".temperature"]
        heads = temperature.shape[0]
        qkv = F.conv2d(F.conv2d(t, sd[p + ".qkv.weight"]),
                       sd[p + ".qkv_dwconv.weight"], padding=1,
                       groups=3 * c)
        q, k, v = (u.reshape(b, heads, c // heads, h * w)
                   for u in qkv.chunk(3, dim=1))
        q = F.normalize(q, dim=-1)
        k = F.normalize(k, dim=-1)
        attn = ((q @ k.transpose(-2, -1)) * temperature).softmax(dim=-1)
        out = (attn @ v).reshape(b, c, h, w)
        return F.conv2d(out, sd[p + ".project_out.weight"])

    def feed_forward(p, t):
        hidden = sd[p + ".project_in.weight"]
        t = F.conv2d(F.conv2d(t, hidden), sd[p + ".dwconv.weight"],
                     padding=1, groups=hidden.shape[0])
        x1, x2 = t.chunk(2, dim=1)
        return F.conv2d(F.gelu(x1) * x2, sd[p + ".project_out.weight"])

    def level(name, t):
        n = len({k.split(".")[1] for k in sd if k.startswith(name + ".")})
        for i in range(n):
            p = f"{name}.{i}"
            t = t + attention(p + ".attn", layer_norm(p + ".norm1", t))
            t = t + feed_forward(p + ".ffn", layer_norm(p + ".norm2", t))
        return t

    def down(name, t):
        return F.pixel_unshuffle(
            F.conv2d(t, sd[name + ".body.0.weight"], padding=1), 2)

    def up(name, t):
        return F.pixel_shuffle(
            F.conv2d(t, sd[name + ".body.0.weight"], padding=1), 2)

    with _no_tf32():
        inp_enc_level1 = F.conv2d(x, sd["patch_embed.proj.weight"],
                                  padding=1)
        out_enc_level1 = level("encoder_level1", inp_enc_level1)
        out_enc_level2 = level("encoder_level2",
                               down("down1_2", out_enc_level1))
        out_enc_level3 = level("encoder_level3",
                               down("down2_3", out_enc_level2))
        latent = level("latent", down("down3_4", out_enc_level3))
        inp_dec_level3 = torch.cat([up("up4_3", latent), out_enc_level3], 1)
        inp_dec_level3 = F.conv2d(inp_dec_level3,
                                  sd["reduce_chan_level3.weight"])
        out_dec_level3 = level("decoder_level3", inp_dec_level3)
        inp_dec_level2 = torch.cat([up("up3_2", out_dec_level3),
                                    out_enc_level2], 1)
        inp_dec_level2 = F.conv2d(inp_dec_level2,
                                  sd["reduce_chan_level2.weight"])
        out_dec_level2 = level("decoder_level2", inp_dec_level2)
        inp_dec_level1 = torch.cat([up("up2_1", out_dec_level2),
                                    out_enc_level1], 1)
        out_dec_level1 = level("decoder_level1", inp_dec_level1)
        out_dec_level1 = level("refinement", out_dec_level1)
        return F.conv2d(out_dec_level1, sd["output.weight"], padding=1)


def torch_restormer_denoise(sd, img, sigma):
    """Restormer as a plug-in prior. Departures from ``Restormer.forward``:
    the network's input is the image and its sigma noise map (``sigma`` a
    float or (B,)), as DPIR's and the DT4IR U-Net's, so that the policy's
    sigma reaches the prior; the global residual adds the image channel;
    the output is clamped to [0, 1], as the DT4IR prior's wrapper clamps
    (noise.py:155-164)."""
    n, _, h, w = img.shape
    noise_map = torch.as_tensor(sigma, dtype=img.dtype,
                                device=img.device).reshape(
        -1, 1, 1, 1).expand(n, 1, h, w)
    out = torch_restormer_forward(sd, torch.cat([img, noise_map], dim=1))
    return torch.clamp(out + img, 0, 1)


def torch_admm_rollout(sd, mat: Mapping[str, np.ndarray], mu: float,
                       sigma_d: float, n_iters: int = 30
                       ) -> Tuple[np.ndarray, float]:
    """Fixed-parameter PnP-ADMM loop (env.py:85-98) on the CPU.

    Returns (final real image (B, 1, H, W), PSNR dB vs gt).
    """
    def fft2c(t):
        t = torch.fft.ifftshift(t, dim=(-2, -1))
        t = torch.fft.fftn(t, dim=(-2, -1), norm="ortho")
        return torch.fft.fftshift(t, dim=(-2, -1))

    def ifft2c(t):
        t = torch.fft.ifftshift(t, dim=(-2, -1))
        t = torch.fft.ifftn(t, dim=(-2, -1), norm="ortho")
        return torch.fft.fftshift(t, dim=(-2, -1))

    s = np.asarray(mat["mask"]).shape[-1]     # square slices, 128 in use
    x0 = torch.from_numpy(np.asarray(mat["x0"], np.float32))
    x = torch.view_as_complex(x0).reshape(-1, 1, s, s)
    y0 = torch.view_as_complex(
        torch.from_numpy(np.asarray(mat["y0"], np.float32))).reshape(
        -1, 1, s, s)
    mask = torch.from_numpy(np.asarray(mat["mask"])).reshape(
        -1, 1, s, s).bool()
    gt = torch.from_numpy(np.asarray(mat["gt"], np.float32)).reshape(
        -1, 1, s, s)

    z = x.clone()
    u = torch.zeros_like(x)
    with torch.no_grad():
        for _ in range(n_iters):
            x = torch_denoise(sd, (z - u).real, sigma_d).to(torch.complex64)
            z = fft2c(x + u)
            temp = (mu * z + y0) / (1 + mu)
            z = torch.where(mask, temp, z)
            z = ifft2c(z)
            u = u + x - z

    out = torch.clamp(x.real, 0, 1)
    mse = torch.mean((out - gt) ** 2)
    psnr = float(10 * torch.log10(1.0 / mse))
    return out.numpy(), psnr
