"""DRUNet, DPIR's deep residual U-Net, as the plug-in prior.

Zhang et al., "Plug-and-Play Image Restoration with Deep Denoiser Prior",
TPAMI 2021 (arXiv:2008.13751); ``cszn/DPIR`` ``models/network_unet.py:
UNetRes`` with the ``drunet_gray`` settings: ``in_nc=2`` (the image and the
sigma noise map), ``out_nc=1``, ``nc=[64, 128, 256, 512]``, ``nb=4``, ReLU,
2x2 stride-2 convs down, 2x2 stride-2 transposed convs up, no biases:

    x1 = head(x0); x2 = down1(x1); x3 = down2(x2); x4 = down3(x3)
    y = body(x4); y = up3(y + x4); y = up2(y + x3); y = up1(y + x2)
    out = tail(y + x1);    ResBlock(h) = h + conv3x3(relu(conv3x3(h)))

Weights (:func:`state_dict`) are in DPIR's key layout; the system is the
port's ``DRUNetDenoiser``, loaded through the port's converter.

The reference (:func:`reference`) follows ``UNetRes.forward`` in plain
torch, every product through :func:`portbench.reference.conv2d` and the
local :func:`_conv_transpose2d`, so that its operands round as the
precision says. Departures from DPIR: the sides must be multiples of 8
(DPIR pads other inputs outside the network); the output is clamped to
[0, 1], as the DT4IR prior's wrapper clamps (noise.py:155-164). Under
``precision="bfloat16"`` it also rounds every tensor of the residual
stream (the head's, the resampling convs' and the tail's outputs, and each
residual and skip sum) to bfloat16: a bfloat16 program keeps its
activations in bfloat16, and that storage is part of what the precision
alone explains. The other precisions keep the stream in float32.
"""
import torch
import torch.nn.functional as F

from portbench.counts import DTYPE_BYTES
from portbench.reference import conv2d, round_operand
from portbench.weights import _draw

__all__ = ["bytes", "flops", "fprop_flops", "reference", "state_dict",
           "system"]

# The random weights (:func:`state_dict`): each residual branch's second
# conv and the deep path's last transposed conv damped, and the noise
# around the head's and tail's linear image path, as shares of their scale.
RES_GAIN = 0.3
DEEP_GAIN = 0.3
EDGE_NOISE = 0.1
# The 3x3 smoothing that tail(head(.)) approximates on the image channel.
SMOOTH = ((1.0, 2.0, 1.0), (2.0, 20.0, 2.0), (1.0, 2.0, 1.0))


def _convs(cfg):
    """(name, weight shape, output side, transposed) of every conv, in
    DPIR's layout and order."""
    nc, nb, s = cfg["nc"], cfg["nb"], cfg["image_size"]
    out = [("m_head", (nc[0], cfg["in_channels"], 3, 3), s, False)]

    def blocks(prefix, c, side, first):
        for i in range(first, first + nb):
            out.extend((f"{prefix}.{i}.res.{j}", (c, c, 3, 3), side, False)
                       for j in (0, 2))

    for k in range(1, 4):
        blocks(f"m_down{k}", nc[k - 1], s >> (k - 1), 0)
        out.append((f"m_down{k}.{nb}", (nc[k], nc[k - 1], 2, 2), s >> k,
                    False))
    blocks("m_body", nc[3], s >> 3, 0)
    for k in range(3, 0, -1):
        out.append((f"m_up{k}.0", (nc[k], nc[k - 1], 2, 2), s >> (k - 1),
                    True))
        blocks(f"m_up{k}", nc[k - 1], s >> (k - 1), 1)
    out.append(("m_tail", (cfg["out_channels"], nc[0], 3, 3), s, False))
    return out


def _std(name, shape, transposed):
    """He before a ReLU, 1 / fan_in elsewhere (one tap an output for a
    2x2 stride-2 transposed conv), damped where the constants say."""
    if transposed:
        return (DEEP_GAIN if name == "m_up1.0" else 1.0) \
            * (1.0 / shape[0]) ** 0.5
    fan_in = shape[1] * shape[2] * shape[3]
    if name.endswith("res.0"):
        return (2.0 / fan_in) ** 0.5
    return (RES_GAIN if name.endswith("res.2") else 1.0) \
        * (1.0 / fan_in) ** 0.5


def state_dict(cfg, gen, device):
    """DRUNet in DPIR's layout, from one draw of ``gen``, near-contractive
    like a trained prior. DRUNet has no global residual, so He-scaled
    weights alone would make a random map of the image: here
    ``tail(head(.))`` is close to a mild smoothing of the image channel
    (head channel c takes the image's centre tap times a_c, the tail takes
    it through :data:`SMOOTH` times a_c / |a|^2, each with noise of
    :data:`EDGE_NOISE` of its scale); the convs in between keep the
    activations' scale, each residual branch's second conv is damped by
    :data:`RES_GAIN` and the deep path's last transposed conv by
    :data:`DEEP_GAIN`, so that the three lower scales give about a seventh
    of the output and a fault in any block shows."""
    convs = _convs(cfg)
    c0 = cfg["nc"][0]
    drawn = _draw([(name, shape) for name, shape, _, _ in convs]
                  + [("a", (c0,))], gen, device)
    a = drawn.pop("a")
    sd = {name + ".weight": drawn[name].mul_(_std(name, shape, tr))
          for name, shape, _, tr in convs}
    head = sd["m_head.weight"].mul_(EDGE_NOISE / 3.0)
    head[:, 0, 1, 1] += a
    b = a / a.dot(a)
    smooth = torch.tensor(SMOOTH, device=device)
    tail = sd["m_tail.weight"].mul_(EDGE_NOISE / 3.0 * b.norm() / c0 ** 0.5)
    tail[0] += b[:, None, None] * (smooth / smooth.sum())
    return sd


def system(cfg, sd, device):
    """The port's DRUNet on ``sd`` (DPIR's layout), frozen."""
    from dt4image_restoration_tpu_torch.models.drunet import DRUNetDenoiser
    from dt4image_restoration_tpu_torch.utils.convert import (
        drunet_from_reference, load_strict)
    if cfg["in_channels"] != 2 or cfg["out_channels"] != 1:
        raise ValueError("the port's DRUNet prior has 2 in / 1 out")
    with torch.device(device):
        den = DRUNetDenoiser(nc=cfg["nc"], nb=cfg["nb"], dtype=cfg["dtype"])
    load_strict(den, drunet_from_reference(sd), "DRUNet weights")
    return den.eval().requires_grad_(False)


def _conv_transpose2d(x, sd, name, precision):
    """``sd``'s bias-free 2x2 stride-2 transposed conv ``name`` on ``x``,
    its operands rounded."""
    return F.conv_transpose2d(round_operand(x, precision),
                              round_operand(sd[name + ".weight"], precision),
                              stride=2)


def reference(sd, img, sigma, precision):
    """(B, 1, H, W) images and (B,) strengths -> the clamped DRUNet output
    (``UNetRes.forward`` on the image and its noise map)."""
    b, _, h, w = img.shape
    nb = sum(1 for k in sd if k.startswith("m_body.")
             and k.endswith(".res.0.weight"))

    def stream(t):
        return round_operand(t, precision) if precision == "bfloat16" else t

    def blocks(prefix, t, first):
        for i in range(first, first + nb):
            r = F.relu(conv2d(t, sd, f"{prefix}.{i}.res.0", precision,
                              padding=1))
            t = stream(t + conv2d(r, sd, f"{prefix}.{i}.res.2", precision,
                                  padding=1))
        return t

    def down(k, t):
        return stream(conv2d(blocks(f"m_down{k}", t, 0), sd,
                             f"m_down{k}.{nb}", precision, stride=2))

    def up(k, t):
        return blocks(f"m_up{k}", stream(_conv_transpose2d(
            t, sd, f"m_up{k}.0", precision)), 1)

    x0 = torch.cat([img, sigma.reshape(b, 1, 1, 1).expand(b, 1, h, w)], 1)
    x1 = stream(conv2d(x0, sd, "m_head", precision, padding=1))
    x2 = down(1, x1)
    x3 = down(2, x2)
    x4 = down(3, x3)
    y = blocks("m_body", x4, 0)
    y = up(3, stream(y + x4))
    y = up(2, stream(y + x3))
    y = up(1, stream(y + x2))
    out = stream(conv2d(stream(y + x1), sd, "m_tail", precision, padding=1))
    return torch.clamp(out, 0, 1)


def _macs(shape, side, transposed):
    """Multiply-adds of one conv on one slice: a 2x2 stride-2 transposed
    conv gives each output one tap of each input channel."""
    c_out, c_in = (shape[1], shape[0]) if transposed else shape[:2]
    taps = 1 if transposed else shape[2] * shape[3]
    return side * side * c_out * c_in * taps


def flops(cfg):
    """FLOPs of one call on one slice: every conv, from the shapes (69.3
    GFLOP at 128^2 and the published widths)."""
    return sum(2.0 * _macs(shape, side, tr)
               for _, shape, side, tr in _convs(cfg))


def fprop_flops(cfg):
    """FLOPs of the forward convolutions of one call on one slice: the 58
    3x3 (head, ResBlocks, tail) and the three 2x2 stride-2 ones, the
    convolutions cuDNN runs as forward-convolution kernels (the transposed
    ones run as its data-gradient kernels)."""
    return sum(2.0 * _macs(shape, side, tr)
               for _, shape, side, tr in _convs(cfg) if not tr)


def bytes(cfg, batch):  # noqa: A001 - the name the harness calls
    """Bytes one call at ``batch`` must move: each conv's input read and
    its output written once in the compute dtype, one more read of the
    tensor each residual and skip sum adds, the float32 input (image and
    noise map) and output, and the weights in the compute dtype."""
    width = DTYPE_BYTES[cfg["dtype"]]
    s, nc, nb = cfg["image_size"], cfg["nc"], cfg["nb"]
    acts = 0
    for _, shape, side, tr in _convs(cfg):
        c_out, c_in = (shape[1], shape[0]) if tr else shape[:2]
        in_side = side // 2 if tr else side * (2 if shape[2] == 2 else 1)
        acts += in_side * in_side * c_in + side * side * c_out
    # Residual sums: 7 stages of nb blocks; skip sums: x4, x3, x2, x1.
    adds = nb * (sum((s >> k) ** 2 * nc[k] for k in range(3))
                 + (s >> 3) ** 2 * nc[3]
                 + sum((s >> k) ** 2 * nc[k] for k in range(3)))
    adds += sum((s >> k) ** 2 * nc[k] for k in range(4))
    io = s * s * (cfg["in_channels"] + cfg["out_channels"]) * 4
    weights = sum(torch.Size(shape).numel() for _, shape, _, _ in _convs(cfg))
    return batch * (width * (acts + adds) + io) + weights * width
