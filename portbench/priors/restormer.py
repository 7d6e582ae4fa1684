"""Restormer, the transposed-attention transformer, as the plug-in prior.

Zamir et al., "Restormer: Efficient Transformer for High-Resolution Image
Restoration", CVPR 2022 (arXiv:2111.09881); ``swz30/Restormer``
``basicsr/models/archs/restormer_arch.py:Restormer`` with the settings of
``Denoising/Options/GaussianGrayDenoising_Restormer.yml``: ``dim`` 48,
``num_blocks`` [4, 6, 6, 8], ``num_refinement_blocks`` 4, ``heads`` [1, 2,
4, 8], ``ffn_expansion_factor`` 2.66, no biases, BiasFree LayerNorms; here
``in_channels=2`` (the image and the sigma noise map) and
``out_channels=1``. A block at width C with h heads, H = int(2.66 C):

    x = x + conv1x1(A v),  q, k, v = dw3x3(conv1x1(LN(x), C -> 3C)),
        A = softmax_j(tau_h * normalize(q_i) . normalize(k_j))  per head
    x = x + conv1x1(gelu(x1) * x2),  x1, x2 = dw3x3(conv1x1(LN(x), C -> 2H))
    LN(x) = x / sqrt(var(x) + 1e-5) * w   over the channels, not centred

Weights (:func:`state_dict`) are in ``restormer_arch.py``'s key layout;
the system is the port's ``RestormerDenoiser``, loaded through the port's
converter.

The reference (:func:`reference`) follows ``Restormer.forward`` in plain
torch, every conv through :func:`portbench.reference.conv2d` and both
attention products through :func:`portbench.reference.round_operand`, so
that their operands round as the precision says. Departures from
Restormer: the input holds the sigma map beside the image, the global
residual adds the image channel, and the output is clamped to [0, 1], as
the DT4IR prior's wrapper clamps (noise.py:155-164). Under
``precision="bfloat16"`` it also rounds to bfloat16 every tensor a
bfloat16 program stores between the products: the residual stream after
each sum, the patch embedding's, the resampling convs' and the output
conv's outputs, and the depthwise conv's q, k, v; the LayerNorms'
statistics and the attention map stay float32, as the configuration
says. The other precisions keep those tensors in float32.
"""
import torch
import torch.nn.functional as F

from portbench.counts import DTYPE_BYTES, PEAK_BYTES_PER_S, PEAK_FLOPS
from portbench.reference import conv2d, round_operand
from portbench.weights import _draw

__all__ = ["attention_flops", "bytes", "flops", "gram_bound_s", "reference",
           "state_dict", "system"]

# The random weights (:func:`state_dict`): each block's two output 1x1
# convs damped, as a share of a variance-keeping scale; the noise around
# the patch embedding's and the output conv's linear image path, as a
# share of their scale; the LayerNorm scales and the temperatures drawn as
# N(1, AROUND_ONE^2).
RES_GAIN = 0.2
EDGE_NOISE = 0.1
SIGMA_GAIN = 10.0
AROUND_ONE = 0.05
# The 3x3 smoothing that the prior approximates on the image channel.
SMOOTH = ((1.0, 2.0, 1.0), (2.0, 20.0, 2.0), (1.0, 2.0, 1.0))
LN_EPS = 1e-5
LEVELS = ("encoder_level1", "encoder_level2", "encoder_level3", "latent",
          "decoder_level3", "decoder_level2", "decoder_level1",
          "refinement")


def _levels(cfg):
    """(name, width, heads, blocks, side) of each level of blocks, in
    ``restormer_arch.py``'s order of execution."""
    d, nb, hd, s = cfg["dim"], cfg["num_blocks"], cfg["heads"], \
        cfg["image_size"]
    widths = (d, 2 * d, 4 * d, 8 * d, 4 * d, 2 * d, 2 * d, 2 * d)
    heads = (hd[0], hd[1], hd[2], hd[3], hd[2], hd[1], hd[0], hd[0])
    blocks = (nb[0], nb[1], nb[2], nb[3], nb[2], nb[1], nb[0],
              cfg["num_refinement_blocks"])
    sides = (s, s // 2, s // 4, s // 8, s // 4, s // 2, s, s)
    return list(zip(LEVELS, widths, heads, blocks, sides))


def _hidden(cfg, width):
    return int(width * cfg["ffn_expansion_factor"])


def _convs(cfg):
    """(name, weight shape, output side, input side) of every conv, in
    ``restormer_arch.py``'s layout; a depthwise conv's shape is (C, 1, 3,
    3)."""
    d, s = cfg["dim"], cfg["image_size"]
    out = [("patch_embed.proj", (d, cfg["in_channels"], 3, 3), s, s)]
    by_level = {name: (w, hd, n, side)
                for name, w, hd, n, side in _levels(cfg)}

    def level(name):
        w, _, n, side = by_level[name]
        hid = _hidden(cfg, w)
        for i in range(n):
            p = f"{name}.{i}."
            out.extend((p + k, shape, side, side) for k, shape in (
                ("attn.qkv", (3 * w, w, 1, 1)),
                ("attn.qkv_dwconv", (3 * w, 1, 3, 3)),
                ("attn.project_out", (w, w, 1, 1)),
                ("ffn.project_in", (2 * hid, w, 1, 1)),
                ("ffn.dwconv", (2 * hid, 1, 3, 3)),
                ("ffn.project_out", (w, hid, 1, 1))))

    level("encoder_level1")
    for k, (a, b) in enumerate((("1", "2"), ("2", "3"), ("3", "4"))):
        w = d << k
        out.append((f"down{a}_{b}.body.0", (w // 2, w, 3, 3), s >> k,
                    s >> k))
        level("encoder_level" + b if b != "4" else "latent")
    for k, (a, b) in zip((3, 2, 1), (("4", "3"), ("3", "2"), ("2", "1"))):
        w = d << k
        out.append((f"up{a}_{b}.body.0", (2 * w, w, 3, 3), s >> k, s >> k))
        if b != "1":
            out.append((f"reduce_chan_level{b}", (w // 2, w, 1, 1),
                        s >> (k - 1), s >> (k - 1)))
        level("decoder_level" + b)
    level("refinement")
    out.append(("output", (cfg["out_channels"], 2 * d, 3, 3), s, s))
    return out


def state_dict(cfg, gen, device):
    """Restormer in ``restormer_arch.py``'s layout, from one draw of
    ``gen``, near-contractive like a trained prior. Restormer adds its
    output conv's result to the image, so random weights alone would add a
    random map of it; here the linear path from the patch embedding through
    the first level's residual stream (its skip into decoder level 1, the
    last ``dim`` channels there) to the output conv makes the prior close
    to a mild smoothing of the image channel: embedding channel c takes
    the image's centre tap times a_c, and the output conv takes channel
    ``dim + c`` through (smoothing - identity) times a_c / |a|^2, each
    with noise of :data:`EDGE_NOISE` of its scale. Every other conv keeps
    its input's scale (std 1 / sqrt(fan_in)), each block's two output 1x1
    convs are damped by :data:`RES_GAIN`, and the LayerNorm scales and the
    temperatures lie around 1, so that every level moves the answer by a
    modest, not a negligible, share: the latent level or the refinement
    left out reads far outside ``correct``'s limits
    (portbench/tests/test_bench_restormer.py, which also holds the first
    step's correction to 10-20 % of the image's RMS)."""
    convs = _convs(cfg)
    d = cfg["dim"]
    extra = []
    for name, w, hd, n, _ in _levels(cfg):
        for i in range(n):
            p = f"{name}.{i}."
            extra.extend([(p + "norm1.body.weight", (w,)),
                          (p + "norm2.body.weight", (w,)),
                          (p + "attn.temperature", (hd, 1, 1))])
    drawn = _draw([(name, shape) for name, shape, _, _ in convs] + extra
                  + [("a", (d,)), ("a2", (d,))], gen, device)
    a = drawn.pop("a")
    sd = {}
    for name, shape, _, _ in convs:
        if name in ("patch_embed.proj", "output"):
            continue
        fan_in = shape[1] * shape[2] * shape[3]
        gain = RES_GAIN if name.endswith("project_out") else 1.0
        sd[name + ".weight"] = drawn[name].mul_(gain * fan_in ** -0.5)
    for name, _ in extra:
        sd[name] = drawn[name].mul_(AROUND_ONE).add_(1.0)
    head = drawn["patch_embed.proj"].mul_(EDGE_NOISE / 3.0)
    head[:, 0, 1, 1] += a
    a2 = drawn.pop("a2")
    a2 -= a * (a2.dot(a) / a.dot(a))
    head[:, 1, 1, 1] += SIGMA_GAIN * a2
    b = a / a.dot(a)
    smooth = torch.tensor(SMOOTH, device=device)
    step = smooth / smooth.sum()
    step[1, 1] -= 1.0                      # smoothing less the identity
    tail = drawn["output"].mul_(EDGE_NOISE / 3.0 * b.norm() / d ** 0.5)
    tail[0, d:2 * d] += b[:, None, None] * step
    sd["patch_embed.proj.weight"], sd["output.weight"] = head, tail
    return sd


def system(cfg, sd, device):
    """The port's Restormer on ``sd`` (``restormer_arch.py``'s layout),
    frozen."""
    from dt4image_restoration_tpu_torch.models.restormer import \
        RestormerDenoiser
    from dt4image_restoration_tpu_torch.utils.convert import (
        load_strict, restormer_from_reference)
    if cfg["in_channels"] != 2 or cfg["out_channels"] != 1:
        raise ValueError("the port's Restormer prior has 2 in / 1 out")
    if cfg["LayerNorm_type"] != "BiasFree" or cfg["bias"]:
        raise ValueError("the port's Restormer has BiasFree LayerNorms and "
                         "no biases")
    with torch.device(device):
        den = RestormerDenoiser(
            dim=cfg["dim"], num_blocks=cfg["num_blocks"],
            num_refinement_blocks=cfg["num_refinement_blocks"],
            heads=cfg["heads"],
            ffn_expansion_factor=cfg["ffn_expansion_factor"],
            dtype=cfg["dtype"])
    load_strict(den, restormer_from_reference(sd), "Restormer weights")
    return den.eval().requires_grad_(False)


def reference(sd, img, sigma, precision):
    """(B, 1, H, W) images and (B,) strengths -> the clamped Restormer
    output (``Restormer.forward`` on the image and its noise map, plus the
    image)."""
    b, _, h, w = img.shape

    def stream(t):
        return round_operand(t, precision) if precision == "bfloat16" else t

    def layer_norm(name, t):
        t3 = t.permute(0, 2, 3, 1)
        var = t3.var(-1, keepdim=True, unbiased=False)
        return (t3 / torch.sqrt(var + LN_EPS) * sd[name + ".body.weight"]) \
            .permute(0, 3, 1, 2)

    def attention(p, t):
        bb, c, hh, ww = t.shape
        tau = sd[p + "temperature"]
        heads = tau.shape[0]
        qkv = stream(conv2d(conv2d(t, sd, p + "qkv", precision), sd,
                            p + "qkv_dwconv", precision, padding=1,
                            groups=3 * c))
        q, k, v = (u.reshape(bb, heads, c // heads, hh * ww)
                   for u in qkv.chunk(3, dim=1))
        q = F.normalize(round_operand(q, precision), dim=-1)
        k = F.normalize(round_operand(k, precision), dim=-1)
        attn = ((q @ k.transpose(-2, -1)) * tau).softmax(dim=-1)
        out = (round_operand(attn, precision) @ round_operand(v, precision))
        return conv2d(out.reshape(bb, c, hh, ww), sd, p + "project_out",
                      precision)

    def feed_forward(p, t):
        groups = sd[p + "dwconv.weight"].shape[0]
        t = conv2d(conv2d(t, sd, p + "project_in", precision), sd,
                   p + "dwconv", precision, padding=1, groups=groups)
        x1, x2 = t.chunk(2, dim=1)
        return conv2d(F.gelu(x1) * x2, sd, p + "project_out", precision)

    def level(name, t):
        n = len({k.split(".")[1] for k in sd if k.startswith(name + ".")})
        for i in range(n):
            p = f"{name}.{i}."
            t = stream(t + attention(p + "attn.",
                                     layer_norm(p + "norm1", t)))
            t = stream(t + feed_forward(p + "ffn.",
                                        layer_norm(p + "norm2", t)))
        return t

    def down(name, t):
        return stream(F.pixel_unshuffle(conv2d(t, sd, name + ".body.0",
                                               precision, padding=1), 2))

    def up(name, t):
        return stream(F.pixel_shuffle(conv2d(t, sd, name + ".body.0",
                                             precision, padding=1), 2))

    x0 = torch.cat([img, sigma.reshape(b, 1, 1, 1).expand(b, 1, h, w)], 1)
    enc1 = level("encoder_level1", stream(conv2d(
        x0, sd, "patch_embed.proj", precision, padding=1)))
    enc2 = level("encoder_level2", down("down1_2", enc1))
    enc3 = level("encoder_level3", down("down2_3", enc2))
    latent = level("latent", down("down3_4", enc3))
    y = torch.cat([up("up4_3", latent), enc3], 1)
    y = level("decoder_level3", stream(conv2d(y, sd, "reduce_chan_level3",
                                              precision)))
    y = torch.cat([up("up3_2", y), enc2], 1)
    y = level("decoder_level2", stream(conv2d(y, sd, "reduce_chan_level2",
                                              precision)))
    y = torch.cat([up("up2_1", y), enc1], 1)
    y = level("refinement", level("decoder_level1", y))
    out = stream(conv2d(y, sd, "output", precision, padding=1))
    return torch.clamp(out + img, 0, 1)


def _conv_macs(shape, side):
    """Multiply-adds of one stride-1 conv (a depthwise one: one input
    channel an output) at ``side`` x ``side``."""
    return side * side * shape[0] * shape[1] * shape[2] * shape[3]


def attention_flops(cfg):
    """FLOPs of the attention's two products of one call on one slice: the
    Gram q k^T and A v, each c x c x P a head."""
    return sum(2 * 2.0 * n * side * side * w * (w // hd)
               for _, w, hd, n, side in _levels(cfg))


def flops(cfg):
    """FLOPs of one call on one slice: every conv and both attention
    products, from the shapes (77.4 GFLOP at 128^2 and the published
    widths)."""
    return sum(2.0 * _conv_macs(shape, side)
               for _, shape, side, _ in _convs(cfg)) + attention_flops(cfg)


def bytes(cfg, batch):  # noqa: A001 - the name the harness calls
    """Bytes one call at ``batch`` must move, in the compute dtype unless
    said: each conv's input read once and its output written once, the
    GDFN's depthwise output counted at its gated width H (the gate fused
    into it), the LayerNorms in neither (fused into the next 1x1 conv);
    the attention's q, k and v read once and its output written once; one
    more read of the stream for each residual sum; the float32 input
    (image and noise map) and output; the weights once."""
    width = DTYPE_BYTES[cfg["dtype"]]
    acts = 0
    for name, shape, side, in_side in _convs(cfg):
        c_in = shape[0] if shape[1] == 1 else shape[1]
        c_out = shape[0] // 2 if name.endswith("ffn.dwconv") else shape[0]
        if name.startswith(("down", "up")):
            c_out = shape[0]      # the shuffles move no data a conv would
        acts += in_side * in_side * c_in + side * side * c_out
    for _, w, _, n, side in _levels(cfg):
        acts += n * side * side * (3 * w + w)      # attention: q, k, v; out
        acts += n * side * side * 2 * w            # two residual sums
    s = cfg["image_size"]
    io = s * s * (cfg["in_channels"] + cfg["out_channels"]) * 4
    weights = sum(torch.Size(shape).numel() for _, shape, _, _ in _convs(cfg))
    return batch * (width * acts + io) + weights * width


def gram_bound_s(cfg, batch):
    """K7's least time in one call at ``batch``: the Gram's FLOPs over the
    peak, or q and k read once and the float32 attention maps written
    once over the bandwidth, the larger."""
    width = DTYPE_BYTES[cfg["dtype"]]
    ops = nbytes = 0.0
    for _, w, hd, n, side in _levels(cfg):
        ops += n * 2.0 * side * side * w * (w // hd)
        nbytes += n * (side * side * 2 * w * width + hd * (w // hd) ** 2 * 4)
    return max(batch * ops / PEAK_FLOPS[cfg["dtype"]],
               batch * nbytes / PEAK_BYTES_PER_S)
