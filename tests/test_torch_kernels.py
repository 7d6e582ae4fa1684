"""The port's kernels (K1 conv_block, K2 kspace, K3 dt_decode, K4 attention,
K5 layernorm, K6 upsample_concat).

On the CPU each wrapper runs its plain PyTorch version, which is held here
against the JAX package's Pallas kernel run in interpret mode on the same
numpy inputs, at the tolerances of tests/test_pallas.py (K6, which has no
Pallas counterpart, against the JAX U-Net decoder's upsampling, pad and
concat). The CUDA kernels
themselves are held against their plain versions on the card by
tests/test_torch_cuda.py.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dt4image_restoration_tpu.config import ModelConfig as JModelConfig
from dt4image_restoration_tpu.models.unet import (
    _pad_to_match as j_pad_to_match)
from dt4image_restoration_tpu.models.decision_transformer import (
    init_dt_params as j_init_dt_params)
from dt4image_restoration_tpu.ops.pallas import (
    fused_causal_attention as j_fused_causal_attention,
    fused_conv_block as j_fused_conv_block,
    kspace_consistency_pallas, layernorm_pallas)
from dt4image_restoration_tpu.ops.image import (
    bilinear_upsample_2x as j_bilinear_upsample_2x)
from dt4image_restoration_tpu.ops.pallas.transformer import (
    fused_dt_decode as j_fused_dt_decode, pack_dt_weights as j_pack)
from dt4image_restoration_tpu_torch.config import ModelConfig
from dt4image_restoration_tpu_torch.ops import kernels
from dt4image_restoration_tpu_torch.ops.kernels import attention as k4
from dt4image_restoration_tpu_torch.ops.kernels import conv_block as k1
from dt4image_restoration_tpu_torch.ops.kernels import conv_block_bf16 as kb
from dt4image_restoration_tpu_torch.ops.kernels import layernorm as k5
from dt4image_restoration_tpu_torch.ops.kernels import kspace as k2
from dt4image_restoration_tpu_torch.ops.kernels import transformer as k3
from dt4image_restoration_tpu_torch.ops.kernels import upsample_concat as k6
from dt4image_restoration_tpu_torch.ops.kernels import mdta_gram as k7
from dt4image_restoration_tpu_torch.models import (DecisionTransformer,
                                                   UNetDenoiser,
                                                   init_dt_params,
                                                   random_unet_state_dict)
from dt4image_restoration_tpu_torch.utils.convert import dt_from_jax
from torch_port_common import one_torch_thread  # noqa: F401


def _block_params(rng, cin, feats, layers):
    ws, bs = [], []
    for _ in range(layers):
        ws.append((rng.standard_normal((3, 3, cin, feats)) * 0.1)
                  .astype(np.float32))
        bs.append((rng.standard_normal((feats,)) * 0.1).astype(np.float32))
        cin = feats
    return ws, bs


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


# --- K1 -----------------------------------------------------------------

@pytest.mark.parametrize("shape,feats,layers,row_tile", [
    ((2, 16, 12, 2), 8, 3, None),     # inc-shaped
    ((1, 8, 8, 4), 16, 1, None),      # single layer
    ((3, 10, 24, 16), 8, 2, None),
    ((1, 16, 8, 64), 8, 3, 2),        # JAX row tiles: every seam
    ((1, 34, 20, 3), 8, 3, None),     # beyond one 16x16 CUDA tile
])
def test_conv_block_plain_matches_pallas(rng, shape, feats, layers,
                                         row_tile):
    x = rng.standard_normal(shape).astype(np.float32)
    ws, bs = _block_params(rng, shape[-1], feats, layers)
    ref = j_fused_conv_block(jnp.asarray(x), [jnp.asarray(w) for w in ws],
                             [jnp.asarray(b) for b in bs],
                             row_tile=row_tile, interpret=True)
    got = k1.fused_conv_block(torch.from_numpy(x), _t(ws), _t(bs))
    assert got.shape == shape[:3] + (feats,)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)


def test_pack_conv_block_layouts_agree(rng):
    ws, bs = _block_params(rng, 5, 8, 3)
    hwio = k1.pack_conv_block(_t(ws), _t(bs), layout="hwio")
    oihw = k1.pack_conv_block(
        [torch.from_numpy(w.transpose(3, 2, 0, 1)) for w in ws], _t(bs))
    assert (hwio.cin, hwio.features, hwio.layers) == (5, 8, 3)
    torch.testing.assert_close(hwio.weights, oihw.weights, rtol=0, atol=0)
    torch.testing.assert_close(hwio.tc_weights, oihw.tc_weights, rtol=0,
                               atol=0)
    torch.testing.assert_close(hwio.layer_weight(1),
                               torch.from_numpy(ws[1]).permute(2, 0, 1, 3))
    with pytest.raises(ValueError, match="layer 1"):
        k1.pack_conv_block(_t([ws[0], ws[0]]), _t(bs[:2]), layout="hwio")


def _unswizzle(frags):
    """(G, 9, NT, 8, 4, 2) fragment halves -> (8G, 3, 3, 8NT) weights: the
    inverse of the kernel's [group][tap][n-tile][g][t][half] order."""
    groups, _, nt = frags.shape[:3]
    return frags.permute(0, 5, 4, 1, 2, 3).reshape(groups * 8, 3, 3, nt * 8)


_TC_SHAPES = [(2, 32, 3), (96, 32, 3), (5, 12, 2)]   # inc, up4, ragged


@pytest.mark.parametrize("cin,feats,layers", _TC_SHAPES)
def test_conv_block_tc_pack_round_trips(rng, cin, feats, layers):
    """hi + lo gives back the float32 weights to 2^-22 relative, and hi is
    TF32: its low 13 mantissa bits are zero."""
    ws, bs = _block_params(rng, cin, feats, layers)
    packed = k1.pack_conv_block(_t(ws), _t(bs), layout="hwio")
    frags = packed.tc_weights.view(-1, 4)
    hi, lo = frags[:, :2], frags[:, 2:]
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert not (lo.view(torch.int32) & 0x1FFF).any()
    total = sum(packed.layer_fragments(i).numel() for i in range(layers))
    assert total == packed.tc_weights.numel()
    for i in range(layers):
        frag = packed.layer_fragments(i)
        w = packed.layer_weight(i)
        ci = w.shape[0]
        both = (_unswizzle(frag[..., :2]) + _unswizzle(frag[..., 2:]))
        rel = ((both[:ci, :, :, :feats] - w).abs() / w.abs()).max()
        assert float(rel) <= 2.0 ** -22


@pytest.mark.parametrize("cin,feats,layers", _TC_SHAPES)
def test_conv_block_fragments_unswizzle_to_layer_weight(rng, cin, feats,
                                                        layers):
    """Undoing the fragment order gives back layer_weight(l): hi exactly as
    its TF32 rounding, lo as the TF32 rounding of the rest, and zeros in the
    channels padded to multiples of 8."""
    ws, bs = _block_params(rng, cin, feats, layers)
    packed = k1.pack_conv_block(_t(ws), _t(bs), layout="hwio")
    for i in range(layers):
        frag = packed.layer_fragments(i)
        w = packed.layer_weight(i)
        ci = w.shape[0]
        hi, lo = _unswizzle(frag[..., :2]), _unswizzle(frag[..., 2:])
        assert torch.equal(hi[:ci, :, :, :feats], k1.tf32_round(w))
        assert torch.equal(lo[:ci, :, :, :feats],
                           k1.tf32_round(w - k1.tf32_round(w)))
        assert not hi[ci:].any() and not hi[..., feats:].any()
        assert not lo[ci:].any() and not lo[..., feats:].any()


def _tf32_block(x, packed, products):
    """The block with every conv taken as TF32 products summed in float32,
    as the kernel has the tensor cores do it: 1 product (hi hi) or 3 (lo hi
    + hi lo + hi hi). Weights split as packed, hi = tf32(w) and
    lo = tf32(w - hi); activations hi = tf32(x) and lo = x - hi truncated
    to TF32, as the tensor core reads it."""
    r = k1.tf32_round
    for layer in range(packed.layers):
        w = packed.layer_weight(layer).permute(3, 0, 1, 2).contiguous()
        xh, wh = r(x), r(w)
        y = F.conv2d(xh, wh, padding=1)
        if products == 3:
            xl = ((x - xh).view(torch.int32) & -0x2000).view(torch.float32)
            y = (F.conv2d(xl, wh, padding=1)
                 + F.conv2d(xh, r(w - wh), padding=1) + y)
        x = F.leaky_relu(y + packed.biases[layer].view(1, -1, 1, 1), 0.2)
    return x


def test_three_tf32_products_are_float32_accurate():
    """Why K1 takes three products: on an up4 block (96 -> 32, 864 terms
    per output) 3xTF32 stays within 1e-5 of the float32 plain version,
    while one TF32 product misses the kernel's 1e-4 tolerance."""
    unet = UNetDenoiser()
    unet.load_state_dict(random_unet_state_dict(0))
    packed = unet.net.up4.packed_weights()
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 1, (1, 96, 24, 24)).astype(np.float32))
    ref = k1.conv_block_plain(x, packed)
    err3 = float((_tf32_block(x, packed, 3) - ref).abs().max())
    err1 = float((_tf32_block(x, packed, 1) - ref).abs().max())
    assert err3 <= 1e-5
    assert err1 > 1e-4


# --- K1 in bfloat16 ------------------------------------------------------

@pytest.mark.parametrize("shape,feats,layers,row_tile", [
    ((2, 16, 16, 2), 8, 3, None),     # inc-shaped (Cin 2), one 16x16 tile
    ((1, 12, 16, 64), 8, 3, 2),       # Cin 64, 3 JAX row tiles
    ((1, 16, 48, 2), 32, 3, None),    # inc width, 3 CUDA tiles
    ((2, 16, 16, 64), 16, 2, None),
])
def test_conv_block_bf16_plain_matches_pallas(rng, shape, feats, layers,
                                              row_tile):
    """The plain bfloat16 K1 against the Pallas kernel on bfloat16
    operands (interpret mode): both sum the products of the bfloat16
    values in float32 and round every layer to bfloat16, so they agree to
    bfloat16 rounding."""
    x = rng.standard_normal(shape).astype(np.float32)
    ws, bs = _block_params(rng, shape[-1], feats, layers)
    bf = jnp.bfloat16
    ref = j_fused_conv_block(jnp.asarray(x, bf),
                             [jnp.asarray(w, bf) for w in ws],
                             [jnp.asarray(b, bf) for b in bs],
                             row_tile=row_tile, interpret=True)
    got = k1.fused_conv_block(torch.from_numpy(x).to(torch.bfloat16),
                              _t(ws), _t(bs))
    assert got.dtype == torch.bfloat16
    assert got.shape == shape[:3] + (feats,)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), rtol=1e-2,
                               atol=1e-2)


def _wgmma_b(tc, start, feats):
    """The (16, F) k16-step operand at byte ``start`` of a bfloat16 pack,
    read as the kernel's wgmma descriptor addresses it: K-major without
    swizzle, 8 x 8 core matrices of 128 contiguous bytes (8 outputs x 16
    bytes), SBO bytes between 8-output groups and LBO = 16 F bytes
    between the step's two 8-channel halves."""
    k, n = torch.meshgrid(torch.arange(16), torch.arange(feats),
                          indexing="ij")
    addr = start + (n // 8) * kb.SBO + (n % 8) * 16 + (k // 8) * 16 * feats \
        + (k % 8) * 2
    return tc[addr // 2].float()


@pytest.mark.parametrize("cin,feats,layers", [(2, 32, 3), (96, 32, 3),
                                              (5, 24, 2), (24, 8, 3)])
def test_conv_block_bf16_weights_are_the_wgmma_b_operand(rng, cin, feats,
                                                         layers):
    """The bfloat16 pack holds the weights rounded to bfloat16, and every
    k16 step of it (per layer: 16-channel group, then tap), read as the
    kernel's descriptor addresses it, gives back ``packed.layer_weight``:
    channel 16 group + k to output n at the tap, zero in the channels
    padded to a multiple of 16."""
    ws, bs = _block_params(rng, cin, feats, layers)
    packed = k1.pack_conv_block(_t(ws), _t(bs), layout="hwio",
                                dtype=torch.bfloat16)
    assert packed.dtype == packed.tc_weights.dtype == torch.bfloat16
    assert torch.equal(packed.biases.float(), torch.from_numpy(
        np.stack(bs)).to(torch.bfloat16).float())
    step, off = 32 * feats, 0
    for i in range(layers):
        w = packed.layer_weight(i)
        assert torch.equal(w, torch.from_numpy(ws[i]).permute(2, 0, 1, 3)
                           .to(torch.bfloat16))
        ci = w.shape[0]
        groups = -(-ci // 16)
        wp = F.pad(w.float(), (0, 0, 0, 0, 0, 0, 0, groups * 16 - ci))
        for grp in range(groups):
            for tap in range(9):
                got = _wgmma_b(packed.tc_weights, off, feats)
                assert torch.equal(got, wp[16 * grp:16 * grp + 16,
                                           tap // 3, tap % 3])
                off += step
    assert off == 2 * packed.tc_weights.numel()


@pytest.mark.parametrize("cin,feats,layers", [(2, 32, 3), (20, 8, 2),
                                              (5, 24, 4), (3, 16, 1)])
def test_conv_block_bf16_row_stride_gemm_is_the_conv(rng, cin, feats,
                                                     layers):
    """The kernel's implicit GEMM, emulated on one tile: each layer's input
    region as K-major pixel rows (one 8-channel plane per LBO, garbage past
    the region), output pixel (oy, ox) as row oy si + ox of the plan's m64
    tiles, tap (ky, kx) as the A rows shifted by ky si + kx, B read by
    descriptor from the pack in (group, tap) order, garbage rows dropped,
    and the next layer's rows written densely at stride so. It equals the
    block's valid convolutions on the window, layer by layer."""
    ws, bs = _block_params(rng, cin, feats, layers)
    packed = k1.pack_conv_block(_t(ws), _t(bs), layout="hwio",
                                dtype=torch.bfloat16)
    si0 = kb.geometry(layers, 0)[0]
    window = torch.from_numpy(rng.standard_normal(
        (cin, si0, si0)).astype(np.float32)).to(torch.bfloat16).float()
    ref, a_in, off = window, window, 0
    for i in range(layers):
        si, so, rows, tiles = kb.geometry(layers, i)
        ci = a_in.shape[0]
        groups = -(-ci // 16)
        nrows = kb.input_rows(layers, i)
        assert si * si <= nrows
        a = torch.from_numpy(rng.standard_normal(
            (groups * 16, nrows)).astype(np.float32))    # garbage rows
        a[:, :si * si] = 0.0
        a[:ci, :si * si] = a_in.reshape(ci, -1)
        acc = torch.zeros(64 * tiles, feats)
        m = torch.arange(64 * tiles)
        for grp in range(groups):
            for tap in range(9):
                shift = (tap // 3) * si + tap % 3
                b = _wgmma_b(packed.tc_weights, off, feats)
                acc += a[16 * grp:16 * grp + 16, m + shift].T @ b
                off += 32 * feats
        oy, ox = m // si, m % si
        keep = (m < rows) & (ox < so)
        assert int(keep.sum()) == so * so
        out = acc[keep].T.reshape(feats, so, so)
        w = packed.layer_weight(i).float().permute(3, 0, 1, 2)
        ref = F.conv2d(ref[None], w)[0]
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-4)
        a_in = ref
    assert off == 2 * packed.tc_weights.numel()


@pytest.mark.parametrize("sms", [8, 132])
@pytest.mark.parametrize("h,w", [(128, 128), (40, 36), (37, 50), (7, 9)])
@pytest.mark.parametrize("batch", [1, 16, 63, 96])
def test_conv_block_bf16_plan_covers_every_tile_once(batch, h, w, sms):
    """The persistent grid's work items (item = block + k x grid) cover
    every (image, tile) exactly once, balanced within one item, with a
    grid of min(items, SMs) blocks: smaller than the SM count where there
    are fewer items."""
    p = kb.plan(batch, 96, h, w, 32, 3, sms)
    tiles_y, tiles_x = -(-h // kb.TILE), -(-w // kb.TILE)
    assert p.items == batch * tiles_y * tiles_x
    assert p.grid == min(sms, p.items)
    blocks = kb.work_items(p)
    seen = [item for block in blocks for item in block]
    assert sorted(seen) == [(b, ty, tx) for b in range(batch)
                            for ty in range(tiles_y)
                            for tx in range(tiles_x)]
    sizes = [len(block) for block in blocks]
    assert max(sizes) - min(sizes) <= 1 and min(sizes) >= 1


@pytest.mark.parametrize("cin,feats,layers,resident", [
    (2, 32, 3, True), (96, 32, 3, True), (160, 32, 3, True),
    (176, 32, 3, False), (512, 32, 3, False), (2, 32, 4, True),
    (96, 32, 4, True), (24, 8, 3, True), (5, 24, 2, True),
    (3, 16, 1, True), (1, 8, 1, True), (1024, 32, 4, False)])
def test_conv_block_bf16_plan_fits_shared_memory(cin, feats, layers,
                                                 resident):
    """The shared-memory map of a launch: 128-byte aligned, disjoint
    regions within the H100's 227 KB; descriptor fields in range; at least
    two ring stages; layer 0's weights resident where they fit (up to
    Cin 160 at F 32, L 3) and carried by each stage beyond; every buffer
    as long as the rows its layer's descriptors reach; and no consumer
    warpgroup holding more than MAX_TILES m64 tiles."""
    p = kb.plan(63, cin, 128, 128, feats, layers, 132)
    assert bool(p.resident) == resident and 2 <= p.stages <= kb.MAX_STAGES
    regions = sorted(p.regions(feats), key=lambda r: r[1])
    end = 0
    for name, offset, size in regions:
        assert offset % 128 == 0 and offset >= end, (name, offset, end)
        end = offset + size
    assert end <= p.smem <= kb.MAX_SMEM and p.smem < 2 ** 18
    fk, step = -(-feats // 16) * 16, 32 * feats
    chunks = -(-cin // kb.CHUNK)
    assert p.chunks == chunks and p.w0_bytes == chunks * 9 * step
    later = (layers - 1) * fk // 16 * 9 * step
    assert p.w_bytes == (p.w0_bytes if resident else 0) + later
    assert p.stage_bytes >= 2 * p.stage_plane + (0 if resident else 9 * step)
    assert p.stage_plane == 16 * kb.input_rows(layers, 0)
    for i in range(1, layers):
        plane = p.mid_plane0 if i % 2 == 1 else p.mid_plane1
        assert plane >= 16 * kb.input_rows(layers, i)
        # layer i - 1 writes its so x so outputs densely at stride so
        assert kb.geometry(layers, i - 1)[1] == kb.geometry(layers, i)[0]
    for plane in (p.stage_plane, p.mid_plane0, p.mid_plane1, 16 * feats):
        assert plane % 16 == 0 and plane >> 4 < 2 ** 14    # LBO field
    for i in range(layers):
        assert -(-kb.geometry(layers, i)[3] // 2) <= kb.MAX_TILES


def test_conv_block_bf16_plan_needs_two_stages(monkeypatch):
    """A consumer releases a ring stage only once the next chunk's products
    are issued, so one stage would deadlock. Where two stages do not fit
    beside the resident weights, layer 0's weights move into the stages;
    where two do not fit even so, the plan refuses the launch."""
    def smem_of_two(p):
        return p.smem - (p.stages - 2) * p.stage_bytes

    args = (1, 96, 128, 128, 32, 3, 132)
    full = kb.plan(*args)
    assert full.resident and full.stages > 2
    monkeypatch.setattr(kb, "MAX_SMEM", smem_of_two(full))
    assert (kb.plan(*args).resident, kb.plan(*args).stages) == (1, 2)
    monkeypatch.setattr(kb, "MAX_SMEM", smem_of_two(full) - 1)
    carried = kb.plan(*args)
    assert not carried.resident and carried.stages >= 2
    monkeypatch.setattr(kb, "MAX_SMEM", smem_of_two(carried))
    assert (kb.plan(*args).resident, kb.plan(*args).stages) == (0, 2)
    monkeypatch.setattr(kb, "MAX_SMEM", smem_of_two(carried) - 1)
    with pytest.raises(ValueError, match="two ring stages"):
        kb.plan(*args)


def test_conv_block_bf16_vector_path():
    """16-byte loads and stores where W % 8 == 0 and the input is 16-byte
    aligned; element by element otherwise."""
    x = torch.zeros((2, 96, 128, 128), dtype=torch.bfloat16)
    assert kb.vector_path(x)
    assert not kb.vector_path(torch.zeros((1, 2, 40, 36),
                                          dtype=torch.bfloat16))
    shifted = torch.zeros(2 * 96 * 128 * 128 + 1,
                          dtype=torch.bfloat16)[1:].view(x.shape)
    assert shifted.is_contiguous() and not kb.vector_path(shifted)


def test_conv_block_bf16_plain_rounds_each_layer():
    """The plain bfloat16 K1 is the float32 block on the bfloat16 values
    with every layer's output rounded to bfloat16."""
    rng = np.random.default_rng(3)
    ws, bs = _block_params(rng, 4, 8, 2)
    x = torch.from_numpy(rng.standard_normal((1, 4, 10, 12)).astype(
        np.float32)).to(torch.bfloat16)
    packed = k1.pack_conv_block(_t(ws), _t(bs), layout="hwio",
                                dtype=torch.bfloat16)
    y = x.float()
    for i in range(2):
        w = packed.layer_weight(i).float().permute(3, 0, 1, 2)
        y = F.leaky_relu(F.conv2d(y, w, packed.biases[i].float(),
                                  padding=1), 0.2)
        y = y.to(torch.bfloat16).float()
    got = k1.conv_block_plain(x, packed)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), y, rtol=2 ** -7, atol=1e-6)


# --- K2 -----------------------------------------------------------------

@pytest.mark.parametrize("b,h,w", [(3, 16, 16), (1, 128, 128)])
def test_kspace_plain_matches_pallas(rng, b, h, w):
    z = rng.standard_normal((b, 1, h, w, 2)).astype(np.float32)
    y0 = rng.standard_normal((b, 1, h, w, 2)).astype(np.float32)
    mask = rng.uniform(size=(b, 1, h, w)) < 0.3
    mu = rng.uniform(0.1, 2.0, (b,)).astype(np.float32)
    ref = np.asarray(kspace_consistency_pallas(
        jnp.asarray(z), jnp.asarray(y0), jnp.asarray(mask), jnp.asarray(mu),
        interpret=True))
    got = k2.kspace_consistency_kernel(
        torch.view_as_complex(torch.from_numpy(z)),
        torch.view_as_complex(torch.from_numpy(y0)),
        torch.from_numpy(mask), torch.from_numpy(mu))
    assert got.dtype == torch.complex64
    np.testing.assert_allclose(torch.view_as_real(got).numpy(), ref,
                               rtol=1e-6, atol=1e-6)


def test_wrappers_refuse_other_devices():
    z = torch.zeros((1, 1, 4, 4), dtype=torch.complex64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        k2.kspace_consistency_kernel(
            z, z, torch.zeros(z.shape, dtype=torch.bool, device="meta"),
            torch.zeros(1, device="meta"))


# --- K3 -----------------------------------------------------------------

JCFG = JModelConfig(block_size=18, n_embeds=9, embed_dim=64, n_heads=4,
                    n_blocks=2, image_size=48)


@pytest.fixture(scope="module")
def dt_params():
    return jax.tree.map(np.asarray, j_init_dt_params(JCFG, seed=3))


@pytest.mark.parametrize("t", [12, 18])
def test_dt_decode_plain_matches_pallas(rng, dt_params, t):
    packed = {k: np.array(v) for k, v in j_pack(dt_params, 2).items()}
    tokens = rng.standard_normal((3, t, 64)).astype(np.float32)
    ref = np.asarray(j_fused_dt_decode(
        jnp.asarray(tokens), {k: jnp.asarray(v) for k, v in packed.items()},
        n_blocks=2, n_heads=4, interpret=True))
    got = k3.fused_dt_decode(torch.from_numpy(tokens),
                             {k: torch.from_numpy(v)
                              for k, v in packed.items()},
                             n_blocks=2, n_heads=4)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-5)


def test_pack_dt_weights_matches_jax(dt_params):
    cfg = ModelConfig(block_size=18, n_embeds=9, embed_dim=64, n_heads=4,
                      n_blocks=2, image_size=48)
    ours = k3.pack_dt_weights(dt_from_jax(dt_params, cfg), 2)
    theirs = j_pack(dt_params, 2)
    assert set(ours) == set(k3.PACK_KEYS) == set(theirs)
    for k in k3.PACK_KEYS:
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(theirs[k]))


def _dt_packed(e, n_blocks, seed=0):
    cfg = ModelConfig(embed_dim=e, n_heads=4, n_blocks=n_blocks)
    dt = DecisionTransformer(cfg)
    dt.load_state_dict(init_dt_params(cfg, seed))
    return dt.packed_weights()


def _a_unswizzle(frags, k, n):
    """(n_blocks, K N) A fragments -> (n_blocks, K, N) (in, out) weights:
    the inverse of the kernel's [k step][m tile][g][t][k half][m half]
    order."""
    x = frags.reshape(-1, k // 8, n // 16, 8, 4, 2, 2)
    return x.permute(0, 1, 5, 4, 2, 6, 3).reshape(-1, k, n)


@pytest.mark.parametrize("e", [64, 128])
def test_dt_fragments_unswizzle_to_pack_weights(e):
    """Block r's stream of the fragment pack gives back head r's q, k, v
    columns of qkv_w and the r-th quarter of o_w, fc_w and proj_w, exactly,
    in the kernel's product order; the four quarters tile each matrix."""
    nb = 2
    packed = _dt_packed(e, nb)
    tc = packed["tc_w"]
    assert tc.shape == (4, nb, 3 * e * e) and tc.is_contiguous()
    q = e // 4
    got = {"qkv_w": torch.empty_like(packed["qkv_w"]),
           "o_w": torch.empty_like(packed["o_w"]),
           "fc_w": torch.empty_like(packed["fc_w"]),
           "proj_w": torch.empty_like(packed["proj_w"])}
    for r in range(4):
        segs = tc[r].split([e * 3 * q, e * q, e * e, 4 * e * q], dim=1)
        qkv = _a_unswizzle(segs[0], e, 3 * q)
        for i in range(3):
            got["qkv_w"][:, :, i * e + r * q:i * e + (r + 1) * q] = \
                qkv[:, :, i * q:(i + 1) * q]
        got["o_w"][:, :, r * q:(r + 1) * q] = _a_unswizzle(segs[1], e, q)
        got["fc_w"][:, :, r * e:(r + 1) * e] = _a_unswizzle(segs[2], e, e)
        got["proj_w"][:, :, r * q:(r + 1) * q] = _a_unswizzle(segs[3], 4 * e,
                                                              q)
    for k, w in got.items():
        assert torch.equal(w, packed[k]), k
    assert set(k3.PACK_KEYS) < set(packed)


def _tf32_dt_decode(tokens, packed, n_blocks, n_heads, products):
    """fused_dt_decode_plain with every projection taken as TF32 products
    summed in float32, as the kernel has the tensor cores do it: 1 product
    (hi hi) or 3 (lo hi + hi lo + hi hi), both operands split as split()
    does: hi = tf32(v), lo = v - hi truncated to TF32."""
    r = k1.tf32_round

    def lo(v):
        return ((v - r(v)).view(torch.int32) & -0x2000).view(torch.float32)

    def matmul(x, w):
        y = r(x) @ r(w)
        if products == 3:
            y = lo(x) @ r(w) + r(x) @ lo(w) + y
        return y

    x = tokens
    b, t, e = x.shape
    d = e // n_heads
    causal = torch.ones(t, t, dtype=torch.bool).tril()
    for i in range(n_blocks):
        h = k5.layernorm_plain(x, packed["ln1_s"][i], packed["ln1_b"][i])
        qkv = matmul(h, packed["qkv_w"][i]) + packed["qkv_b"][i]
        q, k, v = (a.reshape(b, t, n_heads, d).transpose(1, 2)
                   for a in qkv.split(e, dim=-1))
        s = (q @ k.transpose(-1, -2)) * (1.0 / np.sqrt(d))
        p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
        att = (p @ v).transpose(1, 2).reshape(b, t, e)
        x = x + matmul(att, packed["o_w"][i]) + packed["o_b"][i]
        h = k5.layernorm_plain(x, packed["ln2_s"][i], packed["ln2_b"][i])
        h = F.gelu(matmul(h, packed["fc_w"][i]) + packed["fc_b"][i])
        x = matmul(h, packed["proj_w"][i]) + packed["proj_b"][i]
    return k5.layernorm_plain(x, packed["lnf_s"], packed["lnf_b"])


def test_three_tf32_products_keep_dt_decode_float32_accurate():
    """Why K3 takes three products: over the published stack (E 128, 5
    blocks) 3xTF32 stays within 1e-5 of the float32 plain version, while
    one TF32 product misses the kernel's 1e-4 tolerance."""
    cfg = ModelConfig()
    packed = _dt_packed(cfg.embed_dim, cfg.n_blocks)
    tokens = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, 18, cfg.embed_dim)).astype(np.float32))
    ref = k3.fused_dt_decode_plain(tokens, packed, cfg.n_blocks, cfg.n_heads)
    err3 = float((_tf32_dt_decode(tokens, packed, cfg.n_blocks, cfg.n_heads,
                                  3) - ref).abs().max())
    err1 = float((_tf32_dt_decode(tokens, packed, cfg.n_blocks, cfg.n_heads,
                                  1) - ref).abs().max())
    assert err3 <= 1e-5
    assert err1 > 1e-4


@pytest.mark.parametrize("b,t,clusters,s", [
    (1, 12, 30, 1), (63, 12, 30, 3), (63, 18, 30, 3), (63, 12, 32, 2),
    (64, 32, 30, 1), (200, 12, 30, 4), (2, 1, 30, 1), (1000, 7, 30, 8)])
def test_dt_decode_sequences_per_cluster(b, t, clusters, s):
    """S fits B sequences into one wave of the clusters that the card runs
    at once, where a cluster's 56 tokens allow."""
    assert k3.sequences_per_cluster(b, t, clusters) == s
    assert s * t <= k3.MAX_CLUSTER_TOKENS


# --- K4 -----------------------------------------------------------------

@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("shape", [(2, 4, 18, 32), (3, 4, 12, 32),
                                   (1, 2, 5, 16), (2, 4, 33, 32),
                                   (1, 4, 90, 32)])
def test_attention_plain_matches_pallas(rng, shape, strided):
    """Contiguous inputs, and (``strided``) the views the per-op forward
    cuts from one (B, T, 3E) projection: split, reshape, transpose."""
    b, h, t, d = shape
    if strided:
        qkv = torch.from_numpy(
            rng.standard_normal((b, t, 3 * h * d)).astype(np.float32))
        q, k, v = (a.reshape(b, t, h, d).transpose(1, 2)
                   for a in qkv.split(h * d, dim=-1))
        assert not q.is_contiguous() and q.stride()[-1] == 1
    else:
        q, k, v = (torch.from_numpy(rng.standard_normal(shape)
                                    .astype(np.float32)) for _ in range(3))
    ref = np.asarray(j_fused_causal_attention(
        *(jnp.asarray(a.numpy()) for a in (q, k, v)), interpret=True))
    got = k4.fused_causal_attention(q, k, v)
    assert got.shape == shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-5)


# --- K5 -----------------------------------------------------------------

@pytest.mark.parametrize("shape", [(18, 128), (126, 128), (300, 128),
                                   (4, 18, 128), (5, 68)])
def test_layernorm_plain_matches_pallas(rng, shape):
    e = shape[-1]
    # An offset mean, so a one-pass variance would show.
    x = (rng.standard_normal(shape) + 3.0).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(e)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(e)).astype(np.float32)
    ref = np.asarray(layernorm_pallas(jnp.asarray(x), jnp.asarray(scale),
                                      jnp.asarray(bias), interpret=True))
    got = k5.layernorm(torch.from_numpy(x), torch.from_numpy(scale),
                       torch.from_numpy(bias))
    assert got.shape == shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-5)


# --- K6 -----------------------------------------------------------------

# (a, skip) shapes: the decoder's four levels at 128x128, odd-sized levels
# (pad borders on the bottom and the right, and on all four sides) and a Ws
# that is not a multiple of 4.
K6_SHAPES = [((2, 512, 8, 8), (2, 256, 16, 16)),
             ((2, 256, 16, 16), (2, 128, 32, 32)),
             ((1, 128, 32, 32), (1, 64, 64, 64)),
             ((1, 64, 64, 64), (1, 32, 128, 128)),
             ((2, 6, 4, 5), (2, 3, 9, 11)),
             ((3, 4, 7, 3), (3, 5, 14, 6)),
             ((1, 2, 5, 6), (1, 3, 13, 15))]
# A skip smaller than the upsampled image: F.pad crops (the JAX pad
# refuses it).
K6_CROP = ((1, 2, 5, 6), (1, 3, 9, 10))


def _k6_inputs(rng, a_shape, skip_shape, dtype=torch.float32):
    a, skip = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(dtype) for s in (a_shape, skip_shape))
    return a, skip


@pytest.mark.parametrize("a_shape,skip_shape", K6_SHAPES)
def test_upsample_concat_plain_matches_jax_decoder(rng, a_shape,
                                                   skip_shape):
    """The plain K6 against the JAX U-Net decoder's upsampling (two
    interpolation matmuls), pad-to-match and ``[skip, up]`` concat, NHWC."""
    a, skip = _k6_inputs(rng, a_shape, skip_shape)
    got = k6.upsample_concat(a, skip)
    ja, jskip = (jnp.asarray(t.permute(0, 2, 3, 1).numpy())
                 for t in (a, skip))
    ref = np.asarray(jnp.concatenate(
        [jskip, j_pad_to_match(j_bilinear_upsample_2x(ja), jskip)], -1))
    assert got.shape == (skip_shape[0], skip_shape[1] + a_shape[1],
                         *skip_shape[2:])
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("a_shape,skip_shape", K6_SHAPES + [K6_CROP])
def test_upsample_concat_plain_equals_interpolate_pad_cat(
        rng, a_shape, skip_shape, dtype):
    """On the CPU the wrapper is the composition the U-Net ran before K6,
    bit for bit: ``F.interpolate`` (align_corners), ``F.pad`` by half the
    size difference on each side (floor first), ``torch.cat``."""
    a, skip = _k6_inputs(rng, a_shape, skip_shape, dtype)
    up = F.interpolate(a, scale_factor=2, mode="bilinear",
                       align_corners=True)
    dy, dx = (skip.shape[i] - up.shape[i] for i in (2, 3))
    up = F.pad(up, (dx // 2, dx - dx // 2, dy // 2, dy - dy // 2))
    ref = torch.cat([skip, up], dim=1)
    kernels.reset_launch_counts()
    got = k6.upsample_concat(a, skip)
    assert got.dtype == dtype
    assert torch.equal(got, ref)
    assert k6.launches == 0


def test_upsample_concat_refuses_unsupported_device():
    a = torch.empty((1, 2, 4, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        k6.upsample_concat(a, torch.empty((1, 2, 8, 8), device="meta"))


# --- launch counts --------------------------------------------------------

def test_plain_path_counts_no_launches(rng):
    kernels.reset_launch_counts()
    ws, bs = _block_params(rng, 2, 8, 3)
    k1.fused_conv_block(torch.zeros((1, 8, 8, 2)), _t(ws), _t(bs))
    x = torch.zeros((1, 4, 6, 8))
    k4.fused_causal_attention(x, x, x)
    k5.layernorm(x, torch.ones(8), torch.zeros(8))
    k1.fused_conv_block(torch.zeros((1, 8, 8, 2), dtype=torch.bfloat16),
                        _t(ws), _t(bs))
    k6.upsample_concat(torch.zeros((1, 4, 3, 4)), x)
    k7.mdta_gram(torch.zeros((1, 4, 4, 48)), torch.ones(1), 1)
    assert kernels.launch_counts() == {"conv_block": 0,
                                       "conv_block_bf16": 0, "kspace": 0,
                                       "dt_decode": 0, "attention": 0,
                                       "layernorm": 0, "upsample_concat": 0,
                                       "mdta_gram": 0}


def test_unet_forward_on_cpu_counts_no_launches():
    """A U-Net forward on the CPU runs K6's plain version in every mode."""
    x = torch.rand((1, 1, 16, 16))
    for mode in ("none", "pallas", "winograd"):
        model = UNetDenoiser(base_channels=4, packed=mode).eval()
        kernels.reset_launch_counts()
        with torch.no_grad():
            model(x, 0.1)
        assert not any(kernels.launch_counts().values()), mode


def test_a_tallied_capture_counts_its_launches_at_each_replay():
    """Inside ``tally_launches`` (a CUDA graph's capture, which launches
    nothing) a thread's wrapper calls go to its tally and not to the
    counters, while another thread's still count; ``add_launches`` counts
    the tally once more at each replay."""
    from dt4image_restoration_tpu_torch.ops.kernels import _build
    kernels.reset_launch_counts()
    with kernels.tally_launches() as tally:
        _build.count_launch(k3.__name__)
        _build.count_launch(k3.__name__)
        other = threading.Thread(target=_build.count_launch,
                                 args=(k1.__name__,))
        other.start()
        other.join()
    assert tally == {k3.__name__: 2}
    assert kernels.launch_counts()["dt_decode"] == 0
    assert kernels.launch_counts()["conv_block"] == 1
    _build.count_launch(k3.__name__)   # counted again once out of it
    for _ in range(3):                 # three replays
        kernels.add_launches(tally)
    assert kernels.launch_counts()["dt_decode"] == 7
    kernels.reset_launch_counts()
