"""K1 in bfloat16: a whole U-Net ConvBlock in one kernel
(``csrc/conv_block_bf16.cu``).

Replaces the TPU kernel ``fused_conv_block``
(``dt4image_restoration_tpu/ops/pallas/conv_block.py``) called with
bfloat16 operands, as the U-Net's ``pallas`` mode does under
``--dtype bfloat16``: L chained [3x3 SAME conv + bias + LeakyReLU] layers
on bfloat16 input, weights and biases, every product summed in float32,
bias and LeakyReLU in float32, and each layer's result rounded to
nearest-even bfloat16. On the H100 the block is bound by tensor-core
operations at the dense bfloat16 rate. The kernel runs persistent blocks,
one an SM, over (image, 16 x 16 tile) work items: two producer
warpgroups stream each item's input window into a ring of shared-memory
stages while two consumer warpgroups run each layer as an implicit GEMM of
``wgmma`` m64nFk16 products on operands read by descriptor, the block's
weights resident in shared memory. See the source for the layouts.

:func:`wgmma_weights` packs the weights once, as the products read them;
:func:`plan` computes a launch's grid, ring depth and shared-memory map.
The weights are packed by ``conv_block.pack_conv_block(...,
dtype=torch.bfloat16)``; ``conv_block.conv_block`` calls
:func:`conv_block_bf16` for such a block. It has its own launch count.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["Plan", "conv_block_bf16", "conv_block_bf16_plain", "plan",
           "vector_path", "wgmma_weights", "work_items"]

launches = 0  # kernel launches since the last reset

MAX_FEATURES = 32
MAX_LAYERS = 4
TILE = 16             # output tile side of a work item
CHUNK = 16            # layer-0 input channels of a ring stage: one k16 step
MAX_STAGES = 8
MAX_TILES = 5         # m64 tiles of a layer a consumer warpgroup holds
MAX_SMEM = 232448     # dynamic shared memory a block may use on the H100
OUT_STRIDE = TILE * TILE + 8      # bf16 of one channel of the output tile
# The mbarriers (full and empty a stage, one for the weights), then the
# biases as float32 from byte 256.
BARRIER_BYTES = 256 + 4 * MAX_LAYERS * MAX_FEATURES
# wgmma descriptors of the K-major operands: 8-row core matrices of 128
# contiguous bytes, the next 8 rows (M or N) SBO bytes on, the second 8 of
# a k16 step's 16 channels LBO bytes on (one 8-channel plane of the
# activations; F x 16 bytes in the weights).
SBO = 128


def wgmma_weights(w: torch.Tensor) -> torch.Tensor:
    """One layer's (Ci, 3, 3, F) weights as the kernel's ``wgmma`` B
    operands, bfloat16.

    Ci is zero-padded to a multiple of 16 and F to a multiple of 8. For each
    group of 16 input channels and each tap (in that order: one k16 step
    each) the step's F x 16 operand is K-major in 8 x 8 core matrices:
    [k half][8-output group][output][8 channels], so channel 8 h + k to
    output 8 n + r sits at byte 2 k + 16 r + 128 n + 16 F h of the step.
    Shape (Ci/16, 9, 2, F/8, 8, 8), flattened.
    """
    ci, _, _, f = w.shape
    cp, fp = -(-ci // 16) * 16, -(-f // 8) * 8
    w = F.pad(w.detach().to(torch.bfloat16),
              (0, fp - f, 0, 0, 0, 0, 0, cp - ci))
    # channel = 16 group + 8 half + k, output = 8 n + r
    w = w.reshape(cp // 16, 2, 8, 9, fp // 8, 8).permute(0, 3, 1, 4, 5, 2)
    return w.contiguous().reshape(-1)


def geometry(layers: int, layer: int):
    """Layer ``layer``'s input region side si, output side so, output rows
    numbered at row stride si ((so - 1) si + so) and m64 tiles."""
    so = TILE + 2 * (layers - 1 - layer)
    si = so + 2
    rows = (so - 1) * si + so
    return si, so, rows, -(-rows // 64)


def input_rows(layers: int, layer: int) -> int:
    """Pixel rows of a layer's input that its products' descriptors reach:
    the last m64 tile shifted by the last tap."""
    si, _, _, tiles = geometry(layers, layer)
    return 64 * tiles + 2 * si + 2


def _align(n: int, a: int = 128) -> int:
    return -(-n // a) * a


@dataclasses.dataclass(frozen=True)
class Plan:
    """A launch: its grid, then the fields of the kernel's Plan struct in
    its order (``PLAN_FIELDS``; byte offsets into dynamic shared
    memory)."""
    grid: int
    batch: int
    cin: int
    h: int
    w: int
    layers: int
    tiles_x: int
    tiles: int
    items: int
    chunks: int
    stages: int
    resident: int
    vec: int
    w_bytes: int
    w0_bytes: int
    stage_plane: int
    stage_bytes: int
    mid_plane0: int
    mid_plane1: int
    off_w: int
    off_ring: int
    off_mid0: int
    off_mid1: int
    off_out: int
    off_bar: int
    smem: int

    def regions(self, features: int):
        """(name, offset, bytes) of each shared-memory region."""
        fk = -(-features // 16) * 16
        return (("weights", self.off_w, self.w_bytes),
                ("ring", self.off_ring, self.stages * self.stage_bytes),
                ("mid0", self.off_mid0, fk // 8 * self.mid_plane0),
                ("mid1", self.off_mid1, fk // 8 * self.mid_plane1),
                ("out", self.off_out, features * OUT_STRIDE * 2),
                ("barriers", self.off_bar, BARRIER_BYTES))


PLAN_FIELDS = tuple(f.name for f in dataclasses.fields(Plan))[1:]


def plan(batch: int, cin: int, h: int, w: int, features: int, layers: int,
         sms: int, vec: bool = True) -> Plan:
    """The launch of one call on a card of ``sms`` SMs: one persistent
    block an SM (at most one a work item), each work item an (image, tile);
    layer 0's weights resident in shared memory where they fit beside two
    ring stages, else carried by each stage; as many ring stages (at most
    ``MAX_STAGES``) as the rest leaves room for. ``vec``:
    the 16-byte load and store path (W % 8 == 0 and 16-byte aligned
    tensors)."""
    f, fk = features, -(-features // 16) * 16
    tiles_x, tiles_y = -(-w // TILE), -(-h // TILE)
    items = batch * tiles_x * tiles_y
    chunks = -(-cin // CHUNK)
    step = f * 32                      # bytes of B a k16 step
    w0 = chunks * 9 * step
    later = (layers - 1) * (fk // 16) * 9 * step
    stage_plane = input_rows(layers, 0) * 16
    mid0 = max([input_rows(layers, i) for i in (1, 3) if i < layers],
               default=0) * 16
    mid1 = input_rows(layers, 2) * 16 if layers > 2 else 0
    fixed = (_align(fk // 8 * mid0) + _align(fk // 8 * mid1)
             + _align(f * OUT_STRIDE * 2) + BARRIER_BYTES)
    for resident in (1, 0):
        w_bytes = w0 + later if resident else later
        stage_bytes = _align(2 * stage_plane + (0 if resident else 9 * step))
        room = (MAX_SMEM - fixed - _align(w_bytes)) // stage_bytes
        if room >= 2:
            break
    else:
        raise ValueError(f"conv_block_bf16: F={f}, L={layers} leaves no "
                         f"room for two ring stages")
    # At least two stages: a consumer releases a stage once the next
    # chunk's products have been issued.
    n = min(MAX_STAGES, room)
    off_ring = _align(w_bytes)
    off_mid0 = off_ring + n * stage_bytes
    off_mid1 = off_mid0 + _align(fk // 8 * mid0)
    off_out = off_mid1 + _align(fk // 8 * mid1)
    off_bar = off_out + _align(f * OUT_STRIDE * 2)
    return Plan(grid=max(1, min(items, sms)), batch=batch, cin=cin, h=h,
                w=w, layers=layers, tiles_x=tiles_x,
                tiles=tiles_x * tiles_y, items=items, chunks=chunks,
                stages=n, resident=resident, vec=int(vec), w_bytes=w_bytes,
                w0_bytes=w0, stage_plane=stage_plane,
                stage_bytes=stage_bytes, mid_plane0=mid0, mid_plane1=mid1,
                off_w=0, off_ring=off_ring, off_mid0=off_mid0,
                off_mid1=off_mid1, off_out=off_out, off_bar=off_bar,
                smem=off_bar + BARRIER_BYTES)


def vector_path(x: torch.Tensor) -> bool:
    """Whether a launch on contiguous ``x`` takes the 16-byte load and
    store path: rows of whole 16-byte runs (W % 8 == 0) from a 16-byte
    aligned start (the output is a fresh, aligned allocation)."""
    return x.shape[-1] % 8 == 0 and x.data_ptr() % 16 == 0


def work_items(p: Plan):
    """The (image, tile row, tile column) items each block of the grid
    takes, in order, as the kernel walks them: item = block + k x grid."""
    return [[(i // p.tiles, (i % p.tiles) // p.tiles_x,
              (i % p.tiles) % p.tiles_x)
             for i in range(block, p.items, p.grid)]
            for block in range(p.grid)]


def conv_block_bf16_plain(x: torch.Tensor, packed,
                          negative_slope: float = 0.2) -> torch.Tensor:
    """Plain PyTorch version: per layer, the nine taps of the 3x3 SAME conv
    as shifted (Ci -> F) products of the bfloat16 values summed in float32,
    then the bfloat16 bias and LeakyReLU in float32, then rounding to
    bfloat16. NCHW in, NCHW bfloat16 out."""
    x = x.to(torch.bfloat16)
    for layer in range(packed.layers):
        w = packed.layer_weight(layer).float()
        xf = F.pad(x.float(), (1, 1, 1, 1))
        _, _, h, wd = x.shape
        acc = None
        for ky in range(3):
            for kx in range(3):
                term = torch.einsum("bchw,cf->bfhw",
                                    xf[:, :, ky:ky + h, kx:kx + wd],
                                    w[:, ky, kx, :])
                acc = term if acc is None else acc + term
        bias = packed.biases[layer].float().view(1, -1, 1, 1)
        x = F.leaky_relu(acc + bias, negative_slope).to(torch.bfloat16)
    return x


@functools.lru_cache(maxsize=None)
def _lib(defines: tuple = ()):
    lib = _build.load("conv_block_bf16", defines)
    fn = lib.conv_block_bf16_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 \
        + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=256)
def _launch_args(shape, features, layers, sms, vec):
    p = plan(*shape, features, layers, sms, vec)
    return (ctypes.c_int * len(PLAN_FIELDS))(
        *(getattr(p, name) for name in PLAN_FIELDS)), p.grid


def conv_block_bf16(x: torch.Tensor, packed,
                    negative_slope: float = 0.2) -> torch.Tensor:
    """L x [3x3 SAME conv + bias + LeakyReLU] on NCHW bfloat16 ``x``
    (B, Cin, H, W) -> bfloat16 (B, F, H, W), with the weights of a
    ``PackedConvBlock`` packed in bfloat16."""
    if x.device.type == "cpu":
        return conv_block_bf16_plain(x, packed, negative_slope)
    return run_build(x, packed, negative_slope)


def run_build(x: torch.Tensor, packed, negative_slope: float = 0.2,
              defines: tuple = ()) -> torch.Tensor:
    """One launch, counted in ``launches``, of the kernel built with the
    macros ``defines`` (the ``STRIP_`` parts of
    ``perf/conv_block_bf16_parts.py``; none for the kernel itself) on a
    CUDA tensor."""
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype != torch.bfloat16 or packed.tc_weights.dtype != torch.bfloat16 \
            or packed.biases.dtype != torch.bfloat16:
        raise TypeError("conv_block_bf16 kernel takes bfloat16 input and "
                        "weights")
    if x.ndim != 4 or x.shape[1] != packed.cin:
        raise ValueError(f"x must be (B, {packed.cin}, H, W), "
                         f"got {tuple(x.shape)}")
    if packed.features % 8 or packed.features > MAX_FEATURES \
            or not 1 <= packed.layers <= MAX_LAYERS:
        raise ValueError(
            f"conv_block_bf16 kernel takes F % 8 == 0, F <= {MAX_FEATURES} "
            f"and 1..{MAX_LAYERS} layers; got F={packed.features}, "
            f"L={packed.layers}")
    for name, t in (("x", x), ("weights", packed.tc_weights),
                    ("biases", packed.biases)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    b, _, h, w = x.shape
    out = torch.empty((b, packed.features, h, w), dtype=x.dtype,
                      device=x.device)
    if out.numel() == 0:
        return out
    index = x.device.index if x.device.index is not None \
        else torch.cuda.current_device()
    args, grid = _launch_args((b, packed.cin, h, w), packed.features,
                              packed.layers, _sms(index), vector_path(x))
    fn = _lib(tuple(defines))
    with _build.on_device(index):
        rc = fn(x.data_ptr(), packed.tc_weights.data_ptr(),
                packed.biases.data_ptr(), out.data_ptr(), args,
                packed.features, grid, float(negative_slope),
                _build.stream_handle(index))
    _build.check(rc, "conv_block_bf16")
    _build.count_launch(__name__)
    return out
