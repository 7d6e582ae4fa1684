#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. It builds the port's CUDA kernels from the
sources in the checkout, holds each kernel against its plain PyTorch
version at the shapes of the paths below, drives each path once through the
user entry points at the published model widths with random weights from
fixed seeds, checks the results against CPU runs of the same code, and
prints one JSON line per phase. The paths:

  * rollout: 30-iteration fixed-parameter PnP-ADMM on one 128x128 slice
    (kernels K1, K2), then the one-slice rollout repeated 20 times for the
    median and quartiles of its rate;
  * eval: greedy Decision Transformer evaluation of 63 slices, 7 from each
    of 9 synthetic eval directories, with the fused policy forward (K1, K2,
    K3);
  * record: the expert corpus's device path (``data/expert.py``, what
    ``tools/make_dataset.py`` runs): 128 trajectories of 8 ADMM steps as
    one batch of 128 with the full-width U-Net (K1, K2), in memory (the
    card's machine has no h5py, so no states.h5 is written); three
    trajectories held against the one-slice ``rollout_expert`` on the card
    and two against it on the CPU;
  * mcts: the PUCB tree search of 16 of those slices, 30 rounds each, with
    the per-op policy forward (K1, K2, K4, K5) and the proxy scorer, on
    the host-tree backend and on the device-resident one (``DeviceMCTS``,
    the ``mcts`` verb's default, with float32 and bfloat16 node storage):
    tree-iterations/s, host syncs per round and peak device memory of
    each; then one tree on the card and on the CPU at --block_size 18 and
    36, and one tree on both backends on the card and on the device
    backend on the CPU with a quantized scorer; then the host search's
    single-node API (``MCTS.expand`` of one root, ``MCTS.beam_search``
    from a child: the launch path ``mcts_expand``) on the card against the
    CPU; then ARNIQA scores of 16 slices on the card and on the CPU;
  * mesh: evaluation, search and serving over a mesh
    (``training/sharding.py:make_mesh``) on the one card: the eval
    phase's 63 slices on a mesh of one shard (equal to no mesh, bit for
    bit) and of two shards on cuda:0 (64 padded, two rollouts of 32 one
    after another); two Gloo ranks spawned on cuda:0 running
    ``Evaluator.run`` on the 9 directories and
    ``DeviceMCTS.run_global_batches`` on 16 trees x 3 rounds; the device
    search on two shards in one process; ``RestorationService`` on two
    shards in fixed and policy modes at batch 16. Each is held against one
    process without a mesh;
  * serve: ``RestorationService`` at the traffic of
    benchmarks/serving_bench.py: policy mode at batch 16 (a burst of 64
    requests at pipeline_depth 1 and 2, then 32 concurrent clients x 8
    requests: requests/s, p50/p95/p99 latency, padded-slot share), fixed
    mode at batch 16 (64 requests) and mcts mode at batch 8 (8 requests,
    30 rounds), each held against a direct call on the same batch;
  * train: ``Trainer.train()`` of the Decision Transformer at the published
    widths with the default TrainerConfig (batch 48, 6-timestep windows of
    128x128 states), 2 epochs of 25 seeded batches, asynchronous
    checkpoints keeping the last one; then 3 updates on the card against
    the CPU (dropout off, warmup 2), and 2 updates, a preemption save, a
    resume and 2 more against 4 straight updates. Training runs none of
    K1-K5 (they have no backward);
  * native_gather: the training input pipeline's batch gather
    (``data/native_loader.py``, C++ built by g++) on a train batch's
    48 x 6 rows of 128x128 uint8 states, bit-exact against its numpy twin;
    host ms of each;
  * train_tp: training over a model axis, two Gloo ranks sharing the card
    on a mesh of data 1 x model 2 (Megatron-split attention and MLP
    projections), the published DT at B=48: 3 updates against the
    one-process step on the card in the training band, then steps/s
    beside the one-process step's, timed alike;
  * dryrun: ``tools/dryrun_multichip.py`` as 4 ranks sharing the card (a
    mesh of data 2 x model 2): the tensor-parallel train step, a sharded
    greedy evaluation (K1, K2, K3) and a device search (K1, K2, K4, K5),
    launches summed over the ranks as the paths dryrun_train (none),
    dryrun_eval and dryrun_mcts;
  * validate_parity: the real-checkpoint parity harness
    (``tools/validate_parity.py``) in its ``--selftest``: random weights
    in the reference's layouts, synthetic slices, the oracle on the CPU
    and the port on the card, at the published widths; eval and flex (RTG
    3) on 7 slices x 30 timesteps (launch path validate_parity_eval: K1,
    K2, K3), the device search on 2 slices x 8 iterations x 30 timesteps
    (validate_parity_mcts: K1, K2, K4, K5); every row within 0.05 dB of
    the oracle, the wall time of each side per mode;
  * trace: ``torch.profiler`` (``utils/profiling.py``) over one train step
    at B=48, one ADMM iteration at B=63 and at B=1, one search round of 16
    trees on each backend and one served policy batch of 16: device ms,
    idle share and the largest device ops of each;
  * unet_modes: one denoiser forward at B=63 on 128x128 slices in every
    ``--unet_packed`` mode x dtype: device ms, and the error against the
    direct float32 forward;
  * bench: the port's headline benchmark (``python -m
    dt4image_restoration_tpu_torch.bench``) in-process at full width (128²,
    30 iterations, every U-Net mode in both dtypes at B=1 and B=16, the
    A/B rounds, PSNR gates and the torch CPU baseline; its JSON line is
    the phase's), then the knee's B=128 point in direct, pallas and
    pallas_bf16 (the variants that run K1 and the bfloat16 K1) once with 2
    repeats;
    launch paths bench (its float32 variants' timed one-slice windows: K1,
    K2) and bench_bf16 (the bfloat16 ones': the bfloat16 K1, K2);
  * eval_bf16: the eval path in bfloat16 (``--dtype bfloat16``, U-Net mode
    ``pallas``: the bfloat16 K1, K2, K3) against the float32 eval and, on
    two slices, against the CPU;
  * mcts_bf16: a device-backend search of 16 trees x 3 rounds in bfloat16
    (the bfloat16 K1, K2, K4, K5), after a 1-round warm-up; its rate is
    that of rounds 1 and 2 (the 3-round search's wall less a 1-round
    one's).

K1 is timed at the batches of these paths (1, 16, 63, 96 and 128 slices;
K2 at 1, 16, 63 and 128), K3
at one slice and at 63, both bounded by the 3xTF32 tensor-core rate; K1 in
bfloat16 at 1, 16, 63, 96 and 128 slices against the dense bfloat16 rate and
cuDNN's bfloat16 conv chain, and against the float32 K1; K3 is
also held against a chain of PyTorch's own calls for the same stack
(``F.layer_norm``, ``F.linear``, ``F.scaled_dot_product_attention``,
``F.gelu``), timed from a CUDA graph. K4 is timed on the strided q, k, v
views the per-op forward hands it, at 18 tokens and at 90
(--block_size 90). K6 (the U-Net decoder's upsampling, pad and concat) is
timed at the decoder's four levels at 1, 16 and 63 slices in both dtypes
against its byte bound and ``F.interpolate`` with ``torch.cat``, and must
equal its plain version bit for bit; every path that runs the U-Net
launches it. The per_op_forward phase times one per-op policy forward
at the search's shape eagerly and from a CUDA graph and counts the kernels
it runs with ``torch.profiler``. The run fails if the build of K1 (either
dtype) or K3 spills registers, or if the bfloat16 K1's SASS shows no wgmma
(HGMMA) or cannot be read. The device line is preceded by the driver
version, the uncorrected volatile ECC count and nvcc's release line; each
K1 row (both dtypes) launches the kernel twice on its input and fails if
the two outputs differ bit for bit (the kernels use no atomics), and every
kernel row reports the share of its outputs off the plain version.
Launches are counted per path, from zero just before it to just after it; a bfloat16 path that launches the float32 K1,
or a float32 path the bfloat16 one, fails the run.
The line before the last is the kernel summary; the last line is the device
summary. Any failure ends the run with a traceback and a non-zero exit
code.

It imports nothing of JAX or of the JAX package, and exits non-zero
without a result when CUDA is unavailable or the port is not beside it.
"""
from __future__ import annotations

import contextlib
import io
import itertools
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

MU, SIGMA_D = 0.5, 15.0 / 255.0       # the fixed-parameter rollout's action
EVAL_BATCH = 63                        # 9 directories x 7 images
SEARCH_BATCH = 16                      # trees per search chunk (CLI default)
SEARCH_RTG = 5.0
SERVE_BATCH, SERVE_BURST = 16, 64       # benchmarks/serving_bench.py
SERVE_CLIENTS, SERVE_PER_CLIENT = 32, 8
SERVE_MCTS_BATCH = 8
SERVE_RTG, SERVE_TASK = 0.6, 2
EXPANSION_BATCH = 96                   # the search's 6-slot expansion
RECORD_BATCH, RECORD_EP_LEN = 128, 8    # make_dataset's chunk, --ep_len
ROLLOUT_REPEATS = 20                   # one-slice rollouts for a median
BENCH_REPEATS = 6                      # the bench phase's one-slice runs
BENCH_KNEE_REPEATS = 2                 # its B=128 knee rollouts
# The bench phase's knee variants: those that run K1 and the bfloat16 K1.
# The Winograd candidates launch no kernel of the port; the standalone bench
# times them.
BENCH_KNEE_VARIANTS = ("direct", "pallas", "pallas_bf16")
MESH_SEARCH_ROUNDS = 3                 # the mesh phase's searches
MESH_EVAL_DB = 0.01                    # sharded eval against one shard
SEARCH_DB = 0.05                       # the search band (PARITY.md)
MESH_JOIN_S = 600                      # the mesh phase's ranks' limit
SPAWN_JOIN_S = 300                     # train_tp's and dryrun's ranks'
GATHER_IMAGES, GATHER_REPEATS = 4096, 20  # native_gather's states, runs
TP_WARMUP_STEPS, TP_TIMED_STEPS = 2, 10   # train_tp's timing
TP_BATCHES = 4                         # train_tp's seeded batches
DRYRUN_RANKS = 4                       # a mesh of data 2 x model 2
# The parity harness's selftest (tools/validate_parity.py): eval and flex on
# the reference's 7 slices a directory, the search on 2, 30 timesteps each.
PARITY_EVAL_SLICES, PARITY_MCTS_SLICES = 7, 2
PARITY_ITERATIONS, PARITY_FLEX_RTG = 8, 3.0
TRAIN_BATCH, TRAIN_T = 48, 6           # TrainerConfig's batch, 18 tokens
TRAIN_STEPS, TRAIN_EPOCHS = 25, 2      # batches an epoch, epochs
H100_F32_FLOPS = 67e12                 # float32 outside the tensor cores
# K1 runs float32-accurate products on the TF32 tensor cores (495 TFLOP/s)
# as three TF32 products each (3xTF32).
H100_3XTF32_FLOPS = 495e12 / 3
H100_BYTES_PER_S = 3.35e12             # HBM3
# Dense bfloat16 tensor-core rate by the card's name (NVIDIA's data sheets);
# the H100 SXM's unless the name says PCIe or NVL.
BF16_FLOPS = (("H100 PCIe", 756e12), ("H100 NVL", 835e12), ("", 989e12))
# Kernels built around the tensor cores (mma.sync; wgmma in the bfloat16
# K1): the device line reports their SASS counts, and the run fails if
# their builds spill registers.
TENSOR_CORE_KERNELS = ("conv_block", "conv_block_bf16", "dt_decode")
REPLACES = {
    "conv_block": "dt4image_restoration_tpu/ops/pallas/conv_block.py:134",
    "conv_block_bf16":
        "dt4image_restoration_tpu/ops/pallas/conv_block.py:134",
    "kspace": "dt4image_restoration_tpu/ops/pallas/kspace.py:37",
    "dt_decode": "dt4image_restoration_tpu/ops/pallas/transformer.py:122",
    "attention": "dt4image_restoration_tpu/ops/pallas/attention.py:39",
    "layernorm": "dt4image_restoration_tpu/ops/pallas/layernorm.py:29",
    # No Pallas kernel: the JAX decoder's XLA interpolation matmuls.
    "upsample_concat": "none (dt4image_restoration_tpu/ops/image.py:56)",
    # No Pallas kernel: the JAX package has no Restormer.
    "mdta_gram": "none (Restormer's attention map; no JAX prior)",
}
# K6 repeats F.interpolate's arithmetic: bit for bit, no tolerance.
TOLERANCE = {"conv_block": 1e-4, "kspace": 1e-6, "dt_decode": 1e-4,
             "attention": 1e-5, "layernorm": 1e-5, "upsample_concat": 0.0,
             "mdta_gram": 1e-5}
# K1 in bfloat16 against its plain version: both sum in float32 in another
# order and round each layer to bfloat16, so a value near a rounding
# boundary can come out one bfloat16 step (2^-7 relative) apart, and such a
# step in an intermediate moves the next layer's sums. The band is two
# steps of the largest output: 2^-6 x max |plain|.
BF16_STEPS = 2.0 ** -6
# Against the float32 K1 on the same float32-valued input: the band of the
# JAX package's bfloat16 test of this kernel (tests/test_pallas.py),
# |bf16 - f32| <= 0.05 + 0.1 |f32| elementwise.
BF16_VS_F32 = (0.05, 0.1)
# The U-Net band (PARITY.md): float32 modes against the direct float32
# forward, |a - b| <= 2e-4 + 1e-3 |b|; bfloat16 modes: mean |a - f32| at
# most 1.5x that of the direct bfloat16 forward, plus 1e-4
# (tests/test_unet.py).
UNET_F32_BAND = (2e-4, 1e-3)
UNET_BF16_RULE = (1.5, 1e-4)
EVAL_BF16_DB = 0.15                    # tests/test_eval.py's bfloat16 band
# The shape of each kernel's summary row: the main path's (the evaluation
# batch for K1-K3, the search batch for K4 and K5).
SUMMARY_SHAPES = {
    "conv_block": (f"inc B={EVAL_BATCH}", f"up4 B={EVAL_BATCH}"),
    "conv_block_bf16": (f"inc B={EVAL_BATCH}", f"up4 B={EVAL_BATCH}"),
    "kspace": (f"B={EVAL_BATCH}",),
    "dt_decode": (f"B={EVAL_BATCH} T=12", f"B={EVAL_BATCH} T=18"),
    "attention": (f"B={SEARCH_BATCH} H=4 T=18 D=32",),
    "layernorm": (f"rows={SEARCH_BATCH * 18} E=128",),
    # The four decoder levels of one U-Net call.
    "upsample_concat": tuple(f"float32 {lv} B={EVAL_BATCH}"
                             for lv in ("up1", "up2", "up3", "up4")),
    # Restormer's five kinds of level, in bfloat16.
    "mdta_gram": tuple(f"{lv} B={EVAL_BATCH}" for lv in (
        "level1", "level2", "level3", "latent", "decoder1")),
}
# K7's (side, channels, heads) at Restormer's levels on 128x128 slices
# (decoder levels 3 and 2 have the shapes of encoder levels 3 and 2; the
# refinement has decoder level 1's).
RESTORMER_LEVELS = {"level1": (128, 48, 1), "level2": (64, 96, 2),
                    "level3": (32, 192, 4), "latent": (16, 384, 8),
                    "decoder1": (128, 96, 1)}
# K6's (a, skip) planes at the U-Net decoder's levels on 128x128 slices.
UPSAMPLE_LEVELS = {"up1": ((512, 8, 8), (256, 16, 16)),
                   "up2": ((256, 16, 16), (128, 32, 32)),
                   "up3": ((128, 32, 32), (64, 64, 64)),
                   "up4": ((64, 64, 64), (32, 128, 128))}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound(flops: float, nbytes: float, peak: float = H100_F32_FLOPS):
    """Least time on the H100 (ms) for ``flops`` operations at ``peak``
    operations/s and ``nbytes`` of compulsory traffic, and which of the two
    bounds it."""
    t_ops, t_bytes = flops / peak, nbytes / H100_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def bf16_peak(name: str) -> float:
    """The dense bfloat16 tensor-core rate of the card ``name``."""
    return next(rate for key, rate in BF16_FLOPS if key in name)


def sass_counts(library):
    """Tensor-core (mma.sync: HMMA TF32 and bfloat16; wgmma: HGMMA) and
    scalar FMA instructions in a built library's SASS, from ``cuobjdump
    -sass``; None where the tool is missing."""
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "cuobjdump")
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", str(library)], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    return {"hmma_tf32": len(re.findall(r"\bHMMA\.\S*TF32", sass)),
            "hmma_bf16": len(re.findall(r"\bHMMA\.\S*BF16", sass)),
            "hgmma": len(re.findall(r"\bHGMMA\.", sass)),
            "ffma": len(re.findall(r"\bFFMA\b", sass))}


def time_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_graph_ms(torch, fn, launches: int = 100, replays: int = 10
                  ) -> float:
    """Device time of one ``fn`` call: ``launches`` calls captured in one
    CUDA graph, replayed ``replays`` times between CUDA events. A graph
    replay launches the kernels without the host's per-call cost, so this
    times what the card does, not the wrapper."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * launches)


def qkv_views(qkv, h):
    """q, k, v as the per-op forward cuts them from its (B, T, 3E)
    projection: (B, H, T, D) views with a last stride of 1."""
    b, t, e3 = qkv.shape
    return tuple(a.reshape(b, t, h, e3 // (3 * h)).transpose(1, 2)
                 for a in qkv.split(e3 // 3, dim=-1))


def max_errors(got, ref):
    diff = (got - ref).abs()
    abs_err = float(diff.max())
    rel_err = float((diff / ref.abs().clamp_min(1e-6)).max())
    return abs_err, rel_err


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    from dt4image_restoration_tpu_torch.bench import nvidia_smi as smi
    return smi()


def driver_readings(kernels_build) -> dict:
    """The driver version, the uncorrected volatile ECC count and nvcc's
    release line: what tells one machine from another if a kernel's output
    goes wrong on one of them. A failure to read is reported, not
    raised."""
    def first_line(cmd, containing=""):
        try:
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=60)
        except (OSError, subprocess.SubprocessError) as e:
            return f"unread: {e!r}"
        return next((ln.strip() for ln in (r.stdout + r.stderr).splitlines()
                     if containing in ln), f"unread: rc {r.returncode}")

    try:
        nvcc = first_line([kernels_build._nvcc(), "--version"], "release")
    except RuntimeError as e:          # no nvcc: the build fails next
        nvcc = f"unread: {e!r}"
    return {"driver_ecc": first_line(
        ["nvidia-smi", "--query-gpu=driver_version,"
         "ecc.errors.uncorrected.volatile.total", "--format=csv,noheader"]),
        "nvcc": nvcc}


def phase_device(torch, kernels_build):
    smi = nvidia_smi()
    print(smi, flush=True)
    readings = driver_readings(kernels_build)
    print(f"driver_version, ecc.errors.uncorrected.volatile.total: "
          f"{readings['driver_ecc']}; nvcc: {readings['nvcc']}", flush=True)
    build_s = kernels_build.build()
    ptxas = {name: [ln.strip() for ln in
                    kernels_build.build_log(name).splitlines()
                    if re.search(r"Used \d+ registers|spill", ln)]
             for name in kernels_build.KERNEL_SOURCES}
    sass = {name: sass_counts(kernels_build.library_path(name))
            for name in TENSOR_CORE_KERNELS}
    emit({"phase": "device", "nvidia_smi": smi, **readings,
          "name": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": build_s, "ptxas": ptxas,
          **{f"{name}_sass": counts for name, counts in sass.items()}})
    # The bfloat16 K1 runs its products as wgmma (HGMMA in SASS).
    if sass["conv_block_bf16"] is None:
        raise AssertionError("cuobjdump is missing: conv_block_bf16's SASS "
                             "cannot be checked for HGMMA")
    if not sass["conv_block_bf16"]["hgmma"]:
        raise AssertionError("conv_block_bf16's build has no HGMMA")
    for name in TENSOR_CORE_KERNELS:
        spills = re.findall(r"(\d+) bytes spill (?:stores|loads)",
                            kernels_build.build_log(name))
        if not spills or any(n != "0" for n in spills):
            raise AssertionError(f"{name} spills registers: {ptxas[name]}")


def phase_kernels(torch, dev):
    """Each kernel against its plain version (and a library call where one
    computes the same function) at the evaluation path's shapes."""
    import torch.nn.functional as F

    from dt4image_restoration_tpu_torch.config import ModelConfig
    from dt4image_restoration_tpu_torch.models import (
        DecisionTransformer, UNetDenoiser, init_dt_params,
        random_unet_state_dict)
    from dt4image_restoration_tpu_torch.models.decision_transformer import (
        LN_EPS as ln_eps)
    from dt4image_restoration_tpu_torch.ops.csmri import kspace_consistency
    from dt4image_restoration_tpu_torch.ops.kernels import attention as k4
    from dt4image_restoration_tpu_torch.ops.kernels import conv_block as k1
    from dt4image_restoration_tpu_torch.ops.kernels import kspace as k2
    from dt4image_restoration_tpu_torch.ops.kernels import layernorm as k5
    from dt4image_restoration_tpu_torch.ops.kernels import transformer as k3
    from dt4image_restoration_tpu_torch.ops.kernels import (
        upsample_concat as k6)
    from dt4image_restoration_tpu_torch.ops.kernels import mdta_gram as k7

    gen = torch.Generator(device=dev).manual_seed(0)
    unet = UNetDenoiser().eval().requires_grad_(False)
    unet.load_state_dict(random_unet_state_dict(0))
    unet.to(dev)
    cfg = ModelConfig()
    dt = DecisionTransformer(cfg).eval().requires_grad_(False)
    dt.load_state_dict(init_dt_params(cfg, 0))
    dt.to(dev)
    rows = []

    def record(kernel, shape, got, ref, ms, plain_ms, library_ms, flops,
               nbytes, call_ms=None, peak=H100_F32_FLOPS, peak_name="",
               tolerance=None, **extra):
        abs_err, rel_err = max_errors(got, ref)
        bound_ms, bound_by = bound(flops, nbytes, peak)
        if peak_name and bound_by == "operations":
            bound_by = f"operations ({peak_name})"
        tol = TOLERANCE[kernel] if tolerance is None else tolerance
        # Outputs off the plain version by more than the tolerance (NaN
        # counts as off).
        wrong = float((~((got - ref).abs() <= tol)).float().mean())
        row = {"phase": "kernel", "kernel": kernel, "shape": shape,
               "max_abs_err": abs_err, "max_rel_err": rel_err,
               "tolerance": tol, "wrong_share": wrong, "kernel_ms": ms,
               "call_ms": call_ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "flops": flops, "bytes": nbytes,
               **extra}
        if peak != H100_F32_FLOPS:
            row["bound_f32_ms"] = bound(flops, nbytes)[0]
        emit(row)
        if not abs_err <= tol:
            raise AssertionError(f"{kernel} {shape}: max abs error {abs_err} "
                                 f"over {tol}, {100 * wrong:.2f} % of the "
                                 "outputs off")
        rows.append(row)

    def require_equal(kernel, shape, a, b):
        """K1 uses no atomics and a fixed order of products: two launches
        on one input must agree bit for bit, or the kernel races or the
        machine is at fault."""
        if not torch.equal(a, b):
            raise AssertionError(
                f"{kernel} {shape}: two launches on the same input differ "
                f"(max {float((a.float() - b.float()).abs().max())}, "
                f"{100 * float((a != b).float().mean()):.2f} % of outputs)")

    # K1 at the U-Net's two full-resolution blocks, at the batches of the
    # paths: one slice, the search's rollouts, the evaluation batch, the
    # search's expansion and the recorder's chunk.
    for name, block, cin in (("inc", unet.net.inc, 2),
                             ("up4", unet.net.up4, 96)):
        packed = block.packed_weights()
        for b in (1, SEARCH_BATCH, EVAL_BATCH, EXPANSION_BATCH,
                  RECORD_BATCH):
            x = torch.rand((b, cin, 128, 128), generator=gen, device=dev)
            got = k1.conv_block(x, packed)
            again = k1.conv_block(x, packed)
            ref = k1.conv_block_plain(x, packed)

            def library(x=x, block=block):
                y = x
                for conv in block.convs():
                    y = F.leaky_relu(F.conv2d(y, conv.weight, conv.bias,
                                              padding=1), 0.2)
                return y

            iters = 50 if b == 1 else 10
            f, hw = packed.features, 128 * 128
            flops = 2.0 * b * hw * 9 * (cin * f + 2 * f * f)
            nbytes = 4.0 * (b * hw * (cin + f) + packed.weights.numel()
                            + packed.biases.numel())
            record("conv_block", f"{name} B={b}", got, ref,
                   time_ms(torch, lambda: k1.conv_block(x, packed), iters),
                   time_ms(torch, lambda: k1.conv_block_plain(x, packed),
                           iters),
                   time_ms(torch, library, iters), flops, nbytes,
                   peak=H100_3XTF32_FLOPS, peak_name="3xTF32",
                   repeat_bit_equal=bool(torch.equal(got, again)))
            require_equal("conv_block", f"{name} B={b}", got, again)

    # K6 at the decoder's four levels, at one slice, the search's rollouts
    # and the evaluation batch, in both dtypes, against its plain version
    # (F.interpolate, pad, torch.cat): bit for bit. kernel_ms, plain_ms and
    # library_ms (F.interpolate and torch.cat alone, the yardstick) are
    # device times from CUDA graphs; call_ms is the eager wrapper call.
    for dtype in (torch.float32, torch.bfloat16):
        bits = torch.int32 if dtype == torch.float32 else torch.int16
        for lv, (a_plane, skip_plane) in UPSAMPLE_LEVELS.items():
            for b in (1, SEARCH_BATCH, EVAL_BATCH):
                a = torch.randn((b, *a_plane), generator=gen,
                                device=dev).to(dtype)
                skip = torch.randn((b, *skip_plane), generator=gen,
                                   device=dev).to(dtype)
                got = k6.upsample_concat(a, skip)
                ref = k6.upsample_concat_plain(a, skip)

                def library(a=a, skip=skip):
                    return torch.cat([skip, F.interpolate(
                        a, scale_factor=2, mode="bilinear",
                        align_corners=True)], dim=1)

                ca, ha, wa = a_plane
                cs, hs, ws = skip_plane
                # Each input read once, the concat written once; 9 flops
                # (three blends of two products and a sum) an upsampled
                # output.
                nbytes = a.element_size() * b * (
                    ca * ha * wa + cs * hs * ws + (cs + ca) * hs * ws)
                launches = 50 if b == 1 else 10
                record("upsample_concat",
                       f"{str(dtype)[6:]} {lv} B={b}", got.float(),
                       ref.float(),
                       time_graph_ms(torch, lambda: k6.upsample_concat(
                           a, skip), launches=launches, replays=5),
                       time_graph_ms(torch, lambda: k6.upsample_concat_plain(
                           a, skip), launches=launches, replays=5),
                       time_graph_ms(torch, library, launches=launches,
                                     replays=5),
                       9.0 * b * ca * hs * ws, float(nbytes),
                       call_ms=time_ms(torch, lambda: k6.upsample_concat(
                           a, skip), 50),
                       bit_equal_share=1.0 - int(
                           (got.view(bits) != ref.view(bits)).sum())
                       / got.numel())

    # K7 at Restormer's levels, in bfloat16 (the configuration's dtype), at
    # one slice, the search's batch and the evaluation batch, against its
    # plain version (normalize, matmul, softmax in float32 on the same
    # bfloat16 q and k). library_ms is the chain Restormer's code writes,
    # run in bfloat16 on the strided views; kernel_ms, plain_ms and
    # library_ms are device times from CUDA graphs, call_ms the eager
    # wrapper. Two launches on one input agree bit for bit (no atomics).
    # The bound: q and k read once and the float32 maps written once, or
    # the Gram's products at the bfloat16 rate.
    peak_k7 = bf16_peak(torch.cuda.get_device_name(0))
    for lv, (side, ch, heads) in RESTORMER_LEVELS.items():
        c = ch // heads
        for b in (1, SEARCH_BATCH, EVAL_BATCH):
            qkv = torch.randn((b, side, side, 3 * ch), generator=gen,
                              device=dev).to(torch.bfloat16)
            tau = 1.0 + 0.05 * torch.randn((heads,), generator=gen,
                                           device=dev)
            got = k7.mdta_gram(qkv, tau, heads)
            require_equal("mdta_gram", f"{lv} B={b}", got,
                          k7.mdta_gram(qkv, tau, heads))
            ref = k7.mdta_gram_plain(qkv, tau, heads)

            def library(qkv=qkv, tau=tau, heads=heads, c=c, b=b,
                        side=side):
                q, k, _ = qkv.reshape(b, side * side, 3, heads, c) \
                    .unbind(2)
                q = F.normalize(q.permute(0, 2, 3, 1), dim=-1)
                k = F.normalize(k.permute(0, 2, 3, 1), dim=-1)
                return ((q @ k.transpose(-2, -1))
                        * tau.reshape(-1, 1, 1)).softmax(dim=-1)

            launches = 50 if b == 1 else 10
            record("mdta_gram", f"{lv} B={b}", got, ref,
                   time_graph_ms(torch, lambda: k7.mdta_gram(
                       qkv, tau, heads), launches=launches, replays=5),
                   time_graph_ms(torch, lambda: k7.mdta_gram_plain(
                       qkv, tau, heads), launches=launches, replays=5),
                   time_graph_ms(torch, library, launches=launches,
                                 replays=5),
                   2.0 * b * side * side * ch * c,
                   float(b * (side * side * 2 * ch * qkv.element_size()
                              + heads * c * c * 4)),
                   call_ms=time_ms(torch, lambda: k7.mdta_gram(
                       qkv, tau, heads), 50),
                   peak=peak_k7, peak_name="bf16")

    # K1 in bfloat16 at the same blocks, at the batches of the bfloat16
    # paths: one slice, the search's rollouts, the evaluation batch, the
    # search's expansion and the bench's knee. The
    # kernel's device time from a CUDA graph, the eager call's from CUDA
    # events; cuDNN's bfloat16 conv chain as the library call. Each
    # input is a float32 draw rounded to bfloat16, so the float32 K1 on
    # the float32 draw shows what bfloat16 costs in accuracy.
    unet16 = UNetDenoiser(dtype="bfloat16").eval().requires_grad_(False)
    unet16.load_state_dict(random_unet_state_dict(0))
    unet16.to(dev)
    peak16 = bf16_peak(torch.cuda.get_device_name(0))
    for name, block, block32, cin in (
            ("inc", unet16.net.inc, unet.net.inc, 2),
            ("up4", unet16.net.up4, unet.net.up4, 96)):
        packed, packed32 = block.packed_weights(), block32.packed_weights()
        for b in (1, SEARCH_BATCH, EVAL_BATCH, EXPANSION_BATCH,
                  RECORD_BATCH):
            x32 = torch.rand((b, cin, 128, 128), generator=gen, device=dev)
            x = x32.to(torch.bfloat16)
            got = k1.conv_block(x, packed)
            again = k1.conv_block(x, packed)
            ref = k1.conv_block_plain(x, packed)
            f32 = k1.conv_block(x32, packed32)
            off = (got.float() - f32).abs()
            vs_f32 = float(off.max())
            lo, rel = BF16_VS_F32
            if not bool((off <= lo + rel * f32.abs()).all()):
                raise AssertionError(
                    f"conv_block_bf16 {name} B={b}: off the float32 K1 by "
                    f"{vs_f32}, over {lo} + {rel} |f32|")

            ws16 = [(c.weight.to(torch.bfloat16), c.bias.to(torch.bfloat16))
                    for c in block.convs()]

            def library(x=x, ws16=ws16):
                y = x
                for w16, b16 in ws16:
                    y = F.leaky_relu(F.conv2d(y, w16, b16, padding=1), 0.2)
                return y

            iters = 50 if b == 1 else 10
            f, hw = packed.features, 128 * 128
            flops = 2.0 * b * hw * 9 * (cin * f + 2 * f * f)
            nbytes = 2.0 * (b * hw * (cin + f) + packed.weights.numel()
                            + packed.biases.numel())
            record("conv_block_bf16", f"{name} B={b}", got.float(),
                   ref.float(),
                   time_graph_ms(torch, lambda: k1.conv_block(x, packed),
                                 launches=50 if b == 1 else 10, replays=5),
                   time_ms(torch, lambda: k1.conv_block_plain(x, packed),
                           iters),
                   time_graph_ms(torch, library,
                                 launches=50 if b == 1 else 10, replays=5),
                   flops, nbytes,
                   call_ms=time_ms(torch, lambda: k1.conv_block(x, packed),
                                   iters),
                   peak=peak16, peak_name="bf16",
                   tolerance=BF16_STEPS * float(ref.float().abs().max()),
                   max_abs_err_vs_f32=vs_f32,
                   vs_f32_band=list(BF16_VS_F32),
                   repeat_bit_equal=bool(torch.equal(got, again)))
            require_equal("conv_block_bf16", f"{name} B={b}", got, again)

    # K2 on the k-space of 128x128 slices. K2, K4 and K5 take microseconds,
    # less than the wrapper's host cost per call: their kernel_ms, plain_ms
    # and library_ms are device times from CUDA graphs, and call_ms is the
    # eager time per wrapper call.
    for b in (1, SEARCH_BATCH, EVAL_BATCH, RECORD_BATCH):
        shape = (b, 1, 128, 128)
        z = torch.complex(torch.randn(shape, generator=gen, device=dev),
                          torch.randn(shape, generator=gen, device=dev)) * 30
        y0 = torch.complex(torch.randn(shape, generator=gen, device=dev),
                           torch.randn(shape, generator=gen, device=dev)) * 30
        mask = torch.rand(shape, generator=gen, device=dev) < 0.3
        mu = torch.rand((b,), generator=gen, device=dev) + 0.1
        args = (z, y0, mask, mu)

        def library(z, y0, mask, mu):
            mu4 = mu.view(-1, 1, 1, 1)
            return torch.where(mask, (mu4 * z + y0) / (1 + mu4), z)

        got = torch.view_as_real(k2.kspace_consistency_kernel(*args))
        ref = torch.view_as_real(kspace_consistency(*args))
        # Three copies of the inputs, taken in turn: 77 MB at B=63, more
        # than the 50 MB L2, so the graph's launches read device memory as
        # the bound assumes, not the L2 a repeated launch would hit.
        copies = [args] + [tuple(a.clone() for a in args) for _ in range(2)]
        turn = itertools.cycle(copies)
        n = b * 128 * 128
        record("kspace", f"B={b}", got, ref,
               time_graph_ms(torch, lambda: k2.kspace_consistency_kernel(
                   *next(turn))),
               time_graph_ms(torch, lambda: kspace_consistency(*next(turn))),
               time_graph_ms(torch, lambda: library(*next(turn))),
               6.0 * int(mask.sum()), 25.0 * n + 4 * b,
               call_ms=time_ms(
                   torch, lambda: k2.kspace_consistency_kernel(*args), 200))

    # K3 on the policy's token batches: two-token (T=12) and three-token
    # (T=18) forwards of one slice and of 63. kernel_ms, plain_ms and
    # library_ms are device times from CUDA graphs; call_ms is the eager
    # wrapper call. The library chain is the same stack in PyTorch's own
    # fused calls; it must agree with the plain version like the kernel.
    packed = dt.packed_weights()
    e, nb, nh = cfg.embed_dim, cfg.n_blocks, cfg.n_heads
    w_bytes = 4.0 * sum(packed[k].numel() for k in k3.PACK_KEYS)

    def chain(x):
        b, t, _ = x.shape
        for i in range(nb):
            h = F.layer_norm(x, (e,), packed["ln1_s"][i], packed["ln1_b"][i],
                             ln_eps)
            q, k, v = F.linear(h, packed["qkv_w"][i].t(),
                               packed["qkv_b"][i]).view(
                                   b, t, 3, nh, e // nh).permute(2, 0, 3, 1, 4)
            att = F.scaled_dot_product_attention(q, k, v, is_causal=True)
            x = x + F.linear(att.transpose(1, 2).reshape(b, t, e),
                             packed["o_w"][i].t(), packed["o_b"][i])
            h = F.layer_norm(x, (e,), packed["ln2_s"][i], packed["ln2_b"][i],
                             ln_eps)
            h = F.gelu(F.linear(h, packed["fc_w"][i].t(), packed["fc_b"][i]))
            x = F.linear(h, packed["proj_w"][i].t(), packed["proj_b"][i])
        return F.layer_norm(x, (e,), packed["lnf_s"], packed["lnf_b"],
                            ln_eps)

    for b, t in itertools.product((1, EVAL_BATCH), (12, 18)):
        tokens = torch.randn((b, t, e), generator=gen, device=dev)
        got = k3.fused_dt_decode(tokens, packed, nb, nh)
        ref = k3.fused_dt_decode_plain(tokens, packed, nb, nh)
        chain_err = float((chain(tokens) - ref).abs().max())
        if not chain_err <= TOLERANCE["dt_decode"]:
            raise AssertionError(f"the library chain is {chain_err} off the "
                                 f"plain version at B={b} T={t}")
        # Per block: 24 T E^2 for the four projections, 2 E T(T+1) for the
        # causal scores and the weighted values.
        flops = b * nb * (24.0 * t * e * e + 2.0 * e * t * (t + 1))
        record("dt_decode", f"B={b} T={t}", got, ref,
               time_graph_ms(torch, lambda: k3.fused_dt_decode(
                   tokens, packed, nb, nh), launches=50),
               time_graph_ms(torch, lambda: k3.fused_dt_decode_plain(
                   tokens, packed, nb, nh), launches=20),
               time_graph_ms(torch, lambda: chain(tokens), launches=20),
               flops, 8.0 * tokens.numel() + w_bytes,
               call_ms=time_ms(torch, lambda: k3.fused_dt_decode(
                   tokens, packed, nb, nh), 100),
               peak=H100_3XTF32_FLOPS, peak_name="3xTF32",
               clusters_at_once=k3.clusters_at_once(e),
               sequences_per_cluster=k3.sequences_per_cluster(
                   b, t, k3.clusters_at_once(e)))

    # K4 on the per-op policy forward's heads, on the views it hands the
    # kernel: q, k and v cut from one (B, T, 3E) projection. 16 trees (the
    # search batch) and 63 sequences at 18 tokens, and 16 at 90 tokens
    # (--block_size 90); 4 heads of 32. SDPA runs on the same views.
    for b, t in ((SEARCH_BATCH, 18), (EVAL_BATCH, 18), (SEARCH_BATCH, 90)):
        h, d = cfg.n_heads, e // cfg.n_heads
        qkv = torch.randn((b, t, 3 * e), generator=gen, device=dev)
        q, k, v = qkv_views(qkv, h)
        got = k4.fused_causal_attention(q, k, v)
        ref = k4.fused_causal_attention_plain(q, k, v)
        # QK^T and PV over the causal half: 2 D T (T+1) per (b, h) pair.
        record("attention", f"B={b} H={h} T={t} D={d}", got, ref,
               time_graph_ms(torch, lambda: k4.fused_causal_attention(
                   q, k, v)),
               time_graph_ms(torch, lambda: k4.fused_causal_attention_plain(
                   q, k, v)),
               time_graph_ms(torch, lambda: F.scaled_dot_product_attention(
                   q, k, v, is_causal=True)),
               2.0 * b * h * d * t * (t + 1), 16.0 * b * h * t * d,
               call_ms=time_ms(torch, lambda: k4.fused_causal_attention(
                   q, k, v), 200), layout="qkv views")

    # K5 on the per-op forward's LayerNorms: B x 18 rows of 128; about 8
    # flops per value (sum, centre, square, sum, scale, shift).
    for b in (SEARCH_BATCH, EVAL_BATCH):
        x = torch.randn((b * 18, e), generator=gen, device=dev) + 1.0
        scale = 1 + 0.1 * torch.randn(e, generator=gen, device=dev)
        bias = 0.1 * torch.randn(e, generator=gen, device=dev)
        got = k5.layernorm(x, scale, bias)
        ref = k5.layernorm_plain(x, scale, bias)
        record("layernorm", f"rows={b * 18} E={e}", got, ref,
               time_graph_ms(torch, lambda: k5.layernorm(x, scale, bias)),
               time_graph_ms(torch, lambda: k5.layernorm_plain(
                   x, scale, bias)),
               time_graph_ms(torch, lambda: F.layer_norm(
                   x, (e,), scale, bias, ln_eps)),
               8.0 * x.numel(), 8.0 * x.numel() + 8.0 * e,
               call_ms=time_ms(torch, lambda: k5.layernorm(x, scale, bias),
                               200))
    return rows


def phase_per_op_forward(torch, dev):
    """One per-op policy forward (``use_pallas``: K4 and K5) at the
    search's shape: device ms from a CUDA graph, eager ms and the kernels
    it runs (``dt4image_restoration_tpu_torch/perf/per_op_forward.py``)."""
    from dt4image_restoration_tpu_torch.perf import per_op_forward
    out = per_op_forward.measure(torch, dev)
    emit(out)
    return out


def phase_rollout(torch, dev, ckpt_dir):
    """30 fixed-parameter ADMM iterations on one slice, on the card and on
    the CPU; then the same at the evaluation batch for throughput."""
    from dt4image_restoration_tpu_torch.data import make_mat_record
    from dt4image_restoration_tpu_torch.env import (compute_reward,
                                                    fixed_param_rollout,
                                                    reset_from_mat)
    from dt4image_restoration_tpu_torch.utils.loaders import load_denoiser

    unet_path = os.path.join(ckpt_dir, "unet-nm.pt")   # absent: seed 0
    rec = make_mat_record(size=128, acceleration=4, noise_sigma=15.0, seed=0)
    den = load_denoiser(unet_path, device=dev)
    final, hist = fixed_param_rollout(den, reset_from_mat(rec, device=dev),
                                      MU, SIGMA_D, 30)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    final, hist = fixed_param_rollout(den, reset_from_mat(rec, device=dev),
                                      MU, SIGMA_D, 30)
    psnr_gpu = float(compute_reward(final)[0, 0])
    wall = time.perf_counter() - t0

    den_cpu = load_denoiser(unet_path, device="cpu")
    final_cpu, _ = fixed_param_rollout(
        den_cpu, reset_from_mat(rec, device="cpu"), MU, SIGMA_D, 30)
    psnr_cpu = float(compute_reward(final_cpu)[0, 0])
    start = float(compute_reward(reset_from_mat(rec, device="cpu"))[0, 0])

    batch = {k: v.repeat(EVAL_BATCH, axis=0) for k, v in rec.items()}
    state = reset_from_mat(batch, device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    final_b, _ = fixed_param_rollout(den, state, MU, SIGMA_D, 30)
    torch.cuda.synchronize()
    wall_b = time.perf_counter() - t1
    out = {"phase": "rollout", "iters": 30, "psnr_start_db": start,
           "psnr_gpu_db": psnr_gpu, "psnr_cpu_db": psnr_cpu,
           "psnr_diff_db": psnr_gpu - psnr_cpu,
           "admm_iters_per_s_b1": 30 / wall,
           "slices_per_s_b63": EVAL_BATCH / wall_b,
           "admm_iters_per_s_b63": 30 / wall_b}
    emit(out)
    if not (math.isfinite(psnr_gpu) and abs(psnr_gpu - psnr_cpu) <= 0.05):
        raise AssertionError(f"rollout PSNR {psnr_gpu} dB on the card vs "
                             f"{psnr_cpu} dB on the CPU (band 0.05 dB)")
    if not bool(torch.isfinite(final_b.x).all()):
        raise AssertionError("batched rollout produced non-finite values")
    return out


def rollout_repeats(torch, dev, ckpt_dir, repeats=ROLLOUT_REPEATS):
    """The rollout phase's one-slice rollout, repeated: a run takes tens of
    milliseconds of mostly host time, which swings by a fifth between
    single runs, so the median and quartiles of ``repeats`` runs are what
    two trees are compared by."""
    import statistics
    from dt4image_restoration_tpu_torch.data import make_mat_record
    from dt4image_restoration_tpu_torch.env import (fixed_param_rollout,
                                                    reset_from_mat)
    from dt4image_restoration_tpu_torch.utils.loaders import load_denoiser

    den = load_denoiser(os.path.join(ckpt_dir, "unet-nm.pt"), device=dev)
    rec = make_mat_record(size=128, acceleration=4, noise_sigma=15.0, seed=0)
    rates = []
    for _ in range(repeats + 1):          # the first run warms up
        state = reset_from_mat(rec, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fixed_param_rollout(den, state, MU, SIGMA_D, 30)
        torch.cuda.synchronize()
        rates.append(30 / (time.perf_counter() - t0))
    q1, median, q3 = statistics.quantiles(rates[1:], n=4)
    out = {"phase": "rollout_repeats", "repeats": repeats,
           "admm_iters_per_s_b1": {"q1": q1, "median": median, "q3": q3}}
    emit(out)
    return out


def phase_record(torch, dev, ckpt_dir, kernels):
    """The expert corpus's device path (``data/expert.py:
    expert_trajectories``, what ``tools/make_dataset.py`` records with):
    RECORD_BATCH trajectories of RECORD_EP_LEN steps in one chunk on the
    card with the full-width U-Net (random weights, seed 0), kept in
    memory; a first recording warms the shapes up, the second is timed and
    its launches counted. Then three trajectories against
    ``rollout_expert`` (one slice, one step at a time) on the card and two
    against it on the CPU: PSNRs within 1e-3 dB, uint8 states within 1
    LSB. Returns the launches."""
    import numpy as np

    from dt4image_restoration_tpu_torch.config import OPTIMAL_TASKS
    from dt4image_restoration_tpu_torch.data import expert
    from dt4image_restoration_tpu_torch.env import admm_step
    from dt4image_restoration_tpu_torch.utils.loaders import load_denoiser

    unet_path = os.path.join(ckpt_dir, "unet-nm.pt")   # absent: seed 0
    den = load_denoiser(unet_path, device=dev)

    def record():
        return list(expert.expert_trajectories(
            den, n_traj=RECORD_BATCH, ep_len=RECORD_EP_LEN,
            batch_chunk=RECORD_BATCH, device=dev))

    record()
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trajs = record()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()

    checks = []
    den_cpu = load_denoiser(unet_path, device="cpu")
    for device, denoise, picks in ((dev, den, (0, RECORD_BATCH // 2,
                                              RECORD_BATCH - 1)),
                                   ("cpu", den_cpu, (0, RECORD_BATCH - 1))):
        for i in picks:
            _, mat = expert.expert_record(i, OPTIMAL_TASKS)
            obs, _, psnrs = expert.rollout_expert(
                lambda s, a, d=denoise: admm_step(d, s, a), mat,
                RECORD_EP_LEN, device=device)
            states = np.stack([(np.clip(ob.reshape(128, 128), 0, 1) * 255)
                               .astype(np.uint8) for ob in obs])
            checks.append({
                "against": f"rollout_expert on {device}", "trajectory": i,
                "psnr_max_diff_db": max(abs(a - b) for a, b in
                                        zip(trajs[i].psnrs, psnrs)),
                "state_max_lsb": int(np.abs(
                    trajs[i].states.astype(int) - states.astype(int)).max())})
    gains = [t.psnrs[-1] - t.psnrs[0] for t in trajs]
    out = {"phase": "record", "nvidia_smi": nvidia_smi(),
           "trajectories": len(trajs), "ep_len": RECORD_EP_LEN,
           "batch_chunk": RECORD_BATCH, "wall_s": wall,
           "trajectories_per_s": len(trajs) / wall,
           "slice_admm_steps_per_s": len(trajs) * RECORD_EP_LEN / wall,
           "expert_increment_db": sum(gains) / len(gains),
           "launches": counts, "checks": checks,
           "bands": {"psnr_db": 1e-3, "state_lsb": 1}}
    emit(out)
    if len(trajs) != RECORD_BATCH or not all(map(math.isfinite, gains)):
        raise AssertionError(f"recorded {len(trajs)} trajectories, gains "
                             f"finite: {all(map(math.isfinite, gains))}")
    for c in checks:
        if not (c["psnr_max_diff_db"] <= 1e-3 and c["state_max_lsb"] <= 1):
            raise AssertionError(f"recorded trajectory {c['trajectory']} "
                                 f"disagrees with {c['against']}: {c}")
    return counts


def _load_policy(cfg, ckpt_dir, device):
    """Random DT weights (seed 0) whose stop output T sits far below the
    0.5 threshold, so every episode runs its 30 steps on both devices."""
    import torch

    from dt4image_restoration_tpu_torch.models.decision_transformer import (
        ACTION_KEYS)
    from dt4image_restoration_tpu_torch.utils.loaders import load_dt
    dt = load_dt(cfg, os.path.join(ckpt_dir, "model_experiment_2.pt"),
                 device=device)
    with torch.no_grad():
        dt.predict_action.bias[ACTION_KEYS[cfg.mode].index("T")] = -3.0
    return dt


def eval_dirs(data_root):
    """9 synthetic eval directories of 7 slices, as the CLI's default list."""
    from dt4image_restoration_tpu_torch.config import EVAL_DIR_TOKENS
    from dt4image_restoration_tpu_torch.data import write_eval_dir
    return [write_eval_dir(os.path.join(data_root, tok), tok, n=7,
                           seed=1000 * i)
            for i, tok in enumerate(EVAL_DIR_TOKENS)]


def phase_eval(torch, dev, ckpt_dir, dirs):
    """Greedy evaluation of 9 directories x 7 slices at the published
    widths, and a CPU cross-check of two of the slices."""
    from dt4image_restoration_tpu_torch.config import ModelConfig
    from dt4image_restoration_tpu_torch.data import EvaluationDataset
    from dt4image_restoration_tpu_torch.inference import Evaluator
    from dt4image_restoration_tpu_torch.utils.loaders import load_denoiser

    cfg = ModelConfig(block_size=18, n_embeds=9, mode="norm")
    unet_path = os.path.join(ckpt_dir, "unet-nm.pt")

    evaluator = Evaluator(dt=_load_policy(cfg, ckpt_dir, dev),
                          denoise=load_denoiser(unet_path, device=dev),
                          cfg=cfg, max_timesteps=30, rtg_target=10.0,
                          device=dev)
    total = evaluator.run(dirs)
    m = evaluator.last_metrics
    n = len(m["reward"])

    records = [EvaluationDataset(d, 10.0)[0] for d in dirs[:2]]
    gpu = evaluator.evaluate_records(records)
    cpu = Evaluator(dt=_load_policy(cfg, ckpt_dir, "cpu"),
                    denoise=load_denoiser(unet_path, device="cpu"), cfg=cfg,
                    max_timesteps=30, rtg_target=10.0,
                    device="cpu").evaluate_records(records)
    out = {"phase": "eval", "images": n, "dirs": len(dirs),
           "total_increment_db": total,
           "avg_reward_db": float(m["reward"].mean()),
           "avg_increment_db": float(m["increment"].mean()),
           "avg_episode_len": float(m["episode_len"].mean()),
           "wall_s": m["wall_time_s"],
           "policy_steps_per_s": float(m["episode_len"].sum())
           / m["wall_time_s"],
           "check_episode_len_gpu": gpu["episode_len"].tolist(),
           "check_episode_len_cpu": cpu["episode_len"].tolist(),
           "check_reward_diff_db": float(
               abs(gpu["reward"] - cpu["reward"]).max())}
    emit(out)
    if n != EVAL_BATCH or not all(map(math.isfinite, m["reward"])):
        raise AssertionError(f"evaluation returned {n} rewards, finite: "
                             f"{all(map(math.isfinite, m['reward']))}")
    if list(gpu["episode_len"]) != list(cpu["episode_len"]) \
            or out["check_reward_diff_db"] > 0.05:
        raise AssertionError("evaluation on the card disagrees with the CPU")
    return {**out, "rewards": m["reward"]}


def phase_eval_bf16(torch, dev, ckpt_dir, dirs, f32):
    """The eval phase's 63 slices x 30 steps with ``--dtype bfloat16`` and
    U-Net mode ``pallas`` (the bfloat16 K1, K2, K3), against the float32
    eval (``f32``, phase_eval's result) and, on two slices, against the
    CPU in bfloat16."""
    from dt4image_restoration_tpu_torch.config import ModelConfig
    from dt4image_restoration_tpu_torch.data import EvaluationDataset
    from dt4image_restoration_tpu_torch.inference import Evaluator
    from dt4image_restoration_tpu_torch.utils.loaders import load_denoiser

    cfg = ModelConfig(block_size=18, n_embeds=9, mode="norm",
                      dtype="bfloat16")
    unet_path = os.path.join(ckpt_dir, "unet-nm.pt")

    def evaluator(device):
        return Evaluator(dt=_load_policy(cfg, ckpt_dir, device),
                         denoise=load_denoiser(unet_path, device=device,
                                               dtype="bfloat16",
                                               packed="pallas"),
                         cfg=cfg, max_timesteps=30, rtg_target=10.0,
                         device=device)

    ev = evaluator(dev)
    ev.run(dirs)
    m = ev.last_metrics
    records = [EvaluationDataset(d, 10.0)[0] for d in dirs[:2]]
    gpu = ev.evaluate_records(records)
    cpu = evaluator("cpu").evaluate_records(records)
    out = {"phase": "eval_bf16", "nvidia_smi": nvidia_smi(),
           "images": len(m["reward"]), "unet_packed": "pallas",
           "avg_reward_db": float(m["reward"].mean()),
           "avg_reward_f32_db": f32["avg_reward_db"],
           "avg_reward_diff_db": float(m["reward"].mean())
           - f32["avg_reward_db"],
           "max_slice_diff_db": float(abs(m["reward"]
                                          - f32["rewards"]).max()),
           "avg_episode_len": float(m["episode_len"].mean()),
           "wall_s": m["wall_time_s"],
           "policy_steps_per_s": float(m["episode_len"].sum())
           / m["wall_time_s"],
           "policy_steps_per_s_f32": f32["policy_steps_per_s"],
           "check_episode_len_gpu": gpu["episode_len"].tolist(),
           "check_episode_len_cpu": cpu["episode_len"].tolist(),
           "check_reward_diff_db": float(
               abs(gpu["reward"] - cpu["reward"]).max()),
           "band_db": EVAL_BF16_DB}
    emit(out)
    if len(m["reward"]) != EVAL_BATCH \
            or not all(map(math.isfinite, m["reward"])):
        raise AssertionError(f"bfloat16 evaluation returned {m['reward']}")
    if abs(out["avg_reward_diff_db"]) > EVAL_BF16_DB:
        raise AssertionError(
            f"bfloat16 evaluation's mean reward is {out['avg_reward_diff_db']}"
            f" dB off the float32 one (band {EVAL_BF16_DB} dB)")
    if list(gpu["episode_len"]) != list(cpu["episode_len"]) \
            or out["check_reward_diff_db"] > EVAL_BF16_DB:
        raise AssertionError("bfloat16 evaluation on the card disagrees "
                             "with the CPU")
    return out


def phase_eval_restormer(torch, dev, ckpt_dir, dirs):
    """Restormer at its published widths (random weights, as the CLI draws
    them without a file) as the prior of a bfloat16 evaluation of the
    first directory's 7 slices x 30 steps: K7 in every block, K2, K3; the
    prior's forward replayed from one graph."""
    from dt4image_restoration_tpu_torch.config import ModelConfig
    from dt4image_restoration_tpu_torch.inference import Evaluator
    from dt4image_restoration_tpu_torch.utils.loaders import load_denoiser

    cfg = ModelConfig(block_size=18, n_embeds=9, mode="norm",
                      dtype="bfloat16")
    ev = Evaluator(dt=_load_policy(cfg, ckpt_dir, dev),
                   denoise=load_denoiser(os.path.join(ckpt_dir, "none.pth"),
                                         device=dev, dtype="bfloat16",
                                         arch="restormer"),
                   cfg=cfg, max_timesteps=30, rtg_target=10.0, device=dev)
    ev.run(dirs[:1])
    m = ev.last_metrics
    out = {"phase": "eval_restormer", "nvidia_smi": nvidia_smi(),
           "images": len(m["reward"]),
           "avg_reward_db": float(m["reward"].mean()),
           "avg_episode_len": float(m["episode_len"].mean()),
           "wall_s": m["wall_time_s"],
           "prior_graph": ev.prior_graph_stats()}
    emit(out)
    if not all(map(math.isfinite, m["reward"])):
        raise AssertionError(f"Restormer evaluation returned {m['reward']}")
    return out


def search_records(dirs):
    """The first SEARCH_BATCH slices in directory order, with the CLI's
    per-directory seeds."""
    from dt4image_restoration_tpu_torch.data import EvaluationDataset
    records, seeds = [], []
    for d in dirs:
        ds = EvaluationDataset(d, rtg_target=SEARCH_RTG, kind="optimal")
        for i in range(len(ds)):
            records.append(ds[i])
            seeds.append(i)
    return records[:SEARCH_BATCH], seeds[:SEARCH_BATCH]


def _search(torch, device, ckpt_dir, mcts_cfg, record_trace=False,
            block_size=18, backend="host", value=None, dtype="float32",
            **kw):
    """The CLI's search (``mcts`` verb) on random weights: the per-op
    policy with K4 and K5, the proxy scorer (or ``value``, a batched
    scorer, with its per-image twin for the host backend), on the
    host-tree backend or the device-resident one; policy and denoiser
    compute in ``dtype`` (``--dtype``)."""
    from dt4image_restoration_tpu_torch.config import ModelConfig
    from dt4image_restoration_tpu_torch.inference import (BatchedMCTS,
                                                          DeviceMCTS)
    from dt4image_restoration_tpu_torch.models import (
        proxy_value_fn, proxy_value_fn_batched)
    from dt4image_restoration_tpu_torch.utils.loaders import load_denoiser
    cfg = ModelConfig(block_size=block_size, n_embeds=9, mode="norm",
                      use_pallas=True, dtype=dtype)
    value_fn = proxy_value_fn if value is None else host_twin(torch, value)
    common = dict(
        dt=_load_policy(cfg, ckpt_dir, device),
        denoise=load_denoiser(os.path.join(ckpt_dir, "unet-nm.pt"),
                              device=device, dtype=dtype),
        model_cfg=cfg, cfg=mcts_cfg, value_fn=value_fn,
        record_trace=record_trace, device=device)
    if backend == "host":
        return BatchedMCTS(**common)
    return DeviceMCTS(value_fn_batched=value or proxy_value_fn_batched,
                      **common, **kw)


def quantized_value(x):
    """A scorer of (B, H, W) images that float reordering between devices
    and backends cannot move: the mean, quantized."""
    return (x.mean(dim=(1, 2)) * 1e3).round() / 10.0


def host_twin(torch, batched):
    """The host search's (1, H, W) -> float twin of a batched scorer."""
    import numpy as np

    def value(x):
        x = torch.as_tensor(np.asarray(x, np.float32))
        return float(batched(x.reshape(1, *x.shape[-2:]))[0])
    return value


def compare_searches(runs, what):
    """Traces, priors and rewards of one-tree searches against the first."""
    (r0, t0), out = runs[0], []
    key = ("iter", "time", "edge", "index")
    trace = [[e[k] for k in key] for e in t0]
    for r1, t1 in runs[1:]:
        out.append({
            "against": what, "trace": trace,
            "same_trace": trace == [[e[k] for k in key] for e in t1],
            "prior_max_rel_diff": max(
                abs(a - b) / abs(b) for x, y in zip(t0, t1)
                for a, b in zip(x["probs"], y["probs"])),
            "reward_gpu_db": r0, "reward_other_db": r1,
            "reward_diff_db": abs(r0 - r1)})
    return out


def search_check(torch, dev, ckpt_dir, record, seed, iterations,
                 block_size, printed):
    """One tree searched for ``iterations`` rounds on the card and on the
    CPU: the traces (iteration, depth, edge, index), the largest relative
    difference of the priors, and the rewards."""
    from dt4image_restoration_tpu_torch.config import MCTSConfig
    runs = []
    for device in (dev, "cpu"):
        m = _search(torch, device, ckpt_dir,
                    MCTSConfig(iterations=iterations), record_trace=True,
                    block_size=block_size)
        with contextlib.redirect_stdout(printed):
            runs.append((m.run(record, seed=seed), m.traces[0]))
    (check,) = compare_searches(runs, "CPU")
    return {"block_size": block_size, "iterations": iterations, **check}


def device_search_checks(torch, dev, ckpt_dir, record, seed, printed):
    """One tree, 3 rounds, the quantized scorer: the device backend on the
    card against the host backend on the card and against itself on the
    CPU."""
    from dt4image_restoration_tpu_torch.config import MCTSConfig
    runs = []
    for backend, device in (("device", dev), ("host", dev),
                            ("device", "cpu")):
        m = _search(torch, device, ckpt_dir, MCTSConfig(iterations=3),
                    record_trace=True, backend=backend,
                    value=quantized_value)
        with contextlib.redirect_stdout(printed):
            runs.append((m.run(record, seed=seed), m.traces[0]))
    return (compare_searches(runs[:2], "host backend on the card")
            + compare_searches(runs[::2], "device backend on the CPU"))


def expand_check(torch, dev, ckpt_dir, record, seed, kernels):
    """The host search's single-node API on one root, on the card and on
    the CPU: ``MCTS.expand`` (one policy step, six-slot ADMM step) and
    ``MCTS.beam_search`` from its first child (a greedy rollout to the
    horizon). Launches are counted over the card's two calls. Returns
    (the comparison, the launches)."""
    import numpy as np

    from dt4image_restoration_tpu_torch.config import MCTSConfig
    from dt4image_restoration_tpu_torch.env import reset_from_mat
    from dt4image_restoration_tpu_torch.inference import Node
    from dt4image_restoration_tpu_torch.ops.metrics import psnr

    (_, rtg0, _, task0), mat = record
    task = int(np.asarray(task0).reshape(-1)[0])
    runs, counts = {}, None
    for device in (dev, "cpu"):
        m = _search(torch, device, ckpt_dir, MCTSConfig(), backend="host")
        env = reset_from_mat(mat, device=device)
        root = Node(0, 1.0, None, 0, 0, env, env,
                    float(np.asarray(rtg0).reshape(-1)[0]))
        root.bufs = m._seed_bufs(env.x.reshape(1, -1),
                                 torch.tensor(rtg0).reshape(()),
                                 torch.as_tensor(task0))
        if device is dev:
            kernels.reset_launch_counts()
        _, adict, _ = m.expand(root, task, np.random.default_rng(seed), 0)
        value, x, ep_len = m.beam_search(root.children[0], task)
        if device is dev:
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
        gt = root.env_state.gt.cpu().reshape(x.shape)
        runs[device] = {
            "action": root.action, "priors": [c.prob for c in root.children],
            "children_x": torch.cat([c.env_state.x.cpu()
                                     for c in root.children]),
            "value": value, "ep_len": ep_len,
            "beam_psnr_db": float(psnr(gt, torch.from_numpy(x))[0, 0])}
    card, cpu = runs[dev], runs["cpu"]
    lo, rel = UNET_F32_BAND
    off = (card["children_x"] - cpu["children_x"]).abs()
    out = {"against": "CPU",
           "action_max_rel_diff": float(np.max(
               np.abs(card["action"] - cpu["action"])
               / np.maximum(np.abs(cpu["action"]), 1e-6))),
           "prior_max_rel_diff": max(abs(a - b) / abs(b) for a, b in
                                     zip(card["priors"], cpu["priors"])),
           "children_x_max_abs_diff": float(off.max()),
           "children_x_in_band": bool(
               (off <= lo + rel * cpu["children_x"].abs()).all()),
           "beam_ep_len": [card["ep_len"], cpu["ep_len"]],
           "beam_value": [card["value"], cpu["value"]],
           "beam_psnr_diff_db": abs(card["beam_psnr_db"]
                                    - cpu["beam_psnr_db"])}
    return out, counts


def count_syncs(torch, fn):
    """Host syncs ``fn`` makes on the card, as PyTorch's sync debug mode
    reports them (one warning per synchronising call)."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def timed_search(torch, mcts, records, seeds, kernels, printed):
    """One search of ``records``, launches counted over it alone: (rewards,
    wall s, launches, peak device memory MB)."""
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        rewards = mcts.run_batch(records, seeds=seeds)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (rewards, wall, kernels.launch_counts(),
            torch.cuda.max_memory_allocated() / 2 ** 20)


def phase_mcts(torch, dev, ckpt_dir, dirs, kernels):
    """The tree search of 16 slices (one --search_batch chunk) with the
    default MCTSConfig (30 rounds, 5 children, 30 timesteps) on the host
    backend and on the device backend at float32 and bfloat16 node
    storage, launches counted over each search alone; host syncs per round
    of each backend over rounds 1 and 2 of the 16 trees; then one tree on
    the card and on the CPU, for 3 rounds at --block_size 18 and for 2 at
    --block_size 36 (36-token windows, past the fused kernel K3's 32), the
    device backend's checks and the single-node API's
    (:func:`expand_check`). Returns the launches of the host and device
    searches and of the single-node calls, by path."""
    from dt4image_restoration_tpu_torch.config import MCTSConfig
    records, seeds = search_records(dirs)
    mcts_cfg = MCTSConfig()
    printed = io.StringIO()   # the search's "MCTS Reward:" lines
    backends = {}
    for name, kw in (("host", dict(backend="host")),
                     ("device", dict(backend="device")),
                     ("device_bf16", dict(backend="device",
                                          node_dtype="bfloat16"))):
        mcts = _search(torch, dev, ckpt_dir, mcts_cfg, **kw)
        rewards, wall, counts, peak = timed_search(torch, mcts, records,
                                                   seeds, kernels, printed)
        # Syncs of rounds 1 and 2: a 3-round search's less a 1-round
        # one's, so that the set-up of the trees does not count.
        syncs = []
        for rounds in (1, 3):
            short = _search(torch, dev, ckpt_dir,
                            MCTSConfig(iterations=rounds), **kw)
            with contextlib.redirect_stdout(printed):
                syncs.append(count_syncs(torch, lambda: short.run_batch(
                    records, seeds=seeds)))
        backends[name] = {
            "wall_s": wall, "tree_iterations_per_s": len(records)
            * mcts_cfg.iterations / wall,
            "mean_best_psnr_db": sum(rewards) / len(rewards),
            "rewards": rewards,
            "host_syncs_per_round": (syncs[1] - syncs[0]) / 2,
            "host_syncs_set_up_and_round_0": syncs[0],
            "peak_memory_mb": peak, "launches": counts}
        if len(rewards) != SEARCH_BATCH \
                or not all(map(math.isfinite, rewards)):
            raise AssertionError(f"{name} search returned {rewards}")

    checks = [search_check(torch, dev, ckpt_dir, records[0], seeds[0], 3,
                           18, printed),
              search_check(torch, dev, ckpt_dir, records[0], seeds[0], 2,
                           36, printed)]
    device_checks = device_search_checks(torch, dev, ckpt_dir, records[0],
                                         seeds[0], printed)
    single_node, expand_launches = expand_check(torch, dev, ckpt_dir,
                                                records[0], seeds[0],
                                                kernels)
    out = {"phase": "mcts", "nvidia_smi": nvidia_smi(),
           "trees": len(records), "iterations": mcts_cfg.iterations,
           "n_children": mcts_cfg.n_children,
           "max_timesteps": mcts_cfg.max_timesteps,
           "wall_s": backends["host"]["wall_s"],
           "tree_iterations_per_s":
               backends["host"]["tree_iterations_per_s"],
           "mean_best_psnr_db": backends["host"]["mean_best_psnr_db"],
           "launches": backends["host"]["launches"],
           "backends": backends, "checks": checks,
           "device_checks": device_checks, "single_node": single_node}
    emit(out)
    for c in checks:
        if not c["same_trace"] or c["prior_max_rel_diff"] > 1e-4 \
                or c["reward_diff_db"] > 0.05:
            raise AssertionError(f"the search on the card disagrees with "
                                 f"the CPU at --block_size "
                                 f"{c['block_size']}")
    for c in device_checks:
        if not c["same_trace"] or c["prior_max_rel_diff"] > 1e-4 \
                or c["reward_diff_db"] > 0.05:
            raise AssertionError(f"the device search on the card disagrees "
                                 f"with the {c['against']}")
    c = single_node
    if c["action_max_rel_diff"] > 2e-3 or c["prior_max_rel_diff"] > 1e-4 \
            or not c["children_x_in_band"] \
            or c["beam_ep_len"][0] != c["beam_ep_len"][1] \
            or c["beam_psnr_diff_db"] > 0.05:
        raise AssertionError(f"expand/beam_search on the card disagree with "
                             f"the CPU: {c}")
    return {"mcts": backends["host"]["launches"],
            "mcts_device": backends["device"]["launches"],
            "mcts_expand": expand_launches}


def _mesh_evaluator(dev, ckpt_dir, mesh):
    """The eval phase's Evaluator (published widths, random weights) on
    ``mesh``."""
    from dt4image_restoration_tpu_torch.config import ModelConfig
    from dt4image_restoration_tpu_torch.inference import Evaluator
    from dt4image_restoration_tpu_torch.utils.loaders import load_denoiser
    cfg = ModelConfig(block_size=18, n_embeds=9, mode="norm")
    return Evaluator(
        dt=_load_policy(cfg, ckpt_dir, dev),
        denoise=load_denoiser(os.path.join(ckpt_dir, "unet-nm.pt"),
                              device=dev),
        cfg=cfg, max_timesteps=30, rtg_target=10.0, device=dev, mesh=mesh)


def _evaluated(ev, dirs):
    """``ev.run(dirs)``: (metrics, the aggregates it printed)."""
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        ev.run(dirs)
    return ev.last_metrics, printed.getvalue()


def mesh_rank(rank, port, device, ckpt_dir, dirs, out_path):
    """One of the mesh phase's two ranks, both on ``device``: join a Gloo
    group
    of two at ``port``, run ``Evaluator.run`` on ``dirs`` over a mesh of
    the two processes (a warm-up run, then one timed), then
    ``DeviceMCTS.run_global_batches`` on the search's 16 trees, launches
    counted over each; write the results to ``out_path.<rank>`` as JSON."""
    import torch
    import torch.distributed as dist

    from dt4image_restoration_tpu_torch.config import MCTSConfig
    from dt4image_restoration_tpu_torch.ops import kernels
    from dt4image_restoration_tpu_torch.training.sharding import make_mesh
    from dt4image_restoration_tpu_torch.utils.device import resolve_device
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=2, rank=rank)
    try:
        dev = resolve_device(device)
        mesh = make_mesh(devices=[dev])
        ev = _mesh_evaluator(dev, ckpt_dir, mesh)
        _evaluated(ev, dirs)                                # warm-up
        kernels.reset_launch_counts()
        m, printed = _evaluated(ev, dirs)
        eval_launches = kernels.launch_counts()
        records, seeds = search_records(dirs)
        search = _search(torch, dev, ckpt_dir,
                         MCTSConfig(iterations=MESH_SEARCH_ROUNDS),
                         backend="device", mesh=mesh)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        rewards = search.run_global_batches(records, seeds,
                                            batch_size=SEARCH_BATCH)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        search_s = time.perf_counter() - t0
        search_launches = kernels.launch_counts()
        with open(f"{out_path}.{rank}", "w") as f:
            json.dump({
                "printed": printed, "reward": m["reward"].tolist(),
                "episode_len": m["episode_len"].tolist(),
                "wall_s": m["wall_time_s"], "eval_launches": eval_launches,
                "search_rewards": rewards, "search_s": search_s,
                "search_launches": search_launches}, f)
    finally:
        dist.destroy_process_group()


def spawn_mesh_ranks(dev, ckpt_dir, dirs, tmp):
    """Run :func:`mesh_rank` in two spawned processes on ``dev``; their
    results and the seconds from the spawn to the last join."""
    out_path = os.path.join(tmp, "mesh_rank")
    seconds = spawn_ranks(mesh_rank, 2, (str(dev), ckpt_dir, dirs, out_path),
                          "mesh", MESH_JOIN_S)
    ranks = []
    for r in range(2):
        with open(f"{out_path}.{r}") as f:
            ranks.append(json.load(f))
    return ranks, seconds


def phase_mesh(torch, dev, ckpt_dir, dirs, tmp, kernels):
    """Evaluation, search and serving over a mesh on the one card, each
    against one process without a mesh: (a) the eval phase's 63 slices on
    a mesh of one shard, bit-equal; (b) on two shards of cuda:0 (64
    padded), lengths equal and rewards within MESH_EVAL_DB; (c) two Gloo
    ranks on cuda:0 running Evaluator.run on the 9 directories, with
    (b)'s checks and the same aggregates printed by both; (d) the device
    search of 16 trees x 3 rounds over the two ranks
    (run_global_batches) and over two shards in one process, within the
    search band; (e) RestorationService on two shards in fixed and policy
    modes at batch 16, images within 1e-5 and lengths equal. Returns the
    launches of each path."""
    import numpy as np

    from dt4image_restoration_tpu_torch.config import MCTSConfig
    from dt4image_restoration_tpu_torch.training.sharding import make_mesh
    t_phase = time.perf_counter()
    one, two = make_mesh(devices=[dev]), make_mesh(devices=[dev, dev])
    paths, failed = {}, []
    out = {"phase": "mesh", "nvidia_smi": nvidia_smi()}

    m0, _ = _evaluated(_mesh_evaluator(dev, ckpt_dir, None), dirs)
    kernels.reset_launch_counts()
    m1, _ = _evaluated(_mesh_evaluator(dev, ckpt_dir, one), dirs)
    paths["mesh_one"] = kernels.launch_counts()
    kernels.reset_launch_counts()
    m2, _ = _evaluated(_mesh_evaluator(dev, ckpt_dir, two), dirs)
    paths["mesh_eval"] = kernels.launch_counts()

    def against_one(m):
        return {"episode_len_equal": np.asarray(m["episode_len"]).tolist()
                == m0["episode_len"].tolist(),
                "reward_max_abs_diff_db": float(np.abs(
                    np.asarray(m["reward"]) - m0["reward"]).max())}

    out["eval_unsharded_s"] = m0["wall_time_s"]
    out["eval_one_shard_s"] = m1["wall_time_s"]
    out["eval_two_shards_s"] = m2["wall_time_s"]
    out["one_shard_bit_equal"] = (
        m1["reward"].tolist() == m0["reward"].tolist()
        and m1["episode_len"].tolist() == m0["episode_len"].tolist())
    out["two_shards"] = against_one(m2)
    if not out["one_shard_bit_equal"]:
        failed.append("(a) one shard differs from no mesh")
    c = out["two_shards"]
    if not c["episode_len_equal"] or c["reward_max_abs_diff_db"] \
            > MESH_EVAL_DB:
        failed.append(f"(b) two shards: {c}")

    ranks, ranks_s = spawn_mesh_ranks(dev, ckpt_dir, dirs, tmp)
    paths["mesh_ranks_eval"] = {k: sum(r["eval_launches"][k] for r in ranks)
                                for k in ranks[0]["eval_launches"]}
    paths["mesh_ranks_search"] = {
        k: sum(r["search_launches"][k] for r in ranks)
        for k in ranks[0]["search_launches"]}
    out["ranks"] = [{**against_one(r), "wall_s": r["wall_s"],
                     "search_s": r["search_s"],
                     "eval_launches": r["eval_launches"],
                     "search_launches": r["search_launches"]}
                    for r in ranks]
    out["ranks_eval_max_wall_s"] = max(r["wall_s"] for r in ranks)
    out["ranks_spawn_to_join_s"] = ranks_s
    out["ranks_printed_equal"] = ranks[0]["printed"] == ranks[1]["printed"]
    for i, c in enumerate(out["ranks"]):
        if not c["episode_len_equal"] or c["reward_max_abs_diff_db"] \
                > MESH_EVAL_DB:
            failed.append(f"(c) rank {i}: {c}")
    if not out["ranks_printed_equal"]:
        failed.append("(c) the ranks printed different aggregates")

    records, seeds = search_records(dirs)
    search_cfg = MCTSConfig(iterations=MESH_SEARCH_ROUNDS)
    want = _search(torch, dev, ckpt_dir, search_cfg,
                   backend="device").run_batch(records, seeds=seeds,
                                               verbose=False)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    sharded = _search(torch, dev, ckpt_dir, search_cfg, backend="device",
                      mesh=two).run_batch(records, seeds=seeds,
                                          verbose=False)
    out["search_two_shards_s"] = time.perf_counter() - t0
    paths["mesh_search"] = kernels.launch_counts()
    for name, got in (("search_ranks", ranks[0]["search_rewards"]),
                      ("search_ranks_1", ranks[1]["search_rewards"]),
                      ("search_two_shards", sharded)):
        diff = np.abs(np.asarray(got) - np.asarray(want))
        out[name] = {"trees": len(got),
                     "reward_max_abs_diff_db": float(diff.max()),
                     "trees_exactly_equal": int((diff == 0).sum())}
        if len(got) != len(want) or diff.max() > SEARCH_DB:
            failed.append(f"(d) {name}: {out[name]}")

    reqs = serve_requests(SERVE_BATCH)
    for mode in ("fixed", "policy"):
        results = []
        for mesh in (None, two):
            kernels.reset_launch_counts()
            svc = _service(torch, dev, ckpt_dir, mode,
                           batch_size=SERVE_BATCH, mesh=mesh)
            try:
                results.append(_served(svc, reqs)[0])
            finally:
                svc.close(timeout=600)
            if svc.stats()["failed"]:
                failed.append(f"(e) {mode}: {svc.stats()}")
        paths[f"mesh_serve_{mode}"] = kernels.launch_counts()
        want_r, got_r = results
        c = out[f"serve_{mode}"] = {
            "image_max_abs_diff": float(max(
                np.abs(a.image - b.image).max()
                for a, b in zip(want_r, got_r))),
            "episode_len_equal": [a.episode_len for a in want_r]
            == [b.episode_len for b in got_r]}
        if c["image_max_abs_diff"] > 1e-5 or not c["episode_len_equal"]:
            failed.append(f"(e) {mode}: {c}")
    out["launches"] = paths
    out["wall_s"] = time.perf_counter() - t_phase
    emit(out)
    if failed:
        raise AssertionError(f"mesh phase: {failed}")
    return paths


def phase_mcts_bf16(torch, dev, ckpt_dir, dirs, kernels):
    """A device-backend search of 16 trees x 3 rounds with ``--dtype
    bfloat16`` (the bfloat16 K1, K2, K4, K5; proxy scorer), launches
    counted over it alone, after a 1-round search that warms the bfloat16
    path up. Its tree-iterations/s are those of rounds 1 and 2: the
    3-round search's wall less that of a 1-round search, so that neither
    the set-up of the trees nor round 0 counts (``wall_s`` keeps them).
    Returns the launches."""
    from dt4image_restoration_tpu_torch.config import MCTSConfig
    records, seeds = search_records(dirs)
    printed = io.StringIO()
    kw = dict(backend="device", dtype="bfloat16")
    warm = _search(torch, dev, ckpt_dir, MCTSConfig(iterations=1), **kw)
    with contextlib.redirect_stdout(printed):
        warm.run_batch(records, seeds=seeds)
    mcts_cfg = MCTSConfig(iterations=3)
    mcts = _search(torch, dev, ckpt_dir, mcts_cfg, **kw)
    rewards, wall, counts, peak = timed_search(torch, mcts, records, seeds,
                                               kernels, printed)
    one = _search(torch, dev, ckpt_dir, MCTSConfig(iterations=1), **kw)
    wall_1 = timed_search(torch, one, records, seeds, kernels, printed)[1]
    emit({"phase": "mcts_bf16", "nvidia_smi": nvidia_smi(),
          "trees": len(records), "iterations": mcts_cfg.iterations,
          "wall_s": wall, "wall_1_round_s": wall_1,
          "tree_iterations_per_s": len(records)
          * (mcts_cfg.iterations - 1) / (wall - wall_1),
          "tree_iterations_per_s_with_set_up": len(records)
          * mcts_cfg.iterations / wall,
          "mean_best_psnr_db": sum(rewards) / len(rewards),
          "peak_memory_mb": peak, "launches": counts})
    if len(rewards) != SEARCH_BATCH or not all(map(math.isfinite, rewards)):
        raise AssertionError(f"bfloat16 search returned {rewards}")
    return counts


def phase_unet_modes(torch, dev):
    """One denoiser forward at B=63 on 128x128 slices (random weights,
    seed 0) in every ``--unet_packed`` mode x dtype: device ms (CUDA
    events, after a warm-up) and the error against the direct float32
    forward, held to the U-Net band (float32) and the JAX package's
    bfloat16 rule."""
    from dt4image_restoration_tpu_torch.models import (UNetDenoiser,
                                                       random_unet_state_dict)
    from dt4image_restoration_tpu_torch.models.unet import UNET_MODES
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.rand((EVAL_BATCH, 1, 128, 128), generator=gen, device=dev)
    sigma = torch.full((EVAL_BATCH,), SIGMA_D, device=dev)
    sd = random_unet_state_dict(0)
    outs, ms = {}, {}
    for dtype in ("float32", "bfloat16"):
        for mode in UNET_MODES:
            den = UNetDenoiser(dtype=dtype, packed=mode)
            den.load_state_dict(sd)
            den = den.eval().requires_grad_(False).to(dev)
            with torch.no_grad():
                outs[dtype, mode] = den(x, sigma)
                ms[dtype, mode] = time_ms(torch, lambda: den(x, sigma), 3,
                                          warmup=1)
    ref = outs["float32", "none"]
    base16 = float((outs["bfloat16", "none"] - ref).abs().mean())
    rows, failed = [], []
    for (dtype, mode), out in outs.items():
        diff = (out - ref).abs()
        row = {"dtype": dtype, "mode": mode, "device_ms": ms[dtype, mode],
               "max_abs_err": float(diff.max()),
               "mean_abs_err": float(diff.mean())}
        if dtype == "float32":
            lo, rel = UNET_F32_BAND
            ok = bool((diff <= lo + rel * ref.abs()).all())
        else:
            k, lo = UNET_BF16_RULE
            row["mean_abs_err_limit"] = k * base16 + lo
            ok = row["mean_abs_err"] <= row["mean_abs_err_limit"]
        rows.append(row)
        if not ok:
            failed.append(row)
    emit({"phase": "unet_modes", "nvidia_smi": nvidia_smi(),
          "batch": EVAL_BATCH, "f32_band": list(UNET_F32_BAND),
          "bf16_rule": list(UNET_BF16_RULE), "modes": rows})
    if failed:
        raise AssertionError(f"U-Net modes off the band: {failed}")
    return rows


def phase_bench(torch, dev):
    """The port's headline benchmark (``dt4image_restoration_tpu_torch/
    bench.py``) in-process at full width with the knee skipped, then the
    knee's B=128 point in BENCH_KNEE_VARIANTS once with BENCH_KNEE_REPEATS
    rollouts each; the bench's JSON line, with the knee's numbers added, is
    the phase's line. Returns the launch paths bench (the float32
    variants' timed one-slice windows) and bench_bf16 (the bfloat16
    ones'). A missed gate fails the run."""
    from dt4image_restoration_tpu_torch import bench
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rc = bench.main(["--device", str(dev), "--knee", "none",
                         "--repeats", str(BENCH_REPEATS)])
    line = json.loads(printed.getvalue().strip().splitlines()[-1])
    knee = bench.Bench(dev, variants=BENCH_KNEE_VARIANTS)
    knee.knee((bench.PALLAS_KNEE_BATCH,), repeats=BENCH_KNEE_REPEATS)
    emit({"phase": "bench", "nvidia_smi": nvidia_smi(), **line,
          "knee_candidates": knee.extras})
    if rc != 0 or knee.failed:
        raise AssertionError(f"the bench exited {rc}; knee gates missed: "
                             f"{knee.failed}")
    paths = {"bench": {}, "bench_bf16": {}}
    for name, counts in line["extras"]["launches"].items():
        path = paths["bench" if bench.VARIANTS[name][1] == "float32"
                     else "bench_bf16"]
        for k, n in counts.items():
            path[k] = path.get(k, 0) + n
    return paths


def phase_arniqa(torch, dev, dirs):
    """ARNIQA (random hub-layout weights, seed 0) scores of 16 slices on
    the card and on the CPU, and on the card in bfloat16 (the ``mcts``
    verb's scorer under ``--dtype bfloat16``) against the CPU's float32
    scores within the JAX package's bfloat16 band, 0.05 max(1, |score|)."""
    import numpy as np

    from dt4image_restoration_tpu_torch.models import (
        ARNIQA, random_arniqa_state_dict, score_images)
    records, _ = search_records(dirs)
    x = torch.from_numpy(np.stack(
        [np.asarray(mat["gt"], np.float32).reshape(128, 128)
         for _, mat in records]))
    scores = {}
    for device in (dev, "cpu"):
        model = ARNIQA().eval().requires_grad_(False)
        model.load_state_dict(random_arniqa_state_dict(0))
        model.to(device)
        if device != "cpu":
            score_images(model, x.to(device))
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        scores[str(device)] = score_images(model, x.to(device)).cpu()
        if device != "cpu":
            torch.cuda.synchronize()
        scores[f"{device}_s"] = time.perf_counter() - t0
        if device != "cpu":
            scores["bf16"] = score_images(model, x.to(device),
                                          dtype="bfloat16").cpu()
    diff = float((scores[str(dev)] - scores["cpu"]).abs().max())
    bf16_off = (scores["bf16"] - scores["cpu"]).abs()
    bf16_band = 0.05 * scores["cpu"].abs().clamp_min(1.0)
    out = {"phase": "arniqa", "images": len(records),
           "score_mean": float(scores["cpu"].mean()),
           "max_abs_diff": diff, "tolerance": 1e-4,
           "bf16_max_abs_diff": float(bf16_off.max()),
           "wall_s_gpu": scores[f"{dev}_s"], "wall_s_cpu": scores["cpu_s"]}
    emit(out)
    if not diff <= 1e-4:
        raise AssertionError(f"ARNIQA on the card differs from the CPU by "
                             f"{diff}")
    if not bool((bf16_off <= bf16_band).all()):
        raise AssertionError(f"bfloat16 ARNIQA on the card is "
                             f"{float(bf16_off.max())} off the float32 "
                             "scores")
    return out


def serve_requests(n, offset=0):
    """``n`` synthetic 128x128 requests (seeds offset..offset+n-1), as
    benchmarks/serving_bench.py builds them."""
    from dt4image_restoration_tpu_torch.data import make_mat_record
    from dt4image_restoration_tpu_torch.serving import RestorationRequest
    return [RestorationRequest(mat=make_mat_record(size=128, seed=i),
                               rtg=SERVE_RTG, task=SERVE_TASK)
            for i in range(offset, offset + n)]


def _service(torch, dev, ckpt_dir, mode, **kw):
    """A RestorationService on the published widths' random weights."""
    from dt4image_restoration_tpu_torch.config import ModelConfig
    from dt4image_restoration_tpu_torch.serving import RestorationService
    from dt4image_restoration_tpu_torch.utils.loaders import load_denoiser
    cfg = ModelConfig(block_size=18, n_embeds=9, mode="norm",
                      use_pallas=True)
    return RestorationService(
        denoise=load_denoiser(os.path.join(ckpt_dir, "unet-nm.pt"),
                              device=dev),
        dt=_load_policy(cfg, ckpt_dir, dev), mode=mode, max_timesteps=30,
        device=dev, **kw)


def _served(svc, requests, timeout=600):
    """Submit every request, wait for each; (results, wall s). A failed or
    cancelled future raises."""
    t0 = time.perf_counter()
    futs = [svc.submit(r) for r in requests]
    results = [f.result(timeout=timeout) for f in futs]
    return results, time.perf_counter() - t0


def _clients(svc, requests, per_client, timeout=600):
    """One thread a request, each submitting it ``per_client`` times in
    turn: (latencies ms, wall s, errors)."""
    import threading
    lat, errors, lock = [], [], threading.Lock()

    def client(req):
        for _ in range(per_client):
            t0 = time.perf_counter()
            try:
                svc.submit(req).result(timeout=timeout)
            except Exception as exc:   # reported, and the run fails
                with lock:
                    errors.append(repr(exc))
                return
            with lock:
                lat.append(1e3 * (time.perf_counter() - t0))

    threads = [threading.Thread(target=client, args=(r,)) for r in requests]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    if any(t.is_alive() for t in threads):
        errors.append("a client did not finish")
    return lat, time.perf_counter() - t0, errors


def _direct_batch(torch, dev, ckpt_dir, requests, mode):
    """The direct calls the service wraps, on the same (live) batch:
    (images (n, H, W), psnr (n,), episode lengths (n,))."""
    import numpy as np

    from dt4image_restoration_tpu_torch.config import ModelConfig
    from dt4image_restoration_tpu_torch.env import (
        compute_reward, fixed_param_rollout, reset_from_mat)
    from dt4image_restoration_tpu_torch.inference import (
        greedy_rollout, initial_policy_setup, policy_forward)
    from dt4image_restoration_tpu_torch.models import (make_dt_embed_apply,
                                                       make_state_encode)
    from dt4image_restoration_tpu_torch.utils.loaders import load_denoiser
    den = load_denoiser(os.path.join(ckpt_dir, "unet-nm.pt"), device=dev)
    mats = {k: np.concatenate([np.asarray(r.mat[k]) for r in requests])
            for k in ("x0", "y0", "mask", "gt")}
    mats["x0"] = np.clip(mats["x0"], 0, None)
    env = reset_from_mat(mats, device=dev)
    n = len(requests)
    with torch.no_grad():
        if mode == "fixed":
            final, _ = fixed_param_rollout(den, env, MU, SIGMA_D, 30)
            ep = torch.full((n,), 30)
            reward = compute_reward(final)
        else:
            cfg = ModelConfig(block_size=18, n_embeds=9, mode="norm",
                              use_pallas=True)
            dt = _load_policy(cfg, ckpt_dir, dev)
            apply = policy_forward(dt, cfg)
            encode = make_state_encode(dt)
            x0 = torch.from_numpy(np.stack(
                [np.asarray(r.mat["x0"], np.float32)[..., 0].reshape(-1)
                 for r in requests])).to(dev)
            bufs, _, action, rtg = initial_policy_setup(
                apply, cfg, x0, torch.full((n,), SERVE_RTG, device=dev),
                torch.full((n,), SERVE_TASK, device=dev), 30, encode=encode)
            final, reward, ep, _ = greedy_rollout(
                apply, den, cfg, env, bufs, action, rtg, 30, encode=encode,
                dt_embed_apply=make_dt_embed_apply(apply))
    return (final.x[:, 0].cpu().numpy(), reward[:, 0].cpu().numpy(),
            ep.cpu().numpy())


def phase_serve(torch, dev, ckpt_dir, kernels):
    """RestorationService in its three modes at the traffic of
    benchmarks/serving_bench.py, each mode held against a direct call on
    the same batch. Returns each mode's launches."""
    import numpy as np
    paths, out = {}, {"phase": "serve", "nvidia_smi": nvidia_smi()}
    failed = []

    def check_stats(name, svc):
        st = svc.stats()
        out[f"{name}_stats"] = st
        if st["failed"] or st["cancelled"]:
            failed.append(f"{name}: {st}")

    # Policy mode: a burst at pipeline_depth 1 and 2, then the clients.
    burst = serve_requests(SERVE_BURST)
    kernels.reset_launch_counts()
    for depth in (1, 2):
        svc = _service(torch, dev, ckpt_dir, "policy",
                       batch_size=SERVE_BATCH, pipeline_depth=depth)
        try:
            _served(svc, burst[:SERVE_BATCH])          # warm
            results, wall = _served(svc, burst)
            out[f"policy_burst_requests_per_s_depth{depth}"] = \
                SERVE_BURST / wall
            if depth == 1:
                first = results[:SERVE_BATCH]
                st0 = svc.stats()
                lat, wall, errors = _clients(
                    svc, serve_requests(SERVE_CLIENTS), SERVE_PER_CLIENT)
                st1 = svc.stats()
                failed += errors
                p50, p95, p99 = np.percentile(lat, [50, 95, 99])
                batches = st1["batches"] - st0["batches"]
                out.update({
                    "policy_clients": SERVE_CLIENTS,
                    "policy_requests_per_client": SERVE_PER_CLIENT,
                    "policy_clients_requests_per_s": len(lat) / wall,
                    "policy_p50_ms": float(p50), "policy_p95_ms": float(p95),
                    "policy_p99_ms": float(p99),
                    "policy_clients_batches": batches,
                    "policy_clients_padded_share":
                        (st1["padded_slots"] - st0["padded_slots"])
                        / (batches * SERVE_BATCH)})
        finally:
            svc.close(timeout=600)
        check_stats(f"policy_depth{depth}", svc)
    paths["serve_policy"] = kernels.launch_counts()
    images, psnr, eps = _direct_batch(torch, dev, ckpt_dir,
                                      burst[:SERVE_BATCH], "policy")
    out["policy_check_episode_len_equal"] = \
        [r.episode_len for r in first] == eps.tolist()
    out["policy_check_image_max_abs_diff"] = float(max(
        np.abs(r.image - np.clip(images[i], 0, 1)).max()
        for i, r in enumerate(first)))

    # Fixed mode: 64 requests at batch 16.
    kernels.reset_launch_counts()
    svc = _service(torch, dev, ckpt_dir, "fixed", batch_size=SERVE_BATCH)
    try:
        results, wall = _served(svc, burst)
    finally:
        svc.close(timeout=600)
    check_stats("fixed", svc)
    paths["serve_fixed"] = kernels.launch_counts()
    out["fixed_requests_per_s"] = SERVE_BURST / wall
    images, psnr, eps = _direct_batch(torch, dev, ckpt_dir,
                                      burst[:SERVE_BATCH], "fixed")
    out["fixed_check_image_max_abs_diff"] = float(max(
        np.abs(r.image - np.clip(images[i], 0, 1)).max()
        for i, r in enumerate(results[:SERVE_BATCH])))
    out["fixed_check_psnr_max_abs_diff"] = float(max(
        abs(r.psnr_db - psnr[i]) for i, r in enumerate(
            results[:SERVE_BATCH])))

    # Mcts mode: 8 requests at batch 8, 30 rounds, against run_batch.
    from dt4image_restoration_tpu_torch.config import MCTSConfig
    reqs = burst[:SERVE_MCTS_BATCH]
    kernels.reset_launch_counts()
    svc = _service(torch, dev, ckpt_dir, "mcts", batch_size=SERVE_MCTS_BATCH)
    try:
        results, wall = _served(svc, reqs)
    finally:
        svc.close(timeout=600)
    check_stats("mcts", svc)
    paths["serve_mcts"] = kernels.launch_counts()
    out["mcts_requests_per_s"] = SERVE_MCTS_BATCH / wall
    out["mcts_wall_s"] = wall
    direct = _search(torch, dev, ckpt_dir,
                     MCTSConfig(max_timesteps=30), backend="device")
    recs = []
    for r in reqs:
        mat = {k: np.asarray(v) for k, v in r.mat.items()}
        mat["x0"] = np.clip(mat["x0"], 0, None)
        recs.append(((None, np.float32(r.rtg), None, np.int32(r.task)), mat))
    want = direct.run_batch(recs, seeds=[direct.cfg.seed] * len(recs),
                            detailed=True, verbose=False)
    out["mcts_check_rewards_equal"] = \
        [r.psnr_db for r in results] == [w["reward"] for w in want]
    out["mcts_mean_psnr_db"] = sum(r.psnr_db for r in results) / len(results)
    out["launches"] = paths
    emit(out)
    if failed:
        raise AssertionError(f"the service failed requests: {failed}")
    if not (out["policy_check_episode_len_equal"]
            and out["policy_check_image_max_abs_diff"] <= 1e-5):
        raise AssertionError("policy mode disagrees with greedy_rollout")
    if not (out["fixed_check_image_max_abs_diff"] <= 1e-5
            and out["fixed_check_psnr_max_abs_diff"] <= 1e-4):
        raise AssertionError("fixed mode disagrees with fixed_param_rollout")
    if not out["mcts_check_rewards_equal"]:
        raise AssertionError("mcts mode disagrees with DeviceMCTS.run_batch")
    return paths


def train_batches(n: int, seed: int = 0):
    """``n`` seeded host batches as benchmarks/train_bench.py builds them
    (B=48, 6 timesteps, 128x128 states, 9 tasks), where row i keeps
    6 - i % 4 valid timesteps and zeros after them, as the dataset pads
    short trajectories: the masked mean counts 216 of 288 positions."""
    import numpy as np
    rng = np.random.default_rng(seed)
    b, t = TRAIN_BATCH, TRAIN_T
    masks = (np.arange(t)[None, :] < (t - np.arange(b) % 4)[:, None]
             ).astype(np.float32)[..., None]
    return [{
        "states": rng.uniform(0, 1, (b, t, 128 * 128)).astype(np.float32)
        * masks,
        "actions": rng.uniform(0, 1, (b, t, 3)).astype(np.float32) * masks,
        "rtg": rng.uniform(0, 1, (b, t, 1)).astype(np.float32) * masks,
        "traj_masks": masks,
        "timesteps": np.broadcast_to(np.arange(t, dtype=np.int32)[None, :,
                                                                   None],
                                     (b, t, 1)).copy(),
        "task": rng.integers(0, 9, (b, t)).astype(np.int32),
    } for _ in range(n)]


def _train_model(torch, device, seed=0, **cfg_kw):
    """The published DT (block 18, embed 128, 4 heads, 5 blocks, 9 tasks)
    with random weights from ``seed``, as the train verb builds it."""
    from dt4image_restoration_tpu_torch.config import ModelConfig
    from dt4image_restoration_tpu_torch.models import (DecisionTransformer,
                                                       init_dt_params)
    cfg = ModelConfig(block_size=18, n_embeds=9, **cfg_kw)
    model = DecisionTransformer(cfg)
    model.load_state_dict(init_dt_params(cfg, seed))
    return model.to(device)


def _trainer(torch, device, batches, ckpt_dir, seed=0, stop_after=None,
             **kw):
    """A Trainer of one epoch over ``batches`` (default TrainerConfig),
    whose step records its losses and, after ``stop_after`` steps,
    requests the stop that SIGTERM would."""
    from dt4image_restoration_tpu_torch.config import TrainerConfig
    from dt4image_restoration_tpu_torch.training import (Trainer,
                                                         init_train_state,
                                                         make_train_step)
    tcfg = TrainerConfig(max_epochs=kw.pop("max_epochs", 1))
    step, losses = make_train_step(), []

    def recorded(state, batch):
        losses.append(step(state, batch))
        if stop_after is not None and len(losses) == stop_after:
            trainer.request_stop()
        return losses[-1]

    n_steps = tcfg.max_epochs * len(batches)
    trainer = Trainer(
        train_step=recorded, config=tcfg,
        state=init_train_state(_train_model(torch, device, seed), tcfg,
                               n_steps),
        batches=lambda epoch: iter(batches), checkpoint_dir=ckpt_dir, **kw)
    return trainer, losses


def _leaf_errors(got, ref):
    """Per parameter tensor: the 2-norm of the error over the 2-norm of
    ``ref``, and the largest error over the largest value of ``ref``."""
    out = {}
    for name, r in ref.items():
        d = (got[name].double() - r.double())
        out[name] = (float(d.norm() / r.double().norm().clamp_min(1e-30)),
                     float(d.abs().max() / r.double().abs().max()
                           .clamp_min(1e-30)))
    return out


def phase_train(torch, dev, tmp, kernels):
    """``Trainer.train()`` at the published widths, then the card/CPU and
    resume checks. Returns the train path's kernel launches."""
    from dt4image_restoration_tpu_torch.config import TrainerConfig
    from dt4image_restoration_tpu_torch.training import (init_train_state,
                                                         make_train_step,
                                                         shard_batch)
    batches = train_batches(TRAIN_STEPS)
    ckpt = os.path.join(tmp, "train")
    trainer, losses = _trainer(torch, dev, batches, ckpt,
                               max_epochs=TRAIN_EPOCHS, async_save=True,
                               keep_last=1)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    losses = [float(x) for x in losses]
    timing = trainer.step_timer.summary()
    n = len(losses)

    # Card vs CPU: 3 updates from one init, dropout off, warmup 2 so that
    # updates 2 and 3 run at lr 1.5e-4 and 3e-4.
    tcfg = TrainerConfig(warmup_steps=2)
    runs = []
    for device in (dev, "cpu"):
        model = _train_model(torch, device, dropout=0.0, embd_dropout=0.0)
        state = init_train_state(model, tcfg, 10)
        step = make_train_step()
        runs.append(([float(step(state, shard_batch(b, device)))
                      for b in batches[:3]],
                     {k: p.detach().cpu() for k, p in
                      model.named_parameters()}))
    (gpu_losses, gpu_p), (cpu_losses, cpu_p) = runs
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(gpu_losses,
                                                        cpu_losses))
    errs = _leaf_errors(gpu_p, cpu_p)
    norm_rel = max(e[0] for e in errs.values())
    # The QKV biases' key thirds get gradients that are zero in exact
    # arithmetic; their rounding noise sets those entries' updates, so only
    # the norm bound holds them (tests/test_torch_train.py:_close_leaf).
    max_rel = max(e[1] for k, e in errs.items()
                  if not k.endswith("qkv_proj.bias"))

    # Resume: 2 updates, a stop (the preemption save), a Trainer resuming
    # from state_latest.pt on weights of another seed and 2 more updates,
    # against 4 straight updates (dropout on). cuDNN's deterministic
    # algorithms make the two runs' arithmetic the same.
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        straight, straight_losses = _trainer(
            torch, dev, batches[:4], os.path.join(tmp, "straight"))
        straight.train()
        first, _ = _trainer(torch, dev, batches[:4],
                            os.path.join(tmp, "first"), stop_after=2)
        first.train()
        resumed, resumed_losses = _trainer(
            torch, dev, batches[2:4], os.path.join(tmp, "resumed"), seed=1,
            resume_from=os.path.join(tmp, "first", "state_latest.pt"))
        resumed.train()
    finally:
        torch.backends.cudnn.deterministic = prev
    resume_rel = max(e[1] for e in _leaf_errors(
        {k: p.detach().cpu() for k, p in
         resumed.state.model.named_parameters()},
        {k: p.detach().cpu() for k, p in
         straight.state.model.named_parameters()}).values())
    resume_loss_rel = max(abs(float(a) - float(b)) / abs(float(b)) for a, b
                          in zip(resumed_losses, straight_losses[2:]))

    out = {"phase": "train", "nvidia_smi": nvidia_smi(),
           "batch": TRAIN_BATCH, "timesteps": TRAIN_T, "steps": n,
           "epochs": TRAIN_EPOCHS, "wall_s": wall,
           "steps_per_s": n / wall,
           "samples_per_s": n * TRAIN_BATCH / wall,
           "step_p50_ms": 1e3 * timing["p50_s"],
           "step_p95_ms": 1e3 * timing["p95_s"],
           "steady_samples_per_s": TRAIN_BATCH / timing["p50_s"],
           "first_loss": losses[0], "last_loss": losses[-1],
           "max_memory_allocated_mb":
               torch.cuda.max_memory_allocated() / 2 ** 20,
           "checkpoints": sorted(os.listdir(ckpt)),
           "launches": counts,
           "check_loss_gpu": gpu_losses, "check_loss_cpu": cpu_losses,
           "check_loss_max_rel": loss_rel,
           "check_param_norm_rel": norm_rel,
           "check_param_max_rel": max_rel,
           "resume_steps": [first.state.step, resumed.state.step],
           "resume_param_max_rel": resume_rel,
           "resume_loss_max_rel": resume_loss_rel}
    emit(out)
    if n != TRAIN_STEPS * TRAIN_EPOCHS or not all(map(math.isfinite,
                                                      losses)):
        raise AssertionError(f"training ran {n} steps, losses {losses}")
    if out["checkpoints"] != ["model_1.pt", "state_latest.pt"]:
        raise AssertionError(f"checkpoints {out['checkpoints']}")
    if not (loss_rel <= 1e-5 and norm_rel <= 2e-4 and max_rel <= 2e-4):
        raise AssertionError("training on the card disagrees with the CPU: "
                             f"loss {loss_rel}, parameters {norm_rel} "
                             f"(norm), {max_rel} (max)")
    if out["resume_steps"] != [2, 4] or not (resume_rel <= 1e-6
                                             and resume_loss_rel <= 1e-6):
        raise AssertionError(f"the resumed run differs from the straight "
                             f"one: {resume_rel}, {resume_loss_rel}")
    return counts


def phase_native_gather(torch):
    """The training input pipeline's native gather
    (``data/native_loader.py``, built by g++ from ``csrc/gather_scale.cpp``)
    on a train batch's rows: TRAIN_BATCH x TRAIN_T windows of 128x128
    uint8 states, row i holding TRAIN_T - i % 4 states and pads (-1)
    after them, as ``train_batches`` masks them. Bit-exact against its
    numpy twin; the host ms of each (median of GATHER_REPEATS)."""
    import numpy as np

    from dt4image_restoration_tpu_torch.data import native_loader
    t0 = time.perf_counter()
    available = native_loader.native_available()
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    src = rng.integers(0, 256, (GATHER_IMAGES, 128 * 128)).astype(np.uint8)
    b, t = TRAIN_BATCH, TRAIN_T
    rows = rng.integers(0, GATHER_IMAGES, (b, t))
    rows[np.arange(t)[None, :] >= (t - np.arange(b) % 4)[:, None]] = -1
    flat = rows.reshape(-1)

    def median_ms(fn):
        times = []
        for _ in range(GATHER_REPEATS):
            t0 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t0))
        return float(np.median(times))

    got = native_loader.gather_scale_u8(src, rows)
    twin = native_loader._gather_numpy(src, flat).reshape(got.shape)
    out = {"phase": "native_gather", "nvidia_smi": nvidia_smi(),
           "host_cpus": os.cpu_count(), "native_available": available,
           "build_s": build_s, "rows": [b, t],
           "pads": int((rows < 0).sum()),
           "bit_exact": bool(np.array_equal(got.view(np.uint32),
                                            twin.view(np.uint32))),
           "threads": native_loader.default_threads(),
           "native_ms": median_ms(
               lambda: native_loader.gather_scale_u8(src, rows)),
           "native_1_thread_ms": median_ms(
               lambda: native_loader.gather_scale_u8(src, rows, 1)),
           "numpy_ms": median_ms(
               lambda: native_loader._gather_numpy(src, flat))}
    emit(out)
    if not (available and out["bit_exact"]):
        raise AssertionError(f"native gather: available {available}, "
                             f"bit-exact {out['bit_exact']}")


def tp_rank(rank, port, device, out_path):
    """One of the train_tp phase's two ranks, both on ``device``: join a
    Gloo group of two at ``port``, shard the published DT over a mesh of
    data 1 x model 2, take 3 updates of ``train_batches(TP_BATCHES)``
    (dropout off, warmup 2) and gather the weights; then time
    TP_TIMED_STEPS more steps after TP_WARMUP_STEPS. Rank 0 writes the
    results to ``out_path``, with the times at which it reached this
    function, had joined the group and built the mesh, and had made its
    first 3 updates."""
    entered = time.time()
    import torch
    import torch.distributed as dist

    from dt4image_restoration_tpu_torch.config import TrainerConfig
    from dt4image_restoration_tpu_torch.ops import kernels
    from dt4image_restoration_tpu_torch.training import (
        gather_params, init_train_state, make_mesh, make_train_step,
        shard_batch, shard_params)
    from dt4image_restoration_tpu_torch.utils.device import resolve_device
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=2, rank=rank)
    try:
        dev = resolve_device(device)
        mesh = make_mesh(n_data=1, n_model=2, devices=[dev])
        joined = time.time()
        batches = train_batches(TP_BATCHES)
        model = shard_params(
            _train_model(torch, dev, dropout=0.0, embd_dropout=0.0), mesh,
            tensor_parallel=True)
        state = init_train_state(model, TrainerConfig(warmup_steps=2), 100)
        step = make_train_step(mesh=mesh)
        kernels.reset_launch_counts()
        losses = [float(step(state, shard_batch(b, dev)))
                  for b in batches[:3]]
        first_steps = time.time()
        weights = {k: v.detach().cpu().clone()
                   for k, v in gather_params(model).items()}
        shards = {n: tuple(p.shape) for n, p in model.named_parameters()
                  if p.shape != weights[n].shape}
        wall = _timed_steps(torch, step, state,
                            [shard_batch(b, dev) for b in batches])
        if rank == 0:
            torch.save({"losses": losses, "weights": weights,
                        "shards": shards, "steps_per_s":
                            TP_TIMED_STEPS / wall,
                        "launches": kernels.launch_counts(),
                        "entered": entered, "joined": joined,
                        "first_steps": first_steps},
                       out_path)
    finally:
        dist.destroy_process_group()


def _timed_steps(torch, step, state, batches):
    """Seconds of TP_TIMED_STEPS train steps over ``batches`` in turn,
    after TP_WARMUP_STEPS, to the device's end."""
    dev = next(state.model.parameters()).device
    for b in batches[:TP_WARMUP_STEPS]:
        step(state, b)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    for i in range(TP_TIMED_STEPS):
        step(state, batches[i % len(batches)])
    sync()
    return time.perf_counter() - t0


def spawn_ranks(target, n, args, what, join_s=None):
    """Run ``target(rank, port, *args)`` in ``n`` spawned processes; the
    seconds from the spawn to the last join. A rank that fails or outlives
    ``join_s`` (default SPAWN_JOIN_S) fails the run, and is killed."""
    join_s = SPAWN_JOIN_S if join_s is None else join_s
    import multiprocessing
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, port) + tuple(args))
             for r in range(n)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout=max(1.0, join_s - (time.perf_counter() - t0)))
    finally:
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join(10)
    if alive or any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"{what} ranks: exit codes "
                             f"{[p.exitcode for p in procs]}, killed "
                             f"{len(alive)} still running after "
                             f"{join_s} s")
    return time.perf_counter() - t0


def phase_train_tp(torch, dev, tmp):
    """Training over a model axis on the one card: two Gloo ranks sharing
    it (``tp_rank``), the published DT at B=48 over a mesh of data 1 x
    model 2; their 3 updates against the one-process step on the card in
    the training band, then their steps/s beside the one-process step's,
    timed in the same way here. Returns the ranks' kernel launches."""
    from dt4image_restoration_tpu_torch.config import TrainerConfig
    from dt4image_restoration_tpu_torch.training import (init_train_state,
                                                         make_train_step,
                                                         shard_batch)
    out_path = os.path.join(tmp, "tp_rank0.pt")
    t_spawn = time.time()
    spawn_s = spawn_ranks(tp_rank, 2, (str(dev), out_path), "train_tp")
    tp = torch.load(out_path, weights_only=False)
    batches = train_batches(TP_BATCHES)

    model = _train_model(torch, dev, dropout=0.0, embd_dropout=0.0)
    state = init_train_state(model, TrainerConfig(warmup_steps=2), 100)
    step = make_train_step()
    losses = [float(step(state, shard_batch(b, dev))) for b in batches[:3]]
    ref = {k: p.detach().cpu().clone() for k, p in model.named_parameters()}
    one_rate = TP_TIMED_STEPS / _timed_steps(
        torch, step, state, [shard_batch(b, dev) for b in batches])

    errs = _leaf_errors(tp["weights"], ref)
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(tp["losses"],
                                                        losses))
    out = {"phase": "train_tp", "nvidia_smi": nvidia_smi(),
           "mesh": {"data": 1, "model": 2}, "ranks_on_one_card": 2,
           "batch": TRAIN_BATCH, "spawn_s": spawn_s,
           "rank_start_s": tp["entered"] - t_spawn,
           "rank_joined_s": tp["joined"] - t_spawn,
           "rank_first_updates_s": tp["first_steps"] - t_spawn,
           "check_loss_tp": tp["losses"], "check_loss_one": losses,
           "check_loss_max_rel": loss_rel,
           "check_param_norm_rel": max(e[0] for e in errs.values()),
           "check_param_max_rel": max(e[1] for e in errs.values()),
           "check_param_worst": max(errs, key=lambda k: errs[k][0]),
           "sharded": tp["shards"],
           "tp_steps_per_s": tp["steps_per_s"],
           "one_process_steps_per_s": one_rate,
           "timed_steps": TP_TIMED_STEPS, "launches": tp["launches"],
           "wall_s": time.time() - t_spawn}
    emit(out)
    if not tp["shards"]:
        raise AssertionError("the TP ranks held no parameter shards")
    if not (loss_rel <= 1e-5 and out["check_param_norm_rel"] <= 2e-4):
        raise AssertionError(
            f"TP training disagrees with the one-process step: loss "
            f"{loss_rel}, parameters {out['check_param_norm_rel']} (norm)")
    return tp["launches"]


def phase_dryrun(torch):
    """``tools/dryrun_multichip.py``: the multichip dry run as 4 ranks
    sharing the card (a mesh of data 2 x model 2): the TP train step, the
    sharded greedy evaluation and the device search. Returns the paths
    dryrun_train, dryrun_eval and dryrun_mcts, each the sum of the ranks'
    launches over that stage."""
    from dt4image_restoration_tpu_torch.tools.dryrun_multichip import (
        dryrun_multichip)
    t0 = time.perf_counter()
    ranks = dryrun_multichip(DRYRUN_RANKS, "cuda", join_s=SPAWN_JOIN_S)
    wall = time.perf_counter() - t0
    paths = {f"dryrun_{stage}": {k: sum(r[stage]["launches"][k]
                                        for r in ranks)
                                 for k in ranks[0][stage]["launches"]}
             for stage in ("train", "eval", "mcts")}
    emit({"phase": "dryrun", "nvidia_smi": nvidia_smi(),
          "ranks": DRYRUN_RANKS, "mesh": ranks[0]["mesh"], "wall_s": wall,
          "loss": [r["train"]["loss"] for r in ranks],
          "eval_reward": ranks[0]["eval"]["reward"],
          "mcts_reward": ranks[0]["mcts"]["reward"], "paths": paths})
    return paths


def phase_validate_parity(torch, dev, tmp, kernels):
    """The parity harness's ``--selftest`` with the port on ``dev``: eval
    and flex, then the search, each from launch counts of zero. Returns the
    paths validate_parity_eval and validate_parity_mcts. A failing row
    fails the run."""
    from dt4image_restoration_tpu_torch.tools import validate_parity
    runs = {
        "validate_parity_eval": [
            "--modes", "eval", "flex", "--limit", str(PARITY_EVAL_SLICES),
            "--flex_rtgs", str(PARITY_FLEX_RTG)],
        "validate_parity_mcts": [
            "--modes", "mcts", "--limit", str(PARITY_MCTS_SLICES),
            "--iterations", str(PARITY_ITERATIONS)]}
    paths, rows, printed = {}, [], io.StringIO()
    for path, argv in runs.items():
        report = os.path.join(tmp, f"{path}.json")
        kernels.reset_launch_counts()
        with contextlib.redirect_stdout(printed):
            rc = validate_parity.main(
                ["--selftest", "--device", str(dev), "--max_timesteps", "30",
                 "--json_out", report] + argv)
        paths[path] = kernels.launch_counts()
        with open(report) as f:
            rows += json.load(f)["rows"]
        if rc != 0:
            print(printed.getvalue(), file=sys.stderr)
            raise AssertionError(f"{path}: a row failed: {rows}")
    emit({"phase": "validate_parity", "nvidia_smi": nvidia_smi(),
          "rows": [{k: v for k, v in r.items() if k != "dir"}
                   for r in rows], "paths": paths})
    return paths


def phase_trace(torch, dev, ckpt_dir, tmp, dirs):
    """One train step (B=48), one ADMM iteration at B=63 and at B=1 and one
    served policy batch (B=16) under ``torch.profiler``, each region
    synchronised at both ends and run once untraced first; then round 1
    (the second round) of a search of 16 trees on each backend, each
    backend in a trace of its own."""
    from dt4image_restoration_tpu_torch.config import TrainerConfig
    from dt4image_restoration_tpu_torch.data import make_mat_record
    from dt4image_restoration_tpu_torch.env import admm_step, reset_from_mat
    from dt4image_restoration_tpu_torch.training import (init_train_state,
                                                         make_train_step,
                                                         shard_batch)
    from dt4image_restoration_tpu_torch.utils.loaders import load_denoiser
    from dt4image_restoration_tpu_torch.config import MCTSConfig
    from dt4image_restoration_tpu_torch.utils.profiling import (
        SEARCH_ROUND, TRACE_FILE, annotate, region_breakdown,
        trace_if_enabled)

    tcfg = TrainerConfig()
    state = init_train_state(_train_model(torch, dev), tcfg, 100)
    step = make_train_step()
    batch = shard_batch(train_batches(1, seed=5)[0], dev)
    den = load_denoiser(os.path.join(ckpt_dir, "unet-nm.pt"), device=dev)
    rec = make_mat_record(size=128, acceleration=4, noise_sigma=15.0, seed=0)
    one = reset_from_mat(rec, device=dev)
    many = reset_from_mat({k: v.repeat(EVAL_BATCH, axis=0)
                           for k, v in rec.items()}, device=dev)
    action = {"T": 0.0, "mu": MU, "sigma_d": SIGMA_D}
    svc = _service(torch, dev, ckpt_dir, "policy", batch_size=SERVE_BATCH)
    reqs = serve_requests(SERVE_BATCH)
    regions = {f"train_step B={TRAIN_BATCH}": lambda: step(state, batch),
               f"admm B={EVAL_BATCH}": lambda: admm_step(den, many, action),
               "admm B=1": lambda: admm_step(den, one, action),
               f"serve policy batch B={SERVE_BATCH}":
                   lambda: svc.restore(reqs, timeout=600)}
    try:
        for fn in regions.values():
            fn()
        trace_dir = os.path.join(tmp, "trace")
        with trace_if_enabled(trace_dir):
            for name, fn in regions.items():
                torch.cuda.synchronize()
                with annotate(name):
                    fn()
                    torch.cuda.synchronize()
    finally:
        svc.close(timeout=600)
    with open(os.path.join(trace_dir, TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    out = {"phase": "trace", "nvidia_smi": nvidia_smi(),
           "regions": {name: region_breakdown(events, name)
                       for name in regions}}

    # Round 1 of a 2-round search of 16 trees, on each backend.
    records, seeds = search_records(dirs)
    printed = io.StringIO()
    for backend in ("host", "device"):
        mcts = _search(torch, dev, ckpt_dir, MCTSConfig(iterations=2),
                       backend=backend)
        search_dir = os.path.join(tmp, f"trace_search_{backend}")
        with contextlib.redirect_stdout(printed):
            mcts.run_batch(records, seeds=seeds)
            with trace_if_enabled(search_dir):
                mcts.run_batch(records, seeds=seeds)
                torch.cuda.synchronize()
        with open(os.path.join(search_dir, TRACE_FILE)) as f:
            events = json.load(f)["traceEvents"]
        out["regions"][f"search round 1, {SEARCH_BATCH} trees, "
                       f"{backend} backend"] = region_breakdown(
                           events, SEARCH_ROUND.format(1))
    emit(out)
    idle = [n for n, r in out["regions"].items() if r["device_ms"] <= 0]
    if idle:
        raise AssertionError(f"no device work traced in {idle}")
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 2
    try:
        from dt4image_restoration_tpu_torch.ops import kernels
        from dt4image_restoration_tpu_torch.ops.kernels import _build
        from dt4image_restoration_tpu_torch.utils.device import (
            resolve_device)
    except ImportError as e:
        print(f"chip_smoke: the port package is not importable ({e}); run "
              "from the root of a checkout", file=sys.stderr)
        return 2

    dev = resolve_device("cuda")
    t_start = time.perf_counter()
    phase_device(torch, _build)
    rows = phase_kernels(torch, dev)
    phase_per_op_forward(torch, dev)

    paths = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        ckpt_dir = os.path.join(tmp, "checkpoints")   # empty: random weights
        dirs = eval_dirs(os.path.join(tmp, "data"))
        kernels.reset_launch_counts()
        phase_rollout(torch, dev, ckpt_dir)
        paths["rollout"] = kernels.launch_counts()
        rollout_repeats(torch, dev, ckpt_dir)
        kernels.reset_launch_counts()
        f32_eval = phase_eval(torch, dev, ckpt_dir, dirs)
        paths["eval"] = kernels.launch_counts()
        kernels.reset_launch_counts()
        phase_eval_bf16(torch, dev, ckpt_dir, dirs, f32_eval)
        paths["eval_bf16"] = kernels.launch_counts()
        kernels.reset_launch_counts()
        phase_eval_restormer(torch, dev, ckpt_dir, dirs)
        paths["eval_restormer"] = kernels.launch_counts()
        paths["record"] = phase_record(torch, dev, ckpt_dir, kernels)
        paths.update(phase_mcts(torch, dev, ckpt_dir, dirs, kernels))
        paths.update(phase_mesh(torch, dev, ckpt_dir, dirs, tmp, kernels))
        paths["mcts_bf16"] = phase_mcts_bf16(torch, dev, ckpt_dir, dirs,
                                             kernels)
        phase_unet_modes(torch, dev)
        paths.update(phase_bench(torch, dev))
        phase_arniqa(torch, dev, dirs)
        paths.update(phase_serve(torch, dev, ckpt_dir, kernels))
        paths["train"] = phase_train(torch, dev, tmp, kernels)
        phase_native_gather(torch)
        paths["train_tp"] = phase_train_tp(torch, dev, tmp)
        paths.update(phase_dryrun(torch))
        paths.update(phase_validate_parity(torch, dev, tmp, kernels))
        phase_trace(torch, dev, ckpt_dir, tmp, dirs)
    emit({"phase": "launches", "paths": paths})
    # Training runs no U-Net: none of the kernels, K6 included.
    for path in ("train", "train_tp", "dryrun_train"):
        if any(paths[path].values()):
            raise AssertionError(f"the {path} path launched kernels: "
                                 f"{paths[path]}")
    # Every path that runs the U-Net runs K6 at its decoder.
    unet = ("conv_block", "kspace", "upsample_concat")
    unet16 = ("conv_block_bf16",) + unet[1:]
    search = unet + ("attention", "layernorm")
    search16 = unet16 + ("attention", "layernorm")
    for path, want in (("rollout", unet),
                       ("eval", unet + ("dt_decode",)),
                       ("eval_bf16", unet16 + ("dt_decode",)),
                       ("eval_restormer", ("kspace", "dt_decode",
                                           "mdta_gram")),
                       ("record", unet),
                       ("mcts", search), ("mcts_device", search),
                       ("mcts_expand", search),
                       ("mcts_bf16", search16),
                       ("serve_policy", unet + ("dt_decode",)),
                       ("serve_fixed", unet),
                       ("serve_mcts", search),
                       ("mesh_one", unet + ("dt_decode",)),
                       ("mesh_eval", unet + ("dt_decode",)),
                       ("mesh_ranks_eval", unet + ("dt_decode",)),
                       ("mesh_ranks_search", search),
                       ("mesh_search", search),
                       ("mesh_serve_policy", unet + ("dt_decode",)),
                       ("mesh_serve_fixed", unet),
                       ("dryrun_eval", unet + ("dt_decode",)),
                       ("dryrun_mcts", search),
                       ("validate_parity_eval", unet + ("dt_decode",)),
                       ("validate_parity_mcts", search),
                       ("bench", unet),
                       ("bench_bf16", unet16)):
        missing = [k for k in want if paths[path][k] <= 0]
        if missing:
            raise AssertionError(f"the {path} path launched no {missing}")
    # Each dtype runs its own K1 and never the other's.
    mixed = [p for p, c in paths.items()
             if c["conv_block" if p.endswith("_bf16")
                  else "conv_block_bf16"] > 0]
    if mixed:
        raise AssertionError(f"paths that ran the other dtype's K1: {mixed}")

    summary = []
    for name in kernels.KERNEL_MODULES:
        mine = [r for r in rows if r["kernel"] == name
                and r["shape"] in SUMMARY_SHAPES[name]]
        calls = [r["call_ms"] for r in mine if r["call_ms"] is not None]
        summary.append({
            "name": name, "route": "cuda",
            "source": f"dt4image_restoration_tpu_torch/csrc/{name}.cu",
            "replaces": REPLACES[name],
            "launches": sum(p[name] for p in paths.values()),
            "max_abs_err": max(r["max_abs_err"] for r in rows
                               if r["kernel"] == name),
            "ms": sum(r["kernel_ms"] for r in mine),
            "call_ms": sum(calls) if calls else None,
            "plain_ms": sum(r["plain_ms"] for r in mine),
            "bound_ms": sum(r["bound_ms"] for r in mine),
            "bound_by": mine[0]["bound_by"].split()[0],
            "library_ms": None if mine[0]["library_ms"] is None
            else sum(r["library_ms"] for r in mine),
            "shapes": [r["shape"] for r in mine]})
    emit({"phase": "done", "wall_s": time.perf_counter() - t_start})
    zero = [k["name"] for k in summary if k["launches"] <= 0]
    if zero:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{zero}")
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
