#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. It builds the port's CUDA kernels from the
sources in the checkout, holds each kernel against its plain PyTorch
version at the shapes of the evaluation path, drives that path once through
the user entry points at the published model widths (30-iteration
fixed-parameter PnP-ADMM on one 128x128 slice; greedy Decision Transformer
evaluation of 63 slices, 7 from each of 9 synthetic eval directories) with
random weights from fixed seeds, checks the results against CPU runs of the
same code, and prints one JSON line per phase. The line before the last is
the kernel summary; the last line is the device summary. Any failure ends
the run with a traceback and a non-zero exit code.

It imports nothing of JAX or of the JAX package, and exits non-zero
without a result when CUDA is unavailable or the port is not beside it.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

MU, SIGMA_D = 0.5, 15.0 / 255.0       # the fixed-parameter rollout's action
EVAL_BATCH = 63                        # 9 directories x 7 images
H100_F32_FLOPS = 67e12                 # float32 outside the tensor cores
H100_BYTES_PER_S = 3.35e12             # HBM3
REPLACES = {
    "conv_block": "dt4image_restoration_tpu/ops/pallas/conv_block.py:134",
    "kspace": "dt4image_restoration_tpu/ops/pallas/kspace.py:37",
    "dt_decode": "dt4image_restoration_tpu/ops/pallas/transformer.py:122",
}
TOLERANCE = {"conv_block": 1e-4, "kspace": 1e-6, "dt_decode": 1e-4}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound(flops: float, nbytes: float):
    """Least time on the H100 (ms) for ``flops`` float32 operations and
    ``nbytes`` of compulsory traffic, and which of the two bounds it."""
    t_ops, t_bytes = flops / H100_F32_FLOPS, nbytes / H100_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


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


def max_errors(got, ref):
    diff = (got - ref).abs()
    abs_err = float(diff.max())
    rel_err = float((diff / ref.abs().clamp_min(1e-6)).max())
    return abs_err, rel_err


def phase_device(torch, kernels_build):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    build_s = kernels_build.build()
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in kernels_build.build_logs.items()}
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": build_s, "ptxas": ptxas})


def phase_kernels(torch, dev):
    """Each kernel against its plain version (and a library call where one
    computes the same function) at the evaluation path's shapes."""
    import torch.nn.functional as F

    from dt4image_restoration_tpu_torch.config import ModelConfig
    from dt4image_restoration_tpu_torch.models import (
        DecisionTransformer, UNetDenoiser, init_dt_params,
        random_unet_state_dict)
    from dt4image_restoration_tpu_torch.ops.csmri import kspace_consistency
    from dt4image_restoration_tpu_torch.ops.kernels import conv_block as k1
    from dt4image_restoration_tpu_torch.ops.kernels import kspace as k2
    from dt4image_restoration_tpu_torch.ops.kernels import transformer as k3

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
               nbytes):
        abs_err, rel_err = max_errors(got, ref)
        bound_ms, bound_by = bound(flops, nbytes)
        row = {"phase": "kernel", "kernel": kernel, "shape": shape,
               "max_abs_err": abs_err, "max_rel_err": rel_err,
               "tolerance": TOLERANCE[kernel], "kernel_ms": ms,
               "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "flops": flops, "bytes": nbytes}
        emit(row)
        if not abs_err <= TOLERANCE[kernel]:
            raise AssertionError(f"{kernel} {shape}: max abs error {abs_err} "
                                 f"over {TOLERANCE[kernel]}")
        rows.append(row)

    # K1 at the U-Net's two full-resolution blocks.
    for name, block, cin in (("inc", unet.net.inc, 2),
                             ("up4", unet.net.up4, 96)):
        packed = block.packed()
        for b in (1, EVAL_BATCH):
            x = torch.rand((b, cin, 128, 128), generator=gen, device=dev)
            got = k1.conv_block(x, packed)
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
                   time_ms(torch, library, iters), flops, nbytes)

    # K2 on the k-space of 128x128 slices.
    for b in (1, EVAL_BATCH):
        shape = (b, 1, 128, 128)
        z = torch.complex(torch.randn(shape, generator=gen, device=dev),
                          torch.randn(shape, generator=gen, device=dev)) * 30
        y0 = torch.complex(torch.randn(shape, generator=gen, device=dev),
                           torch.randn(shape, generator=gen, device=dev)) * 30
        mask = torch.rand(shape, generator=gen, device=dev) < 0.3
        mu = torch.rand((b,), generator=gen, device=dev) + 0.1
        mu4 = mu.view(b, 1, 1, 1)
        args = (z, y0, mask, mu)
        got = torch.view_as_real(k2.kspace_consistency_kernel(*args))
        ref = torch.view_as_real(kspace_consistency(*args))
        n = b * 128 * 128
        record("kspace", f"B={b}", got, ref,
               time_ms(torch, lambda: k2.kspace_consistency_kernel(*args),
                       200),
               time_ms(torch, lambda: kspace_consistency(*args), 200),
               time_ms(torch, lambda: torch.where(
                   mask, (mu4 * z + y0) / (1 + mu4), z), 200),
               6.0 * int(mask.sum()), 25.0 * n + 4 * b)

    # K3 on the policy's token batches: two-token (T=12) and three-token
    # (T=18) forwards of 63 sequences.
    packed = dt.packed_weights()
    e, nb = cfg.embed_dim, cfg.n_blocks
    w_bytes = 4.0 * sum(v.numel() for v in packed.values())
    for t in (12, 18):
        tokens = torch.randn((EVAL_BATCH, t, e), generator=gen, device=dev)
        got = k3.fused_dt_decode(tokens, packed, nb, cfg.n_heads)
        ref = k3.fused_dt_decode_plain(tokens, packed, nb, cfg.n_heads)
        # Per block: 24 T E^2 for the four projections, 2 E T(T+1) for the
        # causal scores and the weighted values.
        flops = EVAL_BATCH * nb * (24.0 * t * e * e + 2.0 * e * t * (t + 1))
        record("dt_decode", f"B={EVAL_BATCH} T={t}", got, ref,
               time_ms(torch, lambda: k3.fused_dt_decode(
                   tokens, packed, nb, cfg.n_heads), 100),
               time_ms(torch, lambda: k3.fused_dt_decode_plain(
                   tokens, packed, nb, cfg.n_heads), 100),
               None, flops, 8.0 * tokens.numel() + w_bytes)
    return rows


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


def phase_eval(torch, dev, ckpt_dir, data_root):
    """Greedy evaluation of 9 directories x 7 slices at the published
    widths, and a CPU cross-check of two of the slices."""
    from dt4image_restoration_tpu_torch.config import (EVAL_DIR_TOKENS,
                                                       ModelConfig)
    from dt4image_restoration_tpu_torch.data import (EvaluationDataset,
                                                     write_eval_dir)
    from dt4image_restoration_tpu_torch.inference import Evaluator
    from dt4image_restoration_tpu_torch.utils.loaders import load_denoiser

    dirs = [write_eval_dir(os.path.join(data_root, tok), tok, n=7,
                           seed=1000 * i)
            for i, tok in enumerate(EVAL_DIR_TOKENS)]
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

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        ckpt_dir = os.path.join(tmp, "checkpoints")   # empty: random weights
        kernels.reset_launch_counts()
        phase_rollout(torch, dev, ckpt_dir)
        phase_eval(torch, dev, ckpt_dir, os.path.join(tmp, "data"))
        counts = kernels.launch_counts()

    summary = []
    for name in ("conv_block", "kspace", "dt_decode"):
        mine = [r for r in rows if r["kernel"] == name
                and (name != "conv_block" or r["shape"].endswith(
                    f"B={EVAL_BATCH}"))
                and (name != "kspace" or r["shape"] == f"B={EVAL_BATCH}")]
        summary.append({
            "name": name, "route": "cuda",
            "source": f"dt4image_restoration_tpu_torch/csrc/{name}.cu",
            "replaces": REPLACES[name], "launches": counts[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows
                               if r["kernel"] == name),
            "ms": sum(r["kernel_ms"] for r in mine),
            "plain_ms": sum(r["plain_ms"] for r in mine),
            "bound_ms": sum(r["bound_ms"] for r in mine),
            "bound_by": mine[0]["bound_by"],
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
