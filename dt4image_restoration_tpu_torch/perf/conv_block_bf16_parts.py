"""Break the bfloat16 K1's time down into its parts on a CUDA card.

    python3 -m dt4image_restoration_tpu_torch.perf.conv_block_bf16_parts

``csrc/conv_block_bf16.cu`` guards parts of its work with ``STRIP_``
macros, off in the port's build. This script builds the kernel once as it
is and once with each macro defined (one ``nvcc`` each, started together),
and times every build at the U-Net's two full-resolution ConvBlocks (inc
B x 2 x 128^2 -> 32 and up4 B x 96 x 128^2 -> 32, 3 layers, random weights
from seed 0) with CUDA events. The builds take turns, ``--rounds`` times,
and each time is the median over the rounds. A part's cost is the time it
saves when stripped. It prints the card's name and power limit, then one
JSON line per build and block, with the kernel's error against its plain
version for the build that strips nothing.
"""
from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess

BLOCKS = (("inc", 2), ("up4", 96))


def strip_macros(source: str):
    """The ``STRIP_`` macros a kernel source tests, in order of first use."""
    return list(dict.fromkeys(re.findall(r"#ifn?def (STRIP_\w+)", source)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=63)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()

    import torch

    from dt4image_restoration_tpu_torch.models import (UNetDenoiser,
                                                       random_unet_state_dict)
    from dt4image_restoration_tpu_torch.ops.kernels import _build
    from dt4image_restoration_tpu_torch.ops.kernels import conv_block_bf16 as k

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    macros = strip_macros((_build.CSRC_DIR / "conv_block_bf16.cu")
                          .read_text())
    builds = [()] + [(m,) for m in macros]
    build_s = _build.build([("conv_block_bf16", d) for d in builds])

    dev = torch.device("cuda")
    unet = UNetDenoiser(dtype="bfloat16").eval().requires_grad_(False)
    unet.load_state_dict(random_unet_state_dict(0))
    unet.to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    for name, cin in BLOCKS:
        packed = getattr(unet.net, name).packed_weights()
        x = torch.rand((args.batch, cin, 128, 128), generator=gen,
                       device=dev).to(torch.bfloat16)
        ref = k.conv_block_bf16_plain(x, packed).float()
        err = float((k.run_build(x, packed).float() - ref).abs().max())
        times = {d: [] for d in builds}
        for _ in range(args.rounds):
            for d in builds:
                fn = (lambda d=d: k.run_build(x, packed, defines=d))
                for _ in range(3):
                    fn()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(args.iters):
                    fn()
                end.record()
                end.synchronize()
                times[d].append(start.elapsed_time(end) / args.iters)
        base = statistics.median(times[()])
        for d in builds:
            ms = statistics.median(times[d])
            print(json.dumps({
                "block": f"{name} B={args.batch}", "strip": list(d),
                "ms": ms, "ms_rounds": times[d], "saved_ms": base - ms,
                "saved_share": (base - ms) / base,
                "max_abs_err": err if d == () else None,
                "nvidia_smi": smi, "build_s": build_s}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
