"""Where one DRUNet forward's device time goes, on a CUDA card.

    python3 -m dt4image_restoration_tpu_torch.perf.drunet_parts \\
        [--batch 63] [--dtype bfloat16]

At the published widths on 128^2 slices, with random weights from seed 0,
it prints JSON lines:

  * ``forward``: device ms of one ``DRUNetDenoiser`` call, eager, between
    CUDA events, and of the same network on NCHW tensors (the layout the
    U-Net uses: ``utils/torch_reference.py:torch_drunet_forward`` on the
    weights and input in the compute dtype), each with the share of
    cuDNN's NCHW<->NHWC transforms in its profiled device time;
  * ``kernels``: the device ops of one profiled channels-last forward,
    summed by name, with their counts.

Without a card it exits 2.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

SIDE = 128
ITERS = 20
TRANSFORMS = ("nchwToNhwc", "nhwcToNchw")


def _ms(fn, iters: int = ITERS) -> float:
    """Device ms per ``fn`` call between CUDA events, after 3 warm-ups."""
    for _ in range(3):
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


def _kernels(fn):
    """{name: [device ms, count]} of the device ops of one ``fn`` call."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops = {}
    for e in prof.events():
        t = getattr(e, "device_time_total", 0.0) or 0.0
        if e.device_type == torch.autograd.DeviceType.CUDA and t > 0:
            ms, n = ops.get(e.name, (0.0, 0))
            ops[e.name] = (ms + t / 1e3, n + 1)
    return dict(sorted(ops.items(), key=lambda kv: -kv[1][0]))


def _transform_share(ops) -> float:
    total = sum(ms for ms, _ in ops.values())
    part = sum(ms for name, (ms, _) in ops.items()
               if any(t in name for t in TRANSFORMS))
    return part / total if total > 0 else float("nan")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="drunet_parts")
    p.add_argument("--batch", type=int, default=63)
    p.add_argument("--dtype", default="bfloat16",
                   choices=["float32", "bfloat16"])
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("drunet_parts: needs a CUDA card", file=sys.stderr)
        return 2
    from dt4image_restoration_tpu_torch.models.drunet import (
        DRUNetDenoiser, random_drunet_state_dict)
    from dt4image_restoration_tpu_torch.utils.torch_reference import \
        torch_drunet_forward
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    dt = getattr(torch, args.dtype)
    b = args.batch
    print(json.dumps({"device": torch.cuda.get_device_name(dev),
                      "torch": torch.__version__, "batch": b,
                      "dtype": args.dtype}), flush=True)

    gen = torch.Generator(device=dev).manual_seed(0)
    den = DRUNetDenoiser(dtype=args.dtype).to(dev)
    den.load_state_dict(random_drunet_state_dict(0))
    den.eval().requires_grad_(False)
    img = torch.rand(b, 1, SIDE, SIDE, device=dev, generator=gen)
    sigma = torch.full((b,), 0.1, device=dev)
    # The same network on NCHW tensors, as the U-Net runs: the plain
    # forward on the weights and the input in the compute dtype.
    ref_sd = {k.removeprefix("net."): v.to(dt).contiguous()
              for k, v in den.state_dict().items()}
    x0 = torch.cat([img, sigma.reshape(b, 1, 1, 1).expand(b, 1, SIDE, SIDE)],
                   dim=1).to(dt)

    def nchw_call():
        return torch.clamp(torch_drunet_forward(ref_sd, x0).float(), 0, 1)

    with torch.no_grad():
        gap = (den(img, sigma) - nchw_call()).abs().max().item()
        ops = _kernels(lambda: den(img, sigma))
        ops_nchw = _kernels(nchw_call)
        print(json.dumps({
            "forward": "channels_last", "ms": _ms(lambda: den(img, sigma)),
            "transform_share": _transform_share(ops),
            "nchw_ms": _ms(nchw_call),
            "nchw_transform_share": _transform_share(ops_nchw),
            "gap_to_nchw": gap}), flush=True)
    print(json.dumps({"kernels": [[name, round(ms, 4), n] for name, (ms, n)
                                  in ops.items()]}), flush=True)
    print(json.dumps({"kernels_nchw": [[name, round(ms, 4), n]
                                       for name, (ms, n) in
                                       list(ops_nchw.items())[:12]]}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
