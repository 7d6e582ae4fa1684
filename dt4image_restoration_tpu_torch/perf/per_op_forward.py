"""Time one per-op policy forward of the port on a CUDA card.

    python3 -m dt4image_restoration_tpu_torch.perf.per_op_forward
    python3 dt4image_restoration_tpu_torch/perf/per_op_forward.py \\
        --root OTHER_CHECKOUT

The forward is the per-op Decision Transformer (``ModelConfig(use_pallas=
True)``: kernels K4 and K5) at the tree search's shape: 16 sequences of 6
timesteps (18 tokens) at the published widths, over cached state
embeddings as the search runs it, with random weights from seed 0. It
prints one JSON line: the device ms of one forward from a CUDA graph of 20
forwards, the eager ms per forward, and the kernels one eager forward runs,
counted by ``torch.profiler``. ``--root`` times the port package of another
checkout (an unpacked parent commit, say) with this same code, so that two
trees are compared by one script; run the file by its path for that.
``chip_smoke.py`` prints the same line as its ``per_op_forward`` phase.
"""
from __future__ import annotations

import argparse
import json
import sys
from collections import Counter
from pathlib import Path

SEARCH_BATCH = 16   # trees per search chunk (the CLI default)
FORWARDS_PER_GRAPH = 20
EAGER_FORWARDS = 200


def graph_ms(torch, fn, launches: int = FORWARDS_PER_GRAPH,
             replays: int = 10) -> float:
    """Device ms of one ``fn`` call: ``launches`` calls captured in one
    CUDA graph, replayed ``replays`` times between CUDA events."""
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


def eager_ms(torch, fn, iters: int = EAGER_FORWARDS) -> float:
    """Ms per eager ``fn`` call between CUDA events, after 3 warm-ups."""
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


def measure(torch, dev) -> dict:
    """The forward's line, for the port package that is importable."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dt4image_restoration_tpu_torch.config import ModelConfig
    from dt4image_restoration_tpu_torch.models import (DecisionTransformer,
                                                       init_dt_params,
                                                       make_dt_apply,
                                                       make_dt_embed_apply)
    cfg = ModelConfig(use_pallas=True)
    dt = DecisionTransformer(cfg).eval().requires_grad_(False)
    dt.load_state_dict(init_dt_params(cfg, 0))
    dt.to(dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    b, ctx = SEARCH_BATCH, cfg.context_length
    args = (torch.rand((b, ctx, 1), generator=gen, device=dev),
            torch.randn((b, ctx, cfg.embed_dim), generator=gen, device=dev),
            torch.arange(ctx, device=dev).expand(b, ctx),
            torch.full((b, ctx), 2, device=dev),
            torch.rand((b, ctx, cfg.action_dim), generator=gen, device=dev))
    forward = make_dt_embed_apply(make_dt_apply(dt))

    def run():
        return forward(*args).pred_actions

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    names = Counter(e.name for e in prof.events()
                    if e.device_type == DeviceType.CUDA)
    return {"phase": "per_op_forward", "batch": b, "tokens": 3 * ctx,
            "embed_dim": cfg.embed_dim, "n_blocks": cfg.n_blocks,
            "kernels_per_forward": sum(names.values()),
            "kernels_by_name": dict(names.most_common()),
            "graph_ms": graph_ms(torch, run),
            "eager_ms": eager_ms(torch, run)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", type=Path,
                        default=Path(__file__).resolve().parents[2],
                        help="checkout whose port package is timed "
                             "(default: this one)")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(args.root.resolve()))
    import torch
    if not torch.cuda.is_available():
        print("per_op_forward: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    import dt4image_restoration_tpu_torch as port
    root = Path(port.__file__).resolve().parents[1]
    if root != args.root.resolve():
        print(f"per_op_forward: imported the port from {root}, not from "
              f"{args.root}; run this file by its path", file=sys.stderr)
        return 2
    from dt4image_restoration_tpu_torch.utils.device import resolve_device
    line = measure(torch, resolve_device("cuda"))
    line["root"] = str(args.root)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
