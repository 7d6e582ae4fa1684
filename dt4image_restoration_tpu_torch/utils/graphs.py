"""CUDA graph capture, shared by the evaluator's policy step
(``inference/evaluator.py:PolicyGraphs``) and the priors' forward
(``models/prior_graphs.py:PriorGraphs``), and the key of a module's
weights that decides when a captured graph is stale.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, Hashable, Tuple, TypeVar

import torch

from ..ops.kernels import tally_launches

T = TypeVar("T")

# One capture at a time in the process: a capture's set-up synchronises the
# device and empties the allocator's cache, which must not fall inside
# another thread's capture on another device.
_CAPTURE_LOCK = threading.Lock()


def capture_graph(run: Callable[[], T], device: torch.device
                  ) -> Tuple["torch.cuda.CUDAGraph", Dict[str, int], T, T]:
    """Capture ``run()`` as a CUDA graph on ``device``, after one warm-up
    run on the same side stream (packed and cast weight copies, the cuBLAS
    and cuDNN handles and workspaces of that stream). The kernel wrappers'
    calls during the capture launch nothing: they are tallied, for
    :func:`..ops.kernels.add_launches` at each replay. Returns ``(graph,
    launches, the warm-up's result, the captured result)``; the current
    stream waits for both runs."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        warm = run()
    graph = torch.cuda.CUDAGraph()
    # Thread-local: the shards of a mesh drive their devices from threads.
    with _CAPTURE_LOCK, tally_launches() as launches, torch.cuda.graph(
            graph, stream=side, capture_error_mode="thread_local"):
        captured = run()
    torch.cuda.current_stream(device).wait_stream(side)
    return graph, launches, warm, captured


def weights_key(module: torch.nn.Module) -> Hashable:
    """Every parameter's address and version. A captured graph reads the
    weights, and the copies made of them (K1's and K3's packed weights,
    the bfloat16 casts, each cached under a subset of this key), by
    address, so any change must capture anew."""
    return tuple((p.data_ptr(), p._version) for p in module.parameters())
