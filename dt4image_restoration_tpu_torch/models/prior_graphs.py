"""The plug-in prior's forward as a CUDA graph, in the evaluator's rollouts.

Both priors (``unet.py:UNetDenoiser``, ``drunet.py:DRUNetDenoiser``) have
one contract, ``(x (B, 1, H, W), sigma scalar or (B,))`` -> clamped (B, 1,
H, W), and run their forward's body through :func:`run_prior`. Inside a
:meth:`PriorGraphs.scope` opened on the calling thread, with grad off and
``x`` on CUDA, the body is a CUDA graph, one per device, captured on the
first call of a batch shape, dtype, prior and weights and replayed on every
later call: the host launches two copies in, a replay and a copy out in
place of the prior's ~70 launches. The :class:`..inference.Evaluator`
opens the scope around each shard's rollout; it holds the prior only as a
callable (which a caller may wrap), so the prior learns of the rollout from
the thread. Everywhere else the body runs eagerly: the service, whose two
in-flight batches would race on one set of static tensors; the tree
searches, whose batch shapes change every call; training; the CPU.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Callable, Dict, Hashable, Iterator, Optional

import torch
import torch.nn as nn

from ..ops.kernels import add_launches
from ..utils.graphs import capture_graph, weights_key
from ..utils.profiling import PRIOR_GRAPH, annotate

# The body of a prior's forward: (x (B, 1, H, W), sigma) -> (B, 1, H, W).
PriorBody = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

# ``open``: the graph cache of the scope the calling thread is in and the
# weights keys read in it, by prior; None outside a scope.
_scope = threading.local()


def per_image_sigma(sigma, x: torch.Tensor) -> torch.Tensor:
    """``sigma`` (a number, or a tensor of one or B values) as the (B,)
    tensor of ``x``'s dtype on its device that the forward broadcasts it
    to."""
    return torch.as_tensor(sigma, dtype=x.dtype, device=x.device) \
        .reshape(-1).expand(x.shape[0])


def graph_key(prior: nn.Module, x: torch.Tensor,
              read: Dict[nn.Module, Hashable]) -> Hashable:
    """What a captured forward depends on besides the values of its
    inputs: the batch shape and dtype of ``x``, the prior itself, and its
    weights (:func:`..utils.graphs.weights_key`), read on the prior's first
    call in a scope and kept in the scope's ``read``, as the evaluator reads
    its policy's once a rollout: a walk of the prior's parameters costs
    0.1-0.3 ms of host time, and the weights do not change under a
    rollout."""
    weights = read.get(prior)
    if weights is None:
        weights = read[prior] = weights_key(prior)
    return (tuple(x.shape), x.dtype, prior, weights)


@dataclasses.dataclass
class PriorGraph:
    """One device's captured forward: its static input, sigma and output,
    the key they were captured for, and the kernel launches of one replay
    (see ``ops/kernels/_build.py:tally_launches``)."""
    key: Hashable
    x: torch.Tensor
    sigma: torch.Tensor
    out: torch.Tensor
    graph: "torch.cuda.CUDAGraph"
    launches: Dict[str, int]


class PriorGraphs:
    """The priors' forward as a CUDA graph, one per device in ``graphs``,
    in the calls made inside :meth:`scope` (see the module's docstring). A
    call of another batch shape, dtype or prior, or whose prior's weights
    changed since the scope that captured, frees the device's graph and
    captures anew in its place. ``captures``,
    ``replays`` and ``eager_prior_calls`` (calls inside the scope that ran
    eagerly: without CUDA, or with grad on) count what it did; a call
    that captures returns the warm-up's answer and is no replay.

    A device's static tensors are shared by its calls, so they must follow
    one another on one stream, as a device's shards do in
    :func:`..training.sharding.run_sharded`."""

    def __init__(self):
        self.graphs: Dict[torch.device, PriorGraph] = {}
        self._lock = threading.Lock()
        self.captures = self.replays = self.eager_prior_calls = 0

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"captures": self.captures, "replays": self.replays,
                    "eager_prior_calls": self.eager_prior_calls}

    @contextlib.contextmanager
    def scope(self) -> Iterator["PriorGraphs"]:
        """Within, the priors' forwards on this thread run through this
        cache; the priors' weights are read once (:func:`graph_key`)."""
        outer = getattr(_scope, "open", None)
        _scope.open = (self, {})
        try:
            yield self
        finally:
            _scope.open = outer

    def run(self, prior: nn.Module, body: PriorBody, x: torch.Tensor,
            sigma, read: Dict[nn.Module, Hashable]) -> torch.Tensor:
        """``body(x, sigma)``, ``prior``'s forward, replayed from the
        device's graph, captured first where the key (:func:`graph_key`,
        with the scope's ``read``) is new; eager without CUDA or with grad
        on. The answer is a tensor of the caller's own."""
        if x.device.type != "cuda" or torch.is_grad_enabled():
            with self._lock:
                self.eager_prior_calls += 1
            return body(x, sigma)
        sigma = per_image_sigma(sigma, x)
        key = graph_key(prior, x, read)
        with self._lock:
            g = self.graphs.get(x.device)
        if g is None or g.key != key:
            g = None   # freed before the new one is allocated
            return self._capture(key, body, x, sigma)
        g.x.copy_(x)
        g.sigma.copy_(sigma)
        with annotate(PRIOR_GRAPH):
            g.graph.replay()
        add_launches(g.launches)
        with self._lock:
            self.replays += 1
        return g.out.clone()

    def _capture(self, key: Hashable, body: PriorBody, x: torch.Tensor,
                 sigma: torch.Tensor) -> torch.Tensor:
        """Capture ``body`` on static copies of ``x`` and ``sigma`` in place
        of the device's graph, which is freed first; the warm-up's
        answer."""
        dev = x.device
        with self._lock:
            self.graphs.pop(dev, None)
        static_x = x.clone(memory_format=torch.contiguous_format)
        static_sigma = sigma.clone()
        graph, launches, warm, out = capture_graph(
            lambda: body(static_x, static_sigma), dev)
        # Made on the capture's side stream, read on the caller's.
        warm.record_stream(torch.cuda.current_stream(dev))
        with self._lock:
            self.graphs[dev] = PriorGraph(key, static_x, static_sigma, out,
                                          graph, launches)
            self.captures += 1
        return warm


def current_prior_graphs() -> Optional[PriorGraphs]:
    """The graph cache of the scope the calling thread is in, if any."""
    open_ = getattr(_scope, "open", None)
    return None if open_ is None else open_[0]


def run_prior(prior: nn.Module, body: PriorBody, x: torch.Tensor, sigma
              ) -> torch.Tensor:
    """``body(x, sigma)``, ``prior``'s forward: through the graph cache of
    the scope the calling thread is in, else eagerly."""
    open_ = getattr(_scope, "open", None)
    if open_ is None:
        return body(x, sigma)
    graphs, read = open_
    return graphs.run(prior, body, x, sigma, read)
