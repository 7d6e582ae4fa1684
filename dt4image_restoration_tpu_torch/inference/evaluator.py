"""Greedy RTG-conditioned autoregressive evaluation.

Counterpart of the JAX package's ``inference/evaluator.py``: the env step
and the two DT forwards of every policy step, batched over images, run
on the device. It keeps the reference quirks the JAX package
documents, which published-checkpoint outputs depend on:

  * sliding window: ``[:ctx]`` while ``t < ctx`` else ``[t-ctx:t]``; the
    action written at slot ``t`` is visible to the RTG forward only while
    ``t < ctx``.
  * latest-index reads: action at ``min(t, ctx-1)``; RTG at ``t`` while
    ``t < ctx`` else at ``ctx-2``.
  * the initial RTG forward sees all-zero RTG and action streams.
  * the stop action ``T > 0.5`` freezes an image through the env's done
    mask; the loop ends once every image has finished.

Every policy step of the loop is :func:`static_policy_step`: it reads and
writes static tensors in place, with the step index on the device. On CUDA
the :class:`Evaluator` replays it from a CUDA graph (:class:`PolicyGraphs`),
so the host launches a few copies and a replay in place of about a hundred
small launches; the service and the tree searches run it uncaptured, on
copies of their buffers. The :class:`Evaluator`'s rollouts run the prior's
forward through a graph cache of their own too
(:class:`..models.prior_graphs.PriorGraphs`).
"""
from __future__ import annotations

import dataclasses
import functools
import threading
import time as _time
from typing import (Any, Callable, Dict, Hashable, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from ..config import ModelConfig
from ..data.datasets import EvaluationDataset
from ..env.pnp import CSMRIState, admm_step, compute_reward, get_policy_ob, \
    reset_from_mat
from ..models.decision_transformer import (DecisionTransformer,
                                           fused_forward_takes,
                                           make_dt_apply,
                                           make_dt_embed_apply,
                                           make_fused_dt_apply,
                                           make_state_encode)
from ..models.prior_graphs import PriorGraphs
from ..ops.kernels import add_launches
from ..training.sharding import (Mesh, gather_eval_outputs,
                                 local_output_offset, padded_per_process,
                                 replicate, run_sharded, shard_eval_inputs,
                                 synchronize)
from ..utils.device import resolve_device
from ..utils.graphs import capture_graph, weights_key
from ..utils.profiling import (ENV_ADMM, EVAL_PREPARE, EVAL_ROLLOUT,
                               EVAL_STEP, EVAL_SYNC, POLICY_GRAPH,
                               POLICY_STEP, annotate)

@dataclasses.dataclass
class EvalBuffers:
    """Rolling policy buffers, one row per image.

    ``state_embs`` optionally caches the state-encoder output per slot, so
    each observation is encoded once when it lands in the buffer; unfilled
    slots hold the encoding of the zero image, which is what the uncached
    forward computes for padded window positions.
    """
    states: torch.Tensor    # (B, maxT, H*W)
    actions: torch.Tensor   # (B, maxT, action_dim)
    rtg: torch.Tensor       # (B, maxT, 1)
    task: torch.Tensor      # (B,) int64
    state_embs: Optional[torch.Tensor] = None  # (B, maxT, E) or None

    def replace(self, **changes) -> "EvalBuffers":
        return dataclasses.replace(self, **changes)


def _take(buf: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``buf[b, idx[b, k]]`` for (B, K) indices -> (B, K, ...); an index
    past the end reads NaN, as the JAX package's gathers do."""
    trail = (1,) * (buf.ndim - 2)
    gather_idx = idx.clamp(max=buf.shape[1] - 1).reshape(
        idx.shape + trail).expand(idx.shape + buf.shape[2:])
    past = (idx >= buf.shape[1]).reshape(idx.shape + trail)
    return buf.gather(1, gather_idx).masked_fill(past, float("nan"))


def set_slot(buf: torch.Tensor, t: torch.Tensor, value: torch.Tensor
             ) -> torch.Tensor:
    """A copy of ``buf`` (B, maxT, ...) with ``value[b]`` at slot ``t[b]``;
    a row whose ``t`` is past the end is left as it was, as the JAX
    package's scatters drop such writes."""
    hit = torch.arange(buf.shape[1], device=buf.device)[None] == t[:, None]
    hit = hit.reshape(hit.shape + (1,) * (buf.ndim - 2))
    return torch.where(hit, value[:, None], buf)


def make_policy_step(dt_apply: Callable, cfg: ModelConfig,
                     dt_embed_apply: Optional[Callable] = None):
    """Build ``policy_step(bufs, t)``: the two DT forwards of one policy
    step on a ctx-length window. ``t`` is a scalar or a per-image (B,)
    tensor. Returns ``(action_vec (B, A), action_dict {k: (B,)},
    pred_rtg (B,), buffers with the new action written at slot t)``."""
    ctx = cfg.context_length

    def policy_step(bufs: EvalBuffers, t):
        b, dev = bufs.states.shape[0], bufs.states.device
        t = torch.as_tensor(t, dtype=torch.long, device=dev).reshape(-1)
        t = t.expand(b)
        start = torch.clamp(t - ctx, min=0)
        timesteps = start[:, None] + torch.arange(ctx, device=dev)[None]
        task = bufs.task[:, None].expand(b, ctx)
        if bufs.state_embs is not None and dt_embed_apply is not None:
            apply, state_buf = dt_embed_apply, bufs.state_embs
        else:
            apply, state_buf = dt_apply, bufs.states
        # Only the action window differs between the two forwards.
        rtg_w, state_w = _take(bufs.rtg, timesteps), _take(state_buf,
                                                           timesteps)

        def forward(actions_buf):
            return apply(rtg_w, state_w, timesteps, task,
                         _take(actions_buf, timesteps))

        out = forward(bufs.actions)
        read_idx = torch.clamp(t, max=ctx - 1)
        rows = torch.arange(b, device=dev)
        action_vec = out.pred_actions[rows, read_idx]
        action_dict = {k: v[rows, read_idx, 0]
                       for k, v in out.action_dict.items()}

        bufs = bufs.replace(actions=set_slot(bufs.actions, t, action_vec))

        out2 = forward(bufs.actions)
        rtg_idx = torch.where(t < ctx, torch.clamp(t, max=ctx - 1),
                              torch.full_like(t, ctx - 2))
        pred_rtg = out2.pred_rtg[rows, rtg_idx, 0]
        return action_vec, action_dict, pred_rtg, bufs

    return policy_step


@torch.no_grad()
def seed_buffers(cfg: ModelConfig, policy_x0: torch.Tensor,
                 rtg0: torch.Tensor, task: torch.Tensor, max_timesteps: int,
                 encode: Optional[Callable] = None) -> EvalBuffers:
    """Fresh buffers holding the first observation and RTG at slot 0; with
    ``encode`` (``(B, S) -> (B, E)``) the state-embedding cache, whose
    unfilled slots hold the zero image's encoding."""
    b, s = policy_x0.shape
    dev = policy_x0.device
    state_embs = None
    if encode is not None:
        zero_emb = encode(torch.zeros((1, s), device=dev))[0]
        state_embs = zero_emb.expand(b, max_timesteps, -1).clone()
        state_embs[:, 0] = encode(policy_x0)
    states = torch.zeros((b, max_timesteps, s), device=dev)
    states[:, 0] = policy_x0
    rtg = torch.zeros((b, max_timesteps, 1), device=dev)
    rtg[:, 0] = rtg0.reshape(b, 1)
    return EvalBuffers(
        states=states,
        actions=torch.zeros((b, max_timesteps, cfg.action_dim), device=dev),
        rtg=rtg, task=task.reshape(b).long(), state_embs=state_embs)


@torch.no_grad()
def initial_policy_setup(dt_apply: Callable, cfg: ModelConfig,
                         policy_x0: torch.Tensor, rtg0: torch.Tensor,
                         task: torch.Tensor, max_timesteps: int,
                         encode: Optional[Callable] = None
                         ) -> Tuple[EvalBuffers, torch.Tensor,
                                    Dict[str, torch.Tensor], torch.Tensor]:
    """Seed the buffers and produce the first action (a two-token forward)
    and the first RTG prediction (a three-token forward whose RTG and
    action streams are all zeros). With ``encode`` (``(B, S) -> (B, E)``)
    the buffers carry the state-embedding cache."""
    b, dev = policy_x0.shape[0], policy_x0.device
    ctx = cfg.context_length
    if max_timesteps < ctx:
        raise ValueError(
            f"max_timesteps ({max_timesteps}) must be >= the context "
            f"length ({ctx}); the policy windows are ctx-sized")

    bufs = seed_buffers(cfg, policy_x0, rtg0, task, max_timesteps, encode)

    timesteps = torch.arange(ctx, device=dev)[None].expand(b, ctx)
    task_w = bufs.task[:, None].expand(b, ctx)

    out = dt_apply(bufs.rtg[:, :ctx], bufs.states[:, :ctx], timesteps,
                   task_w, None)
    action_vec = out.pred_actions[:, 0]
    action_dict = {k: v[:, 0, 0] for k, v in out.action_dict.items()}
    bufs.actions[:, 0] = action_vec

    out2 = dt_apply(torch.zeros((b, ctx, 1), device=dev),
                    bufs.states[:, :ctx], timesteps, task_w,
                    torch.zeros((b, ctx, cfg.action_dim), device=dev))
    pred_rtg = out2.pred_rtg[:, 0, 0]
    return bufs, action_vec, action_dict, pred_rtg


def _where_rows(keep: torch.Tensor, new: torch.Tensor, old: torch.Tensor):
    return torch.where(keep.reshape((-1,) + (1,) * (new.ndim - 1)), new, old)


def _host_bool(x: torch.Tensor) -> bool:
    """``bool(x)``: a read of the device that waits for it, in its span."""
    with annotate(EVAL_SYNC):
        return bool(x)


@dataclasses.dataclass
class StaticPolicyStep:
    """The tensors one batch's policy step reads and writes in place, so
    that a CUDA graph can replay it: the rolling buffers, the action and
    RTG prediction the next ADMM step reads, and the step's inputs (the
    observation, the live mask and the step index, on the device)."""
    bufs: EvalBuffers
    action_dict: Dict[str, torch.Tensor]
    pred_rtg: torch.Tensor
    ob: torch.Tensor      # (B, H*W)
    live: torch.Tensor    # (B,) bool
    t: torch.Tensor       # (1,) int64
    step: Optional[Callable[["StaticPolicyStep"], None]] = None
    graph: Optional[Any] = None   # torch.cuda.CUDAGraph once captured
    key: Hashable = None
    # The kernel launches of one replay, by wrapper module (see
    # ``ops/kernels/_build.py:tally_launches``).
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)

    @classmethod
    def copy_of(cls, bufs: EvalBuffers, action_dict: Dict[str, torch.Tensor],
                pred_rtg: torch.Tensor, step: Callable
                ) -> "StaticPolicyStep":
        """Static tensors holding copies of a seeded batch's buffers and
        first outputs, none shared with the caller, and no image live."""
        dev = bufs.states.device
        return cls(
            bufs=bufs.replace(**{k: v.clone() for k, v in vars(bufs).items()
                                 if v is not None}),
            action_dict={k: v.clone() for k, v in action_dict.items()},
            pred_rtg=pred_rtg.clone(),
            ob=torch.zeros_like(bufs.states[:, 0]),
            live=torch.zeros(bufs.states.shape[0], dtype=torch.bool,
                             device=dev),
            t=torch.zeros(1, dtype=torch.long, device=dev), step=step)

    def load(self, bufs: EvalBuffers, action_dict: Dict[str, torch.Tensor],
             pred_rtg: torch.Tensor) -> None:
        """Copy a call's seeded buffers and first outputs in."""
        for f in dataclasses.fields(EvalBuffers):
            dst = getattr(self.bufs, f.name)
            if dst is not None:
                dst.copy_(getattr(bufs, f.name))
        for k, v in self.action_dict.items():
            v.copy_(action_dict[k])
        self.pred_rtg.copy_(pred_rtg)

    def run(self, ob: torch.Tensor, live: torch.Tensor, t: int) -> None:
        """Step ``t``: the observation and live mask copied in, the index
        set on the device (no copy from the host), the graph replayed or,
        uncaptured, the step run."""
        self.ob.copy_(ob)
        self.live.copy_(live)
        self.t.fill_(t)
        if self.graph is not None:
            self.graph.replay()
            add_launches(self.launches)
        else:
            self.step(self)


def _write_slot(buf: torch.Tensor, slot: torch.Tensor, live: torch.Tensor,
                value: torch.Tensor) -> None:
    """``buf[:, slot] = value`` in the rows where ``live``, for a
    one-element device index ``slot``: one slot is read and written."""
    old = buf.index_select(1, slot)[:, 0]
    buf.index_copy_(1, slot, _where_rows(live, value, old)[:, None])


def static_policy_step(s: StaticPolicyStep, policy_step: Callable,
                       encode: Optional[Callable], max_timesteps: int
                       ) -> None:
    """One policy step of :func:`greedy_rollout` on ``s``'s tensors, in
    place, with the step index ``s.t`` on the device and no host read, so
    that it can be captured: the observation, the RTG and (where the
    buffers carry the cache) the observation's encoding written at the
    step's slot, the two DT forwards, and their outputs merged into the
    live images' rows."""
    bufs, live = s.bufs, s.live
    slot = s.t.clamp(max=max_timesteps - 1)
    _write_slot(bufs.states, slot, live, s.ob)
    _write_slot(bufs.rtg, slot, live, s.pred_rtg[:, None])
    if bufs.state_embs is not None:
        _write_slot(bufs.state_embs, slot, live, encode(s.ob))
    _, new_dict, new_rtg, stepped = policy_step(bufs, s.t)
    bufs.actions.copy_(_where_rows(live, stepped.actions, bufs.actions))
    for k, v in s.action_dict.items():
        v.copy_(torch.where(live, new_dict[k], v))
    s.pred_rtg.copy_(torch.where(live, new_rtg, s.pred_rtg))


class PolicyGraphs:
    """The policy step of :func:`greedy_rollout` as a CUDA graph, one per
    device in ``steps``, captured on the first call of a batch shape and
    replayed on every later step; a call of another shape or with another
    key captures anew in its place. Without CUDA the same static step runs
    uncaptured. ``captures``, ``replays`` and ``eager_policy_steps`` (steps
    run uncaptured) count what it did. The :class:`Evaluator` keeps one on
    CUDA, where each call of ``evaluate_records`` is one batch shape a
    device; the service, whose batches run two at a time on worker
    threads, and the tree searches, whose batches change every call, run
    a static step of their own, uncaptured.

    A device's step tensors are shared by its calls, so they must follow
    one another on one stream, as a device's shards do in
    :func:`..training.sharding.run_sharded`."""

    def __init__(self):
        self.steps: Dict[torch.device, StaticPolicyStep] = {}
        self._lock = threading.Lock()
        self.captures = self.replays = self.eager_policy_steps = 0

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"captures": self.captures, "replays": self.replays,
                    "eager_policy_steps": self.eager_policy_steps}

    def bind(self, key: Hashable, step: Callable[[StaticPolicyStep], None],
             bufs: EvalBuffers, action_dict: Dict[str, torch.Tensor],
             pred_rtg: torch.Tensor) -> StaticPolicyStep:
        """The device's static step, with the call's seeded buffers and
        first outputs copied in; ``step`` (:func:`static_policy_step` bound
        to the call's functions) captured first, in place of the device's
        last one, where the batch shape, the encoder cache or ``key`` is
        new. ``key`` holds whatever else the step depends on (the evaluator
        passes its DT's weights)."""
        dev = bufs.states.device
        key = (tuple(bufs.states.shape), bufs.state_embs is not None, key)
        with self._lock:
            s = self.steps.pop(dev, None)
        if s is not None and s.key != key:
            s = None   # freed before the new one is allocated
        if s is None:
            s = StaticPolicyStep.copy_of(bufs, action_dict, pred_rtg, step)
            s.key = key
            if dev.type == "cuda":
                # After one warm-up run; the launches are counted at each
                # replay.
                s.graph, s.launches, _, _ = capture_graph(
                    lambda: s.step(s), dev)
                with self._lock:
                    self.captures += 1
        elif s.graph is None:   # uncaptured, it runs this call's functions
            s.step = step
        with self._lock:
            self.steps[dev] = s
        # After the capture, whose warm-up and capture write the tensors.
        s.load(bufs, action_dict, pred_rtg)
        return s

    def run(self, s: StaticPolicyStep, ob: torch.Tensor, live: torch.Tensor,
            t: int) -> None:
        """:meth:`StaticPolicyStep.run` in its span, counted."""
        with annotate(POLICY_GRAPH):
            s.run(ob, live, t)
        with self._lock:
            if s.graph is not None:
                self.replays += 1
            else:
                self.eager_policy_steps += 1


@torch.no_grad()
def greedy_rollout(dt_apply: Callable, denoise: Callable, cfg: ModelConfig,
                   env_state: CSMRIState, bufs: EvalBuffers,
                   action_dict: Dict[str, torch.Tensor],
                   pred_rtg: torch.Tensor, max_timesteps: int,
                   start_time: Any = 1,
                   encode: Optional[Callable] = None,
                   dt_embed_apply: Optional[Callable] = None,
                   policy_graphs: Optional[PolicyGraphs] = None,
                   graph_key: Hashable = None
                   ) -> Tuple[CSMRIState, torch.Tensor, torch.Tensor,
                              EvalBuffers]:
    """The greedy env/policy loop over t = 0 .. max_timesteps.

    Returns ``(final_env_state, reward (B, 1), episode_len (B,), final
    buffers)``; ``episode_len`` is the iteration at which each image
    finished (stop action or ``max_timesteps``). Iterations before
    ``start_time`` (scalar or per-image) are no-ops for that image. The
    loop stops as soon as every image has finished; the iterations it
    skips would change nothing.

    Each policy step is :func:`static_policy_step` on the tensors of a
    :class:`StaticPolicyStep`. Without ``policy_graphs`` they are this
    call's copies of ``bufs`` and the first outputs, and the step runs
    uncaptured: the tree search hands the loop buffer snapshots that
    sibling nodes share. With ``policy_graphs`` they are that cache's for
    this batch (``graph_key``: see :meth:`PolicyGraphs.bind`), replayed
    from its CUDA graph on CUDA; the final buffers returned are then the
    cache's own tensors, until that device's next call.

    The encoder cache is on where ``bufs`` carry it and ``encode`` is
    given; the loop drops it otherwise, so that the slot write, the
    forward and the graph key all read it from the buffers.
    """
    if encode is None:
        bufs = bufs.replace(state_embs=None)
    step = functools.partial(
        static_policy_step,
        policy_step=make_policy_step(dt_apply, cfg, dt_embed_apply),
        encode=encode, max_timesteps=max_timesteps)
    if policy_graphs is None:
        static = StaticPolicyStep.copy_of(bufs, action_dict, pred_rtg, step)
        run = static.run
    else:
        static = policy_graphs.bind(graph_key, step, bufs, action_dict,
                                    pred_rtg)
        run = functools.partial(policy_graphs.run, static)
    b, dev = env_state.batch, env_state.x.device
    start_time = torch.as_tensor(start_time, dtype=torch.long,
                                 device=dev).reshape(-1).expand(b)
    finished = torch.zeros(b, dtype=torch.bool, device=dev)
    ep_len = torch.full((b,), max_timesteps, dtype=torch.long, device=dev)

    for t in range(max_timesteps + 1):
        with annotate(EVAL_STEP):
            started = t >= start_time
            if not _host_bool(started.any()):
                continue  # every update below is masked by `started`
            with annotate(ENV_ADMM):
                stepped = admm_step(denoise, env_state, static.action_dict)
                env_state = CSMRIState(**{
                    f.name: _where_rows(started, getattr(stepped, f.name),
                                        getattr(env_state, f.name))
                    for f in dataclasses.fields(CSMRIState)})
            finished_now = (env_state.done | (t == max_timesteps)) & started
            ep_len = torch.where(finished_now & ~finished,
                                 torch.full_like(ep_len, t), ep_len)
            finished = finished | finished_now
            live = ~finished & started
            if not _host_bool(live.any()):
                # Every buffer write and policy output below is masked by
                # `live`; with no live image the step changes nothing.
                if _host_bool(finished.all()):
                    break
                continue

            with annotate(POLICY_STEP):
                run(get_policy_ob(env_state), live, t)

    return env_state, compute_reward(env_state), ep_len, static.bufs


def policy_forward(dt: DecisionTransformer, cfg: ModelConfig) -> Callable:
    """The policy's forward: the fused one of ``dt`` (kernel K3) where K3
    takes ``cfg``, else the per-op one."""
    return (make_fused_dt_apply(dt) if fused_forward_takes(cfg)
            else make_dt_apply(dt))


def check_policy_forward(dt: DecisionTransformer, cfg: ModelConfig,
                         device: torch.device) -> None:
    """On the card, refuse a :func:`policy_forward` that would run the
    per-op forward without kernels K4 and K5 (``dt`` built without
    ``use_pallas``)."""
    if device.type == "cuda" and not fused_forward_takes(cfg) \
            and not dt.cfg.use_pallas:
        raise ValueError(
            f"kernel K3 does not take {3 * cfg.context_length} tokens at "
            f"embed_dim {cfg.embed_dim} with {cfg.n_heads} heads, and the "
            "per-op forward runs its kernels K4 and K5 on the card only "
            "with ModelConfig(use_pallas=True); build the "
            "DecisionTransformer with it")


@dataclasses.dataclass
class Evaluator:
    """Evaluation driver with the reference CLI's surface: a loop over
    dataset directories and metrics over the first ``report_every`` images
    of each, with all images of all directories in one batched rollout.

    ``dt_apply`` is the forward the policy runs, with the signature of
    :func:`..models.decision_transformer.make_dt_apply`. By default it is
    the fused forward of ``dt`` (kernel K3) where K3 takes ``cfg``
    (:func:`..models.decision_transformer.fused_forward_takes`), else the
    per-op forward, which on the card must run kernels K4 and K5: a ``dt``
    built without ``use_pallas`` is then refused with a ``ValueError``.
    ``dt`` itself supplies the state encoder of the embedding cache.

    With a ``mesh`` (``training/sharding.py:make_mesh``) the images are
    padded to this process's share of its data axis and split over the
    local shards, one rollout each, on a copy of ``dt`` and ``denoise``
    per local device (a given ``dt_apply`` is used on every shard as it
    is); on more than one process, ``records`` are this process's slice of
    the global batch and the outputs are gathered over the processes.

    On CUDA each policy step replays a CUDA graph (:class:`PolicyGraphs`),
    captured on the first call of each batch size and again after the DT's
    weights change; :meth:`policy_graph_stats` counts captures and
    replays. A given ``dt_apply`` is captured as it is: weights it reads
    other than ``dt``'s must keep their storage. Each shard's rollout runs
    inside the scope of a :class:`..models.prior_graphs.PriorGraphs`, so
    that on CUDA the prior's forward replays a CUDA graph too, captured on
    the first call of each batch size and again after the prior's weights
    change; :meth:`prior_graph_stats` counts them."""
    dt: DecisionTransformer
    denoise: Callable
    cfg: ModelConfig
    max_timesteps: int = 30
    rtg_target: float = 10.0
    eval_type: str = "norm"
    report_every: int = 7
    cached_encoder: bool = True   # cache state-encoder outputs per slot
    device: Any = "cuda"
    dt_apply: Optional[Callable] = None
    mesh: Optional[Mesh] = None   # shard the images over its data axis
    # Metrics of the last ``run``, as ``evaluate_records`` returns them.
    last_metrics: Optional[Dict[str, Any]] = dataclasses.field(
        default=None, init=False)

    def __post_init__(self):
        if self.mesh is None:
            self.device = resolve_device(self.device)
            self._shards = [(self.device, self.dt, self.denoise)]
        else:
            self.device = self.mesh.devices[0]
            self._shards = list(zip(self.mesh.devices,
                                    replicate(self.dt, self.mesh),
                                    replicate(self.denoise, self.mesh)))
        if self.dt_apply is None:
            for dev in dict.fromkeys(d for d, _, _ in self._shards):
                check_policy_forward(self.dt, self.cfg, dev)
        self._policy_graphs = PolicyGraphs()
        self._prior_graphs = PriorGraphs()

    def policy_graph_stats(self) -> Dict[str, int]:
        """Over this evaluator's calls: the policy-step graphs captured,
        their replays, and the policy steps run without a graph."""
        return self._policy_graphs.stats()

    def prior_graph_stats(self) -> Dict[str, int]:
        """Over this evaluator's calls: the prior's graphs captured, their
        replays, and the prior's calls run eagerly (without CUDA, or with
        grad on)."""
        return self._prior_graphs.stats()

    def _rollout(self, dt, denoise, policy_x0, rtg0, task, env_state):
        """One shard's rollout: (final state, reward (B,),
        previous reward (B,), episode lengths (B,)), on the device."""
        dt_apply = self.dt_apply or policy_forward(dt, self.cfg)
        encode = dt_embed_apply = None
        if self.cached_encoder:
            encode = make_state_encode(dt)
            dt_embed_apply = make_dt_embed_apply(dt_apply)
        graphs = graph_key = None
        if env_state.x.device.type == "cuda":
            graphs, graph_key = self._policy_graphs, weights_key(dt)
        with annotate(EVAL_ROLLOUT):
            old_reward = compute_reward(env_state)
            bufs, _, action_dict, pred_rtg = initial_policy_setup(
                dt_apply, self.cfg, policy_x0, rtg0, task,
                self.max_timesteps, encode=encode)
            with self._prior_graphs.scope():
                final, reward, ep_len, _ = greedy_rollout(
                    dt_apply, denoise, self.cfg, env_state, bufs,
                    action_dict, pred_rtg, self.max_timesteps, encode=encode,
                    dt_embed_apply=dt_embed_apply, policy_graphs=graphs,
                    graph_key=graph_key)
        return final, reward[:, 0], old_reward[:, 0], ep_len

    @torch.no_grad()
    def evaluate_records(self, records: Sequence[Tuple[Any, Any]],
                         return_global: bool = False) -> Dict[str, Any]:
        """Evaluate ``((states, rtg, actions, task), mat)`` items in one
        batched rollout (one per local shard with a mesh). Returns a
        metrics dict.

        On more than one process ``records`` is this process's slice of
        the global batch (the slices in process order make it), and
        ``return_global=True`` returns the metrics of the whole gathered
        batch, every process's padding included; for one process it
        changes nothing."""
        if not records:
            raise ValueError("evaluate_records needs at least one record "
                             "(empty evaluation directory?)")
        n = len(records)
        if self.mesh is not None:
            # This process's share of the data axis is the padding unit.
            unit = max(1, self.mesh.shape["data"]
                       // self.mesh.data_processes)
            records = list(records) + [records[-1]] * ((-n) % unit)

        def stack(i):
            return torch.from_numpy(np.stack(
                [np.asarray(r[0][i], np.float32 if i < 3 else np.int64)
                 .reshape(-1) for r in records]))

        with annotate(EVAL_PREPARE):
            inputs = (stack(0), stack(1)[:, 0], stack(3)[:, 0])
            mats = {k: np.concatenate([np.asarray(r[1][k])
                                       for r in records])
                    for k in ("x0", "y0", "mask", "gt")}
            shard_inputs = shard_eval_inputs(
                inputs + (reset_from_mat(mats, device="cpu"),), self.mesh,
                device=self.device)
        devices = [dev for dev, _, _ in self._shards]
        synchronize(devices)
        t0 = _time.perf_counter()
        outs = run_sharded(self._rollout, devices,
                           [shard[1:] + inp for shard, inp in
                            zip(self._shards, shard_inputs)])
        synchronize(devices)
        wall = _time.perf_counter() - t0
        reward, old, ep_len = gather_eval_outputs([o[1:] for o in outs],
                                                  self.mesh)
        final = outs[0][0] if len(outs) == 1 else CSMRIState(**{
            f.name: torch.cat([getattr(o[0], f.name).to(devices[0])
                               for o in outs])
            for f in dataclasses.fields(CSMRIState)})
        # Gathered over processes, the outputs are the global batch; this
        # process's rows start at its offset (equal counts are checked).
        if not (return_global and self.mesh is not None
                and self.mesh.data_processes > 1):
            off = local_output_offset(len(records), self.mesh)
            reward, old, ep_len = (x[off:off + n]
                                   for x in (reward, old, ep_len))
        return {
            "reward": reward,
            "increment": reward - old,
            "episode_len": ep_len,
            "wall_time_s": wall,
            "final_state": final,
        }

    def run(self, eval_paths: Sequence[str]) -> float:
        """Evaluate every directory's first ``report_every`` images in one
        batched rollout, print the reference's per-directory aggregates in
        order, and return the total PSNR increment.

        With a mesh over more than one process the global record list is
        wrap-padded to equal process slices (each a multiple of the
        process's share of the data axis), each process evaluates its own
        slice, and the gathered rows are put back in order, so that every
        process prints the one-process aggregates."""
        groups = []
        for path in eval_paths:
            ds = EvaluationDataset(
                path, rtg_target=self.rtg_target,
                kind="flex" if self.eval_type == "flex" else "optimal",
                image_size=self.cfg.image_size)
            n = min(len(ds), self.report_every)
            if n:
                groups.append((path, [ds[i] for i in range(n)]))
        if not groups:
            return 0.0
        records = [r for _, recs in groups for r in recs]
        n_proc = 1 if self.mesh is None else self.mesh.data_processes
        if n_proc > 1:
            n_global = len(records)
            per_proc = padded_per_process(n_global, self.mesh)
            padded = [records[i % n_global]
                      for i in range(n_proc * per_proc)]
            pid = self.mesh.data_index
            m = self.evaluate_records(
                padded[pid * per_proc:(pid + 1) * per_proc],
                return_global=True)
            for k in ("reward", "increment", "episode_len"):
                m[k] = m[k][:n_global]
        else:
            m = self.evaluate_records(records)
        self.last_metrics = m
        total_increment, off = 0.0, 0
        for _, recs in groups:
            sl = slice(off, off + len(recs))
            off += len(recs)
            print("Average iter, ", float(np.mean(m["episode_len"][sl])))
            print("Average reward, ", float(np.mean(m["reward"][sl])))
            print("PSNR increment ", float(np.mean(m["increment"][sl])))
            total_increment += float(np.mean(m["increment"][sl]))
        return total_increment
