"""Greedy RTG-conditioned autoregressive evaluation.

Counterpart of the JAX package's ``inference/evaluator.py``: the env step
and the two DT forwards of every policy step, batched over images, run
eagerly on the device. It keeps the reference quirks the JAX package
documents, which published-checkpoint outputs depend on:

  * sliding window: ``[:ctx]`` while ``t < ctx`` else ``[t-ctx:t]``; the
    action written at slot ``t`` is visible to the RTG forward only while
    ``t < ctx``.
  * latest-index reads: action at ``min(t, ctx-1)``; RTG at ``t`` while
    ``t < ctx`` else at ``ctx-2``.
  * the initial RTG forward sees all-zero RTG and action streams.
  * the stop action ``T > 0.5`` freezes an image through the env's done
    mask; the loop ends once every image has finished.
"""
from __future__ import annotations

import dataclasses
import time as _time
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import ModelConfig
from ..data.datasets import EvaluationDataset
from ..env.pnp import CSMRIState, admm_step, compute_reward, get_policy_ob, \
    reset_from_mat
from ..models.decision_transformer import (DecisionTransformer,
                                           make_dt_apply,
                                           make_dt_embed_apply,
                                           make_state_encode)
from ..utils.device import resolve_device


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
    """``buf[b, idx[b, k]]`` for (B, K) indices -> (B, K, ...)."""
    gather_idx = idx.reshape(idx.shape + (1,) * (buf.ndim - 2)).expand(
        idx.shape + buf.shape[2:])
    return buf.gather(1, gather_idx)


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
            def forward(actions_buf):
                return dt_embed_apply(
                    _take(bufs.rtg, timesteps), _take(bufs.state_embs,
                                                      timesteps),
                    timesteps, task, _take(actions_buf, timesteps))
        else:
            def forward(actions_buf):
                return dt_apply(
                    _take(bufs.rtg, timesteps), _take(bufs.states, timesteps),
                    timesteps, task, _take(actions_buf, timesteps))

        out = forward(bufs.actions)
        read_idx = torch.clamp(t, max=ctx - 1)
        rows = torch.arange(b, device=dev)
        action_vec = out.pred_actions[rows, read_idx]
        action_dict = {k: v[rows, read_idx, 0]
                       for k, v in out.action_dict.items()}

        actions = bufs.actions.clone()
        actions[rows, t] = action_vec
        bufs = bufs.replace(actions=actions)

        out2 = forward(bufs.actions)
        rtg_idx = torch.where(t < ctx, torch.clamp(t, max=ctx - 1),
                              torch.full_like(t, ctx - 2))
        pred_rtg = out2.pred_rtg[rows, rtg_idx, 0]
        return action_vec, action_dict, pred_rtg, bufs

    return policy_step


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
    b, s = policy_x0.shape
    dev = policy_x0.device
    ctx = cfg.context_length
    if max_timesteps < ctx:
        raise ValueError(
            f"max_timesteps ({max_timesteps}) must be >= the context "
            f"length ({ctx}); the policy windows are ctx-sized")

    state_embs = None
    if encode is not None:
        zero_emb = encode(torch.zeros((1, s), device=dev))[0]
        state_embs = zero_emb.expand(b, max_timesteps, -1).clone()
        state_embs[:, 0] = encode(policy_x0)

    states = torch.zeros((b, max_timesteps, s), device=dev)
    states[:, 0] = policy_x0
    rtg = torch.zeros((b, max_timesteps, 1), device=dev)
    rtg[:, 0] = rtg0.reshape(b, 1)
    bufs = EvalBuffers(
        states=states,
        actions=torch.zeros((b, max_timesteps, cfg.action_dim), device=dev),
        rtg=rtg, task=task.reshape(b).long(), state_embs=state_embs)

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


@torch.no_grad()
def greedy_rollout(dt_apply: Callable, denoise: Callable, cfg: ModelConfig,
                   env_state: CSMRIState, bufs: EvalBuffers,
                   action_dict: Dict[str, torch.Tensor],
                   pred_rtg: torch.Tensor, max_timesteps: int,
                   start_time: Any = 1,
                   encode: Optional[Callable] = None,
                   dt_embed_apply: Optional[Callable] = None
                   ) -> Tuple[CSMRIState, torch.Tensor, torch.Tensor,
                              EvalBuffers]:
    """The greedy env/policy loop over t = 0 .. max_timesteps.

    Returns ``(final_env_state, reward (B, 1), episode_len (B,), buffers)``;
    ``episode_len`` is the iteration at which each image finished (stop
    action or ``max_timesteps``). Iterations before ``start_time`` (scalar
    or per-image) are no-ops for that image. The loop stops as soon as
    every image has finished; the iterations it skips would change
    nothing.
    """
    policy_step = make_policy_step(dt_apply, cfg, dt_embed_apply)
    cached = bufs.state_embs is not None and encode is not None
    b, dev = env_state.batch, env_state.x.device
    start_time = torch.as_tensor(start_time, dtype=torch.long,
                                 device=dev).reshape(-1).expand(b)
    finished = torch.zeros(b, dtype=torch.bool, device=dev)
    ep_len = torch.full((b,), max_timesteps, dtype=torch.long, device=dev)

    for t in range(max_timesteps + 1):
        started = t >= start_time
        if not bool(started.any()):
            continue  # every update below is masked by `started`
        stepped = admm_step(denoise, env_state, action_dict)
        env_state = CSMRIState(**{
            f.name: _where_rows(started, getattr(stepped, f.name),
                                getattr(env_state, f.name))
            for f in dataclasses.fields(CSMRIState)})
        finished_now = (env_state.done | (t == max_timesteps)) & started
        ep_len = torch.where(finished_now & ~finished,
                             torch.full_like(ep_len, t), ep_len)
        finished = finished | finished_now
        live = ~finished & started
        if not bool(live.any()):
            # Every buffer write and policy output below is masked by
            # `live`; with no live image the step changes nothing.
            if bool(finished.all()):
                break
            continue

        tw = min(t, max_timesteps - 1)
        ob = get_policy_ob(env_state)
        bufs.states[:, tw] = _where_rows(live, ob, bufs.states[:, tw])
        bufs.rtg[:, tw] = _where_rows(live, pred_rtg[:, None],
                                      bufs.rtg[:, tw])
        if cached:
            bufs.state_embs[:, tw] = _where_rows(
                live, encode(ob), bufs.state_embs[:, tw])

        old_actions = bufs.actions
        _, new_dict, new_rtg, bufs = policy_step(bufs, t)
        bufs = bufs.replace(actions=_where_rows(live, bufs.actions,
                                                old_actions))
        action_dict = {k: torch.where(live, new_dict[k], action_dict[k])
                       for k in action_dict}
        pred_rtg = torch.where(live, new_rtg, pred_rtg)

    return env_state, compute_reward(env_state), ep_len, bufs


@dataclasses.dataclass
class Evaluator:
    """Evaluation driver with the reference CLI's surface: a loop over
    dataset directories and metrics over the first ``report_every`` images
    of each, with all images of all directories in one batched rollout."""
    dt: DecisionTransformer
    denoise: Callable
    cfg: ModelConfig
    max_timesteps: int = 30
    rtg_target: float = 10.0
    eval_type: str = "norm"
    report_every: int = 7
    cached_encoder: bool = True   # cache state-encoder outputs per slot
    device: Any = "cuda"
    # Metrics of the last ``run``, as ``evaluate_records`` returns them.
    last_metrics: Optional[Dict[str, Any]] = dataclasses.field(
        default=None, init=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)

    @torch.no_grad()
    def evaluate_records(self, records: Sequence[Tuple[Any, Any]]
                         ) -> Dict[str, Any]:
        """Evaluate ``((states, rtg, actions, task), mat)`` items in one
        batched rollout. Returns a metrics dict."""
        if not records:
            raise ValueError("evaluate_records needs at least one record "
                             "(empty evaluation directory?)")
        dev = self.device

        def stack(i):
            return torch.from_numpy(np.stack(
                [np.asarray(r[0][i], np.float32 if i < 3 else np.int64)
                 .reshape(-1) for r in records])).to(dev)

        policy_x0, rtg0, task = stack(0), stack(1)[:, 0], stack(3)[:, 0]
        mats = {k: np.concatenate([np.asarray(r[1][k]) for r in records])
                for k in ("x0", "y0", "mask", "gt")}
        env_state = reset_from_mat(mats, device=dev)
        old_reward = compute_reward(env_state)

        dt_apply = make_dt_apply(self.dt)
        encode = dt_embed_apply = None
        if self.cached_encoder:
            encode = make_state_encode(self.dt)
            dt_embed_apply = make_dt_embed_apply(self.dt)

        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = _time.perf_counter()
        bufs, _, action_dict, pred_rtg = initial_policy_setup(
            dt_apply, self.cfg, policy_x0, rtg0, task, self.max_timesteps,
            encode=encode)
        final, reward, ep_len, _ = greedy_rollout(
            dt_apply, self.denoise, self.cfg, env_state, bufs, action_dict,
            pred_rtg, self.max_timesteps, encode=encode,
            dt_embed_apply=dt_embed_apply)
        reward = reward[:, 0].cpu().numpy()
        wall = _time.perf_counter() - t0
        old = old_reward[:, 0].cpu().numpy()
        return {
            "reward": reward,
            "increment": reward - old,
            "episode_len": ep_len.cpu().numpy(),
            "wall_time_s": wall,
            "final_state": final,
        }

    def run(self, eval_paths: Sequence[str]) -> float:
        """Evaluate every directory's first ``report_every`` images in one
        batched rollout, print the reference's per-directory aggregates in
        order, and return the total PSNR increment."""
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
        m = self.evaluate_records([r for _, recs in groups for r in recs])
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
