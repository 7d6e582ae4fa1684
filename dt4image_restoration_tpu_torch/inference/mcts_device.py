"""Device-resident PUCB tree search: the tree lives on the device.

Counterpart of the JAX package's ``inference/mcts_device.py``, with the
same semantics. The host-tree search (:mod:`.mcts`) keeps its nodes as
Python objects and reads every round's priors and rewards back to the
host; here the tree is a set of fixed-size tensors on the device and the
host only launches work:

  * **node arrays**: a search of I rounds with K children per expansion
    touches at most ``1 + I*K`` nodes; parent and first-child indices, the
    PUCB statistics (prob, reward, visits), each node's env state (x, z,
    u, T) and a buffer-bank pointer are allocated at that bound. Children
    of round i occupy slots ``1 + i*K .. (i+1)*K``;
  * **selection**: the PUCB descent as masked steps over those arrays,
    with the host search's first-strict-maximum tie-break, NaN scores
    skipped and the -1000 floor. Where no child clears the floor at an
    expanded node, the host loop re-selects that node and inflates its
    visit count until one does; the descent's ``retry`` lanes do the same.
    The descent runs as many steps as the tree can be deep without a host
    sync, then checks once whether a lane still retries and goes on only
    then, up to ``n_nodes + 10_000`` steps; a lane still descending there
    gives up (it re-expands its node) and ``run_batch`` warns;
  * **expansion and rollout**: :meth:`MCTS._search_iter`, the body the
    host backend runs, so the two backends cannot drift;
  * **buffer bank**: the children of round i share one policy-buffer
    snapshot; the bank holds ``1 + I`` of them and nodes point into it;
  * **max-backprop**: :func:`max_backprop`, an ascent that stops at the
    first ancestor the reward does not improve;
  * **value function**: ``value_fn_batched`` scores every tree's rollout
    in one call, (B, H, W) -> (B,) on the device
    (``models/arniqa.py``: ``make_value_fn_batched``,
    ``proxy_value_fn_batched``). The host search memoises rewards per
    node; a selected leaf is always freshly expanded, so the memo never
    hits and is not kept.

``node_dtype="bfloat16"`` stores the node states (the search's largest
allocation: 5 planes of H*W floats a node) in bfloat16; they are computed
in float32 after the gather.
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..env.pnp import CSMRIState, reset_from_mat
from ..ops.metrics import psnr
from ..training.sharding import (gather_eval_outputs, local_output_offset,
                                 padded_per_process, run_sharded,
                                 shard_eval_inputs, tree_map)
from ..utils.profiling import SEARCH_ROUND, annotate
from .evaluator import EvalBuffers, seed_buffers
from .mcts import MCTS

NODE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# Descent steps between two checks for lanes still retrying at the floor.
RETRY_STEPS = 64
# Past this many descent steps beyond the tree's size a lane gives up floor
# recovery (the host loop would keep inflating visits for ever).
GIVE_UP_STEPS = 10_000


def max_backprop(reward: torch.Tensor, parent: torch.Tensor,
                 leaf: torch.Tensor, r: torch.Tensor,
                 max_steps: Optional[int] = None) -> torch.Tensor:
    """Batched max-backprop: from each tree's ``leaf``, ascend the
    ``parent`` chain setting ``reward`` to ``r`` while it improves, and stop
    at the first ancestor it does not improve (the host
    ``Node.backprop``). Returns the new (n, n_nodes) reward array.

    ``parent`` must be the CURRENT parent array, with this round's children
    in it: a stale copy strands every update at the leaf. The ascent runs
    ``max_steps`` masked steps without a host sync; a chain is at most
    ``n_nodes`` long, the default.
    """
    n, n_nodes = reward.shape
    reward = reward.clone()
    rows = torch.arange(n, device=reward.device)
    cur = leaf.long()
    for _ in range(n_nodes if max_steps is None else max_steps):
        safe = cur.clamp(min=0)
        old = reward[rows, safe]
        improve = (cur >= 0) & (r > old)
        reward[rows, safe] = torch.where(improve, r, old)
        cur = torch.where(improve, parent[rows, safe].long(),
                          torch.full_like(cur, -1))
    return reward


def _descend(first_child, prob, reward, visits, cur, stopped, rows, kids):
    """One masked PUCB descent step of every tree; adds the step's visits
    into ``visits`` in place."""
    fc = first_child[rows, cur]
    ch = fc.clamp(min=0)[:, None] + kids
    ch_r = reward.gather(1, ch)
    ch_p = prob.gather(1, ch)
    ch_v = visits.gather(1, ch)
    pv = visits[rows, cur].float()
    # v >= 1 on the path; the host's NaN branch (log < 0) fires at v == 0.
    term = torch.where(pv >= 1.0, torch.sqrt(torch.log(pv.clamp(min=1.0))),
                       torch.full_like(pv, math.nan))
    score = (ch_r - reward[rows, cur][:, None]
             + ch_p * term[:, None] / (1.0 + ch_v))
    score = torch.where(torch.isnan(score),
                        torch.full_like(score, -math.inf), score)
    best, best_k = score.max(dim=1)            # the first maximum wins
    descend = ~stopped & (fc >= 0)
    advance = descend & (best > -1000.0)
    retry = descend & ~advance                 # floor tripped: inflate
    new_cur = torch.where(advance, ch.gather(1, best_k[:, None])[:, 0], cur)
    visits.scatter_add_(1, new_cur[:, None],
                        (advance | retry).to(visits.dtype)[:, None])
    return new_cur, stopped | (fc < 0)


@dataclasses.dataclass
class DeviceMCTS(MCTS):
    """The search with its tree on the device. ``value_fn_batched`` scores
    a (B, H, W) batch of rollout images on the device, (B,) out (default:
    the proxy scorer); ``value_fn``, the host scorer, is not called."""
    value_fn_batched: Optional[Callable[[torch.Tensor],
                                        torch.Tensor]] = None
    # Storage dtype of the node states (x, z, u): 'bfloat16' halves the
    # search's largest allocation; compute stays float32.
    node_dtype: str = "float32"

    def __post_init__(self):
        super().__post_init__()
        if self.node_dtype not in NODE_DTYPES:
            raise ValueError(f"node_dtype must be one of {sorted(NODE_DTYPES)}"
                             f", got {self.node_dtype!r}")
        if self.value_fn_batched is None:
            from ..models.arniqa import proxy_value_fn_batched
            self.value_fn_batched = proxy_value_fn_batched

    def _select(self, first_child, prob, reward, visits, depth: int):
        """The PUCB descent of every tree from its root. ``depth`` bounds
        the trees' depth, so that ``depth + 1`` steps end every descent
        that no floor retry holds up. Returns (leaf, gave_up)."""
        n, dev = first_child.shape[0], first_child.device
        rows = torch.arange(n, device=dev)
        kids = torch.arange(self.cfg.n_children, device=dev)
        visits[:, 0] += 1                      # the root's pre-increment
        cur = torch.zeros(n, dtype=torch.long, device=dev)
        stopped = torch.zeros(n, dtype=torch.bool, device=dev)
        bound = first_child.shape[1] + GIVE_UP_STEPS
        steps, chunk = 0, depth + 1
        while True:
            for _ in range(min(chunk, bound - steps)):
                cur, stopped = _descend(first_child, prob, reward, visits,
                                        cur, stopped, rows, kids)
            steps += min(chunk, bound - steps)
            if steps >= bound or not bool((~stopped).any()):
                return cur, ~stopped
            chunk = RETRY_STEPS

    def _search_all(self, root_bufs: EvalBuffers, root: CSMRIState,
                    rtg0: torch.Tensor, z_all: torch.Tensor):
        """Every round of every tree; ``z_all`` (I, n, 2K) holds the
        standard normals of the children's draws. Returns (final PSNR,
        best final image, its episode length, gave-up lanes, per-round
        traces)."""
        I, K = self.cfg.iterations, self.cfg.n_children
        n, dev = root.batch, root.x.device
        n_nodes = 1 + I * K
        store = NODE_DTYPES[self.node_dtype]
        rows = torch.arange(n, device=dev)

        def node_alloc(root_leaf):
            arr = torch.zeros((n, n_nodes) + root_leaf.shape[1:],
                              dtype=store, device=dev)
            arr[:, 0] = root_leaf
            return arr

        # z and u are complex64: stored as (..., 2) real pairs.
        node_x = node_alloc(root.x)
        node_z = node_alloc(torch.view_as_real(root.z))
        node_u = node_alloc(torch.view_as_real(root.u))
        node_T = torch.zeros((n, n_nodes), device=dev)
        parent = torch.full((n, n_nodes), -1, dtype=torch.long, device=dev)
        first_child = torch.full_like(parent, -1)
        time = torch.zeros_like(parent)
        prob = torch.zeros((n, n_nodes), device=dev)
        prob[:, 0] = 1.0
        reward = torch.zeros((n, n_nodes), device=dev)
        visits = torch.zeros((n, n_nodes), dtype=torch.int32, device=dev)
        visits[:, 0] = 1
        policy_rtg = torch.zeros((n, n_nodes), device=dev)
        policy_rtg[:, 0] = rtg0
        buf_id = torch.zeros_like(parent)

        bank_keys = [f.name for f in dataclasses.fields(EvalBuffers)
                     if f.name != "task"
                     and getattr(root_bufs, f.name) is not None]
        bank = {}
        for key in bank_keys:
            leaf = getattr(root_bufs, key)
            bank[key] = torch.zeros((n, 1 + I) + leaf.shape[1:],
                                    dtype=leaf.dtype, device=dev)
            bank[key][:, 0] = leaf

        best_reward = torch.full((n,), -math.inf, device=dev)
        best_final = torch.zeros_like(root.gt)
        best_ep = torch.zeros(n, dtype=torch.long, device=dev)
        bailed = torch.zeros(n, dtype=torch.bool, device=dev)
        traces = []

        def as_complex(stored):
            return torch.view_as_complex(stored.float().contiguous())

        def children(x):
            return x.reshape((n, K + 1) + x.shape[1:])[:, 1:]

        for i in range(I):
            with annotate(SEARCH_ROUND.format(i)):
                leaf, gave_up = self._select(first_child, prob, reward,
                                             visits, depth=i)
                bailed |= gave_up
                t_vec = time[rows, leaf]
                env = CSMRIState(
                    x=node_x[rows, leaf].float(),
                    z=as_complex(node_z[rows, leaf]),
                    u=as_complex(node_u[rows, leaf]), mask=root.mask,
                    y0=root.y0, gt=root.gt, T=node_T[rows, leaf],
                    done=torch.zeros(n, dtype=torch.bool, device=dev))
                bid = buf_id[rows, leaf]
                bufs = EvalBuffers(task=root_bufs.task, **{
                    key: bank[key][rows, bid] for key in bank_keys})

                (_, pred_rtg, probs, stepped, new_bufs, finals,
                 ep_len) = self._search_iter(
                    bufs, t_vec, env, policy_rtg[rows, leaf],
                    z_all[i, :, :K], z_all[i, :, K:])

                new = slice(1 + i * K, 1 + (i + 1) * K)
                node_x[:, new] = children(stepped.x)
                node_z[:, new] = children(torch.view_as_real(stepped.z))
                node_u[:, new] = children(torch.view_as_real(stepped.u))
                node_T[:, new] = children(stepped.T)
                parent[:, new] = leaf[:, None]
                time[:, new] = (t_vec + 1)[:, None]
                prob[:, new] = probs
                policy_rtg[:, new] = pred_rtg[:, None]
                buf_id[:, new] = i + 1
                first_child[rows, leaf] = new.start
                for key in bank_keys:
                    bank[key][:, i + 1] = getattr(new_bufs, key)

                # finals: (n, 1, H, W), the rollouts' last images.
                r = self.value_fn_batched(finals[:, 0]).float().reshape(n)
                reward = max_backprop(reward, parent, leaf, r,
                                      max_steps=i + 1)
                better = r > best_reward
                best_reward = torch.where(better, r, best_reward)
                best_final = torch.where(better[:, None, None, None],
                                         finals, best_final)
                best_ep = torch.where(better, ep_len, best_ep)
                if self.record_trace:
                    traces.append((leaf, t_vec, probs, r))

        # The score: PSNR of the best-scored rollout's image against gt,
        # in the host search's argument order.
        final_reward = psnr(root.gt, best_final)[:, 0]
        return final_reward, best_final, best_ep, bailed, traces

    def run_global_batches(self, records: Sequence, seeds: Sequence[int],
                           batch_size: int) -> List[float]:
        """Search a global record list in chunks of ``batch_size`` trees and
        return its rewards in order.

        With a mesh over more than one process, the records are cut into
        equal contiguous process slices (the tail wrap-padded, so that
        every process runs the same chunks in step), each process searches
        its own slice, and the gathered rows are put back in global order:
        the inverse of :meth:`_prepare_batch`'s padding. Otherwise the
        chunks run here, one after another."""
        pairs = list(zip(records, seeds))
        n_proc = 1 if self.mesh is None else self.mesh.data_processes
        if n_proc <= 1:
            out: List[float] = []
            for off in range(0, len(pairs), batch_size):
                chunk = pairs[off:off + batch_size]
                out += self.run_batch([r for r, _ in chunk],
                                      seeds=[s for _, s in chunk],
                                      verbose=False)
            return out
        n_global = len(pairs)
        if n_global == 0:
            return []
        per_proc = padded_per_process(n_global, self.mesh)
        padded = [pairs[i % n_global] for i in range(n_proc * per_proc)]
        pid = self.mesh.data_index
        local = padded[pid * per_proc:(pid + 1) * per_proc]
        rewards = np.full(n_proc * per_proc, np.nan)
        for off in range(0, per_proc, batch_size):
            chunk = local[off:off + batch_size]
            vals = self.run_batch([r for r, _ in chunk],
                                  seeds=[s for _, s in chunk],
                                  verbose=False, return_global=True)
            cp = self.local_padded_count(len(chunk))
            for p in range(n_proc):
                rewards[p * per_proc + off:p * per_proc + off + len(chunk)] \
                    = vals[p * cp:p * cp + len(chunk)]
        return [float(v) for v in rewards[:n_global]]

    def _search_shard(self, root: CSMRIState, rtg0: torch.Tensor,
                      task: torch.Tensor, z: torch.Tensor):
        """One shard's search of its trees (``z``: (trees, I, 2K) standard
        normals), on this search's device. Returns (final PSNR, best final
        image, its episode length, gave-up lanes, the traces stacked per
        field over the rounds, or None)."""
        root_bufs = seed_buffers(self.model_cfg,
                                 root.x_real.reshape(root.batch, -1), rtg0,
                                 task, self.cfg.max_timesteps, self._encode)
        final_reward, best_final, best_ep, bailed, traces = \
            self._search_all(root_bufs, root, rtg0, z.transpose(0, 1))
        traces = tuple(torch.stack(x) for x in zip(*traces)) \
            if traces else None
        return final_reward, best_final, best_ep, bailed, traces

    @torch.no_grad()
    def run_batch(self, records: Sequence, seeds: Optional[Sequence[int]]
                  = None, detailed: bool = False, verbose: bool = True,
                  return_global: bool = False) -> list:
        """Search ``((states, rtg, actions, task), mat)`` records, one tree
        each, in lockstep, with per-tree RNG streams seeded from ``seeds``
        (default ``cfg.seed + i``) as in the host search. Returns each
        tree's final PSNR (printed unless ``verbose=False``), or with
        ``detailed=True`` dicts ``{"reward", "image" (H, W),
        "episode_len"}`` of the best-scored rollout. Fetches to the host
        only what it returns, and the traces when ``record_trace``.

        With a mesh the trees are padded to this process's share of its
        data axis and split over the local shards. On more than one
        process ``records`` is this process's slice of the global batch,
        and ``return_global=True`` returns the rewards of the whole
        gathered batch in process order, every process's padding
        included; for one process it changes nothing."""
        self.traces = None
        records, seeds, n_out = self._prepare_batch(records, seeds)
        n = len(records)
        I, K = self.cfg.iterations, self.cfg.n_children
        # The per-tree streams in the host search's order: K sigma_d
        # draws, then K mu draws, per round; drawn once, moved once.
        z = np.stack([np.random.default_rng(s).standard_normal((I, 2 * K))
                      for s in seeds])
        mats = {k: np.concatenate([np.asarray(r[1][k]) for r in records])
                for k in ("x0", "y0", "mask", "gt")}
        rtg0 = torch.tensor([float(np.asarray(r[0][1]).reshape(-1)[0])
                             for r in records], dtype=torch.float32)
        task = torch.as_tensor(np.stack(
            [np.asarray(r[0][3]).reshape(-1)[0] for r in records]))
        # The root observation is the reset state's x (the clipped record
        # x0), as in the host search.
        inputs = shard_eval_inputs(
            (reset_from_mat(mats, device="cpu"), rtg0, task, z), self.mesh,
            device=self.device)
        searches = self._shard_searches
        outs = run_sharded(lambda m, *a: m._search_shard(*a),
                           [m.device for m in searches],
                           [(m,) + a for m, a in zip(searches, inputs)])
        mesh = self.mesh

        def local(pick, axis=0):
            """``pick`` of this process's shards' outputs, on the host,
            joined: its rows, the padding dropped."""
            out = gather_eval_outputs([pick(o) for o in outs], axis=axis)
            index = (slice(None),) * axis + (slice(0, n_out),)
            return tree_map(lambda x: x[index], out)

        rewards, bailed = local(lambda o: (o[0], o[3]))
        rewards = rewards.tolist()
        if bailed.any():
            warnings.warn(
                f"DeviceMCTS selection gave up floor recovery on trees "
                f"{np.nonzero(bailed)[0].tolist()}: the host backend would "
                f"explore differently here (value scale likely "
                f"pathological)", RuntimeWarning, stacklevel=3)
        if self.record_trace:
            # (iterations, trees, ...) per field.
            leaf, t_leaf, probs, r = local(lambda o: o[4], 1)
            self.traces = [[{
                "iter": i, "time": int(t_leaf[i, j]),
                "edge": (int(leaf[i, j]) - 1) % K if leaf[i, j] > 0 else 0,
                "index": (int(leaf[i, j]) - 1) // K if leaf[i, j] > 0
                else 0,
                "probs": [float(p) for p in probs[i, j]],
                "reward": float(r[i, j])} for i in range(I)]
                for j in range(n_out)]
        if return_global and mesh is not None and mesh.data_processes > 1:
            # Every process's rewards, its padding included, in process
            # order (equal counts are checked).
            local_output_offset(n, mesh)
            return [float(v) for v in gather_eval_outputs(
                [o[0] for o in outs], mesh)]
        if verbose:
            for v in rewards:
                print("MCTS Reward: ", v)
        if not detailed:
            return rewards
        images, eps = local(lambda o: (o[1][:, 0], o[2]))
        return [{"reward": rewards[j], "image": images[j],
                 "episode_len": int(eps[j])} for j in range(n_out)]
