"""PUCB tree search, the third inference mode.

Counterpart of the JAX package's ``inference/mcts.py`` host-tree search,
with the same semantics: the tree and its bookkeeping stay on the host,
N images' trees advance in lockstep, and one fused device iteration per
PUCB round runs, for every tree's selected leaf,

  * the policy step (two DT forwards) at the leaf's depth;
  * the |Normal| sampling of the children's sigma_d and mu around the
    policy's action (standard normals drawn on the host, per tree, in the
    order the JAX search draws them), sorted by descending mu density;
  * one batched PnP-ADMM step over (children + 1) slots per tree: slot 0 is
    the policy's own action, slots 1.. the sampled children; ``done`` is
    cleared on the outputs (the stop flag is re-decided every step);
  * the buffer snapshot every child of the leaf shares;
  * the greedy rollout from the leaf's depth to the horizon.

Leaves are scored by a no-reference value function (ARNIQA or the proxy,
``models/arniqa.py``), memoised per node name; rewards back up by max. The
result per tree is the PSNR of the best-scored rollout's final image.

The JAX package's single-node API is here too: :meth:`MCTS.expand` expands
one node (its children's samples drawn from a numpy generator, in the
order the JAX package draws them) and :meth:`MCTS.beam_search` rolls one
out, both through the pieces the batched round uses.

Nodes share tensors: a leaf's children hold views of one stepped batch and
one buffer snapshot. Nothing here writes into a tensor in place, and the
greedy rollout works on copies of the buffers it is given, so a rollout
from one leaf leaves its siblings' state as it was.

A leaf at or past ``max_timesteps`` is expanded as in the JAX package:
buffer writes past the end are dropped and window reads past it are NaN.

The device part draws its |Normal| densities in float64, as the JAX
package's host ``fold_and_sort`` does: at the mu std of 0.001 the float32
``(|loc + std z| - loc) / std`` loses up to 3e-5 of z to rounding, which
is visible in the priors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import MCTSConfig, ModelConfig
from ..env.pnp import CSMRIState, admm_step, reset_from_mat
from ..models.decision_transformer import (DecisionTransformer,
                                           make_dt_apply,
                                           make_dt_embed_apply,
                                           make_state_encode)
from ..ops.metrics import psnr
from ..training.sharding import (Mesh, process_count, replicate,
                                 run_sharded)
from ..utils.device import resolve_device
from ..utils.profiling import SEARCH_ROUND, annotate
from .evaluator import (EvalBuffers, greedy_rollout, make_policy_step,
                        seed_buffers, set_slot)


class Node:
    """Search-tree node holding references to device tensors."""

    def __init__(self, time: int, prob: float, parent: Optional["Node"],
                 edge: int, index: int, env_state: Optional[CSMRIState],
                 policy_state: Optional[CSMRIState],
                 policy_rtg: float) -> None:
        self.time = time
        self.prob = float(prob)
        self.parent = parent
        self.edge = edge
        self.index = index
        self.env_state = env_state
        self.policy_state = policy_state
        self.policy_rtg = float(policy_rtg)
        self.children: List["Node"] = []
        self.reward = 0.0
        self.s_visits = 0
        self.action: Optional[np.ndarray] = None  # set when expanded
        self.bufs: Optional[EvalBuffers] = None   # policy buffer snapshot

    def set_policy_state(self, state: CSMRIState) -> None:
        self.policy_state = state

    def __repr__(self) -> str:
        return f"Node(time = {self.time}, edge = {self.edge})_{self.index}"

    def backprop(self, reward: float) -> None:
        """Max-backprop to the root."""
        if reward > self.reward:
            self.reward = reward
            if self.parent is not None:
                self.parent.backprop(reward)

    def ancestry(self) -> List["Node"]:
        """This node and its ancestors, up to the root."""
        nodes, n = [], self
        while n is not None:
            nodes.append(n)
            n = n.parent
        return nodes


def select_p_ucb(parent: Node) -> Node:
    """PUCB child selection: score = (child.reward - parent.reward) +
    prob * sqrt(log(parent visits)) / (1 + child visits). The first child
    with the highest score wins; the parent is returned when no child
    beats the floor score of -1000."""
    max_p_ucb = -1000.0
    s_visits = parent.s_visits
    log_visits = math.log(s_visits) if s_visits > 0 else -math.inf
    root_term = math.sqrt(log_visits) if log_visits >= 0 else math.nan
    best = parent
    for child in parent.children:
        p_ucb = (child.reward - parent.reward) \
            + child.prob * root_term / (1 + child.s_visits)
        if not math.isnan(p_ucb) and p_ucb > max_p_ucb:
            best, max_p_ucb = child, p_ucb
    return best


def fold_and_sort(raw: np.ndarray, loc: float, std: float
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Fold raw normal draws to |draws| and sort them by descending
    N(loc, std) density, evaluated at the folded samples."""
    samples = np.abs(np.asarray(raw, np.float64))
    probs = np.exp(-0.5 * ((samples - loc) / std) ** 2) \
        / (std * np.sqrt(2 * np.pi))
    order = np.argsort(-probs, kind="stable")
    return (samples[order].astype(np.float32),
            probs[order].astype(np.float32))


def sample_actions(rng: np.random.Generator, loc: float, std: float, n: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """|N(loc, std)| samples sorted by descending density."""
    raw = loc + std * rng.standard_normal(n)
    return fold_and_sort(raw, loc, std)


def fold_sort_batch(loc: torch.Tensor, z: torch.Tensor, std: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`fold_and_sort` of ``loc + std * z`` over a (n_trees, k) batch
    of standard normals with per-tree locs, on their device, in float64.
    Returns float32 (samples, densities)."""
    loc = loc.double()[:, None]
    samples = (loc + std * z.double()).abs()
    u = (samples - loc) / std
    probs = torch.exp(-0.5 * u * u) / (std * math.sqrt(2 * math.pi))
    order = torch.argsort(-probs, dim=-1, stable=True)
    return (samples.gather(-1, order).float(),
            probs.gather(-1, order).float())


def _cat(items, cls):
    """Concatenate dataclasses of tensors along the batch axis."""
    return cls(**{f.name: None if getattr(items[0], f.name) is None
                  else torch.cat([getattr(x, f.name) for x in items])
                  for f in dataclasses.fields(cls)})


def _rows(item, lo: int, hi: int):
    """Rows ``lo:hi`` (views) of a dataclass of tensors."""
    return dataclasses.replace(item, **{
        f.name: getattr(item, f.name)[lo:hi]
        for f in dataclasses.fields(item)
        if getattr(item, f.name) is not None})


@dataclasses.dataclass
class MCTS:
    """The lockstep tree search. ``value_fn`` maps a restored image (1, H, W)
    numpy array to a scalar no-reference quality score.

    The policy is ``dt``'s per-op forward, which runs kernels K4 and K5
    when ``dt.cfg.use_pallas``; with ``cached_encoder`` the buffers cache
    each observation's state embedding and the forward runs over them.

    With a ``mesh`` (``training/sharding.py:make_mesh``) the trees are
    padded to this process's share of its data axis (the padded trees are
    dropped from the outputs) and split over the local shards, each shard's
    trees on its device with a copy of ``dt`` and ``denoise`` there. The
    single-node API (:meth:`expand`, :meth:`beam_search`) runs on the
    first local device.
    """
    dt: DecisionTransformer
    denoise: Callable
    model_cfg: ModelConfig
    cfg: MCTSConfig
    value_fn: Callable[[np.ndarray], float]
    cached_encoder: bool = True
    record_trace: bool = False   # keep per-iteration traces in self.traces
    device: Any = "cuda"
    mesh: Optional[Mesh] = None  # shard the lockstep trees over its data axis

    def __post_init__(self):
        if self.mesh is None:
            self.device = resolve_device(self.device)
            self._shard_searches = [self]
        else:
            self.device = self.mesh.devices[0]
            # One search per local device, on its copies of the models;
            # shards on one device share it.
            per_device = {}
            for dev, dt, denoise in zip(
                    self.mesh.devices, replicate(self.dt, self.mesh),
                    replicate(self.denoise, self.mesh)):
                if dev not in per_device:
                    per_device[dev] = dataclasses.replace(
                        self, dt=dt, denoise=denoise, device=dev, mesh=None)
            self._shard_searches = [per_device[d] for d in self.mesh.devices]
        self._dt_apply = make_dt_apply(self.dt)
        self._encode = self._dt_embed_apply = None
        if self.cached_encoder:
            self._encode = make_state_encode(self.dt)
            self._dt_embed_apply = make_dt_embed_apply(self._dt_apply)
        self._policy_step = make_policy_step(self._dt_apply, self.model_cfg,
                                             self._dt_embed_apply)
        self.traces: Optional[List[List[Dict[str, Any]]]] = None

    def local_padded_count(self, n: int) -> int:
        """The number of trees after ``n`` local records are padded to this
        process's share of the mesh's data axis: the layout that callers
        who put gathered outputs back in global order rely on."""
        if self.mesh is None:
            return n
        unit = max(1, self.mesh.shape["data"] // self.mesh.data_processes)
        return n + (-n) % unit

    def _prepare_batch(self, records: Sequence,
                       seeds: Optional[Sequence[int]]):
        """The default per-tree seeds, and the mesh padding (copies of the
        last record and seed). Returns (records, seeds, trees to keep)."""
        if not records:
            raise ValueError("run_batch needs at least one record "
                             "(empty evaluation directory?)")
        n_out = len(records)
        if seeds is None:
            seeds = [self.cfg.seed + i for i in range(n_out)]
        pad = self.local_padded_count(n_out) - n_out
        return (list(records) + [records[-1]] * pad,
                list(seeds) + [seeds[-1]] * pad, n_out)

    def _shards(self, n: int) -> List[Tuple["MCTS", int, int]]:
        """(search, first tree, end) of each local shard of ``n`` padded
        trees, in shard order."""
        per = n // len(self._shard_searches)
        return [(m, i * per, (i + 1) * per)
                for i, m in enumerate(self._shard_searches)]

    @torch.no_grad()
    def _seed_bufs(self, policy_x0: torch.Tensor, rtg0: torch.Tensor,
                   task: torch.Tensor) -> EvalBuffers:
        """A root's buffers: its observation ``policy_x0`` (B, H*W) and RTG
        at slot 0 (:func:`seed_buffers`), on the search's device."""
        dev = self.device
        x = torch.as_tensor(policy_x0, device=dev)
        return seed_buffers(
            self.model_cfg, x.reshape(x.shape[0], -1).float(),
            torch.as_tensor(rtg0, dtype=torch.float32, device=dev),
            torch.as_tensor(task, device=dev).reshape(-1)[:x.shape[0]],
            self.cfg.max_timesteps, self._encode)

    def _expand_step(self, state: CSMRIState, action) -> CSMRIState:
        """The expansion's env step. ``done`` is cleared on its output: the
        stop flag is re-decided from each step's own action, so a node
        stepped with a stop action still steps under its children's."""
        out = admm_step(self.denoise, state, action)
        return out.replace(done=torch.zeros_like(out.done))

    def _expand(self, env_state: CSMRIState, action_dict,
                sig_samples: torch.Tensor, mu_samples: torch.Tensor
                ) -> CSMRIState:
        """One batched env step over (children + 1) slots per tree: slot 0
        the policy's own action ``action_dict`` ({k: (n,)}), slots 1.. the
        sampled children (``sig_samples``, ``mu_samples``: (n, k))."""
        slots = sig_samples.shape[1] + 1
        tiled = CSMRIState(**{
            f.name: getattr(env_state, f.name).repeat_interleave(slots, 0)
            for f in dataclasses.fields(CSMRIState)})
        return self._expand_step(tiled, {
            "T": action_dict["T"].repeat_interleave(slots),
            "sigma_d": torch.cat([action_dict["sigma_d"][:, None],
                                  sig_samples], 1).reshape(-1),
            "mu": torch.cat([action_dict["mu"][:, None], mu_samples],
                            1).reshape(-1)})

    def _child_bufs(self, bufs: EvalBuffers, t: torch.Tensor,
                    ob: torch.Tensor, pred_rtg: torch.Tensor
                    ) -> EvalBuffers:
        """The snapshot a leaf's children share: the leaf's buffers with
        its policy action (already at slot t - 1), and its stepped
        observation and predicted RTG at slot t."""
        new = bufs.replace(states=set_slot(bufs.states, t, ob),
                           rtg=set_slot(bufs.rtg, t, pred_rtg[:, None]))
        if self._encode is not None:
            new = new.replace(state_embs=set_slot(
                bufs.state_embs, t, self._encode(ob)))
        return new

    def _search_iter(self, bufs: EvalBuffers, t_vec: torch.Tensor,
                     env_state: CSMRIState, policy_rtg: torch.Tensor,
                     z_sig: torch.Tensor, z_mu: torch.Tensor):
        """One fused search iteration over every tree's leaf (see the
        module docstring)."""
        n, k = bufs.states.shape[0], self.cfg.n_children
        action_vec, action_dict, pred_rtg, bufs_upd = self._policy_step(
            bufs, t_vec)
        sig_samples, _ = fold_sort_batch(action_dict["sigma_d"], z_sig,
                                         self.cfg.sigma_d_std)
        # The children's priors are the mu densities.
        mu_samples, probs = fold_sort_batch(action_dict["mu"], z_mu,
                                            self.cfg.mu_std)
        stepped = self._expand(env_state, action_dict, sig_samples,
                               mu_samples)
        slot0_ob = stepped.x.reshape(n, k + 1, -1)[:, 0]
        new_bufs = self._child_bufs(bufs_upd, t_vec + 1, slot0_ob, pred_rtg)

        final, _, ep_len, _ = greedy_rollout(
            self._dt_apply, self.denoise, self.model_cfg, env_state,
            bufs_upd, action_dict, policy_rtg, self.cfg.max_timesteps,
            t_vec, encode=self._encode, dt_embed_apply=self._dt_embed_apply)
        return (action_vec, pred_rtg, probs, stepped, new_bufs, final.x,
                ep_len)

    @torch.no_grad()
    def expand(self, node: Node, task: int, rng: np.random.Generator,
               index_tree: int) -> Tuple[Node, Dict[str, float], float]:
        """Expand one node, as the JAX package's ``MCTS.expand``: the policy
        step at the node's depth; ``n_children`` sigma_d samples, then as
        many mu samples, drawn from ``rng`` by :func:`sample_actions`; one
        batched env step whose slot 0 (the policy's own action) becomes
        the node's policy state and whose slots 1.. become the children,
        with the mu densities as priors. ``node.bufs`` stays as it was;
        the children share one snapshot holding the node's action at its
        slot. ``task`` is carried by the buffers and unused here. Returns
        ``(node, action dict of floats, predicted RTG)``."""
        del task
        k = self.cfg.n_children
        action_vec, action_dict, pred_rtg, bufs_upd = self._policy_step(
            node.bufs, node.time)
        node.action = action_vec[0].cpu().numpy()
        adict = {key: float(v[0]) for key, v in action_dict.items()}
        sig_samples, _ = sample_actions(rng, adict["sigma_d"],
                                        self.cfg.sigma_d_std, k)
        mu_samples, probs = sample_actions(rng, adict["mu"],
                                           self.cfg.mu_std, k)
        stepped = self._expand(
            node.env_state, action_dict,
            torch.from_numpy(sig_samples[None]).to(self.device),
            torch.from_numpy(mu_samples[None]).to(self.device))
        node.set_policy_state(_rows(stepped, 0, 1))
        pred_rtg_f = float(pred_rtg[0])
        shared = self._child_bufs(
            bufs_upd, torch.tensor([node.time + 1], device=self.device),
            node.policy_state.x.reshape(1, -1), pred_rtg)
        for c in range(k):
            child = Node(time=node.time + 1, prob=float(probs[c]),
                         parent=node, edge=c, index=index_tree,
                         env_state=_rows(stepped, c + 1, c + 2),
                         policy_state=node.policy_state,
                         policy_rtg=pred_rtg_f)
            child.bufs = shared
            node.children.append(child)
        return node, adict, pred_rtg_f

    @torch.no_grad()
    def beam_search(self, node: Node, task: int
                    ) -> Tuple[float, np.ndarray, int]:
        """The greedy rollout from ``node`` to the horizon, as the JAX
        package's ``MCTS.beam_search``: ``(value of the final image, the
        final image (1, H, W), episode length)``. ``task`` is carried by
        the buffers and unused here."""
        del task
        _, action_dict, _, bufs = self._policy_step(node.bufs, node.time)
        final, _, ep_len, _ = greedy_rollout(
            self._dt_apply, self.denoise, self.model_cfg, node.env_state,
            bufs, action_dict,
            torch.full((1,), node.policy_rtg, dtype=torch.float32,
                       device=self.device),
            self.cfg.max_timesteps, node.time, encode=self._encode,
            dt_embed_apply=self._dt_embed_apply)
        x = final.x.cpu().numpy().reshape(1, *final.x.shape[-2:])
        return float(self.value_fn(x)), x, int(ep_len[0])

    def _shard_round(self, leaves: List[Node], z: np.ndarray):
        """One shard's fused iteration over its trees' ``leaves`` (z: their
        standard normals); returns the host copies of (actions, predicted
        RTGs, priors, final images) and the device (stepped states, child
        buffers)."""
        dev, k = self.device, self.cfg.n_children
        z = torch.from_numpy(z).to(dev)
        (action_vec, pred_rtg, probs, stepped, child_bufs, finals,
         _) = self._search_iter(
            _cat([n.bufs for n in leaves], EvalBuffers),
            torch.tensor([n.time for n in leaves], device=dev),
            _cat([n.env_state for n in leaves], CSMRIState),
            torch.tensor([n.policy_rtg for n in leaves],
                         dtype=torch.float32, device=dev),
            z[:, :k], z[:, k:])
        return tuple(a.cpu().numpy() for a in (
            action_vec, pred_rtg, probs, finals)) + (stepped, child_bufs)

    def _round(self, i: int, roots: List[Node], rngs, rewards_dicts,
               states_dicts) -> None:
        """Round ``i`` of every tree: select a leaf, expand it (one fused
        iteration per local shard), score its rollout and back the score
        up."""
        k = self.cfg.n_children
        leaves = []
        for root in roots:
            root.s_visits += 1
            node = root
            while node.children:
                node = select_p_ucb(node)
                node.s_visits += 1
            leaves.append(node)

        # The loc-independent standard normals, in the order
        # sample_actions consumes them: k sigma_d draws, then k
        # mu draws, per tree.
        z = np.stack([r.standard_normal(2 * k) for r in rngs])
        shards = self._shards(len(roots))
        outs = run_sharded(
            lambda m, lo, hi: m._shard_round(leaves[lo:hi], z[lo:hi]),
            [m.device for m, _, _ in shards], shards)

        for (_, lo, hi), out in zip(shards, outs):
            action_vec, pred_rtg, probs, finals, stepped, child_bufs = out
            for j, node in enumerate(leaves[lo:hi]):
                node.action = action_vec[j]
                node.policy_state = _rows(stepped, j * (k + 1),
                                          j * (k + 1) + 1)
                shared = _rows(child_bufs, j, j + 1)
                for c in range(k):
                    row = j * (k + 1) + c + 1
                    child = Node(time=node.time + 1,
                                 prob=float(probs[j, c]), parent=node,
                                 edge=c, index=i,
                                 env_state=_rows(stepped, row, row + 1),
                                 policy_state=node.policy_state,
                                 policy_rtg=float(pred_rtg[j]))
                    child.bufs = shared
                    node.children.append(child)

            for j, node in enumerate(leaves[lo:hi], start=lo):
                rep = repr(node)
                if rep in rewards_dicts[j]:
                    reward = rewards_dicts[j][rep]
                else:
                    x = finals[j - lo:j - lo + 1].reshape(
                        1, *finals.shape[-2:])
                    reward = float(self.value_fn(x))
                    rewards_dicts[j][rep] = reward
                    states_dicts[j][rep] = x
                node.backprop(reward)
                if self.record_trace:
                    self.traces[j].append({
                        "iter": i, "time": node.time, "edge": node.edge,
                        "index": node.index,
                        "probs": [c.prob for c in node.children],
                        "reward": reward})

    def run(self, record, seed: Optional[int] = None) -> float:
        """Search one image (a batch of one)."""
        return self.run_batch(
            [record], seeds=[self.cfg.seed if seed is None else seed])[0]

    @torch.no_grad()
    def run_batch(self, records: Sequence, seeds: Optional[Sequence[int]]
                  = None) -> List[float]:
        """Search ``((states, rtg, actions, task), mat)`` records, one tree
        each, in lockstep; per-tree RNG streams are seeded from ``seeds``
        (default ``cfg.seed + i``), so a tree's search does not depend on
        the batch it runs in beyond float reordering. Prints and returns
        each tree's final PSNR. With a mesh it runs in one process only:
        the tree lives on the host, which syncs every round."""
        if self.mesh is not None and process_count() > 1:
            raise ValueError(
                "the host-tree backend syncs host state every iteration "
                "and cannot span processes; use DeviceMCTS "
                "(--tree_backend device) across processes")
        records, seeds, n_out = self._prepare_batch(records, seeds)
        rngs = [np.random.default_rng(s) for s in seeds]
        self.traces = [[] for _ in records] if self.record_trace else None

        roots: List[Node] = []
        rewards_dicts: List[Dict[str, float]] = []
        states_dicts: List[Dict[str, np.ndarray]] = []
        for m, lo, hi in self._shards(len(records)):
            for (_, rtg0, _, task0), mat in records[lo:hi]:
                env_state = reset_from_mat(mat, device=m.device)
                rtg0 = float(np.asarray(rtg0).reshape(-1)[0])
                root = Node(time=0, prob=1.0, parent=None, edge=0, index=0,
                            env_state=env_state, policy_state=env_state,
                            policy_rtg=rtg0)
                # The root observation is the reset state's x (the clipped
                # record x0), not the dataset's policy state.
                root.bufs = m._seed_bufs(
                    env_state.x_real.reshape(1, -1), torch.tensor([rtg0]),
                    torch.from_numpy(np.asarray(task0).reshape(-1)[:1]))
                root.s_visits = 1
                roots.append(root)
                rewards_dicts.append({})
                states_dicts.append({})

        for i in range(self.cfg.iterations):
            with annotate(SEARCH_ROUND.format(i)):
                self._round(i, roots, rngs, rewards_dicts, states_dicts)

        out = []
        # The padded trees are dropped.
        for j, root in enumerate(roots[:n_out]):
            best_key = max(rewards_dicts[j], key=rewards_dicts[j].get)
            best_state = torch.from_numpy(states_dicts[j][best_key])
            gt = root.env_state.gt.cpu().reshape(best_state.shape)
            # PSNR(gt, best) in the JAX search's argument order.
            reward = float(psnr(gt, best_state)[0, 0])
            print("MCTS Reward: ", reward)
            out.append(reward)
        return out


class BatchedMCTS(MCTS):
    """The CLI's name for the lockstep search (:class:`MCTS` batches every
    call; ``run`` is a batch of one)."""


def run_mcts(mcts: MCTS, record, seed: Optional[int] = None) -> float:
    """Functional entry point: search one record."""
    return mcts.run(record, seed=seed)
