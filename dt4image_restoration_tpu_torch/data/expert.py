"""Scripted-expert corpus recording: training and evaluation data with no
download (the port's counterpart of the JAX package's ``data/expert.py``).

The reference's trajectory dataset is email-gated and its eval ``.mat`` sets
are download-gated (reference README.md:9-39). This module writes both in
the reference's on-disk layouts by rolling the port's PnP-ADMM environment
under a scripted expert policy:

* training corpus: one JSON per trajectory (``RTG`` increment-to-go,
  ``Actions`` dict of the three parameter series, ``State Paths`` into a
  shared HDF5 of uint8 observations, ``Task``), what ``TrainingDataset``
  reads;
* evaluation directories: ``evaluation/image_dir/vanilla/{A}_{S}/
  img_{A}_{S}_s{i}.mat`` records (x0/y0/mask/ATy0/gt), the layout the
  eval/flex/mcts verbs scan.

For the "optimal" experiment the task name sets the physics: ``{A}x_{S}``
is A-fold undersampling with S/255 k-space noise, so the nine task tokens
are nine different inverse problems.

The device work and the file writing are apart: :func:`expert_trajectories`
rolls the expert ``batch_chunk`` trajectories at a time on the device and
yields them in memory; :func:`record_expert_corpus` writes what it yields
(``h5py`` is imported there only). ``python -m
dt4image_restoration_tpu_torch.tools.make_dataset`` is the command line.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import (Callable, Dict, Iterator, List, Mapping, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from ..config import (EVAL_DIR_TOKENS, IMAGE_SIZE, OPTIMAL_TASKS,
                      tasks_for_experiment)
from ..env.pnp import admm_step, compute_reward, get_policy_ob, reset_from_mat
from ..utils.device import resolve_device
from .synthetic import make_mat_record

ACTION_KEYS = ("T", "sigma_d", "mu")
# The reference's reader drops a 10-character prefix of each state path to
# form the h5 key (reference dataset/datasets.py:49-54).
STATE_PATH_PREFIX = "0123456789"


def scripted_expert_action(t: int, ep_len: int) -> Dict[str, float]:
    """Hand-tuned restoration schedule: denoiser strength decays from
    25/255 as the iterate cleans up, data-consistency weight fixed at 0.5,
    stop (T > 0.5) on the final step."""
    if t == ep_len - 1:
        return {"T": 0.9, "sigma_d": 8 / 255.0, "mu": 0.5}
    return {"T": 0.02 * t, "sigma_d": (25.0 - 2.0 * t) / 255.0, "mu": 0.5}


def task_physics(task: str) -> Tuple[int, float]:
    """(acceleration, noise_sigma) encoded by an optimal-experiment task
    name ``{A}x_{S}`` / eval dir name ``{A}_{S}``; flex tasks (``rtg_*``)
    fall back to the 4x/15 default physics."""
    m = re.fullmatch(r"(\d+)x?_(\d+(?:\.\d+)?)", task)
    if m is None:
        return 4, 15.0
    return int(m.group(1)), float(m.group(2))


def expert_record(i: int, tasks: Sequence[str], *, size: int = IMAGE_SIZE,
                  seed: int = 0, physics_from_task: bool = True
                  ) -> Tuple[Optional[str], Dict[str, np.ndarray]]:
    """Trajectory ``i``'s task label and the ``.mat`` record it starts
    from, with ``x0`` clipped at 0. The label is None for an ``rtg_*``
    vocabulary: such a name carries no physics, so the physics cycles
    over ``OPTIMAL_TASKS`` and the recorder labels the trajectory by the
    gain it achieves."""
    if all(str(t).startswith("rtg_") for t in tasks):
        task, physics = None, OPTIMAL_TASKS[i % len(OPTIMAL_TASKS)]
    else:
        task = physics = tasks[i % len(tasks)]
    acc, noise = task_physics(physics) if physics_from_task else (4, 0.0)
    mat = dict(make_mat_record(size=size, acceleration=acc,
                               noise_sigma=noise, seed=seed + i))
    mat["x0"] = np.clip(mat["x0"], 0, None)
    return task, mat


@torch.no_grad()
def rollout_expert(step_fn: Callable, mat: Mapping[str, np.ndarray],
                   ep_len: int,
                   expert_fn: Callable[[int, int], Dict[str, float]]
                   = scripted_expert_action, device="cuda"):
    """Roll the scripted expert in the environment, one slice, one step at
    a time.

    ``step_fn(state, action dict of (1,) tensors) -> state``, e.g. an
    ``admm_step`` closure. ``expert_fn(t, ep_len) -> action dict``. Returns
    ``(obs, actions, psnrs)`` as numpy: ``obs`` has one flattened policy
    observation per acted step and ``psnrs`` ``ep_len + 1`` entries
    (initial and after each step).
    """
    dev = resolve_device(device)
    state = reset_from_mat(mat, device=dev)
    obs = [get_policy_ob(state)[0].cpu().numpy()]
    psnrs = [float(compute_reward(state)[0, 0])]
    actions: List[Dict[str, float]] = []
    for t in range(ep_len):
        a = expert_fn(t, ep_len)
        actions.append(a)
        state = step_fn(state, {
            k: torch.full((1,), v, dtype=torch.float32, device=dev)
            for k, v in a.items()})
        psnrs.append(float(compute_reward(state)[0, 0]))
        if t < ep_len - 1:
            obs.append(get_policy_ob(state)[0].cpu().numpy())
    return obs, actions, psnrs


@torch.no_grad()
def roll_expert_chunk(denoise: Callable, mats: Sequence[Mapping],
                      schedule: Sequence[Mapping[str, float]], device
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """One batched episode of ``len(schedule)`` steps over ``mats`` on
    ``device``: observations and PSNRs stay there until the episode ends,
    then come to the host in one copy. Returns ``obs`` (ep_len, B, H*W),
    the observation before each acted step, and ``psnrs`` (ep_len + 1,
    B)."""
    stacked = {k: np.concatenate([m[k] for m in mats])
               for k in ("x0", "y0", "mask", "gt")}
    state = reset_from_mat(stacked, device=device)
    acts = {k: torch.tensor([a[k] for a in schedule], dtype=torch.float32,
                            device=device) for k in ACTION_KEYS}
    ep_len, b = len(schedule), state.batch
    obs, psnrs = [get_policy_ob(state)], [compute_reward(state)[:, 0]]
    for t in range(ep_len):
        state = admm_step(denoise, state, {k: v[t] for k, v in acts.items()})
        psnrs.append(compute_reward(state)[:, 0])
        # The observation after the final step is never acted on.
        if t < ep_len - 1:
            obs.append(get_policy_ob(state))
    flat = torch.cat([torch.stack(obs).reshape(-1),
                      torch.stack(psnrs).reshape(-1)]).cpu().numpy()
    n_obs = ep_len * b * obs[0].shape[1]
    return (flat[:n_obs].reshape(ep_len, b, -1),
            flat[n_obs:].reshape(ep_len + 1, b))


@dataclasses.dataclass
class ExpertTrajectory:
    """One recorded trajectory, in memory."""
    index: int
    task: str
    rtg: List[float]                 # increment-to-go, ep_len entries
    actions: Dict[str, List[float]]  # ACTION_KEYS -> ep_len values
    states: np.ndarray               # (ep_len, H, W) uint8 observations
    psnrs: List[float]               # initial and after each step


def expert_trajectories(denoise: Callable, *, n_traj: int = 64,
                        ep_len: int = 8, experiment: str = "optimal",
                        seed: int = 0, size: int = IMAGE_SIZE,
                        tasks: Optional[Sequence[str]] = None,
                        physics_from_task: bool = True,
                        expert_fn: Callable[[int, int], Dict[str, float]]
                        = scripted_expert_action,
                        batch_chunk: int = 128,
                        progress: Optional[Callable[[str], None]] = None,
                        device="cuda") -> Iterator[ExpertTrajectory]:
    """Yield ``n_traj`` expert trajectories in order, rolled
    ``batch_chunk`` at a time by :func:`roll_expert_chunk` (the expert's
    schedule depends only on the step, so a chunk is one batched episode;
    a trajectory matches :func:`rollout_expert` up to the float
    reassociation of batched convolutions). Trajectories cycle through
    ``tasks`` (default: the experiment's vocabulary); see
    :func:`expert_record` for the physics and the ``rtg_*`` labels."""
    dev = resolve_device(device)
    if tasks is None:
        tasks, _ = tasks_for_experiment(experiment)
    schedule = [expert_fn(t, ep_len) for t in range(ep_len)]
    actions = {k: [float(a[k]) for a in schedule] for k in ACTION_KEYS}
    for lo in range(0, n_traj, batch_chunk):
        idx = range(lo, min(lo + batch_chunk, n_traj))
        labels, mats = zip(*(expert_record(
            i, tasks, size=size, seed=seed,
            physics_from_task=physics_from_task) for i in idx))
        obs, psnrs = roll_expert_chunk(denoise, mats, schedule, dev)
        for j, i in enumerate(idx):
            traj_psnrs = [float(p) for p in psnrs[:, j]]
            gain = traj_psnrs[-1] - traj_psnrs[0]
            task = labels[j]
            if task is None:   # the nearest rtg_* bucket to the gain
                task = min(tasks, key=lambda t: abs(
                    float(t.split("_", 1)[1]) - gain))
            states = (np.clip(obs[:, j].reshape(ep_len, size, size), 0, 1)
                      * 255).astype(np.uint8)
            yield ExpertTrajectory(
                index=i, task=task,
                rtg=[traj_psnrs[-1] - p for p in traj_psnrs[:ep_len]],
                actions=actions, states=states, psnrs=traj_psnrs)
        if progress:
            progress(f"recorded {idx[-1] + 1}/{n_traj} trajectories")


def record_expert_corpus(root: str, denoise: Callable, *,
                         n_traj: int = 64, ep_len: int = 8,
                         experiment: str = "optimal", seed: int = 0,
                         size: int = IMAGE_SIZE,
                         tasks: Optional[Sequence[str]] = None,
                         physics_from_task: bool = True,
                         expert_fn: Callable[[int, int], Dict[str, float]]
                         = scripted_expert_action,
                         batch_chunk: int = 128,
                         progress: Optional[Callable[[str], None]] = None,
                         device="cuda") -> Dict[str, object]:
    """Write ``<root>/trajs/traj_<i>.json`` and ``<root>/states.h5`` (keys
    ``traj<i>/s<t>``) from :func:`expert_trajectories`.

    ``denoise(img, sigma)`` is the plug-in prior (e.g. a
    ``UNetDenoiser``). A rerun removes this recorder's earlier
    ``traj_<i>.json`` files, whose h5 keys the rewritten ``states.h5`` no
    longer holds, and leaves every other file alone. With
    ``physics_from_task`` off every trajectory gets the 4x noiseless
    physics. Returns stats with the expert's mean PSNR increment, the
    target a trained policy should recover.
    """
    import h5py

    resolve_device(device)     # refuse a missing GPU before any file work
    traj_dir = os.path.join(root, "trajs")
    os.makedirs(traj_dir, exist_ok=True)
    for stale in os.listdir(traj_dir):
        if re.fullmatch(r"traj_\d+\.json", stale):
            os.remove(os.path.join(traj_dir, stale))
    h5_path = os.path.join(root, "states.h5")
    gains: List[float] = []
    with h5py.File(h5_path, "w") as f:
        for traj in expert_trajectories(
                denoise, n_traj=n_traj, ep_len=ep_len, experiment=experiment,
                seed=seed, size=size, tasks=tasks,
                physics_from_task=physics_from_task, expert_fn=expert_fn,
                batch_chunk=batch_chunk, progress=progress, device=device):
            paths = []
            for t, img in enumerate(traj.states):
                key = f"traj{traj.index}/s{t}"
                f.create_dataset(key, data=img)
                paths.append(STATE_PATH_PREFIX + key)
            with open(os.path.join(traj_dir, f"traj_{traj.index}.json"),
                      "w") as jf:
                json.dump({"RTG": traj.rtg, "Actions": traj.actions,
                           "State Paths": paths, "Task": traj.task}, jf)
            gains.append(traj.psnrs[-1] - traj.psnrs[0])
    return {"traj_dir": traj_dir, "h5_path": h5_path, "n_traj": n_traj,
            "ep_len": ep_len, "experiment": experiment,
            "expert_increment_db": float(np.mean(gains))}


def make_eval_dirs(root: str, *, per_dir: int = 7,
                   dirs: Optional[Sequence[str]] = None,
                   size: int = IMAGE_SIZE, seed: int = 0) -> List[str]:
    """Write the ``evaluation/image_dir/vanilla/{A}_{S}/`` eval directories
    (default: the nine of ``config.EVAL_DIR_TOKENS``, the CLI's default
    list) of ``per_dir`` ``.mat`` records each under ``root``; the
    evaluator averages the first seven of a directory. Returns the
    directories."""
    import zlib

    from scipy.io import savemat

    out = []
    for d in (EVAL_DIR_TOKENS if dirs is None else dirs):
        acc, noise = task_physics(d)
        # A seed block keyed by the name: no two names collide (acc + noise
        # would) and the list's order does not matter.
        base = seed + (zlib.crc32(d.encode()) % 1_000_003) * 1000
        full = os.path.join(root, "evaluation", "image_dir", "vanilla", d)
        os.makedirs(full, exist_ok=True)
        # A rerun with fewer records or another seed must not leave
        # records of the previous run among the first seven; only this
        # generator's img_{d}_s<i>.mat files are removed.
        for stale in os.listdir(full):
            if re.fullmatch(rf"img_{re.escape(d)}_s\d+\.mat", stale):
                os.remove(os.path.join(full, stale))
        for i in range(per_dir):
            rec = make_mat_record(size=size, acceleration=acc,
                                  noise_sigma=noise, seed=base + i)
            savemat(os.path.join(full, f"img_{d}_s{i}.mat"), rec)
        out.append(full)
    return out
