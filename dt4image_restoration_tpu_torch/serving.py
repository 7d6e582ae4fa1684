"""Production serving: a batched restoration service on the device.

Counterpart of the JAX package's ``serving.py``. ``RestorationService``
gathers concurrent requests into fixed-size device batches (a partial batch
is padded with copies of its last request), runs them, and resolves each
request's future with its restored image and metrics.

Three modes:
  * ``policy``: Decision-Transformer-guided greedy restoration (the
    ``eval`` path): the fused policy forward (kernel K3) where K3 takes the
    config, else the per-op forward (K4, K5), as the ``Evaluator`` picks;
  * ``fixed``: fixed-(mu, sigma_d) PnP-ADMM, no policy;
  * ``mcts``: the device-resident PUCB tree search of every slice of the
    batch (``inference/mcts_device.py``).

Requests come in on any thread; one worker thread batches and runs them.
With ``pipeline_depth > 1`` (policy and fixed modes) a resolver thread
waits for each batch's results while the worker launches the next batch:
the worker records an event after a batch's last kernel, and a side
stream waiting on that event copies the live rows to pinned host memory,
so the resolver's wait does not queue behind the next batch's kernels.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import Any, Callable, Mapping, Optional

import numpy as np
import torch

from .config import MCTSConfig
from .env.pnp import compute_reward, fixed_param_rollout, reset_from_mat
from .inference.evaluator import (check_policy_forward, greedy_rollout,
                                  initial_policy_setup, policy_forward)
from .models.decision_transformer import (DecisionTransformer,
                                          make_dt_embed_apply,
                                          make_state_encode)
from .training.sharding import (Mesh, process_count, replicate,
                                run_sharded, shard_eval_inputs)
from .utils.device import resolve_device
from .utils.profiling import (SERVE_FILL, SERVE_LAUNCH, SERVE_PERMIT,
                              SERVE_RESOLVE, SERVE_SETTLE, SERVE_WAIT,
                              annotate)


class ServiceOverloaded(RuntimeError):
    """Admission control: the request queue is at ``max_queue_depth``.

    Raised by :meth:`RestorationService.submit`, so that callers can shed
    load or retry elsewhere instead of joining an unbounded queue: at
    saturation the wait in the queue, not the service time, sets the
    tail."""


@dataclasses.dataclass
class RestorationRequest:
    """One slice to restore: the .mat-style record (x0, y0, mask and
    optionally gt) plus the RTG target and task token of policy mode."""
    mat: Mapping[str, Any]
    rtg: float = 0.0
    task: int = 0


@dataclasses.dataclass
class RestorationResult:
    image: np.ndarray          # (H, W) restored slice, clipped to [0, 1]
    psnr_db: Optional[float]   # against gt, if the record carried one
    episode_len: int


def _settle(fut: Future, result=None, exc: Optional[BaseException] = None
            ) -> None:
    """Resolve a future, tolerating a client's cancel(): these futures are
    never marked running, so a caller may cancel one while its batch runs,
    and its batchmates' results must still land (set_result on a cancelled
    future raises InvalidStateError)."""
    if fut.done():
        return
    try:
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(result)
    except InvalidStateError:
        pass  # lost the race to a concurrent cancel()


class RestorationService:
    """Fixed-batch-size restoration server.

    Args:
      denoise: the U-Net denoiser, (B, 1, H, W) image and (B,) sigma ->
        (B, 1, H, W), on ``device``.
      dt: the policy, a ``DecisionTransformer`` on ``device`` (policy and
        mcts modes). On the card, where kernel K3 does not take
        ``dt.cfg``, a ``dt`` built without ``use_pallas`` is refused (the
        per-op forward must run K4 and K5); mcts mode always runs the
        per-op forward and needs ``use_pallas`` there.
      mode: 'policy', 'fixed' or 'mcts'.
      batch_size: the batch every run has; partial batches are padded.
      max_timesteps / mu / sigma_d: the episode length, and the fixed
        mode's ADMM parameters.
      max_delay_s: the least time the worker waits to fill a partial
        batch. The fill window adapts to the backlog: it is
        ``fill_window_frac`` of the running mean of batch turn times
        (capped at ``fill_window_max_s``), floored at ``max_delay_s``, so
        that a cohort of concurrent requests lands in one batch instead of
        several partial ones that each cost a whole turn.
        ``fill_window_frac=0`` keeps the window at ``max_delay_s``.
      max_queue_depth: optional admission bound: ``submit`` raises
        :class:`ServiceOverloaded` (counted in ``stats()['rejected']``)
        when the queue holds this many requests. ``None`` keeps the queue
        unbounded.
      search_cfg / value_fn_batched / node_dtype: mcts mode's search
        configuration (default ``MCTSConfig(max_timesteps=max_timesteps)``),
        batched scorer (default: the proxy) and node storage dtype.
      pipeline_depth: > 1 lets the worker run batch N+1 while a resolver
        thread waits for batch N's results, with at most
        ``pipeline_depth`` batches launched and not yet resolved (a permit
        is taken before a batch is launched and returned once it is
        settled). Policy and fixed modes only.
      device: 'cuda' (default) or 'cpu'.
      mesh: optional ``training/sharding.py:make_mesh`` mesh: each batch is
        split over its local shards (``batch_size`` must be a multiple of
        its data axis), one rollout per shard on a copy of the models on
        the shard's device, and the results are joined; mcts mode passes
        it to the search. One process only: the queue's asynchronous
        batches cannot be coordinated across processes, so run one
        service per process instead. ``device`` is then the mesh's first
        device.
    """

    def __init__(self, denoise: Callable,
                 dt: Optional[DecisionTransformer] = None,
                 mode: str = "policy",
                 batch_size: int = 8, max_timesteps: int = 30,
                 mu: float = 0.5, sigma_d: float = 15.0 / 255.0,
                 max_delay_s: float = 0.01,
                 search_cfg: Optional[MCTSConfig] = None,
                 value_fn_batched: Optional[Callable] = None,
                 node_dtype: str = "float32",
                 pipeline_depth: int = 1,
                 fill_window_frac: float = 0.1,
                 fill_window_max_s: float = 0.5,
                 max_queue_depth: Optional[int] = None,
                 device: Any = "cuda", mesh: Optional[Mesh] = None
                 ) -> None:
        if mode not in ("policy", "mcts", "fixed"):
            raise ValueError(
                f"unknown serving mode {mode!r}; expected one of "
                "'policy', 'mcts', 'fixed'")
        if pipeline_depth < 1:
            raise ValueError(f"pipeline_depth must be >= 1, got "
                             f"{pipeline_depth}")
        if pipeline_depth > 1 and mode == "mcts":
            raise ValueError(
                "pipeline_depth > 1 is for policy/fixed modes; the mcts "
                "search reads its own results back")
        if mode in ("policy", "mcts") and dt is None:
            raise ValueError(f"{mode} mode needs a DecisionTransformer (dt)")
        if fill_window_frac < 0:
            raise ValueError(f"fill_window_frac must be >= 0, got "
                             f"{fill_window_frac}")
        if max_queue_depth is not None and max_queue_depth < 1:
            raise ValueError(f"max_queue_depth must be >= 1, got "
                             f"{max_queue_depth}")
        if mesh is not None:
            if process_count() > 1:
                raise ValueError(
                    "RestorationService mesh sharding is single-process "
                    "only (async queue dispatch cannot be coordinated "
                    "across hosts); run one service per host")
            n_data = mesh.shape["data"]
            if batch_size % n_data:
                raise ValueError(
                    f"batch_size {batch_size} must be a multiple of the "
                    f"mesh data axis ({n_data})")
        self.mesh = mesh
        self.device = resolve_device(device) if mesh is None \
            else mesh.devices[0]
        self.mode = mode
        self.batch_size = batch_size
        self.max_timesteps = max_timesteps
        self.max_delay_s = max_delay_s
        self.fill_window_frac = fill_window_frac
        self.fill_window_max_s = fill_window_max_s
        self.max_queue_depth = max_queue_depth
        self._mu, self._sigma_d = mu, sigma_d
        self._turn_ema_s = 0.0  # running mean of batch turns; 0: none yet
        self._queue: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        # Guards the stop check and the enqueue in submit() against
        # close()'s drain: a request enqueued between the two would never
        # resolve.
        self._submit_lock = threading.Lock()

        devices = [self.device] if mesh is None else list(mesh.devices)
        if mode == "mcts":
            if self.device.type == "cuda" and not dt.cfg.use_pallas:
                raise ValueError(
                    "the search runs the per-op forward, whose kernels K4 "
                    "and K5 run on the card only with "
                    "ModelConfig(use_pallas=True); build the "
                    "DecisionTransformer with it")
            from .inference.mcts_device import DeviceMCTS
            from .models.arniqa import proxy_value_fn
            self._mcts = DeviceMCTS(
                dt=dt, denoise=denoise, model_cfg=dt.cfg,
                cfg=search_cfg or MCTSConfig(max_timesteps=max_timesteps),
                value_fn=proxy_value_fn, value_fn_batched=value_fn_batched,
                node_dtype=node_dtype, device=self.device, mesh=mesh)
        else:
            # Per local shard: (device, denoiser, and in policy mode the
            # policy forward, the state encoder and the forward over cached
            # embeddings); shards on one device share its models.
            denoisers = [denoise] if mesh is None \
                else replicate(denoise, mesh)
            policies = [(None, None, None)] * len(devices)
            if mode == "policy":
                self._cfg = dt.cfg
                forwards = {}
                for dev, dt_i in zip(devices, [dt] if mesh is None
                                     else replicate(dt, mesh)):
                    if dev not in forwards:
                        check_policy_forward(dt_i, dt.cfg, dev)
                        dt_apply = policy_forward(dt_i, dt.cfg)
                        forwards[dev] = (dt_apply, make_state_encode(dt_i),
                                         make_dt_embed_apply(dt_apply))
                policies = [forwards[dev] for dev in devices]
            self._shards = [(dev, den) + policy for dev, den, policy
                            in zip(devices, denoisers, policies)]

        self._stats_lock = threading.Lock()
        self._stats = {"submitted": 0, "completed": 0, "failed": 0,
                       "cancelled": 0, "rejected": 0, "batches": 0,
                       "padded_slots": 0,
                       "latency_sum_ms": 0.0, "latency_max_ms": 0.0}

        self._copy_streams = {dev: torch.cuda.Stream(dev)
                              for dev in dict.fromkeys(devices)
                              if dev.type == "cuda"}
        self._resolve_q: Optional["queue.Queue"] = None
        self._resolver: Optional[threading.Thread] = None
        self._inflight: Optional[threading.Semaphore] = None
        if pipeline_depth > 1:
            # The worker takes a permit BEFORE it launches a batch and the
            # resolver returns it once the batch is settled: at most
            # pipeline_depth launched batches hold device outputs.
            self._inflight = threading.Semaphore(pipeline_depth)
            self._resolve_q = queue.Queue(maxsize=pipeline_depth)
            self._resolver = threading.Thread(target=self._resolve_loop,
                                              daemon=True)
            self._resolver.start()

        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    # -- public API --------------------------------------------------------
    def submit(self, request: RestorationRequest) -> "Future":
        """Enqueue one slice; returns a Future[RestorationResult]. Raises
        ``RuntimeError`` after :meth:`close` (nothing would drain the
        queue) and :class:`ServiceOverloaded` at ``max_queue_depth``."""
        with self._submit_lock:
            if self._stop.is_set():
                raise RuntimeError("RestorationService is closed")
            if (self.max_queue_depth is not None
                    and self._queue.qsize() >= self.max_queue_depth):
                with self._stats_lock:
                    self._stats["rejected"] += 1
                raise ServiceOverloaded(
                    f"queue depth {self._queue.qsize()} >= max_queue_depth "
                    f"{self.max_queue_depth}; shed or retry later")
            fut: Future = Future()
            self._queue.put((request, fut, time.monotonic()))
        with self._stats_lock:
            self._stats["submitted"] += 1
        return fut

    def restore(self, requests, timeout: Optional[float] = None) -> list:
        """Blocking convenience: restore a list of requests, waiting at most
        ``timeout`` seconds for each."""
        futs = [self.submit(r) for r in requests]
        return [f.result(timeout=timeout) for f in futs]

    def stats(self) -> dict:
        """A thread-safe snapshot of the counters: requests submitted,
        completed, failed, cancelled and rejected; batches run and padded
        slots; submit-to-resolve latency mean and max; queue depth."""
        with self._stats_lock:
            out = dict(self._stats)
        done = out["completed"]
        lat_sum = out.pop("latency_sum_ms")  # always: stable key set
        out["latency_mean_ms"] = lat_sum / done if done else 0.0
        out["queue_depth"] = self._queue.qsize()
        return out

    def close(self, timeout: Optional[float] = None) -> None:
        """Stop taking requests, finish the batch in hand (and, pipelined,
        every launched batch), and cancel what is still queued. Raises
        ``TimeoutError`` when a thread does not stop within ``timeout``
        seconds."""
        with self._submit_lock:
            self._stop.set()
        for thread in (self._worker, self._resolver):
            if thread is None:
                continue
            # The worker puts the resolver's drain sentinel on exit, so
            # every launched batch settles before the resolver stops.
            thread.join(timeout)
            if thread.is_alive():
                raise TimeoutError(f"RestorationService: {thread.name} did "
                                   f"not stop within {timeout} s")
        while True:
            try:
                _, fut, _ = self._queue.get_nowait()
            except queue.Empty:
                break
            if fut.cancel():
                with self._stats_lock:
                    self._stats["cancelled"] += 1

    # -- worker --------------------------------------------------------------
    def _fill_window_s(self) -> float:
        """The fill window of a partial batch: ``fill_window_frac`` of the
        running mean turn, floored at ``max_delay_s`` and capped at
        ``fill_window_max_s``; the floor until a turn is measured."""
        return min(max(self.max_delay_s,
                       self._turn_ema_s * self.fill_window_frac),
                   self.fill_window_max_s)

    def _note_turn(self, seconds: float) -> None:
        self._turn_ema_s = (seconds if self._turn_ema_s == 0.0
                            else 0.5 * self._turn_ema_s + 0.5 * seconds)

    def _collect(self):
        items = []
        try:
            with annotate(SERVE_WAIT):
                items.append(self._queue.get(timeout=0.05))
        except queue.Empty:
            return items
        # One window from the FIRST item, not a timeout per item.
        deadline = time.monotonic() + self._fill_window_s()
        with annotate(SERVE_FILL):
            while len(items) < self.batch_size:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    items.append(self._queue.get(timeout=remaining))
                except queue.Empty:
                    break
        return items

    def _loop(self) -> None:
        # Grad mode is per thread: a no_grad around the constructor does not
        # reach this one.
        with torch.no_grad():
            while not self._stop.is_set():
                items = self._collect()
                if items:
                    self._serve(items)
        if self._resolve_q is not None:
            self._resolve_q.put(None)  # the drain sentinel for close()

    def _serve(self, items) -> None:
        requests = [req for req, _, _ in items]
        if self._resolve_q is not None:
            # Pipelined: launch here, wait on the resolver thread. The
            # resolver returns the permit once the batch settles (or it
            # is returned here if the launch fails).
            with annotate(SERVE_PERMIT):
                self._inflight.acquire()
            try:
                with annotate(SERVE_LAUNCH):
                    handle = self._dispatch_batch(requests)
            except Exception as exc:
                self._inflight.release()
                self._settle_batch(items, exc=exc)
            else:
                self._resolve_q.put((items, handle, time.monotonic()))
            return
        t0 = time.monotonic()
        try:
            with annotate(SERVE_LAUNCH):
                results = self._run_batch(requests)
        except Exception as exc:
            self._settle_batch(items, exc=exc)
        else:
            self._note_turn(time.monotonic() - t0)
            self._settle_batch(items, results)

    def _resolve_loop(self) -> None:
        with torch.no_grad():
            while True:
                entry = self._resolve_q.get()
                if entry is None:
                    return
                items, handle, t_dispatch = entry
                try:
                    try:
                        results = self._finalize_batch(handle)
                    except Exception as exc:
                        self._settle_batch(items, exc=exc)
                    else:
                        # Launch to settled, queue wait included: the
                        # turn's pace under pipelining.
                        self._note_turn(time.monotonic() - t_dispatch)
                        self._settle_batch(items, results)
                finally:
                    self._inflight.release()

    def _settle_batch(self, items, results=None, exc=None) -> None:
        """Resolve one batch's futures and update the counters."""
        with annotate(SERVE_SETTLE):
            now = time.monotonic()
            with self._stats_lock:
                self._stats["batches"] += 1
                self._stats["padded_slots"] += self.batch_size - len(items)
            for i, (_, fut, t0) in enumerate(items):
                if exc is not None:
                    _settle(fut, exc=exc)
                else:
                    _settle(fut, results[i])
                lat_ms = 1e3 * (now - t0)
                with self._stats_lock:
                    if fut.cancelled():
                        self._stats["cancelled"] += 1
                    elif exc is not None:
                        self._stats["failed"] += 1
                    else:
                        self._stats["completed"] += 1
                        self._stats["latency_sum_ms"] += lat_ms
                        self._stats["latency_max_ms"] = max(
                            self._stats["latency_max_ms"], lat_ms)

    def _run_batch(self, requests) -> list:
        if self.mode == "mcts":
            return self._run_mcts_batch(requests)
        return self._finalize_batch(self._dispatch_batch(requests))

    def _prepare_mats(self, requests):
        """Pad to the batch size and stack the .mat records."""
        n = len(requests)
        padded = list(requests) + [requests[-1]] * (self.batch_size - n)
        # Per request: a gt-less neighbour must not suppress another
        # request's PSNR.
        has_gt = ["gt" in r.mat for r in requests]
        mats = {k: np.concatenate([np.asarray(r.mat[k]) for r in padded])
                for k in ("x0", "y0", "mask")}
        # Without gt (production) the env carries zeros and the PSNR is not
        # reported.
        mats["gt"] = np.concatenate(
            [np.asarray(r.mat["gt"]) if "gt" in r.mat
             else np.zeros(np.asarray(r.mat["mask"]).shape, np.float32)
             for r in padded])
        # The eval dataset clips x0 at 0 before the env reads it.
        mats["x0"] = np.clip(mats["x0"], 0, None)
        return n, padded, has_gt, mats

    def _run_mcts_batch(self, requests) -> list:
        # One seed for every request keeps a result independent of its
        # batchmates (the trees run in lockstep but apart).
        n, padded, has_gt, mats = self._prepare_mats(requests)
        recs = [((None, np.float32(r.rtg), None, np.int32(r.task)),
                 {k: v[i:i + 1] for k, v in mats.items()})
                for i, r in enumerate(padded)]
        results = self._mcts.run_batch(
            recs, seeds=[self._mcts.cfg.seed] * len(recs), detailed=True,
            verbose=False)[:n]
        return [RestorationResult(
            image=np.clip(res["image"], 0.0, 1.0),
            psnr_db=res["reward"] if has_gt[i] else None,
            episode_len=res["episode_len"])
            for i, res in enumerate(results)]

    def _launch(self, denoise, dt_apply, encode, dt_embed_apply, env_state,
                policy_x0=None, rtg0=None, task=None):
        """One shard's policy or fixed rollout: (final images (B, H, W),
        reward (B,), episode lengths (B,)), on its device."""
        if self.mode == "policy":
            bufs, _, action_dict, pred_rtg = initial_policy_setup(
                dt_apply, self._cfg, policy_x0, rtg0, task,
                self.max_timesteps, encode=encode)
            final, reward, ep_len, _ = greedy_rollout(
                dt_apply, denoise, self._cfg, env_state, bufs, action_dict,
                pred_rtg, self.max_timesteps, encode=encode,
                dt_embed_apply=dt_embed_apply)
        else:
            final, _ = fixed_param_rollout(denoise, env_state, self._mu,
                                           self._sigma_d, self.max_timesteps)
            reward = compute_reward(final)
            ep_len = torch.full((env_state.batch,), self.max_timesteps,
                                dtype=torch.long, device=final.x.device)
        return final.x[:, 0], reward[:, 0], ep_len

    def _copy_live(self, dev, live):
        """Launch the copy of one shard's live rows to pinned host memory
        on ``dev``'s side stream; returns (host tensors, the copy's event),
        the event None off the card."""
        stream = self._copy_streams.get(dev)
        if stream is None:
            return live, None
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(dev))
        stream.wait_event(done)
        host = []
        with torch.cuda.stream(stream):
            for t in live:
                # The copy stream reads these; keep their memory from the
                # next batch until it has.
                t.record_stream(stream)
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                host.append(h)
            copied = torch.cuda.Event()
            copied.record()
        return tuple(host), copied

    def _dispatch_batch(self, requests):
        """Launch one policy or fixed batch (split over the mesh's local
        shards, if any) and the copy of its live rows to the host; returns
        the handle :meth:`_finalize_batch` waits on."""
        n, padded, has_gt, mats = self._prepare_mats(requests)
        policy = ()
        if self.mode == "policy":
            # The policy's first observation is the UNCLIPPED x0, as in the
            # eval dataset (the clip applies to the env's record only).
            policy = (torch.from_numpy(np.stack(
                [np.asarray(r.mat["x0"], np.float32)[..., 0].reshape(-1)
                 for r in padded])),
                torch.tensor([float(r.rtg) for r in padded],
                             dtype=torch.float32),
                torch.tensor([int(r.task) for r in padded]))
        inputs = shard_eval_inputs(
            (reset_from_mat(mats, device="cpu"),) + policy, self.mesh,
            device=self.device)
        devices = [shard[0] for shard in self._shards]
        outs = run_sharded(self._launch, devices,
                           [shard[1:] + inp for shard, inp in
                            zip(self._shards, inputs)])
        # Only the live rows go to the host.
        per = self.batch_size // len(devices)
        copies = [self._copy_live(dev, tuple(
            t[:max(0, min(per, n - i * per))] for t in out))
            for i, (dev, out) in enumerate(zip(devices, outs))]
        return copies, has_gt

    def _finalize_batch(self, handle) -> list:
        """Wait for one launched batch's copies and build its results."""
        copies, has_gt = handle
        with annotate(SERVE_RESOLVE):
            for _, copied in copies:
                if copied is not None:
                    copied.synchronize()
            images, reward, ep_len = (
                np.concatenate([host[k].numpy() for host, _ in copies])
                for k in range(3))
            return [RestorationResult(
                image=np.clip(images[i], 0.0, 1.0),
                psnr_db=float(reward[i]) if has_gt[i] else None,
                episode_len=int(ep_len[i])) for i in range(len(has_gt))]
