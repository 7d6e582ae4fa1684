"""Command line of the PyTorch/CUDA port: training, greedy evaluation and
tree search.

    python -m dt4image_restoration_tpu_torch --block_size 18 train \\
        --batch_size 48 --save_every 1 --max_epochs 5
    python -m dt4image_restoration_tpu_torch --block_size 18 --n_embeds 9 \\
        eval --rtg 10 --max_timesteps 30
    python -m dt4image_restoration_tpu_torch --block_size 18 --n_embeds 6 \\
        flex --max_timesteps 30
    python -m dt4image_restoration_tpu_torch --block_size 18 --n_embeds 9 \\
        mcts --rtg 5 --max_timesteps 30

Flags follow the JAX package's ``main.py`` for these modes; ``--device``
(default ``cuda``) picks the device, and ``cpu`` must be asked for; the JAX
CLI's ``--platform {default,cpu}`` is taken as an alias of it. A missing
checkpoint is replaced by random weights with a warning. ``eval`` and
``flex`` run the fused policy forward (kernel K3) where K3 takes the
config (``--block_size`` up to 32 at the published widths) and the per-op
forward with kernels K4 and K5 above that, and say which on stderr;
``mcts`` runs the per-op forward with K4 and K5 and scores leaves with
ARNIQA when ``--arniqa_ckpt`` names a hub checkpoint, else with the proxy
scorer; its tree lives on the device (``--tree_backend device``, the
default, with ``--node_dtype``) or on the host (``--tree_backend host``,
and ``--sequential``, one image at a time). K4 takes every
``--block_size`` that ``max_timestep`` 30 allows.
``eval``, ``flex`` and ``mcts`` take ``--dtype bfloat16`` (the policy, the
denoiser and the ARNIQA scorer compute in bfloat16; the ADMM state stays
float32) and ``--unet_packed`` (the U-Net's execution mode; every mode runs
the same weights). The port's default mode is ``pallas``, the U-Net's two
full-resolution blocks as kernel K1 (in bfloat16 under ``--dtype
bfloat16``); the JAX CLI's default is ``none``.
``eval``, ``flex`` and ``mcts`` shard their images (or trees) over every
local GPU, as the JAX verbs shard over every local device; under
``torchrun`` (``WORLD_SIZE`` > 1) each process takes its own slice of the
records on its own GPU and every process prints the one-process output:

    torchrun --nproc_per_node 2 -m dt4image_restoration_tpu_torch \
        --block_size 18 --n_embeds 9 eval --rtg 10

``train`` reads trajectory jsons and an HDF5 state file (h5py), trains the
Decision Transformer without the kernels (they have no backward), and
writes ``model_<epoch>.pt`` in the reference's layout (which ``eval
--checkpoint`` reads) and ``state_latest.pt`` (``--resume``). Under
``torchrun`` it trains data-parallel, one process per device, with
``--batch_size`` per process.

With ``DT4IR_TRACE_DIR`` set to a directory, the verb runs under
``torch.profiler`` and its Chrome trace is written there as ``trace.json``
(``utils/profiling.py:trace_if_enabled``).
"""
from __future__ import annotations

import argparse
import contextlib
import glob
import os
import sys

from .config import DENOISER_ARCHS, EVAL_DIR_TOKENS
from .models.unet import UNET_MODES
from .utils.profiling import trace_if_enabled

EVAL_DIRS_9 = [f"evaluation/image_dir/vanilla/{t}/" for t in EVAL_DIR_TOKENS]
EVAL_DIRS_6 = EVAL_DIRS_9[:6]
FLEX_RTGS = [1.5, 3, 3.5, 4, 4.5]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m dt4image_restoration_tpu_torch",
        description="Decision Transformer for PnP-ADMM CSMRI (PyTorch/CUDA)")
    p.add_argument("--block_size", type=int, required=True)
    p.add_argument("--n_embeds", type=int, default=9)
    p.add_argument("--device", default=None,
                   help="torch device, the port's own flag (default "
                        "cuda); 'cpu' runs the kernels' plain PyTorch "
                        "versions")
    p.add_argument("--platform", default=None, choices=["default", "cpu"],
                   help="the JAX CLI's flag, an alias of --device: "
                        "'default' is cuda, 'cpu' is cpu; giving both "
                        "flags with different devices is an error")
    sub = p.add_subparsers(dest="mode", required=True)

    t = sub.add_parser("train")
    t.add_argument("--batch_size", type=int, required=True,
                   help="per process")
    t.add_argument("--ddp", action="store_true",
                   help="accepted for parity with the JAX CLI; under "
                        "torchrun the run is always data-parallel")
    t.add_argument("--compile", action="store_true",
                   help="accepted for parity with the JAX CLI; the step "
                        "runs eagerly")
    t.add_argument("--save_every", type=int, required=True)
    t.add_argument("--max_epochs", type=int, required=True)
    t.add_argument("--training_type", default="optimal",
                   choices=["optimal", "flexible"])
    t.add_argument("--data_dir", default="dataset/data/new_json_folder")
    t.add_argument("--state_file", default="dataset/data/data_1_410.h5")
    t.add_argument("--checkpoint_dir", default="checkpoints")
    t.add_argument("--resume", default=None,
                   help="path of a state_latest.pt to resume from")
    t.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="compute dtype of forward and loss (bfloat16: "
                        "autocast, float32 parameters and optimizer)")
    t.add_argument("--keep_last", type=int, default=None,
                   help="keep only the newest N model_<epoch>.pt (default: "
                        "all); state_latest.pt is never removed")
    t.add_argument("--async_save", action="store_true",
                   help="epoch checkpoints on a background writer "
                        "(preemption saves stay synchronous)")
    t.add_argument("--preload_data", action="store_true",
                   help="read every trajectory and uint8 state once and "
                        "gather batch states from memory (the same "
                        "batches)")

    for name, ckpt in (("eval", "checkpoints/model_experiment_2.pt"),
                       ("mcts", "checkpoints/model_experiment_2.pt"),
                       ("flex", "checkpoints/model_experiment_1.pt")):
        s = sub.add_parser(name)
        if name != "flex":
            s.add_argument("--rtg", required=True)
        s.add_argument("--max_timesteps", type=int, default=30)
        s.add_argument("--checkpoint", default=ckpt)
        s.add_argument("--denoiser_ckpt", default=None,
                       help="the prior's checkpoint (default: where its "
                            "project keeps it: "
                            "evaluation/pretrained/unet-nm.pt, "
                            "model_zoo/drunet_gray.pth for drunet, "
                            "Denoising/pretrained_models/"
                            "gaussian_gray_denoising_blind.pth for "
                            "restormer)")
        s.add_argument("--denoiser_arch", default="unet_nm",
                       choices=list(DENOISER_ARCHS),
                       help="the plug-in prior: 'unet_nm' (default), the "
                            "DT4IR U-Net; 'drunet', DPIR's DRUNet "
                            "(DPIR's UNetRes checkpoint layout); "
                            "'restormer', Restormer (restormer_arch.py's "
                            "layout); --unet_packed applies to the U-Net "
                            "alone")
        s.add_argument("--data_dirs", nargs="*", default=None)
        s.add_argument("--data_root", default=None,
                       help="re-root the default eval dir list "
                            "(evaluation/image_dir/vanilla/{A}_{S}) under "
                            "this path; ignored when --data_dirs is given")
        s.add_argument("--dtype", default="float32",
                       choices=["float32", "bfloat16"],
                       help="compute dtype of the DT, the denoiser and the "
                            "value model (the reference's autocast policy); "
                            "parameters and the ADMM state stay float32")
        s.add_argument("--unet_packed", default="pallas",
                       choices=list(UNET_MODES),
                       help="U-Net execution: 'none' = direct convs; "
                            "'s2d' = space-to-depth packed 128^2 stages; "
                            "'pallas' (default) = each 128^2 stage as one "
                            "launch of kernel K1; 'winograd' = every 3x3 "
                            "block as Winograd F(2x2,3x3) products; "
                            "'winograd_deep' = Winograd on the "
                            ">=128-channel blocks only. The same weights "
                            "in every mode, exact up to float "
                            "reassociation (the JAX CLI's default is "
                            "'none')")
        if name == "mcts":
            s.add_argument("--seed", type=int, default=0)
            s.add_argument("--arniqa_ckpt", default=None,
                           help="ARNIQA hub checkpoint scoring the leaves; "
                                "without it the proxy scorer does")
            s.add_argument("--sequential", action="store_true",
                           help="search one image at a time instead of "
                                "batching the trees")
            s.add_argument("--search_batch", type=int, default=16,
                           help="trees searched in lockstep per chunk")
            s.add_argument("--tree_backend", default="device",
                           choices=["device", "host"],
                           help="'device' (default): the tree lives on the "
                                "device as fixed-size arrays and the host "
                                "only launches work; 'host': tree logic on "
                                "the host, one fused device iteration per "
                                "search round")
            s.add_argument("--node_dtype", default="float32",
                           choices=["float32", "bfloat16"],
                           help="storage dtype of the device search's node "
                                "states (bfloat16 halves the search's "
                                "largest allocation; compute stays "
                                "float32)")
    return p


def _existing_dirs(dirs):
    """Directories that exist and hold .mat records; warn about the rest
    and fail when none qualify."""
    existing = [d for d in dirs
                if os.path.isdir(d) and glob.glob(os.path.join(d, "*.mat"))]
    for d in dirs:
        if d not in existing:
            print(f"WARNING: skipping missing/empty eval directory {d!r}",
                  file=sys.stderr)
    if not existing:
        raise FileNotFoundError(
            f"none of the evaluation directories exist (with .mat "
            f"records): {dirs}")
    return existing


def _default_dirs(args, base_dirs):
    if args.data_dirs:
        return args.data_dirs
    root = args.data_root or "."
    return [os.path.join(root, d) for d in base_dirs]


def _eval_mesh(device):
    """The mesh of the eval verbs: None on one device; otherwise every
    local device of every process (every visible GPU of a one-process run
    on ``cuda``, else the process's own device)."""
    import torch

    from .training.sharding import make_mesh, process_count
    if device.type == "cuda" and device.index is None \
            and process_count() == 1:
        local = [torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
    else:
        local = [device]
    if len(local) * process_count() <= 1:
        return None
    return make_mesh(devices=local)


@contextlib.contextmanager
def _process_group(device):
    """The process's device from ``maybe_initialize_distributed``; the
    process group it joins (under ``torchrun``) is left at exit."""
    import torch.distributed as dist

    from .training import maybe_initialize_distributed
    joined = not dist.is_initialized()
    dev = maybe_initialize_distributed(device)
    try:
        yield dev
    finally:
        if joined and dist.is_initialized():
            dist.destroy_process_group()


def _prior_note(args) -> str:
    """How the verb runs its prior, for its stderr line."""
    from .utils.loaders import PRIORS
    if PRIORS[args.denoiser_arch].modes:
        return f"U-Net mode {args.unet_packed}"
    return f"prior {args.denoiser_arch}"


def _load_prior(args, dev):
    """The verb's plug-in prior (``--denoiser_arch``) on ``dev``."""
    from .utils.loaders import PRIORS, load_denoiser
    path = args.denoiser_ckpt or PRIORS[args.denoiser_arch].checkpoint
    return load_denoiser(path, device=dev, dtype=args.dtype,
                         packed=args.unet_packed, arch=args.denoiser_arch)


def _evaluate(args) -> None:
    with _process_group(args.device) as dev:
        _evaluate_on(args, dev, _eval_mesh(dev))


def _evaluate_on(args, dev, mesh) -> None:
    from .config import ModelConfig
    from .inference import Evaluator
    from .models import fused_forward_takes
    from .ops.kernels import transformer as k3
    from .utils.loaders import load_dt

    mode = "flex" if args.mode == "flex" else "norm"
    # The per-op forward, where the Evaluator picks it, with kernels K4
    # (attention) and K5 (LayerNorm); the fused forward ignores the flag.
    cfg = ModelConfig(block_size=args.block_size, n_embeds=args.n_embeds,
                      mode=mode, use_pallas=True, dtype=args.dtype)
    # The Evaluator chooses the forward from the config; say which.
    run = f"dtype {args.dtype}, {_prior_note(args)}"
    if fused_forward_takes(cfg):
        print(f"policy forward: fused (kernel K3); {run}", file=sys.stderr)
    else:
        print(f"policy forward: per-op (kernels K4, K5); {run}; K3 takes up "
              f"to {k3.MAX_TOKENS} tokens at embed_dim {k3.WIDTHS} with "
              f"{k3.CLUSTER} heads, this config has "
              f"{3 * cfg.context_length} tokens at embed_dim "
              f"{cfg.embed_dim} with {cfg.n_heads} heads", file=sys.stderr)
    dirs = _existing_dirs(_default_dirs(
        args, EVAL_DIRS_6 if args.mode == "flex" else EVAL_DIRS_9))
    targets = FLEX_RTGS if args.mode == "flex" else [float(args.rtg)]
    dt = load_dt(cfg, args.checkpoint, device=dev)
    denoiser = _load_prior(args, dev)
    for rtg in targets:
        evaluator = Evaluator(dt=dt, denoise=denoiser, cfg=cfg,
                              max_timesteps=args.max_timesteps or 30,
                              rtg_target=float(rtg), eval_type=mode,
                              device=dev, mesh=mesh)
        if args.mode == "flex":
            print(f"Test for reward increment: {rtg}\n")
            total = evaluator.run(dirs)
            print(f"\nAverage increment: {total / len(dirs)}\n")
        else:
            evaluator.run(dirs)


def _search(args) -> None:
    with _process_group(args.device) as dev:
        _search_on(args, dev, None if args.sequential else _eval_mesh(dev))


def _value_fn_batched(arniqa, mesh, image_size: int, dtype: str):
    """The batched ARNIQA scorer, with a copy of ``arniqa`` on each device
    of ``mesh``: a shard's rollouts are scored on its own device."""
    from .models.arniqa import make_value_fn_batched
    from .training.sharding import replicate
    if mesh is None:
        return make_value_fn_batched(arniqa, image_size, dtype)
    copies = dict(zip(mesh.devices, replicate(arniqa, mesh)))
    scorers = {dev: make_value_fn_batched(copy, image_size, dtype)
               for dev, copy in copies.items()}
    return lambda x: scorers[x.device](x)


def _search_on(args, dev, mesh) -> None:
    from .config import MCTSConfig, ModelConfig
    from .data import EvaluationDataset
    from .inference import MCTS, BatchedMCTS, DeviceMCTS
    from .models.arniqa import (make_value_fn, proxy_value_fn,
                                proxy_value_fn_batched)
    from .training.sharding import process_count
    from .utils.loaders import load_arniqa, load_dt

    rtg_target = float(args.rtg)
    # The per-op forward with kernels K4 (attention) and K5 (LayerNorm).
    cfg = ModelConfig(block_size=args.block_size, n_embeds=args.n_embeds,
                      mode="norm", use_pallas=True, dtype=args.dtype)
    print(f"policy forward: per-op (kernels K4, K5); dtype {args.dtype}, "
          f"{_prior_note(args)}", file=sys.stderr)
    dt = load_dt(cfg, args.checkpoint, device=dev)
    denoiser = _load_prior(args, dev)
    if args.arniqa_ckpt and os.path.exists(args.arniqa_ckpt):
        # The reference's autocast also wraps the ARNIQA scoring.
        arniqa = load_arniqa(args.arniqa_ckpt, dev)
        value_fn = make_value_fn(arniqa, cfg.image_size, args.dtype)
        value_fn_batched = _value_fn_batched(arniqa, mesh, cfg.image_size,
                                             args.dtype)
    else:
        print("WARNING: no ARNIQA checkpoint; using the documented no-ref "
              "proxy scorer", file=sys.stderr)
        value_fn, value_fn_batched = proxy_value_fn, proxy_value_fn_batched
    search_cfg = MCTSConfig(max_timesteps=args.max_timesteps or 30,
                            seed=args.seed)
    common = dict(dt=dt, denoise=denoiser, model_cfg=cfg, cfg=search_cfg,
                  value_fn=value_fn, device=dev)
    if args.sequential:
        mcts = MCTS(**common)
    elif args.tree_backend == "host":
        mcts = BatchedMCTS(mesh=mesh, **common)
    else:
        mcts = DeviceMCTS(value_fn_batched=value_fn_batched,
                          node_dtype=args.node_dtype, mesh=mesh, **common)
    records = []
    for path in _existing_dirs(_default_dirs(args, EVAL_DIRS_9)):
        ds = EvaluationDataset(path, rtg_target=rtg_target, kind="optimal",
                               image_size=cfg.image_size)
        records += [(ds[i], args.seed + i) for i in range(len(ds))]
    b = 1 if args.sequential else args.search_batch
    total = 0.0
    if isinstance(mcts, DeviceMCTS) and mesh is not None \
            and process_count() > 1:
        # Each process searches its own slice of the records; every
        # process prints the one-process lines. The host-tree backend
        # takes the loop below, whose run_batch refuses several processes.
        rewards = mcts.run_global_batches(
            [r for r, _ in records], [s for _, s in records], batch_size=b)
        for v in rewards:
            print("MCTS Reward: ", float(v))
        total = float(sum(rewards))
    else:
        for off in range(0, len(records), b):
            chunk = records[off:off + b]
            total += sum(mcts.run_batch([r for r, _ in chunk],
                                        seeds=[s for _, s in chunk]))
    print("Total MCTS reward:", total)


def _train(args) -> None:
    import numpy as np
    import torch.distributed as dist

    from .config import ModelConfig, TrainerConfig, tasks_for_experiment
    from .data import TrainingDataset
    from .models import DecisionTransformer, init_dt_params
    from .training import (Trainer, init_train_state, make_train_step,
                           make_watch_grad_fn, maybe_initialize_distributed)
    from .training.sharding import process_count, process_index
    from .utils.convert import load_strict
    from .utils.device import resolve_device

    dev = maybe_initialize_distributed(resolve_device(args.device))
    tasks, (min_rtg, max_rtg) = tasks_for_experiment(args.training_type)
    cfg = ModelConfig(block_size=args.block_size, n_embeds=len(tasks),
                      mode="flex" if args.training_type == "flexible"
                      else "norm")
    tcfg = TrainerConfig(batch_size=args.batch_size,
                         max_epochs=args.max_epochs,
                         save_every=args.save_every,
                         checkpoint_dir=args.checkpoint_dir,
                         log_wandb=bool(os.environ.get("WANDB_API_KEY")))
    data_rng = np.random.default_rng(0)
    dataset = TrainingDataset(
        block_size=cfg.context_length, data_dir=args.data_dir,
        action_dim=cfg.action_dim, state_file_path=args.state_file,
        tasks=tasks, min_rtg=min_rtg, max_rtg=max_rtg, rng=data_rng,
        preload=args.preload_data)
    # --batch_size is per process; the global batch is batch_size times
    # the number of processes.
    n_proc, rank = process_count(), process_index()
    max_steps = max((len(dataset) // n_proc) // tcfg.batch_size, 1) \
        * tcfg.max_epochs
    model = load_strict(DecisionTransformer(cfg),
                        init_dt_params(cfg, tcfg.seed), "DT").to(dev)
    os.makedirs(tcfg.checkpoint_dir, exist_ok=True)
    trainer = Trainer(
        train_step=make_train_step(args.dtype),
        state=init_train_state(model, tcfg, max_steps), config=tcfg,
        batches=lambda epoch: dataset.batches(
            tcfg.batch_size, seed=tcfg.seed + epoch, shard_index=rank,
            num_shards=n_proc),
        checkpoint_dir=tcfg.checkpoint_dir, resume_from=args.resume,
        async_save=args.async_save, keep_last=args.keep_last,
        watch_grad_fn=make_watch_grad_fn(model), data_rng=data_rng)
    try:
        trainer.train()
    finally:
        dataset.close()
        if dist.is_initialized():
            dist.destroy_process_group()
    print("Training complete; last losses:", trainer.last_losses)


def _device_flags(parser: argparse.ArgumentParser, args) -> str:
    """The device that ``--device`` and its alias ``--platform`` name
    (default ``cuda``); a parser error when they name different ones."""
    platform = {"default": "cuda", "cpu": "cpu", None: None}[args.platform]
    if args.device is None:
        return platform or "cuda"
    if platform is not None and args.device.split(":")[0] != platform:
        parser.error(f"--device {args.device} and --platform "
                     f"{args.platform} name different devices")
    return args.device


def main(argv=None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    args.device = _device_flags(parser, args)
    with trace_if_enabled():
        if args.mode == "train":
            _train(args)
        elif args.mode == "mcts":
            _search(args)
        else:
            _evaluate(args)


if __name__ == "__main__":
    main()
