"""Command line of the PyTorch/CUDA port: greedy evaluation.

    python -m dt4image_restoration_tpu_torch --block_size 18 --n_embeds 9 \\
        eval --rtg 10 --max_timesteps 30
    python -m dt4image_restoration_tpu_torch --block_size 18 --n_embeds 6 \\
        flex --max_timesteps 30

Flags follow the JAX package's ``main.py`` for these two modes; ``--device``
(default ``cuda``) picks the device, and ``cpu`` must be asked for. A missing
checkpoint is replaced by random weights with a warning.
"""
from __future__ import annotations

import argparse
import glob
import os
import sys

from .config import EVAL_DIR_TOKENS

EVAL_DIRS_9 = [f"evaluation/image_dir/vanilla/{t}/" for t in EVAL_DIR_TOKENS]
EVAL_DIRS_6 = EVAL_DIRS_9[:6]
FLEX_RTGS = [1.5, 3, 3.5, 4, 4.5]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m dt4image_restoration_tpu_torch",
        description="Decision Transformer for PnP-ADMM CSMRI (PyTorch/CUDA)")
    p.add_argument("--block_size", type=int, required=True)
    p.add_argument("--n_embeds", type=int, default=9)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain "
                        "PyTorch versions")
    sub = p.add_subparsers(dest="mode", required=True)
    for name, ckpt in (("eval", "checkpoints/model_experiment_2.pt"),
                       ("flex", "checkpoints/model_experiment_1.pt")):
        s = sub.add_parser(name)
        if name == "eval":
            s.add_argument("--rtg", required=True)
        s.add_argument("--max_timesteps", type=int, default=30)
        s.add_argument("--checkpoint", default=ckpt)
        s.add_argument("--denoiser_ckpt",
                       default="evaluation/pretrained/unet-nm.pt")
        s.add_argument("--data_dirs", nargs="*", default=None)
        s.add_argument("--data_root", default=None,
                       help="re-root the default eval dir list "
                            "(evaluation/image_dir/vanilla/{A}_{S}) under "
                            "this path; ignored when --data_dirs is given")
        s.add_argument("--dtype", default="float32", choices=["float32"],
                       help="compute dtype (the port's kernels are float32)")
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


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    from .config import ModelConfig
    from .inference import Evaluator
    from .utils.loaders import load_denoiser, load_dt

    mode = "flex" if args.mode == "flex" else "norm"
    cfg = ModelConfig(block_size=args.block_size, n_embeds=args.n_embeds,
                      mode=mode)
    dirs = _existing_dirs(_default_dirs(
        args, EVAL_DIRS_6 if args.mode == "flex" else EVAL_DIRS_9))
    targets = FLEX_RTGS if args.mode == "flex" else [float(args.rtg)]
    dt = load_dt(cfg, args.checkpoint, device=args.device)
    denoiser = load_denoiser(args.denoiser_ckpt, device=args.device)
    for rtg in targets:
        evaluator = Evaluator(dt=dt, denoise=denoiser, cfg=cfg,
                              max_timesteps=args.max_timesteps or 30,
                              rtg_target=float(rtg), eval_type=mode,
                              device=args.device)
        if args.mode == "flex":
            print(f"Test for reward increment: {rtg}\n")
            total = evaluator.run(dirs)
            print(f"\nAverage increment: {total / len(dirs)}\n")
        else:
            evaluator.run(dirs)
    if args.mode == "flex":
        # The reference prints the last target's total under this label.
        print("Total MCTS reward:", total)


if __name__ == "__main__":
    main()
