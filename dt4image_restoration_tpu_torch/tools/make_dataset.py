"""Generate training and evaluation data with no download.

The reference's trajectory dataset is email-gated and its eval ``.mat`` sets
are download-gated (reference README.md:9-39). This records a
scripted-expert corpus in the reference's on-disk layouts
(``data/expert.py``), after which the train -> eval -> export loop runs
in the port:

    python -m dt4image_restoration_tpu_torch.tools.make_dataset \\
        --out data_synth --n_traj 128 --eval
    python -m dt4image_restoration_tpu_torch --block_size 18 train \\
        --batch_size 16 --save_every 1 --max_epochs 5 \\
        --data_dir data_synth/trajs --state_file data_synth/states.h5 \\
        --checkpoint_dir ckpts
    python -m dt4image_restoration_tpu_torch --block_size 18 --n_embeds 9 \\
        eval --rtg 10 --checkpoint ckpts/model_4.pt \\
        --data_root data_synth
    python -m dt4image_restoration_tpu_torch.tools.export_checkpoint \\
        --model dt --in ckpts/state_latest.pt --out dt_export.pt \\
        --block_size 18

The recorder rolls the environment on ``--device`` (default ``cuda``; the
U-Net runs kernel K1 and the data-consistency step kernel K2 there) and
writes the states with ``h5py``, which must be installed. Prints one JSON
line of paths and the expert's mean PSNR increment, the target a policy
trained on the corpus should recover.
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m dt4image_restoration_tpu_torch.tools.make_dataset",
        description=__doc__.splitlines()[0])
    p.add_argument("--out", required=True, help="output root directory")
    p.add_argument("--n_traj", type=int, default=64)
    p.add_argument("--ep_len", type=int, default=8)
    p.add_argument("--experiment", default="optimal",
                   choices=["optimal", "flex"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--denoiser_ckpt", default="/nonexistent.pt",
                   help="reference unet-nm.pt; missing -> random-weight "
                        "prior (the corpus is still trainable: the env "
                        "physics, not the prior's quality, drives "
                        "learning)")
    p.add_argument("--eval", action="store_true",
                   help="also write the nine evaluation/image_dir/vanilla/"
                        "{A}_{S}/ eval dirs the verbs scan by default")
    p.add_argument("--per_dir", type=int, default=7,
                   help="eval images per dir (the evaluator averages the "
                        "first 7)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="device of the rollouts (the JAX tool's --cpu is "
                        "--device cpu)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        import h5py  # noqa: F401
    except ImportError:
        print("make_dataset: h5py is not installed; the corpus's states.h5 "
              "is written with it. Install h5py and run again.",
              file=sys.stderr)
        return 2

    from ..data.expert import make_eval_dirs, record_expert_corpus
    from ..utils.loaders import load_denoiser

    os.makedirs(args.out, exist_ok=True)
    denoise = load_denoiser(args.denoiser_ckpt, device=args.device)
    stats = record_expert_corpus(
        args.out, denoise, n_traj=args.n_traj, ep_len=args.ep_len,
        experiment=args.experiment, seed=args.seed, device=args.device,
        progress=lambda m: print(m, file=sys.stderr))
    if args.eval:
        stats["eval_dirs"] = make_eval_dirs(
            args.out, per_dir=args.per_dir, seed=args.seed)
    print(json.dumps(stats))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
