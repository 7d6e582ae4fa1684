"""Time the bfloat16 device-backend tree search of the port on a CUDA card,
repeated, for a median.

    python3 -m dt4image_restoration_tpu_torch.perf.search_bf16_repeats
    python3 dt4image_restoration_tpu_torch/perf/search_bf16_repeats.py \\
        --root OTHER_CHECKOUT

The search is ``chip_smoke.py``'s ``mcts_bf16`` phase: the ``mcts`` verb's
device backend with ``--dtype bfloat16`` (the bfloat16 K1, K2, K4, K5; the
proxy scorer) on 16 trees of synthetic slices, random weights from seed 0,
the per-op policy's stop output biased so that every episode runs 30 steps.
After one 1-round search that warms the path up, each repeat times a
3-round and a 1-round search; its tree-iterations/s are those of rounds 1
and 2 (16 x 2 over the difference of the two walls), so that neither the
trees' set-up nor round 0 counts. It prints the card's name and power
limit, then one JSON line: each repeat's rate, their median and quartiles,
and the mean best PSNR. ``--root`` times the port package of another
checkout (an unpacked parent commit, say) with this same code; run the file
by its path for that.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

TREES = 16          # trees per search chunk (the CLI default)
ROUNDS = 3
SEARCH_RTG = 5.0


def search_records(data_root):
    """The first TREES slices of 9 synthetic eval directories of 7 slices,
    in directory order, with the CLI's per-directory seeds."""
    from dt4image_restoration_tpu_torch.config import EVAL_DIR_TOKENS
    from dt4image_restoration_tpu_torch.data import (EvaluationDataset,
                                                     write_eval_dir)
    records, seeds = [], []
    for i, tok in enumerate(EVAL_DIR_TOKENS):
        d = write_eval_dir(os.path.join(data_root, tok), tok, n=7,
                           seed=1000 * i)
        ds = EvaluationDataset(d, rtg_target=SEARCH_RTG, kind="optimal")
        for j in range(len(ds)):
            records.append(ds[j])
            seeds.append(j)
    return records[:TREES], seeds[:TREES]


def make_search(torch, dev, ckpt_dir, iterations):
    """The bfloat16 device-backend search on random weights."""
    from dt4image_restoration_tpu_torch.config import MCTSConfig, ModelConfig
    from dt4image_restoration_tpu_torch.inference import DeviceMCTS
    from dt4image_restoration_tpu_torch.models import (
        proxy_value_fn, proxy_value_fn_batched)
    from dt4image_restoration_tpu_torch.models.decision_transformer import (
        ACTION_KEYS)
    from dt4image_restoration_tpu_torch.utils.loaders import (load_denoiser,
                                                              load_dt)
    cfg = ModelConfig(block_size=18, n_embeds=9, mode="norm",
                      use_pallas=True, dtype="bfloat16")
    dt = load_dt(cfg, os.path.join(ckpt_dir, "model_experiment_2.pt"),
                 device=dev)
    with torch.no_grad():
        dt.predict_action.bias[ACTION_KEYS[cfg.mode].index("T")] = -3.0
    return DeviceMCTS(
        dt=dt, denoise=load_denoiser(os.path.join(ckpt_dir, "unet-nm.pt"),
                                     device=dev, dtype="bfloat16"),
        model_cfg=cfg, cfg=MCTSConfig(iterations=iterations),
        value_fn=proxy_value_fn, value_fn_batched=proxy_value_fn_batched,
        record_trace=False, device=dev)


def timed(torch, search, records, seeds):
    """(rewards, wall s) of one search."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rewards = search.run_batch(records, seeds=seeds)
    torch.cuda.synchronize()
    return rewards, time.perf_counter() - t0


def measure(torch, dev, repeats: int) -> dict:
    """The search's line, for the port package that is importable."""
    with tempfile.TemporaryDirectory(prefix="search_bf16_") as tmp:
        ckpt_dir = os.path.join(tmp, "checkpoints")   # empty: random weights
        records, seeds = search_records(os.path.join(tmp, "data"))
        timed(torch, make_search(torch, dev, ckpt_dir, 1), records, seeds)
        rates, psnr = [], []
        for _ in range(repeats):
            rewards, wall = timed(
                torch, make_search(torch, dev, ckpt_dir, ROUNDS), records,
                seeds)
            wall_1 = timed(torch, make_search(torch, dev, ckpt_dir, 1),
                           records, seeds)[1]
            rates.append(TREES * (ROUNDS - 1) / (wall - wall_1))
            psnr.append(sum(rewards) / len(rewards))
    q1, median, q3 = statistics.quantiles(rates, n=4)
    return {"phase": "search_bf16_repeats", "trees": TREES,
            "rounds": ROUNDS, "repeats": repeats,
            "tree_iterations_per_s": rates, "median": median, "q1": q1,
            "q3": q3, "mean_best_psnr_db": psnr}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", type=Path,
                        default=Path(__file__).resolve().parents[2],
                        help="checkout whose port package is timed "
                             "(default: this one)")
    parser.add_argument("--repeats", type=int, default=7)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(args.root.resolve()))
    import torch
    if not torch.cuda.is_available():
        print("search_bf16_repeats: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    import dt4image_restoration_tpu_torch as port
    root = Path(port.__file__).resolve().parents[1]
    if root != args.root.resolve():
        print(f"search_bf16_repeats: imported the port from {root}, not "
              f"from {args.root}; run this file by its path",
              file=sys.stderr)
        return 2
    from dt4image_restoration_tpu_torch.utils.device import resolve_device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    line = measure(torch, resolve_device("cuda"), args.repeats)
    line.update(root=str(args.root), nvidia_smi=smi)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
