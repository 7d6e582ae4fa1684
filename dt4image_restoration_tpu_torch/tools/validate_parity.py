"""Real-checkpoint parity harness: holds the port to the reference's
inference semantics, in mean dB per directory, against the ±0.05 dB gate.

The reference ships three download-gated files: ``model_experiment_2.pt``
(the optimal, or norm, policy), ``model_experiment_1.pt`` (the flexible
policy) and ``unet-nm.pt`` (the plug-in denoiser). With them in place:

    python -m dt4image_restoration_tpu_torch.tools.validate_parity \\
        --dt checkpoints/model_experiment_2.pt \\
        --dt_flex checkpoints/model_experiment_1.pt \\
        --unet evaluation/pretrained/unet-nm.pt \\
        [--arniqa <hub state dict .pt>] \\
        --dirs evaluation/image_dir/vanilla/4_15 ...

For every requested mode (eval, flex, mcts) each slice is restored twice:
by the oracle (``utils/torch_oracle.py``, a plain PyTorch restatement of
the reference on the raw state dicts, on the CPU in float32) and by the
port on ``--device`` (default ``cuda``): the ``Evaluator`` with its
default policy forward and the ``DeviceMCTS`` search, on the converted
weights, with the U-Net in the verbs' default mode. A row passes when the
two mean PSNRs of a directory lie within ``--tolerance`` dB; the exit code
is 0 only when every row passes. ``--selftest`` runs the same on random
weights in the reference's layout and synthetic slices, and needs no
file. ``--device cuda`` without a card raises; only ``--device cpu`` runs
the port on the CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

BLOCK_SIZE = 18            # the published DT's 6-timestep context
EVAL_EMBEDS, FLEX_EMBEDS = 9, 6


def _policy(path: str, mode: str, n_embeds: int, device):
    """The port's DT from a reference checkpoint, built as the verbs build
    it (``use_pallas``: the per-op forward runs kernels K4 and K5; the
    fused forward, K3, ignores the flag)."""
    from ..config import ModelConfig
    from ..utils.loaders import load_dt
    cfg = ModelConfig(block_size=BLOCK_SIZE, n_embeds=n_embeds, mode=mode,
                      use_pallas=True)
    return load_dt(cfg, path, device=device)


def _load_checkpoints(args, device) -> Dict:
    """The raw reference state dicts (the oracle's) and the port's models
    converted from them on ``device``, with the search's scorers: ARNIQA
    from ``--arniqa`` (the oracle's on the CPU, the search's batched one on
    ``device``), else the proxy scorer on both sides."""
    from ..models.arniqa import (make_value_fn, make_value_fn_batched,
                                 proxy_value_fn, proxy_value_fn_batched)
    from ..utils.loaders import load_arniqa, load_denoiser

    # Each file is read here first, so a missing one raises; the loaders
    # then convert it (they fall back to random weights only for a path
    # that does not exist).
    out = {"dt_sd": torch.load(args.dt, map_location="cpu"),
           "unet_sd": torch.load(args.unet, map_location="cpu"),
           "dt_flex_sd": None, "dt_flex": None}
    out["dt"] = _policy(args.dt, "norm", EVAL_EMBEDS, device)
    out["denoiser"] = load_denoiser(args.unet, device=device)
    if args.dt_flex:
        out["dt_flex_sd"] = torch.load(args.dt_flex, map_location="cpu")
        out["dt_flex"] = _policy(args.dt_flex, "flex", FLEX_EMBEDS, device)
    if args.arniqa:
        out["value_fn"] = make_value_fn(load_arniqa(args.arniqa, "cpu"))
        out["value_fn_batched"] = make_value_fn_batched(
            load_arniqa(args.arniqa, device))
    else:
        out["value_fn"] = proxy_value_fn
        out["value_fn_batched"] = proxy_value_fn_batched
    return out


def _records_and_mats(path, rtg_target, kind, limit):
    """Dataset records for the port and the RAW mats for the oracle (the
    oracle clips x0 for the env itself and reads the unclipped x0 for the
    policy's first observation, as ``EvaluationDataset`` does)."""
    from scipy.io import loadmat
    from ..data.datasets import EvaluationDataset
    ds = EvaluationDataset(path, rtg_target=rtg_target, kind=kind)
    n = min(len(ds), limit)
    records = [ds[i] for i in range(n)]
    raw = [loadmat(os.path.join(path, ds.fns[i])) for i in range(n)]
    return records, raw


def _rtg_task(record):
    return (float(np.asarray(record[0][1]).reshape(-1)[0]),
            int(np.asarray(record[0][3]).reshape(-1)[0]))


def _greedy_rows(ckpts, dirs, rtg_target, mode, args, device) -> List[Dict]:
    """One row per directory: the mean PSNR of the oracle's episodes
    against the port's batched rollout."""
    from ..inference import Evaluator
    from ..utils.torch_oracle import torch_eval_episode, torch_psnr
    flex = mode == "flex"
    dt = ckpts["dt_flex"] if flex else ckpts["dt"]
    dt_sd = ckpts["dt_flex_sd"] if flex else ckpts["dt_sd"]
    evaluator = Evaluator(
        dt=dt, denoise=ckpts["denoiser"], cfg=dt.cfg,
        max_timesteps=args.max_timesteps, rtg_target=rtg_target,
        eval_type=mode, report_every=args.limit, device=device)

    rows = []
    for path in dirs:
        records, raw = _records_and_mats(
            path, rtg_target, "flex" if flex else "optimal", args.limit)
        if not records:
            continue
        t0 = time.perf_counter()
        ref = []
        for rec, mat in zip(records, raw):
            x, _ = torch_eval_episode(dt_sd, ckpts["unet_sd"], mat,
                                      *_rtg_task(rec),
                                      max_timesteps=args.max_timesteps,
                                      mode=mode)
            ref.append(torch_psnr(x, mat["gt"]))
        t1 = time.perf_counter()
        reward = evaluator.evaluate_records(records)["reward"]
        t2 = time.perf_counter()
        label = f"flex(rtg={rtg_target})" if flex else mode
        rows.append(_row(label, path, len(records), float(np.mean(ref)),
                         float(np.mean(reward)), args.tolerance, t1 - t0,
                         t2 - t1))
    return rows


def _mcts_rows(ckpts, dirs, rtg_target, args, device) -> List[Dict]:
    """One row per directory: the oracle's tree search against the port's
    device-resident one, the children drawn from the same numpy streams
    (``seed + i`` for the i-th slice)."""
    from ..config import MCTSConfig
    from ..inference.mcts_device import DeviceMCTS
    from ..utils.torch_oracle import torch_run_mcts
    dt = ckpts["dt"]
    mcts = DeviceMCTS(
        dt=dt, denoise=ckpts["denoiser"], model_cfg=dt.cfg,
        cfg=MCTSConfig(iterations=args.iterations,
                       max_timesteps=args.max_timesteps, seed=args.seed),
        value_fn=ckpts["value_fn"],
        value_fn_batched=ckpts["value_fn_batched"], device=device)

    rows = []
    for path in dirs:
        records, raw = _records_and_mats(path, rtg_target, "optimal",
                                         args.limit)
        if not records:
            continue
        seeds = [args.seed + i for i in range(len(records))]
        t0 = time.perf_counter()
        ref = [torch_run_mcts(ckpts["dt_sd"], ckpts["unet_sd"], mat,
                              *_rtg_task(rec), seed=seed,
                              iterations=args.iterations,
                              max_timesteps=args.max_timesteps,
                              value_fn=ckpts["value_fn"])[0]
               for rec, mat, seed in zip(records, raw, seeds)]
        t1 = time.perf_counter()
        ours = mcts.run_batch(records, seeds=seeds, verbose=False)
        t2 = time.perf_counter()
        rows.append(_row("mcts", path, len(records), float(np.mean(ref)),
                         float(np.mean(ours)), args.tolerance, t1 - t0,
                         t2 - t1))
    return rows


def _row(mode, path, n, oracle_db, port_db, tol, oracle_s, port_s):
    delta = port_db - oracle_db
    return {"mode": mode, "dir": path, "n": n,
            "oracle_db": round(oracle_db, 4), "port_db": round(port_db, 4),
            "delta_db": round(delta, 4), "pass": bool(abs(delta) <= tol),
            "oracle_s": round(oracle_s, 3), "port_s": round(port_s, 3)}


def validate(args) -> Dict:
    """Run the requested modes, print the table and return the report
    ``{"ok", "tolerance_db", "device", "rows"}`` (also written to
    ``--json_out``)."""
    from ..utils.device import resolve_device
    device = resolve_device(args.device)
    ckpts = _load_checkpoints(args, device)
    rows = []
    if "eval" in args.modes:
        rows += _greedy_rows(ckpts, args.dirs, args.rtg, "norm", args,
                             device)
    if "flex" in args.modes:
        if ckpts["dt_flex"] is None:
            print("NOTE: flex mode skipped (--dt_flex not given)",
                  file=sys.stderr)
        else:
            for rtg in args.flex_rtgs:
                rows += _greedy_rows(ckpts, args.dirs, float(rtg), "flex",
                                     args, device)
    if "mcts" in args.modes:
        rows += _mcts_rows(ckpts, args.dirs, args.rtg, args, device)

    header = (f"{'mode':<16} {'dir':<40} {'n':>3} {'oracle dB':>9} "
              f"{'port dB':>9} {'Δ dB':>8}  status  {'oracle s':>8} "
              f"{'port s':>8}")
    print(header)
    print("-" * len(header))
    for r in rows:
        print(f"{r['mode']:<16} {r['dir'][-40:]:<40} {r['n']:>3} "
              f"{r['oracle_db']:>9.4f} {r['port_db']:>9.4f} "
              f"{r['delta_db']:>8.4f}  {'PASS' if r['pass'] else 'FAIL'}"
              f"    {r['oracle_s']:>8.3f} {r['port_s']:>8.3f}")
    ok = bool(rows) and all(r["pass"] for r in rows)
    print(f"\nOverall: {'PASS' if ok else 'FAIL'} "
          f"(tolerance ±{args.tolerance} dB, {len(rows)} rows)")
    report = {"ok": ok, "tolerance_db": args.tolerance,
              "device": str(device), "rows": rows}
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(report, f, indent=1)
    return report


def write_selftest_fixtures(root: str, n_images: int) -> Dict[str, str]:
    """Write the selftest's inputs under ``root``: random weights in the
    reference checkpoints' layouts (the DTs from seeds 0 and 1, their stop
    logit lowered by 0.5 for episodes of middle length, and the U-Net from
    seed 0) and ``n_images`` synthetic slices ``make_mat_record(seed=i)``
    in one directory. The JAX package's harness builds the same fixtures
    from the same seeds. Returns the paths ``{"dt", "dt_flex", "unet",
    "dir"}``."""
    from scipy.io import savemat
    from ..data.synthetic import make_mat_record
    from ..utils.torch_oracle import make_dt_state_dict
    from ..utils.torch_reference import random_unet_state_dict

    paths = {"dt": os.path.join(root, "model_experiment_2.pt"),
             "dt_flex": os.path.join(root, "model_experiment_1.pt"),
             "unet": os.path.join(root, "unet-nm.pt"),
             "dir": os.path.join(root, "4_15")}
    dt_sd = make_dt_state_dict(torch.Generator().manual_seed(0),
                               n_embeds=EVAL_EMBEDS)
    dt_sd["predict_action.0.bias"][0] -= 0.5
    dt_flex_sd = make_dt_state_dict(torch.Generator().manual_seed(1),
                                    n_embeds=FLEX_EMBEDS)
    dt_flex_sd["predict_action.0.bias"][2] -= 0.5
    torch.save(dt_sd, paths["dt"])
    torch.save(dt_flex_sd, paths["dt_flex"])
    torch.save(random_unet_state_dict(seed=0), paths["unet"])
    os.makedirs(paths["dir"])
    for i in range(n_images):
        savemat(os.path.join(paths["dir"], f"img_4_15_s{i}.mat"),
                make_mat_record(seed=i))
    return paths


def _selftest(args) -> Dict:
    """The whole harness on :func:`write_selftest_fixtures`' inputs, in a
    temporary directory removed on exit."""
    with tempfile.TemporaryDirectory(
            prefix="validate_parity_selftest_") as tmp:
        paths = write_selftest_fixtures(tmp, args.limit)
        args.dt, args.dt_flex, args.unet = (paths["dt"], paths["dt_flex"],
                                            paths["unet"])
        args.dirs = [paths["dir"]]
        return validate(args)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m dt4image_restoration_tpu_torch.tools."
             "validate_parity",
        description=__doc__.splitlines()[0])
    p.add_argument("--dt", help="model_experiment_2.pt (norm: eval, mcts)")
    p.add_argument("--dt_flex", default=None,
                   help="model_experiment_1.pt (flex mode)")
    p.add_argument("--unet", help="unet-nm.pt")
    p.add_argument("--arniqa", default=None,
                   help="ARNIQA hub state dict (else: the proxy scorer on "
                        "both sides)")
    p.add_argument("--dirs", nargs="+", default=None,
                   help="evaluation .mat directories")
    p.add_argument("--modes", nargs="+", default=["eval", "flex", "mcts"],
                   choices=["eval", "flex", "mcts"])
    p.add_argument("--rtg", type=float, default=10.0,
                   help="RTG target for eval and mcts (reference "
                        "scripts.sh)")
    p.add_argument("--flex_rtgs", nargs="+", type=float,
                   default=[1.5, 3, 3.5, 4, 4.5])
    p.add_argument("--limit", type=int, default=7,
                   help="slices per directory (the reference reports the "
                        "first 7, eval.py:137-143)")
    p.add_argument("--max_timesteps", type=int, default=30)
    p.add_argument("--iterations", type=int, default=30,
                   help="search iterations (mcts.py:231)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tolerance", type=float, default=0.05,
                   help="pass threshold in dB")
    p.add_argument("--json_out", default=None)
    p.add_argument("--selftest", action="store_true",
                   help="run on random weights and synthetic slices "
                        "(ignores --dt, --dt_flex, --unet and --dirs)")
    p.add_argument("--device", default="cuda",
                   help="the port's device, cuda or cpu (the oracle runs "
                        "on the CPU)")
    return p


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    missing = [k for k in ("dt", "unet", "dirs")
               if getattr(args, k) in (None, [])]
    if missing and not args.selftest:
        parser.error(f"--{', --'.join(missing)} required (or use --selftest)")
    report = _selftest(args) if args.selftest else validate(args)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
