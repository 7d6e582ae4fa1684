"""Headline benchmark of the port: PnP-ADMM iterations/s on one GPU.

    python -m dt4image_restoration_tpu_torch.bench          # on the card
    python -m dt4image_restoration_tpu_torch.bench --device cpu --size 32 \\
        --iters 3 --repeats 2 --batch 2 --knee none        # plain versions

The port's twin of the JAX package's root ``bench.py`` (BASELINE config 1):
the 30-iteration fixed-parameter CSMRI PnP-ADMM loop (radial mask, the
base-32 U-Net prior, 128x128 slices, random weights from seed 0) in every
U-Net execution mode and dtype, and the same loop on the same weights and
record in the plain torch reference (``utils/torch_reference.py``) on the
CPU as the baseline. The variants keep ``bench.py``'s names (``VARIANTS``).

The method is ``bench.py``'s:
  * one slice: every variant warmed; each variant's final PSNR held to
    direct float32's (``GATE_DB`` in float32, ``BF16_GATE_DB`` in
    bfloat16); interleaved A/B rounds, each variant's fastest window kept
    (``_ab_throughput``); the fastest gated float32 variant adopted as the
    headline, then ``--repeats`` rollouts of it, each synchronised on its
    own, for the median and quartiles;
  * ``--batch`` slices (16): the same, gated against direct at that batch;
  * the knee: B = 64, 128 and 256 in direct, packed and bf16_direct, and at
    B = 128 the candidates (``KNEE_CANDIDATES``), each gated against direct
    at that batch, with the peak device memory of each point;
  * the torch CPU reference, timed once: ``vs_baseline`` and the PSNR
    parity of the adopted variant, held to ``PARITY_DB``.

Unlike ``bench.py`` it has no subprocess, retry or degraded CPU line:
without CUDA, and without ``--device cpu``, it exits 2 and prints nothing
on stdout. A variant that raises ends the run; a variant off its gate, or
the parity off ``PARITY_DB``, makes it exit 1 after the line is printed.
Progress goes to stderr as ``[bench-section]`` lines; the last stdout line
is the JSON result.
"""
from __future__ import annotations

import argparse
import functools
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from .data.synthetic import make_mat_record
from .env.pnp import compute_reward, fixed_param_rollout, reset_from_mat
from .models.unet import UNetDenoiser
from .ops import kernels
from .utils.convert import load_strict, unet_from_reference
from .utils.device import resolve_device
from .utils.torch_reference import random_unet_state_dict, torch_admm_rollout

N_ITERS = 30
MU = 0.5
SIGMA_D = 15.0 / 255.0
BATCH = 16
SCALING_BATCHES = (64, 128, 256)
KNEE_REP_BUDGET = 512    # slices dispatched per knee variant (reps = /b)
PALLAS_KNEE_BATCH = 128  # the knee point where the candidates are timed
SINGLE_REPEATS = 20
BATCH_REPEATS = 10
IMAGE_SEED = 0
GATE_DB = 0.01       # a float32 variant against direct (bench.py's band)
BF16_GATE_DB = 0.15  # a bfloat16 variant: tests/test_eval.py's band
PARITY_DB = 0.05     # the adopted variant against the torch CPU reference

# bench.py's variant names -> (the U-Net's --unet_packed mode, dtype).
VARIANTS = {
    "direct": ("none", "float32"),
    "packed": ("s2d", "float32"),
    "pallas": ("pallas", "float32"),
    "winograd": ("winograd", "float32"),
    "winograd_deep": ("winograd_deep", "float32"),
    "bf16_direct": ("none", "bfloat16"),
    "bf16_packed": ("s2d", "bfloat16"),
    "pallas_bf16": ("pallas", "bfloat16"),
    "winograd_bf16": ("winograd", "bfloat16"),
    "winograd_deep_bf16": ("winograd_deep", "bfloat16"),
}
KNEE_VARIANTS = ("direct", "packed", "bf16_direct")
KNEE_CANDIDATES = ("winograd", "winograd_bf16", "winograd_deep",
                   "winograd_deep_bf16", "pallas", "pallas_bf16")
KNEE_KEY = {"bf16_direct": "bf16"}  # bench.py's knee keys


def _throughput(fn, fetch, repeats: int) -> float:
    """Seconds per call: dispatch ``repeats`` calls, fetch only the last.
    Callers warm ``fn`` first."""
    t0 = time.perf_counter()
    out = None
    for _ in range(repeats):
        out = fn()
    fetch(out)
    return (time.perf_counter() - t0) / repeats


def _ab_throughput(fns, fetch, repeats: int, rounds: int = 3,
                   launches=None):
    """Per-variant seconds/call for competing variants, interleaved.

    Windows minutes apart drift (a B=1 rollout swings by a fifth between
    runs on the card), so every variant is measured back to back in each
    round and each keeps its fastest window: drift inflates windows but
    never deflates them, so minima compare. Callers warm every fn first.
    ``launches``, where given, collects each variant's kernel launches
    over its timed windows (the counts are zeroed before each window).
    """
    best = {k: float("inf") for k in fns}
    for _ in range(rounds):
        for k, fn in fns.items():
            if launches is not None:
                kernels.reset_launch_counts()
            t0 = time.perf_counter()
            out = None
            for _ in range(repeats):
                out = fn()
            fetch(out)
            best[k] = min(best[k], (time.perf_counter() - t0) / repeats)
            if launches is not None:
                got = kernels.launch_counts()
                acc = launches.setdefault(k, dict.fromkeys(got, 0))
                for name, n in got.items():
                    acc[name] += n
    return best


def fetch(out: torch.Tensor) -> float:
    """One PSNR to the host: waits for the rollout that made it."""
    return float(out[0, 0])


def make_denoiser(name: str, state_dict, device) -> UNetDenoiser:
    """Variant ``name``'s denoiser on ``device``, loaded from a state dict in
    the reference's layout."""
    mode, dtype = VARIANTS[name]
    den = UNetDenoiser(dtype=dtype, packed=mode)
    load_strict(den, unet_from_reference(state_dict), "U-Net")
    return den.eval().requires_grad_(False).to(device)


def make_roll(denoise, iters: int):
    """state -> final PSNR (B, 1) of ``iters`` fixed-parameter iterations."""
    def roll(state):
        final, _ = fixed_param_rollout(denoise, state, MU, SIGMA_D, iters)
        return compute_reward(final)
    return roll


def batch_record(mats, b: int):
    """``b`` slices drawn from ``mats`` in turn, as one record."""
    return {k: np.concatenate([mats[s % len(mats)][k] for s in range(b)])
            for k in mats[0]}


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


class Bench:
    """The bench's weights, records and rollouts on one device. Each stage
    adds its numbers to ``extras`` and every gate it misses to
    ``failed``."""

    def __init__(self, device, size: int = 128, iters: int = N_ITERS,
                 batch: int = BATCH, variants=tuple(VARIANTS)):
        self.dev = torch.device(device)
        self.iters, self.batch = iters, batch
        self.state_dict = random_unet_state_dict(seed=0)
        self.mat = make_mat_record(size=size, seed=IMAGE_SEED)
        self.mats = [make_mat_record(size=size, seed=s)
                     for s in range(batch)]
        self.rolls = {n: make_roll(make_denoiser(n, self.state_dict,
                                                 self.dev), iters)
                      for n in variants}
        self.state1 = reset_from_mat(self.mat, device=self.dev)
        self.extras, self.failed = {}, []
        self.psnr_f32 = self.psnr_bf16 = None
        self.t_single = None
        self._t_prev = time.perf_counter()

    def _mark(self, label: str) -> None:
        now = time.perf_counter()
        print(f"[bench-section] {label}: {now - self._t_prev:.1f}s",
              file=sys.stderr, flush=True)
        self._t_prev = now

    def _sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def _psnr(self, name, state) -> np.ndarray:
        return self.rolls[name](state).cpu().numpy()

    def _gate(self, psnr, suffix: str):
        """Hold each variant's PSNRs to direct's on the same slices (the
        largest |difference| over the slices, under ``GATE_DB`` in float32
        and ``BF16_GATE_DB`` in bfloat16); record ``<name><suffix>_
        psnr_delta_db`` and ``<name><suffix>_ok``. Returns the variants
        that passed, direct first."""
        passed = ["direct"]
        for name, p in psnr.items():
            if name == "direct":
                continue
            delta = float(np.abs(p - psnr["direct"]).max())
            band = GATE_DB if VARIANTS[name][1] == "float32" \
                else BF16_GATE_DB
            ok = delta < band      # False for NaN
            self.extras[f"{name}{suffix}_psnr_delta_db"] = round(delta, 4)
            self.extras[f"{name}{suffix}_ok"] = ok
            if ok:
                passed.append(name)
            else:
                self.failed.append(f"{name}{suffix}")
                print(f"[bench] {name}{suffix}: PSNR {delta:.4f} dB off "
                      f"direct (band {band} dB)", file=sys.stderr)
        return passed

    def _ab(self, state, repeats: int, launches=None):
        fns = {n: functools.partial(roll, state)
               for n, roll in self.rolls.items()}
        return _ab_throughput(fns, fetch, repeats=max(1, repeats // 3),
                              launches=launches)

    def single(self, repeats: int = SINGLE_REPEATS) -> None:
        """One slice: warm, gate, interleaved A/B, adopt, then the median
        and quartiles of ``repeats`` rollouts of the adopted variant."""
        for roll in self.rolls.values():   # builds kernels, picks algorithms
            fetch(roll(self.state1))
        psnr = {n: self._psnr(n, self.state1) for n in self.rolls}
        self._mark(f"single-slice warm x{len(self.rolls)}")
        passed = self._gate(psnr, "")
        launches = {}
        t = self._ab(self.state1, repeats, launches)
        self._mark("single-slice interleaved A/B")
        ex = self.extras
        for n in self.rolls:
            ex[f"{n}_iters_per_sec"] = round(self.iters / t[n], 2)
        f32 = [n for n in passed if VARIANTS[n][1] == "float32"]
        bf16 = [n for n in passed if VARIANTS[n][1] == "bfloat16"]
        adopted = min(f32, key=t.get)
        self.t_single = t[adopted]
        self.psnr_f32 = float(psnr[adopted][0, 0])
        ex.update({"unet_variant_adopted": adopted,
                   "unet_packed_adopted": adopted == "packed",
                   "single_slice_ms_per_iter": round(
                       1e3 * t[adopted] / self.iters, 3),
                   "launches": launches})
        if bf16:
            best16 = min(bf16, key=t.get)
            self.psnr_bf16 = float(psnr[best16][0, 0])
            ex["bf16_variant_adopted"] = best16
            ex["bf16_iters_per_sec"] = round(self.iters / t[best16], 2)

        roll, rates = self.rolls[adopted], []
        for _ in range(repeats + 1):       # the first run warms up
            self._sync()
            t0 = time.perf_counter()
            fetch(roll(self.state1))
            self._sync()
            rates.append(self.iters / (time.perf_counter() - t0))
        q1, median, q3 = statistics.quantiles(rates[1:], n=4)
        ex.update({"single_iters_per_sec_median": round(median, 2),
                   "single_iters_per_sec_q1": round(q1, 2),
                   "single_iters_per_sec_q3": round(q3, 2),
                   "single_repeats": repeats})
        self._mark(f"single-slice {repeats} synchronised runs")

    def batched(self, repeats: int = BATCH_REPEATS) -> None:
        """``batch`` slices: the single slice's A/B, gated against direct at
        this batch (cuDNN picks other algorithms at another batch)."""
        state = reset_from_mat(batch_record(self.mats, self.batch),
                               device=self.dev)
        psnr = {n: self._psnr(n, state) for n in self.rolls}   # warm-up
        passed = self._gate(psnr, "_batched")
        t = self._ab(state, repeats)
        b, ex = self.batch, self.extras
        for n in self.rolls:
            ex[f"{n}_batched_slices_per_sec"] = round(b / t[n], 2)
        f32 = [n for n in passed if VARIANTS[n][1] == "float32"]
        bf16 = [n for n in passed if VARIANTS[n][1] == "bfloat16"]
        best = min(f32, key=t.get)
        ex.update({"batched_variant_adopted": best,
                   "batched_slices_per_sec": round(b / t[best], 2),
                   "batched_iters_per_sec": round(
                       b * self.iters / t[best], 2)})
        if bf16:
            ex["bf16_batched_slices_per_sec"] = round(
                b / min(t[n] for n in bf16), 2)
        self._mark(f"B={b} A/B")

    def knee(self, batches=None, repeats=None) -> None:
        """Slices/s at each batch of ``batches`` (default
        ``SCALING_BATCHES``) in the knee variants, and
        at ``PALLAS_KNEE_BATCH`` also in the candidates; ``repeats`` rollouts
        a variant (default ``max(2, KNEE_REP_BUDGET // b)``) after one whose
        PSNRs are gated against direct's at that batch."""
        names = [n for n in self.rolls
                 if n in KNEE_VARIANTS + KNEE_CANDIDATES]
        ex = self.extras
        for b in batches or SCALING_BATCHES:
            here = [n for n in names
                    if n in KNEE_VARIANTS or b == PALLAS_KNEE_BATCH]
            reps = repeats or max(2, KNEE_REP_BUDGET // b)
            state = reset_from_mat(batch_record(self.mats, b),
                                   device=self.dev)
            if self.dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(self.dev)
            psnr, t = {}, {}
            for n in here:
                psnr[n] = self._psnr(n, state)
                t[n] = _throughput(functools.partial(self.rolls[n], state),
                                   fetch, repeats=reps)
                ex[f"{KNEE_KEY.get(n, n)}_slices_per_sec_b{b}"] = round(
                    b / t[n], 2)
            passed = self._gate(psnr, f"_b{b}")
            ex[f"batched_slices_per_sec_b{b}"] = round(
                b / min(t[n] for n in passed), 2)
            if self.dev.type == "cuda":
                ex[f"peak_memory_gb_b{b}"] = round(
                    torch.cuda.max_memory_allocated(self.dev) / 1e9, 3)
            del state
            self._mark(f"knee b={b} ({len(here)} variants)")

    def baseline(self) -> float:
        """The torch CPU reference on the same weights and record, timed
        once; records the PSNR parity. Returns its iterations/s."""
        t0 = time.perf_counter()
        _, psnr_torch = torch_admm_rollout(self.state_dict, self.mat, MU,
                                           SIGMA_D, self.iters)
        rate = self.iters / (time.perf_counter() - t0)
        parity = abs(self.psnr_f32 - psnr_torch)
        self.extras.update({
            "cpu_reference_iters_per_sec": round(rate, 2),
            "psnr_f32_db": round(self.psnr_f32, 4),
            "psnr_torch_cpu_db": round(psnr_torch, 4),
            "psnr_parity_delta_db": round(parity, 4)})
        if self.psnr_bf16 is not None:
            self.extras["psnr_bf16_delta_db"] = round(
                abs(self.psnr_bf16 - psnr_torch), 4)
        if not parity <= PARITY_DB:
            self.failed.append("psnr_parity")
            print(f"[bench] the adopted variant is {parity:.4f} dB off the "
                  f"torch CPU reference (band {PARITY_DB} dB)",
                  file=sys.stderr)
        self._mark("torch CPU baseline")
        return rate


def _variants(text: str):
    names = [n.strip() for n in text.split(",") if n.strip()]
    unknown = sorted(set(names) - set(VARIANTS))
    if unknown:
        raise argparse.ArgumentTypeError(
            f"unknown variants {unknown}; choose from {list(VARIANTS)}")
    if "direct" not in names:
        raise argparse.ArgumentTypeError("the variants must include direct, "
                                         "the reference of every gate")
    return tuple(n for n in VARIANTS if n in names)


def _at_least_two(text: str) -> int:
    n = int(text)
    if n < 2:
        raise argparse.ArgumentTypeError("needs at least 2 (quartiles)")
    return n


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m dt4image_restoration_tpu_torch.bench",
        description="PnP-ADMM iterations/s of the port on one GPU, in "
                    "every U-Net mode and dtype, against the torch CPU "
                    "reference; prints one JSON line")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda); 'cpu' runs the "
                        "kernels' plain versions, for tests")
    p.add_argument("--size", type=int, default=128,
                   help="slice size (default 128, the published one)")
    p.add_argument("--iters", type=int, default=N_ITERS)
    p.add_argument("--repeats", type=_at_least_two, default=SINGLE_REPEATS,
                   help="synchronised one-slice runs for the median; the "
                        "A/B windows take a third as many, the batched "
                        f"ones {BATCH_REPEATS}/{SINGLE_REPEATS} of that")
    p.add_argument("--batch", type=int, default=BATCH)
    p.add_argument("--knee", choices=("full", "none"), default="full",
                   help=f"'full' times B = {SCALING_BATCHES}")
    p.add_argument("--variants", type=_variants, default=tuple(VARIANTS),
                   help="comma list of variants (direct required); "
                        f"default all: {','.join(VARIANTS)}")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    t_start = time.perf_counter()
    try:
        dev = resolve_device(args.device)   # TF32 off before any timing
    except RuntimeError as e:
        print(f"bench: {e}", file=sys.stderr)
        return 2
    bench = Bench(dev, size=args.size, iters=args.iters, batch=args.batch,
                  variants=args.variants)
    bench.single(args.repeats)
    bench.batched(max(1, args.repeats * BATCH_REPEATS // SINGLE_REPEATS))
    if args.knee == "full":
        bench.knee()
    baseline = bench.baseline()
    value = args.iters / bench.t_single
    cuda = dev.type == "cuda"
    bench.extras.update({
        "platform": "gpu" if cuda else "cpu",
        "device": nvidia_smi() if cuda else "cpu",
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "size": args.size, "iters": args.iters, "batch": args.batch,
        "wall_s": round(time.perf_counter() - t_start, 1)})
    print(json.dumps({"metric": "pnp_admm_iters_per_sec_per_chip",
                      "value": round(value, 2), "unit": "iters/s",
                      "vs_baseline": round(value / baseline, 2),
                      "extras": bench.extras}), flush=True)
    if bench.failed:
        print(f"bench: gates missed: {bench.failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
