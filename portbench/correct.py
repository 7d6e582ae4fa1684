"""``correct``: a sample of the window's answers against the reference.

After the window has closed, a sample of the answers drawn from the seed
(``sample`` of them, or all if fewer) is restored again by the plain
reference (:mod:`.reference`), on the same weights and slices, in blocks of
``block`` rows. Of these numbers, a cell compares those its
``limits/<workload>.json`` gives a limit:

  * ``episode_len_mismatches``: answers whose episode length differs;
  * ``psnr_gap_db``: the widest gap between the PSNR the program reported
    and the reference image's PSNR against the ground truth;
    ``psnr_mean_gap_db``: the mean of those gaps;
  * ``image_gap``: the widest pixel gap between the program's restored
    image and the reference's, both clipped to [0, 1];
    ``image_mean_gap``: the mean over answers of each one's widest gap;
    ``image_rms_gap``: the root mean square of the pixel gaps over every
    answer;
  * ``image_rms_ratio``, where the configuration computes in a precision
    below float32: ``image_rms_gap`` over the same gap of the reference
    itself run in the configuration's ``dtype``. The random prior of some
    seeds amplifies any rounding over the 30 steps, the reference's own
    in that precision as much as the program's, so a gap in pixels is
    measured in units of what the precision alone explains;
    ``image_rms_ratio_max``: the same answer by answer, the largest over
    answers of each one's RMS gap over the reference's own gap on that
    answer or on the median answer, whichever is larger, so that one
    wrong answer is not diluted by the sample; ``psnr_gap_ratio_max``:
    likewise of the PSNR gaps.

A run is correct when every answer due in the window came, none failed,
and every compared number is within its limit.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from .records import Pool
from .reference import greedy_episodes, psnr_db

def sample(n: int, k: int, seed: int) -> List[int]:
    """``min(n, k)`` of ``range(n)``, drawn from ``seed``, in order."""
    rng = np.random.default_rng(seed ^ 0xC0FFEE)
    return sorted(int(i) for i in rng.choice(n, size=min(n, k),
                                             replace=False))


def reference_answers(cfg: Dict, dt_sd: Dict, denoise: Callable,
                      pool: Pool, idx: Sequence[int], device, block: int,
                      precision: str = "float32"
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The reference's (images (N, H, W), PSNR dB (N,), episode lengths
    (N,)) of the pool's slices ``idx``, in ``precision``, with the prior's
    reference ``denoise(img, sigma, precision)``."""
    images, psnrs, lens = [], [], []
    for s in range(0, len(idx), block):
        rows = list(idx[s:s + block])
        inputs = pool.reference_inputs(rows, device)
        x, ep = greedy_episodes(dt_sd, denoise, inputs,
                                cfg["max_timesteps"], cfg["block_size"] // 3,
                                cfg["n_heads"], cfg["mode"], precision)
        images.append(torch.clamp(x, 0, 1).cpu().numpy())
        psnrs.append(psnr_db(x, inputs["gt"]).cpu().numpy())
        lens.append(ep.cpu().numpy())
    return (np.concatenate(images), np.concatenate(psnrs).astype(np.float64),
            np.concatenate(lens))


def _rms(a, b) -> float:
    return float(np.sqrt(np.mean(np.square(a - b, dtype=np.float64))))


def _worst_ratio(gaps, own_gaps) -> float:
    """The largest ``gaps[i] / max(own_gaps[i], median(own_gaps))``."""
    floor = np.maximum(own_gaps, np.median(own_gaps))
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.where(gaps > 0, gaps / floor, 0.0)
    return float(np.max(ratio))


def compare(images, psnrs, lens, ref, own=None) -> Dict[str, float]:
    """The numbers of answers (images, reported PSNRs, episode lengths)
    against the reference's; with ``own``, the reference's answers in the
    configuration's precision, also the ratios to its gaps."""
    r_img, r_psnr, r_len = ref
    images = np.clip(np.asarray(images, np.float32), 0, 1)
    diff = (images - r_img).reshape(len(images), -1)
    gap = np.abs(diff).max(axis=1)
    psnr_gap = np.abs(np.asarray(psnrs, np.float64) - r_psnr)
    rms = _rms(images, r_img)
    extra = {}
    if own is not None:
        own_rms = _rms(own[0], r_img)
        extra["image_rms_ratio"] = rms / own_rms if own_rms > 0 else math.inf
        own_diff = (own[0] - r_img).reshape(len(images), -1)
        extra["image_rms_ratio_max"] = _worst_ratio(
            np.sqrt(np.mean(np.square(diff, dtype=np.float64), axis=1)),
            np.sqrt(np.mean(np.square(own_diff, dtype=np.float64), axis=1)))
        extra["psnr_gap_ratio_max"] = _worst_ratio(
            psnr_gap, np.abs(np.asarray(own[1], np.float64) - r_psnr))
    return {
        "episode_len_mismatches": float(
            (np.asarray(lens) != r_len).sum()),
        "psnr_gap_db": float(np.max(psnr_gap)),
        "psnr_mean_gap_db": float(np.mean(psnr_gap)),
        "image_gap": float(np.max(gap)),
        "image_mean_gap": float(np.mean(gap)),
        "image_rms_gap": rms,
        **extra,
    }


def program_answers(answers: Sequence, idx: Sequence[int]):
    """(pool indices, images, PSNRs, episode lengths) of the chosen
    answers, on the host."""
    chosen = [answers[i] for i in idx]
    images = np.stack([
        a[1].float().cpu().numpy() if isinstance(a[1], torch.Tensor)
        else np.asarray(a[1], np.float32) for a in chosen])
    return ([a[0] for a in chosen], images,
            np.array([a[2] for a in chosen], np.float64),
            np.array([a[3] for a in chosen]))


def judge(numbers: Dict[str, float], limits: Dict) -> Tuple[bool, Dict]:
    """(every number ``limits`` names within its limit, {name: {value,
    limit}})."""
    checks, ok = {}, True
    for name in limits:
        value, limit = numbers[name], float(limits[name]["limit"])
        ok = ok and math.isfinite(value) and value <= limit
        checks[name] = {"value": value, "limit": limit}
    return ok, checks
