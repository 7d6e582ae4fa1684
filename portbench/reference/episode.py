"""Greedy DT4IR episodes, batched (eval.py:62-220 with env.py:74-100).

Each row is one slice. The rows run in lockstep: a row that stops (its
action ``T`` over 0.5) or reaches ``max_timesteps`` is frozen and keeps
its episode length, as the reference's early return does for one slice.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from .model import dt_forward, precision_scope

# Column of each action key in the policy's output, per mode
# (decision_transformer.py:147-154).
MODE_COLS = {"norm": ("T", "sigma_d", "mu"), "flex": ("mu", "sigma_d", "T")}
DONE_THRESHOLD = 0.5


def _fft2c(t):
    t = torch.fft.ifftshift(t, dim=(-2, -1))
    t = torch.fft.fftn(t, dim=(-2, -1), norm="ortho")
    return torch.fft.fftshift(t, dim=(-2, -1))


def _ifft2c(t):
    t = torch.fft.ifftshift(t, dim=(-2, -1))
    t = torch.fft.ifftn(t, dim=(-2, -1), norm="ortho")
    return torch.fft.fftshift(t, dim=(-2, -1))


def psnr_db(x: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """torch_psnr (env.py:120-125) per row: both clamped to [0, 1], then
    10 log10(1 / mse). (B, H, W) -> (B,)."""
    a = torch.clamp(x, 0, 1).reshape(x.shape[0], -1)
    b = torch.clamp(gt, 0, 1).reshape(gt.shape[0], -1)
    return 10.0 * torch.log10(1.0 / torch.mean((a - b) ** 2, dim=1))


@torch.no_grad()
def greedy_episodes(dt_sd: Dict[str, torch.Tensor], denoise: Callable,
                    inputs: Dict[str, torch.Tensor], max_timesteps: int,
                    context: int, n_heads: int, mode: str = "norm",
                    precision: str = "float32"
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The greedy evaluation of every row of ``inputs``.

    ``denoise(img (B, 1, H, W), sigma (B,), precision)``: the prior's
    reference on its weights (a ``priors/<prior>.py`` ``reference`` with
    its state dict bound).
    ``inputs``: ``x0`` and ``y0`` (B, H, W) complex, ``mask`` (B, H, W)
    bool, ``rtg`` (B,) the normalised RTG target, ``task`` (B,) the task
    token. The env starts from x0 clipped at 0 (datasets.py:160), both
    parts of each pixel; the
    policy's first observation is the real part of the unclipped x0
    (datasets.py:163). Returns (final real images (B, H, W), episode
    lengths (B,))."""
    x0, y0 = inputs["x0"], inputs["y0"]
    b, h, w = x0.shape
    dev = x0.device
    mask = inputs["mask"].bool()
    cols = MODE_COLS[mode]
    c_t, c_sigma, c_mu = (cols.index(k) for k in ("T", "sigma_d", "mu"))
    n_act = len(cols)

    # The record's clip acts on the real/imaginary pairs: both parts.
    x0c = torch.complex(torch.clamp(x0.real, min=0),
                        torch.clamp(x0.imag, min=0))
    x, z, u = x0c.real.clone(), x0c.clone(), torch.zeros_like(x0c)

    states = torch.zeros(b, max_timesteps, h * w, device=dev)
    actions = torch.zeros(b, max_timesteps, n_act, device=dev)
    rtg = torch.zeros(b, max_timesteps, 1, device=dev)
    states[:, 0] = x0.real.reshape(b, -1)
    rtg[:, 0, 0] = inputs["rtg"]
    task = inputs["task"].long()[:, None].expand(b, context)

    def forward(lo, hi, acts, r=None):
        ts = torch.arange(lo, hi, device=dev)[None].expand(b, hi - lo)
        return dt_forward(dt_sd, rtg[:, lo:hi] if r is None else r,
                          states[:, lo:hi], ts, task, acts, n_heads,
                          precision)

    with precision_scope(precision):
        pa, _ = forward(0, context, None)
        action = pa[:, 0]
        actions[:, 0] = action
        _, pr = forward(0, context, torch.zeros(b, context, n_act,
                                                device=dev),
                        torch.zeros(b, context, 1, device=dev))
        pred_rtg = pr[:, 0, 0]

        finished = torch.zeros(b, dtype=torch.bool, device=dev)
        ep_len = torch.full((b,), max_timesteps, dtype=torch.long,
                            device=dev)
        for t in range(1, max_timesteps + 1):
            stop = action[:, c_t] > DONE_THRESHOLD
            step = (~finished & ~stop)[:, None, None]
            xn = denoise((z - u).real[:, None], action[:, c_sigma],
                         precision)[:, 0]
            mu = action[:, c_mu][:, None, None]
            zn = _fft2c(xn.to(torch.complex64) + u)
            zn = torch.where(mask, (mu * zn + y0) / (1 + mu), zn)
            zn = _ifft2c(zn)
            un = u + xn - zn
            x = torch.where(step, xn, x)
            z = torch.where(step, zn, z)
            u = torch.where(step, un, u)

            now = ~finished & (stop | (t == max_timesteps))
            ep_len = torch.where(now, torch.full_like(ep_len, t), ep_len)
            finished = finished | now
            if t == max_timesteps or bool(finished.all()):
                break
            live = ~finished
            states[:, t] = x.reshape(b, -1)
            rtg[:, t, 0] = pred_rtg
            lo, hi = (0, context) if t < context else (t - context, t)
            pa, _ = forward(lo, hi, actions[:, lo:hi])
            idx = t if t < context else context - 1
            new = pa[:, idx]
            actions[:, t] = torch.where(live[:, None], new, actions[:, t])
            action = torch.where(live[:, None], new, action)
            _, pr = forward(lo, hi, actions[:, lo:hi])
            rtg_idx = t if t < context else context - 2
            pred_rtg = torch.where(live, pr[:, rtg_idx, 0], pred_rtg)
    return x, ep_len
