"""PnP-ADMM environment for CSMRI, as functions over a state dataclass.

Counterpart of the JAX package's ``env/pnp.py``, with the same semantics:
batched over a leading slice axis, and the early stop on the action
``T > 0.5`` is a per-slice ``done`` mask that freezes the slice, so every
step is batch-uniform. The k-space state is complex64 on the device; ``x``
is real, as in the JAX package.

One ADMM iteration:
    x   = denoiser(Re(z - u), sigma_d)            # plug-in prior
    z~  = F(x + u)                                # centered ortho FFT
    z~  = (mu*z~ + y0)/(1+mu) on sampled k-space  # kernel K2
    z   = F^-1(z~)
    u   = u + x - z                               # dual ascent
    T  += 1/30
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Optional, Tuple

import numpy as np
import torch

from ..ops.fourier import fft2c, ifft2c
from ..ops.kernels.kspace import kspace_consistency_kernel
from ..ops.metrics import psnr
from ..utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class CSMRIState:
    """ADMM state for a batch of CSMRI slices, layout (B, 1, H, W)."""
    x: torch.Tensor      # float32, current estimate (real)
    z: torch.Tensor      # complex64, split variable
    u: torch.Tensor      # complex64, scaled dual
    mask: torch.Tensor   # bool, k-space sampling mask
    y0: torch.Tensor     # complex64, measured k-space
    gt: torch.Tensor     # float32, ground truth
    T: torch.Tensor      # (B,) float32, normalised step counter
    done: torch.Tensor   # (B,) bool, episode termination mask

    @property
    def batch(self) -> int:
        return self.x.shape[0]

    @property
    def x_real(self) -> torch.Tensor:
        return self.x

    def replace(self, **changes) -> "CSMRIState":
        return dataclasses.replace(self, **changes)


Action = Mapping[str, Any]  # keys: 'T', 'mu', 'sigma_d'

DenoiseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
# (B, 1, H, W) image, (B,) sigma -> (B, 1, H, W) denoised


def reset_from_mat(mat: Mapping[str, Any], image_size: Optional[int] = None,
                   device="cuda") -> CSMRIState:
    """Initial state from a .mat record dict with keys x0, y0
    (..., H, W, 2 real/imag pairs), mask (..., H, W) and gt (..., H, W);
    leading batch dims collapse into one. ``image_size`` defaults to the
    record's own square geometry."""
    dev = resolve_device(device)
    s = int(image_size) if image_size \
        else int(np.asarray(mat["mask"]).shape[-1])

    def cplx(arr):
        ri = np.ascontiguousarray(np.asarray(arr, np.float32).reshape(
            -1, 1, s, s, 2))
        return torch.view_as_complex(torch.from_numpy(ri)).to(dev)

    x0 = cplx(mat["x0"])
    # ascontiguousarray: scipy.io.loadmat returns Fortran-ordered arrays.
    mask = torch.from_numpy(np.ascontiguousarray(
        np.asarray(mat["mask"]).reshape(-1, 1, s, s), dtype=bool)).to(dev)
    gt = torch.from_numpy(np.ascontiguousarray(
        np.asarray(mat["gt"], np.float32).reshape(-1, 1, s, s))).to(dev)
    b = x0.shape[0]
    return CSMRIState(
        x=x0.real.contiguous(), z=x0, u=torch.zeros_like(x0), mask=mask,
        y0=cplx(mat["y0"]), gt=gt,
        T=torch.zeros(b, dtype=torch.float32, device=dev),
        done=torch.zeros(b, dtype=torch.bool, device=dev))


def _per_slice(value, b: int, device) -> torch.Tensor:
    """Broadcast an action component (scalar or per-slice) to (B,)."""
    return torch.as_tensor(value, dtype=torch.float32,
                           device=device).reshape(-1).expand(b).contiguous()


@torch.no_grad()
def admm_step(denoise: DenoiseFn, state: CSMRIState, action: Action,
              done_threshold: float = 0.5) -> CSMRIState:
    """One masked PnP-ADMM iteration. Where ``done`` or the stop action
    ``T > done_threshold`` holds, the slice is frozen; ``done`` records the
    stop."""
    b, dev = state.batch, state.x.device
    t_act = _per_slice(action["T"], b, dev)
    mu = _per_slice(action["mu"], b, dev)
    sigma_d = _per_slice(action["sigma_d"], b, dev)

    stop_now = t_act > done_threshold
    active = ~(state.done | stop_now)

    x_real = denoise(state.z.real - state.u.real, sigma_d)
    z_k = fft2c(x_real.to(torch.complex64) + state.u)
    z_k = kspace_consistency_kernel(z_k, state.y0, state.mask, mu)
    z_c = ifft2c(z_k)
    u_c = state.u + x_real - z_c

    keep = active[:, None, None, None]
    return state.replace(
        x=torch.where(keep, x_real, state.x),
        z=torch.where(keep, z_c, state.z),
        u=torch.where(keep, u_c, state.u),
        T=torch.where(active, state.T + 1.0 / 30.0, state.T),
        done=state.done | stop_now)


def compute_reward(state: CSMRIState) -> torch.Tensor:
    """PSNR of the current estimate vs ground truth, (B, 1)."""
    return psnr(state.x_real, state.gt)


def get_policy_ob(state: CSMRIState) -> torch.Tensor:
    """Flattened real part of x, (B, H*W)."""
    return state.x_real.reshape(state.batch, -1)


@torch.no_grad()
def fixed_param_rollout(denoise: DenoiseFn, state: CSMRIState, mu: float,
                        sigma_d: float, n_iters: int = 30
                        ) -> Tuple[CSMRIState, torch.Tensor]:
    """Fixed-parameter PnP-ADMM for ``n_iters`` iterations. Returns the
    final state and the per-iteration PSNR history (n_iters, B, 1)."""
    action = {"T": 0.0, "mu": mu, "sigma_d": sigma_d}
    history = []
    for _ in range(n_iters):
        state = admm_step(denoise, state, action)
        history.append(compute_reward(state))
    return state, torch.stack(history)


@dataclasses.dataclass
class PnPEnv:
    """Object wrapper bundling the denoiser, mirroring the reference's
    environment class."""
    denoiser: DenoiseFn
    max_episode_step: int = 30
    image_size: Optional[int] = None  # None = infer from each record
    device: Any = "cuda"

    def reset(self, mat: Mapping[str, Any]) -> CSMRIState:
        return reset_from_mat(mat, self.image_size, self.device)

    def step(self, state: CSMRIState, action: Action
             ) -> Tuple[CSMRIState, torch.Tensor]:
        new = admm_step(self.denoiser, state, action)
        return new, new.done

    @staticmethod
    def get_policy_ob(state: CSMRIState) -> torch.Tensor:
        return get_policy_ob(state)

    @staticmethod
    def compute_reward(state: CSMRIState) -> torch.Tensor:
        return compute_reward(state)
