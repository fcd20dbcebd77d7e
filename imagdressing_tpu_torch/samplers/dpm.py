"""DPM-Solver++(2M): the second-order multistep ODE sampler in its
data-prediction form (port of `imagdressing_tpu/samplers/dpm.py`).

    lambda_t = log(alpha_t / sigma_t),  h_i = lambda_{i+1} - lambda_i
    x0_i = (x_i - sigma_i eps(x_i, t_i)) / alpha_i
    x_{i+1} = (sigma_{i+1}/sigma_i) x_i - alpha_{i+1} expm1(-h_i) D_i
    first step:  D_i = x0_i
    later steps: D_i = (1 + 1/(2 r_i)) x0_i - 1/(2 r_i) x0_{i-1},
                 r_i = h_{i-1} / h_i

A Python loop over the same static fp32 tables as the JAX scan; each step's
coefficients are host numbers, so a step copies nothing to the device.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from imagdressing_tpu_torch.samplers import ddim

EpsFn = Callable[[torch.Tensor, int], torch.Tensor]


def lambda_tables(sched: ddim.DDIMSchedule, num_steps: int,
                  t_start: int = 0):
    """Per used step (ts, alpha, sigma, lambda) and the same of the next
    solver point (alpha_n, sigma_n, lambda_n), fp32. `t_start` drops the
    first steps (inpaint strength); the next point of the last step is the
    terminal one (final_alpha_cumprod)."""
    ts = ddim.timesteps(sched, num_steps)[t_start:]
    ac = sched.alphas_cumprod
    abar = ac[ts]
    prev = np.concatenate([ts[1:], np.full((1,), -1, ts.dtype)])
    abar_next = np.where(prev >= 0, ac[np.maximum(prev, 0)],
                         sched.final_alpha_cumprod).astype(np.float32)
    alpha, sigma = np.sqrt(abar), np.sqrt(np.float32(1.0) - abar)
    alpha_n = np.sqrt(abar_next)
    sigma_n = np.sqrt(np.maximum(np.float32(1.0) - abar_next,
                                 np.float32(1e-12)))
    lam = np.log(alpha / np.maximum(sigma, np.float32(1e-12)))
    lam_n = np.log(alpha_n / sigma_n)
    return ts, alpha, sigma, lam, alpha_n, sigma_n, lam_n


def sample_loop(sched: ddim.DDIMSchedule, eps_fn: EpsFn,
                latents: torch.Tensor, num_inference_steps: int, *,
                t_start: int = 0,
                post_fn: Optional[ddim.PostStepFn] = None) -> torch.Tensor:
    """Run the solver from `latents`; eps_fn(x, t) -> the CFG-combined eps
    at integer timestep t; post_fn(x_next, t_next, is_last) after each
    update. Returns fp32 latents."""
    ts, alpha, sigma, lam, alpha_n, sigma_n, lam_n = lambda_tables(
        sched, num_inference_steps, t_start)
    ts_next = ddim.next_timesteps(ts)
    x = latents.float()
    x0_prev = None
    lam_prev = np.float32(0.0)
    for i, t in enumerate(ts):
        eps = eps_fn(x, int(t)).float()
        x0 = (x - float(sigma[i]) * eps) / float(alpha[i])
        h = lam_n[i] - lam[i]
        if x0_prev is None:
            d = x0
        else:
            r = (lam[i] - lam_prev) / h
            coeff = np.float32(1.0) / (np.float32(2.0) * r)
            d = float(np.float32(1.0) + coeff) * x0 - float(coeff) * x0_prev
        x = (float(sigma_n[i] / sigma[i]) * x
             - float(alpha_n[i] * np.expm1(-h)) * d)
        if post_fn is not None:
            x = post_fn(x, int(ts_next[i]), i == len(ts) - 1)
        x0_prev, lam_prev = x0, lam[i]
    return x
