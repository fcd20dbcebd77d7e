"""UniPC, order 2, data prediction (port of
`imagdressing_tpu/samplers/unipc.py`), with exact exponential-integrator
coefficients (lambda = log(alpha/sigma), h = lambda_{i+1} - lambda_i):

    x_{i+1} = (sigma_{i+1}/sigma_i) x_i
              + alpha_{i+1} [phi1(h) x0_i + phi2(h) d1]
    phi1(h) = 1 - e^{-h},  phi2(h) = h - 1 + e^{-h}

UniP predicts with the backward difference d1 = (x0_i - x0_{i-1}) / h_prev;
UniC, when the next model evaluation arrives, re-takes the previous
transition with it (no extra evaluation) and recomputes x0 from the
corrected sample with the same eps. A Python loop over the JAX scan's fp32
tables; the coefficients are host numbers.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from imagdressing_tpu_torch.samplers import ddim
from imagdressing_tpu_torch.samplers.dpm import EpsFn, lambda_tables


def _phi1(h: np.float32) -> np.float32:
    return -np.expm1(-h)


def _phi2(h: np.float32) -> np.float32:
    return h - np.float32(1.0) + np.exp(-h)


def sample_loop(sched: ddim.DDIMSchedule, eps_fn: EpsFn,
                latents: torch.Tensor, num_inference_steps: int, *,
                t_start: int = 0,
                post_fn: Optional[ddim.PostStepFn] = None) -> torch.Tensor:
    """As `dpm.sample_loop`, with the UniC corrector."""
    ts, alpha, sigma, lam, alpha_n, sigma_n, lam_n = lambda_tables(
        sched, num_inference_steps, t_start)
    ts_next = ddim.next_timesteps(ts)
    x = latents.float()
    x_prev, x0_prev = x, None
    for i, t in enumerate(ts):
        p = max(i - 1, 0)
        eps = eps_fn(x, int(t)).float()
        x0 = (x - float(sigma[i]) * eps) / float(alpha[i])
        h_prev = lam[i] - lam[p]
        if x0_prev is not None:
            safe_hp = np.float32(1.0) if h_prev == 0 else h_prev
            d1 = (x0 - x0_prev) / float(safe_hp)
            x = (float(sigma[i] / sigma[p]) * x_prev + float(alpha[i])
                 * (float(_phi1(h_prev)) * x0_prev
                    + float(_phi2(h_prev)) * d1))
            x0 = (x - float(sigma[i]) * eps) / float(alpha[i])
            d1 = (x0 - x0_prev) / float(safe_hp)
        h = lam_n[i] - lam[i]
        x_next = (float(sigma_n[i] / sigma[i]) * x
                  + float(alpha_n[i] * _phi1(h)) * x0)
        if x0_prev is not None:
            x_next = x_next + float(alpha_n[i] * _phi2(h)) * d1
        if post_fn is not None:
            x_next = post_fn(x_next, int(ts_next[i]), i == len(ts) - 1)
        x_prev, x0_prev = x, x0
        x = x_next
    return x
