"""DDIM schedule, the update (deterministic at eta = 0, the diffusers
variance with per-step noise at eta > 0), the forward noising and the SNR
(port of `imagdressing_tpu/samplers/ddim.py`). The numpy tables are the
port's own copy. A step's coefficients are Python numbers computed on the
host in fp32 (as the JAX update computes them); the forward noising and the
SNR read alphas_cumprod from a copy held on the device once per schedule.
So neither copies anything to the device or waits for it. Training uses
the zero-SNR, trailing-spacing schedule (`TRAIN_SCHEDULER`)."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from imagdressing_tpu_torch.core.config import SchedulerConfig


TRAIN_SCHEDULER = SchedulerConfig(rescale_betas_zero_snr=True,
                                  timestep_spacing="trailing")


@dataclasses.dataclass(frozen=True)
class DDIMSchedule:
    cfg: SchedulerConfig
    alphas_cumprod: np.ndarray  # (T,) float32
    final_alpha_cumprod: float
    # alphas_cumprod on each device it was asked for (`alphas_on`)
    _on_device: Dict[torch.device, torch.Tensor] = dataclasses.field(
        default_factory=dict, compare=False, repr=False)

    @property
    def init_noise_sigma(self) -> float:
        return 1.0


def _betas(cfg: SchedulerConfig) -> np.ndarray:
    if cfg.beta_schedule == "scaled_linear":
        return np.linspace(cfg.beta_start**0.5, cfg.beta_end**0.5,
                           cfg.num_train_timesteps, dtype=np.float64) ** 2
    if cfg.beta_schedule == "linear":
        return np.linspace(cfg.beta_start, cfg.beta_end,
                           cfg.num_train_timesteps, dtype=np.float64)
    raise ValueError(cfg.beta_schedule)


def _rescale_zero_terminal_snr(alphas_cumprod: np.ndarray) -> np.ndarray:
    """diffusers `rescale_zero_terminal_snr` (on sqrt alpha-bar)."""
    sqrt = np.sqrt(alphas_cumprod)
    t0, t_end = sqrt[0].copy(), sqrt[-1].copy()
    sqrt -= t_end
    sqrt *= t0 / (t0 - t_end)
    return sqrt**2


def make_schedule(cfg: SchedulerConfig = SchedulerConfig()) -> DDIMSchedule:
    alphas_cumprod = np.cumprod(1.0 - _betas(cfg))
    if cfg.rescale_betas_zero_snr:
        alphas_cumprod = _rescale_zero_terminal_snr(alphas_cumprod)
    final = 1.0 if cfg.set_alpha_to_one else float(alphas_cumprod[0])
    return DDIMSchedule(cfg=cfg,
                        alphas_cumprod=alphas_cumprod.astype(np.float32),
                        final_alpha_cumprod=final)


def timesteps(sched: DDIMSchedule, num_inference_steps: int) -> np.ndarray:
    """Descending inference timesteps (int32), diffusers set_timesteps."""
    cfg = sched.cfg
    total = cfg.num_train_timesteps
    if cfg.timestep_spacing == "leading":
        ratio = total // num_inference_steps
        ts = (np.arange(num_inference_steps) * ratio).round()[::-1]
        ts = ts.astype(np.int64) + cfg.steps_offset
    elif cfg.timestep_spacing == "trailing":
        ratio = total / num_inference_steps
        ts = np.round(np.arange(total, 0, -ratio)).astype(np.int64) - 1
    else:
        raise ValueError(cfg.timestep_spacing)
    return ts.astype(np.int32)


def step(sched: DDIMSchedule, model_output: torch.Tensor, t: int,
         sample: torch.Tensor, num_inference_steps: int, eta: float = 0.0,
         noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One DDIM update, epsilon prediction. eta = 0:
        x_prev = sqrt(a_prev) * x0 + sqrt(1 - a_prev) * eps.
    eta > 0 adds the diffusers variance with the given per-step `noise`:
        sigma  = eta * sqrt((1 - a_prev) / (1 - a_t) * (1 - a_t / a_prev))
        x_prev = sqrt(a_prev) * x0 + sqrt(1 - a_prev - sigma^2) * eps
                 + sigma * noise.
    prev_t = t - T // num_inference_steps: pass the full step count even
    where the schedule was truncated (inpaint strength)."""
    t = int(t)
    prev_t = t - sched.cfg.num_train_timesteps // num_inference_steps
    # the JAX update computes its coefficients in fp32
    a_t = sched.alphas_cumprod[t]
    a_prev = (sched.alphas_cumprod[prev_t] if prev_t >= 0
              else np.float32(sched.final_alpha_cumprod))
    one = np.float32(1.0)
    c_eps = float(np.sqrt(one - a_t))
    c_x0 = float(np.sqrt(a_t))
    c_prev = float(np.sqrt(a_prev))
    x = sample.float()
    eps = model_output.float()
    x0 = (x - c_eps * eps) / c_x0
    if not eta:
        c_dir = float(np.sqrt(one - a_prev))
        return (c_prev * x0 + c_dir * eps).to(sample.dtype)
    if noise is None:
        raise ValueError("a DDIM step with eta > 0 needs its noise")
    var = (one - a_prev) / (one - a_t) * (one - a_t / a_prev)
    sigma = np.float32(eta) * np.sqrt(var)
    c_dir = float(np.sqrt(one - a_prev - sigma * sigma))
    return (c_prev * x0 + c_dir * eps
            + float(sigma) * noise.float()).to(sample.dtype)


def alphas_on(sched: DDIMSchedule, device: torch.device) -> torch.Tensor:
    """alphas_cumprod (T,) fp32 on `device`, copied there once per
    schedule."""
    device = torch.device(device)
    table = sched._on_device.get(device)
    if table is None:
        table = torch.as_tensor(sched.alphas_cumprod, device=device)
        sched._on_device[device] = table
    return table


def add_noise(sched: DDIMSchedule, original: torch.Tensor,
              noise: torch.Tensor, t: Union[int, torch.Tensor]
              ) -> torch.Tensor:
    """Forward-process noising sqrt(a_t) x0 + sqrt(1 - a_t) eps, fp32 math,
    the result in `original`'s dtype; t an integer timestep or (B,) integer
    timesteps on `original`'s device."""
    table = alphas_on(sched, original.device)
    a = table[t.long()] if torch.is_tensor(t) else table[int(t)]
    a = a.reshape(a.shape + (1,) * (original.ndim - a.ndim))
    return (torch.sqrt(a) * original.float()
            + torch.sqrt(1.0 - a) * noise.float()).to(original.dtype)


def compute_snr(sched: DDIMSchedule, t: torch.Tensor) -> torch.Tensor:
    """SNR(t) = a_t / (1 - a_t), the min-SNR loss weighting."""
    a = alphas_on(sched, t.device)[t.long()]
    return a / (1.0 - a)


def next_timesteps(ts: np.ndarray) -> np.ndarray:
    """The timestep each step's post-step hook sees: the next one, 0 after
    the last."""
    return np.concatenate([ts[1:], np.zeros((1,), ts.dtype)])


# a post-step hook of the sampling loops: (x_next, t_next, is_last) ->
# x_next, as the JAX scans pass it (the inpaint recomposition)
PostStepFn = Callable[[torch.Tensor, int, bool], torch.Tensor]
