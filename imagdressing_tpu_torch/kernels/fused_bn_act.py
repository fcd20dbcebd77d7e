"""Folded batch norm + activation, the inference pass of InPlaceABN:
`act(x * scale + shift)` per channel of a channel-last tensor.

Port of `imagdressing_tpu/kernels/fused_bn_act.py` (`abn_inference`, whose
Pallas kernel is `_fused_kernel`). The scale and shift are folded from the
running statistics in fp32 and rounded to x's dtype, as the JAX package does
(in bf16 that rounding is part of the function); the pass itself is fp32
arithmetic with one rounding on store. Activations: "none", "leaky_relu"
(`x >= 0 ? x : slope * x`) and "elu" (`x >= 0 ? x : expm1(x)`).

`abn_inference` launches `csrc/bn_act.cu` for a CUDA tensor (the fold runs
in the kernel's prologue, so one launch per call) and runs the plain PyTorch
version, `abn_inference_plain`, only for a CPU tensor. The kernel takes every
shape SCHP produces (no shape gate): any row count and any C that is a
multiple of 8.

`abn_train` / `abn_train_stats` are the training-mode ABN of the fine-tune
(the JAX `abn_train` custom VJP, XLA math there): fp32 batch moments, then
the apply as one K7 launch with the batch mean and biased variance in the
places of the running statistics (K7's own function, folded). Its backward
is InPlaceABN's: only the output y, the affine parameters and the
per-channel mean and rsqrt are saved (never x), and the pre-activation is
rebuilt by inverting the activation. With a process group the moments and
the backward's sums are all-reduced (InPlaceABNSync). `abn_inference` has
no backward and raises when asked for a gradient.
"""

from __future__ import annotations

import ctypes

import torch
import torch.distributed as dist

from imagdressing_tpu_torch.kernels import _build

COUNTER = _build.LaunchCounter()
_SOURCE = "bn_act.cu"
ACTIVATIONS = ("none", "leaky_relu", "elu")


def _act(y: torch.Tensor, activation: str, slope: float) -> torch.Tensor:
    if activation == "leaky_relu":
        return torch.where(y >= 0, y, slope * y)
    if activation == "elu":
        return torch.where(y >= 0, y, torch.expm1(y))
    return y


def _act_inverse(y: torch.Tensor, activation: str, slope: float
                 ) -> torch.Tensor:
    """The pre-activation from the output (the InPlaceABN trick). elu's
    output is clamped just inside its asymptote -1: a saturated y of
    exactly -1 would give log1p(-1) = -inf and a NaN downstream, where the
    activation's gradient there (~1e-7) makes the rebuilt value irrelevant
    (JAX `_act_inverse`)."""
    if activation == "leaky_relu":
        return torch.where(y >= 0, y, y / slope)
    if activation == "elu":
        return torch.where(y >= 0, y,
                           torch.log1p(torch.clamp(y, min=-1.0 + 1e-7)))
    return y


def _act_grad_from_output(y: torch.Tensor, activation: str, slope: float
                          ) -> torch.Tensor:
    """d act / d pre-activation, written with the output y."""
    if activation == "leaky_relu":
        return torch.where(y >= 0, 1.0, slope)
    if activation == "elu":
        return torch.where(y >= 0, 1.0, y + 1.0)
    return torch.ones_like(y)


def _compute_dtype(x: torch.Tensor) -> torch.dtype:
    """fp32 for bf16 and fp32 inputs (the kernels' arithmetic); fp64 stays
    fp64 on the CPU (the float64 reference of the card checks)."""
    return torch.promote_types(x.dtype, torch.float32)


def abn_inference_plain(x: torch.Tensor, weight: torch.Tensor,
                        bias: torch.Tensor, running_mean: torch.Tensor,
                        running_var: torch.Tensor, *, eps: float = 1e-5,
                        activation: str = "leaky_relu",
                        slope: float = 0.01) -> torch.Tensor:
    """The kernel's function in plain PyTorch (the JAX package's XLA
    branch, `fused_bn_act.py:125-140`): scale and shift folded in fp32
    and rounded to x's dtype, then one fp32 pass."""
    cdt = _compute_dtype(x)
    inv = torch.rsqrt(running_var.to(cdt) + eps)
    w = weight.to(cdt)
    scale = (w * inv).to(x.dtype)
    shift = (bias.to(cdt) - running_mean.to(cdt) * w * inv).to(x.dtype)
    y = x.to(cdt) * scale.to(cdt) + shift.to(cdt)
    return _act(y, activation, slope).to(x.dtype)


_P, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
# the launch function per dtype, typed once: a parse calls it 238 times and
# each launch moves only microseconds of data, so the wrapper stays lean
_FNS = {}


def _fn(dtype: torch.dtype):
    if not _FNS:
        lib = _build.load(_SOURCE)
        for name, dt in (("bn_act_bf16", torch.bfloat16),
                         ("bn_act_f32", torch.float32)):
            fn = getattr(lib, name)
            fn.argtypes = [_P] * 6 + [_LL, _I, _F, _I, _F, _P]
            fn.restype = _I
            _FNS[dt] = fn
    return _FNS[dtype]


def abn_inference(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  running_mean: torch.Tensor, running_var: torch.Tensor, *,
                  eps: float = 1e-5, activation: str = "leaky_relu",
                  slope: float = 0.01) -> torch.Tensor:
    """act(BN_eval(x)) over the last axis of a contiguous (..., C) tensor,
    fp32 or bf16; weight, bias and the running statistics (C,). A CPU tensor
    takes the plain version; a CUDA tensor launches `csrc/bn_act.cu`."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"activation must be one of {ACTIVATIONS}, "
                         f"got {activation!r}")
    if not x.is_contiguous():
        raise ValueError("abn_inference: x must be contiguous")
    if torch.is_grad_enabled() and any(
            t.requires_grad
            for t in (x, weight, bias, running_mean, running_var)):
        raise NotImplementedError(
            "abn_inference has no backward; call it under torch.no_grad(), "
            "or train with abn_train")
    if x.device.type == "cpu":
        return abn_inference_plain(x, weight, bias, running_mean, running_var,
                                   eps=eps, activation=activation, slope=slope)
    return _launch(x, weight, bias, running_mean, running_var, eps,
                   activation, slope)


def _launch(x, weight, bias, running_mean, running_var, eps, activation,
            slope):
    if x.device.type != "cuda":
        raise ValueError(f"abn_inference: unsupported device {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"abn_inference: dtype {x.dtype}")
    c = x.shape[-1]
    if c % 8:
        raise ValueError(f"abn_inference: C={c} is not a multiple of 8")
    params = [p.float().contiguous()
              for p in (weight, bias, running_mean, running_var)]
    if any(p.shape != (c,) for p in params):
        raise ValueError(f"abn_inference: parameters of shape "
                         f"{[tuple(p.shape) for p in params]} for C={c}")
    out = torch.empty_like(x)
    m = x.numel() // c
    if m == 0:
        return out
    _build.check_operands("abn_inference", x, *params, out)
    rc = _fn(x.dtype)(x.data_ptr(), *(p.data_ptr() for p in params),
                      out.data_ptr(), m, c, eps,
                      ACTIVATIONS.index(activation), slope,
                      _build.stream_handle(x.device))
    _build.check(rc, "abn_inference")
    COUNTER.add((tuple(x.shape), str(x.dtype), activation))
    return out


# ---------------------------------------------------------------------------
# Training-mode ABN: batch statistics, inverse-recompute backward
# ---------------------------------------------------------------------------


def _all_reduce_mean(t: torch.Tensor, group) -> torch.Tensor:
    dist.all_reduce(t, group=group)
    return t / dist.get_world_size(group)


def batch_moments(x: torch.Tensor, group=None
                  ) -> "tuple[torch.Tensor, torch.Tensor]":
    """The mean and biased variance (fp32; fp64 for fp64) over every axis
    but the last
    (E[x^2] - E[x]^2, as the JAX `_abn_train_fwd_impl`); with a process
    group the two moments are averaged across it first (per-rank
    variances would not average to the global one)."""
    xf = x.to(_compute_dtype(x))
    dims = tuple(range(x.dim() - 1))
    moments = torch.stack([xf.mean(dims), (xf * xf).mean(dims)])
    if group is not None:
        moments = _all_reduce_mean(moments, group)
    mean, mean_sq = moments
    return mean, mean_sq - mean * mean


class AbnTrainFunction(torch.autograd.Function):
    """(y, mean, var) = ABN_train(x, weight, bias); mean and var carry no
    gradient."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, activation, slope, group):
        mean, var = batch_moments(x, group)
        # K7 on a CUDA tensor, its plain version on a CPU one: the batch
        # statistics take the running statistics' places
        y = abn_inference(x, weight, bias, mean, var, eps=eps,
                          activation=activation, slope=slope)
        ctx.save_for_backward(y, weight, bias, mean, torch.rsqrt(var + eps))
        ctx.cfg = (activation, slope, group)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        y, weight, bias, mean, inv = ctx.saved_tensors
        activation, slope, group = ctx.cfg
        cdt = _compute_dtype(y)
        yf, gyf = y.to(cdt), gy.to(cdt)
        w, b = weight.to(cdt), bias.to(cdt)
        z = _act_inverse(yf, activation, slope)
        dz = gyf * _act_grad_from_output(yf, activation, slope)
        xhat = (z - b) / torch.where(w == 0, 1.0, w)
        dims = tuple(range(y.dim() - 1))
        n = y.numel() // y.shape[-1]
        sums = torch.stack([dz.sum(dims), (dz * xhat).sum(dims)])
        if group is not None:
            dist.all_reduce(sums, group=group)
            n *= dist.get_world_size(group)
        sum_dz, sum_dz_xhat = sums
        dx = (w * inv) * (dz - (xhat * sum_dz_xhat + sum_dz) / n)
        return (dx.to(y.dtype), sum_dz_xhat.to(weight.dtype),
                sum_dz.to(bias.dtype), None, None, None, None)


def abn_train_stats(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    *, eps: float = 1e-5, activation: str = "leaky_relu",
                    slope: float = 0.01, group=None):
    """act(BN_train(x)) over the last axis of a contiguous (..., C) tensor
    with batch statistics, and those statistics (fp32 mean, biased
    variance; no gradient) for the running-statistics EMA. `group`: a
    torch.distributed process group to sync the statistics over (the JAX
    package's `axis_name`), or None."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"activation must be one of {ACTIVATIONS}, "
                         f"got {activation!r}")
    return AbnTrainFunction.apply(x, weight, bias, eps, activation, slope,
                                  group)


def abn_train(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, *,
              eps: float = 1e-5, activation: str = "leaky_relu",
              slope: float = 0.01, group=None) -> torch.Tensor:
    """`abn_train_stats` without the statistics."""
    return abn_train_stats(x, weight, bias, eps=eps, activation=activation,
                           slope=slope, group=group)[0]
