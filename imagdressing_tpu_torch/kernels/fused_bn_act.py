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

The fine-tune path (`abn_train`, with its inverse-recompute backward) is not
ported; asking for a gradient through `abn_inference` raises.
"""

from __future__ import annotations

import ctypes

import torch

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


def abn_inference_plain(x: torch.Tensor, weight: torch.Tensor,
                        bias: torch.Tensor, running_mean: torch.Tensor,
                        running_var: torch.Tensor, *, eps: float = 1e-5,
                        activation: str = "leaky_relu",
                        slope: float = 0.01) -> torch.Tensor:
    """The kernel's function in plain PyTorch (the JAX package's XLA
    branch, `fused_bn_act.py:125-140`): scale and shift folded in fp32
    and rounded to x's dtype, then one fp32 pass."""
    inv = torch.rsqrt(running_var.float() + eps)
    w = weight.float()
    scale = (w * inv).to(x.dtype)
    shift = (bias.float() - running_mean.float() * w * inv).to(x.dtype)
    y = x.float() * scale.float() + shift.float()
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
            "abn_inference has no backward (the training-mode ABN is not "
            "ported); call it under torch.no_grad()")
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
