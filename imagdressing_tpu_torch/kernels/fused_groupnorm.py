"""Fused GroupNorm(+add)+activation: `act(GN(x + add[b, c]))`.

Port of `imagdressing_tpu/kernels/fused_groupnorm.py` (`_gn_kernel`): fp32
channel sums, the per-(B, C) `add` folded into the moments algebraically
(s1' = s1 + M*t, s2' = s2 + 2*t*s1 + M*t^2), group aggregation on the (B, C)
moments, then one normalize+affine+act pass. The CUDA kernel is
`csrc/groupnorm.cu` (statistics in `csrc/gn_stats.cuh`, shared with the
fused GN+conv).

`group_norm_act` launches the kernel for a CUDA tensor and runs the plain
PyTorch version, `group_norm_act_plain`, only for a CPU tensor. The plain
version repeats the kernel's arithmetic; the CPU tests hold it against the
JAX kernel and the card's smoke run holds the kernel against it.

Gradients: as in the JAX package (`fused_groupnorm.py:_bwd`, `jax.vjp` of
`_xla_reference`), the backward recomputes the unfused chain in PyTorch ops
(`group_norm_act_reference`, fp32 statistics) and differentiates it; the TPU
package has no backward kernel here, so neither has the port. When grad mode
is on and an operand requires a gradient, `group_norm_act` returns the
output of `GroupNormActFunction`, whose forward is the kernel.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from imagdressing_tpu_torch.kernels import _build
from imagdressing_tpu_torch.ops.nn import group_norm

COUNTER = _build.LaunchCounter()
_SOURCE = "groupnorm.cu"
_ACTS = ("none", "silu")


def scale_shift(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                add: Optional[torch.Tensor], *, num_groups: int, eps: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(B, C) fp32 (scale, shift) with GN(x + add) == x*scale + shift.

    x (B, ..., C); add (B, C) or None. E[x^2] - E[x]^2 on fp32 sums, as the
    JAX kernels and `csrc/gn_stats.cuh` compute it."""
    b, c = x.shape[0], x.shape[-1]
    xf = x.float().reshape(b, -1, c)
    m = xf.shape[1]
    s1 = xf.sum(1)
    s2 = (xf * xf).sum(1)
    if add is not None:
        t = add.float()
        s2 = s2 + 2.0 * t * s1 + m * t * t
        s1 = s1 + m * t
    cpg = c // num_groups
    n = float(m * cpg)
    mean = s1.reshape(b, num_groups, cpg).sum(-1) / n
    var = s2.reshape(b, num_groups, cpg).sum(-1) / n - mean * mean
    inv = torch.rsqrt(var + eps)
    scale = inv.repeat_interleave(cpg, dim=-1) * weight.float()
    shift = bias.float() - mean.repeat_interleave(cpg, dim=-1) * scale
    if add is not None:
        shift = shift + add.float() * scale
    return scale, shift


def group_norm_act_plain(x: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor, *, num_groups: int, eps: float,
                         act: str = "none",
                         add: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch (fp32 math, one rounding)."""
    scale, shift = scale_shift(x, weight, bias, add, num_groups=num_groups,
                               eps=eps)
    shape = (x.shape[0],) + (1,) * (x.ndim - 2) + (x.shape[-1],)
    y = x.float() * scale.reshape(shape) + shift.reshape(shape)
    if act == "silu":
        y = torch.nn.functional.silu(y)
    return y.to(x.dtype)


def stats_chunks(batch: int, rows: int) -> Tuple[int, int]:
    """(nchunks, rows_per_chunk) of the statistics pass: about two blocks
    per SM of the H100 over the whole batch, never an empty chunk."""
    want = max(1, min(rows, math.ceil(264 / batch)))
    per = math.ceil(rows / want)
    return math.ceil(rows / per), per


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built library with its functions typed, once per process."""
    lib = _build.load(_SOURCE)
    for fn in (lib.group_norm_act_bf16, lib.group_norm_act_f32):
        fn.argtypes = [_P] * 8 + [_I] * 4 + [_F] + [_I] * 3 + [_P]
        fn.restype = _I
    return lib


def group_norm_act_reference(x: torch.Tensor, weight: torch.Tensor,
                             bias: torch.Tensor, *, num_groups: int,
                             eps: float, act: str = "none",
                             add: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """The JAX package's `_xla_reference` in PyTorch ops: x + add in x's
    dtype, GroupNorm with fp32 statistics rounded to x's dtype, the
    activation in fp32. The backward differentiates this chain."""
    if add is not None:
        shape = (x.shape[0],) + (1,) * (x.ndim - 2) + (x.shape[-1],)
        x = x + add.reshape(shape).to(x.dtype)
    out = group_norm(x, weight, bias, num_groups=num_groups, eps=eps).float()
    if act == "silu":
        out = torch.nn.functional.silu(out)
    return out.to(x.dtype)


def vjp_of_reference(fn, inputs, needs, g, **kwargs):
    """Gradients of `fn(*inputs, **kwargs)` against `g` for the inputs whose
    `needs` flag is set (None for the others): the recompute-and-
    differentiate backward that the GroupNorm and GN+conv Functions share."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(n) if t is not None else None
                  for t, n in zip(inputs, needs)]
        y = fn(*leaves, **kwargs)
        want = [t for t, n in zip(leaves, needs) if t is not None and n]
        got = iter(torch.autograd.grad(y, want, g))
    return [next(got) if t is not None and n else None
            for t, n in zip(leaves, needs)]


def _forward(x, weight, bias, add, num_groups, eps, act):
    """The plain version for a CPU tensor, the kernel for a CUDA tensor."""
    if x.device.type == "cpu":
        return group_norm_act_plain(x, weight, bias, num_groups=num_groups,
                                    eps=eps, act=act, add=add)
    return _launch(x, weight, bias, add, num_groups, eps, act)


class GroupNormActFunction(torch.autograd.Function):
    """Kernel forward; the backward differentiates
    `group_norm_act_reference` (JAX `fused_group_norm_act`'s custom VJP)."""

    @staticmethod
    def forward(ctx, x, weight, bias, add, num_groups, eps, act):
        ctx.cfg = dict(num_groups=num_groups, eps=eps, act=act)
        ctx.save_for_backward(x, weight, bias, add)
        return _forward(x, weight, bias, add, num_groups, eps, act)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, weight, bias, add = ctx.saved_tensors
        cfg = ctx.cfg

        def ref(x_, w_, b_, a_):
            return group_norm_act_reference(x_, w_, b_, add=a_, **cfg)

        grads = vjp_of_reference(ref, (x, weight, bias, add),
                                 ctx.needs_input_grad[:4], g)
        return (*grads, None, None, None)


def group_norm_act(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   *, num_groups: int, eps: float, act: str = "none",
                   add: Optional[torch.Tensor] = None) -> torch.Tensor:
    """act(GroupNorm(x + add[:, None, ..., :])) over the channel-last axis.

    x (B, ..., C) contiguous; weight/bias (C,); add (B, C) or None; act
    "none" or "silu". A CPU tensor takes the plain version; a CUDA tensor
    launches `csrc/groupnorm.cu`. Differentiable (see the module note)."""
    if act not in _ACTS:
        raise ValueError(f"act must be one of {_ACTS}, got {act!r}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, weight, bias, add)):
        return GroupNormActFunction.apply(x, weight, bias, add, num_groups,
                                          eps, act)
    return _forward(x, weight, bias, add, num_groups, eps, act)


def _launch(x, weight, bias, add, num_groups, eps, act):
    if x.device.type != "cuda":
        raise ValueError(f"group_norm_act: unsupported device {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"group_norm_act: dtype {x.dtype}")
    b, c = x.shape[0], x.shape[-1]
    m = x.numel() // (b * c)
    if c % num_groups or c % 8:
        raise ValueError(f"group_norm_act: C={c} with {num_groups} groups")
    if not x.is_contiguous():
        raise ValueError("group_norm_act: x must be contiguous")
    params = [p.contiguous().to(x.dtype) for p in (weight, bias)]
    addc = None
    if add is not None:
        if add.shape != (b, c):
            raise ValueError(f"group_norm_act: add {tuple(add.shape)}")
        addc = add.contiguous().to(x.dtype)
    _build.check_operands("group_norm_act", x, *params,
                          *([addc] if addc is not None else []))
    nchunks, per = stats_chunks(b, m)
    out = torch.empty_like(x)
    partial = torch.empty((b, nchunks, c, 2), device=x.device,
                          dtype=torch.float32)
    scale = torch.empty((b, c), device=x.device, dtype=torch.float32)
    shift = torch.empty_like(scale)
    lib = _lib()
    fn = lib.group_norm_act_bf16 if x.dtype == torch.bfloat16 \
        else lib.group_norm_act_f32
    rc = fn(x.data_ptr(), addc.data_ptr() if addc is not None else None,
            params[0].data_ptr(), params[1].data_ptr(), out.data_ptr(),
            partial.data_ptr(), scale.data_ptr(), shift.data_ptr(),
            b, m, c, num_groups, eps, int(act == "silu"), nchunks, per,
            _build.stream_handle(x.device))
    _build.check(rc, "group_norm_act")
    COUNTER.add((tuple(x.shape), act))
    return out
