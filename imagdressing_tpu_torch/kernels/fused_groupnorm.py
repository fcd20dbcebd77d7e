"""Fused GroupNorm(+add)+activation: `act(GN(x + add[b, c]))`.

Port of `imagdressing_tpu/kernels/fused_groupnorm.py` (`_gn_kernel`): fp32
channel sums, the per-(B, C) `add` folded into the moments algebraically
(s1' = s1 + M*t, s2' = s2 + 2*t*s1 + M*t^2), group aggregation on the (B, C)
moments, then one normalize+affine+act pass. The CUDA kernels are in
`csrc/gn_stats.cuh` (entry points `csrc/groupnorm.cu`; the fused GN+conv
runs the same launch as its prologue). `gn_plan` picks, per shape, the
resident mode (one cluster launch: each (batch row, slab of whole groups)
lies in a thread-block cluster's shared memory, x read once) or the
streaming mode (two launches) where no cluster holds a slab.

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
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

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


SMS = 132  # streaming multiprocessors of the H100 SXM
THREADS = 256
MAX_SLAB = 256  # channels of a slab: the width of one TMA box
BOX_ROWS = 256  # rows of one TMA box
# blocks of a cluster: the portable limit. Clusters of 9-16 (with the
# non-portable attribute) measured slower at every UNet level (PERF.md):
# a 16-block cluster at one block per SM does not fit the H100's smallest
# GPC.
MAX_CLUSTER = 8
SMEM_LIMIT = 232448  # bytes of dynamic shared memory a block may use
MAX_BOXES = 64  # TMA boxes (and mbarriers) of a resident block
# a resident block's shared memory beside its rows (csrc/gn_stats.cuh:
# GN_FIXED_SMEM): alignment slack, the row lanes' partials, three float2 per
# slab channel, the boxes' mbarriers
RED_BYTES = 4 * (2 * THREADS * 8 + 2 * THREADS)
FIXED_SMEM = 128 + RED_BYTES + 3 * MAX_SLAB * 8 + MAX_BOXES * 8
STREAM_CLUSTER = 8
STREAM_BLOCKS = 4 * SMS  # blocks of a streaming statistics launch (about)
# The resident plan's cost model, microseconds of a CUDA-graph replay: a
# least-squares fit to every plan of the four UNet levels at batch 1 and 2
# (`tools/time_gn_ops.py --sweep`, H100 80GB HBM3 at 700 W, PERF.md; rms
# error 0.6 us) of a fixed part, a cluster's barriers and exchange, the
# bytes and rows a block holds and the blocks in the grid; and, set by hand
# from the same sweep, a cost per MB of x where a slab's row segment is
# under 128 bytes (narrow segments measured ~1.5 us slower at the top level).
# With silu, each element also takes two special-function operations (exp2
# and a reciprocal) on the SMs the grid occupies: 16 per clock per SM at
# 1.755 GHz.
PLAN_US = dict(fixed=3.55, cluster=1.17, per_rank=0.063, per_kb=0.025,
               per_row=0.0025, per_block=0.0088, narrow_per_mb=0.3,
               sfu_per_us_per_sm=16 * 1755.0)
# Slabs whose row segment is under 32 bytes measured 2-2.5x slower than the
# streaming mode at the VAE's 320x256 level (`--sweep`, PERF.md): not planned.
MIN_SEGMENT_BYTES = 32


def plan_us(b: int, m: int, c: int, itemsize: int, act: str, cs: int,
            sw: int, rpb: int, blocks: int) -> float:
    """The cost model's estimate of a resident plan, in microseconds."""
    k = PLAN_US
    us = (k["fixed"] + (k["cluster"] if cs > 1 else 0.0) + k["per_rank"] * cs
          + k["per_kb"] * rpb * sw * itemsize / 1e3 + k["per_row"] * rpb
          + k["per_block"] * blocks)
    if sw * itemsize < 128:
        us += k["narrow_per_mb"] * b * m * c * itemsize / 1e6
    if act == "silu":
        us += 2.0 * b * m * c / (min(blocks, SMS) * k["sfu_per_us_per_sm"])
    return us


@dataclass(frozen=True)
class GnPlan:
    """How the GroupNorm kernels cover one (B, M, C) shape.

    Resident (`resident` True, one launch): the channels are cut into C /
    `sw` slabs of whole groups; each (batch row, slab) is one cluster of
    `cs` blocks, block r holding rows [r * rpb, (r + 1) * rpb) (rpb =
    `box_rows` * `nboxes`, TMA boxes of box_rows x sw, each a multiple of
    128 bytes so that every box lands 128-byte aligned) in `smem` bytes of
    shared memory. Streaming (two launches): each batch row is cut into
    `nclusters` clusters of `cs` blocks of `rows_per_block` whole rows for
    the statistics, then an apply pass. Mirrors csrc/gn_stats.cuh:GnPlan."""
    resident: bool
    cs: int
    sw: int
    box_rows: int
    nboxes: int
    nclusters: int
    rows_per_block: int
    blocks: int
    smem: int

    @property
    def rpb(self) -> int:
        """Rows of a resident block."""
        return self.box_rows * self.nboxes

    def c_args(self) -> Tuple[int, ...]:
        return (int(self.resident), self.cs, self.sw, self.box_rows,
                self.nboxes, self.nclusters, self.rows_per_block)

    def workspace_floats(self, b: int, c: int) -> int:
        """fp32 words of the streaming workspace: the (b, nclusters, c)
        float2 cluster partials, then scale and shift (b, c); 0 resident."""
        if self.resident:
            return 0
        return 2 * b * self.nclusters * c + 2 * b * c


def resident_smem(rows: int, sw: int, itemsize: int) -> int:
    """Dynamic shared memory of a resident block holding `rows` x `sw`."""
    return FIXED_SMEM + rows * sw * itemsize


def stream_smem(c: int) -> int:
    """Dynamic shared memory of a streaming statistics block
    (csrc/gn_stats.cuh:gn_stream_smem)."""
    return RED_BYTES + 16 * c + 16


def _resident_plans(b: int, m: int, c: int, groups: int, itemsize: int,
                    act: str = "none"):
    """Every resident plan the kernel takes (and the plan allows), each with
    its sort key: the cost model's estimate, then a smaller cluster, then a
    wider slab."""
    unit = math.lcm(c // groups, 8)
    for sw in range(unit, min(c, MAX_SLAB) + 1, unit):
        if c % sw or sw * itemsize < MIN_SEGMENT_BYTES:
            continue
        for cs in range(1, MAX_CLUSTER + 1):
            r = -(-m // cs)
            nboxes = -(-r // BOX_ROWS)
            box_rows = -(-r // nboxes)
            box_rows += -box_rows % (128 // math.gcd(128, sw * itemsize))
            rpb = box_rows * nboxes
            if (cs - 1) * rpb >= m or nboxes > MAX_BOXES:
                continue  # a block without a row, or too many boxes
            smem = resident_smem(rpb, sw, itemsize)
            if smem > SMEM_LIMIT:
                continue
            blocks = b * (c // sw) * cs
            key = (plan_us(b, m, c, itemsize, act, cs, sw, rpb, blocks), cs,
                   -sw)
            yield key, GnPlan(True, cs, sw, box_rows, nboxes, 0, 0, blocks,
                              smem)


def stream_plan(b: int, m: int, c: int) -> GnPlan:
    """The streaming statistics' clusters: STREAM_CLUSTER blocks each, about
    STREAM_BLOCKS blocks over the batch, every cluster with rows."""
    want = max(1, STREAM_BLOCKS // b)
    per = -(-m // want)
    nclusters = -(-m // (per * STREAM_CLUSTER))
    per = -(-m // (nclusters * STREAM_CLUSTER))
    smem = stream_smem(c)
    if smem > SMEM_LIMIT:
        raise ValueError(f"group norm: C={c} is too wide for the kernel")
    return GnPlan(False, STREAM_CLUSTER, 0, 0, 0, nclusters, per,
                  b * nclusters * STREAM_CLUSTER, smem)


@functools.lru_cache(maxsize=None)
def gn_plan(b: int, m: int, c: int, groups: int, dtype: torch.dtype,
            act: str = "none") -> GnPlan:
    """The plan of `act(GN(x + add))` for x (b, m, c) of `dtype`.

    Resident where one (batch row, slab) fits a cluster's shared memory:
    among the slab widths (multiples of lcm(C/G, 8) channels dividing C, at
    most MAX_SLAB, with row segments of at least MIN_SEGMENT_BYTES) and
    cluster sizes (1 .. MAX_CLUSTER), the one the cost model rates fastest
    (`_resident_plans`). Streaming where none fits (the VAE's pixel
    levels). Cached per shape: the search costs more host time than a
    small launch takes on the card."""
    if c % groups or c % 8:
        raise ValueError(f"group norm: C={c} with {groups} groups")
    best = min(_resident_plans(b, m, c, groups, dtype.itemsize, act),
               key=lambda kp: kp[0], default=None)
    if best is not None:
        return best[1]
    return stream_plan(b, m, c)


_COUNTS: Dict[torch.device, torch.Tensor] = {}
MAX_BATCH = 65535  # the grid's z extent


def arrival_counts(device: torch.device) -> torch.Tensor:
    """The streaming statistics' per-batch-row arrival counters on
    `device`: zeroed once, and set back to zero by the launch that used
    them, so one buffer serves every launch in stream order."""
    t = _COUNTS.get(device)
    if t is None:
        t = torch.zeros(MAX_BATCH, dtype=torch.int32, device=device)
        _COUNTS[device] = t
    return t


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built library with its functions typed, once per process."""
    lib = _build.load(_SOURCE)
    for fn in (lib.group_norm_act_bf16, lib.group_norm_act_f32):
        fn.argtypes = [_P] * 7 + [_I] * 4 + [_F] + [_I] * 8 + [_P]
        fn.restype = _I
    lib.gn_resident_max_clusters.argtypes = [_I] * 3
    lib.gn_resident_max_clusters.restype = _I
    return lib


def max_active_clusters(plan: GnPlan, dtype: torch.dtype) -> int:
    """How many of a resident plan's clusters the card holds at once
    (cudaOccupancyMaxActiveClusters); for the tools."""
    return _lib().gn_resident_max_clusters(int(dtype == torch.bfloat16),
                                           plan.cs, plan.smem)


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


def _launch(x, weight, bias, add, num_groups, eps, act, plan=None):
    """The kernel on x's device. `plan` overrides `gn_plan` (for the
    tools); in resident mode the only allocation is the output."""
    if x.device.type != "cuda":
        raise ValueError(f"group_norm_act: unsupported device {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"group_norm_act: dtype {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("group_norm_act: x must be contiguous")
    b, c = x.shape[0], x.shape[-1]
    m = x.numel() // (b * c)
    if weight.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"group_norm_act: weight {tuple(weight.shape)}, "
                         f"bias {tuple(bias.shape)} for C={c}")
    if add is not None and add.shape != (b, c):
        raise ValueError(f"group_norm_act: add {tuple(add.shape)}")
    if b > MAX_BATCH:
        raise ValueError(f"group_norm_act: batch {b} > {MAX_BATCH}")
    if plan is None:
        plan = gn_plan(b, m, c, num_groups, x.dtype, act)
    params = [p.contiguous().to(x.dtype) for p in (weight, bias)]
    addc = add.contiguous().to(x.dtype) if add is not None else None
    _build.check_operands("group_norm_act", x, *params,
                          *([addc] if addc is not None else []))
    out = torch.empty_like(x)
    n_ws = plan.workspace_floats(b, c)
    ws = torch.empty(n_ws, device=x.device, dtype=torch.float32) \
        if n_ws else None
    lib = _lib()
    fn = lib.group_norm_act_bf16 if x.dtype == torch.bfloat16 \
        else lib.group_norm_act_f32
    rc = fn(x.data_ptr(), addc.data_ptr() if addc is not None else None,
            params[0].data_ptr(), params[1].data_ptr(), out.data_ptr(),
            ws.data_ptr() if ws is not None else None,
            arrival_counts(x.device).data_ptr(), b, m, c, num_groups, eps,
            int(act == "silu"), *plan.c_args(),
            _build.stream_handle(x.device))
    _build.check(rc, "group_norm_act")
    COUNTER.add((tuple(x.shape), act))
    return out
