"""Fused GroupNorm(+add)+SiLU+conv3x3: `conv3x3_SAME(silu(GN(x + add))) + b`.

Port of two Pallas kernels of `imagdressing_tpu/kernels/fused_gn_conv.py`
that compute this one function: `_kernel` (whole batch row resident) and
`_windowed_kernel` (row windows with one-row halos for the VAE's
pixel-level activations). On the H100 both become one CUDA op,
`csrc/gn_conv.cu`. In bf16: the fused GroupNorm's own launch
(`csrc/gn_stats.cuh`, planned by `fused_groupnorm.gn_plan`: one cluster
launch with the rows resident, or the streaming statistics and an apply
pass at the VAE's pixel levels) writes `h = silu(GN(x + add))` in bf16 to a
scratch of x's shape, then an
implicit-GEMM conv over h on Hopper's tensor cores (TMA tiles, wgmma),
split along K where the pixels are few (`conv_plan`), the split partials
added in a fixed order by a second pass. In fp32 (parity mode): the
streaming statistics, then a SIMT conv that normalizes on the way into
shared memory.

Every resnet `GN -> SiLU -> conv3x3` chain of the UNet and the VAE goes
through `gn_silu_conv3x3`, whatever its size: the JAX package's gates
(`_supported`, `_pick_cot`, `_VMEM_BUDGET`, `_WINDOWED_SHAPES`) are facts of
the TPU's VMEM and are not carried over. The wrapper's only requirements
are those of the kernel's vector loads and tensor maps: Cin and Cout
multiples of 8.

Layouts: x NHWC; the conv weight is OIHW in `torch.channels_last` memory,
i.e. stored as (Cout, 3, 3, Cin), which is what the kernel reads and what
`F.conv2d` takes without a copy.

Gradients: as in the JAX package (`fused_gn_conv.py:_bwd`, `jax.vjp` of
`_xla_reference`), the backward recomputes the unfused chain in PyTorch ops
and differentiates it; the TPU package has no backward kernel here. The
chain it differentiates is the kernel's own function,
`gn_silu_conv3x3_plain` (temb folded into the fp32 statistics, the
normalized activation rounded once), not JAX's `_xla_reference`, which adds
temb to x in x's dtype: in bf16 that rounding made d(temb), a sum over
every pixel, twice as far from the fp32 gradient as the plain chain's
(1.15 against 0.51 at 1x80x64x320 on an H100, `tools/gn_conv_grad_probe.py`,
against the bound 0.86 of `chip_smoke.py`'s check). In fp32
the two chains agree to rounding. When grad mode is on and an operand
requires a gradient, `gn_silu_conv3x3` returns the output of
`GnSiluConv3x3Function`, whose forward is the kernel.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from imagdressing_tpu_torch.kernels import _build
from imagdressing_tpu_torch.kernels.fused_groupnorm import (
    MAX_BATCH,
    arrival_counts,
    gn_plan,
    scale_shift,
    stream_plan,
    vjp_of_reference,
)

COUNTER = _build.LaunchCounter()
_SOURCE = "gn_conv.cu"


def gn_silu_conv3x3_plain(x: torch.Tensor, gamma: torch.Tensor,
                          beta: torch.Tensor, weight: torch.Tensor,
                          bias: torch.Tensor, *, num_groups: int, eps: float,
                          add: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: fp32 statistics, the
    normalized activation rounded to x's dtype (the bf16 kernel writes it so
    to its scratch), then the conv."""
    scale, shift = scale_shift(x, gamma, beta, add, num_groups=num_groups,
                               eps=eps)
    h = F.silu(x.float() * scale[:, None, None, :] + shift[:, None, None, :])
    h = h.to(x.dtype).permute(0, 3, 1, 2)
    y = F.conv2d(h, weight.to(x.dtype), bias.to(x.dtype), padding=1)
    return y.permute(0, 2, 3, 1).contiguous()


# The bf16 conv's tiles (csrc/gn_conv.cu): 128 pixels x BN output channels
# per block, K steps of one tap x 64 channels, a ring of stages per N width.
SMS = 132  # streaming multiprocessors of the H100 SXM
BLOCK_PIXELS = 128
K_STEP_CHANNELS = 64
STAGES = {64: 6, 128: 6, 160: 5, 256: 4}
SMEM_LIMIT = 232448  # bytes of dynamic shared memory a block may use
MAX_SPLITS = 32
# Cost model of the plan, in microseconds on the H100 (guesses from the
# card's rates, to be tuned by measurement): a K step of a 128 x BN tile
# takes the larger of its tensor work at ~70 % of an SM's share of the
# 989 TFLOP/s and its tile bytes at an SM's share of ~10 TB/s of L2; a
# block adds a fixed cost (launch, ring fill, epilogue); a split adds the
# reduce pass, which reads and writes fp32 partials at 3.35 TB/s.
_STEP_FLOP_PER_US = 0.7 * 989e6 / SMS
_STEP_BYTES_PER_US = 10e6 / SMS
_BLOCK_US = 1.0
_REDUCE_US = 2.0
_HBM_BYTES_PER_US = 3.35e6


def conv_smem_bytes(bn: int) -> int:
    """Dynamic shared memory of the bf16 conv at N width `bn` (the ring of
    A and B tiles and their mbarriers, and 1024 bytes of alignment slack):
    `conv_smem` in csrc/gn_conv.cu."""
    return STAGES[bn] * ((BLOCK_PIXELS + bn) * 128 + 8) + 1024


@dataclass(frozen=True)
class ConvPlan:
    """How the bf16 conv covers one shape: pixel tiles of `th` rows x `tw`
    columns of one image (th * tw = 128), N tiles of `bn` channels, and the
    K steps (9 taps x ceil(Cin / 64) channel steps) cut into `splits`
    balanced ranges, split s taking steps [s*K // splits, (s+1)*K //
    splits): every split gets floor or ceil of K / splits steps."""
    tw: int
    th: int
    bn: int
    splits: int
    mtiles: int
    ntiles: int
    ksteps: int
    est_us: float

    @property
    def blocks(self) -> int:
        return self.mtiles * self.ntiles * self.splits


def _plan_cost(mtiles, ntiles, ksteps, bn, splits, m, cout):
    blocks = mtiles * ntiles * splits
    step_us = max(2.0 * BLOCK_PIXELS * bn * K_STEP_CHANNELS / _STEP_FLOP_PER_US,
                  (BLOCK_PIXELS + bn) * 128 / _STEP_BYTES_PER_US)
    us = math.ceil(blocks / SMS) * (_BLOCK_US + math.ceil(ksteps / splits)
                                    * step_us)
    if splits > 1:
        us += _REDUCE_US + (splits + 1) * 4.0 * m * cout / _HBM_BYTES_PER_US
    return us


@functools.lru_cache(maxsize=None)
def conv_plan(b: int, h: int, w: int, cin: int, cout: int) -> ConvPlan:
    """The bf16 conv's tiles and K splits for x (b, h, w, cin) -> cout.

    The pixel tile is the narrowest power-of-two width that spans a row
    (at most 128), stacked to 128 pixels. Among the N widths and split
    counts, the cheapest by the cost model above, under one rule: where M =
    b*h*w <= 640 pixels (the deep UNet levels, whose 128-pixel tiles are
    few), the launch must have at least one wave of blocks (one per SM of
    the card) when the K steps allow it. Cached per shape: the search
    costs more host time than a deep-level launch takes on the card."""
    tw = min(BLOCK_PIXELS, 1 << max(0, (w - 1).bit_length()))
    th = BLOCK_PIXELS // tw
    mtiles = b * math.ceil(h / th) * math.ceil(w / tw)
    ksteps = 9 * math.ceil(cin / K_STEP_CHANNELS)
    m = b * h * w
    best = None
    for bn in STAGES:
        ntiles = math.ceil(cout / bn)
        max_splits = min(ksteps, MAX_SPLITS)
        for splits in range(1, max_splits + 1):
            blocks = mtiles * ntiles * splits
            if m <= 640 and blocks < SMS and splits < max_splits:
                continue
            us = _plan_cost(mtiles, ntiles, ksteps, bn, splits, m, cout)
            if best is None or us < best.est_us:
                best = ConvPlan(tw, th, bn, splits, mtiles, ntiles, ksteps,
                                us)
    return best


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built library with its functions typed, once per process."""
    lib = _build.load(_SOURCE)
    lib.gn_silu_conv3x3_bf16.argtypes = [_P] * 11 + [_I] * 6 + [_F] + \
        [_I] * 10 + [_P]
    lib.gn_silu_conv3x3_f32.argtypes = [_P] * 9 + [_I] * 6 + [_F] + \
        [_I] * 3 + [_P]
    for fn in (lib.gn_silu_conv3x3_bf16, lib.gn_silu_conv3x3_f32):
        fn.restype = _I
    return lib


def _forward(x, gamma, beta, weight, bias, add, num_groups, eps):
    """The plain version for a CPU tensor, the kernel for a CUDA tensor."""
    if x.device.type == "cpu":
        return gn_silu_conv3x3_plain(x, gamma, beta, weight, bias,
                                     num_groups=num_groups, eps=eps, add=add)
    return _launch(x, gamma, beta, weight, bias, add, num_groups, eps)


class GnSiluConv3x3Function(torch.autograd.Function):
    """Kernel forward; the backward recomputes and differentiates
    `gn_silu_conv3x3_plain` (JAX `fused_gn_silu_conv`'s custom VJP, on the
    kernel's own chain: see the module note)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, weight, bias, add, num_groups, eps):
        ctx.cfg = dict(num_groups=num_groups, eps=eps)
        ctx.save_for_backward(x, gamma, beta, weight, bias, add)
        return _forward(x, gamma, beta, weight, bias, add, num_groups, eps)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        cfg = ctx.cfg

        def ref(x_, gw_, gb_, w_, b_, a_):
            return gn_silu_conv3x3_plain(x_, gw_, gb_, w_, b_, add=a_, **cfg)

        grads = vjp_of_reference(ref, ctx.saved_tensors,
                                 ctx.needs_input_grad[:6], g)
        return (*grads, None, None)


def gn_silu_conv3x3(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                    weight: torch.Tensor, bias: torch.Tensor, *,
                    num_groups: int, eps: float,
                    add: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (B, H, W, Cin) contiguous; gamma/beta (Cin,); weight (Cout, Cin, 3,
    3) channels_last; bias (Cout,); add (B, Cin) or None. Returns
    (B, H, W, Cout). A CPU tensor takes the plain version; a CUDA tensor
    launches `csrc/gn_conv.cu`. Differentiable (see the module note)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, gamma, beta, weight, bias, add)):
        return GnSiluConv3x3Function.apply(x, gamma, beta, weight, bias, add,
                                           num_groups, eps)
    return _forward(x, gamma, beta, weight, bias, add, num_groups, eps)


def _launch(x, gamma, beta, weight, bias, add, num_groups, eps):
    if x.device.type != "cuda":
        raise ValueError(f"gn_silu_conv3x3: unsupported device {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"gn_silu_conv3x3: dtype {x.dtype}")
    if x.ndim != 4 or not x.is_contiguous():
        raise ValueError("gn_silu_conv3x3: x must be contiguous NHWC")
    b, h, w, cin = x.shape
    cout = weight.shape[0]
    if weight.shape != (cout, cin, 3, 3):
        raise ValueError(f"gn_silu_conv3x3: weight {tuple(weight.shape)}")
    if cin % num_groups or cin % 8 or cout % 8:
        raise ValueError(f"gn_silu_conv3x3: Cin={cin} Cout={cout}")
    wt = weight.to(x.dtype).contiguous(memory_format=torch.channels_last)
    params = [p.contiguous().to(x.dtype) for p in (gamma, beta, bias)]
    addc = None
    if add is not None:
        if add.shape != (b, cin):
            raise ValueError(f"gn_silu_conv3x3: add {tuple(add.shape)}")
        addc = add.contiguous().to(x.dtype)
    _build.check_operands("gn_silu_conv3x3", x, wt, *params,
                          *([addc] if addc is not None else []))
    if b > MAX_BATCH:
        raise ValueError(f"gn_silu_conv3x3: batch {b} > {MAX_BATCH}")
    out = torch.empty((b, h, w, cout), device=x.device, dtype=x.dtype)
    bf = x.dtype == torch.bfloat16
    plan = conv_plan(b, h, w, cin, cout) if bf else None
    gn = gn_plan(b, h * w, cin, num_groups, x.dtype, "silu") if bf \
        else stream_plan(b, h * w, cin)
    # One fp32 workspace, carved by offset: the GroupNorm's streaming
    # workspace (none when its plan is resident), and in bf16 the
    # normalized activation h (x's shape, bf16) and, with split K, the
    # conv's partials (splits, M, cout). Every piece starts 16-byte aligned
    # (cin and cout are multiples of 8).
    n_gn = gn.workspace_floats(b, cin)
    n_h = x.numel() // 2 if bf else 0
    n_kpart = plan.splits * b * h * w * cout if bf and plan.splits > 1 \
        else 0
    ws = torch.empty(n_gn + n_h + n_kpart, device=x.device,
                     dtype=torch.float32)
    base = ws.data_ptr()
    gn_p = base if n_gn else None
    h_p = base + 4 * n_gn
    kpart_p = h_p + 4 * n_h if n_kpart else None
    stream = _build.stream_handle(x.device)
    common = (x.data_ptr(), addc.data_ptr() if addc is not None else None,
              params[0].data_ptr(), params[1].data_ptr(), wt.data_ptr(),
              params[2].data_ptr(), out.data_ptr(), gn_p,
              arrival_counts(x.device).data_ptr())
    if bf:
        rc = _lib().gn_silu_conv3x3_bf16(
            *common, h_p, kpart_p, b, h, w, cin, cout, num_groups, eps,
            *gn.c_args(), plan.tw, plan.bn, plan.splits, stream)
    else:
        rc = _lib().gn_silu_conv3x3_f32(
            *common, b, h, w, cin, cout, num_groups, eps, gn.cs,
            gn.nclusters, gn.rows_per_block, stream)
    _build.check(rc, "gn_silu_conv3x3")
    COUNTER.add((b, h, w, cin, cout))
    return out
