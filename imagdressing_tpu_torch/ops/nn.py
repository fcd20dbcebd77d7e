"""NN primitives of the port: plain PyTorch functions on tensors plus the
leaf modules that hold their weights.

Layouts follow the JAX package at every public function: activations are
NHWC, linear inputs (..., in). Weights are laid out once, at init or in the
converter, in the form the call reads without a copy:

  * linear weights (out, in), as `F.linear` takes them;
  * conv weights OIHW in `torch.channels_last` memory, i.e. stored as
    (out, kh, kw, in). `x_nhwc.permute(0, 3, 1, 2)` is a channels_last NCHW
    view, so `F.conv2d` reads both without a transpose, and the fused
    GN+conv kernel reads the same storage as (Cout, 3, 3, Cin).

These are the ops that XLA compiles in the JAX package (no Pallas), so they
stay plain PyTorch here. Norm statistics are fp32 whatever the input type.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

Padding = Union[int, Tuple[Tuple[int, int], Tuple[int, int]]]


# ---------------------------------------------------------------------------
# Functions
# ---------------------------------------------------------------------------


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ weight.T + bias; weight (out, in)."""
    return F.linear(x, weight, bias)


def conv2d(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None, *, stride: int = 1,
           padding: Padding = 0, dilation: int = 1) -> torch.Tensor:
    """NHWC conv with an OIHW (channels_last) weight. `padding` is an int or
    explicit ((top, bottom), (left, right)); the VAE downsampler uses the
    asymmetric ((0, 1), (0, 1)). `dilation` spaces the taps (SCHP's layer4
    runs its 3x3 convs at dilation 2, padding 2)."""
    if not isinstance(padding, int):
        (top, bottom), (left, right) = padding
        if top == bottom and left == right and top == left:
            padding = top
        else:
            x = F.pad(x, (0, 0, left, right, top, bottom))
            padding = 0
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, bias, stride=stride,
                 padding=padding, dilation=dilation)
    return y.permute(0, 2, 3, 1)


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, *,
               num_groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over the channel-last axis of (B, ..., C), fp32 statistics
    (E[x^2] - E[x]^2 on per-channel sums, as the JAX package computes them)."""
    b, c = x.shape[0], x.shape[-1]
    xf = x.float()
    spatial = tuple(range(1, x.ndim - 1))
    n = math.prod(x.shape[1:-1]) * (c // num_groups)
    s1 = xf.sum(spatial).reshape(b, num_groups, -1).sum(-1)
    s2 = (xf * xf).sum(spatial).reshape(b, num_groups, -1).sum(-1)
    mean = s1 / n
    inv = torch.rsqrt(s2 / n - mean * mean + eps)
    scale = inv.repeat_interleave(c // num_groups, dim=-1) * weight.float()
    shift = bias.float() - mean.repeat_interleave(c // num_groups, -1) * scale
    shape = (b,) + (1,) * (x.ndim - 2) + (c,)
    return (xf * scale.reshape(shape) + shift.reshape(shape)).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: Optional[torch.Tensor],
               bias: Optional[torch.Tensor], *, eps: float = 1e-5
               ) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), weight, bias, eps)


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def geglu(x: torch.Tensor, weight: torch.Tensor,
          bias: Optional[torch.Tensor]) -> torch.Tensor:
    """GEGLU gate: project to 2*inner, h * gelu(gate)."""
    h, gate = F.linear(x, weight, bias).chunk(2, dim=-1)
    return h * F.gelu(gate)


def timestep_embedding(timesteps: torch.Tensor, dim: int, *,
                       flip_sin_to_cos: bool = True, freq_shift: float = 0.0,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep embedding in fp32 (diffusers convention)."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=timesteps.device)
        / (half - freq_shift)
    )
    args = timesteps.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half:], emb[:, :half]], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


def fold_upsample_weight(w: torch.Tensor) -> torch.Tensor:
    """3x3 OIHW weight -> the (4*Cout, Cin, 2, 2) subpixel kernel that runs
    `conv3x3(upsample_nearest_2x(x))` at the low resolution.

    Output phase a=0 rows read input rows (i-1, i) with taps (w0, w1+w2);
    a=1 reads (i, i+1) with (w0+w1, w2); the same per column phase. Phases
    are concatenated phase-major on the output axis (index p*Cout + o,
    p = 2a + b), as `imagdressing_tpu/ops/nn.py::upsample2x_conv` does."""
    r0 = torch.stack([w[:, :, 0], w[:, :, 1] + w[:, :, 2]], dim=2)
    r1 = torch.stack([w[:, :, 0] + w[:, :, 1], w[:, :, 2]], dim=2)

    def cols(wr):  # (O, I, 2, 3) -> two (O, I, 2, 2)
        c0 = torch.stack([wr[..., 0], wr[..., 1] + wr[..., 2]], dim=-1)
        c1 = torch.stack([wr[..., 0] + wr[..., 1], wr[..., 2]], dim=-1)
        return c0, c1

    k00, k01 = cols(r0)
    k10, k11 = cols(r1)
    kk = torch.cat([k00, k01, k10, k11], dim=0)
    return kk.contiguous(memory_format=torch.channels_last)


def upsample2x_conv_folded(x: torch.Tensor, wf: torch.Tensor,
                           bias: Optional[torch.Tensor]) -> torch.Tensor:
    """Nearest-2x upsample + 3x3/pad-1 conv as one subpixel conv, from the
    folded kernel of `fold_upsample_weight`. x NHWC -> (B, 2H, 2W, Cout)."""
    b, h, w, _ = x.shape
    co = wf.shape[0] // 4
    y = conv2d(x, wf, None, padding=1).reshape(b, h + 1, w + 1, 2, 2, co)
    p00 = y[:, 0:h, 0:w, 0, 0]
    p01 = y[:, 0:h, 1:w + 1, 0, 1]
    p10 = y[:, 1:h + 1, 0:w, 1, 0]
    p11 = y[:, 1:h + 1, 1:w + 1, 1, 1]
    out = torch.stack(
        [torch.stack([p00, p01], dim=3), torch.stack([p10, p11], dim=3)],
        dim=2,
    ).reshape(b, 2 * h, 2 * w, co)
    if bias is not None:
        out = out + bias
    return out


def upsample2x_conv(x: torch.Tensor, w: torch.Tensor,
                    bias: Optional[torch.Tensor]) -> torch.Tensor:
    """Nearest-2x upsample + 3x3/pad-1 conv from the 3x3 OIHW weight, folded
    here (differentiably) into the subpixel kernel."""
    return upsample2x_conv_folded(x, fold_upsample_weight(w), bias)


# ---------------------------------------------------------------------------
# Leaf modules (weights only; random init from an explicit generator)
# ---------------------------------------------------------------------------


def _uniform(shape: Sequence[int], bound: float,
             gen: torch.Generator) -> torch.Tensor:
    t = torch.empty(tuple(shape), device=gen.device)
    return t.uniform_(-bound, bound, generator=gen)


class Linear(nn.Module):
    """weight (out, in); torch.nn.Linear's Kaiming-uniform init bound."""

    def __init__(self, in_dim: int, out_dim: int, *, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim))
        self.bias = nn.Parameter(torch.empty(out_dim)) if bias else None

    def reset_parameters(self, gen: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.weight.shape[1])
        with torch.no_grad():
            self.weight.copy_(_uniform(self.weight.shape, bound, gen))
            if self.bias is not None:
                self.bias.copy_(_uniform(self.bias.shape, bound, gen))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)


class Conv2d(nn.Module):
    """NHWC conv; weight OIHW in channels_last memory."""

    def __init__(self, cin: int, cout: int, k: int, *, stride: int = 1,
                 padding: Padding = 0, dilation: int = 1, bias: bool = True):
        super().__init__()
        self.stride = stride
        self.padding = padding
        self.dilation = dilation
        self.weight = nn.Parameter(
            torch.empty(cout, cin, k, k).contiguous(
                memory_format=torch.channels_last))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None

    def reset_parameters(self, gen: torch.Generator) -> None:
        fan_in = self.weight[0].numel()
        bound = 1.0 / math.sqrt(fan_in)
        with torch.no_grad():
            self.weight.copy_(_uniform(self.weight.shape, bound, gen))
            if self.bias is not None:
                self.bias.copy_(_uniform(self.bias.shape, bound, gen))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d(x, self.weight, self.bias, stride=self.stride,
                      padding=self.padding, dilation=self.dilation)


class Upsample2xConv(nn.Module):
    """Nearest-2x upsample + 3x3 conv, run as one subpixel conv at the low
    resolution. The parameter is the 3x3 weight (OIHW channels_last), as in
    the JAX tree, so that training updates what the JAX package trains; the
    folded (4*C, C, 2, 2) kernel is made from it at each call."""

    def __init__(self, ch: int):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(ch, ch, 3, 3).contiguous(
                memory_format=torch.channels_last))
        self.bias = nn.Parameter(torch.empty(ch))

    def reset_parameters(self, gen: torch.Generator) -> None:
        ch = self.bias.shape[0]
        bound = 1.0 / math.sqrt(9 * ch)
        with torch.no_grad():
            self.weight.copy_(_uniform((ch, ch, 3, 3), bound, gen))
            self.bias.copy_(_uniform((ch,), bound, gen))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return upsample2x_conv(x, self.weight, self.bias)


class Embedding(nn.Module):
    """Lookup table (num, dim); normal(0, 0.02) init as the JAX package's."""

    def __init__(self, num: int, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num, dim))

    def reset_parameters(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.normal_(0.0, 0.02, generator=gen)


class Norm(nn.Module):
    """Affine parameters of a GroupNorm or LayerNorm (ones / zeros)."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))

    def reset_parameters(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()


def init_module(root: nn.Module, gen: torch.Generator) -> None:
    """Random init of every module that has `reset_parameters(gen)`, each
    after its submodules (a parent may override a child's default), from
    one generator on the modules' device. CPU and CUDA generators give
    different numbers for one seed; a random stack is reproducible per
    device."""
    for m in reversed(list(root.modules())):
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(gen)
