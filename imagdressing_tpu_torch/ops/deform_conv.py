"""Deformable convolution (DCN v1/v2) as gathers plus one contraction (port
of `imagdressing_tpu/ops/deform_conv.py`).

Parity for detectron2's deform_conv CUDA kernels (the reference's offline
toolchain vendors them under detectron2/layers/csrc/deformable/): per
kernel tap, bilinear-sample the input at (base grid + learned offset),
optionally modulate (v2), then one matmul over (taps x channels). The
backward is autograd's: the gathers are `index_select`, whose backward is
an `index_add_`.

Border rule: detectron2's `deformable_im2col_bilinear` (as torchvision's)
reads zero for each of the four corners that falls outside the input, and
the whole sample is zero unless -1 < y < H and -1 < x < W. The JAX op
clamps the sample point into [0, H-1] x [0, W-1] first, so in the one-pixel
band (-1, 0) and (H-1, H) (and the same in x) it reads the border pixel at
full weight where detectron2 weighs it by the distance. This port follows
detectron2; everywhere else both agree.

Layout: NHWC; weights (kh, kw, C_in, C_out); offsets (B, H_out, W_out,
2*kh*kw) ordered (dy, dx) per tap row-major (torchvision / detectron2);
mask (B, H_out, W_out, kh*kw) for the modulated variant.
"""

from __future__ import annotations

from typing import Optional

import torch


def deform_conv2d(
    x: torch.Tensor,  # (B, H, W, C)
    offsets: torch.Tensor,  # (B, Ho, Wo, 2*kh*kw)
    weight: torch.Tensor,  # (kh, kw, C, O)
    bias: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,  # (B, Ho, Wo, kh*kw): DCNv2
    *,
    stride: int = 1,
    padding: int = 1,
    dilation: int = 1,
) -> torch.Tensor:
    b, h, w, c = x.shape
    kh, kw, _, out_ch = weight.shape
    ho = (h + 2 * padding - dilation * (kh - 1) - 1) // stride + 1
    wo = (w + 2 * padding - dilation * (kw - 1) - 1) // stride + 1
    k = kh * kw
    if tuple(offsets.shape) != (b, ho, wo, 2 * k):
        raise ValueError(f"deform_conv2d: offsets {tuple(offsets.shape)}, "
                         f"expected {(b, ho, wo, 2 * k)}")
    dev = x.device

    # base sampling grid per tap, broadcast to (Ho, Wo, K)
    ys = (torch.arange(ho, device=dev) * stride - padding)[:, None, None]
    xs = (torch.arange(wo, device=dev) * stride - padding)[None, :, None]
    taps = torch.arange(k, device=dev)
    base_y = ys + (taps // kw) * dilation
    base_x = xs + (taps % kw) * dilation

    off = offsets.reshape(b, ho, wo, k, 2)
    py = base_y.to(offsets.dtype) + off[..., 0]  # (B, Ho, Wo, K)
    px = base_x.to(offsets.dtype) + off[..., 1]
    inside = (py > -1) & (py < h) & (px > -1) & (px < w)
    y0f = torch.floor(py)
    x0f = torch.floor(px)
    ly = py - y0f
    lx = px - x0f
    y0 = y0f.long()
    x0 = x0f.long()

    flat = x.reshape(b * h * w, c)
    row0 = (torch.arange(b, device=dev) * (h * w))[:, None, None, None]

    def corner(yi, xi, wgt):
        valid = (yi >= 0) & (yi <= h - 1) & (xi >= 0) & (xi <= w - 1)
        idx = row0 + yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        val = flat.index_select(0, idx.reshape(-1)).reshape(b, ho, wo, k, c)
        return val * (wgt * valid.to(wgt.dtype))[..., None].to(val.dtype)

    samples = (corner(y0, x0, (1 - ly) * (1 - lx))
               + corner(y0, x0 + 1, (1 - ly) * lx)
               + corner(y0 + 1, x0, ly * (1 - lx))
               + corner(y0 + 1, x0 + 1, ly * lx))
    samples = samples * inside[..., None].to(samples.dtype)
    if mask is not None:
        samples = samples * mask[..., None].to(samples.dtype)

    out = samples.reshape(b * ho * wo, k * c) @ weight.reshape(k * c, out_ch)
    out = out.reshape(b, ho, wo, out_ch)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out
