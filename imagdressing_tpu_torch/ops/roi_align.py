"""ROIAlign as bilinear gathers (port of `imagdressing_tpu/ops/roi_align.py`,
detectron2's ROIAlign / ROIAlignRotated semantics).

  * boxes (N, 5): [batch_idx, x0, y0, x1, y1] in input coordinates, scaled
    by `spatial_scale`; `aligned=True` shifts by -0.5 (detectron2's
    "aligned" variant);
  * `sampling_ratio` points per bin and axis, averaged;
  * a sample in [-1, 0) or (size - 1, size] clamps to the border, a sample
    farther out reads zero (detectron2's `bilinear_interpolate`).

Features are NHWC. The gathers index one flat (rows, C) buffer, so one call
can pool each ROI from its own feature map: `roi_align_levels` aligns every
ROI on the FPN level it is assigned to, which is what the JAX package's
"align on all four levels, select with a one-hot" computes, at a quarter
of the work. The backward is autograd's (a scatter-add into the features),
so on the card it is not bit-repeatable.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch


def _bilinear(flat: torch.Tensor, base: torch.Tensor, h: torch.Tensor,
              w: torch.Tensor, yy: torch.Tensor, xx: torch.Tensor
              ) -> torch.Tensor:
    """Sample the (h, w, C) map at rows `base` + y * w + x of `flat` at
    float coordinates yy, xx (broadcastable to one lattice; `base`, h and w
    broadcast with them) -> (*lattice, C), zero outside."""
    valid = (yy >= -1.0) & (yy <= h) & (xx >= -1.0) & (xx <= w)
    yy = torch.minimum(yy.clamp(min=0.0), h - 1)
    xx = torch.minimum(xx.clamp(min=0.0), w - 1)
    yl = torch.floor(yy)
    xl = torch.floor(xx)
    yh = torch.minimum(yl + 1, h - 1)
    xh = torch.minimum(xl + 1, w - 1)
    wy = yy - yl
    wx = xx - xl
    wi = w.long()

    def at(y, x):
        idx = base + y.long() * wi + x.long()
        # index_select: its backward is an index_add_ (atomics on the
        # card), where advanced indexing's sorts the indices first (two
        # thirds of a detector step's device time at 512x512)
        return flat.index_select(0, idx.reshape(-1)).reshape(
            *idx.shape, flat.shape[-1])

    val = (at(yl, xl) * ((1 - wy) * (1 - wx))[..., None]
           + at(yl, xh) * ((1 - wy) * wx)[..., None]
           + at(yh, xl) * (wy * (1 - wx))[..., None]
           + at(yh, xh) * (wy * wx)[..., None])
    return val * valid[..., None].to(val.dtype)


def _grid(out: int, sr: int, device) -> torch.Tensor:
    """(out, sr) sample offsets in bins: bin + (s + 0.5) / sr."""
    grid = torch.arange(out, dtype=torch.float32, device=device)[:, None]
    sub = (torch.arange(sr, dtype=torch.float32, device=device)
           + 0.5)[None, :] / sr
    return grid + sub


def _align_axis(flat, base, h, w, y0, x0, bin_h, bin_w, out, sr):
    """Axis-aligned pooling of N ROIs: per-ROI (N,) origin, bin size, map
    size and flat base row -> (N, out, out, C)."""
    g = _grid(out, sr, flat.device)
    ys = y0[:, None, None] + g * bin_h[:, None, None]  # (N, P, S)
    xs = x0[:, None, None] + g * bin_w[:, None, None]
    r = (slice(None),) + (None,) * 4
    samples = _bilinear(flat, base[r], h[r], w[r],
                        ys[:, :, :, None, None], xs[:, None, None, :, :])
    return samples.mean(dim=(2, 4))


def roi_align_levels(feats: Sequence[torch.Tensor], level: torch.Tensor,
                     boxes: torch.Tensor, scales: Sequence[float], *,
                     output_size: int = 7, sampling_ratio: int = 2,
                     aligned: bool = True) -> torch.Tensor:
    """Pool ROI i from feats[level[i]] (each (B, H_l, W_l, C)) at
    spatial scale scales[level[i]] -> (N, output_size, output_size, C)."""
    dev = boxes.device
    flat = torch.cat([f.reshape(-1, f.shape[-1]) for f in feats])
    sizes = [f.shape[1] * f.shape[2] for f in feats]
    starts = [0]
    for f, n in zip(feats[:-1], sizes):
        starts.append(starts[-1] + f.shape[0] * n)

    def per_level(values, dtype):
        return torch.tensor(values, dtype=dtype, device=dev)[level]

    h = per_level([float(f.shape[1]) for f in feats], torch.float32)
    w = per_level([float(f.shape[2]) for f in feats], torch.float32)
    scale = per_level([float(s) for s in scales], torch.float32)
    base = (per_level(starts, torch.int64)
            + boxes[:, 0].long() * per_level(sizes, torch.int64))
    offset = 0.5 if aligned else 0.0
    x0 = boxes[:, 1] * scale - offset
    y0 = boxes[:, 2] * scale - offset
    x1 = boxes[:, 3] * scale - offset
    y1 = boxes[:, 4] * scale - offset
    roi_w, roi_h = x1 - x0, y1 - y0
    if not aligned:
        roi_w, roi_h = roi_w.clamp(min=1.0), roi_h.clamp(min=1.0)
    return _align_axis(flat, base, h, w, y0, x0, roi_h / output_size,
                       roi_w / output_size, output_size, sampling_ratio)


def roi_align(features: torch.Tensor, boxes: torch.Tensor,
              output_size: int = 7, spatial_scale: float = 1.0,
              sampling_ratio: int = 2, aligned: bool = True
              ) -> torch.Tensor:
    """features (B, H, W, C), boxes (N, 5) -> (N, output_size,
    output_size, C)."""
    level = torch.zeros(boxes.shape[0], dtype=torch.long,
                        device=boxes.device)
    return roi_align_levels([features], level, boxes, [spatial_scale],
                            output_size=output_size,
                            sampling_ratio=sampling_ratio, aligned=aligned)


def roi_align_rotated(features: torch.Tensor, rois: torch.Tensor,
                      output_size: int = 7, spatial_scale: float = 1.0,
                      sampling_ratio: int = 2) -> torch.Tensor:
    """Rotated ROIAlign: rois (N, 6) [batch_idx, cx, cy, w, h, angle in
    degrees, counter-clockwise positive]; the sample grid is laid out in
    the box's frame, rotated about its centre, then gathered. Always
    "aligned" (detectron2 ships only that variant) -> (N, output_size,
    output_size, C)."""
    b, hh, ww, c = features.shape
    dev = features.device
    cx = rois[:, 1] * spatial_scale - 0.5
    cy = rois[:, 2] * spatial_scale - 0.5
    roi_w = (rois[:, 3] * spatial_scale).clamp(min=1e-6)
    roi_h = (rois[:, 4] * spatial_scale).clamp(min=1e-6)
    theta = rois[:, 5] * (math.pi / 180.0)
    cos_t, sin_t = torch.cos(theta), torch.sin(theta)
    g = _grid(output_size, sampling_ratio, dev)
    yy_loc = -roi_h[:, None, None] / 2.0 + g * (roi_h / output_size)[
        :, None, None]
    xx_loc = -roi_w[:, None, None] / 2.0 + g * (roi_w / output_size)[
        :, None, None]
    yy = yy_loc[:, :, :, None, None]
    xx = xx_loc[:, None, None, :, :]
    r = (slice(None),) + (None,) * 4
    ys = yy * cos_t[r] - xx * sin_t[r] + cy[r]
    xs = yy * sin_t[r] + xx * cos_t[r] + cx[r]
    base = (rois[:, 0].long() * (hh * ww))[r]
    size_h = torch.tensor(float(hh), device=dev)
    size_w = torch.tensor(float(ww), device=dev)
    samples = _bilinear(features.reshape(-1, c), base, size_h, size_w, ys,
                        xs)
    return samples.mean(dim=(2, 4))
