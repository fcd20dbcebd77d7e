"""The resamplers the preprocessing modules of the JAX package call inline,
as separable weight matrices.

Each resize is a pair of (n_out, n_in) matrices, built once per (n_in,
n_out) in float64 numpy and applied on the tensor's device with two
einsums (rows, then columns), so the device does the resize with no
gather:

  * `jax_resize`: `jax.image.resize(x, shape, "bicubic")`, JAX's
    `scale_and_translate` with Keys' cubic (a = -0.5), half-pixel centres,
    the kernel widened by the scale when shrinking (antialias, JAX's
    default), taps outside the input dropped and each output's weights
    renormalised to sum 1. `F.interpolate(mode="bicubic")` is another
    function (a = -0.75, clamped border).
  * `cv2_resize_cubic`: OpenCV's `resize(..., INTER_CUBIC)`: Keys' cubic
    with a = -0.75 at half-pixel centres, the four taps clamped to the edge
    pixel, no antialias; uint8 is resized with the same weights and
    rounded back to uint8 (OpenCV 5's float path for 8-bit images: its
    4.x fixed-point weights, multiples of 1/2048, leave 3-5 % of pixels
    one level apart from it).
  * `cv2_resize_nearest`: OpenCV's `resize(..., INTER_NEAREST)`: source
    index floor(i * in / out) (not JAX's half-pixel nearest).
  * `cv2_resize_linear`: OpenCV's `resize(..., INTER_LINEAR)` of a float
    image: half-pixel centres, the fraction from float64 positions, the
    column taps clamped to the edge.
  * `cv2_resize_linear_u8`: the same of a uint8 image in OpenCV's
    fixed-point arithmetic (weights in 1/2048 from float32 fractions, the
    row pass in integers, the column pass as its SIMD code shifts and
    rounds), equal to `cv2.resize` bit for bit.
  * `cv2_resize_area_u8`: OpenCV's `resize(..., INTER_AREA)` of a uint8
    image when shrinking: each output the mean of the input area it covers
    (float32 weights, rounded to nearest), or, at an integer factor, the
    box mean rounded half up.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple, Union

import numpy as np
import torch

Array = Union[np.ndarray, torch.Tensor]


@functools.lru_cache(maxsize=64)
def jax_cubic_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) weights of JAX's `compute_weight_mat` for a bicubic
    resize n_in -> n_out (scale n_out / n_in, translation 0), in float32
    as JAX computes them."""
    f32 = np.float32
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = f32(max(inv_scale, 1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * f32(inv_scale) \
        - f32(0.5)
    x = np.abs(sample[:, None] - np.arange(n_in, dtype=f32)[None, :]) \
        / kernel_scale
    near = ((f32(1.5) * x - f32(2.5)) * x) * x + f32(1)
    far = ((f32(-0.5) * x + f32(2.5)) * x - f32(4)) * x + f32(2)
    w = np.where(x >= 2, f32(0), np.where(x >= 1, far, near)).astype(f32)
    total = w.sum(1, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000 * np.finfo(f32).eps,
                 w / np.where(total != 0, total, f32(1)), f32(0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[:, None], w, f32(0)).astype(np.float64)


@functools.lru_cache(maxsize=64)
def cv2_cubic_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) float64 weights of OpenCV's INTER_CUBIC: the fraction
    and the coefficients in float32 as OpenCV computes them, the taps
    clamped into [0, n_in)."""
    scale = 1.0 / (n_out / n_in)  # OpenCV's 1 / inv_scale
    fx = ((np.arange(n_out) + 0.5) * scale - 0.5).astype(np.float32)
    sx = np.floor(fx)
    f = (fx - sx).astype(np.float32)
    a = np.float32(-0.75)
    c0 = ((a * (f + 1) - 5 * a) * (f + 1) + 8 * a) * (f + 1) - 4 * a
    c1 = ((a + 2) * f - (a + 3)) * f * f + 1
    c2 = ((a + 2) * (1 - f) - (a + 3)) * (1 - f) * (1 - f) + 1
    c3 = 1 - c0 - c1 - c2
    coef = np.stack([c0, c1, c2, c3], 1).astype(np.float32).astype(np.float64)
    w = np.zeros((n_out, n_in))
    rows = np.arange(n_out)
    for k in range(4):
        idx = np.clip(sx.astype(np.int64) - 1 + k, 0, n_in - 1)
        np.add.at(w, (rows, idx), coef[:, k])
    return w


def _apply(x: torch.Tensor, wh: np.ndarray, ww: np.ndarray,
           dtype: torch.dtype) -> torch.Tensor:
    """(..., H, W, C) -> (..., h, w, C) by rows then columns."""
    mh = torch.from_numpy(wh).to(x.device, dtype)
    mw = torch.from_numpy(ww).to(x.device, dtype)
    y = torch.einsum("oh,...hwc->...owc", mh, x.to(dtype))
    return torch.einsum("pw,...owc->...opc", mw, y)


def jax_resize(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """float (..., H, W, C) -> float32 (..., h, w, C), as
    `jax.image.resize(x, (..., h, w, C), "bicubic")`; an axis whose size
    does not change is left as it is, as JAX does."""
    hh, ww_ = x.shape[-3], x.shape[-2]
    wh = jax_cubic_matrix(hh, h) if hh != h else np.eye(h)
    wm = jax_cubic_matrix(ww_, w) if ww_ != w else np.eye(w)
    return _apply(x, wh, wm, torch.float32)


def cv2_resize_cubic(x: torch.Tensor, w: int, h: int) -> torch.Tensor:
    """(H, W, C) -> (h, w, C) for size (w, h) (OpenCV's order), as
    `cv2.resize(x, (w, h), interpolation=cv2.INTER_CUBIC)`: uint8 in,
    uint8 out (rounded, saturated); float in, float32 out."""
    wh = cv2_cubic_matrix(x.shape[-3], h)
    wm = cv2_cubic_matrix(x.shape[-2], w)
    if x.dtype != torch.uint8:
        return _apply(x, wh, wm, torch.float32)
    y = _apply(x, wh, wm, torch.float64)
    return torch.floor(y + 0.5).clamp_(0, 255).to(torch.uint8)


def nearest_index(n_in: int, n_out: int) -> np.ndarray:
    """OpenCV's INTER_NEAREST source indices, in its float64 arithmetic."""
    ifx = 1.0 / (n_out / n_in)
    return np.minimum(np.floor(np.arange(n_out) * ifx).astype(np.int64),
                      n_in - 1)


def cv2_resize_nearest(x: Array, w: int, h: int) -> Array:
    """(H, W, ...) numpy array or tensor -> (h, w, ...) for size (w, h), as
    `cv2.resize(x, (w, h), interpolation=cv2.INTER_NEAREST)`."""
    rows = nearest_index(x.shape[0], h)
    cols = nearest_index(x.shape[1], w)
    if torch.is_tensor(x):
        rows, cols = (torch.from_numpy(i).to(x.device) for i in (rows, cols))
    return x[rows][:, cols]


def _linear_taps(n_in: int, n_out: int, f32: bool, clamp: bool
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """OpenCV's INTER_LINEAR taps of one axis: (i0, i1, fraction of i1).
    The position (i + 0.5) * in / out - 0.5 in float64, rounded to float32
    where `f32`; `clamp`: a tap off the edge takes the edge pixel with
    weight 1 (OpenCV's column taps; its rows keep their fractions and
    clamp the row index only)."""
    pos = (np.arange(n_out) + 0.5) * (1.0 / (n_out / n_in)) - 0.5
    if f32:
        pos = pos.astype(np.float32)
    i0 = np.floor(pos).astype(np.int64)
    frac = pos - i0.astype(pos.dtype)
    if clamp:
        frac = np.where((i0 < 0) | (i0 >= n_in - 1), 0.0, frac).astype(
            frac.dtype)
    return (np.clip(i0, 0, n_in - 1), np.clip(i0 + 1, 0, n_in - 1), frac)


@functools.lru_cache(maxsize=64)
def cv2_linear_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) float64 weights of OpenCV's float INTER_LINEAR."""
    i0, i1, frac = _linear_taps(n_in, n_out, f32=False, clamp=True)
    w = np.zeros((n_out, n_in))
    rows = np.arange(n_out)
    np.add.at(w, (rows, i0), 1.0 - frac)
    np.add.at(w, (rows, i1), frac)
    return w


def cv2_resize_linear(x: torch.Tensor, w: int, h: int) -> torch.Tensor:
    """float (H, W, C) -> float32 (h, w, C) for size (w, h), as
    `cv2.resize(x, (w, h), interpolation=cv2.INTER_LINEAR)` of a float32
    image (within float32 rounding), on the tensor's device."""
    return _apply(x, cv2_linear_matrix(x.shape[-3], h),
                  cv2_linear_matrix(x.shape[-2], w), torch.float32)


def cv2_resize_linear_u8(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """uint8 (H, W[, C]) -> uint8 (h, w[, C]) for size (w, h), as
    `cv2.resize(img, (w, h))` (INTER_LINEAR) computes it: weights
    rint(2048 * float32 fraction), each tap's own; the row pass exact in
    integers; the column pass ((b0 * (r0 >> 4)) >> 16) + ((b1 * (r1 >> 4))
    >> 16), then + 2 >> 2 and saturated."""
    def weights(frac):
        f = frac.astype(np.float32)
        return (np.rint(((np.float32(1) - f) * np.float32(2048))).astype(
            np.int64), np.rint(f * np.float32(2048)).astype(np.int64))

    x0, x1, fx = _linear_taps(img.shape[1], w, f32=True, clamp=True)
    y0, y1, fy = _linear_taps(img.shape[0], h, f32=True, clamp=False)
    (a0, a1), (b0, b1) = weights(fx), weights(fy)
    extra = (1,) * (img.ndim - 2)
    src = img.astype(np.int64)
    rows = src[:, x0] * a0.reshape((1, -1) + extra) \
        + src[:, x1] * a1.reshape((1, -1) + extra)
    b0, b1 = (b.reshape((-1, 1) + extra) for b in (b0, b1))
    out = (((b0 * (rows[y0] >> 4)) >> 16) + ((b1 * (rows[y1] >> 4)) >> 16)
           + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


def _area_taps(n_in: int, n_out: int):
    """OpenCV's `computeResizeAreaTab` for a shrink: (out, in, weight)."""
    scale = n_in / n_out
    taps = []
    for d in range(n_out):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, n_in - f1)
        s2 = min(math.floor(f2), n_in - 1)
        s1 = min(math.ceil(f1), s2)
        if s1 - f1 > 1e-3:
            taps.append((d, s1 - 1, (s1 - f1) / cell))
        taps.extend((d, s, 1.0 / cell) for s in range(s1, s2))
        if f2 - s2 > 1e-3:
            taps.append((d, s2, min(min(f2 - s2, 1.0), cell) / cell))
    return taps


def cv2_resize_area_u8(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """uint8 (H, W[, C]) -> uint8 (h, w[, C]), h <= H and w <= W, as
    `cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA)`."""
    hh, ww = img.shape[:2]
    if h > hh or w > ww:
        raise ValueError(f"cv2_resize_area_u8 shrinks only: {hh}x{ww} -> "
                         f"{h}x{w}")
    if hh % h == 0 and ww % w == 0:
        sy, sx = hh // h, ww // w
        box = img.astype(np.int64).reshape(
            (h, sy, w, sx) + img.shape[2:]).sum((1, 3))
        return ((box + sy * sx // 2) // (sy * sx)).astype(np.uint8)
    src = img.astype(np.float32)
    cols = np.zeros((hh, w) + img.shape[2:], np.float32)
    for d, s, a in _area_taps(ww, w):
        cols[:, d] += src[:, s] * np.float32(a)
    out = np.zeros((h, w) + img.shape[2:], np.float32)
    for d, s, b in _area_taps(hh, h):
        out[d] += cols[s] * np.float32(b)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)
