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
"""

from __future__ import annotations

import functools
from typing import Union

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
