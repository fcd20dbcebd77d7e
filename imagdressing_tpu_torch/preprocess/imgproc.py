"""Raster, filter and morphology helpers of the preprocessing and the face
fusion, on host numpy + scipy: the OpenCV calls of the JAX package's
`preprocess/mask.py`, `preprocess/openpose/{draw,hand}.py` and
`postprocess/face_fusion.py`, without OpenCV.

Drawing follows OpenCV's integer rasterisers (`drawing.cpp`): the
8-connected line iterator with its clipping, the filled convex polygon
scan (with sub-pixel vertices for thick lines), the midpoint filled
circle, `ellipse2Poly` with its sine table of 7-digit floats, and thick
lines as a filled quad plus round caps. Filters follow `cv2.GaussianBlur`
(float kernels; the 8-bit path's fixed-point kernel), `pyrDown` /
`pyrUp`, `dilate` / `erode` with OpenCV's default borders (which add
nothing), and `warpAffine` (INTER_LINEAR, BORDER_REFLECT) of a float
image, which OpenCV 5 samples at exact source coordinates.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch
from scipy import ndimage

from imagdressing_tpu_torch.preprocess.parsing.infer import exact_grid

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT
Point = Tuple[int, int]


def _cdiv(a: int, b: int) -> int:
    """C integer division (truncates toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _hline(img: np.ndarray, y: int, x1: int, x2: int, value) -> None:
    img[y, x1:x2 + 1] = value


# ---------------------------------------------------------------------------
# Lines, polygons, circles, ellipses (OpenCV's drawing.cpp)
# ---------------------------------------------------------------------------


def clip_line(w: int, h: int, p1: List[int], p2: List[int]) -> bool:
    """`cv::clipLine` on a w x h rectangle; moves p1, p2 in place."""
    right, bottom = w - 1, h - 1
    if w <= 0 or h <= 0:
        return False
    x1, y1 = p1
    x2, y2 = p2
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    p1[:] = [x1, y1]
    p2[:] = [x2, y2]
    return (c1 | c2) == 0


def line(img: np.ndarray, pt1: Point, pt2: Point, value) -> None:
    """An 8-connected line (`cv::Line`, LineIterator left to right)."""
    h, w = img.shape[:2]
    p1, p2 = [int(pt1[0]), int(pt1[1])], [int(pt2[0]), int(pt2[1])]
    if not (0 <= p1[0] < w and 0 <= p2[0] < w and 0 <= p1[1] < h
            and 0 <= p2[1] < h):
        if not clip_line(w, h, p1, p2):
            return
    dx, dy = p2[0] - p1[0], p2[1] - p1[1]
    if dx < 0:
        dx, dy = -dx, -dy
        p1, p2 = p2, p1
    step_y = 1
    if dy < 0:
        dy, step_y = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err = dx - 2 * dy
    x, y = p1
    for _ in range(dx + 1):
        img[y, x] = value
        minor = err < 0
        err += -2 * dy + (2 * dx if minor else 0)
        if vert:
            y += step_y
            x += 1 if minor else 0
        else:
            x += 1
            y += step_y if minor else 0


def line_fixed(img: np.ndarray, p1: List[int], p2: List[int],
               value) -> None:
    """A line between 16.16 fixed-point ends (`cv::Line2`)."""
    h, w = img.shape[:2]
    p1, p2 = list(p1), list(p2)
    if not clip_line(w << XY_SHIFT, h << XY_SHIFT, p1, p2):
        return
    dx, dy = p2[0] - p1[0], p2[1] - p1[1]
    j = -1 if dx < 0 else 0
    ax = (dx ^ j) - j
    i = -1 if dy < 0 else 0
    ay = (dy ^ i) - i
    if ax > ay:
        dy = (dy ^ j) - j
        if j:
            p1, p2 = p2, p1
        y_step = _cdiv(dy << XY_SHIFT, ax | 1)
        ecount = (p2[0] - p1[0]) >> XY_SHIFT
    else:
        dx = (dx ^ i) - i
        if i:
            p1, p2 = p2, p1
        x_step = _cdiv(dx << XY_SHIFT, ay | 1)
        ecount = (p2[1] - p1[1]) >> XY_SHIFT
    p1[0] += XY_ONE >> 1
    p1[1] += XY_ONE >> 1

    def put(x, y):
        if 0 <= x < w and 0 <= y < h:
            img[y, x] = value

    put((p2[0] + (XY_ONE >> 1)) >> XY_SHIFT,
        (p2[1] + (XY_ONE >> 1)) >> XY_SHIFT)
    x, y = p1
    if ax > ay:
        x >>= XY_SHIFT
        while ecount >= 0:
            put(x, y >> XY_SHIFT)
            x += 1
            y += y_step
            ecount -= 1
    else:
        y >>= XY_SHIFT
        while ecount >= 0:
            put(x >> XY_SHIFT, y)
            x += x_step
            y += 1
            ecount -= 1


def fill_convex_poly(img: np.ndarray, pts: Sequence[Point], value,
                     shift: int = 0) -> None:
    """`cv2.fillConvexPoly(img, pts, value, LINE_8, shift)`: the outline's
    lines, then the scanline fill between the two edge chains."""
    v = [(int(x), int(y)) for x, y in pts]
    n = len(v)
    h, w = img.shape[:2]
    delta = 1 << shift >> 1
    delta1 = delta2 = XY_ONE >> 1
    p0 = [v[-1][0] << (XY_SHIFT - shift), v[-1][1] << (XY_SHIFT - shift)]
    xmin = xmax = v[0][0]
    ymin = ymax = v[0][1]
    imin = 0
    for i, (px, py) in enumerate(v):
        if py < ymin:
            ymin, imin = py, i
        ymax, xmax, xmin = max(ymax, py), max(xmax, px), min(xmin, px)
        p = [px << (XY_SHIFT - shift), py << (XY_SHIFT - shift)]
        if shift == 0:
            line(img, (p0[0] >> XY_SHIFT, p0[1] >> XY_SHIFT),
                 (p[0] >> XY_SHIFT, p[1] >> XY_SHIFT), value)
        else:
            line_fixed(img, p0, p, value)
        p0 = p
    xmin, xmax = (xmin + delta) >> shift, (xmax + delta) >> shift
    ymin, ymax = (ymin + delta) >> shift, (ymax + delta) >> shift
    if n < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    edge = [dict(idx=imin, di=1, x=-XY_ONE, dx=0, ye=ymin),
            dict(idx=imin, di=n - 1, x=-XY_ONE, dx=0, ye=ymin)]
    edges = n
    y = ymin
    while True:
        for e in edge:
            if y >= e["ye"]:
                idx0 = e["idx"]
                idx = (idx0 + e["di"]) % n
                while True:
                    edges -= 1
                    if edges < 0:
                        break
                    ty = (v[idx][1] + delta) >> shift
                    if ty > y:
                        xs = v[idx0][0] << (XY_SHIFT - shift)
                        xe = v[idx][0] << (XY_SHIFT - shift)
                        e["ye"] = ty
                        e["dx"] = _cdiv((xe - xs) * 2 + (ty - y),
                                        2 * (ty - y))
                        e["x"] = xs
                        e["idx"] = idx
                        break
                    idx0 = idx
                    idx = (idx + e["di"]) % n
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if edge[0]["x"] > edge[1]["x"] else (0, 1)
            x1 = (edge[left]["x"] + delta1) >> XY_SHIFT
            x2 = (edge[right]["x"] + delta2) >> XY_SHIFT
            if x2 >= 0 and x1 < w:
                _hline(img, y, max(x1, 0), min(x2, w - 1), value)
        edge[0]["x"] += edge[0]["dx"]
        edge[1]["x"] += edge[1]["dx"]
        y += 1
        if y > ymax:
            break


def circle(img: np.ndarray, center: Point, radius: int, value) -> None:
    """A filled circle, `cv2.circle(img, center, radius, value, -1)`
    (OpenCV's midpoint `Circle` with fill)."""
    h, w = img.shape[:2]
    cx, cy = int(center[0]), int(center[1])
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1

    def span(y, x1, x2):
        if 0 <= y < h and x1 < w and x2 >= 0:
            _hline(img, y, max(x1, 0), min(x2, w - 1), value)

    while dx >= dy:
        x11, x12, x21, x22 = cx - dx, cx + dx, cx - dy, cx + dy
        if x11 < w and x12 >= 0 and cy - dx < h and cy + dx >= 0:
            span(cy - dy, x11, x12)
            span(cy + dy, x11, x12)
            if x21 < w and x22 >= 0:
                span(cy - dx, x21, x22)
                span(cy + dx, x21, x22)
        dy += 1
        err += plus
        plus += 2
        mask = (1 if err <= 0 else 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def polylines(img: np.ndarray, pts: Sequence[Point], value,
              thickness: int) -> None:
    """An open polyline, `cv2.polylines(img, [pts], False, value,
    thickness, LINE_8)` with thickness > 1: per segment a filled quad on
    OpenCV's 16.16 grid and round caps (filled circles) at its ends (the
    first segment both, every later one its end)."""
    v = [(int(x) << XY_SHIFT, int(y) << XY_SHIFT) for x, y in pts]
    half = thickness << (XY_SHIFT - 1)
    odd = thickness & 1
    for k in range(1, len(v)):
        p0, p1 = v[k - 1], v[k]
        dx = (p0[0] - p1[0]) / XY_ONE
        dy = (p1[1] - p0[1]) / XY_ONE
        r = dx * dx + dy * dy
        if abs(r) > np.finfo(np.float64).eps:
            r = (half + odd * XY_ONE * 0.5) / math.sqrt(r)
            ox, oy = round(dy * r), round(dx * r)
            fill_convex_poly(img, [(p0[0] + ox, p0[1] + oy),
                                   (p0[0] - ox, p0[1] - oy),
                                   (p1[0] - ox, p1[1] - oy),
                                   (p1[0] + ox, p1[1] + oy)], value,
                             XY_SHIFT)
        for end in ((p0, p1) if k == 1 else (p1,)):
            circle(img, ((end[0] + (XY_ONE >> 1)) >> XY_SHIFT,
                         (end[1] + (XY_ONE >> 1)) >> XY_SHIFT),
                   (half + (XY_ONE >> 1)) >> XY_SHIFT, value)


# OpenCV's SinTable: sin of each whole degree 0..450 as a 7-digit float
_SIN = np.round(np.sin(np.deg2rad(np.arange(451))), 7).astype(
    np.float32).astype(np.float64)


def ellipse2poly(center: Point, axes: Tuple[int, int], angle: int,
                 arc_start: int = 0, arc_end: int = 360,
                 delta: int = 1) -> np.ndarray:
    """`cv2.ellipse2Poly` (integer version): (N, 2) int32 vertices."""
    while angle < 0:
        angle += 360
    while angle > 360:
        angle -= 360
    if arc_start > arc_end:
        arc_start, arc_end = arc_end, arc_start
    while arc_start < 0:
        arc_start, arc_end = arc_start + 360, arc_end + 360
    while arc_end > 360:
        arc_start, arc_end = arc_start - 360, arc_end - 360
    if arc_end - arc_start > 360:
        arc_start, arc_end = 0, 360
    alpha, beta = _SIN[450 - angle], _SIN[angle]
    out: List[Point] = []
    for i in range(arc_start, arc_end + delta, delta):
        a = min(i, arc_end)
        if a < 0:
            a += 360
        x = axes[0] * _SIN[450 - a]
        y = axes[1] * _SIN[a]
        pt = (round(center[0] + x * alpha - y * beta),
              round(center[1] + x * beta + y * alpha))
        if not out or pt != out[-1]:
            out.append(pt)
    if len(out) == 1:
        out = [tuple(center)] * 2
    return np.asarray(out, np.int32)


def convex_hull(points: np.ndarray) -> np.ndarray:
    """(N, 2) int points -> their convex hull's vertices (no collinear
    points), (M, 2) int32; Andrew's monotone chain."""
    pts = sorted(set(map(tuple, np.asarray(points, np.int64).tolist())))
    if len(pts) <= 2:
        return np.asarray(pts, np.int32).reshape(-1, 2)

    def cross(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    hull: List[Tuple[int, int]] = []
    for seq in (pts, pts[::-1]):
        chain: List[Tuple[int, int]] = []
        for p in seq:
            while len(chain) >= 2 and cross(chain[-2], chain[-1], p) <= 0:
                chain.pop()
            chain.append(p)
        hull += chain[:-1]
    return np.asarray(hull, np.int32)


# ---------------------------------------------------------------------------
# Morphology and filters
# ---------------------------------------------------------------------------


def dilate5(mask: np.ndarray, iterations: int = 1) -> np.ndarray:
    """`cv2.dilate(m, np.ones((5, 5)), iterations=n)` of a 0/1 mask, as
    bool: OpenCV's default border adds nothing."""
    return ndimage.binary_dilation(mask > 0, np.ones((5, 5), bool),
                                   iterations=iterations, border_value=0)


def dilate3(img: np.ndarray) -> np.ndarray:
    """`cv2.dilate(img, None)`: the 3x3 maximum, the border adding nothing
    (OpenCV's default border for dilation is the type's minimum)."""
    return ndimage.maximum_filter(img, size=3, mode="nearest")


def corner_harris(gray: np.ndarray, k: float = 0.04) -> np.ndarray:
    """`cv2.cornerHarris(gray, blockSize=2, ksize=3, k)` of a float32 gray
    image, in OpenCV's float32 order: 3x3 Sobel derivatives scaled by
    1 / (4 * 2) (the scale on the smoothing taps), BORDER_REFLECT_101; the
    products summed over an unnormalised 2x2 box at anchor (1, 1) (rows
    and columns i-1 and i, reflected at the top and left); then
    (a * c - b * b) - k * ((a + c) * (a + c)). Bit-equal to cv2 for
    integer-valued gray (the derivatives and box sums are exact)."""
    f32 = np.float32
    p = np.pad(np.asarray(gray, f32), 1, mode="reflect")
    t = p[:, 2:] - p[:, :-2]
    dx = f32(0.25) * t[1:-1] + f32(0.125) * (t[:-2] + t[2:])
    t = f32(0.25) * p[:, 1:-1] + f32(0.125) * (p[:, :-2] + p[:, 2:])
    dy = t[2:] - t[:-2]

    def box(v):
        q = np.pad(v, ((1, 0), (1, 0)), mode="reflect")
        return q[:-1, :-1] + q[:-1, 1:] + q[1:, :-1] + q[1:, 1:]

    a, b, c = box(dx * dx), box(dx * dy), box(dy * dy)
    s = a + c
    return ((a * c - b * b) - f32(k) * (s * s)).astype(f32)


def erode_box(img: np.ndarray, k: int) -> np.ndarray:
    """`cv2.erode(img, np.ones((k, k)))` of a float image: the k x k
    minimum, anchored at k // 2, the border adding nothing."""
    return ndimage.grey_erosion(img, size=(k, k), mode="constant",
                                cval=np.inf).astype(img.dtype)


def gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    """`cv2.getGaussianKernel(ksize, sigma, CV_32F)` as float64."""
    x = np.arange(ksize) - (ksize - 1) * 0.5
    k = np.exp(-0.5 / (sigma * sigma) * x * x).astype(np.float32)
    return (k * (1.0 / float(k.astype(np.float64).sum()))).astype(
        np.float32).astype(np.float64)


def _sep_filter(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """Separable correlation over axes 0 and 1, BORDER_REFLECT_101."""
    out = ndimage.correlate1d(img.astype(np.float64), kernel, axis=0,
                              mode="mirror")
    return ndimage.correlate1d(out, kernel, axis=1, mode="mirror")


def gaussian_blur(img: np.ndarray, ksize: int, sigma: float) -> np.ndarray:
    """`cv2.GaussianBlur(img, (ksize, ksize), sigma)` of a float32 image."""
    return _sep_filter(img, gaussian_kernel(ksize, sigma)).astype(np.float32)


def gaussian_kernel_u8(sigma: float) -> np.ndarray:
    """The 8-bit path's kernel of `cv2.GaussianBlur(img, (0, 0), sigma)`:
    size round(sigma * 6 + 1) | 1, weights in 1/256 distributed from the
    centre outwards by error diffusion, the centre taking what makes the
    sum exactly 256."""
    n = int(round(sigma * 6 + 1)) | 1
    x = np.arange(n) - (n - 1) * 0.5
    k = np.exp(-0.5 / (sigma * sigma) * x * x)
    k /= k.sum()
    out = np.zeros(n, np.int64)
    err = 0.0
    for i in range(n // 2):
        adj = k[i] * 256 + err
        out[i] = out[n - 1 - i] = int(np.rint(adj))
        err = adj - out[i]
    out[n // 2] = 256 - 2 * out[:n // 2].sum()
    return out


def gaussian_blur_u8(img: np.ndarray, sigma: float) -> np.ndarray:
    """`cv2.GaussianBlur(img_uint8, (0, 0), sigma)`: the fixed-point kernel
    on both axes, exact integer sums, rounded half up to uint8."""
    k = gaussian_kernel_u8(sigma).astype(np.float64)
    out = _sep_filter(img, k)  # integers times 2^16, exact in float64
    return np.clip(np.floor(out / 65536 + 0.5), 0, 255).astype(np.uint8)


def pyr_down(img: np.ndarray) -> np.ndarray:
    """`cv2.pyrDown` of a float image: [1 4 6 4 1] / 16 on each axis with
    BORDER_REFLECT_101, every other pixel from the first."""
    k = np.array([1, 4, 6, 4, 1], np.float64) / 16
    return _sep_filter(img, k)[::2, ::2].astype(np.float32)


def _pyr_up_axis(x: np.ndarray, n_out: int, axis: int) -> np.ndarray:
    """One axis of `cv2.pyrUp`: out[2i] = s[i-1] + 6 s[i] + s[i+1],
    out[2i+1] = 4 (s[i] + s[i+1]); s[-1] = s[1], s[n] = s[n-1]."""
    x = np.moveaxis(x, axis, 0)
    n = x.shape[0]
    left = x[1:2] if n > 1 else x[:1]
    ext = np.concatenate([left, x, x[-1:]], 0)
    even = ext[:-2] + 6 * ext[1:-1] + ext[2:]
    odd = 4 * (ext[1:-1] + ext[2:])
    out = np.stack([even, odd], 1).reshape((2 * n,) + x.shape[1:])
    return np.moveaxis(out[:n_out], 0, axis)


def pyr_up(img: np.ndarray, dstsize: Tuple[int, int]) -> np.ndarray:
    """`cv2.pyrUp(img, dstsize=(w, h))` of a float image, for a dstsize of
    at most twice the input (2n or 2n - 1 on each axis)."""
    w, h = dstsize
    for n, m in ((img.shape[0], h), (img.shape[1], w)):
        if m not in (2 * n, 2 * n - 1):
            raise ValueError(f"pyr_up: {n} -> {m} is not supported")
    out = _pyr_up_axis(img.astype(np.float64), h, 0)
    return (_pyr_up_axis(out, w, 1) / 64).astype(np.float32)


def warp_affine_reflect(img: np.ndarray, m: np.ndarray, w: int,
                        h: int) -> np.ndarray:
    """`cv2.warpAffine(img, m, (w, h), flags=INTER_LINEAR,
    borderMode=BORDER_REFLECT)` of a float32 (H, W, C) image: exact source
    coordinates, fp32 corner weights, taps outside the image reflected
    (fedcba|abcdef)."""
    src = torch.from_numpy(np.ascontiguousarray(img, np.float32))
    sx, sy = exact_grid(np.asarray(m, np.float64), h, w, "cpu")
    fx, fy = torch.floor(sx), torch.floor(sy)
    ax, ay = (sx - fx).float()[..., None], (sy - fy).float()[..., None]
    x0, y0 = fx.long(), fy.long()
    H, W = src.shape[:2]

    def reflect(i, n):
        i = torch.remainder(i, 2 * n)
        return torch.where(i >= n, 2 * n - 1 - i, i)

    xa, xb = reflect(x0, W), reflect(x0 + 1, W)
    ya, yb = reflect(y0, H), reflect(y0 + 1, H)
    out = (src[ya, xa] * ((1 - ax) * (1 - ay)) + src[ya, xb] * (ax * (1 - ay))
           + src[yb, xa] * ((1 - ax) * ay) + src[yb, xb] * (ax * ay))
    return out.numpy()
