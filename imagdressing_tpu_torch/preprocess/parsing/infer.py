"""Human parsing: SCHP ATR (512) + LIP (473) on the device, mask refinement
on the host. Port of `imagdressing_tpu/preprocess/parsing/infer.py`
(`Parsing.__call__`), with its output contract: (parse map (H, W) uint8 with
the neck label 18, face mask (H, W) float32), as numpy arrays.

On the device, per net: the BGR flip, the aspect-preserving affine warp
into the square input, the normalization, the SCHP forward, the
align-corners upsample of the fusion logits, the inverse warp back to
(H, W) and the argmax. Only the two (H, W) label maps come to the host.

On the host, numpy + scipy only (no OpenCV): the upper-cloth hole filling,
the "> 2000 px" hole filter and the neck merge of the reference
(`parsing_api.py:143-179`).

The two warps reproduce what `cv2.warpAffine` (INTER_LINEAR,
BORDER_CONSTANT 0) computes in the JAX package:

  * the forward warp of the 3-channel uint8 photo samples at exact source
    coordinates and rounds half up; OpenCV's own rounding leaves a few
    pixels one level apart;
  * the inverse warp of the 18/20-channel logits uses OpenCV's fixed-point
    grid for images of more than 4 channels: source coordinates rounded to
    1/32 px (10-bit products, `>> 5`), fp32 weights (1-a)(1-b) ... summed in
    OpenCV's order.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from scipy import ndimage

from imagdressing_tpu_torch.pipelines.dressing import resolve_device
from imagdressing_tpu_torch.preprocess.parsing import model as schp

Device = Union[str, torch.device]

_MEAN = np.asarray([0.406, 0.456, 0.485], np.float32)
_STD = np.asarray([0.225, 0.224, 0.229], np.float32)
HOLE_MIN_AREA = 2000


# ---------------------------------------------------------------------------
# Affine geometry (host, float64 as OpenCV computes it)
# ---------------------------------------------------------------------------


def affine_from_points(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """The 2x3 affine that maps three points onto three points
    (`cv2.getAffineTransform`): an exact 3x3 solve in float64."""
    p = np.concatenate([np.asarray(src, np.float64), np.ones((3, 1))], 1)
    return np.linalg.solve(p, np.asarray(dst, np.float64)).T


def invert_affine(m: np.ndarray) -> np.ndarray:
    """`cv2.invertAffineTransform`, with its formula."""
    d = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[1, 1] * d, m[0, 0] * d
    a12, a21 = -m[0, 1] * d, -m[1, 0] * d
    b1 = -a11 * m[0, 2] - a12 * m[1, 2]
    b2 = -a21 * m[0, 2] - a22 * m[1, 2]
    return np.array([[a11, a12, b1], [a21, a22, b2]])


def _affine(center, scale, size, inv=False):
    """Aspect-preserving box->square affine (SCHP get_affine_transform with
    rot=0), via source/destination point triplets."""
    src_w = scale[0]
    dst_h, dst_w = size
    src = np.zeros((3, 2), np.float32)
    dst = np.zeros((3, 2), np.float32)
    src[0] = center
    src[1] = center + np.array([0, -src_w * 0.5], np.float32)
    dst[0] = [dst_w * 0.5, dst_h * 0.5]
    dst[1] = [dst_w * 0.5, dst_h * 0.5 - dst_w * 0.5]

    def third(a, b):
        d = a - b
        return b + np.array([-d[1], d[0]], np.float32)

    src[2] = third(src[0], src[1])
    dst[2] = third(dst[0], dst[1])
    if inv:
        return affine_from_points(dst, src)
    return affine_from_points(src, dst)


def _box_center_scale(w, h, aspect):
    center = np.array([(w - 1) * 0.5, (h - 1) * 0.5], np.float32)
    bw, bh = w - 1, h - 1
    if bw > aspect * bh:
        bh = bw / aspect
    elif bw < aspect * bh:
        bw = bh * aspect
    return center, np.array([bw, bh], np.float32)


# ---------------------------------------------------------------------------
# Device warps
# ---------------------------------------------------------------------------


def exact_grid(m: np.ndarray, out_h: int, out_w: int, device
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Source coordinates (sx, sy), float64 (out_h, out_w), that
    `cv2.warpAffine(src, m, (out_w, out_h))` samples for each output pixel:
    the inverse of `m` applied to the pixel."""
    a = invert_affine(m).tolist()
    y = torch.arange(out_h, device=device, dtype=torch.float64)[:, None]
    x = torch.arange(out_w, device=device, dtype=torch.float64)[None, :]
    return (a[0][0] * x + a[0][1] * y + a[0][2],
            a[1][0] * x + a[1][1] * y + a[1][2])


def fixed_point_grid(m: np.ndarray, out_h: int, out_w: int, device
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same coordinates on OpenCV's fixed-point grid (its path for
    images of more than 4 channels): products rounded to 1/1024 px, then
    to 1/32 px by an arithmetic shift. Returned as float64 multiples of
    1/32, exact."""
    a = invert_affine(m).tolist()
    y = torch.arange(out_h, device=device, dtype=torch.float64)[:, None]
    x = torch.arange(out_w, device=device, dtype=torch.float64)[None, :]

    def fixed(v):
        return torch.round(v * 1024).long()

    xs = (fixed(a[0][0] * x) + fixed(a[0][1] * y + a[0][2]) + 16) >> 5
    ys = (fixed(a[1][0] * x) + fixed(a[1][1] * y + a[1][2]) + 16) >> 5
    return xs.double() / 32, ys.double() / 32


def bilinear(src: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor
             ) -> torch.Tensor:
    """Bilinear samples of src (H, W, C) float32 at (sx, sy) float64
    (h, w), with zeros outside src (INTER_LINEAR, BORDER_CONSTANT 0) ->
    (h, w, C) float32. The corner weights are fp32 products, summed
    top-left, top-right, bottom-left, bottom-right."""
    h, w, c = src.shape
    flat = F.pad(src, (0, 0, 1, 1, 1, 1)).reshape(-1, c)
    fx, fy = torch.floor(sx), torch.floor(sy)
    ax, ay = (sx - fx).float()[..., None], (sy - fy).float()[..., None]
    x0, y0 = fx.long(), fy.long()

    def pad_index(v, n):  # out-of-range neighbours land on the zero border
        return v.clamp(-1, n) + 1

    xa, xb = pad_index(x0, w), pad_index(x0 + 1, w)
    ya, yb = pad_index(y0, h), pad_index(y0 + 1, h)

    def at(yy, xx):
        return flat[yy * (w + 2) + xx]

    return (at(ya, xa) * ((1 - ax) * (1 - ay)) + at(ya, xb) * (ax * (1 - ay))
            + at(yb, xa) * ((1 - ax) * ay) + at(yb, xb) * (ax * ay))


def warp_photo(image: torch.Tensor, m: np.ndarray, size: int
               ) -> torch.Tensor:
    """uint8 (H, W, 3) -> the (size, size, 3) float32 image of
    `cv2.warpAffine(image, m, (size, size))` on uint8: exact coordinates,
    rounded half up to whole levels."""
    sx, sy = exact_grid(m, size, size, image.device)
    return torch.floor(bilinear(image.float(), sx, sy) + 0.5).clamp_(0, 255)


def warp_logits(logits: torch.Tensor, m: np.ndarray, h: int, w: int
                ) -> torch.Tensor:
    """float32 (S, S, C), C > 4 -> the (h, w, C) of
    `cv2.warpAffine(logits, m, (w, h))` (OpenCV's fixed-point grid)."""
    return bilinear(logits, *fixed_point_grid(m, h, w, logits.device))


def _forward(net: schp.SCHP, image: torch.Tensor, num_classes: int,
             size: int) -> torch.Tensor:
    """(1, size, size, 3) normalized -> fusion logits upsampled to
    (1, size, size, num_classes) on the align-corners grid (the reference's
    torch Upsample; the JAX package reaches it through
    scale_and_translate)."""
    schp.check_num_classes(net, num_classes)
    fusion, _ = net(image)
    return schp.resize_align_corners(fusion, size, size)


# ---------------------------------------------------------------------------
# Host refinement (numpy + scipy)
# ---------------------------------------------------------------------------

# OpenCV's chain codes: 0 right, 1 up-right, 2 up, ... 7 down-right
_DX = (1, 1, 0, -1, -1, -1, 0, 1)
_DY = (0, -1, -1, -1, 0, 1, 1, 1)


def outer_boundary(mask: np.ndarray) -> np.ndarray:
    """The outer border of the one 8-connected component in `mask`, as
    (x, y) pixel centres in the order Suzuki's border following visits them
    (OpenCV `findContours`, CHAIN_APPROX_NONE): start at the first pixel in
    raster order, search clockwise from its left neighbour for the second
    point, then walk counterclockwise around each point until the first two
    points come round again."""
    m = np.pad(mask.astype(bool), 1)
    ys, xs = np.nonzero(m)
    y0, x0 = int(ys[0]), int(xs[0])
    s = 4
    for _ in range(8):
        s = (s - 1) & 7
        if m[y0 + _DY[s], x0 + _DX[s]]:
            break
    else:
        return np.array([[x0 - 1, y0 - 1]])
    y1, x1 = y0 + _DY[s], x0 + _DX[s]
    y3, x3 = y0, x0
    pts = []
    while True:
        for _ in range(8):
            s = (s + 1) & 7
            y4, x4 = y3 + _DY[s], x3 + _DX[s]
            if m[y4, x4]:
                break
        pts.append((x3 - 1, y3 - 1))
        if (y4, x4) == (y0, x0) and (y3, x3) == (y1, x1):
            break
        y3, x3 = y4, x4
        s = (s + 4) & 7
    return np.asarray(pts)


def polygon_area(pts: np.ndarray) -> float:
    """|shoelace area| of a closed polygon (cv2.contourArea)."""
    x, y = pts[:, 0].astype(np.float64), pts[:, 1].astype(np.float64)
    twice = np.dot(x, np.roll(y, -1)) - np.dot(np.roll(x, -1), y)
    return abs(float(twice)) / 2


def fill(mask: np.ndarray) -> np.ndarray:
    """mask plus its holes: the background regions (4-connected) that do
    not reach the border. The set of `scipy.ndimage.binary_fill_holes`, in
    one labelling pass instead of its iterated dilation."""
    background, n = ndimage.label(~mask)
    outside = np.zeros(n + 1, bool)
    outside[np.concatenate([background[0], background[-1],
                            background[:, 0], background[:, -1]])] = True
    return mask | ~outside[background]


def fill_holes(mask255: np.ndarray) -> np.ndarray:
    """`mask | ~floodFill(mask, seed (0, 0), 4-connected)` of the JAX
    package on a map whose border is background: the background regions
    that do not reach the border join the mask (255 / 0 uint8)."""
    return np.where(fill(mask255 > 0), 255, 0).astype(np.uint8)


def large_regions(hole: np.ndarray) -> np.ndarray:
    """255 where a component of `hole` (8-connected) has an outer border
    of area > HOLE_MIN_AREA, filled with its holes; the JAX package's
    findContours(RETR_CCOMP) + contourArea + filled drawContours. An inner
    border lies inside its outer one, so only outer borders can add pixels.
    The area is taken over every border point; OpenCV's TC89_L1 drops some
    points first, which can move an area by a few pixels."""
    keep = np.zeros(hole.shape, np.uint8)
    labels, _ = ndimage.label(hole, structure=np.ones((3, 3), bool))
    for k, box in enumerate(ndimage.find_objects(labels), 1):
        if box is None:
            continue
        bh, bw = box[0].stop - box[0].start, box[1].stop - box[1].start
        if (bh - 1) * (bw - 1) <= HOLE_MIN_AREA:  # bounds the border's area
            continue
        comp = labels[box] == k
        if polygon_area(outer_boundary(comp)) > HOLE_MIN_AREA:
            keep[box][fill(comp)] = 255
    return keep


def refine(atr_parse: np.ndarray, lip_parse: np.ndarray
           ) -> Tuple[np.ndarray, np.ndarray]:
    """ATR and LIP label maps (H, W) -> (parse uint8 with neck 18, face
    mask float32): `parsing_api.py:143-179` as the JAX package runs it."""
    parse = np.pad(atr_parse, 1, mode="constant")

    # upper-cloth hole filling (parsing_api.py:143-154)
    arm = ((parse == 14) | (parse == 15)).astype(np.float32)
    upper = (parse == 4).astype(np.float32) + arm
    filled = fill_holes(np.where(upper > 0, 255, 0).astype(np.uint8))
    filled_cloth = filled.astype(np.float64) / 255 * 4
    parse_woarm = np.where(filled_cloth == 4, filled_cloth, parse)

    # holes between arm and cloth > 2000 px stay as they are; arm pixels
    # leave the hole mask
    hole = np.where((filled_cloth == 4) & (parse != 4), 255, 0).astype(
        np.uint8)
    hole[arm > 0] = 0
    keep_mask = large_regions(hole > 0)
    keep_mask = keep_mask + arm.astype(np.uint8)  # uint8, as the reference
    parse = np.where(keep_mask, parse, parse_woarm)
    parse = parse[1:-1, 1:-1]

    # neck from LIP (parsing_api.py:176-179)
    neck = (~(lip_parse == 13)) & (parse == 11)
    parse = np.where(neck, 18, parse).astype(np.uint8)
    return parse, (parse == 11).astype(np.float32)


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------


def _prepare(net: Optional[schp.SCHP], device: torch.device
             ) -> Optional[schp.SCHP]:
    if net is None:
        return None
    return net.to(device).eval().requires_grad_(False)


class Parsing:
    """ATR + LIP SCHP parser with the reference's output contract. Runs on
    "cuda" unless the caller passes device="cpu" (the plain PyTorch
    versions of the kernels); raises on a host without a card otherwise.

    After each call, `last_stage_seconds` holds host wall times of the two
    device parts (warp ... argmax, ending when the labels reach the host)
    and of the host refinement, and `last_device_ms` the device time of
    each device part (CUDA events; empty on the CPU)."""

    _defaults: Dict[str, "Parsing"] = {}

    def __init__(self, atr: Optional[schp.SCHP], lip: Optional[schp.SCHP],
                 device: Device = "cuda"):
        self.device = resolve_device(device)
        schp.check_num_classes(atr, schp.NUM_CLASSES_ATR)
        schp.check_num_classes(lip, schp.NUM_CLASSES_LIP)
        self.atr = _prepare(atr, self.device)
        self.lip = _prepare(lip, self.device)
        self.last_stage_seconds: Dict[str, float] = {}
        self.last_device_ms: Dict[str, float] = {}

    @classmethod
    def init_random(cls, seed: int, device: Device = "cuda") -> "Parsing":
        """Both nets at full width with `schp.init`'s distribution (ATR from
        `seed`, LIP from `seed + 1`), drawn on `device`."""
        dev = resolve_device(device)
        return cls(schp.init(seed, schp.NUM_CLASSES_ATR, dev),
                   schp.init(seed + 1, schp.NUM_CLASSES_LIP, dev), dev)

    @classmethod
    def from_torch(cls, atr_path: str, lip_path: str,
                   device: Device = "cuda") -> "Parsing":
        """The SCHP torch checkpoints (`exp-schp-201908301523-atr.pth`
        etc.; tensors only)."""
        def load(path, n):
            sd = torch.load(path, map_location="cpu", weights_only=True)
            return schp.load_schp_state_dict(sd.get("state_dict", sd), n,
                                             device)

        return cls(load(atr_path, schp.NUM_CLASSES_ATR),
                   load(lip_path, schp.NUM_CLASSES_LIP), device)

    @classmethod
    def from_onnx(cls, atr_path: str, lip_path: str,
                  device: Device = "cuda") -> "Parsing":
        """The reference's ONNX graphs (`ckpt/humanparsing/parsing_atr.onnx`
        / `parsing_lip.onnx`), read by their initializers (no onnxruntime):
        torch.onnx keeps the state-dict names."""
        from imagdressing_tpu_torch.convert.onnx_reader import (
            read_onnx_initializers,
        )

        return cls(
            schp.load_schp_state_dict(read_onnx_initializers(atr_path),
                                      schp.NUM_CLASSES_ATR, device),
            schp.load_schp_state_dict(read_onnx_initializers(lip_path),
                                      schp.NUM_CLASSES_LIP, device),
            device)

    @classmethod
    def get_default(cls, device: Device = "cuda") -> "Parsing":
        """The checkpoints named by IMAGDRESSING_ATR_CKPT /
        IMAGDRESSING_LIP_CKPT (default: the reference's ONNX files), loaded
        once per device."""
        key = str(resolve_device(device))
        if key not in cls._defaults:
            atr = os.environ.get("IMAGDRESSING_ATR_CKPT",
                                 "ckpt/humanparsing/parsing_atr.onnx")
            lip = os.environ.get("IMAGDRESSING_LIP_CKPT",
                                 "ckpt/humanparsing/parsing_lip.onnx")
            load = cls.from_onnx if atr.endswith(".onnx") else cls.from_torch
            cls._defaults[key] = load(atr, lip, device)
        return cls._defaults[key]

    @torch.no_grad()
    def logits(self, image: torch.Tensor, net: Optional[schp.SCHP],
               num_classes: int, size: int) -> torch.Tensor:
        """uint8 RGB (H, W, 3) on the device -> the net's upsampled fusion
        logits warped back to the photo, (H, W, num_classes) float32."""
        h, w = image.shape[:2]
        center, scale = _box_center_scale(w, h, 1.0)
        trans = _affine(center, scale, (size, size))
        warped = warp_photo(image.flip(-1), trans, size)  # BGR, as SCHP
        mean, std = (torch.from_numpy(v).to(image.device)
                     for v in (_MEAN, _STD))
        norm = (warped / 255.0 - mean) / std
        logits = _forward(net, norm[None], num_classes, size)[0]
        inv = _affine(center, scale, (size, size), inv=True)
        return warp_logits(logits, inv, h, w)

    def _labels(self, image, net, num_classes, size, name):
        """The argmax of `logits` on the device, brought to the host as
        uint8 (an eighth of int64's bytes); timed on the host clock and, on
        a card, with CUDA events."""
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            labels = self.logits(image, net, num_classes, size).argmax(
                -1).to(torch.uint8)
            end.record()
            labels = labels.cpu().numpy()
            self.last_device_ms[name] = start.elapsed_time(end)
        else:
            labels = self.logits(image, net, num_classes, size).argmax(
                -1).to(torch.uint8).numpy()
        self.last_stage_seconds[name] = time.perf_counter() - t0
        return labels

    def __call__(self, image_rgb: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """uint8 RGB (H, W, 3) -> (parse_map (H, W) uint8 with neck label
        18, face_mask (H, W) float32)."""
        self.last_stage_seconds, self.last_device_ms = {}, {}
        image = torch.from_numpy(np.ascontiguousarray(image_rgb)).to(
            self.device)
        with torch.no_grad():
            atr = self._labels(image, self.atr, schp.NUM_CLASSES_ATR, 512,
                               "atr")
            lip = self._labels(image, self.lip, schp.NUM_CLASSES_LIP, 473,
                               "lip")
        t0 = time.perf_counter()
        out = refine(atr, lip)
        self.last_stage_seconds["refine"] = time.perf_counter() - t0
        return out
