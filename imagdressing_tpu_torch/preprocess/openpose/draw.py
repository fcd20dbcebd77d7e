"""Pose rendering for ControlNet conditioning (port of
`imagdressing_tpu/preprocess/openpose/draw.py`): the reference's
`util.draw_bodypose` contract, 17 limbs as width-4 filled ellipses in the
18-colour CMU palette on black, the canvas dimmed by 0.6, then radius-4
joint discs. Rasterised by `preprocess/imgproc.py` (OpenCV's ellipse2Poly,
fillConvexPoly and filled circle), pixel for pixel.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from imagdressing_tpu_torch.preprocess.imgproc import (
    circle,
    ellipse2poly,
    fill_convex_poly,
)
from imagdressing_tpu_torch.preprocess.openpose.infer import LIMB_SEQ

COLORS = [
    [255, 0, 0], [255, 85, 0], [255, 170, 0], [255, 255, 0], [170, 255, 0],
    [85, 255, 0], [0, 255, 0], [0, 255, 85], [0, 255, 170], [0, 255, 255],
    [0, 170, 255], [0, 85, 255], [0, 0, 255], [85, 0, 255], [170, 0, 255],
    [255, 0, 255], [255, 0, 170], [255, 0, 85],
]


def draw_bodypose(keypoints: np.ndarray, height: int, width: int, *,
                  src_size: Optional[tuple] = None,
                  stickwidth: int = 4) -> np.ndarray:
    """(18, 2) keypoints ([0, 0] = missing) in `src_size` (w, h) pixels
    (default (width, height)) -> (height, width, 3) uint8 RGB render."""
    kps = np.asarray(keypoints, np.float64).copy()
    # missing joints are the EXACT [0, 0] sentinel: tested before scaling
    present = ~np.all(kps == 0.0, axis=1)
    sw, sh = src_size if src_size else (width, height)
    kps[:, 0] *= width / sw
    kps[:, 1] *= height / sh

    canvas = np.zeros((height, width, 3), np.uint8)
    for li, (a, b) in enumerate(LIMB_SEQ[:17]):
        ia, ib = a - 1, b - 1
        if not (present[ia] and present[ib]):
            continue
        xa, ya = kps[ia]
        xb, yb = kps[ib]
        mx, my = (xa + xb) / 2, (ya + yb) / 2
        length = math.hypot(xa - xb, ya - yb)
        angle = math.degrees(math.atan2(ya - yb, xa - xb))
        poly = ellipse2poly((int(mx), int(my)), (int(length / 2), stickwidth),
                            int(angle))
        fill_convex_poly(canvas, poly, COLORS[li])
    canvas = (canvas * 0.6).astype(np.uint8)
    for i in range(18):
        if present[i]:
            circle(canvas, (int(kps[i, 0]), int(kps[i, 1])), 4, COLORS[i])
    return canvas
