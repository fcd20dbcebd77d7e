"""Category-aware inpaint mask from a human-parse map and pose keypoints.
Port of `imagdressing_tpu/preprocess/mask.py` (`get_mask_location`,
`make_inpaint_condition`, `person_upper_body_mask`), on host numpy + scipy
with the rasterisers of `preprocess/imgproc.py` in place of OpenCV.

The label algebra per category, the arm bands (shoulder, elbow and the
wrist extended 1.2x past the elbow, a thick polyline plus a shoulder disc),
the 5x-dilated garment, the neck (label 18) merge, the hole filling and the
largest-component refinement follow the JAX package. Two steps differ from
it along borders only, both measured in `tests/test_torch_preprocess.py`:
OpenCV's thick lines clip their quads' outlines in a way the port's
`polylines` does not reproduce where an arm runs off the image, and the
largest component is taken over its full border (CHAIN_APPROX_NONE) where
the JAX package fills OpenCV's TC89_L1 approximation of it.

ATR label ids: 0 bg, 1 hat, 2 hair, 3 sunglasses, 4 upper_clothes,
5 skirt, 6 pants, 7 dress, 8 belt, 9/10 shoes, 11 head, 12/13 legs,
14/15 arms, 16 bag, 17 scarf, 18 neck (added by the parser).
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import numpy as np
from scipy import ndimage

from imagdressing_tpu_torch.ops.resize import cv2_resize_nearest
from imagdressing_tpu_torch.preprocess import imgproc
from imagdressing_tpu_torch.preprocess.parsing.infer import (
    fill,
    outer_boundary,
    polygon_area,
)

LABELS = {
    "background": 0, "hat": 1, "hair": 2, "sunglasses": 3,
    "upper_clothes": 4, "skirt": 5, "pants": 6, "dress": 7, "belt": 8,
    "left_shoe": 9, "right_shoe": 10, "head": 11, "left_leg": 12,
    "right_leg": 13, "left_arm": 14, "right_arm": 15, "bag": 16,
    "scarf": 17, "neck": 18,
}

_HEAD = (1, 3, 11)
_FIXED_BASE = (9, 10, 1, 3, 16)

_CATEGORY_GARMENT = {
    "dresses": (7, 4, 5, 6),
    "upper_body": (4, 7),
    "lower_body": (6, 12, 13, 5),
}
_CATEGORY_EXTRA_FIXED = {
    "dresses": (),
    "upper_body": (5, 6),
    "lower_body": (4, 14, 15),
}


def _isin(parse: np.ndarray, labels) -> np.ndarray:
    return np.isin(parse, np.asarray(labels, parse.dtype))


def _fill_holes(mask: np.ndarray) -> np.ndarray:
    """The JAX package's flood fill from (0, 0) on the mask with its
    one-pixel frame cleared: the frame stays background, enclosed
    background (4-connected) joins the mask."""
    inner = np.zeros_like(mask, bool)
    inner[1:-1, 1:-1] = mask[1:-1, 1:-1]
    return fill(inner)


def _largest_component(mask: np.ndarray) -> np.ndarray:
    """The 8-connected component whose outer border encloses the largest
    area (shoelace), filled with its holes; all False for an empty mask."""
    labels, n = ndimage.label(mask, structure=np.ones((3, 3), bool))
    best, best_area, best_box = 0, -1.0, None
    for k, box in enumerate(ndimage.find_objects(labels), 1):
        area = polygon_area(outer_boundary(labels[box] == k))
        if area > best_area:
            best, best_area, best_box = k, area, box
    out = np.zeros(mask.shape, bool)
    if best:
        out[best_box] = fill(labels[best_box] == best)
    return out


def get_mask_location(model_type: str, category: str, parse_map: np.ndarray,
                      keypoints: Dict, width: int = 384, height: int = 512
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """-> (mask uint8 {0, 255}, mask_gray uint8 {0, 127}) at (height,
    width). parse_map: (H0, W0) int labels (ATR + neck 18); keypoints:
    {"pose_keypoints_2d": [(x, y) * 18]} in 384x512 space."""
    if model_type == "hd":
        arm_width = 60
    elif model_type == "dc":
        arm_width = 45
    else:
        raise ValueError("model_type must be 'hd' or 'dc'")
    if category not in _CATEGORY_GARMENT:
        raise NotImplementedError(category)

    parse = cv2_resize_nearest(parse_map.astype(np.uint8), width, height)
    head = _isin(parse, _HEAD)
    fixed = _isin(parse, _FIXED_BASE + _CATEGORY_EXTRA_FIXED[category])
    garment = _isin(parse, _CATEGORY_GARMENT[category])
    changeable = (parse == 0) | ((parse > 0) & ~fixed)

    arms_left = parse == 14
    arms_right = parse == 15

    if category in ("dresses", "upper_body"):
        pts = np.asarray(keypoints["pose_keypoints_2d"],
                         np.float64).reshape(-1, 2)
        scale = height / 512.0
        sh_r, el_r, wr_r = pts[2] * scale, pts[3] * scale, pts[4] * scale
        sh_l, el_l, wr_l = pts[5] * scale, pts[6] * scale, pts[7] * scale
        lw = int(arm_width / 512 * height)

        def arm_band(shoulder, elbow, wrist, fallback):
            if wrist[0] <= 1.0 and wrist[1] <= 1.0:
                return fallback.copy()
            wrist_ext = elbow + 1.2 * (wrist - elbow)
            band = np.zeros((height, width), np.uint8)
            poly = np.asarray([shoulder, elbow, wrist_ext],
                              np.float64).astype(np.uint16).astype(np.int32)
            imgproc.polylines(band, poly, 255, lw)
            # shoulder cap: a filled disc of radius lw // 2 (the reference's
            # PIL arc strokes inward from the outer radius)
            imgproc.circle(band, tuple(np.round(shoulder).astype(int)),
                           lw // 2, 255)
            return band > 0

        band_r = arm_band(sh_r, el_r, wr_r, arms_right)
        band_l = arm_band(sh_l, el_l, wr_l, arms_left)

        # hands (arm-labelled pixels outside the band) stay untouched
        fixed = fixed | (arms_left & ~band_l) | (arms_right & ~band_r)

    fixed = fixed | head
    garment = imgproc.dilate5(garment, 5)

    if category in ("dresses", "upper_body"):
        neck = imgproc.dilate5(parse == 18, 1)
        garment = garment | (neck & ~head)
        garment = garment | imgproc.dilate5(band_l | band_r, 4)

    keep = changeable & ~garment
    inpaint = ~(keep | fixed)
    final = _largest_component(_fill_holes(inpaint))

    mask = final.astype(np.uint8) * 255
    mask_gray = final.astype(np.uint8) * 127
    return mask, mask_gray


def make_inpaint_condition(person_rgb01: np.ndarray,
                           mask01: np.ndarray) -> np.ndarray:
    """The inpaint ControlNet's condition: masked pixels set to -1. person
    (H, W, 3) in [0, 1], mask (H, W) {0, 1} -> (1, H, W, 3) float32."""
    cond = person_rgb01.astype(np.float32).copy()
    cond[mask01 > 0.5] = -1.0
    return cond[None]


def person_upper_body_mask(path: str, height: int, width: int, *,
                           device="cuda",
                           stage_seconds: Optional[Dict[str, float]] = None
                           ) -> np.ndarray:
    """The automatic upper-body mask of a person photo: OpenPose keypoints
    on the photo resized to 384x512 (PIL's bicubic) and the SCHP parse of
    the photo, both on `device` from their default checkpoints, then
    `get_mask_location("hd", "upper_body", ...)` and OpenCV's nearest
    resize to (height, width). -> (1, height, width, 1) float32 {0, 1}.
    `stage_seconds`, where given, receives the wall time of each stage."""
    from imagdressing_tpu_torch.apps.image_utils import read_image
    from imagdressing_tpu_torch.preprocess.openpose import OpenPose
    from imagdressing_tpu_torch.preprocess.parsing import infer as parsing
    from imagdressing_tpu_torch.train.data import resize

    t = [time.perf_counter()]
    img = read_image(path)
    keypoints = OpenPose.get_default(device)(
        resize(img, (384, 512), "bicubic"))
    t.append(time.perf_counter())
    parse, _ = parsing.Parsing.get_default(device)(img)
    t.append(time.perf_counter())
    mask, _ = get_mask_location("hd", "upper_body", parse, keypoints)
    mask = cv2_resize_nearest(mask, width, height)
    t.append(time.perf_counter())
    if stage_seconds is not None:
        stage_seconds.update(openpose=t[1] - t[0], parse=t[2] - t[1],
                             mask=t[3] - t[2])
    return (mask[None, ..., None] > 127).astype(np.float32)
