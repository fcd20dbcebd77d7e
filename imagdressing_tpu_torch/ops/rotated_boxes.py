"""Rotated-box IoU and NMS (port of `imagdressing_tpu/ops/rotated_boxes.py`):
parity for detectron2's csrc ops box_iou_rotated / nms_rotated, which the
reference's offline dataset-construction toolchain vendors.

Boxes are (cx, cy, w, h, angle_degrees) with detectron2's convention
(angle CCW). The exact IoU comes from convex-polygon clipping
(Sutherland-Hodgman) and the shoelace area, in float64 numpy on the host,
as in the JAX package: these ops run in offline data preparation only.
Inputs may be numpy arrays or CPU tensors; results are numpy arrays, equal
to the JAX module's bit for bit.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch


def _host(a) -> np.ndarray:
    """A numpy view of `a` in its own dtype (a tensor's on the host)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def box_to_corners(boxes) -> np.ndarray:
    """(N, 5) -> (N, 4, 2) corner coordinates (CCW)."""
    boxes = _host(boxes)
    cx, cy, w, h, ang = (boxes[:, i] for i in range(5))
    theta = np.deg2rad(ang)
    c, s = np.cos(theta), np.sin(theta)
    dx = np.stack([w / 2, w / 2, -w / 2, -w / 2], axis=1)  # (N,4)
    dy = np.stack([-h / 2, h / 2, h / 2, -h / 2], axis=1)
    x = cx[:, None] + dx * c[:, None] - dy * s[:, None]
    y = cy[:, None] + dx * s[:, None] + dy * c[:, None]
    return np.stack([x, y], axis=-1)


def _polygon_area(poly: np.ndarray) -> float:
    if len(poly) < 3:
        return 0.0
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * abs(
        float(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))
    )


def _cross2(u: np.ndarray, v: np.ndarray) -> float:
    return float(u[0] * v[1] - u[1] * v[0])


def _clip_polygon(subject: np.ndarray, clip: np.ndarray) -> np.ndarray:
    """Sutherland-Hodgman: clip `subject` polygon by convex CCW `clip`."""
    output = list(subject)
    n = len(clip)
    for i in range(n):
        a, b = clip[i], clip[(i + 1) % n]
        edge = b - a
        if not output:
            break
        input_pts = output
        output = []
        prev = input_pts[-1]
        prev_in = _cross2(edge, prev - a) >= 0
        for cur in input_pts:
            cur_in = _cross2(edge, cur - a) >= 0
            if cur_in != prev_in:
                d = cur - prev
                denom = _cross2(edge, d)
                if abs(denom) > 1e-12:
                    # solve cross(edge, (prev - a) + t*d) == 0
                    t = _cross2(edge, a - prev) / denom
                    output.append(prev + np.clip(t, 0.0, 1.0) * d)
            if cur_in:
                output.append(cur)
            prev, prev_in = cur, cur_in
    return np.asarray(output) if output else np.zeros((0, 2))


def pairwise_iou_rotated(boxes1, boxes2) -> np.ndarray:
    """(N, 5) x (M, 5) -> (N, M) exact rotated IoU."""
    boxes1, boxes2 = _host(boxes1), _host(boxes2)
    c1 = box_to_corners(np.asarray(boxes1, np.float64))
    c2 = box_to_corners(np.asarray(boxes2, np.float64))
    a1 = boxes1[:, 2] * boxes1[:, 3]
    a2 = boxes2[:, 2] * boxes2[:, 3]
    out = np.zeros((len(boxes1), len(boxes2)))
    for i in range(len(boxes1)):
        for j in range(len(boxes2)):
            inter = _polygon_area(_clip_polygon(c1[i], c2[j]))
            union = a1[i] + a2[j] - inter
            out[i, j] = inter / union if union > 0 else 0.0
    return out


def nms_rotated(boxes, scores, iou_threshold: float) -> np.ndarray:
    """Greedy rotated NMS; returns kept indices sorted by score."""
    boxes, scores = _host(boxes), _host(scores)
    order = np.argsort(-scores)
    keep: List[int] = []
    suppressed = np.zeros(len(boxes), bool)
    for idx in order:
        if suppressed[idx]:
            continue
        keep.append(int(idx))
        rest = order[~suppressed[order]]
        rest = rest[rest != idx]
        if len(rest) == 0:
            continue
        ious = pairwise_iou_rotated(boxes[idx: idx + 1], boxes[rest])[0]
        suppressed[rest[ious > iou_threshold]] = True
    return np.asarray(keep, np.int64)
