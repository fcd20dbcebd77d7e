"""Axis-aligned box ops of the person detector (port of
`imagdressing_tpu/ops/boxes.py`): areas, IoU, the Faster R-CNN delta
encoding, clipping, and a greedy NMS with a static output.

Boxes are (..., 4) [x0, y0, x1, y1] float. Every function works on the
tensor's device and reads nothing back to the host: `nms_fixed` runs its
`max_out` argmax-and-suppress steps batched over images, with no `.item()`
and no Python branch on a device value, so the detector's proposal and
detection steps queue on the card without a sync.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

# detectron2's Box2BoxTransform clamp on dw / dh
_CLAMP = math.log(1000.0 / 16)


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    return (boxes[..., 2] - boxes[..., 0]).clamp(min=0.0) * (
        boxes[..., 3] - boxes[..., 1]).clamp(min=0.0)


def pairwise_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., N, 4), (..., M, 4) -> (..., N, M) IoU (detectron2
    structures.pairwise_iou); a leading batch axis is allowed."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(a)[..., :, None] + box_area(b)[..., None, :] - inter
    return torch.where(union > 0, inter / union.clamp(min=1e-9),
                       torch.zeros_like(inter))


def _centers(boxes: torch.Tensor):
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    return boxes[..., 0] + 0.5 * w, boxes[..., 1] + 0.5 * h, w, h


def encode_boxes(boxes: torch.Tensor, anchors: torch.Tensor,
                 weights: Sequence[float] = (1.0, 1.0, 1.0, 1.0)
                 ) -> torch.Tensor:
    """gt boxes + anchors -> regression deltas (dx, dy, dw, dh)."""
    ax, ay, aw, ah = _centers(anchors)
    bx, by, bw, bh = _centers(boxes)
    wx, wy, ww, wh = weights
    aw_, ah_ = aw.clamp(min=1e-6), ah.clamp(min=1e-6)
    return torch.stack([
        wx * (bx - ax) / aw_,
        wy * (by - ay) / ah_,
        ww * torch.log(bw.clamp(min=1e-6) / aw_),
        wh * torch.log(bh.clamp(min=1e-6) / ah_),
    ], dim=-1)


def decode_boxes(deltas: torch.Tensor, anchors: torch.Tensor,
                 weights: Sequence[float] = (1.0, 1.0, 1.0, 1.0)
                 ) -> torch.Tensor:
    """regression deltas + anchors -> boxes (inverse of encode_boxes)."""
    ax, ay, aw, ah = _centers(anchors)
    wx, wy, ww, wh = weights
    dx = deltas[..., 0] / wx
    dy = deltas[..., 1] / wy
    dw = (deltas[..., 2] / ww).clamp(max=_CLAMP)
    dh = (deltas[..., 3] / wh).clamp(max=_CLAMP)
    cx = ax + dx * aw
    cy = ay + dy * ah
    w = aw * torch.exp(dw)
    h = ah * torch.exp(dh)
    return torch.stack(
        [cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], dim=-1)


def clip_boxes(boxes: torch.Tensor, height: float, width: float
               ) -> torch.Tensor:
    return torch.stack([
        boxes[..., 0].clamp(0.0, width), boxes[..., 1].clamp(0.0, height),
        boxes[..., 2].clamp(0.0, width), boxes[..., 3].clamp(0.0, height),
    ], dim=-1)


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """`jax.lax.top_k` over the last axis: the k largest in descending
    order, equal values in index order (a stable sort; `torch.topk` leaves
    the order of ties open)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def nms_fixed(boxes: torch.Tensor, scores: torch.Tensor, *,
              iou_threshold: float = 0.7, max_out: int = 100,
              score_threshold: float = -math.inf
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS with a static output size, batched over a leading axis.

    boxes (B, N, 4), scores (B, N) -> (indices (B, max_out) int64 padded
    with 0, valid (B, max_out) bool); a 2-D / 1-D call drops the batch
    axis. Each step takes the highest live score (the first on a tie, as
    `jnp.argmax`), records it, and suppresses it and every box whose IoU
    with it exceeds the threshold; once no box is live every later slot is
    invalid."""
    single = scores.dim() == 1
    if single:
        boxes, scores = boxes[None], scores[None]
    b, n = scores.shape
    overlaps = pairwise_iou(boxes, boxes) > iou_threshold  # (B, N, N)
    live = scores > score_threshold
    neg_inf = torch.full_like(scores, -math.inf)
    rows = torch.arange(b, device=scores.device)
    idxs, valid = [], []
    for _ in range(max_out):
        masked = torch.where(live, scores, neg_inf)
        j = masked.argmax(dim=1)
        ok = masked[rows, j] > -math.inf
        idxs.append(torch.where(ok, j, torch.zeros_like(j)))
        valid.append(ok)
        suppress = overlaps[rows, j]
        suppress[rows, j] = True
        live = live & ~suppress & ok[:, None]
    idx = torch.stack(idxs, dim=1)
    ok = torch.stack(valid, dim=1)
    return (idx[0], ok[0]) if single else (idx, ok)
