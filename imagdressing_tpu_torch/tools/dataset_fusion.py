"""Offline dataset-construction fusion utilities (port of
`imagdressing_tpu/tools/dataset_fusion.py`; the reference's mhp_extension
logits_fusion.py), on host numpy:

  * mask_nms     — panoptic-style instance suppression: high-score person
    masks claim pixels first; an instance mostly covered by earlier ones is
    dropped, partial overlaps are carved away (:10-47).
  * stitch_patch_logits — paste per-person crop logits back into the full
    image canvas, summing overlaps (patch2img_output, :117-135).
  * fuse_global_local   — global parse + stitched instance logits -> final
    label map: argmax over the summed logits, instance id map via the
    panoptic mask (refine/get_instance semantics).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from imagdressing_tpu_torch.ops.resize import cv2_resize_linear


def mask_nms(
    masks: np.ndarray,  # (H, W, N) {0,1}, sorted by descending score
    scores: Sequence[float],
    *,
    confidence_threshold: float = 0.5,
    overlap_threshold: float = 0.7,
) -> Tuple[np.ndarray, List[int]]:
    """-> (panoptic_seg (H,W) int with ids 1..K, kept_instance_indices)."""
    panoptic = np.zeros(masks.shape[:2], np.int32)
    kept: List[int] = []
    next_id = 0
    for idx in range(masks.shape[-1]):
        if scores[idx] < confidence_threshold:
            break
        mask = masks[:, :, idx] > 0
        area = int(mask.sum())
        if area == 0:
            continue
        intersect = mask & (panoptic > 0)
        if intersect.sum() / area > overlap_threshold:
            continue
        free = mask & (panoptic == 0)
        next_id += 1
        panoptic[free] = next_id
        kept.append(idx)
    return panoptic, kept


def stitch_patch_logits(
    patches: Sequence[np.ndarray],  # list of (h_i, w_i, C) logits
    boxes: Sequence[Tuple[int, int, int, int]],  # (top, left, h, w)
    img_height: int,
    img_width: int,
    num_classes: int,
) -> np.ndarray:
    """Sum per-person crop logits into an image-size canvas (a patch of
    another size resized as OpenCV's INTER_LINEAR)."""
    canvas = np.zeros((img_height, img_width, num_classes), np.float32)
    for logits, (top, left, h, w) in zip(patches, boxes):
        if logits.shape[:2] != (h, w):
            x = torch.from_numpy(np.asarray(logits, np.float32))
            logits = cv2_resize_linear(x if x.ndim == 3 else x[..., None],
                                       w, h).numpy()
        canvas[top : top + h, left : left + w] += logits
    return canvas


def fuse_global_local(
    global_logits: np.ndarray,  # (H, W, C)
    local_logits: np.ndarray,  # (H, W, C) stitched instance logits
    panoptic: np.ndarray,  # (H, W) instance ids (0 = background)
) -> Tuple[np.ndarray, np.ndarray]:
    """-> (category label map, instance label map).

    Fused category = argmax(global + local); instance labels follow the
    panoptic mask where the fused category is foreground.
    """
    fused = global_logits + local_logits
    category = np.argmax(fused, axis=-1).astype(np.uint8)
    instance = np.where(category > 0, panoptic, 0).astype(np.int32)
    return category, instance
