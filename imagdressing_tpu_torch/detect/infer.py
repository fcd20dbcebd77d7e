"""Mask R-CNN inference and the make_crop instances contract (port of
`imagdressing_tpu/detect/infer.py`): `detect_instances` is the device
program (a static number of detections per image, batched NMS);
`to_instances` turns one image's padded detections into the list
`tools/make_crop.py` reads: [{score, bbox [x, y, w, h], segmentation (H, W)
uint8}], score-descending (detectron2's instances_predictions with full
masks in place of RLE).

Test-time thresholds default to parsing_inference.yaml (NMS 0.95, score
0.5).
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from imagdressing_tpu_torch.detect import maskrcnn
from imagdressing_tpu_torch.ops import boxes as box_ops
from imagdressing_tpu_torch.ops.resize import cv2_resize_linear


@torch.no_grad()
def detect_instances(model: maskrcnn.MaskRCNN, images: torch.Tensor, *,
                     max_detections: int = 20, score_threshold: float = 0.5,
                     nms_threshold: float = 0.95) -> Dict[str, torch.Tensor]:
    """images (B, H, W, 3) float [0, 1] -> boxes (B, D, 4) xyxy, scores (B,
    D), valid (B, D), masks (B, D, 2m, 2m) sigmoid probabilities in ROI
    coordinates, on the images' device."""
    cfg = model.cfg
    b, h, w = images.shape[:3]
    feats = maskrcnn.apply_backbone_fpn(model, images)
    anchors = maskrcnn.anchors_on(cfg, (h, w), str(images.device))
    objectness, rpn_deltas = maskrcnn.apply_rpn_head(model, feats)
    proposals, pvalid = maskrcnn.rpn_proposals(
        cfg, anchors, objectness, rpn_deltas, (h, w))
    n_roi = proposals.shape[1]
    scores = None
    for stage in range(len(cfg.cascade_ious)):
        cls_logits, box_deltas = maskrcnn.roi_forward(
            model, feats, maskrcnn.rois_with_batch(proposals), stage=stage)
        probs = torch.softmax(cls_logits.reshape(b, n_roi, -1), dim=-1)
        # cascade: the stages' scores averaged (detectron2 CascadeROIHeads)
        scores = probs if scores is None else scores + probs
        boxes = box_ops.clip_boxes(
            box_ops.decode_boxes(box_deltas.reshape(b, n_roi, 4), proposals,
                                 cfg.roi_delta_weights),
            float(h), float(w))
        if stage + 1 < len(cfg.cascade_ious):
            proposals = boxes
    scores = scores / len(cfg.cascade_ious)
    person = torch.where(pvalid, scores[..., 1], torch.zeros_like(
        scores[..., 1]))  # class 1 = person
    keep, valid = box_ops.nms_fixed(
        boxes, person, iou_threshold=nms_threshold, max_out=max_detections,
        score_threshold=score_threshold)
    dboxes = torch.gather(boxes, 1, keep[..., None].expand(-1, -1, 4))
    dscores = torch.gather(person, 1, keep)
    m = cfg.mask_size
    mask_logits = maskrcnn.mask_forward(model, feats,
                                        maskrcnn.rois_with_batch(dboxes))
    masks = torch.sigmoid(mask_logits[..., 0]).reshape(
        b, max_detections, m, m)
    return {"boxes": dboxes, "scores": dscores, "valid": valid,
            "masks": masks}


def paste_mask(mask: np.ndarray, box: np.ndarray, height: int, width: int,
               threshold: float = 0.5) -> np.ndarray:
    """Paste one ROI-space mask into a (height, width) canvas: the box
    rounded and clamped into the frame, the mask resized to it as OpenCV's
    INTER_LINEAR and thresholded (detectron2 paste_masks_in_image on the
    host)."""
    x0, y0, x1, y1 = [int(round(float(v))) for v in box]
    canvas = np.zeros((height, width), np.uint8)
    # clamp INTO the frame on both ends: an un-letterboxed box can land
    # entirely in the padding (x0 >= width)
    x0 = max(min(x0, width - 1), 0)
    y0 = max(min(y0, height - 1), 0)
    x1 = min(max(x1, x0 + 1), width)
    y1 = min(max(y1, y0 + 1), height)
    if x1 <= x0 or y1 <= y0:
        return canvas
    resized = cv2_resize_linear(
        torch.from_numpy(np.asarray(mask, np.float32))[..., None],
        x1 - x0, y1 - y0)[..., 0].numpy()
    canvas[y0:y1, x0:x1] = (resized >= threshold).astype(np.uint8)
    return canvas


def to_instances(det: Dict[str, np.ndarray], image_index: int, height: int,
                 width: int) -> List[Dict[str, Any]]:
    """One image's padded detections (numpy) -> [{score, bbox [x, y, w,
    h], segmentation (H, W) uint8}], score-descending."""
    boxes = np.asarray(det["boxes"][image_index])
    scores = np.asarray(det["scores"][image_index])
    valid = np.asarray(det["valid"][image_index])
    masks = np.asarray(det["masks"][image_index])
    out = []
    for i in np.argsort(-scores):
        if not valid[i]:
            continue
        x0, y0, x1, y1 = boxes[i]
        out.append({
            "score": float(scores[i]),
            "bbox": [float(x0), float(y0), float(x1 - x0), float(y1 - y0)],
            "segmentation": paste_mask(masks[i], boxes[i], height, width),
        })
    return out
