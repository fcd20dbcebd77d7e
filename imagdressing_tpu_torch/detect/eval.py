"""Detection evaluation: person AP (port of `imagdressing_tpu/detect/
eval.py`; the COCOEvaluator seat of the reference's finetune_net.py,
reduced to the 1-class case the mhp_extension fine-tune evaluates).

Implements the standard 11-point-free PASCAL/COCO-style AP at a box-IoU
threshold over score-ranked detections across a dataset, plus the mean over
thresholds .50:.05:.95 (COCO mAP). Pure numpy — evaluation is offline.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = np.clip(a[:, 2] - a[:, 0], 0, None) * np.clip(
        a[:, 3] - a[:, 1], 0, None)
    area_b = np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(
        b[:, 3] - b[:, 1], 0, None)
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-9), 0.0)


def average_precision(
    detections: Dict[str, List[Dict]],  # image -> [{score, bbox xywh}]
    ground_truth: Dict[str, np.ndarray],  # image -> (G, 4) xyxy
    *,
    iou_threshold: float = 0.5,
) -> float:
    """Greedy score-ranked matching (each gt matched once), AP = area under
    the interpolated precision-recall curve."""
    rows = []  # (score, is_tp)
    n_gt = 0
    # images with detections but no ground-truth entry still contribute
    # false positives (otherwise hallucinations on negative images are free)
    names = list(ground_truth) + [
        n for n in detections if n not in ground_truth
    ]
    for name in names:
        gts = ground_truth.get(name, np.zeros((0, 4), np.float32))
        gts = np.asarray(gts, np.float32).reshape(-1, 4)
        n_gt += len(gts)
        dets = sorted(detections.get(name, []), key=lambda d: -d["score"])
        boxes = np.asarray(
            [[d["bbox"][0], d["bbox"][1],
              d["bbox"][0] + d["bbox"][2], d["bbox"][1] + d["bbox"][3]]
             for d in dets], np.float32).reshape(-1, 4)
        iou = _iou_matrix(boxes, gts)
        taken = np.zeros(len(gts), bool)
        for i, d in enumerate(dets):
            j = -1
            if iou.shape[1]:
                order = np.argsort(-iou[i])
                for cand in order:
                    if iou[i, cand] >= iou_threshold and not taken[cand]:
                        j = cand
                        break
            if j >= 0:
                taken[j] = True
                rows.append((d["score"], 1.0))
            else:
                rows.append((d["score"], 0.0))
    if n_gt == 0 or not rows:
        return 0.0
    rows.sort(key=lambda r: -r[0])
    tp = np.cumsum([r[1] for r in rows])
    fp = np.cumsum([1.0 - r[1] for r in rows])
    recall = tp / n_gt
    precision = tp / np.maximum(tp + fp, 1e-9)
    # monotone interpolation, integrate over recall
    precision = np.maximum.accumulate(precision[::-1])[::-1]
    r = np.concatenate([[0.0], recall])
    p = np.concatenate([[precision[0] if len(precision) else 0.0], precision])
    return float(np.sum((r[1:] - r[:-1]) * p[1:]))


def coco_map(detections, ground_truth,
             thresholds: Sequence[float] = tuple(
                 np.arange(0.5, 1.0, 0.05))) -> Dict[str, float]:
    """-> {"AP50", "AP75", "mAP"} for the person class."""
    aps = {f"AP{int(round(t * 100))}": average_precision(
        detections, ground_truth, iou_threshold=float(t))
        for t in thresholds}
    return {"AP50": aps.get("AP50", 0.0), "AP75": aps.get("AP75", 0.0),
            "mAP": float(np.mean(list(aps.values())))}
