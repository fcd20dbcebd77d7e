"""Target assignment and balanced sampling for the detector's RPN and ROI
losses (port of `imagdressing_tpu/detect/targets.py`; detectron2's Matcher
and subsample_labels with static shapes: every anchor or proposal keeps a
slot, selection is a 0/1 loss weight). Batched over a leading image axis.
"""

from __future__ import annotations

from typing import Tuple

import torch

from imagdressing_tpu_torch.ops import boxes as box_ops
from imagdressing_tpu_torch.ops.roi_align import roi_align


def match_boxes(candidates: torch.Tensor, gt_boxes: torch.Tensor,
                gt_valid: torch.Tensor, *, pos_iou: float, neg_iou: float,
                allow_low_quality: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """candidates (B, R, 4) (or (R, 4), shared), gt_boxes (B, G, 4),
    gt_valid (B, G) -> (matched gt index (B, R) int64, labels (B, R) int64
    in {1, 0, -1}).

    1 = positive (best IoU >= pos_iou), 0 = background (< neg_iou), -1 =
    ignored (the band between). With allow_low_quality the best candidate
    of every valid gt with some overlap is forced positive and matched to
    that gt (detectron2 allow_low_quality_matches, the RPN's); where two
    gts claim one candidate the later gt keeps it."""
    if candidates.dim() == 2:
        candidates = candidates.expand(gt_boxes.shape[0], -1, -1)
    iou = box_ops.pairwise_iou(candidates, gt_boxes)  # (B, R, G)
    iou = torch.where(gt_valid[:, None, :], iou, torch.full_like(iou, -1.0))
    best, matched = iou.max(dim=2)
    ones = torch.ones_like(matched)
    labels = torch.where(best >= pos_iou, ones,
                         torch.where(best < neg_iou, 0 * ones, -ones))
    if allow_low_quality:
        per_gt, best_per_gt = iou.max(dim=1)  # (B, G)
        has_overlap = gt_valid & (per_gt > 0)
        r = torch.arange(candidates.shape[1], device=iou.device)
        claims = (best_per_gt[:, None, :] == r[None, :, None]) \
            & has_overlap[:, None, :]  # (B, R, G)
        g = torch.arange(gt_boxes.shape[1], device=iou.device)
        claimed = torch.where(claims, g, torch.full_like(g, -1)).amax(2)
        force = claimed >= 0
        labels = torch.where(force, ones, labels)
        matched = torch.where(force, claimed, matched)
    return matched, labels


def draw_priorities(shape, generator: torch.Generator
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Uniform priorities for `sample_balanced`'s positive and negative
    draws, on the generator's device."""
    return (torch.rand(shape, generator=generator,
                       device=generator.device),
            torch.rand(shape, generator=generator,
                       device=generator.device))


def sample_balanced(labels: torch.Tensor,
                    priorities: Tuple[torch.Tensor, torch.Tensor], *,
                    num_samples: int, positive_fraction: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """labels (B, R) {1, 0, -1}, priorities (positive, negative) each (B,
    R) in [0, 1) -> (selected, positive) float {0, 1} weights (B, R): at
    most num_samples slots on, positives capped at num_samples *
    positive_fraction, each kind the slots of highest priority (the JAX
    package draws the priorities from its keys; the tests pass JAX's)."""
    n_pos = int(round(num_samples * positive_fraction))
    n_neg = num_samples - n_pos
    r = labels.shape[-1]

    def draw(mask, pri, k):
        pri = torch.where(mask, pri, torch.full_like(pri, -1.0))
        _, idx = box_ops.top_k(pri, k)
        chosen = torch.zeros_like(mask).scatter_(-1, idx, True)
        return chosen & mask  # drop slots that were just -1 padding

    w_pos = draw(labels == 1, priorities[0], min(n_pos, r))
    w_neg = draw(labels == 0, priorities[1], min(n_neg, r))
    return (w_pos | w_neg).float(), w_pos.float()


def crop_gt_masks(gt_masks: torch.Tensor, matched_idx: torch.Tensor,
                  rois: torch.Tensor, mask_size: int) -> torch.Tensor:
    """gt_masks (B, G, H, W) {0, 1}, matched_idx (B, P), rois (B, P, 4) xyxy
    -> (B, P, mask_size, mask_size) {0, 1} crops, bilinearly resampled in
    each roi and thresholded at 0.5 (detectron2 crop_and_resize). Each ROI
    is aligned on its matched gt mask in place (no (P, H, W) copy)."""
    b, g, h, w = gt_masks.shape
    p = rois.shape[1]
    image = torch.arange(b, device=rois.device)[:, None] * g
    rois5 = torch.cat([(image + matched_idx).to(rois.dtype)[..., None],
                       rois], dim=-1).reshape(-1, 5)
    crops = roi_align(gt_masks.reshape(b * g, h, w, 1).float(), rois5,
                      output_size=mask_size, sampling_ratio=2)
    return (crops[..., 0] >= 0.5).float().reshape(b, p, mask_size,
                                                  mask_size)
