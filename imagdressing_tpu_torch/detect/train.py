"""Mask R-CNN training: the losses and the train step (port of
`imagdressing_tpu/detect/train.py`; the reference's mhp_extension person
fine-tune, detectron2 GeneralizedRCNN's loss structure):

  * RPN objectness BCE and box L1 on balanced samples of the anchors;
  * per cascade stage, ROI softmax CE and class-agnostic box L1 on balanced
    samples of the proposals (gt boxes appended, so positives exist);
  * mask BCE on the matched gt's crops of the final stage's positives.

Proposals and samples are fixed in number, with 0/1 loss weights.

Batch: image (B, H, W, 3) float [0, 1] with H, W % 64 == 0; gt_boxes (B,
G, 4) xyxy zero-padded; gt_valid (B, G) bool; gt_masks (B, G, H, W) {0, 1}.

The random draws of the balanced sampling are explicit: `draws` holds the
RPN's and each stage's (positive, negative) priorities per image
(`make_draws` takes them from a torch.Generator; the JAX package takes
them from its keys, and the tests pass JAX's draws in).

Data parallel: each rank holds its images. The three loss normalisers
(the RPN's selected anchors, each stage's selected proposals, the final
stage's positives) are summed over the data group before they divide, and
the gradients are summed, not averaged, so N ranks take the step that one
device takes on the whole batch (as GSPMD keeps the JAX package's sums
global).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from imagdressing_tpu_torch.core import mesh as mesh_lib
from imagdressing_tpu_torch.detect import maskrcnn, targets
from imagdressing_tpu_torch.ops import boxes as box_ops

Draws = Dict[str, Tuple[torch.Tensor, torch.Tensor]]


def make_draws(cfg: maskrcnn.MaskRCNNConfig, batch: int,
               image_hw: Tuple[int, int], generator: torch.Generator
               ) -> Draws:
    """The sampling priorities of one step for `batch` images, from the
    generator (on its device): "rpn" (B, anchors) and "roi{stage}" (B,
    proposals + max_gt), each a (positive, negative) pair. A data rank
    takes its own images' rows of the global batch's draws."""
    n_anchors = sum((image_hw[0] // s) * (image_hw[1] // s)
                    for s in cfg.strides) * cfg.num_anchors
    n_roi = cfg.rpn_post_nms_topk + cfg.max_gt
    draws = {"rpn": targets.draw_priorities((batch, n_anchors), generator)}
    for stage in range(len(cfg.cascade_ious)):
        draws[f"roi{stage}"] = targets.draw_priorities((batch, n_roi),
                                                       generator)
    return draws


def rows_of(draws: Draws, start: int, stop: int) -> Draws:
    return {k: (p[start:stop], n[start:stop]) for k, (p, n) in draws.items()}


def _sigmoid_bce(logits: torch.Tensor, labels: torch.Tensor
                 ) -> torch.Tensor:
    return F.binary_cross_entropy_with_logits(logits, labels,
                                              reduction="none")


def _global_count(x: torch.Tensor, group) -> torch.Tensor:
    return mesh_lib.psum(x.sum(), group)


def detection_loss(model: maskrcnn.MaskRCNN, batch: Dict[str, torch.Tensor],
                   draws: Draws, *, group=None,
                   proposals: Optional[Tuple[torch.Tensor,
                                             torch.Tensor]] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """-> (total, {rpn_obj, rpn_box, roi{s}_cls, roi{s}_box, mask, total}).
    `group`: the data group whose ranks hold the rest of the batch (None:
    this process holds all of it); each rank's losses are then its share,
    and their sum over the group is the whole batch's loss. `proposals`:
    (boxes (B, P, 4), valid (B, P)) in place of `rpn_proposals` of this
    model's RPN outputs (a check feeds another device's, so that the ROI
    stages meet the same top-k and NMS choices)."""
    cfg = model.cfg
    images = batch["image"]
    gt_valid = batch["gt_valid"].bool()
    gt_boxes = batch["gt_boxes"].float()
    gt_masks = batch["gt_masks"]
    # padding gt slots are (0, 0, 0, 0): encode_boxes would take log(0) =
    # -inf there, and -inf times a zero weight is NaN; a finite unit box
    # stands in (matching ignores invalid gts)
    unit = torch.tensor([0.0, 0.0, 1.0, 1.0], device=gt_boxes.device)
    gt_boxes = torch.where(gt_valid[..., None], gt_boxes, unit)
    b, h, w = images.shape[:3]

    feats = maskrcnn.apply_backbone_fpn(model, images)
    anchors = maskrcnn.anchors_on(cfg, (h, w), str(images.device))
    objectness, rpn_deltas = maskrcnn.apply_rpn_head(model, feats)

    # ---- RPN targets ----------------------------------------------------
    matched, labels = targets.match_boxes(
        anchors, gt_boxes, gt_valid, pos_iou=cfg.rpn_pos_iou,
        neg_iou=cfg.rpn_neg_iou, allow_low_quality=True)
    wsel, wpos = targets.sample_balanced(
        labels, draws["rpn"], num_samples=cfg.rpn_samples,
        positive_fraction=cfg.rpn_pos_fraction)
    reg_t = box_ops.encode_boxes(_take(gt_boxes, matched), anchors,
                                 cfg.rpn_delta_weights)
    denom = _global_count(wsel, group).clamp(min=1.0)
    rpn_obj = (_sigmoid_bce(objectness, (labels == 1).float())
               * wsel).sum() / denom
    rpn_box = ((rpn_deltas - reg_t).abs().sum(-1) * wpos).sum() / denom

    # ---- proposals (no gradient through the RPN outputs) -----------------
    if proposals is None:
        proposals = maskrcnn.rpn_proposals(
            cfg, anchors, objectness.detach(), rpn_deltas.detach(), (h, w))
    proposals, pvalid = proposals
    proposals = torch.cat([proposals, gt_boxes], dim=1)  # (B, P+G, 4)
    pvalid = torch.cat([pvalid, gt_valid], dim=1)
    n_roi = proposals.shape[1]

    losses = {"rpn_obj": rpn_obj, "rpn_box": rpn_box}
    total = rpn_obj + rpn_box
    last = None
    for stage, stage_iou in enumerate(cfg.cascade_ious):
        matched, lab = targets.match_boxes(
            proposals, gt_boxes, gt_valid, pos_iou=stage_iou,
            neg_iou=stage_iou)
        lab = torch.where(pvalid, lab, torch.full_like(lab, -1))
        rsel, rpos = targets.sample_balanced(
            lab, draws[f"roi{stage}"], num_samples=cfg.roi_samples,
            positive_fraction=cfg.roi_pos_fraction)
        cls_logits, box_deltas = maskrcnn.roi_forward(
            model, feats, maskrcnn.rois_with_batch(proposals), stage=stage)
        cls_logits = cls_logits.reshape(b, n_roi, -1)
        box_deltas = box_deltas.reshape(b, n_roi, 4)
        # 1-class person: class 1 for positives, 0 background
        cls_t = (lab == 1).long()
        rdenom = _global_count(rsel, group).clamp(min=1.0)
        cls_loss = (F.cross_entropy(cls_logits.transpose(1, 2), cls_t,
                                    reduction="none") * rsel).sum() / rdenom
        reg_target = box_ops.encode_boxes(_take(gt_boxes, matched),
                                          proposals, cfg.roi_delta_weights)
        box_loss = ((box_deltas - reg_target).abs().sum(-1)
                    * rpos).sum() / rdenom
        losses[f"roi{stage}_cls"] = cls_loss
        losses[f"roi{stage}_box"] = box_loss
        total = total + cls_loss + box_loss
        last = (rpos, matched, proposals)
        if stage + 1 < len(cfg.cascade_ious):
            # cascade: the refined (detached) boxes feed the next stage
            proposals = box_ops.clip_boxes(
                box_ops.decode_boxes(box_deltas, proposals,
                                     cfg.roi_delta_weights),
                float(h), float(w)).detach()

    # ---- mask head on the final stage's sampled proposals ----------------
    last_wpos, last_matched, last_rois = last
    m = cfg.mask_size
    mask_logits = maskrcnn.mask_forward(
        model, feats, maskrcnn.rois_with_batch(last_rois))
    mask_logits = mask_logits[..., 0].reshape(b, n_roi, m, m)
    with torch.no_grad():
        mtargets = targets.crop_gt_masks(gt_masks, last_matched, last_rois,
                                         m)
    mdenom = (_global_count(last_wpos, group) * m * m).clamp(min=1.0)
    mask_loss = (_sigmoid_bce(mask_logits, mtargets).sum((2, 3))
                 * last_wpos).sum() / mdenom
    losses["mask"] = mask_loss
    total = total + mask_loss
    losses["total"] = total
    return total, losses


def _take(gt_boxes: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """gt_boxes (B, G, 4)[b, idx[b, r]] -> (B, R, 4)."""
    return torch.gather(gt_boxes, 1, idx[..., None].expand(-1, -1, 4))


class ClipAdam:
    """The detector CLI's optimizer, optax.chain(clip_by_global_norm(1.0),
    adam(lr)), on a list of parameters in optax's arithmetic: the clip
    scales by 1 / norm only when norm >= 1 (no epsilon); mu = (1 - b1) g +
    b1 mu, nu = (1 - b2) g^2 + b2 nu, bias corrections 1 - b^t in float32,
    update -lr * mu_hat / (sqrt(nu_hat) + eps). (`torch.optim.Adam` and
    `clip_grad_norm_` round differently: the latter divides by norm +
    1e-6.)"""

    MAX_NORM, B1, B2, EPS = 1.0, 0.9, 0.999, 1e-8  # optax's defaults

    def __init__(self, params: List[torch.Tensor], lr: float):
        self.params = list(params)
        self.lr = lr
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """Apply one update from `grads` (one per parameter); returns the
        global gradient norm before the clip (a device scalar)."""
        b1, b2 = self.B1, self.B2
        norm = torch.sqrt(sum((g * g).sum() for g in grads))
        keep = norm < self.MAX_NORM
        self.count += 1
        one = torch.ones((), dtype=torch.float32, device=norm.device)
        bc1 = 1 - (one * b1) ** self.count
        bc2 = 1 - (one * b2) ** self.count
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            g = torch.where(keep, g, (g / norm) * self.MAX_NORM)
            mu.copy_((1 - b1) * g + b1 * mu)
            nu.copy_((1 - b2) * (g * g) + b2 * nu)
            update = (mu / bc1) / (torch.sqrt(nu / bc2) + self.EPS)
            p.add_(-self.lr * update)
        return norm


def loss_and_grads(model: maskrcnn.MaskRCNN, batch: Dict[str, torch.Tensor],
                   draws: Draws, *, group=None, proposals=None
                   ) -> Tuple[Dict[str, torch.Tensor], List[torch.Tensor]]:
    """-> (this rank's losses, the gradient of the whole batch's loss for
    each parameter): with a data group, the ranks' gradients summed (one
    all-reduce of the flat gradient). `proposals`: as `detection_loss`."""
    params = list(model.parameters())
    total, losses = detection_loss(model, batch, draws, group=group,
                                   proposals=proposals)
    grads = torch.autograd.grad(total, params)
    if group is not None:
        flat = mesh_lib.psum(torch.cat([g.reshape(-1) for g in grads]),
                             group)
        grads = [t.view_as(g) for t, g in
                 zip(flat.split([g.numel() for g in grads]), grads)]
    return losses, list(grads)


def make_train_step(model: maskrcnn.MaskRCNN, optimizer: ClipAdam, *,
                    mesh: Optional[mesh_lib.Mesh] = None):
    """-> step(batch, draws) -> metrics (device scalars: the losses of the
    whole batch and "grad_norm"). With a mesh, `batch` and `draws` are this
    rank's rows and every rank applies the same update."""
    group = None if mesh is None else mesh.data_group

    def step(batch: Dict[str, torch.Tensor], draws: Draws
             ) -> Dict[str, torch.Tensor]:
        losses, grads = loss_and_grads(model, batch, draws, group=group)
        norm = optimizer.step(grads)
        names = sorted(losses)
        values = mesh_lib.psum(torch.stack([losses[k].detach()
                                            for k in names]), group)
        metrics = dict(zip(names, values.unbind()))
        metrics["grad_norm"] = norm
        return metrics

    return step
