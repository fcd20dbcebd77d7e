"""Losses and the metric of the SCHP human-parser fine-tune, in PyTorch
(port of `imagdressing_tpu/train/parsing_losses.py`; the reference's
criterion stack in preprocess/humanparsing/utils/):

  * cross_entropy_2d: per-pixel CE with an ignore index and class weights
    as a weighted mean (torch CrossEntropyLoss(weight=...))
  * lovasz_softmax: the convex Lovász extension of the IoU loss (Berman et
    al. 2018), errors sorted in a stable descending order
  * soft_dice_loss
  * kl_consistency: SCHP's self-correction KL(target || input)
  * schp_criterion: CE + Lovász on the fusion head, pos/neg-weighted CE on
    the edge head, the optional KL term
  * mean_iou: the confusion-matrix mIoU

Logits are channel-last (B, H, W, C), labels (B, H, W) integers. Where the
JAX package takes `axis_name` (the sums of a sharded batch), these take
`group`, a torch.distributed process group, or None.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F


def _all_sum(t: torch.Tensor, group) -> torch.Tensor:
    t = t.clone()
    dist.all_reduce(t, group=group)
    return t


def cross_entropy_2d(logits: torch.Tensor, labels: torch.Tensor,
                     ignore_index: int = 255,
                     class_weights: Optional[torch.Tensor] = None,
                     group=None) -> torch.Tensor:
    """Mean NLL over the pixels whose label is not `ignore_index`;
    `class_weights` (C,) make it the weighted mean (sum of weighted NLL /
    sum of the pixels' weights). With a group the denominator is the
    group's, and the numerator is scaled by the group's size: the caller
    averages the loss over the group, which gives the full batch's CE."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, 0).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    if class_weights is not None:
        wpix = class_weights.float()[safe]
        nll = nll * wpix
        denom = torch.where(valid, wpix, 0.0).sum()
    else:
        denom = valid.sum().float()
    num = torch.where(valid, nll, 0.0).sum()
    if group is not None:
        denom = _all_sum(denom, group)
        num = num * dist.get_world_size(group)
    return num / torch.clamp(denom, min=1e-8)


def _lovasz_grad(gt_sorted: torch.Tensor) -> torch.Tensor:
    """The Lovász extension's gradient with respect to the sorted errors,
    per row of (C, N)."""
    gts = gt_sorted.sum(-1, keepdim=True)
    intersection = gts - torch.cumsum(gt_sorted, -1)
    union = gts + torch.cumsum(1.0 - gt_sorted, -1)
    jaccard = 1.0 - intersection / torch.clamp(union, min=1e-8)
    return torch.cat([jaccard[..., :1], jaccard[..., 1:] - jaccard[..., :-1]],
                     dim=-1)


def lovasz_softmax(logits: torch.Tensor, labels: torch.Tensor,
                   ignore_index: int = 255) -> torch.Tensor:
    """The mean over the classes present in `labels` of the Lovász hinge on
    the softmax errors; ignored pixels get zero error (they sort to the
    tail). The sort is stable and descending, as JAX's `argsort(-errors)`:
    the order of equal errors does not change the value but does change
    its gradient."""
    c = logits.shape[-1]
    probs = torch.softmax(logits.float(), dim=-1).reshape(-1, c).t()
    labels = labels.reshape(-1)
    valid = (labels != ignore_index).float()
    classes = torch.arange(c, device=labels.device)[:, None]
    fg = (labels[None] == classes).float() * valid          # (C, N)
    errors = (fg - probs).abs() * valid
    errors_sorted, order = torch.sort(errors, dim=-1, descending=True,
                                      stable=True)
    grad = _lovasz_grad(torch.gather(fg, -1, order))
    present = fg.sum(-1) > 0
    losses = torch.where(present, (errors_sorted * grad).sum(-1), 0.0)
    return losses.sum() / torch.clamp(present.sum(), min=1)


def soft_dice_loss(logits: torch.Tensor, labels: torch.Tensor,
                   ignore_index: int = 255, eps: float = 1.0
                   ) -> torch.Tensor:
    c = logits.shape[-1]
    probs = torch.softmax(logits.float(), dim=-1).reshape(-1, c)
    labels = labels.reshape(-1)
    valid = (labels != ignore_index)[:, None].float()
    onehot = F.one_hot(torch.where(labels == ignore_index, 0, labels).long(),
                       c).float() * valid
    probs = probs * valid
    inter = (probs * onehot).sum(0)
    denom = probs.sum(0) + onehot.sum(0)
    dice = (2 * inter + eps) / (denom + eps)
    return 1.0 - dice.mean()


def kl_consistency(input_logits: torch.Tensor, target_logits: torch.Tensor,
                   labels: Optional[torch.Tensor] = None,
                   temperature: float = 1.0,
                   ignore_index: int = 255) -> torch.Tensor:
    """T^2 * KL(softmax(target / T) || softmax(input / T)), the element
    mean over the pixels not ignored (divided by valid pixels * C, torch's
    kl_div default), as the reference's KLDivergenceLoss."""
    t = temperature
    li = torch.log_softmax(input_logits.float() / t, -1)
    lt = torch.log_softmax(target_logits.float() / t, -1)
    elem = lt.exp() * (lt - li)
    if labels is not None:
        valid = (labels != ignore_index)[..., None].float()
        elem = elem * valid
        denom = torch.clamp(valid.sum() * elem.shape[-1], min=1.0)
    else:
        denom = elem.numel()
    return t * t * elem.sum() / denom


def schp_criterion(fusion_logits: torch.Tensor, edge_logits: torch.Tensor,
                   labels: torch.Tensor, edge_labels: torch.Tensor, *,
                   lovasz_weight: float = 1.0, edge_weight: float = 1.0,
                   prev_fusion_logits: Optional[torch.Tensor] = None,
                   cycle_weight: float = 0.0, group=None) -> torch.Tensor:
    """The SCHP objective (reference CriterionAll.parsing_loss): CE +
    Lovász on the parsing head, CE on the edge head with the classes
    weighted by the other class's share of the (group's) pixels, and the
    optional self-correction KL. The reference's consistency term is zero
    by construction and is left out, as in the JAX package."""
    loss = cross_entropy_2d(fusion_logits, labels, group=group)
    loss = loss + lovasz_weight * lovasz_softmax(fusion_logits, labels)
    ev = edge_labels != 255
    counts = torch.stack([((edge_labels == 1) & ev).sum(),
                          ((edge_labels == 0) & ev).sum()]).float()
    if group is not None:
        counts = _all_sum(counts, group)
    pos, neg = counts
    tot = torch.clamp(pos + neg, min=1.0)
    edge_w = torch.stack([pos / tot, neg / tot])  # [w_class0, w_class1]
    loss = loss + edge_weight * cross_entropy_2d(
        edge_logits, edge_labels, class_weights=edge_w, group=group)
    if prev_fusion_logits is not None and cycle_weight > 0:
        loss = loss + cycle_weight * kl_consistency(
            fusion_logits, prev_fusion_logits, labels)
    return loss


def mean_iou(pred: torch.Tensor, labels: torch.Tensor, num_classes: int,
             ignore_index: int = 255) -> torch.Tensor:
    """The mean IoU of the classes present in `labels`, from one confusion
    matrix; ignored pixels go to an extra bin that is dropped."""
    valid = labels != ignore_index
    p = torch.where(valid, pred, num_classes).long().reshape(-1)
    lab = torch.where(valid, labels, num_classes).long().reshape(-1)
    n = num_classes + 1
    conf = torch.bincount(lab * n + p, minlength=n * n).float().reshape(
        n, n)[:num_classes, :num_classes]
    inter = conf.diagonal()
    union = conf.sum(0) + conf.sum(1) - inter
    iou = inter / torch.clamp(union, min=1.0)
    present = (conf.sum(1) > 0).float()
    return (iou * present).sum() / torch.clamp(present.sum(), min=1.0)
