"""Mask R-CNN (FPN) person detector of the offline dataset toolchain (port
of `imagdressing_tpu/detect/maskrcnn.py`; the reference's vendored
detectron2 1-class cascade Mask R-CNN, configs/Misc/
parsing_finetune_cihp.yaml):

  * a ResNet-shaped GroupNorm backbone (NHWC), FPN P2..P6 (P6 a stride-2
    subsample of P5, detectron2's LastLevelMaxPool);
  * an RPN head shared across levels; proposals by a stable top-k and the
    fixed-size greedy NMS of `ops/boxes.nms_fixed`, batched over images;
  * class-agnostic box heads, one per cascade stage;
  * a mask head on ROI-aligned features.

Every count is fixed by the config, so no step reads a device value back
to the host. The modules' attribute paths are the JAX parameter tree's keys
(`convert.detector_params_from_jax` maps a JAX tree by path). The convs run
on cuDNN and the GroupNorm is the plain `ops.nn.group_norm`, as the JAX
package runs them through XLA (no Pallas kernel on this path).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import List, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from imagdressing_tpu_torch.ops import boxes as box_ops
from imagdressing_tpu_torch.ops.nn import Conv2d, Linear, Norm, group_norm
from imagdressing_tpu_torch.ops.nn import init_module
from imagdressing_tpu_torch.ops.roi_align import roi_align_levels


@dataclasses.dataclass(frozen=True)
class MaskRCNNConfig:
    num_classes: int = 1  # person (parsing_finetune_cihp.yaml ROI_HEADS)
    # backbone (resnet-18-shaped by default; shrink for tests)
    stem_channels: int = 64
    stage_channels: Tuple[int, ...] = (64, 128, 256, 512)
    stage_blocks: Tuple[int, ...] = (2, 2, 2, 2)
    norm_groups: int = 16
    # FPN
    fpn_dim: int = 256
    # anchors: one size per level P2..P6 (strides 4..64), 3 aspect ratios
    anchor_sizes: Tuple[float, ...] = (32.0, 64.0, 128.0, 256.0, 512.0)
    anchor_ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    # RPN
    rpn_pre_nms_topk: int = 1000
    rpn_post_nms_topk: int = 256
    rpn_nms_threshold: float = 0.7
    rpn_pos_iou: float = 0.7
    rpn_neg_iou: float = 0.3
    rpn_samples: int = 256
    rpn_pos_fraction: float = 0.5
    # ROI heads
    roi_samples: int = 128
    roi_pos_fraction: float = 0.25
    cascade_ious: Tuple[float, ...] = (0.5,)  # one entry per cascade stage
    box_fc_dim: int = 1024
    roi_size: int = 7
    # mask head
    mask_roi_size: int = 14
    mask_convs: int = 4
    max_gt: int = 16
    # box-delta weights (detectron2 Box2BoxTransform defaults)
    rpn_delta_weights: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0)
    roi_delta_weights: Tuple[float, ...] = (10.0, 10.0, 5.0, 5.0)

    @property
    def strides(self) -> Tuple[int, ...]:
        return (4, 8, 16, 32, 64)

    @property
    def num_anchors(self) -> int:
        return len(self.anchor_ratios)

    @property
    def mask_size(self) -> int:
        return self.mask_roi_size * 2


def tiny_config() -> MaskRCNNConfig:
    """Small config for tests / CPU smoke runs."""
    return MaskRCNNConfig(
        stem_channels=8, stage_channels=(8, 16, 16, 16),
        stage_blocks=(1, 1, 1, 1), norm_groups=4, fpn_dim=16,
        rpn_pre_nms_topk=64, rpn_post_nms_topk=32, rpn_samples=32,
        roi_samples=16, box_fc_dim=32, mask_roi_size=7, mask_convs=1,
        max_gt=4,
    )


# --------------------------------------------------------------------------
# modules (weights; the JAX tree's paths)
# --------------------------------------------------------------------------


class _Block(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__()
        self.stride = stride
        self.conv1 = Conv2d(cin, cout, 3, stride=stride, padding=1)
        self.norm1 = Norm(cout)
        self.conv2 = Conv2d(cout, cout, 3, padding=1)
        self.norm2 = Norm(cout)
        if stride != 1 or cin != cout:
            # the 1x1 stride-s conv as a subsample and a 1x1 conv: the same
            # function, and PyTorch 2.13's CPU weight gradient of a strided
            # channels_last 1x1 conv writes out of bounds (heap corruption)
            self.shortcut = Conv2d(cin, cout, 1)

    def forward(self, x: torch.Tensor, groups: int) -> torch.Tensor:
        h = self.conv1(x)
        h = F.relu(group_norm(h, self.norm1.weight, self.norm1.bias,
                              num_groups=groups))
        h = self.conv2(h)
        h = group_norm(h, self.norm2.weight, self.norm2.bias,
                       num_groups=groups)
        if hasattr(self, "shortcut"):
            x = self.shortcut(x[:, ::self.stride, ::self.stride])
        return F.relu(x + h)


class _Backbone(nn.Module):
    def __init__(self, cfg: MaskRCNNConfig):
        super().__init__()
        self.stem = Conv2d(3, cfg.stem_channels, 7, stride=2, padding=3)
        self.stem_norm = Norm(cfg.stem_channels)
        self.stages = nn.ModuleList()
        cin = cfg.stem_channels
        for ch, n in zip(cfg.stage_channels, cfg.stage_blocks):
            self.stages.append(nn.ModuleList(
                _Block(cin if j == 0 else ch, ch, 2 if j == 0 else 1)
                for j in range(n)))
            cin = ch


class _FPN(nn.Module):
    def __init__(self, cfg: MaskRCNNConfig):
        super().__init__()
        d = cfg.fpn_dim
        self.lateral = nn.ModuleList(Conv2d(ch, d, 1)
                                     for ch in cfg.stage_channels)
        self.output = nn.ModuleList(Conv2d(d, d, 3, padding=1)
                                    for _ in cfg.stage_channels)


class _RPN(nn.Module):
    def __init__(self, cfg: MaskRCNNConfig):
        super().__init__()
        d, a = cfg.fpn_dim, cfg.num_anchors
        self.conv = Conv2d(d, d, 3, padding=1)
        self.obj = Conv2d(d, a, 1)
        self.deltas = Conv2d(d, 4 * a, 1)


class _BoxHead(nn.Module):
    def __init__(self, cfg: MaskRCNNConfig):
        super().__init__()
        in_dim = cfg.fpn_dim * cfg.roi_size * cfg.roi_size
        self.fc1 = Linear(in_dim, cfg.box_fc_dim)
        self.fc2 = Linear(cfg.box_fc_dim, cfg.box_fc_dim)
        self.cls = Linear(cfg.box_fc_dim, cfg.num_classes + 1)
        self.box = Linear(cfg.box_fc_dim, 4)  # class-agnostic regression


class _MaskConv(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.conv = Conv2d(d, d, 3, padding=1)
        self.norm = Norm(d)


class _MaskHead(nn.Module):
    def __init__(self, cfg: MaskRCNNConfig):
        super().__init__()
        d = cfg.fpn_dim
        self.convs = nn.ModuleList(_MaskConv(d)
                                   for _ in range(cfg.mask_convs))
        self.up = Conv2d(d, d, 3, padding=1)
        self.logits = Conv2d(d, cfg.num_classes, 1)


class MaskRCNN(nn.Module):
    """The detector's weights, with its config."""

    def __init__(self, cfg: MaskRCNNConfig):
        super().__init__()
        self.cfg = cfg
        self.backbone = _Backbone(cfg)
        self.fpn = _FPN(cfg)
        self.rpn = _RPN(cfg)
        self.box_heads = nn.ModuleList(_BoxHead(cfg)
                                       for _ in cfg.cascade_ious)
        self.mask = _MaskHead(cfg)


def init(seed: int, cfg: MaskRCNNConfig,
         device: Union[str, torch.device] = "cuda") -> MaskRCNN:
    """A random detector with the JAX `init`'s distribution (convs and
    linears uniform in +-1/sqrt(fan_in), norms identity), drawn from a
    torch.Generator on `device` (other numbers than the JAX init, and on
    the CPU than on a card). Raises for CUDA on a host without a card."""
    from imagdressing_tpu_torch.pipelines.dressing import resolve_device

    device = resolve_device(device)
    with torch.device(device):
        model = MaskRCNN(cfg)
    init_module(model, torch.Generator(device=device).manual_seed(seed))
    return model


# --------------------------------------------------------------------------
# backbone + FPN
# --------------------------------------------------------------------------


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    b, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(
        b, 2 * h, 2 * w, c)


def apply_backbone_fpn(model: MaskRCNN, images: torch.Tensor
                       ) -> List[torch.Tensor]:
    """images (B, H, W, 3) float in [0, 1], H and W divisible by 64 ->
    [P2, P3, P4, P5, P6] NHWC feature maps at strides 4..64."""
    cfg, bb = model.cfg, model.backbone
    x = bb.stem(images)
    x = F.relu(group_norm(x, bb.stem_norm.weight, bb.stem_norm.bias,
                          num_groups=cfg.norm_groups))
    feats = []
    for blocks in bb.stages:
        for block in blocks:
            x = block(x, cfg.norm_groups)
        feats.append(x)  # strides 4, 8, 16, 32
    fpn = model.fpn
    laterals = [conv(f) for conv, f in zip(fpn.lateral, feats)]
    outs = [None] * len(laterals)
    prev = laterals[-1]
    outs[-1] = fpn.output[-1](prev)
    for i in range(len(laterals) - 2, -1, -1):
        prev = laterals[i] + upsample_nearest_2x(prev)
        outs[i] = fpn.output[i](prev)
    return outs + [outs[-1][:, ::2, ::2]]


# --------------------------------------------------------------------------
# anchors
# --------------------------------------------------------------------------


def generate_anchors(cfg: MaskRCNNConfig, image_hw: Tuple[int, int]
                     ) -> List[np.ndarray]:
    """-> per-level (h*w*A, 4) xyxy anchor arrays (numpy)."""
    h, w = image_hw
    out = []
    for size, stride in zip(cfg.anchor_sizes, cfg.strides):
        fh, fw = h // stride, w // stride
        base = []
        area = size * size
        for r in cfg.anchor_ratios:
            bw = math.sqrt(area / r)
            bh = bw * r
            base.append([-bw / 2, -bh / 2, bw / 2, bh / 2])
        base = np.asarray(base, np.float32)  # (A, 4)
        sx = (np.arange(fw, dtype=np.float32) + 0.5) * stride
        sy = (np.arange(fh, dtype=np.float32) + 0.5) * stride
        cx, cy = np.meshgrid(sx, sy)
        centers = np.stack([cx, cy, cx, cy], axis=-1)  # (fh, fw, 4)
        anchors = centers[:, :, None, :] + base[None, None, :, :]
        out.append(anchors.reshape(-1, 4))
    return out


@functools.lru_cache(maxsize=8)
def anchors_on(cfg: MaskRCNNConfig, image_hw: Tuple[int, int],
               device: str) -> torch.Tensor:
    """All levels' anchors as one (R, 4) tensor on `device` (made once per
    size and device)."""
    return torch.from_numpy(
        np.concatenate(generate_anchors(cfg, image_hw))).to(device)


# --------------------------------------------------------------------------
# RPN
# --------------------------------------------------------------------------


def apply_rpn_head(model: MaskRCNN, feats: Sequence[torch.Tensor]):
    """-> (objectness (B, R), deltas (B, R, 4)) concatenated over levels,
    R = sum over levels of h*w*A, in `generate_anchors` order."""
    rpn = model.rpn
    objs, deltas = [], []
    for f in feats:
        h = F.relu(rpn.conv(f))
        o = rpn.obj(h)  # (B, fh, fw, A)
        d = rpn.deltas(h)  # (B, fh, fw, 4A)
        b, fh, fw, a = o.shape
        objs.append(o.reshape(b, fh * fw * a))
        deltas.append(d.reshape(b, fh * fw * a, 4))
    return torch.cat(objs, dim=1), torch.cat(deltas, dim=1)


def rpn_proposals(cfg: MaskRCNNConfig, anchors: torch.Tensor,
                  objectness: torch.Tensor, deltas: torch.Tensor,
                  image_hw: Tuple[int, int]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (proposals (B, P, 4), valid (B, P)), P = rpn_post_nms_topk: per
    image the top-k objectness (ties in anchor order), decoded and clipped,
    then NMS; all images in one batched loop."""
    h, w = image_hw
    k = min(cfg.rpn_pre_nms_topk, objectness.shape[1])
    top, idx = box_ops.top_k(objectness, k)
    d = torch.gather(deltas, 1, idx[..., None].expand(-1, -1, 4))
    cand = box_ops.clip_boxes(
        box_ops.decode_boxes(d, anchors[idx], cfg.rpn_delta_weights),
        float(h), float(w))
    keep, valid = box_ops.nms_fixed(
        cand, top, iou_threshold=cfg.rpn_nms_threshold,
        max_out=cfg.rpn_post_nms_topk)
    return torch.gather(cand, 1, keep[..., None].expand(-1, -1, 4)), valid


# --------------------------------------------------------------------------
# ROI heads
# --------------------------------------------------------------------------


def roi_levels(rois: torch.Tensor) -> torch.Tensor:
    """The FPN level of each ROI (FPN paper eq. 1, canonical 224 at P4),
    0..3 for P2..P5."""
    areas = (rois[:, 3] - rois[:, 1]).clamp(min=0.0) * (
        rois[:, 4] - rois[:, 2]).clamp(min=0.0)
    lvl = torch.floor(4.0 + torch.log2(torch.sqrt(areas) / 224.0 + 1e-8))
    return lvl.clamp(2.0, 5.0).long() - 2


def multilevel_roi_align(feats: Sequence[torch.Tensor], rois: torch.Tensor,
                         cfg: MaskRCNNConfig, out_size: int
                         ) -> torch.Tensor:
    """rois (N, 5) [batch, x0, y0, x1, y1] in image coordinates -> (N, s,
    s, C), each ROI aligned on its own level of P2..P5 (the JAX package
    aligns on all four and selects with a one-hot: the same values)."""
    return roi_align_levels(
        feats[:4], roi_levels(rois), rois,
        [1.0 / s for s in cfg.strides[:4]], output_size=out_size)


def apply_box_head(head: _BoxHead, roi_feats: torch.Tensor):
    """(N, s, s, C) -> (cls_logits (N, K+1), deltas (N, 4))."""
    x = roi_feats.reshape(roi_feats.shape[0], -1)
    x = F.relu(head.fc1(x))
    x = F.relu(head.fc2(x))
    return head.cls(x), head.box(x)


def apply_mask_head(model: MaskRCNN, roi_feats: torch.Tensor
                    ) -> torch.Tensor:
    """(N, m, m, C) -> mask logits (N, 2m, 2m, num_classes)."""
    m = model.mask
    x = roi_feats
    for cp in m.convs:
        x = cp.conv(x)
        x = F.relu(group_norm(x, cp.norm.weight, cp.norm.bias,
                              num_groups=1))
    x = upsample_nearest_2x(x)
    x = F.relu(m.up(x))
    return m.logits(x)


def roi_forward(model: MaskRCNN, feats: Sequence[torch.Tensor],
                rois: torch.Tensor, stage: int = 0):
    """rois (N, 5) -> (cls_logits, box_deltas) of the cascade stage."""
    pooled = multilevel_roi_align(feats, rois, model.cfg,
                                  model.cfg.roi_size)
    return apply_box_head(model.box_heads[stage], pooled)


def mask_forward(model: MaskRCNN, feats: Sequence[torch.Tensor],
                 rois: torch.Tensor) -> torch.Tensor:
    pooled = multilevel_roi_align(feats, rois, model.cfg,
                                  model.cfg.mask_roi_size)
    return apply_mask_head(model, pooled)


def rois_with_batch(boxes: torch.Tensor) -> torch.Tensor:
    """(B, P, 4) -> (B*P, 5) [image index, x0, y0, x1, y1]."""
    b, p = boxes.shape[:2]
    idx = torch.arange(b, dtype=boxes.dtype, device=boxes.device)
    return torch.cat([idx.repeat_interleave(p)[:, None],
                      boxes.reshape(-1, 4)], dim=1)
