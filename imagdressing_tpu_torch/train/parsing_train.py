"""The SCHP human-parser fine-tune in PyTorch (port of
`imagdressing_tpu/train/parsing_train.py`; the reference's parsing training
stack: AugmentCE2P + InPlaceABNSync + the CE / Lovász criteria, SGD with a
poly learning rate):

  * the forward in train mode (`preprocess.parsing.model.BNTrainCtx`):
    batch statistics per ABN through `abn_train_stats`, one K7 launch each
    for the apply, the inverse-recompute backward;
  * the loss: `parsing_losses.schp_criterion` on the logits' 1/4
    resolution, the labels downsampled to it at JAX's half-pixel nearest
    indices;
  * SGD with momentum, weight decay added to the gradient before the
    momentum trace, the step's poly learning rate applied last (optax's
    add_decayed_weights -> trace -> scale chain); the running statistics are
    buffers, updated by an EMA of the batch mean and biased variance
    (momentum 0.1), never by the optimizer.

`ParsingDataset` reads LIP/ATR-style folders without OpenCV: images in BGR
(PIL's decode) resized by `ops.resize.cv2_resize_linear_u8`, labels read as
`cv2.IMREAD_GRAYSCALE` reads them and resized by `cv2_resize_nearest`.
`shard_parsing_train_step` runs the step over a data group (the JAX
package's shard_map step): each rank its rows, the statistics and the
loss's normalisation synced, the gradients averaged.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from imagdressing_tpu_torch.apps.image_utils import read_image
from imagdressing_tpu_torch.core import mesh as mesh_lib
from imagdressing_tpu_torch.ops.resize import (
    cv2_resize_linear_u8,
    cv2_resize_nearest,
)
from imagdressing_tpu_torch.pipelines.dressing import resize_nearest
from imagdressing_tpu_torch.preprocess.parsing import model as schp
from imagdressing_tpu_torch.train import parsing_losses


@dataclasses.dataclass(frozen=True)
class ParsingTrainConfig:
    num_classes: int = schp.NUM_CLASSES_ATR
    learning_rate: float = 7e-3  # SCHP recipe
    momentum: float = 0.9
    weight_decay: float = 5e-4
    total_steps: int = 10000
    poly_power: float = 0.9
    bn_momentum: float = 0.1  # running-statistics EMA
    lovasz_weight: float = 1.0
    edge_weight: float = 1.0


def lr_schedule(cfg: ParsingTrainConfig) -> Callable[[int], float]:
    """SCHP's poly decay, optax's `polynomial_schedule(lr, 0, power,
    total_steps)` in its float32 arithmetic: lr * (1 - min(step, total) /
    total) ** power, evaluated at the caller's step index (so a run
    restarted from its parameters resumes the decay where it was)."""
    f32 = np.float32

    def schedule(step_idx: int) -> float:
        count = min(max(int(step_idx), 0), cfg.total_steps)
        frac = f32(1) - f32(count) / f32(cfg.total_steps)
        return float(f32(cfg.learning_rate) * frac ** f32(cfg.poly_power))

    return schedule


def make_optimizer(cfg: ParsingTrainConfig, net: torch.nn.Module
                   ) -> torch.optim.SGD:
    """SGD over the net's parameters (the running statistics are buffers):
    d = g + wd * p; buf = momentum * buf + d; p -= lr * buf, which is the
    JAX package's optax chain at the step's lr. The lr is set per step by
    `make_parsing_train_step`."""
    return torch.optim.SGD(net.parameters(), lr=cfg.learning_rate,
                           momentum=cfg.momentum, dampening=0.0,
                           weight_decay=cfg.weight_decay)


def _downsample_labels(labels: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, H, W) integer labels -> (B, h, w) as `jax.image.resize(...,
    "nearest")`: half-pixel centres, not `F.interpolate`'s indices."""
    return resize_nearest(labels[..., None], h, w)[..., 0]


@torch.no_grad()
def _update_running_stats(collected: Sequence, momentum: float) -> None:
    """The running-statistics EMA from the (ABN module, mean, var) of the
    forward: (1 - momentum) * running + momentum * batch, with the batch's
    biased variance (nn.BatchNorm keeps an unbiased one: another
    result)."""
    for module, mean, var in collected:
        module.running_mean.copy_((1 - momentum) * module.running_mean
                                  + momentum * mean)
        module.running_var.copy_((1 - momentum) * module.running_var
                                 + momentum * var)


def make_parsing_train_step(cfg: ParsingTrainConfig, net: schp.SCHP,
                            optimizer: torch.optim.Optimizer, group=None):
    """-> step(step_idx, batch) -> {"loss", "lr"}: one forward in train
    mode, the loss, the backward, the optimizer step at the step's lr, the
    running-statistics EMA. batch: {"image": (B, H, W, 3) normalized
    float32, "label" and "edge": (B, H, W) integers}, tensors on the net's
    device. The net's parameters must require gradients. With a process
    `group` (`shard_parsing_train_step`) the batch is this rank's rows."""
    schedule = lr_schedule(cfg)
    # the ABNs' weight and bias gradients come out of their synced backward
    # already summed over the group
    synced = {id(p) for m in net.modules() if isinstance(m, schp.ABN)
              for p in (m.weight, m.bias)}

    def step(step_idx: int, batch: Dict[str, torch.Tensor]
             ) -> Dict[str, torch.Tensor]:
        ctx = schp.BNTrainCtx(group=group)
        fusion, edge = net(batch["image"], ctx)
        lh, lw = fusion.shape[1:3]
        loss = parsing_losses.schp_criterion(
            fusion, edge, _downsample_labels(batch["label"], lh, lw),
            _downsample_labels(batch["edge"], lh, lw),
            lovasz_weight=cfg.lovasz_weight, edge_weight=cfg.edge_weight,
            group=group)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if group is not None:
            # the gradient of the group's mean loss: each rank's own
            # gradients averaged, the synced sums divided by the group size
            with torch.no_grad():
                own = [p.grad for p in net.parameters()
                       if p.grad is not None and id(p) not in synced]
                flat = mesh_lib.pmean(
                    torch.cat([g.reshape(-1) for g in own]), group)
                torch._foreach_copy_(own, [
                    x.view_as(g) for x, g in zip(
                        flat.split([g.numel() for g in own]), own)])
                torch._foreach_div_(
                    [p.grad for p in net.parameters()
                     if p.grad is not None and id(p) in synced],
                    mesh_lib.group_size(group))
            loss = mesh_lib.pmean(loss.detach(), group)
        lr = schedule(step_idx)
        for param_group in optimizer.param_groups:
            param_group["lr"] = lr
        optimizer.step()
        _update_running_stats(ctx.stats, cfg.bn_momentum)
        return {"loss": loss.detach(), "lr": lr}

    return step


def shard_parsing_train_step(cfg: ParsingTrainConfig, net: schp.SCHP,
                             optimizer: torch.optim.Optimizer,
                             mesh: mesh_lib.Mesh):
    """The step over the mesh's data group (the JAX package's
    `shard_parsing_train_step`): the parameters replicated (every rank
    starts from the same weights), the batch split by rank, the ABNs'
    statistics synced through `abn_train(group=...)`, the cross-entropy
    normalised over the group's pixels, the gradients all-reduced as a
    mean (the ABNs' weight and bias gradients, which their synced backward
    sums over the group, divided by its size), the loss averaged. ->
    step(step_idx, this rank's rows)."""
    return make_parsing_train_step(cfg, net, optimizer,
                                   group=mesh.data_group)


def edges_from_labels(labels: np.ndarray) -> np.ndarray:
    """A binary boundary map of a label map: 1 where a pixel differs from
    its upper or left neighbour."""
    lab = np.asarray(labels)
    edge = np.zeros_like(lab, dtype=np.int32)
    edge[..., 1:, :] |= lab[..., 1:, :] != lab[..., :-1, :]
    edge[..., :, 1:] |= lab[..., :, 1:] != lab[..., :, :-1]
    return edge


def read_label(path: str) -> np.ndarray:
    """A label PNG as `cv2.imread(path, cv2.IMREAD_GRAYSCALE)` reads it: a
    gray file's values as they are; a palette or RGB file expanded to RGB
    and taken to gray by libpng's truncating fixed-point weights (9797,
    19234, 3737) / 2^15, as OpenCV's PNG decoder asks libpng to."""
    rgb = read_image(path).astype(np.int64)
    return ((rgb[..., 0] * 9797 + rgb[..., 1] * 19234 + rgb[..., 2] * 3737)
            >> 15).astype(np.uint8)


class ParsingDataset:
    """LIP/ATR-style folders: images/<id>.jpg and labels/<id>.png (class
    ids). Each sample is resized to (h, w), normalized with SCHP's BGR
    mean and std, and given the label's edge map."""

    MEAN = np.array([0.406, 0.456, 0.485], np.float32)  # BGR order
    STD = np.array([0.225, 0.224, 0.229], np.float32)
    IMAGE_EXTS = (".jpg", ".png", ".jpeg", ".JPG", ".PNG", ".JPEG")

    def __init__(self, image_dir: str, label_dir: str, *, h: int = 473,
                 w: int = 473):
        self.image_dir, self.label_dir = image_dir, label_dir
        self.h, self.w = h, w
        self.ids = sorted(os.path.splitext(f)[0] for f in os.listdir(
            image_dir))

    def __len__(self) -> int:
        return len(self.ids)

    def get(self, idx: int) -> Dict[str, np.ndarray]:
        sid = self.ids[idx % len(self.ids)]
        for ext in self.IMAGE_EXTS:
            path = os.path.join(self.image_dir, sid + ext)
            if os.path.exists(path):
                break
        else:
            raise FileNotFoundError(
                f"no readable image for id {sid!r} under {self.image_dir}")
        img = np.ascontiguousarray(read_image(path)[..., ::-1])  # BGR
        lab_path = os.path.join(self.label_dir, sid + ".png")
        if not os.path.exists(lab_path):
            raise FileNotFoundError(f"missing label {lab_path}")
        lab = read_label(lab_path)
        img = cv2_resize_linear_u8(img, self.w, self.h)
        lab = cv2_resize_nearest(lab, self.w, self.h)
        img_norm = (img.astype(np.float32) / 255.0 - self.MEAN) / self.STD
        return {"image": img_norm.astype(np.float32),
                "label": lab.astype(np.int32),
                "edge": edges_from_labels(lab)}

    def batch(self, idxs: List[int]) -> Dict[str, np.ndarray]:
        samples = [self.get(i) for i in idxs]
        return {k: np.stack([s[k] for s in samples]) for k in samples[0]}
