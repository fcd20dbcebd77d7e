"""The CPM hand-pose network and the hand-box geometry. Port of
`imagdressing_tpu/preprocess/openpose/hand.py`.

HandPoseNet: a VGG trunk (conv1_1 .. conv5_3_CPM, three max pools, stride
8, 128-channel features F), stage 1 (1x1 512 -> 1x1 22 heatmaps), stages
2-6 over concat(heatmap, F) (150 channels) with 7x7 convs.

`Hand.__call__`: OpenCV's 8-bit Gaussian pre-blur (sigma 0.8), four scales
of 368 (OpenCV's cubic resize, a stride-8 pad with 128), the net and JAX's
bicubic resize of the heatmaps to 128 x 128 on the device; the average of
the scales, and per part the largest-sum connected component's peak, on the
host, as the JAX package computes them.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from scipy.ndimage import gaussian_filter
from scipy.ndimage import label as cc_label

from imagdressing_tpu_torch.ops.resize import cv2_resize_cubic, jax_resize
from imagdressing_tpu_torch.pipelines.dressing import resolve_device
from imagdressing_tpu_torch.preprocess.imgproc import gaussian_blur_u8
from imagdressing_tpu_torch.preprocess.openpose.model import (
    CPMNet,
    Device,
    Layer,
)

TRUNK: List[Layer] = [
    ("conv1_1", 3, 64, 3), ("conv1_2", 64, 64, 3), ("pool", 0, 0, 0),
    ("conv2_1", 64, 128, 3), ("conv2_2", 128, 128, 3), ("pool", 0, 0, 0),
    ("conv3_1", 128, 256, 3), ("conv3_2", 256, 256, 3),
    ("conv3_3", 256, 256, 3), ("conv3_4", 256, 256, 3), ("pool", 0, 0, 0),
    ("conv4_1", 256, 512, 3), ("conv4_2", 512, 512, 3),
    ("conv4_3", 512, 512, 3), ("conv4_4", 512, 512, 3),
    ("conv5_1", 512, 512, 3), ("conv5_2", 512, 512, 3),
    ("conv5_3_CPM", 512, 128, 3),
]
HAND_CH = 22


def stage1(out: int) -> List[Layer]:
    return [("conv6_1_CPM", 128, 512, 1), ("conv6_2_CPM", 512, out, 1)]


def stageN(i: int, out: int) -> List[Layer]:
    cin = 128 + out
    return [
        (f"Mconv1_stage{i}", cin, 128, 7), (f"Mconv2_stage{i}", 128, 128, 7),
        (f"Mconv3_stage{i}", 128, 128, 7), (f"Mconv4_stage{i}", 128, 128, 7),
        (f"Mconv5_stage{i}", 128, 128, 7), (f"Mconv6_stage{i}", 128, 128, 1),
        (f"Mconv7_stage{i}", 128, out, 1),
    ]


class HandPoseNet(CPMNet):
    """image (B, H, W, 3) normalized (x / 256 - 0.5) BGR -> heatmaps
    (B, H/8, W/8, out); `out` 22 for the hand, 71 for the face net (the
    same trunk)."""

    OUT = HAND_CH

    def __init__(self):
        super().__init__([TRUNK, stage1(self.OUT)]
                         + [stageN(i, self.OUT) for i in range(2, 7)])

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        feat = self.run(TRUNK, image, final_relu_skip=False)
        heat = self.run(stage1(self.OUT), feat, final_relu_skip=True)
        for i in range(2, 7):
            x = torch.cat([heat, feat], -1)
            heat = self.run(stageN(i, self.OUT), x, final_relu_skip=True)
        return heat


def detect_hand_boxes(keypoints: np.ndarray, image_height: int,
                      image_width: int) -> List[Tuple[int, int, int, bool]]:
    """[(x, y, width, is_left)] square crops from the (18, 2) body
    keypoints ([0, 0] = missing), the reference's handDetect geometry."""
    out = []
    for (si, ei, wi), is_left in (((5, 6, 7), True), ((2, 3, 4), False)):
        pts = keypoints[[si, ei, wi]]
        if np.any(np.all(pts <= 1.0, axis=1)):
            continue
        (x1, y1), (x2, y2), (x3, y3) = pts
        x = x3 + 0.33 * (x3 - x2)
        y = y3 + 0.33 * (y3 - y2)
        d_we = float(np.hypot(x3 - x2, y3 - y2))
        d_es = float(np.hypot(x2 - x1, y2 - y1))
        width = 1.5 * max(d_we, 0.9 * d_es)
        x -= width / 2
        y -= width / 2
        x, y = max(x, 0.0), max(y, 0.0)
        width = min(width, image_width - x, image_height - y)
        if width >= 20:
            out.append((int(x), int(y), int(width), is_left))
    return out


class Hand:
    """21-keypoint hand estimator with the reference's output contract.
    Runs on "cuda" unless the caller passes device="cpu"."""

    def __init__(self, net: HandPoseNet, device: Device = "cuda", *,
                 boxsize: int = 368, stride: int = 8, pad_value: int = 128,
                 thre: float = 0.05):
        self.device = resolve_device(device)
        self.net = net.to(self.device).eval().requires_grad_(False)
        self.boxsize = boxsize
        self.stride = stride
        self.pad_value = pad_value
        self.thre = thre

    @classmethod
    def from_torch(cls, path: str, device: Device = "cuda") -> "Hand":
        """`hand_pose_model.pth` (tensors only)."""
        sd = torch.load(path, map_location="cpu", weights_only=True)
        return cls(HandPoseNet.from_state_dict(sd, device), device)

    @torch.no_grad()
    def heatmaps(self, crop: torch.Tensor, side: int, size: int
                 ) -> np.ndarray:
        """uint8 BGR (H, W, 3) on the device -> the net's heatmaps at one
        scale, resized to (size, size, 22), float32 on the host."""
        resized = cv2_resize_cubic(crop, side, side)
        ph = (self.stride - side % self.stride) % self.stride
        padded = F.pad(resized, (0, 0, 0, ph, 0, ph), value=self.pad_value)
        norm = padded.float() / 256.0 - 0.5
        heat = jax_resize(self.net(norm[None]), size, size)[0]
        return heat.cpu().numpy()

    def __call__(self, crop_bgr: np.ndarray,
                 scales=(0.5, 1.0, 1.5, 2.0)) -> np.ndarray:
        """crop (H, W, 3) uint8 BGR -> (21, 2) [x, y] peaks in crop pixels
        ([0, 0] where a part is missing)."""
        hr, wr = crop_bgr.shape[:2]
        wsize = 128
        blur = torch.from_numpy(gaussian_blur_u8(crop_bgr, 0.8)).to(
            self.device)
        heat_avg = np.zeros((wsize, wsize, HAND_CH), np.float64)
        for s in scales:
            side = max(8, int(round(s * self.boxsize)))
            heat_avg += self.heatmaps(blur, side, wsize) / len(scales)

        peaks = np.zeros((21, 2), np.int64)
        for part in range(21):
            raw = heat_avg[:, :, part]
            smooth = gaussian_filter(raw, sigma=3)
            binary = smooth > self.thre
            if not binary.any():
                continue
            labels, n = cc_label(binary)
            sums = [raw[labels == i].sum() for i in range(1, n + 1)]
            best = int(np.argmax(sums)) + 1
            masked = np.where(labels == best, raw, 0.0)
            yy, xx = np.unravel_index(np.argmax(masked), masked.shape)
            peaks[part] = [int(xx * wr / wsize), int(yy * hr / wsize)]
        return peaks
