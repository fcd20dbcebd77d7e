"""The CPM face-landmark network (OpenPose FaceNet, 70 landmarks). Port of
`imagdressing_tpu/preprocess/openpose/face.py`.

FaceNet: the hand net's trunk with 71-channel heatmaps; stages 2-6 over
concat(heatmap 71, features 128) = 199 channels. `Face.__call__`: OpenCV's
cubic resize of the crop to `inference_size`, one forward and JAX's bicubic
resize back to that size on the device; per part the Gaussian-smoothed
thresholded argmax on the host, scaled back to the crop.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.ndimage import gaussian_filter

from imagdressing_tpu_torch.ops.resize import cv2_resize_cubic, jax_resize
from imagdressing_tpu_torch.pipelines.dressing import resolve_device
from imagdressing_tpu_torch.preprocess.openpose.hand import HandPoseNet
from imagdressing_tpu_torch.preprocess.openpose.model import Device

FACE_CH = 71


class FaceNet(HandPoseNet):
    """image (B, H, W, 3) normalized -> heatmaps (B, H/8, W/8, 71)."""

    OUT = FACE_CH


class Face:
    """70-landmark face estimator (the reference's Face.__call__ contract).
    Runs on "cuda" unless the caller passes device="cpu"."""

    def __init__(self, net: FaceNet, device: Device = "cuda", *,
                 inference_size: int = 384, sigma: float = 2.5,
                 threshold: float = 0.1):
        self.device = resolve_device(device)
        self.net = net.to(self.device).eval().requires_grad_(False)
        self.inference_size = inference_size
        self.sigma = sigma
        self.threshold = threshold

    @classmethod
    def from_torch(cls, path: str, device: Device = "cuda") -> "Face":
        """`facenet.pth` (tensors only)."""
        sd = torch.load(path, map_location="cpu", weights_only=True)
        return cls(FaceNet.from_state_dict(sd), device)

    @torch.no_grad()
    def heatmaps(self, face_bgr: np.ndarray) -> np.ndarray:
        """uint8 BGR crop -> (s, s, 71) float32 heatmaps on the host."""
        s = self.inference_size
        crop = torch.from_numpy(np.ascontiguousarray(face_bgr)).to(
            self.device)
        norm = cv2_resize_cubic(crop, s, s).float() / 256.0 - 0.5
        return jax_resize(self.net(norm[None]), s, s)[0].cpu().numpy()

    def __call__(self, face_bgr: np.ndarray) -> np.ndarray:
        """crop (H, W, 3) uint8 BGR -> (70, 2) [x, y] peaks ([0, 0]
        missing)."""
        hr, wr = face_bgr.shape[:2]
        s = self.inference_size
        heat = self.heatmaps(face_bgr)
        peaks = np.zeros((70, 2), np.int64)
        for part in range(70):
            smooth = gaussian_filter(heat[:, :, part], sigma=self.sigma)
            if smooth.max() <= self.threshold:
                continue
            yy, xx = np.unravel_index(np.argmax(smooth), smooth.shape)
            peaks[part] = [int(xx * wr / s), int(yy * hr / s)]
        return peaks
