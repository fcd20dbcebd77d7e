"""Host-side image preparation of the training data (port of
`imagdressing_tpu/train/data.py`, so far its CLIP view of a garment, which
the apps share).

The JAX package resizes with PIL; the port resizes with
`F.interpolate(..., antialias=True)` on a uint8 CPU tensor in channels-last
memory (`resize`), whose bilinear and bicubic (a = -0.5) kernels with
support scaling are PIL's and which rounds to uint8 after each separable
pass as PIL does: within 1 level of PIL at the apps' sizes
(`tests/test_torch_apps.py`).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from imagdressing_tpu_torch.models.clip import CLIP_IMAGE_MEAN, CLIP_IMAGE_STD


def resize(img: np.ndarray, size: Tuple[int, int],
           mode: str = "bilinear") -> np.ndarray:
    """uint8 (H, W, C) -> uint8 (h, w, C) for size (w, h) (PIL's order),
    mode "bilinear" or "bicubic", antialiased when shrinking (PIL's
    `Image.resize` with BILINEAR / BICUBIC)."""
    w, h = size
    if img.dtype != np.uint8 or img.ndim != 3:
        raise ValueError(f"resize: expected uint8 (H, W, C), got {img.dtype} "
                         f"{img.shape}")
    x = torch.from_numpy(np.require(img, requirements=["C", "W"]))
    x = x.permute(2, 0, 1)[None]
    x = x.contiguous(memory_format=torch.channels_last)
    y = F.interpolate(x, size=(h, w), mode=mode, align_corners=False,
                      antialias=True)
    return y[0].permute(1, 2, 0).contiguous().numpy()


def clip_preprocess_np(img: np.ndarray, size: int = 224) -> np.ndarray:
    """CLIPImageProcessor equivalent: shortest-side bicubic resize to
    `size`, center crop, rescale, normalize. img: (H,W,3) uint8 ->
    (size,size,3) f32."""
    h, w = img.shape[:2]
    if h < w:
        nh, nw = size, max(size, round(w * size / h))
    else:
        nh, nw = max(size, round(h * size / w)), size
    x = resize(img, (nw, nh), "bicubic")
    top = (x.shape[0] - size) // 2
    left = (x.shape[1] - size) // 2
    x = x[top:top + size, left:left + size].astype(np.float32) / 255.0
    return (x - np.asarray(CLIP_IMAGE_MEAN, np.float32)) / np.asarray(
        CLIP_IMAGE_STD, np.float32)
