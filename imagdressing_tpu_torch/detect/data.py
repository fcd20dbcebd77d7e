"""COCO-style data for the person detector (port of `imagdressing_tpu/
detect/data.py`): reads the annotation json that `tools/coco_annotations.py`
writes and yields fixed-shape batches for `detect/train.py`: each image
letterboxed into one (S, S) square at the top left (aspect kept, so the box
mapping is a pure scale), boxes scaled, masks rasterised at the image's
resolution and resized with it, everything zero-padded to max_gt.

Images are read as RGB (PNG by the port's codec, other formats by PIL) and
resized as OpenCV's INTER_LINEAR on uint8 computes it; masks as its
INTER_NEAREST; polygons filled as `cv2.fillPoly` (`preprocess/imgproc.py`).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from imagdressing_tpu_torch.apps.image_utils import read_image
from imagdressing_tpu_torch.ops.resize import (
    cv2_resize_linear_u8,
    cv2_resize_nearest,
)
from imagdressing_tpu_torch.preprocess.imgproc import fill_poly


def rle_decode(rle: Dict[str, Any]) -> np.ndarray:
    """Uncompressed COCO RLE (column-major) -> (H, W) uint8."""
    h, w = rle["size"]
    flat = np.zeros(h * w, np.uint8)
    pos, val = 0, 0
    for run in rle["counts"]:
        if val:
            flat[pos:pos + run] = 1
        pos += run
        val ^= 1
    return flat.reshape((w, h)).T  # column-major


def polygons_to_mask(polys: List[List[float]], height: int,
                     width: int) -> np.ndarray:
    mask = np.zeros((height, width), np.uint8)
    pts = [np.asarray(p, np.float64).reshape(-1, 2).round().astype(np.int64)
           for p in polys if len(p) >= 6]
    if pts:
        fill_poly(mask, pts, 1)
    return mask


def annotation_mask(ann: Dict[str, Any], height: int,
                    width: int) -> np.ndarray:
    seg = ann["segmentation"]
    if isinstance(seg, dict):
        return rle_decode(seg)
    return polygons_to_mask(seg, height, width)


class CocoDetectionData:
    """Per-image access and a batch iterator over a COCO-style instance
    json."""

    def __init__(self, json_path: str, img_dir: str, *, max_gt: int = 16,
                 image_size: int = 512):
        with open(json_path) as f:
            coco = json.load(f)
        self.img_dir = img_dir
        self.max_gt = max_gt
        self.image_size = image_size
        self.images = {im["id"]: im for im in coco["images"]}
        self.anns_by_image: Dict[int, List[Dict[str, Any]]] = {
            i: [] for i in self.images}
        for ann in coco.get("annotations", []):
            if ann["image_id"] in self.anns_by_image:
                self.anns_by_image[ann["image_id"]].append(ann)
        self.ids = sorted(self.images)

    def __len__(self) -> int:
        return len(self.ids)

    def load_example(self, image_id: int) -> Dict[str, np.ndarray]:
        info = self.images[image_id]
        path = os.path.join(self.img_dir, info["file_name"])
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        rgb = read_image(path)
        h0, w0 = rgb.shape[:2]
        s = self.image_size
        # aspect-preserving letterbox at the top left
        scale = min(s / w0, s / h0)
        rw, rh = max(1, int(round(w0 * scale))), max(1, int(round(h0 * scale)))
        image = np.zeros((s, s, 3), np.float32)
        image[:rh, :rw] = cv2_resize_linear_u8(rgb, rw, rh).astype(
            np.float32) / 255.0

        g = self.max_gt
        boxes = np.zeros((g, 4), np.float32)
        valid = np.zeros((g,), bool)
        masks = np.zeros((g, s, s), np.float32)
        for k, ann in enumerate(self.anns_by_image[image_id][:g]):
            x, y, bw, bh = ann["bbox"]
            boxes[k] = np.array([x, y, x + bw, y + bh]) * scale
            valid[k] = True
            m = annotation_mask(ann, h0, w0)
            masks[k, :rh, :rw] = cv2_resize_nearest(m.astype(np.float32),
                                                    rw, rh)
        return {"image": image, "gt_boxes": boxes, "gt_valid": valid,
                "gt_masks": masks, "image_id": np.int32(image_id),
                "scale": np.float32(scale)}

    def batches(self, batch_size: int, *,
                rng: Optional[np.random.Generator] = None,
                epochs: Optional[int] = None, rank: int = 0, ranks: int = 1
                ) -> Iterator[Dict[str, np.ndarray]]:
        """Yields stacked batch dicts of `batch_size` images, shuffled per
        epoch when rng is given; the trailing partial batch is wrapped
        around (static shapes). With `ranks` > 1, this data rank's rows of
        each global batch (`batch_size` divisible by `ranks`; every rank
        passes an rng in the same state)."""
        if not self.ids:
            raise ValueError(
                "empty dataset: the annotation json lists no usable images")
        if batch_size % ranks:
            raise ValueError(f"batch {batch_size} does not split over "
                             f"{ranks} ranks")
        per = batch_size // ranks
        epoch = 0
        while epochs is None or epoch < epochs:
            order = list(self.ids)
            if rng is not None:
                rng.shuffle(order)
            for i in range(0, len(order), batch_size):
                chunk = order[i:i + batch_size]
                while len(chunk) < batch_size:  # wrap to keep shapes static
                    chunk.append(order[(i + len(chunk)) % len(order)])
                exs = [self.load_example(j)
                       for j in chunk[rank * per:(rank + 1) * per]]
                yield {k: np.stack([e[k] for e in exs]) for k in exs[0]}
            epoch += 1
