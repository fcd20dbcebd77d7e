"""The person detector's training step and inference on the card, under
`torch.profiler`: wall, device time, the device's busy share, kernel
launches and the costliest device ops, at full width (`MaskRCNNConfig()`,
512x512 letterboxed, batch 2) on a synthetic CIHP-like dataset that
`write_person_dataset` draws (photos of 1-3 people with instance-id PNGs;
the real CIHP images are not in the repository).

    python -m imagdressing_tpu_torch.tools.profile_detect [--size 512]
        [--batch 2] [--root DIR]

`chip_smoke.py`'s detect phase calls `write_person_dataset` and
`profile_train_step`.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Any, Dict, Tuple

import numpy as np
import torch

from imagdressing_tpu_torch.core.profiling import device_summary


def person_scene(h: int, w: int, people: int, seed: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """A synthetic photo of `people` standing figures (uint8 RGB (h, w, 3):
    graded backdrop, clothes, skin, sensor noise) and its instance-id map
    (uint8 (h, w), 0 background, ids 1..people, later figures in front)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.empty((h, w, 3))
    img[:] = rng.uniform(120, 230, 3) * (0.75 + 0.25 * (yy / h)[..., None])
    ids = np.zeros((h, w), np.uint8)
    for k in range(people):
        ph = rng.uniform(0.45, 0.9) * h
        pw = ph * rng.uniform(0.28, 0.4)
        cx = rng.uniform(pw / 2, w - pw / 2)
        top = rng.uniform(0, h - ph)
        skin, shirt, pants = (rng.uniform(lo, hi, 3) for lo, hi in
                              ((150, 230), (20, 200), (20, 120)))
        parts = [  # (cy, cx, ry, rx) in person units, colour
            ((0.09, 0.0, 0.08, 0.14), skin),  # head
            ((0.36, 0.0, 0.2, 0.42), shirt),  # torso
            ((0.38, -0.5, 0.18, 0.1), skin),  # arms
            ((0.38, 0.5, 0.18, 0.1), skin),
            ((0.74, -0.2, 0.25, 0.14), pants),  # legs
            ((0.74, 0.2, 0.25, 0.14), pants)]
        for (cy, dx, ry, rx), rgb in parts:
            inside = (((yy - (top + cy * ph)) / (ry * ph)) ** 2
                      + ((xx - (cx + dx * pw)) / (rx * pw)) ** 2) < 1
            img[inside] = rgb
            ids[inside] = k + 1
    img += rng.normal(0, 6, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8), ids


def write_person_dataset(root: str, n: int = 8, seed: int = 0
                         ) -> Tuple[str, str]:
    """n JPEG photos, 600x450 and 450x600 by turns, with 1-3 people each,
    and their instance-id PNGs -> (image dir, annotation dir)."""
    from imagdressing_tpu_torch.apps import image_utils as iu
    from imagdressing_tpu_torch.apps.png import encode_png

    img_dir, ann_dir = (os.path.join(root, d) for d in ("images", "ids"))
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(ann_dir, exist_ok=True)
    for i in range(n):
        h, w = (450, 600) if i % 2 else (600, 450)
        img, ids = person_scene(h, w, 1 + i % 3, seed + i)
        iu.write_image(os.path.join(img_dir, f"p{i:03d}.jpg"), img)
        with open(os.path.join(ann_dir, f"p{i:03d}.png"), "wb") as f:
            f.write(encode_png(ids))
    return img_dir, ann_dir


def profile_train_step(annotations: str, img_dir: str, *, size: int = 512,
                       batch: int = 2, warm: int = 2, seed: int = 0,
                       device: str = "cuda") -> Dict[str, Any]:
    """`warm` steps of `detect_cli train`'s step at full width, then one
    under the profiler -> `core.profiling.device_summary`'s dict with the losses."""
    from imagdressing_tpu_torch.detect import maskrcnn
    from imagdressing_tpu_torch.detect.data import CocoDetectionData
    from imagdressing_tpu_torch.detect.train import (
        ClipAdam,
        make_draws,
        make_train_step,
    )

    cfg = maskrcnn.MaskRCNNConfig()
    model = maskrcnn.init(seed, cfg, device)
    step = make_train_step(model, ClipAdam(list(model.parameters()), 1e-3))
    data = CocoDetectionData(annotations, img_dir, max_gt=cfg.max_gt,
                             image_size=size)
    host = next(data.batches(batch, rng=np.random.default_rng(seed)))
    b = {k: torch.from_numpy(v).to(device) for k, v in host.items()
         if k in ("image", "gt_boxes", "gt_valid", "gt_masks")}
    draws = [make_draws(cfg, batch, (size, size),
                        torch.Generator(device=device).manual_seed(i))
             for i in range(warm + 1)]
    for i in range(warm):
        step(b, draws[i])
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        m = step(b, draws[warm])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    out = device_summary(prof, wall)
    out["losses"] = {k: float(v) for k, v in m.items()}
    return out


def profile_infer(params: str, annotations: str, img_dir: str, *,
                  size: int = 512, device: str = "cuda") -> Dict[str, Any]:
    """One warm `detect_instances` on the first image, then one under the
    profiler -> `core.profiling.device_summary`'s dict."""
    from imagdressing_tpu_torch.apps.detect_cli import config, load_params
    from imagdressing_tpu_torch.detect.data import CocoDetectionData
    from imagdressing_tpu_torch.detect.infer import detect_instances

    model = load_params(params, config(False), device)
    data = CocoDetectionData(annotations, img_dir, image_size=size)
    image = torch.from_numpy(
        data.load_example(data.ids[0])["image"][None]).to(device)
    detect_instances(model, image)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        det = detect_instances(model, image)
        det["masks"].cpu()
        wall = (time.perf_counter() - t0) * 1e3
    return device_summary(prof, wall)


def main(argv=None) -> Dict[str, Any]:
    from imagdressing_tpu_torch.tools import coco_annotations

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--root", default=None,
                   help="where to write the dataset (default: a temporary "
                        "directory)")
    a = p.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="detect_profile_") as tmp:
        root = a.root or tmp
        img_dir, ann_dir = write_person_dataset(root)
        coco_annotations.main(["train", "--json_save_dir", root,
                               "--train_img_dir", img_dir,
                               "--train_anno_dir", ann_dir])
        out = profile_train_step(os.path.join(root, "CIHP_train.json"),
                                 img_dir, size=a.size, batch=a.batch)
    out["card"] = torch.cuda.get_device_name(0)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
