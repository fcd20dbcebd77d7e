"""COCO-style annotation creators for human-instance masks (port of
`imagdressing_tpu/tools/coco_annotations.py`; the reference's
mhp_extension coco_style_annotation_creator/{human_to_coco.py,
pycococreatortools.py, test_human2coco_format.py} and global_local_parsing/
make_id_list.py) without skimage, pycocotools or OpenCV: RLE, area and
bbox in numpy; polygons from `preprocess/imgproc.py`'s outer-contour trace
(`cv2.findContours(RETR_EXTERNAL, CHAIN_APPROX_SIMPLE)`, vertex for vertex)
and its `approx_poly_dp` (OpenCV 5's `approxPolyDP`).

As in the JAX tool, instances are the actual label values of the instance-id
PNG (the reference indexes them by position in np.unique, which breaks on
sparse ids).

CLI:
  python -m imagdressing_tpu_torch.tools.coco_annotations train \
      --dataset CIHP --train_img_dir ... --train_anno_dir ... \
      --json_save_dir out/ [--use_val --val_img_dir ... --val_anno_dir ...]
  python -m imagdressing_tpu_torch.tools.coco_annotations test \
      --dataset CIHP --test_img_dir ... --json_save_dir out/
  python -m imagdressing_tpu_torch.tools.coco_annotations idlist \
      --img_dir ... --out_file id.txt
"""

from __future__ import annotations

import datetime
import json
import os
from typing import Any, Dict, List, Optional

import numpy as np

from imagdressing_tpu_torch.preprocess.imgproc import (
    approx_poly_dp,
    find_contours_external,
)


def binary_mask_to_rle(binary_mask: np.ndarray) -> Dict[str, Any]:
    """Uncompressed COCO RLE: column-major run lengths, leading 0-run."""
    flat = np.asarray(binary_mask, np.uint8).ravel(order="F")
    counts: List[int] = []
    if flat.size == 0:
        return {"counts": counts, "size": list(binary_mask.shape)}
    change = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    runs = np.diff(np.concatenate([[0], change, [flat.size]]))
    if flat[0] == 1:  # RLE starts with the count of leading zeros
        counts.append(0)
    counts.extend(int(r) for r in runs)
    return {"counts": counts, "size": list(binary_mask.shape)}


def mask_area(binary_mask: np.ndarray) -> int:
    return int(np.count_nonzero(binary_mask))


def mask_bbox(binary_mask: np.ndarray) -> List[float]:
    """[x, y, w, h] in pixel counts (pycocotools.mask.toBbox semantics)."""
    ys, xs = np.nonzero(binary_mask)
    if ys.size == 0:
        return [0.0, 0.0, 0.0, 0.0]
    x0, x1 = float(xs.min()), float(xs.max())
    y0, y1 = float(ys.min()), float(ys.max())
    return [x0, y0, x1 - x0 + 1.0, y1 - y0 + 1.0]


def binary_mask_to_polygon(
    binary_mask: np.ndarray, tolerance: float = 0
) -> List[List[float]]:
    """COCO polygon list [[x0,y0,x1,y1,...], ...]; tolerance = max deviation
    of the simplified chain (the reference passes tolerance=10)."""
    polygons = []
    for c in find_contours_external(binary_mask):
        if tolerance > 0:
            approx = approx_poly_dp(c, tolerance)
            # keep the raw contour when simplification degenerates a small
            # instance below a valid polygon (the reference drops it)
            if len(approx) >= 3:
                c = approx
        if len(c) < 3:
            continue
        polygons.append([float(v) for v in c.reshape(-1)])
    return polygons


def create_image_info(
    image_id: int,
    file_name: str,
    image_size,  # (width, height) — PIL Image.size order
    date_captured: Optional[str] = None,
    license_id: int = 1,
) -> Dict[str, Any]:
    return {
        "id": image_id,
        "file_name": file_name,
        "width": image_size[0],
        "height": image_size[1],
        "date_captured": date_captured
        or datetime.datetime.now(datetime.timezone.utc).isoformat(" "),
        "license": license_id,
        "coco_url": "",
        "flickr_url": "",
    }


def create_annotation_info(
    annotation_id: int,
    image_id: int,
    category_info: Dict[str, Any],
    binary_mask: np.ndarray,
    image_size=None,  # (width, height)
    tolerance: float = 2,
    bounding_box=None,
) -> Optional[Dict[str, Any]]:
    if image_size is not None and binary_mask.shape[:2] != (
        image_size[1], image_size[0]
    ):
        from PIL import Image

        binary_mask = np.asarray(
            Image.fromarray(binary_mask.astype(np.uint8) * 255).resize(
                image_size, Image.NEAREST
            )
        ) > 0

    area = mask_area(binary_mask)
    if area < 1:
        return None
    if bounding_box is None:
        bounding_box = mask_bbox(binary_mask)

    if category_info.get("is_crowd"):
        is_crowd = 1
        segmentation: Any = binary_mask_to_rle(binary_mask)
    else:
        is_crowd = 0
        segmentation = binary_mask_to_polygon(binary_mask, tolerance)
        if not segmentation:
            return None

    return {
        "id": annotation_id,
        "image_id": image_id,
        "category_id": category_info["id"],
        "iscrowd": is_crowd,
        "area": area,
        "bbox": list(bounding_box),
        "segmentation": segmentation,
        "width": binary_mask.shape[1],
        "height": binary_mask.shape[0],
    }


def _coco_header(name: str) -> Dict[str, Any]:
    return {
        "info": {
            "description": f"{name} Dataset",
            "url": "",
            "version": "",
            "year": datetime.datetime.now(datetime.timezone.utc).year,
            "contributor": "",
            "date_created": datetime.datetime.now(datetime.timezone.utc).isoformat(" "),
        },
        "licenses": [{"id": 1, "name": "", "url": ""}],
        "categories": [
            {"id": 1, "name": "person", "supercategory": "person"}
        ],
        "images": [],
        "annotations": [],
    }


def add_split(
    coco: Dict[str, Any],
    img_dir: str,
    anno_dir: str,
    *,
    image_id: int = 1,
    segmentation_id: int = 1,
    tolerance: float = 10,
):
    """Append every image + per-instance person annotation from a
    Human_ids-style split (one instance-id PNG per image). Returns the next
    (image_id, segmentation_id)."""
    from PIL import Image

    for image_name in sorted(os.listdir(img_dir)):
        with Image.open(os.path.join(img_dir, image_name)) as im:
            size = im.size
        coco["images"].append(create_image_info(image_id, image_name, size))

        mask_name = os.path.splitext(image_name)[0] + ".png"
        human_mask = np.asarray(Image.open(os.path.join(anno_dir, mask_name)))
        for lab in np.unique(human_mask):
            if lab == 0:  # background
                continue
            info = create_annotation_info(
                segmentation_id, image_id, {"id": 1, "is_crowd": 0},
                human_mask == lab, size, tolerance=tolerance,
            )
            if info is not None:
                coco["annotations"].append(info)
            segmentation_id += 1
        image_id += 1
    return image_id, segmentation_id


def images_only_coco(name: str, img_dir: str) -> Dict[str, Any]:
    """test_human2coco_format.py: image records without annotations."""
    from PIL import Image

    coco = _coco_header(name)
    for image_id, image_name in enumerate(sorted(os.listdir(img_dir)), 1):
        with Image.open(os.path.join(img_dir, image_name)) as im:
            size = im.size
        coco["images"].append(create_image_info(image_id, image_name, size))
    return coco


def make_id_list(img_dir: str, out_file: str):
    """global_local_parsing/make_id_list.py: one basename-sans-ext per line."""
    ids = sorted(os.path.splitext(f)[0] for f in os.listdir(img_dir))
    with open(out_file, "w") as f:
        f.write("\n".join(ids) + ("\n" if ids else ""))
    return ids


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="COCO-style annotation creator")
    sub = p.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("train", help="human_to_coco.py equivalent")
    t.add_argument("--dataset", default="CIHP")
    t.add_argument("--json_save_dir", required=True)
    t.add_argument("--use_val", action="store_true")
    t.add_argument("--train_img_dir", required=True)
    t.add_argument("--train_anno_dir", required=True)
    t.add_argument("--val_img_dir")
    t.add_argument("--val_anno_dir")
    t.add_argument("--tolerance", type=float, default=10)

    s = sub.add_parser("test", help="test_human2coco_format.py equivalent")
    s.add_argument("--dataset", default="CIHP")
    s.add_argument("--json_save_dir", required=True)
    s.add_argument("--test_img_dir", required=True)

    i = sub.add_parser("idlist", help="make_id_list.py equivalent")
    i.add_argument("--img_dir", required=True)
    i.add_argument("--out_file", required=True)

    args = p.parse_args(argv)
    if args.cmd == "idlist":
        make_id_list(args.img_dir, args.out_file)
        return

    os.makedirs(args.json_save_dir, exist_ok=True)
    if args.cmd == "test":
        coco = images_only_coco(args.dataset, args.test_img_dir)
        out = os.path.join(args.json_save_dir, f"{args.dataset}.json")
        with open(out, "w") as f:
            json.dump(coco, f)
        print("wrote", out)
        return

    if args.use_val and not (args.val_img_dir and args.val_anno_dir):
        p.error("--use_val requires --val_img_dir and --val_anno_dir")
    coco = _coco_header(args.dataset)
    img_id, seg_id = add_split(
        coco, args.train_img_dir, args.train_anno_dir,
        tolerance=args.tolerance,
    )
    if args.use_val:
        add_split(
            coco, args.val_img_dir, args.val_anno_dir,
            image_id=img_id, segmentation_id=seg_id,
            tolerance=args.tolerance,
        )
        train_name = f"{args.dataset}_trainval.json"
    else:
        train_name = f"{args.dataset}_train.json"
    with open(os.path.join(args.json_save_dir, train_name), "w") as f:
        json.dump(coco, f)
    print("wrote", os.path.join(args.json_save_dir, train_name))

    if args.val_img_dir and args.val_anno_dir:
        coco_val = _coco_header(args.dataset)
        add_split(coco_val, args.val_img_dir, args.val_anno_dir,
                  tolerance=args.tolerance)
        out = os.path.join(args.json_save_dir, f"{args.dataset}_val.json")
        with open(out, "w") as f:
            json.dump(coco_val, f)
        print("wrote", out)


if __name__ == "__main__":
    main()
