"""Person-crop extraction from detector instances (port of
`imagdressing_tpu/tools/make_crop.py`; the reference's mhp_extension
make_crop_and_mask_w_mask_nms.py): per image, score-ordered instance masks
claim pixels into a panoptic map (the mask-NMS of tools/dataset_fusion.py),
each kept instance's bbox is expanded by `exp_ratio` (:10-18), the crop is
written as `<img>_<k>_msrcnn.jpg`, the panoptic map as `<img>_mask.npy`, and
a `crop.json` records the bookkeeping the global-local parsing scripts
consume (:80-93 field-for-field).

Detections come from `apps/detect_cli.py infer` (`instances.npy`) in
place of detectron2's instances_predictions.pth. Images are read as RGB
and the crops written through PIL at JPEG quality 95 (what `cv2.imwrite`
writes by default): the same pictures as the JAX tool's BGR crops, up to
the two libraries' JPEG encoders.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Tuple

import numpy as np

from imagdressing_tpu_torch.apps.image_utils import read_image, write_image
from imagdressing_tpu_torch.tools.dataset_fusion import mask_nms


def bbox_expand(img_height: int, img_width: int, bbox, exp_ratio: float
                ) -> Tuple[int, int, int, int]:
    """Expand an xyxy box about its center, clamped to the image
    (reference make_crop_and_mask_w_mask_nms.py:10-18 incl. the round/clamp
    asymmetry)."""
    x_min, y_min, x_max, y_max = bbox
    exp_x = (x_max - x_min) * ((exp_ratio - 1) / 2)
    exp_y = (y_max - y_min) * ((exp_ratio - 1) / 2)
    nx0 = 0 if x_min - exp_x < 0 else int(np.round(x_min - exp_x))
    ny0 = 0 if y_min - exp_y < 0 else int(np.round(y_min - exp_y))
    nx1 = (img_width - 1 if x_max + exp_x > img_width - 1
           else int(np.round(x_max + exp_x)))
    ny1 = (img_height - 1 if y_max + exp_y > img_height - 1
           else int(np.round(y_max + exp_y)))
    return nx0, ny0, nx1, ny1


def crop_image_instances(
    image: np.ndarray,  # (H, W, 3)
    instances: List[Dict[str, Any]],  # [{score, bbox xywh, segmentation}]
    im_name: str,
    *,
    dataset: str = "CIHP",
    exp_ratio: float = 1.2,
    overlap_threshold: float = 0.5,
    conf_thres: float = 0.5,
):
    """-> (item dict for crop.json, [(crop_name, crop_img)], panoptic map).

    `instances` must be score-descending (the detector contract). Crops
    keep the channel order of `image` (run() passes RGB)."""
    img_h, img_w = image.shape[:2]
    if instances:
        masks = np.stack([i["segmentation"] for i in instances], axis=-1)
        scores = [i["score"] for i in instances]
    else:
        masks = np.zeros((img_h, img_w, 0), np.uint8)
        scores = []
    panoptic, kept = mask_nms(
        masks, scores, confidence_threshold=conf_thres,
        overlap_threshold=overlap_threshold)

    exp_bbox, ori_bbox, names, kept_scores, crops = [], [], [], [], []
    for person_idx, inst_i in enumerate(kept, start=1):
        inst = instances[inst_i]
        x_min, y_min, bw, bh = inst["bbox"]
        x_max, y_max = x_min + bw, y_min + bh
        ex0, ey0, ex1, ey1 = bbox_expand(
            img_h, img_w, [x_min, y_min, x_max, y_max], exp_ratio)
        crop = image[ey0:ey1 + 1, ex0:ex1 + 1, :]
        name = os.path.splitext(im_name)[0] + f"_{person_idx}_msrcnn.jpg"
        exp_bbox.append([ex0, ey0, ex1, ey1])
        ori_bbox.append([x_min, y_min, x_max, y_max])
        names.append(name)
        kept_scores.append(float(inst["score"]))
        crops.append((name, crop))

    item = {
        "dataset": dataset,
        "im_name": im_name,
        "img_height": img_h,
        "img_width": img_w,
        "center": [img_h / 2, img_w / 2],
        "person_num": len(kept),
        "person_bbox": exp_bbox,
        "real_person_bbox": ori_bbox,
        "person_bbox_score": kept_scores,
        "bbox_name": names,
        "mask_name": os.path.splitext(im_name)[0] + "_mask.npy",
    }
    return item, crops, panoptic.astype(np.uint8)


def run(img_dir: str, save_dir: str, det_res: str, *,
        dataset: str = "CIHP", exp_ratio: float = 1.2,
        overlap_threshold: float = 0.5, conf_thres: float = 0.5) -> str:
    """Process every image in `det_res` (instances.npy from detect_cli);
    writes crop_pic/, crop_mask/, crop.json under save_dir; returns the
    crop.json path."""
    preds: Dict[str, List[Dict[str, Any]]] = np.load(
        det_res, allow_pickle=True).item()
    crop_dir = os.path.join(save_dir, "crop_pic")
    mask_dir = os.path.join(save_dir, "crop_mask")
    os.makedirs(crop_dir, exist_ok=True)
    os.makedirs(mask_dir, exist_ok=True)

    file_list = []
    for im_name in sorted(preds):
        path = os.path.join(img_dir, im_name)
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        item, crops, panoptic = crop_image_instances(
            read_image(path), preds[im_name], im_name, dataset=dataset,
            exp_ratio=exp_ratio, overlap_threshold=overlap_threshold,
            conf_thres=conf_thres)
        for name, crop in crops:
            write_image(os.path.join(crop_dir, name), crop, quality=95)
        np.save(os.path.join(mask_dir, item["mask_name"]), panoptic)
        file_list.append(item)

    out = os.path.join(save_dir, "crop.json")
    with open(out, "w") as f:
        json.dump({"root": file_list}, f, indent=2)
    return out


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(
        description="crop persons with mask-NMS (mhp_extension make_crop)")
    p.add_argument("--img_dir", required=True)
    p.add_argument("--save_dir", required=True)
    p.add_argument("--det_res", required=True,
                   help="instances.npy from `detect_cli infer`")
    p.add_argument("--dataset", default="CIHP")
    p.add_argument("--exp_ratio", type=float, default=1.2)
    p.add_argument("--overlap_threshold", type=float, default=0.5)
    p.add_argument("--conf_thres", type=float, default=0.5)
    a = p.parse_args(argv)
    print(run(a.img_dir, a.save_dir, a.det_res, dataset=a.dataset,
              exp_ratio=a.exp_ratio, overlap_threshold=a.overlap_threshold,
              conf_thres=a.conf_thres))


if __name__ == "__main__":
    main()
