"""The CAMI-S grid evaluation driver (port of `imagdressing_tpu/eval/
grid.py`; the reference's metric/eval_s.py:145-181): iterate the
prompt x pose x face x cloth grid over a folder of generated images named
`pt_{i}_pose_{j}_face_{k}_{cloth_basename}` and score each cell

    CAMI-S = CAMI-US(cloth, generated cloth crop)
           + pose-overlap(pose render, openpose(generated))
           + face-cosine(face photo, generated)
           + CLIP(text, generated)

The three model-backed terms are injected callables, so the driver runs
without weights; `run` wires the port's CLIP scorer (`eval.clip_score`),
OpenPose (`preprocess/openpose`, rendered by its `draw.py`) and the face
embedder (`--face_embedder module:function`, else insightface). Images
are read without OpenCV, in its BGR order.
"""

from __future__ import annotations

import json
import os
import zlib
from typing import Callable, Dict, List, Optional

import numpy as np

from imagdressing_tpu_torch.apps.image_utils import read_image
from imagdressing_tpu_torch.eval.cami import cami_u, face_cosine, pose_overlap
from imagdressing_tpu_torch.ops.resize import cv2_resize_area_u8


def imread_bgr(path: str) -> Optional[np.ndarray]:
    """`cv2.imread(path)`: uint8 BGR, or None for a missing or unreadable
    file."""
    try:
        return np.ascontiguousarray(read_image(path)[..., ::-1])
    except (OSError, ValueError, zlib.error):
        return None


def make_pose_renderer(openpose) -> Callable[[np.ndarray, int, int],
                                              np.ndarray]:
    """OpenPose keypoints -> the stick render at (h, w): the reference's
    `model_pose(img_path)` on the image shrunk to 384x512 (INTER_AREA),
    then drawn at the pose render's size."""
    from imagdressing_tpu_torch.preprocess.openpose.draw import draw_bodypose

    def render(image_rgb: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
        view = cv2_resize_area_u8(image_rgb, 384, 512)
        kps = np.asarray(openpose(view)["pose_keypoints_2d"])
        return draw_bodypose(kps, out_h, out_w, src_size=(384, 512))

    return render


def _images_in(d: str) -> List[str]:
    # stray non-image files (.DS_Store, jsons) must not abort the grid
    exts = (".jpg", ".jpeg", ".png", ".bmp", ".webp")
    return sorted(f for f in os.listdir(d) if f.lower().endswith(exts))


def cami_s_grid(prompts: List[str], pose_dir: str, face_dir: str,
                cloth_dir: str, generated_dir: str, cloth_mask_dir: str, *,
                clip_fn: Callable[[str, np.ndarray], float],
                face_embed_fn: Callable[[str], np.ndarray],
                pose_render_fn: Callable[[np.ndarray, int, int], np.ndarray],
                num_faces: int = 5) -> Dict:
    """-> {"cami_s_score": mean, "num_cells", "num_missing", "cells"}, in
    eval_s.py's grid order and naming. A cell whose generated image or
    garment crop is missing or unreadable scores 0 (the reference would
    crash; the CAMI-U folder CLI's convention)."""
    cloths = _images_in(cloth_dir)
    poses = _images_in(pose_dir)
    faces = _images_in(face_dir)
    num_faces = min(num_faces, len(faces))
    cloth_imgs = {c: imread_bgr(os.path.join(cloth_dir, c)) for c in cloths}
    face_embeds = {f: np.asarray(face_embed_fn(os.path.join(face_dir, f)))
                   for f in faces[:num_faces]}

    cells = []
    for i_prompt, prompt in enumerate(prompts):
        for j_pose, pose_name in enumerate(poses):
            pose1 = imread_bgr(os.path.join(pose_dir, pose_name))
            if pose1 is None:
                raise ValueError(
                    f"unreadable pose image: {pose_dir}/{pose_name}")
            ph, pw = pose1.shape[:2]
            for k_face in range(num_faces):
                face_name = faces[k_face]
                for cloth_name in cloths:
                    gen_name = (f"pt_{i_prompt}_pose_{j_pose}_face_{k_face}_"
                                f"{cloth_name}")
                    gen_img_path = os.path.join(generated_dir, gen_name)
                    gen_cloth_path = os.path.join(cloth_mask_dir, gen_name)
                    cell = {"prompt": i_prompt, "pose": j_pose,
                            "face": k_face, "cloth": cloth_name,
                            "generated": gen_name}
                    ref_cloth = cloth_imgs[cloth_name]
                    gen_cloth = imread_bgr(gen_cloth_path)
                    gen_img = imread_bgr(gen_img_path)
                    if ref_cloth is None or gen_cloth is None \
                            or gen_img is None:
                        cell["score"] = 0.0
                        cell["missing"] = True
                        cells.append(cell)
                        continue
                    cami_us = cami_u(ref_cloth, gen_cloth)
                    gen_rgb = np.ascontiguousarray(gen_img[..., ::-1])
                    pose_term = pose_overlap(pose1[..., ::-1],
                                             pose_render_fn(gen_rgb, ph, pw))
                    face_term = face_cosine(
                        face_embeds[face_name],
                        np.asarray(face_embed_fn(gen_img_path)))
                    clip_term = clip_fn(prompt,
                                        gen_rgb.astype(np.float32) / 255.0)
                    cell.update(cami_us=float(cami_us),
                                pose_term=float(pose_term),
                                face_term=float(face_term),
                                clip_term=float(clip_term),
                                score=float(cami_us + pose_term + face_term
                                            + clip_term))
                    cells.append(cell)

    scores = [c["score"] for c in cells]
    return {"cami_s_score": float(np.mean(scores)) if scores else 0.0,
            "num_cells": len(cells),
            "num_missing": sum(1 for c in cells if c.get("missing")),
            "cells": cells}


def run(args) -> Dict:
    """Wire the scorers on `args.device` and run the grid (the CLI
    body)."""
    from imagdressing_tpu_torch.apps.serve import load_post_process
    from imagdressing_tpu_torch.eval.clip_score import ClipScorer
    from imagdressing_tpu_torch.preprocess.openpose.infer import OpenPose

    scorer = ClipScorer.from_torch(args.clip_model, args.clip_tokenizer,
                                   args.device)
    if args.face_embedder:
        face_embed_fn = load_post_process(args.face_embedder, args.device)
    else:
        from imagdressing_tpu_torch.preprocess.face import (
            face_embeds_from_image,
        )

        def face_embed_fn(path):
            return face_embeds_from_image(path)[0][0]

    openpose = (OpenPose.from_torch(args.openpose_ckpt, args.device)
                if args.openpose_ckpt else OpenPose.get_default(args.device))
    if args.prompts_file:
        with open(args.prompts_file) as f:
            prompts = [ln.strip() for ln in f if ln.strip()]
    else:
        prompts = args.prompt
    result = cami_s_grid(
        prompts, args.pose_path, args.face_path, args.cloth_path,
        args.model_path, args.cloth_mask_path, clip_fn=scorer.similarity,
        face_embed_fn=face_embed_fn,
        pose_render_fn=make_pose_renderer(openpose),
        num_faces=args.num_faces)
    if args.out_json:
        with open(args.out_json, "w") as f:
            json.dump(result, f, indent=1)
    return result


def add_parser(sub) -> None:
    g = sub.add_parser(
        "cami-s-grid",
        help="self-contained prompt x pose x face x cloth grid "
             "(eval_s.py:145-181)")
    g.add_argument("--prompt", action="append", default=[],
                   help="repeatable; or use --prompts_file")
    g.add_argument("--prompts_file", default=None)
    g.add_argument("--pose_path", required=True)
    g.add_argument("--face_path", required=True)
    g.add_argument("--cloth_path", required=True)
    g.add_argument("--cloth_mask_path", required=True,
                   help="generated garment crops")
    g.add_argument("--model_path", required=True,
                   help="generated images (pt_i_pose_j_face_k_<cloth>)")
    g.add_argument("--clip_model", required=True,
                   help="transformers CLIP ViT-B/32 state dict")
    g.add_argument("--clip_tokenizer", default="")
    g.add_argument("--openpose_ckpt", default=None)
    g.add_argument("--face_embedder", default=None,
                   help="'module:function' path->(512,) embedding override "
                        "(default: insightface)")
    g.add_argument("--num_faces", type=int, default=5)
    g.add_argument("--out_json", default=None)
    g.add_argument("--device", default="cuda",
                   help="where the CLIP scorer and OpenPose run")
