"""Evaluation CLIs (port of `imagdressing_tpu/eval/cli.py`; the reference's
metric/eval.py (CAMI-U) and eval_s.py (CAMI-S)):

  python -m imagdressing_tpu_torch.eval.cli cami-u --cloth_path A \
      --cloth_mask_path B
  python -m imagdressing_tpu_torch.eval.cli cami-s --pose_path P \
      --gen_pose_path Q --face_embeds E.npy --clip_similarity S
  python -m imagdressing_tpu_torch.eval.cli cami-s-grid --cloth_path ... \
      --model_path ... --clip_model ... [--device cuda]  (eval/grid.py)

As the JAX package's CLI: generated paths are joined relative to the given
directory, and the generated image is loaded for keypointing (the
reference's eval.py:74 and :85 faults are not kept).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from imagdressing_tpu_torch.eval import grid as grid_lib


def cami_u_folder(cloth_dir: str, generated_dir: str) -> float:
    """The mean CAMI-U over the garments of `cloth_dir`, 0 where the
    generated crop of the same name is missing."""
    from imagdressing_tpu_torch.eval.cami import cami_u

    scores = []
    for name in sorted(os.listdir(cloth_dir)):
        gen_path = os.path.join(generated_dir, name)
        if not os.path.exists(gen_path):
            scores.append(0.0)
            continue
        scores.append(cami_u(grid_lib.imread_bgr(os.path.join(cloth_dir,
                                                               name)),
                             grid_lib.imread_bgr(gen_path)))
    return float(np.mean(scores)) if scores else 0.0


def main(argv=None):
    p = argparse.ArgumentParser(description="CAMI metrics")
    sub = p.add_subparsers(dest="cmd", required=True)
    pu = sub.add_parser("cami-u")
    pu.add_argument("--cloth_path", required=True)
    pu.add_argument("--cloth_mask_path", required=True,
                    help="directory of generated garment crops")
    ps = sub.add_parser("cami-s")
    ps.add_argument("--pose_path", required=True,
                    help="reference pose render (png)")
    ps.add_argument("--gen_pose_path", required=True,
                    help="generated-image pose render (png)")
    ps.add_argument("--face_embeds", required=True,
                    help=".npy with two rows: [ref_embed, gen_embed]")
    ps.add_argument("--clip_similarity", type=float, required=True,
                    help="precomputed CLIP text-image similarity")
    grid_lib.add_parser(sub)
    args = p.parse_args(argv)

    if args.cmd == "cami-u":
        print("cami_us_score:", cami_u_folder(args.cloth_path,
                                              args.cloth_mask_path))
    elif args.cmd == "cami-s-grid":
        result = grid_lib.run(args)
        print("cami_s_score:", result["cami_s_score"],
              f"({result['num_cells']} cells,",
              f"{result['num_missing']} missing)")
    else:
        from imagdressing_tpu_torch.apps.image_utils import read_image
        from imagdressing_tpu_torch.eval.cami import cami_s

        embeds = np.load(args.face_embeds)
        print("cami_s_score:",
              cami_s(read_image(args.pose_path),
                     read_image(args.gen_pose_path), embeds[0], embeds[1],
                     args.clip_similarity))


if __name__ == "__main__":
    main()
