"""Person-detector train / infer CLI (port of `imagdressing_tpu/apps/
detect_cli.py`; the reference's mhp_extension detectron2 scripts,
tools/finetune_net.py with parsing_finetune_cihp.yaml / parsing_inference.
yaml):

  python -m imagdressing_tpu_torch.apps.detect_cli train \
      --annotations CIHP_train.json --img_dir Images/ --out detector.npz \
      --steps 200 [--tiny] [--data_parallel N]
  python -m imagdressing_tpu_torch.apps.detect_cli infer \
      --annotations CIHP_val.json --img_dir Images/ --params detector.npz \
      --out instances.npy [--tiny]

Train: `detect/train.py`'s loss, optax's chain(clip_by_global_norm(1.0),
adam(lr)) as `ClipAdam`, batches of `--batch_size` letterboxed images
(shuffled from `--seed`), the sampling draws of step s from a generator
seeded seed * 100003 + s. `--data_parallel N` (-1: every visible GPU)
splits the batch over N data ranks (started here, or under torchrun): the
loss normalisers are summed over the ranks and the gradients summed, so
the step is the one-device step on the whole batch; more ranks than cards
raise (no CPU stands in; `--allow_cpu_mesh` runs gloo CPU ranks, for
tests). Infer: `detect_instances` per image, the boxes taken back through
the letterbox scale, the masks pasted into the original frame:
`instances.npy`, the `tools/make_crop.py` contract. Both run on the card
unless `--device cpu`.

The parameter file is the JAX CLI's format: "p0", "p1", ... the leaves in
`jax.tree.leaves` order (dict keys sorted), JAX layouts (HWIO conv
kernels, (in, out) linear kernels): a file written by either package loads
in the other.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Any, Dict

import numpy as np
import torch


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="person Mask R-CNN train/infer")
    sub = p.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("train")
    t.add_argument("--annotations", required=True)
    t.add_argument("--img_dir", required=True)
    t.add_argument("--out", required=True)
    t.add_argument("--resume", default=None, help="warm-start .npz")
    t.add_argument("--steps", type=int, default=200)
    t.add_argument("--batch_size", type=int, default=2,
                   help="global batch, split over the data ranks")
    t.add_argument("--image_size", type=int, default=512)
    t.add_argument("--learning_rate", type=float, default=1e-3)
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--tiny", action="store_true",
                   help="tiny test config instead of the full model")
    t.add_argument("--data_parallel", type=int, default=1,
                   help="data-parallel ranks (-1: every visible GPU)")
    t.add_argument("--allow_cpu_mesh", action="store_true",
                   help="permit CPU ranks over gloo (tests only)")
    t.add_argument("--log_every", type=int, default=20)
    t.add_argument("--device", default="cuda")

    i = sub.add_parser("infer")
    i.add_argument("--annotations", required=True,
                   help="COCO json (images list; annotations optional)")
    i.add_argument("--img_dir", required=True)
    i.add_argument("--params", required=True)
    i.add_argument("--out", required=True, help="instances .npy to write")
    i.add_argument("--image_size", type=int, default=512)
    i.add_argument("--score_threshold", type=float, default=0.5)
    i.add_argument("--nms_threshold", type=float, default=0.95)
    i.add_argument("--max_detections", type=int, default=20)
    i.add_argument("--tiny", action="store_true")
    i.add_argument("--device", default="cuda")
    return p


def config(tiny: bool):
    from imagdressing_tpu_torch.detect import maskrcnn

    return maskrcnn.tiny_config() if tiny else maskrcnn.MaskRCNNConfig()


def save_params(path: str, model) -> None:
    """The detector's parameters -> the JAX CLI's flat .npz (float32,
    stored uncompressed; `np.load` reads it either way)."""
    from imagdressing_tpu_torch.convert import (
        jax_leaf_order,
        tree_from_module,
        tree_paths,
    )

    leaves = tree_paths(tree_from_module(model))
    np.savez(path, **{
        f"p{i}": leaves[k].float().cpu().contiguous().numpy()
        for i, k in enumerate(jax_leaf_order(list(leaves)))})


def load_params(path: str, cfg, device="cuda"):
    """A flat detector .npz (written by either package's CLI) -> the port's
    `MaskRCNN` on `device`."""
    from imagdressing_tpu_torch.convert import (
        detector_params_from_jax,
        tree_from_flat_leaves,
        tree_from_module,
        tree_paths,
    )
    from imagdressing_tpu_torch.detect import maskrcnn
    from imagdressing_tpu_torch.pipelines.dressing import resolve_device

    with torch.device("meta"):
        template = maskrcnn.MaskRCNN(cfg)
    with np.load(path) as flat:
        tree = tree_from_flat_leaves(
            flat, list(tree_paths(tree_from_module(template))))
    with torch.device(resolve_device(device)):
        model = maskrcnn.MaskRCNN(cfg)
    model.load_state_dict(detector_params_from_jax(tree))
    return model


def run_train(args, argv=None) -> Dict[str, Any]:
    """-> {"losses", "metrics", "step_s", "params"}: the whole batch's
    total loss and losses of each step, each step's wall time
    (synchronised), the written file; where this call started the ranks,
    rank 0's (its losses and grad_norm are the whole batch's)."""
    from imagdressing_tpu_torch.parallel import launch

    return launch.run_app(main, argv, lambda mesh: _train(args, mesh),
                          data_parallel=args.data_parallel,
                          tensor_parallel=1, device=args.device,
                          allow_cpu_mesh=args.allow_cpu_mesh,
                          rank0_result=True)


def _train(args, mesh) -> Dict[str, Any]:
    import torch.distributed as dist

    from imagdressing_tpu_torch.core import mesh as mesh_lib
    from imagdressing_tpu_torch.detect import maskrcnn
    from imagdressing_tpu_torch.detect.data import CocoDetectionData
    from imagdressing_tpu_torch.detect.train import (
        ClipAdam,
        make_draws,
        make_train_step,
        rows_of,
    )
    from imagdressing_tpu_torch.pipelines.dressing import resolve_device

    device = resolve_device(args.device) if mesh is None else mesh.device
    ranks, rank = (1, 0) if mesh is None else (mesh.data, mesh.data_rank)
    if args.batch_size % ranks:
        raise SystemExit(f"--batch_size {args.batch_size} does not split "
                         f"over {ranks} data ranks")
    per = args.batch_size // ranks
    cfg = config(args.tiny)
    data = CocoDetectionData(args.annotations, args.img_dir,
                             max_gt=cfg.max_gt, image_size=args.image_size)
    model = (load_params(args.resume, cfg, device) if args.resume
             else maskrcnn.init(args.seed, cfg, device))
    params = list(model.parameters())
    if mesh is not None and mesh.data_group is not None:
        # every rank starts from rank 0's weights
        flat = torch.cat([p.detach().reshape(-1) for p in params])
        dist.broadcast(flat, src=0, group=mesh.data_group)
        with torch.no_grad():
            for p, t in zip(params, flat.split([p.numel() for p in params])):
                p.copy_(t.view_as(p))
    step = make_train_step(model, ClipAdam(params, args.learning_rate),
                           mesh=mesh)
    it = data.batches(args.batch_size, rng=np.random.default_rng(args.seed),
                      rank=rank, ranks=ranks)
    size = (args.image_size, args.image_size)
    losses, metrics, step_s = [], [], []
    for s in range(args.steps):
        ts = time.perf_counter()
        batch = {k: torch.from_numpy(v).to(device) for k, v in next(it).items()
                 if k in ("image", "gt_boxes", "gt_valid", "gt_masks")}
        gen = torch.Generator(device=device).manual_seed(
            args.seed * 100003 + s)
        draws = rows_of(make_draws(cfg, args.batch_size, size, gen),
                        rank * per, (rank + 1) * per)
        m = step(batch, draws)
        names = sorted(m)
        values = torch.stack([m[k] for k in names]).tolist()  # waits
        step_s.append(time.perf_counter() - ts)
        metrics.append(dict(zip(names, values)))
        losses.append(metrics[-1]["total"])
        if rank == 0 and (s % args.log_every == 0 or s == args.steps - 1):
            print(f"step {s}: " + " ".join(
                f"{k}={v:.4f}" for k, v in metrics[-1].items()), flush=True)
    if rank == 0:
        save_params(args.out, model)
        print("saved", args.out, flush=True)
    if mesh is not None:
        mesh_lib.barrier(mesh.world_group)
    return {"losses": losses, "metrics": metrics, "step_s": step_s,
            "params": args.out}


def run_infer(args) -> Dict[str, Any]:
    """-> {file name: instances} (also written to --out)."""
    from imagdressing_tpu_torch.detect import infer as det_infer
    from imagdressing_tpu_torch.detect.data import CocoDetectionData
    from imagdressing_tpu_torch.pipelines.dressing import resolve_device

    device = resolve_device(args.device)
    cfg = config(args.tiny)
    model = load_params(args.params, cfg, device)
    data = CocoDetectionData(args.annotations, args.img_dir,
                             max_gt=cfg.max_gt, image_size=args.image_size)
    out: Dict[str, Any] = {}
    for image_id in data.ids:
        info = data.images[image_id]
        ex = data.load_example(image_id)
        det = det_infer.detect_instances(
            model, torch.from_numpy(ex["image"][None]).to(device),
            max_detections=args.max_detections,
            score_threshold=args.score_threshold,
            nms_threshold=args.nms_threshold)
        det = {k: v.cpu().numpy() for k, v in det.items()}
        # undo the letterbox scale before pasting into the original frame
        det["boxes"] = det["boxes"] / float(ex["scale"])
        out[info["file_name"]] = det_infer.to_instances(
            det, 0, info["height"], info["width"])
    np.save(args.out, out, allow_pickle=True)
    print("wrote", args.out, f"({len(out)} images)", flush=True)
    return out


def main(argv=None):
    """-> `run_train`'s dict or `run_infer`'s instances."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_argparser().parse_args(argv)
    return run_train(args, argv) if args.cmd == "train" else run_infer(args)


if __name__ == "__main__":
    main()
