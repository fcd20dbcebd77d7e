"""Human-parsing train / eval CLI (port of `imagdressing_tpu/apps/
parsing_cli.py`; the reference's global_local_train.py /
global_local_evaluate.py):

  python -m imagdressing_tpu_torch.apps.parsing_cli train \
      --image_dir data/Images --label_dir data/Category_ids --out_dir log/
  python -m imagdressing_tpu_torch.apps.parsing_cli eval \
      --image_dir data/Images --label_dir data/Category_ids \
      --restore log/params.npz [--flip] [--scales 0.75,1.0,1.25]

Train: AugmentCE2P with batch-statistics ABN, the CE + Lovász + edge
criterion, SGD with the poly schedule (`train/parsing_train.py`), over the
data group (the JAX CLI's whole mesh): `--data_parallel N` (default -1,
every visible GPU) starts N ranks itself, or run under torchrun; each rank
takes its `--batch_size` rows of the global batch, the statistics and
gradients are synced (`shard_parsing_train_step`), rank 0 writes
params.npz; one rank runs the single-device step. `--allow_cpu_mesh` runs
CPU ranks over gloo (tests). Eval: logits averaged over the optional
horizontal flip (left / right classes swapped back) and the scales,
resized to the input size with align_corners=True, one dataset-wide
confusion matrix, the mean IoU; the eval forward is the inference net, so
every ABN is one K7 launch (119 per forward). Both run on the card unless
`--device cpu`.

`params.npz` holds the JAX package's key paths ("layer1/0/bn1/weight",
HWIO "kernel"s, BN "running_mean" / "running_var"): a file written by
either package loads in the other (`np.load` reads both; the port writes
it without deflate, which takes ~11 s for SCHP's 67 M floats and saves
~7 %); the JAX package's legacy "p0"... format (leaves in its flattening
order) loads too. `--restore x.pth` reads an SCHP torch checkpoint.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Dict

import numpy as np
import torch


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="SCHP parsing train/eval")
    sub = p.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("train")
    t.add_argument("--image_dir", required=True)
    t.add_argument("--label_dir", required=True)
    t.add_argument("--out_dir", required=True)
    t.add_argument("--num_classes", type=int, default=18)
    t.add_argument("--input_size", type=int, default=473)
    t.add_argument("--batch_size", type=int, default=1,
                   help="per-device batch")
    t.add_argument("--steps", type=int, default=1000)
    t.add_argument("--learning_rate", type=float, default=7e-3)
    t.add_argument("--restore", default=None,
                   help="torch SCHP .pth or params .npz to fine-tune from "
                        "(else random)")
    t.add_argument("--log_every", type=int, default=10)
    t.add_argument("--device", default="cuda")
    t.add_argument("--data_parallel", type=int, default=-1,
                   help="data-parallel ranks (-1: every visible GPU)")
    t.add_argument("--allow_cpu_mesh", action="store_true",
                   help="permit CPU ranks over gloo (tests only)")

    e = sub.add_parser("eval")
    e.add_argument("--image_dir", required=True)
    e.add_argument("--label_dir", required=True)
    e.add_argument("--restore", required=True,
                   help="params .npz (from train) or torch SCHP .pth")
    e.add_argument("--num_classes", type=int, default=18)
    e.add_argument("--input_size", type=int, default=473)
    e.add_argument("--flip", action="store_true")
    e.add_argument("--scales", default="1.0",
                   help="comma list, e.g. 0.75,1.0,1.25")
    e.add_argument("--save_dir", default=None,
                   help="write predicted label PNGs here")
    e.add_argument("--device", default="cuda")
    return p


# ---------------------------------------------------------------------------
# params.npz: the JAX package's key paths
# ---------------------------------------------------------------------------


def _is_kernel(net: torch.nn.Module, name: str) -> bool:
    from imagdressing_tpu_torch.ops.nn import Conv2d

    owner, _, leaf = name.rpartition(".")
    return leaf == "weight" and isinstance(net.get_submodule(owner), Conv2d)


def _leaf_key(net: torch.nn.Module, name: str) -> str:
    """A state-dict key -> the JAX tree's key path ("/"-joined), conv
    weights as "kernel"."""
    if _is_kernel(net, name):
        name = name[:-len("weight")] + "kernel"
    return name.replace(".", "/")


def load_params(path: str, num_classes: int, device="cuda"):
    """A params .npz (key paths or legacy "p{i}") or an SCHP torch
    checkpoint -> an SCHP net in eval mode on `device`. A wrong
    --num_classes fails loudly."""
    from imagdressing_tpu_torch.preprocess.parsing import model as schp

    if not path.endswith(".npz"):
        from imagdressing_tpu_torch.convert.torch_sd import load_torch_file

        sd = load_torch_file(path)
        return schp.load_schp_state_dict(sd.get("state_dict", sd),
                                         num_classes, device)
    flat = np.load(path)
    with torch.device("meta"):
        template = schp.SCHP(num_classes)
    names = list(template.state_dict())
    keys = {n: _leaf_key(template, n) for n in names}
    if "p0" in flat.files:
        from imagdressing_tpu_torch.convert import jax_leaf_order

        order = jax_leaf_order(list(keys.values()))
        index = {k: i for i, k in enumerate(order)}
        arrays = {n: flat[f"p{index[keys[n]]}"] for n in names}
    else:
        arrays = {n: flat[keys[n]] for n in names}
    state = {}
    for n, a in arrays.items():
        t = torch.from_numpy(np.asarray(a, np.float32))
        state[n] = t.permute(3, 2, 0, 1) if _is_kernel(template, n) else t
    got = state["fushion.conv2.weight"].shape[0]
    if got != num_classes:
        raise ValueError(f"params produce {got} classes, caller expects "
                         f"{num_classes}")
    from imagdressing_tpu_torch.pipelines.dressing import resolve_device

    with torch.device(resolve_device(device)):
        net = schp.SCHP(num_classes)
    net.load_state_dict(state)
    return net.eval().requires_grad_(False)


def save_params(path: str, net: torch.nn.Module) -> None:
    """The net's parameters and running statistics -> `path` with the JAX
    package's `_save_params` keys and layouts (key paths, conv kernels
    HWIO, float32), stored uncompressed."""
    named = {}
    for n, t in net.state_dict().items():
        a = t.detach().float().cpu()
        if _is_kernel(net, n):
            a = a.permute(2, 3, 1, 0)
        named[_leaf_key(net, n)] = a.contiguous().numpy()
    np.savez(path, **named)


# ---------------------------------------------------------------------------
# train / eval
# ---------------------------------------------------------------------------


def run_train(args, argv=None) -> Dict:
    """-> {"losses", "step_s", "params"}: the loss of each step (global),
    each step's wall time (synchronised) and the written params path; None
    where this call started the ranks."""
    from imagdressing_tpu_torch.parallel import launch

    return launch.run_app(main, argv, lambda mesh: _train(args, mesh),
                          data_parallel=args.data_parallel,
                          tensor_parallel=1, device=args.device,
                          allow_cpu_mesh=args.allow_cpu_mesh)


def _train(args, mesh) -> Dict:
    from imagdressing_tpu_torch.core import mesh as mesh_lib
    from imagdressing_tpu_torch.pipelines.dressing import resolve_device
    from imagdressing_tpu_torch.preprocess.parsing import model as schp
    from imagdressing_tpu_torch.train.parsing_train import (
        ParsingDataset,
        ParsingTrainConfig,
        make_optimizer,
        make_parsing_train_step,
        shard_parsing_train_step,
    )

    device = resolve_device(args.device) if mesh is None else mesh.device
    data, rank = (1, 0) if mesh is None else (mesh.data, mesh.data_rank)
    cfg = ParsingTrainConfig(num_classes=args.num_classes,
                             learning_rate=args.learning_rate,
                             total_steps=args.steps)
    if args.restore:
        net = load_params(args.restore, args.num_classes, device)
    else:
        net = schp.init(0, args.num_classes, device)
    net.requires_grad_(True)
    if mesh is None:
        step = make_parsing_train_step(cfg, net, make_optimizer(cfg, net))
    else:
        step = shard_parsing_train_step(cfg, net, make_optimizer(cfg, net),
                                        mesh)
    ds = ParsingDataset(args.image_dir, args.label_dir, h=args.input_size,
                        w=args.input_size)
    os.makedirs(args.out_dir, exist_ok=True)
    b = args.batch_size
    losses, step_s = [], []
    t0 = time.perf_counter()
    for i in range(args.steps):
        ts = time.perf_counter()
        # this rank's rows of the global batch of b x data
        batch = ds.batch([(i * b * data + rank * b + j) % len(ds)
                          for j in range(b)])
        batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        m = step(i, batch)
        losses.append(float(m["loss"]))  # waits for the step
        step_s.append(time.perf_counter() - ts)
        if (i + 1) % args.log_every == 0 and rank == 0:
            print(f"step {i + 1} loss {losses[-1]:.4f} "
                  f"({(time.perf_counter() - t0) / (i + 1):.2f}s/step)",
                  flush=True)
    out = os.path.join(args.out_dir, "params.npz")
    if rank == 0:
        save_params(out, net)
        print("saved", out, flush=True)
    if mesh is not None:
        mesh_lib.barrier(mesh.world_group)
    return {"losses": losses, "step_s": step_s, "params": out}


def flip_permutation(num_classes: int) -> np.ndarray:
    """The class permutation that swaps left and right for the flipped
    pass: LIP/CIHP-20 swaps 14..19, ATR-18 swaps 9..15 (the reference's
    multi_scale_testing)."""
    pairs = {20: [(14, 15), (16, 17), (18, 19)],
             18: [(9, 10), (12, 13), (14, 15)]}.get(num_classes, [])
    perm = np.arange(num_classes)
    for a, b in pairs:
        perm[a], perm[b] = b, a
    return perm


def run_eval(args) -> float:
    """The mean IoU over the dataset (and the prediction PNGs where
    --save_dir is given)."""
    from imagdressing_tpu_torch.apps.png import encode_png
    from imagdressing_tpu_torch.ops.resize import cv2_resize_linear
    from imagdressing_tpu_torch.pipelines.dressing import resolve_device
    from imagdressing_tpu_torch.preprocess.parsing.model import (
        resize_align_corners,
    )
    from imagdressing_tpu_torch.train.parsing_train import ParsingDataset

    device = resolve_device(args.device)
    net = load_params(args.restore, args.num_classes, device)
    scales = [float(s) for s in args.scales.split(",")]
    size, n = args.input_size, args.num_classes
    perm = torch.from_numpy(flip_permutation(n)).to(device)

    @torch.no_grad()
    def logits_at(image: torch.Tensor) -> torch.Tensor:
        fusion, _ = net(image)
        # align_corners=True as the reference's eval (nn.Upsample)
        return resize_align_corners(fusion.float(), size, size)[0]

    ds = ParsingDataset(args.image_dir, args.label_dir, h=size, w=size)
    if args.save_dir:
        os.makedirs(args.save_dir, exist_ok=True)
    # one dataset-wide confusion matrix (the reference's compute_mean_ioU)
    confusion = np.zeros((n, n), np.int64)
    for i in range(len(ds)):
        s = ds.get(i)
        image = torch.from_numpy(s["image"]).to(device)
        acc = torch.zeros((size, size, n), dtype=torch.float32,
                          device=device)
        for sc in scales:
            side = max(32, int(round(size * sc)))
            img = cv2_resize_linear(image, side, side)[None].contiguous()
            acc += logits_at(img)
            if args.flip:
                flipped = logits_at(img.flip(2).contiguous()).flip(1)
                acc += flipped[:, :, perm]
        pred = acc.argmax(-1).cpu().numpy().astype(np.int32)
        label = np.asarray(s["label"])
        valid = label != 255
        confusion += np.bincount(
            label[valid].astype(np.int64) * n + pred[valid],
            minlength=n * n).reshape(n, n)
        if args.save_dir:
            with open(os.path.join(args.save_dir, f"{ds.ids[i]}.png"),
                      "wb") as f:
                f.write(encode_png(pred.astype(np.uint8)))
    tp = np.diag(confusion).astype(np.float64)
    denom = confusion.sum(0) + confusion.sum(1) - np.diag(confusion)
    present = denom > 0
    miou = float(np.mean(tp[present] / denom[present])) if present.any() \
        else 0.0
    print(f"mean IoU over {len(ds)} images: {miou:.4f}", flush=True)
    return miou


def main(argv=None):
    """-> `run_train`'s dict or `run_eval`'s mIoU."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_argparser().parse_args(argv)
    return run_train(args, argv) if args.cmd == "train" else run_eval(args)


if __name__ == "__main__":
    main()
