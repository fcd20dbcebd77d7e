"""The detector's data-parallel step against one process: two gloo ranks
(one image each; on one card they share it, which NCCL refuses) run
`detect/train.py`'s `loss_and_grads` and one `make_train_step` step over
their data group, and this process runs the same on the whole batch. The
CPU test (`tests/test_torch_detect.py`) and `chip_smoke.py`'s detect_check
phase call `data_parallel_vs_one` and hold its errors to their bounds.

    python -m imagdressing_tpu_torch.tools.detect_check [--device cpu]

prints the errors for the tiny detector on a synthetic 2-image batch.
"""

from __future__ import annotations

import argparse
import json
from typing import Any, Dict

import numpy as np
import torch

from imagdressing_tpu_torch.detect import maskrcnn
from imagdressing_tpu_torch.detect import train as dtrain


class _SeenAdam(dtrain.ClipAdam):
    """ClipAdam that keeps the gradients of its last step."""

    def step(self, grads):
        self.grads = [g.detach().clone() for g in grads]
        return super().step(grads)


def dp_rank(cfg, state, batch, draws, lr, device_type, tf32):
    """One rank of a 2-rank gloo world -> (the whole batch's loss, the
    step's reported total, the summed gradients the step applied, the
    step's change of every parameter in units of lr, the largest
    difference of that change from a ClipAdam replayed here on the same
    gradients, in units of lr), on the host. `tf32`: the parent's (cuDNN,
    matmul) TF32 flags."""
    from imagdressing_tpu_torch.core import mesh as mesh_lib

    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = tf32
    dev = mesh_lib.init_from_env("gloo", device_type=device_type,
                                 share_devices=True)
    try:
        mesh = mesh_lib.make_mesh(2, 1, device=dev)
        r = mesh.data_rank
        with torch.device(dev):
            model = maskrcnn.MaskRCNN(cfg)
        model.load_state_dict(state)
        mine = {k: v[r:r + 1].to(dev) for k, v in batch.items()}
        my_draws = {k: (p[r:r + 1].to(dev), n[r:r + 1].to(dev))
                    for k, (p, n) in draws.items()}
        losses, _ = dtrain.loss_and_grads(model, mine, my_draws,
                                          group=mesh.data_group)
        total = mesh_lib.psum(losses["total"].detach(), mesh.data_group)
        before = [p.detach().clone() for p in model.parameters()]
        opt = _SeenAdam(list(model.parameters()), lr)
        metrics = dtrain.make_train_step(model, opt, mesh=mesh)(mine,
                                                                 my_draws)
        replay = [p.clone() for p in before]
        dtrain.ClipAdam(replay, lr).step(opt.grads)
        replay_err = max(float((p.detach() - q).abs().max()) / lr
                         for p, q in zip(model.parameters(), replay))
        return (float(total), float(metrics["total"]),
                [g.cpu().numpy() for g in opt.grads],
                _steps(model, before, lr), replay_err)
    finally:
        mesh_lib.destroy()


def _steps(model, before, lr) -> list:
    """Each parameter's change since `before`, in units of lr (float64)."""
    return [(p.detach().cpu().double() - q.cpu().double()).numpy() / lr
            for p, q in zip(model.parameters(), before)]


def _rel_max(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got - want).max()
                 / max(float(np.abs(want).max()), 1e-12))


def data_parallel_vs_one(model: maskrcnn.MaskRCNN,
                         batch: Dict[str, torch.Tensor],
                         draws: dtrain.Draws, lr: float = 1e-3
                         ) -> Dict[str, Any]:
    """2 ranks against this process on `model`'s device (with its TF32
    flags); batch and draws of 2 images. -> {"loss_rel_err",
    "step_loss_rel_err", "grad_err" (the largest over leaves of max|diff| /
    max|ref|, on the gradients each rank's step applied), "replay_err"
    (each rank's parameter change against ClipAdam replayed on the
    gradients that rank applied, in units of lr), "step_err" (the change
    against this process's, in units of lr, over the elements whose
    gradient here is larger than `sign_floor`), "sign_floor" (the largest
    gradient difference of a leaf from this process's, times 10: below it
    Adam's first step, +-lr, takes its sign from rounding), "ranks_equal"}.
    A change of p by lr must stand out of p's rounding: lr 1e-3 on
    parameters below 10 reads it to 1e-3 of lr."""
    from imagdressing_tpu_torch.parallel import launch

    dev = next(model.parameters()).device
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    host = {k: v.cpu() for k, v in batch.items()}
    host_draws = {k: (p.cpu(), n.cpu()) for k, (p, n) in draws.items()}
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    ranks = launch.spawn(dp_rank, 2, (model.cfg, state, host, host_draws,
                                      lr, dev.type, tf32), timeout=600,
                         threads=2)
    with torch.device(dev):
        one = maskrcnn.MaskRCNN(model.cfg)
    one.load_state_dict(state)
    on_dev = {k: v.to(dev) for k, v in batch.items()}
    dev_draws = {k: (p.to(dev), n.to(dev)) for k, (p, n) in draws.items()}
    losses, _ = dtrain.loss_and_grads(one, on_dev, dev_draws)
    before = [p.detach().clone() for p in one.parameters()]
    opt = _SeenAdam(list(one.parameters()), lr)
    metrics = dtrain.make_train_step(one, opt)(on_dev, dev_draws)
    want = float(losses["total"].detach())
    grads = [g.cpu().numpy() for g in opt.grads]
    steps = _steps(one, before, lr)
    floor = 10 * max(float(np.abs(a - b).max()) for r in ranks
                     for a, b in zip(r[2], grads))
    return {
        "loss": want,
        "loss_rel_err": max(abs(r[0] - want) / abs(want) for r in ranks),
        "step_loss_rel_err": max(abs(r[1] - float(metrics["total"]))
                                 / abs(want) for r in ranks),
        "grad_err": max(_rel_max(a, b) for r in ranks
                        for a, b in zip(r[2], grads)),
        "replay_err": max(r[4] for r in ranks),
        "step_err": max(float(np.abs(a - b)[np.abs(g) > floor].max(
            initial=0.0)) for r in ranks
            for a, b, g in zip(r[3], steps, grads)),
        "sign_floor": floor,
        "steps_over_floor": sum(int((np.abs(g) > floor).sum())
                                for g in grads),
        "ranks_equal": all(np.array_equal(a, b)
                           for a, b in zip(ranks[0][3], ranks[1][3])),
    }


def synthetic_batch(cfg: maskrcnn.MaskRCNNConfig, b: int = 2,
                    size: int = 64, seed: int = 3) -> Dict[str, np.ndarray]:
    """Noisy dark images with 1..b bright person boxes each (the noise
    keeps objectness values apart, so top-k and NMS meet no exact ties)."""
    rng = np.random.default_rng(seed)
    images = rng.uniform(0.0, 0.2, (b, size, size, 3)).astype(np.float32)
    gt_boxes = np.zeros((b, cfg.max_gt, 4), np.float32)
    gt_valid = np.zeros((b, cfg.max_gt), bool)
    gt_masks = np.zeros((b, cfg.max_gt, size, size), np.float32)
    for i in range(b):
        for k in range(min(1 + i, cfg.max_gt)):
            x0, y0 = (int(v * size / 64) for v in rng.integers(2, 30, 2))
            bw, bh = (int(v * size / 64) for v in rng.integers(14, 32, 2))
            x1, y1 = min(x0 + bw, size - 1), min(y0 + bh, size - 1)
            images[i, y0:y1, x0:x1] += 0.7
            gt_boxes[i, k] = [x0, y0, x1, y1]
            gt_valid[i, k] = True
            gt_masks[i, k, y0:y1, x0:x1] = 1.0
    return {"image": images, "gt_boxes": gt_boxes, "gt_valid": gt_valid,
            "gt_masks": gt_masks}


def main(argv=None) -> Dict[str, Any]:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    from imagdressing_tpu_torch.pipelines.dressing import resolve_device

    dev = resolve_device(a.device)
    cfg = maskrcnn.tiny_config()
    model = maskrcnn.init(0, cfg, dev)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in synthetic_batch(cfg).items()}
    draws = dtrain.make_draws(cfg, 2, (64, 64),
                              torch.Generator(device=dev).manual_seed(0))
    out = data_parallel_vs_one(model, batch, draws)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
