"""Training CLI (port of `imagdressing_tpu/apps/train_cli.py`):

  python -m imagdressing_tpu_torch.apps.train_cli \\
      --data_json_file manifest.json --base_dir ckpt/... --vae_path ... \\
      --image_encoder_path ... --output_dir runs/exp1

Flag names and defaults are the JAX CLI's (the reference's train.py and
run.sh). From a manifest of person / garment images (`train.data`) to
training steps (`train.step`) on one device, metrics in
`<output_dir>/metrics.jsonl` (+ TensorBoard events under
`<output_dir>/logs` with `--report_to tensorboard|all`), and checkpoints in
`<output_dir>/checkpoints` (`train.checkpoint`) every
`--checkpointing_steps` and at the end; `--resume_from_checkpoint` starts
from the latest one. `apps.dress --trained_ckpt <output_dir>/checkpoints`
serves the result.

The stack starts from the base files (the reference's train.py: the garment
UNet a copy of the base UNet, the adapters from its attn1 projections, a
fresh Resampler), loaded in fp32 and split by `cast_for_training`: frozen
models in bf16, fp32 master weights for the trainables.

Runs on the card (`--device cuda`, the default; raises on a host without
one) or, with `--device cpu`, with every kernel's plain version.
`--tensor_parallel` other than 1 raises (multi-GPU is not ported).
"""

from __future__ import annotations

import argparse
import logging
import os
import time


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="IMAGDressing training (PyTorch)")
    p.add_argument("--data_json_file", required=True)
    p.add_argument("--data_root_path", default="")
    p.add_argument("--base_dir", default="ckpt/Realistic_Vision_V4.0_noVAE")
    p.add_argument("--vae_path", default="ckpt/sd-vae-ft-mse")
    p.add_argument("--image_encoder_path", default="ckpt/image_encoder")
    p.add_argument("--output_dir", default="output")
    p.add_argument("--learning_rate", type=float, default=5e-5)
    p.add_argument("--weight_decay", type=float, default=1e-2)
    p.add_argument("--lr_warmup_steps", type=int, default=2000)
    p.add_argument("--train_batch_size", type=int, default=5,
                   help="per-device batch (run.sh uses 5)")
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--noise_offset", type=float, default=0.05)
    p.add_argument("--snr_gamma", type=float, default=None)
    p.add_argument("--num_train_steps", type=int, default=200_000)
    p.add_argument("--checkpointing_steps", type=int, default=2000)
    p.add_argument("--resume_from_checkpoint", action="store_true")
    p.add_argument("--resize_shorter", type=int, default=512,
                   help="dataset resize shorter-side (IGPair.py Resize(512))")
    p.add_argument("--crop_height", type=int, default=640)
    p.add_argument("--crop_width", type=int, default=512)
    p.add_argument("--dataloader_num_workers", type=int, default=4)
    p.add_argument("--logging_steps", type=int, default=10)
    p.add_argument("--report_to", default="jsonl",
                   choices=["jsonl", "tensorboard", "all", "wandb"],
                   help="metric sink(s): jsonl (default, always on), "
                        "tensorboard (adds an offline event file under "
                        "output_dir/logs), all (reference train.py)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--tensor_parallel", type=int, default=1,
                   help="only 1: multi-GPU is not ported yet")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the card, default) or 'cpu' (every "
                        "kernel's plain version)")
    return p


def _to_device(batch, device):
    """numpy batch -> tensors on `device`: from pinned host memory with
    asynchronous copies on a card."""
    import torch

    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(v)
        if k == "text_ids":
            t = t.long()
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


def main(argv=None):
    """Train; returns the final `train.step.TrainState`."""
    args = build_argparser().parse_args(argv)
    import torch

    from imagdressing_tpu_torch.apps.loader import load_dressing_models
    from imagdressing_tpu_torch.apps.serve import MULTI_GPU_PENDING
    from imagdressing_tpu_torch.apps.tokenizer import load_tokenizer
    from imagdressing_tpu_torch.core.config import TrainConfig
    from imagdressing_tpu_torch.core.profiling import StepTimer
    from imagdressing_tpu_torch.pipelines.dressing import resolve_device
    from imagdressing_tpu_torch.train.checkpoint import CheckpointManager
    from imagdressing_tpu_torch.train.data import IGPairDataset, data_iterator
    from imagdressing_tpu_torch.train.step import (
        init_train_state,
        make_train_step,
    )
    from imagdressing_tpu_torch.train.trackers import make_tracker

    if args.tensor_parallel != 1:
        raise SystemExit(MULTI_GPU_PENDING)
    device = resolve_device(args.device)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    log = logging.getLogger("train")

    cfg = TrainConfig(
        learning_rate=args.learning_rate,
        weight_decay=args.weight_decay,
        warmup_steps=args.lr_warmup_steps,
        train_batch_size=args.train_batch_size,
        gradient_accumulation_steps=args.gradient_accumulation_steps,
        max_grad_norm=args.max_grad_norm,
        noise_offset=args.noise_offset,
        snr_gamma=args.snr_gamma,
        num_train_steps=args.num_train_steps,
        checkpointing_steps=args.checkpointing_steps,
        seed=args.seed,
    )
    models = load_dressing_models(
        base_dir=args.base_dir,
        vae_path=args.vae_path,
        image_encoder_path=args.image_encoder_path,
        model_ckpt=None,
        dtype=None,
        device=device,
    ).cast_for_training(torch.bfloat16)
    state, frozen, tx = init_train_state(models, cfg)
    train_step = make_train_step(models, cfg, tx)
    log.info("device %s, batch %d, remat %s", device, cfg.train_batch_size,
             cfg.remat_policy)

    ckpt = CheckpointManager(os.path.join(args.output_dir, "checkpoints"))
    if args.resume_from_checkpoint:
        restored, _ = ckpt.restore(state)
        if restored is not None:
            state = restored
            log.info("resumed at step %d", state.step)

    tokenizer = load_tokenizer(os.path.join(args.base_dir, "tokenizer"))
    dataset = IGPairDataset(
        args.data_json_file,
        tokenizer,
        size=args.resize_shorter,
        crop_h=args.crop_height,
        crop_w=args.crop_width,
        clip_size=models.vision_cfg.image_size,
        image_root=args.data_root_path,
        seed=cfg.seed,
    )
    it = data_iterator(dataset, cfg.train_batch_size,
                       num_workers=args.dataloader_num_workers, seed=cfg.seed)
    os.makedirs(args.output_dir, exist_ok=True)
    tracker = make_tracker(args.report_to, args.output_dir)
    try:
        # the step synchronises the device, so step_time_s is its whole
        # work and data_time_s the wait for the next batch
        timer = StepTimer(device)
        for step in range(state.step, cfg.num_train_steps):
            batch = _to_device(next(it), device)
            timer.data_done()
            state, metrics = train_step(state, frozen, batch, cfg.seed)
            timer.step_done()
            if (step + 1) % args.logging_steps == 0:
                loss, gnorm = (float(metrics[k])
                               for k in ("loss", "grad_norm"))
                log.info("step %d loss %.4f gnorm %.3f step_time %.3fs "
                         "data_time %.3fs", step + 1, loss, gnorm,
                         timer.step_time, timer.data_time)
                tracker.log(step + 1, {
                    "loss": loss,
                    "grad_norm": gnorm,
                    "step_time_s": timer.step_time,
                    "data_time_s": timer.data_time,
                    "images_per_sec": cfg.train_batch_size
                    / max(timer.step_time, 1e-9),
                })
            if (step + 1) % cfg.checkpointing_steps == 0:
                t0 = time.perf_counter()
                ckpt.save(state, {"step": step + 1})
                log.info("checkpoint saved at %d (%.2fs in the loop)",
                         step + 1, time.perf_counter() - t0)
                timer = StepTimer(device)  # the save is not data time
        ckpt.save(state, {"step": state.step})
        ckpt.wait()
    finally:
        it.close()
        tracker.close()
    log.info("training done")
    return state


if __name__ == "__main__":
    main()
