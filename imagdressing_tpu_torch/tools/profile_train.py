"""Device-time breakdown of one training step on a CUDA card (the port's
counterpart of `bench_train.py`'s profile, with `torch.profiler`).

Random weights at full SD1.5 width (the FLOPs and bytes of real
checkpoints): bf16 frozen models, fp32 master weights of the trainables,
block remat, batch 1. Two warm steps (the first has learning rate 0), then
one step under the profiler. Prints one JSON object: the step's wall time,
the device's busy share of it, device time and launches by kernel class
(the port's kernels by name, cuDNN, cuBLAS, the rest) and the costliest
kernels.

Usage (on the card's machine, from the repository root):
    python -m imagdressing_tpu_torch.tools.profile_train [WxH] [batch]
"""

from __future__ import annotations

import json
import sys
import time
from collections import defaultdict

from imagdressing_tpu_torch.tools.profile_infer import classify

# the training kernels, checked before the inference classes (K5 is the
# residual mode of K1's kernel template, its last template argument true)
TRAIN_CLASSES = (
    ("K5 flash_fwd_res", ("flash_fwd_wgmma<", ", true>")),
    ("K6a flash_bwd_dkv", ("flash_bwd_dkv",)),
    ("K6b flash_bwd_dq", ("flash_bwd_dq",)),
)


def classify_train(name: str) -> str:
    for label, marks in TRAIN_CLASSES:
        if all(m in name for m in marks):
            return label
    return classify(name)


def main(size: str = "512x640", batch: int = 1) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from imagdressing_tpu_torch.core.config import TrainConfig
    from imagdressing_tpu_torch.pipelines.dressing import DressingModels
    from imagdressing_tpu_torch.train import step as tstep

    w, h = (int(t) for t in size.split("x"))
    models = DressingModels.init_random(0).cast_for_training(torch.bfloat16)
    cfg = TrainConfig(train_batch_size=batch, warmup_steps=2)
    state, frozen, tx = tstep.init_train_state(models, cfg)
    step = tstep.make_train_step(models, cfg, tx)
    gen = torch.Generator(device="cuda").manual_seed(0)
    data = {
        "person_image": torch.rand((batch, h, w, 3), generator=gen,
                                   device="cuda") * 2 - 1,
        "cloth_image": torch.rand((batch, h, w, 3), generator=gen,
                                  device="cuda") * 2 - 1,
        "cloth_clip": torch.randn((batch, 224, 224, 3), generator=gen,
                                  device="cuda"),
        "text_ids": torch.randint(0, 49408, (batch, 77), generator=gen,
                                  device="cuda"),
    }
    for _ in range(2):
        state, metrics = step(state, frozen, data, seed=0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, metrics = step(state, frozen, data, seed=0)
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_kernel = {}
    by_class = defaultdict(float)
    class_launches = defaultdict(int)
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0.0)
        if us <= 0:
            continue
        by_kernel[e.key] = (us / 1e3, e.count)
        by_class[classify_train(e.key)] += us / 1e3
        class_launches[classify_train(e.key)] += e.count
    device_ms = sum(by_class.values())
    if device_ms <= 0:
        raise RuntimeError("the profiler recorded no device time")
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:20]
    result = dict(
        device=torch.cuda.get_device_name(0), size=size, batch=batch,
        loss=loss, wall_ms=wall * 1e3, device_ms=device_ms,
        device_busy_share=device_ms / (wall * 1e3),
        class_ms=dict(sorted(by_class.items(), key=lambda kv: -kv[1])),
        class_launches=dict(class_launches),
        top_kernels=[dict(name=k[:120], ms=ms, calls=n)
                     for k, (ms, n) in top])
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    args = sys.argv[1:]
    main(*args[:1], *(int(a) for a in args[1:2]))
