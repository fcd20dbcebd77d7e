"""Device-time breakdown of one SCHP fine-tune step on a CUDA card, with
the share of its training-mode ABNs (`torch.profiler`).

The full-width SCHP (ResNet-101 AugmentCE2P, random weights, 18 classes)
at SIZE x SIZE, fp32 with cuDNN's default TF32 convs, batch B, through
`train.parsing_train.make_parsing_train_step`: two warm steps, then one
under the profiler. Then the step's 119 ABNs alone: `abn_train_stats`
forward and backward at the shapes the step gave them (recorded by forward
hooks), replayed under the profiler. Prints one JSON object: the step's
wall and device time, busy share, device ms and launches by kernel class,
the costliest kernels, and the ABNs' device ms and launches split into
K7 and the rest (the plain-torch moments and backward).

Usage (on the card's machine, from the repository root):
    python -m imagdressing_tpu_torch.tools.profile_parse_train [SIZE] [B]
"""

from __future__ import annotations

import json
import sys
import time
from collections import defaultdict

from imagdressing_tpu_torch.tools.profile_infer import classify


def _device_ms(prof):
    """{kernel name: (ms, launches)} of a profile's device work."""
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0.0)
        if us > 0:
            out[e.key] = (us / 1e3, e.count)
    return out


def main(size: int = 473, batch: int = 1) -> dict:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from imagdressing_tpu_torch.kernels.fused_bn_act import abn_train_stats
    from imagdressing_tpu_torch.preprocess.parsing import model as schp
    from imagdressing_tpu_torch.train import parsing_train as pt

    net = schp.init(0, schp.NUM_CLASSES_ATR).requires_grad_(True)
    cfg = pt.ParsingTrainConfig(total_steps=100)
    step = pt.make_parsing_train_step(cfg, net, pt.make_optimizer(cfg, net))
    rng = np.random.default_rng(0)
    label = rng.integers(0, schp.NUM_CLASSES_ATR, (batch, size, size))
    data = {"image": torch.randn(batch, size, size, 3, device="cuda"),
            "label": torch.from_numpy(label).cuda(),
            "edge": torch.from_numpy(pt.edges_from_labels(label)).cuda()}
    shapes = []
    hooks = [m.register_forward_hook(
        lambda mod, args, out: shapes.append(
            (tuple(args[0].shape), mod.activation)))
        for m in net.modules() if isinstance(m, schp.ABN)]
    for i in range(2):
        step(i, data)
    for h in hooks:
        h.remove()
    shapes = shapes[:len(hooks)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loss = float(step(2, data)["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = _device_ms(prof)
    by_class, launches = defaultdict(float), defaultdict(int)
    for name, (ms, n) in kernels.items():
        by_class[classify(name)] += ms
        launches[classify(name)] += n
    device_ms = sum(by_class.values())
    if device_ms <= 0:
        raise RuntimeError("the profiler recorded no device time")

    # the ABNs alone, forward and backward, at the step's shapes
    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs = []
    for shape, act in shapes:
        c = shape[-1]
        leaves = [torch.randn(shape, generator=gen, device="cuda"),
                  torch.ones(c, device="cuda"), torch.zeros(c, device="cuda")]
        inputs.append(([t.requires_grad_() for t in leaves], act,
                       torch.randn(shape, generator=gen, device="cuda")))

    def abns():
        for leaves, act, g in inputs:
            y, _, _ = abn_train_stats(*leaves, activation=act)
            y.backward(g)

    abns()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        abns()
        torch.cuda.synchronize()
    abn = _device_ms(prof)
    k7 = [v for k, v in abn.items() if "bn_act" in k]
    rest = [v for k, v in abn.items() if "bn_act" not in k]
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:20]
    result = dict(
        device=torch.cuda.get_device_name(0), size=size, batch=batch,
        loss=loss, wall_ms=wall * 1e3, device_ms=device_ms,
        device_busy_share=device_ms / (wall * 1e3),
        class_ms=dict(sorted(by_class.items(), key=lambda kv: -kv[1])),
        class_launches=dict(launches), abns=len(shapes),
        abn_k7_ms=sum(v[0] for v in k7), abn_k7_launches=sum(
            v[1] for v in k7),
        abn_plain_ms=sum(v[0] for v in rest),
        abn_plain_launches=sum(v[1] for v in rest),
        top_kernels=[dict(name=k[:120], ms=ms, calls=n)
                     for k, (ms, n) in top])
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    args = [int(a) for a in sys.argv[1:3]]
    main(*args)
