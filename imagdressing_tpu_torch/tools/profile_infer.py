"""Device-time breakdown of one `basic` try-on on a CUDA card (the port's
counterpart of `imagdressing_tpu/tools/profile_infer.py`, with
`torch.profiler` in place of `jax.profiler`).

Random bf16 weights at full SD1.5 width (the FLOPs and bytes of real
checkpoints). One warm call, then one call under the profiler. Prints one
JSON object: wall time, per-stage wall times, the device's busy share of
the wall window, device time and launches by kernel class, device time by
kernel, and, for the kernels with many shapes (K1, K2, K3), each shape's
launches in that call,
its device time (CUDA-graph replays of the call: the deep UNet shapes take
less device time than host time), achieved TFLOP/s and bound (the largest
of tensor FLOPs over 989 TFLOP/s, bytes over 3.35 TB/s and, for K1, one
exp2 per (q, k) pair and source run over the special-function units), and
the plan: K2's pixel tile, N width and K splits and its GroupNorm
prologue's mode, cluster and slab, K1's rows, keys per tile and ring depth,
K3's mode, cluster and slab.

Usage (on the card's machine, from the repository root):
    python -m imagdressing_tpu_torch.tools.profile_infer [WxH] [steps]
"""

from __future__ import annotations

import dataclasses
import json
import math
import sys
import time
from collections import defaultdict

import numpy as np

# kernel-name markers, checked in order (cuDNN's conv kernels are also
# implicit GEMMs, so convolution markers come before the GEMM ones)
CLASSES = (
    ("K1 flash_fwd_wgmma", ("flash_fwd_wgmma",)),
    ("K1 flash_fwd_f32", ("flash_fwd_f32",)),
    ("K2 split-K reduce", ("splitk_reduce",)),
    ("K2 conv (wgmma; fp32 SIMT)", ("gn_conv3x3",)),
    ("GN statistics + normalize, resident (K3, K2's prologue)",
     ("gn_resident",)),
    ("GN statistics, streaming (VAE pixel levels)", ("gn_stream_stats",)),
    ("GN normalize, streaming", ("gn_apply",)),
    ("cuDNN convolution", ("fprop", "conv", "winograd")),
    ("cuBLAS GEMM", ("gemm", "nvjet", "cutlass", "cublas")),
)


def classify(name: str) -> str:
    low = name.lower()
    for label, marks in CLASSES:
        if any(m in low for m in marks):
            return label
    return "elementwise / norm / copy"


HBM_BYTES_PER_MS = 3.35e9  # H100 SXM, NVIDIA data sheet
BF16_FLOPS_PER_MS = 989e9  # dense bf16 tensor cores, same source
# exp2 on the special-function units: 132 SMs x 16 per clock at the H100's
# maximum SM clock, 1980 MHz (`nvidia-smi --query-gpu=clocks.max.sm`)
EXP2_PER_MS = 132 * 16 * 1.98e6


def _shape_rows(counter, make_call, flops, nbytes, extra=lambda *k: {},
                exp2=lambda *k: 0.0):
    """Per launch shape of one kernel: launches, device ms per launch (CUDA
    graph replays), the total, the achieved TFLOP/s and the bound with its
    terms (tensor FLOPs, bytes, exp2 evaluations), the costliest shape
    first."""
    from imagdressing_tpu_torch.tools.timing import cuda_graph_ms

    rows = []
    for key, n in counter.by_shape.items():
        ms = cuda_graph_ms(make_call(*key), calls=10, replays=10)
        terms = {"tensor": flops(*key) / BF16_FLOPS_PER_MS,
                 "bytes": nbytes(*key) / HBM_BYTES_PER_MS,
                 "exp2": exp2(*key) / EXP2_PER_MS}
        rows.append(dict(shape=list(key), launches=n, ms=ms, total_ms=ms * n,
                         tflops=flops(*key) / ms / 1e9,
                         bound_ms=max(terms.values()), bound_terms_ms=terms,
                         **extra(*key)))
    return sorted(rows, key=lambda r: -r["total_ms"])


def _conv_bytes(b, h, w, cin, co):
    # bf16 x, weights and out, each once
    return 2.0 * (b * h * w * (cin + co) + 9 * cin * co)


def _conv_plan(b, h, w, cin, co):
    import torch

    from imagdressing_tpu_torch.kernels.fused_gn_conv import conv_plan
    from imagdressing_tpu_torch.kernels.fused_groupnorm import gn_plan

    p = conv_plan(b, h, w, cin, co)
    g = gn_plan(b, h * w, cin, 32, torch.bfloat16, "silu")
    return dict(plan=dict(tw=p.tw, th=p.th, bn=p.bn, splits=p.splits,
                          blocks=p.blocks),
                gn_plan=dict(resident=g.resident, cs=g.cs, sw=g.sw,
                             blocks=g.blocks))


def _gn_bytes(shape, act):
    # bf16 x read and y written, each once
    return 4.0 * math.prod(shape)


def _gn_plan(shape, act):
    import torch

    from imagdressing_tpu_torch.kernels.fused_groupnorm import gn_plan

    b, c = shape[0], shape[-1]
    g = gn_plan(b, math.prod(shape) // (b * c), c, 32, torch.bfloat16, act)
    return dict(plan=dict(resident=g.resident, cs=g.cs, sw=g.sw,
                          blocks=g.blocks))


def _gn_call(shape, act):
    import torch

    from imagdressing_tpu_torch.kernels.fused_groupnorm import group_norm_act

    x = torch.randn(shape, device="cuda", dtype=torch.bfloat16)
    w, b = (torch.randn(shape[-1], device="cuda", dtype=torch.bfloat16)
            for _ in range(2))
    return lambda: group_norm_act(x, w, b, num_groups=32, eps=1e-6, act=act)


def _flash_bytes(b, s, h, d, dual):
    # bf16 q, k, v (k_ref, v_ref) read and out written
    return 2.0 * b * s * h * d * (6 if dual else 4)


def _conv_call(b, h, w, cin, co):
    import torch

    from imagdressing_tpu_torch.kernels.fused_gn_conv import gn_silu_conv3x3

    def t(*shape):
        return torch.randn(shape, device="cuda", dtype=torch.bfloat16)

    x, wt = t(b, h, w, cin), t(co, cin, 3, 3).contiguous(
        memory_format=torch.channels_last)
    gw, gb, cb, add = t(cin), t(cin), t(co), t(b, cin)
    return lambda: gn_silu_conv3x3(x, gw, gb, wt, cb, num_groups=32,
                                   eps=1e-5, add=add)


def _flash_call(b, s, h, d, dual):
    import torch

    from imagdressing_tpu_torch.kernels.flash_attention import flash_attention

    qkv = [torch.randn((b, s, h, d), device="cuda", dtype=torch.bfloat16)
           for _ in range(5 if dual else 3)]
    if dual:
        qkv.append(torch.tensor([0.0, 1.0] if b == 2 else [1.0] * b,
                                device="cuda"))
    return lambda: flash_attention(*qkv)


def _flash_flops(b, s, h, d, dual):
    return 4.0 * d * _flash_exp2(b, s, h, d, dual)


def _flash_exp2(b, s, h, d, dual):
    # one per (q, k) pair and source run; _flash_call's scales: a batch of 2
    # is a CFG batch [0, 1], whose scale-0 row skips the garment pass
    ref_rows = (1 if b == 2 else b) if dual else 0
    return float(h * s * s * (b + ref_rows))


def _flash_plan(b, s, h, d, dual):
    from imagdressing_tpu_torch.kernels.flash_attention import flash_plan

    p = flash_plan(b, s, h, d, dual)
    return {"plan": dict(rows=p.rows, bkv=p.bkv, stages=p.stages, dn=p.dn)}


def main(size: str = "512x640", steps: int = 30) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from imagdressing_tpu_torch.core.config import PRESETS
    from imagdressing_tpu_torch.kernels import flash_attention as fa
    from imagdressing_tpu_torch.kernels import fused_gn_conv as fgc
    from imagdressing_tpu_torch.kernels import fused_groupnorm as fg
    from imagdressing_tpu_torch.pipelines.dressing import (
        DressingModels,
        DressingPipeline,
    )

    w, h = (int(t) for t in size.split("x"))
    models = DressingModels.init_random(0).cast(torch.bfloat16)
    preset = dataclasses.replace(PRESETS["basic"], height=h, width=w,
                                 num_inference_steps=steps)
    pipe = DressingPipeline(models, preset)
    rng = np.random.default_rng(0)
    kw = dict(prompt_ids=rng.integers(0, 49408, (1, 77)),
              negative_prompt_ids=rng.integers(0, 49408, (1, 77)),
              ref_image=rng.uniform(-1, 1, (1, h, w, 3)),
              ref_clip_image=rng.standard_normal((1, 224, 224, 3)),
              output_uint8=True)
    pipe(**kw)  # warm: kernel build, library handles, allocator
    for counter in (fa.COUNTER, fgc.COUNTER, fg.COUNTER):
        counter.reset()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe(**kw)
        wall = time.perf_counter() - t0
    by_kernel = {}
    by_class = defaultdict(float)
    class_launches = defaultdict(int)
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0.0)
        if us <= 0:
            continue
        by_kernel[e.key] = (us / 1e3, e.count)
        by_class[classify(e.key)] += us / 1e3
        class_launches[classify(e.key)] += e.count
    device_ms = sum(by_class.values())
    if device_ms <= 0:
        raise RuntimeError("the profiler recorded no device time")
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:15]
    result = dict(
        device=torch.cuda.get_device_name(0), size=size, steps=steps,
        wall_ms=wall * 1e3, device_ms=device_ms,
        device_busy_share=device_ms / (wall * 1e3),
        stage_ms={k: v * 1e3 for k, v in pipe.last_stage_seconds.items()},
        class_ms=dict(sorted(by_class.items(), key=lambda kv: -kv[1])),
        class_launches=dict(class_launches),
        top_kernels=[dict(name=k[:120], ms=ms, calls=n)
                     for k, (ms, n) in top],
        gn_conv_shapes=_shape_rows(
            fgc.COUNTER, _conv_call,
            lambda b, h, w, cin, co: 2.0 * b * h * w * 9 * cin * co,
            _conv_bytes, _conv_plan),
        flash_shapes=_shape_rows(fa.COUNTER, _flash_call, _flash_flops,
                                 _flash_bytes, _flash_plan, _flash_exp2),
        group_norm_shapes=_shape_rows(fg.COUNTER, _gn_call,
                                      lambda *k: 0.0, _gn_bytes, _gn_plan))
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    args = sys.argv[1:]
    main(*args[:1], *(int(a) for a in args[1:2]))
