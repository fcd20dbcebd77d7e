"""Device-time breakdown of one try-on of a preset on a CUDA card (the
port's counterpart of `imagdressing_tpu/tools/profile_infer.py`, with
`torch.profiler` in place of `jax.profiler`).

Random bf16 weights at full SD1.5 width (the FLOPs and bytes of real
checkpoints); for the ControlNet presets its zero-initialised output convs
are filled with random values. One warm call, then one call under the
profiler. Prints one JSON object: wall time, per-stage wall times, the
device's busy share of the wall window, device time and launches by kernel
class, device time by kernel, for the ControlNet presets the device time of
one ControlNet call and of one main-UNet call at the run's CFG batch
(CUDA-graph replays) with the ControlNet's share of the run's device time,
and, for the kernels with many shapes (K1, K2, K3), each shape's launches
in that call,
its device time (CUDA-graph replays of the call: the deep UNet shapes take
less device time than host time), achieved TFLOP/s and bound (the largest
of tensor FLOPs over 989 TFLOP/s, bytes over 3.35 TB/s and, for K1, one
exp2 per (q, k) pair and source run over the special-function units), and
the plan: K2's pixel tile, N width and K splits and its GroupNorm
prologue's mode, cluster and slab, K1's rows, keys per tile and ring depth,
K3's mode, cluster and slab.

Usage (on the card's machine, from the repository root):
    python -m imagdressing_tpu_torch.tools.profile_infer [WxH] [steps]
        [--preset basic|cartoon|pose|ipa_pose|inpaint] [--batch B]
(the size defaults to the preset's: 512x640, inpaint 512x512; B images per
call, default 1: the UNet runs at the CFG batch 2B)
"""

from __future__ import annotations

import argparse
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
        qkv.append(torch.tensor(_ref_scale(b), device="cuda"))
    return lambda: flash_attention(*qkv)


def _ref_scale(b):
    """The garment scales of a dual call: an even batch is a CFG batch
    [0 (uncond) x b/2, 1 (cond) x b/2], an odd one all 1 (training)."""
    return [0.0] * (b // 2) + [1.0] * (b // 2) if b % 2 == 0 else [1.0] * b


def _flash_flops(b, s, h, d, dual):
    return 4.0 * d * _flash_exp2(b, s, h, d, dual)


def _flash_exp2(b, s, h, d, dual):
    # one per (q, k) pair and source run; the scale-0 rows of a CFG batch
    # skip the garment pass
    ref_rows = sum(x != 0 for x in _ref_scale(b)) if dual else 0
    return float(h * s * s * (b + ref_rows))


def _flash_plan(b, s, h, d, dual):
    from imagdressing_tpu_torch.kernels.flash_attention import flash_plan

    p = flash_plan(b, s, h, d, dual)
    return {"plan": dict(rows=p.rows, bkv=p.bkv, stages=p.stages, dn=p.dn)}


def fill_zero_convs(controlnet, seed: int = 1) -> None:
    """Random values (each conv's own init) in the ControlNet's
    zero-initialised output convs, so that its residuals are not zero."""
    import torch

    gen = torch.Generator(device=controlnet.conv_in.weight.device)
    gen.manual_seed(seed)
    for conv in (controlnet.controlnet_cond_embedding.conv_out,
                 controlnet.controlnet_mid_block,
                 *controlnet.controlnet_down_blocks):
        conv.reset_parameters(gen)


def preset_models(preset):
    """Full-width bf16 random models for `preset`: with the ControlNet (its
    zero convs filled) and the IP adapters where the preset runs them."""
    import torch

    from imagdressing_tpu_torch.pipelines.dressing import DressingModels

    models = DressingModels.init_random(
        0, with_controlnet=preset.use_controlnet, with_ipa=preset.use_ipa)
    if models.controlnet is not None:
        fill_zero_convs(models.controlnet)
    return models.cast(torch.bfloat16)


def preset_inputs(b: int, h: int, w: int, clip_size: int = 224,
                  id_dim: int = 512, vocab: int = 49408,
                  seed: int = 0) -> dict:
    """Random inputs of every preset, numpy from `seed`: prompts, garment,
    pose (the ControlNet's condition), face embedding and crop, person, and
    a mask box over the upper middle of the image (1 = regenerate)."""
    rng = np.random.default_rng(seed)
    mask = np.zeros((b, h, w, 1), np.float32)
    mask[:, h // 8:5 * h // 8, w // 4:3 * w // 4] = 1.0
    return dict(prompt_ids=rng.integers(0, vocab, (b, 77)),
                negative_prompt_ids=rng.integers(0, vocab, (b, 77)),
                ref_image=rng.uniform(-1, 1, (b, h, w, 3)),
                ref_clip_image=rng.standard_normal((b, clip_size, clip_size,
                                                    3)),
                pose_image=rng.uniform(0, 1, (b, h, w, 3)),
                faceid_embeds=rng.standard_normal((b, id_dim)),
                face_clip_image=rng.standard_normal((b, clip_size, clip_size,
                                                     3)),
                person_image=rng.uniform(-1, 1, (b, h, w, 3)),
                mask_image=mask)


def _unet_calls(models, h: int, w: int, ipa: bool):
    """(one ControlNet call, one main-UNet call) at a CFG batch of 2 and the
    latent size of an h x w image as the loop runs them: text K/V hoisted,
    garment K/V with scales [0, 1], the residuals, and with `ipa` the 4 face
    tokens' K/V (random conditioning of the run's shapes)."""
    import torch

    from imagdressing_tpu_torch.models.conditioning import Conditioning
    from imagdressing_tpu_torch.models.unet import (
        attn_layer_dims,
        attn_layer_names,
        precompute_cross_kv,
    )

    def layer_kv(which, tokens):
        dims = attn_layer_dims(models.unet_cfg)
        return {n: tuple(torch.randn((2, tokens(n), dims[n]), device="cuda",
                                     dtype=dt) for _ in range(2))
                for n in attn_layer_names(models.unet_cfg, which)}

    def latent_tokens(name):
        parts, n = name.split("."), len(models.unet_cfg.block_out_channels)
        level = {"down_blocks": lambda: int(parts[1]),
                 "up_blocks": lambda: n - 1 - int(parts[1]),
                 "mid_block": lambda: n - 1}[parts[0]]()
        return ((h // 8) >> level) * ((w // 8) >> level)

    dt = models.dtype
    cn = models.controlnet
    with torch.inference_mode():
        lat = torch.randn((2, h // 8, w // 8, 4), device="cuda", dtype=dt)
        text = torch.randn((2, 77, models.text_cfg.hidden_size),
                           device="cuda", dtype=dt)
        t = torch.tensor(500, device="cuda")
        emb = cn.cond_embedding(torch.rand((2, h, w, 3), device="cuda"))
        cn_cond = Conditioning(cross_kv=precompute_cross_kv(cn, text))
        down, mid = cn(lat, t, text, cond_emb=emb, cond=cn_cond)
        cond = Conditioning(
            ref_kv=layer_kv("attn1", latent_tokens),
            ref_scale=torch.tensor([0.0, 1.0], device="cuda"),
            ip_kv=layer_kv("attn2", lambda n: 4) if ipa else None,
            ip_scale=torch.full((2,), 0.9, device="cuda"),
            cross_kv=precompute_cross_kv(models.unet, text),
            down_block_residuals=down, mid_block_residual=mid)

    def controlnet():
        with torch.inference_mode():
            return cn(lat, t, text, cond_emb=emb, cond=cn_cond)

    def unet():
        with torch.inference_mode():
            return models.unet(lat, t, text, cond)

    return controlnet, unet


def main(size: str = None, steps: int = 30, preset: str = "basic",
         batch: int = 1) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from imagdressing_tpu_torch.core.config import PRESETS
    from imagdressing_tpu_torch.kernels import flash_attention as fa
    from imagdressing_tpu_torch.kernels import fused_gn_conv as fgc
    from imagdressing_tpu_torch.kernels import fused_groupnorm as fg
    from imagdressing_tpu_torch.pipelines.dressing import DressingPipeline
    from imagdressing_tpu_torch.tools.timing import cuda_graph_ms

    base = PRESETS[preset]
    w, h = ((int(t) for t in size.split("x")) if size
            else (base.width, base.height))
    size = f"{w}x{h}"
    cfg = dataclasses.replace(base, height=h, width=w,
                              num_inference_steps=steps)
    models = preset_models(cfg)
    pipe = DressingPipeline(models, cfg)
    kw = dict(preset_inputs(batch, h, w), output_uint8=True)
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
        device=torch.cuda.get_device_name(0), preset=preset, size=size,
        steps=steps, batch=batch,
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
    if cfg.use_controlnet:  # after the shape rows: this launches too
        # a step outside the ControlNet's window runs no ControlNet call;
        # the default window keeps every used step
        used = steps - (max(steps - int(steps * cfg.strength), 0)
                        if cfg.use_inpaint else 0)
        controlnet, unet = _unet_calls(models, h, w, cfg.use_ipa)
        cn_ms, unet_ms = (cuda_graph_ms(f, calls=3, replays=5)
                          for f in (controlnet, unet))
        result.update(used_steps=used, controlnet_call_ms=cn_ms,
                      unet_call_ms=unet_ms,
                      controlnet_share=used * cn_ms / device_ms)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("size", nargs="?", help="WxH (default: the preset's)")
    ap.add_argument("steps", nargs="?", type=int, default=30)
    ap.add_argument("--preset", default="basic")
    ap.add_argument("--batch", type=int, default=1,
                    help="images per call (the server batches up to 4)")
    a = ap.parse_args(sys.argv[1:])
    main(a.size, a.steps, a.preset, a.batch)
