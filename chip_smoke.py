#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`imagdressing_tpu_torch`) on one CUDA card.

Phases, each printing one line:
  1. device: the card's name, count, and `nvidia-smi` name and power limit;
  2. build: the CUDA kernels, compiled from `imagdressing_tpu_torch/kernels/
     csrc` with one nvcc per source, all at once;
  3. check: every kernel against its plain PyTorch version on the card, in
     bf16 and fp32, at the main paths' shapes: the inference kernels (K1
     also at ragged lengths and with 2S keys, K1-K3 also at the inpaint
     preset's 512x512 levels), the training forward with residuals and both
     backward kernels (with K6b's D_i, and at ragged lengths), the GN+conv
     at the deep UNet levels (split K) and at a ragged shape, and the
     gradients of the GN+conv and GroupNorm autograd Functions, K3 at the
     four UNet levels at batch 2 and 1, with the temb fold, at a ragged
     shape and at a VAE pixel level (streaming); K1-K4 at the shapes of a
     served batch of 4 images (the CFG batch 8 of the UNet, batch 4 of the
     VAE; also timed); then determinism: K1, K5,
     the backward pair, the GN+conv (split K, not, and streaming) and K3
     (resident and streaming) twice on the same inputs must give
     bit-identical results;
  4. mini: a small fp32 stack run end to end on the card and on the CPU (the
     CPU runs every kernel's plain version): the outputs must agree; then
     mini_presets: the same with a perturbed ControlNet and IP adapters for
     `pose`, `ipa_pose`, `inpaint` and `pose` with UniPC;
  5. mini_train: two training steps of the same small stack on the card and
     on the CPU with the same random draws: losses, gradient norms and the
     trained weights must agree;
  6. time: each kernel's CUDA-event time at a main-path shape, beside its
     plain version's, the PyTorch library call's, and the card's bound
     (bytes, tensor-core FLOPs, and for the flash kernels exp2 per (q, k)
     pair); the backward pair's time beside its function's bound; the
     GN+conv also at the deep UNet shapes where its time goes, with its
     GN+SiLU prologue timed alone and the plan (tiles, K splits) of each;
     K3 at the four UNet levels with F.group_norm beside it; K1
     at every level of the main path and at D = 512, K5 at every training
     level (CUDA-graph replays, eager times beside);
  7. main: the `basic` preset through DressingModels / DressingPipeline at
     full SD1.5 width, 512x640, bf16, 30 DDIM steps, with per-stage wall
     times, peak memory, and each kernel's launches in that run (K1's and
     K2's by shape);
  7b. presets: `cartoon`, `pose`, `ipa_pose` (512x640) and `inpaint`
     (512x512) the same way, one stack with a ControlNet (its zero convs
     filled) and the IP adapters: per preset the launches of a counted run
     against the count derived from the code, and probes (same seed, same
     image; another pose, face or ControlNet scale, another image);
  8. train: the training step (`train.step`) at full SD1.5 width, 512x640,
     batch 1, bf16 frozen models and fp32 master weights, block remat: one
     warm step, then TRAIN_STEPS timed steps with s/step, peak memory, the
     loss and gradient norm of each step and each kernel's launches (as
     derived in `expected_train_launches`);
  8b. remat: the same step from the same weights, batch and draws under
     each remat policy (full, dots, names, heavy, none): the loss equal
     across policies, the gradient norm within 1e-3 of full's, peak memory,
     s/step and the launches per step as derived (names / heavy launch no
     K5 and no GN+conv forward in the recompute);
  9. parse_check: the SCHP human parser (ATR 512 + LIP 473, ResNet-101 at
     full width, random weights) on a 200x150 photo on the card and on the
     CPU with the same weights: the logits of both nets and the parse maps
     must agree (TF32 off);
 10. parse: `Parsing.__call__` at full width on a 1024x768 synthetic person
     photo, cuDNN's default TF32 convs: one warm call, one counted call
     (K7's launches), then PARSES timed calls with the median wall time, the
     device time of both forwards, the host refinement's time, peak memory;
 11. load: the full-width `basic` stack in bf16 written as the reference's
     checkpoint files (`tools/write_checkpoints.py`) into a temporary
     directory of the checkout and loaded back by `apps.loader.
     load_dressing_models(..., device="cuda")`: every parameter bit-equal;
     write s, load s, peak host RSS and device memory of the load;
 12. serve: the port's HTTP server (`apps.serve`) over the loaded stack,
     `basic` 512x640, STEPS steps: 4 concurrent requests answered by one
     batch-4 pipeline call (launches exactly `expected_launches`), bit-equal
     to a direct call on the same arrays; other seeds in their own rounds;
     the batch-4 latency, images per minute, stage times, peak memory;
 13. dress: `apps.dress.main` on a folder of 5 PNG garments at batch 4 (one
     chunk padded), loading from the same files: 5 collages, wall per chunk;
 13b. train_cli: `apps.train_cli.main` from the same base files on a
     written manifest of 4 JPEG person / garment pairs (4 steps,
     checkpoints every 2, TensorBoard), a resumed run to step 6, and
     `apps.dress.main --trained_ckpt` beside the base stack's image: the
     metrics, checkpoints, the bit-equal step-4 state, the merge and the
     launches per step and per image; the decoder used, s/step, data time,
     peak memory;
 14. openpose_check: the OpenPose body, hand and face nets at full width,
     random weights, on the card and on the CPU (TF32 off): their maps and
     keypoints;
 15. person: `preprocess/mask.person_upper_body_mask` from the written
     preprocessing checkpoints (`write_checkpoints --preprocess`) on a
     600x460 photo, card vs CPU, then timed stages (OpenPose, parse, mask);
 16. dress_person: `apps.dress.main --preset inpaint --model_dir --cloth_dir`
     (2 persons x 2 garments) with a written ControlNet: 4 collages, K1-K4
     launches as derived, K7 once per person;
 17. serve_fusion: the server with `--post_process face_fusion:<facenet>`,
     one request with a face and one without, against direct calls;
 18. parse_train: `apps.parsing_cli train` at its defaults (SCHP ResNet-101
     at full width, 18 classes, 473x473) on 8 synthetic 600x460 JPEG /
     label pairs, 6 steps at batch 1 and 4 at batch 4: s/step, peak
     memory, the losses, the running statistics, K7's 119 launches a step;
     and 2 steps at 64x64 card vs CPU (TF32 off);
 19. parse_eval: `apps.parsing_cli eval --flip --scales 0.75,1.0,1.25` on
     the fine-tuned params.npz: mIoU, s/image, the PNGs, K7's launches
     exactly 714 per image;
 20. eval: `eval.cli cami-u` over the dress phase's garments and results,
     `eval.cli cami-s-grid` (2 prompts x 2 poses x 2 faces x 2 garments)
     with a random full-width CLIP ViT-B/32, the written OpenPose and a
     fixed face embedder; CLIP embed and OpenPose times.
(abn_train_check runs right after check: the training-mode ABN forward and
backward on the card at SCHP's shapes against the CPU in float64.)
Then the per-kernel JSON line, the `nvidia-smi` line, and as the last line
{"ok": true, "device": {...}}. Any failure exits non-zero before that line.
Without a card, or without the rest of the repository, it exits non-zero.

Usage, from the repository root: python3 chip_smoke.py
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
STEPS = 30
TRAIN_STEPS = 6
PARSES = 5
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BF16_FLOPS_PER_S = 989e12  # dense bf16 tensor cores, same source
FP32_FLOPS_PER_S = 67e12  # fp32 outside the tensor cores, same source
TOL = {"bf16": (1e-2, 1e-2), "fp32": (2e-4, 1e-4)}  # atol, rtol * max|ref|
# the base-2 log-sum-exp: fp32 scores in both versions, so sum order only
LSE_TOL = 1e-3
# K6b's D_i: fp32 sums of D products of the same inputs in both versions,
# so sum order only (atol, rtol * max|ref|)
DELTA_TOL = (1e-5, 1e-5)
# exp2 per clock per SM (the special-function units), H100
EXP2_PER_CLOCK_PER_SM = 16
SMS = 132
REPLACES = {
    "flash_fwd": "imagdressing_tpu/kernels/flash_attention.py:98",
    "gn_silu_conv3x3": "imagdressing_tpu/kernels/fused_gn_conv.py:55",
    "gn_silu_conv3x3[vae_pixel]": "imagdressing_tpu/kernels/fused_gn_conv.py:345",
    "group_norm_act": "imagdressing_tpu/kernels/fused_groupnorm.py:57",
    "flash_fwd_res": "imagdressing_tpu/kernels/flash_attention.py:239",
    "flash_bwd_dkv": "imagdressing_tpu/kernels/flash_attention.py:425",
    "flash_bwd_dq": "imagdressing_tpu/kernels/flash_attention.py:507",
    "bn_act": "imagdressing_tpu/kernels/fused_bn_act.py:75",
}
SOURCES = {
    "flash_fwd": "imagdressing_tpu_torch/kernels/csrc/flash_fwd.cu",
    "gn_silu_conv3x3": "imagdressing_tpu_torch/kernels/csrc/gn_conv.cu",
    "gn_silu_conv3x3[vae_pixel]":
        "imagdressing_tpu_torch/kernels/csrc/gn_conv.cu",
    "group_norm_act": "imagdressing_tpu_torch/kernels/csrc/groupnorm.cu",
    "flash_fwd_res": "imagdressing_tpu_torch/kernels/csrc/flash_fwd.cu",
    "flash_bwd_dkv": "imagdressing_tpu_torch/kernels/csrc/flash_bwd.cu",
    "flash_bwd_dq": "imagdressing_tpu_torch/kernels/csrc/flash_bwd.cu",
    "bn_act": "imagdressing_tpu_torch/kernels/csrc/bn_act.cu",
}


class SmokeFailure(Exception):
    pass


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi(query: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def exp2_per_ms() -> float:
    """The card's exp2 rate per ms at its maximum SM clock."""
    mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    return SMS * EXP2_PER_CLOCK_PER_SM * mhz * 1e3


# ---------------------------------------------------------------------------
# Kernel cases at the main path's shapes
# ---------------------------------------------------------------------------


def flash_case(b, s, h, d, dual, dtype, seed, lengths=None, scale=None):
    """K1 against its plain version; library: two SDPA calls and the scaled
    sum. `lengths` (Sq, Skv, Sref) for ragged sequences, else all s;
    `scale` the ref scales (default the CFG layout: [0, 1] at batch 2,
    [0, 0, 0, 0, 1, 1, 1, 1] at the CFG batch 8 of four images).
    graph=True: the device time comes from CUDA-graph replays (eager times
    beside it); the plain version stays eager (tens of ms, device-bound)."""
    import torch

    from imagdressing_tpu_torch.kernels import flash_attention as fa

    sq, skv, sref = lengths or (s, s, s)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    t = [torch.randn((b, n, h, d), generator=gen, device="cuda").to(dtype)
         for n in (sq, skv, skv) + ((sref, sref) if dual else ())]
    args = tuple(t)
    if dual:
        if scale is None:  # the CFG layout [uncond 0...; cond 1...]
            scale = [0.0] * (b // 2) + [1.0] * (b // 2) if b % 2 == 0 \
                else [1.0] * b
        args += (torch.tensor(scale, device="cuda"),)
    # 4*Sq*Skv*D flops and Sq*Skv exp2 per (b, h) and source; rows with
    # scale 0 skip the ref pass
    dual_rows = int((args[-1] != 0).sum()) if dual else 0
    flops = 4.0 * h * sq * d * (b * skv + dual_rows * sref)
    nbytes = sum(x.numel() * x.element_size() for x in t) \
        + t[0].numel() * t[0].element_size()

    def library():
        f = torch.nn.functional.scaled_dot_product_attention
        q, k, v = (x.transpose(1, 2) for x in t[:3])
        o = f(q, k, v)
        if dual:
            o = o + args[-1].view(-1, 1, 1, 1) * f(q, t[3].transpose(1, 2),
                                                   t[4].transpose(1, 2))
        return o

    return dict(kernel=lambda: fa.flash_attention(*args),
                plain=lambda: fa.flash_attention_plain(*args),
                library=library, flops=flops, bytes=nbytes, graph=True,
                plain_eager=True,
                exp2=float(h * sq * (b * skv + dual_rows * sref)))


def gn_conv_case(b, h, w, cin, co, with_add, dtype, seed, groups=32):
    """K2/K4 against the plain version; library: F.group_norm, F.silu and
    cuDNN's conv, three calls the port never makes. graph=True: the deep
    shapes take tens of microseconds behind more host time, so the device
    time comes from CUDA-graph replays (eager times beside it)."""
    import torch
    import torch.nn.functional as F

    from imagdressing_tpu_torch.kernels import fused_gn_conv as fgc
    from imagdressing_tpu_torch.kernels import fused_groupnorm as fg

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dtype)

    x = rnd((b, h, w, cin))
    gw, gb = 1.0 + 0.1 * rnd((cin,)), 0.1 * rnd((cin,))
    wt = rnd((co, cin, 3, 3), (9 * cin) ** -0.5).contiguous(
        memory_format=torch.channels_last)
    cb = rnd((co,))
    add = rnd((b, cin)) if with_add else None
    args = (x, gw, gb, wt, cb)
    kw = dict(num_groups=groups, eps=1e-5, add=add)
    x_nchw = x.permute(0, 3, 1, 2)

    def library():
        xin = x_nchw + add[:, :, None, None] if with_add else x_nchw
        hh = F.silu(F.group_norm(xin, groups, gw, gb, 1e-5))
        return F.conv2d(hh, wt, cb, padding=1)

    def normalize():  # the op's GN+SiLU prologue alone: K3's own launch
        return fg.group_norm_act(x, gw, gb, num_groups=groups, eps=1e-5,
                                 act="silu", add=add)

    flops = 2.0 * b * h * w * 9 * cin * co
    item = x.element_size()
    nbytes = item * (x.numel() + wt.numel() + b * h * w * co)
    x_bytes = item * x.numel()
    plan = fgc.conv_plan(b, h, w, cin, co)
    return dict(kernel=lambda: fgc.gn_silu_conv3x3(*args, **kw),
                plain=lambda: fgc.gn_silu_conv3x3_plain(*args, **kw),
                library=library, flops=flops, bytes=nbytes, graph=True,
                x_bytes=x_bytes,
                normalize=normalize,
                plan=dict(tw=plan.tw, th=plan.th, bn=plan.bn,
                          splits=plan.splits, blocks=plan.blocks))


def group_norm_case(shape, act, dtype, seed, groups=32, with_add=False):
    """K3 against its plain version; library: F.group_norm (and the add and
    F.silu where the case has them) on the channel-last input, by CUDA-graph
    replay (eager beside it): a few microseconds of kernel behind more host
    time."""
    import torch
    import torch.nn.functional as F

    from imagdressing_tpu_torch.kernels import fused_groupnorm as fg

    gen = torch.Generator(device="cuda").manual_seed(seed)
    c = shape[-1]
    x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    w = (1.0 + 0.1 * torch.randn(c, generator=gen, device="cuda")).to(dtype)
    bb = (0.1 * torch.randn(c, generator=gen, device="cuda")).to(dtype)
    add = torch.randn((shape[0], c), generator=gen, device="cuda").to(dtype) \
        if with_add else None
    eps = 1e-6 if act == "none" else 1e-5
    kw = dict(num_groups=groups, eps=eps, act=act, add=add)
    x_ncl = x.reshape(shape[0], -1, c).transpose(1, 2)

    def library():
        xin = x_ncl + add[:, :, None] if with_add else x_ncl
        y = F.group_norm(xin, groups, w, bb, eps)
        return F.silu(y) if act == "silu" else y

    plan = fg.gn_plan(shape[0], x.numel() // (shape[0] * c), c, groups,
                      dtype, act)
    return dict(kernel=lambda: fg.group_norm_act(x, w, bb, **kw),
                plain=lambda: fg.group_norm_act_plain(x, w, bb, **kw),
                library=library, flops=0.0, bytes=2.0 * x.numel()
                * x.element_size(), graph=True,
                plan=dataclasses.asdict(plan))


def group_norm_label(shape, act, groups=32, with_add=False):
    return "x".join(map(str, shape)) + act + ("+add" if with_add else "") \
        + ("" if groups == 32 else f"/g{groups}")


def bn_act_case(shape, act, dtype, seed):
    """K7 at an SCHP shape; library: F.batch_norm (eval) + the activation,
    two calls the port never makes."""
    import torch
    import torch.nn.functional as F

    from imagdressing_tpu_torch.kernels import fused_bn_act as fba

    gen = torch.Generator(device="cuda").manual_seed(seed)
    c = shape[-1]

    def rnd(n, scale, offset=0.0):
        return torch.randn(n, generator=gen, device="cuda") * scale + offset

    x = (2 * torch.randn(shape, generator=gen, device="cuda")).to(dtype)
    params = (rnd(c, 0.3, 1.0), rnd(c, 0.3), rnd(c, 0.5),
              torch.rand(c, generator=gen, device="cuda") * 1.7 + 0.3)
    x_nchw = x.permute(0, 3, 1, 2)
    acts = {"none": lambda y: y, "elu": F.elu,
            "leaky_relu": lambda y: F.leaky_relu(y, 0.01)}

    def library():
        w, b, mean, var = (p.to(dtype) for p in params)
        return acts[act](F.batch_norm(x_nchw, mean, var, w, b, False, 0.0,
                                      1e-5))

    kw = dict(activation=act)
    # one read of x and one write of y; mul, add and the activation per
    # element on the fp32 CUDA cores
    # graph=True: a launch moves ~10 us of data behind more host time, so
    # its device time comes from CUDA-graph replays (eager times beside it)
    return dict(kernel=lambda: fba.abn_inference(x, *params, **kw),
                plain=lambda: fba.abn_inference_plain(x, *params, **kw),
                library=library, graph=True, flops=3.0 * x.numel(),
                flops_per_s=FP32_FLOPS_PER_S,
                bytes=2.0 * x.numel() * x.element_size() + 16.0 * c)


def _flash_train_inputs(b, s, h, d, dual, scale, dtype, seed, lengths=None):
    """(q, k, v, k_ref, v_ref, scale) and g; `lengths` (Sq, Skv, Sref) for
    ragged sequences, else all s."""
    import torch

    sq, skv, sref = lengths or (s, s, s)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    t = [torch.randn((b, n, h, d), generator=gen, device="cuda").to(dtype)
         for n in (sq, skv, skv) + ((sref, sref) if dual else ()) + (sq,)]
    g = t.pop()
    sc = torch.tensor(scale, device="cuda") if dual else None
    args = (*t, *((None, None) if not dual else ()), sc)
    return args, g


def _flash_train_flops(b, s, h, d, dual, products):
    """`products` (s x s x d) matrix products per (b, h) and source: the
    JAX cost model (2 for the forward, 4 for dK/dV, 3 for dQ)."""
    return 2.0 * products * b * h * s * s * d * (2 if dual else 1)


def flash_res_case(b, s, h, d, dual, scale, dtype, seed):
    """K5: (out, lse, o2) against the plain version; library: two SDPA
    forwards and the scaled sum. Timed as K1 is (graph replays, the plain
    version eager)."""
    import torch

    from imagdressing_tpu_torch.kernels import flash_attention as fa

    args, _ = _flash_train_inputs(b, s, h, d, dual, scale, dtype, seed)
    item = args[0].element_size()
    n = b * s * h * d
    # q, k, v (, k_ref, v_ref) read; out (, o2) and the fp32 lse written
    nbytes = item * n * (7 if dual else 4) + 4 * b * h * s * (2 if dual
                                                               else 1)

    def library():
        f = torch.nn.functional.scaled_dot_product_attention
        q, k, v = (x.transpose(1, 2) for x in args[:3])
        o = f(q, k, v)
        if dual:
            o = o + args[5].view(-1, 1, 1, 1) * f(
                q, args[3].transpose(1, 2), args[4].transpose(1, 2))
        return o

    return dict(kernel=lambda: fa.flash_attention_res(*args),
                plain=lambda: fa.flash_attention_res_plain(*args),
                library=library, outputs=("out", "lse", "o2"), graph=True,
                plain_eager=True,
                flops=_flash_train_flops(b, s, h, d, dual, 2),
                bytes=nbytes, exp2=float(b * h * s * s * (2 if dual else 1)))


def flash_bwd_case(b, s, h, d, dual, scale, dtype, seed, part=None,
                   lengths=None):
    """K6b + K6a (part None): the five gradients and K6b's D_i against the
    plain versions, on the plain version's residuals; or one of them
    ("dkv" / "dq", timing; K6a alone reads a D_i that K6b wrote once).
    Library: the backward of two SDPA calls."""
    import torch

    from imagdressing_tpu_torch.kernels import flash_attention as fa

    args, g = _flash_train_inputs(b, s, h, d, dual, scale, dtype, seed,
                                  lengths)
    res = fa.flash_attention_res_plain(*args)
    item = args[0].element_size()
    n = b * s * h * d
    # read: q, k, v (, k_ref, v_ref), g, out (, o2) and the fp32 lse;
    # written: dk, dv (, dk_ref, dv_ref) or dq; the fp32 D_i written by K6b
    # and read by K6a
    stats = 4 * b * h * s * (2 if dual else 1)
    ins = item * n * ((5 if dual else 3) + 2 + (1 if dual else 0)) + stats
    nbytes = {"dkv": ins + stats + item * n * (4 if dual else 2),
              "dq": ins + stats + item * n}
    flops = {"dkv": _flash_train_flops(b, s, h, d, dual, 4),
             "dq": _flash_train_flops(b, s, h, d, dual, 3)}
    # one exp2 per (q, k) pair and source run (scale-0 rows skip theirs)
    sources = b + (sum(x != 0 for x in scale) if dual else 0)
    exp2 = float(sources * h * s * s)
    lib_in = [x.detach().transpose(1, 2).requires_grad_()
              for x in args[:(5 if dual else 3)]]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_out = sdpa(*lib_in[:3])
    if dual:
        lib_out = lib_out + args[5].view(-1, 1, 1, 1) * sdpa(
            lib_in[0], lib_in[3], lib_in[4])
    lib_g = g.transpose(1, 2)

    def library():
        return torch.autograd.grad(lib_out, lib_in, lib_g, retain_graph=True)

    def kernel():
        grads, delta = fa._launch_bwd(*args, *res, g)
        return (*grads, delta)

    def plain():
        return (*fa.flash_attention_bwd_plain(*args, *res, g),
                fa.flash_attention_delta_plain(g, res[0], res[2], args[5]))

    if part == "dq":
        kernel = lambda: fa._launch_bwd(*args, *res, g,  # noqa: E731
                                        parts=("dq",))
    elif part == "dkv":
        delta = fa._launch_bwd(*args, *res, g, parts=("dq",))[1]
        kernel = lambda: fa._launch_bwd(*args, *res, g,  # noqa: E731
                                        parts=("dkv",), delta=delta)
    return dict(kernel=kernel, plain=plain, library=library,
                outputs=("dq", "dk", "dv", "dk_ref", "dv_ref", "delta"),
                flops=flops[part] if part else sum(flops.values()),
                bytes=nbytes[part] if part else sum(nbytes.values()),
                exp2=exp2 if part else 2 * exp2,
                flops_5=_flash_train_flops(b, s, h, d, dual, 5))


def _grad_case(fn, plain, leaves, g):
    """An autograd Function against autograd of its plain version: each
    leaf's gradient; the Function's output must carry its grad_fn. The
    case also keeps its inputs and both functions (for
    `tools/gn_conv_grad_probe.py`)."""
    import torch

    def kernel():
        y = fn(*leaves)
        name = type(y.grad_fn).__name__
        if not name.endswith("FunctionBackward"):
            raise SmokeFailure(f"no kernel Function on the graph: {name}")
        return torch.autograd.grad(y, leaves, g)

    return dict(kernel=kernel,
                plain=lambda: torch.autograd.grad(plain(*leaves), leaves, g),
                outputs=tuple(f"d{i}" for i in range(len(leaves))),
                leaves=leaves, g=g, fns=(fn, plain))


def gn_conv_grad_case(dtype, seed):
    """K2's Function (kernel forward, its chain recomputed and
    differentiated in the backward) at the top UNet level of a batch-1
    training step; in bf16 both it and autograd of the plain version are
    held against the fp32 gradients (`truth`)."""
    import torch

    from imagdressing_tpu_torch.kernels import fused_gn_conv as fgc

    gen = torch.Generator(device="cuda").manual_seed(seed)
    b, h, w, cin, co = 1, 80, 64, 320, 320

    def rnd(shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dtype)

    wt = rnd((co, cin, 3, 3), (9 * cin) ** -0.5).contiguous(
        memory_format=torch.channels_last)
    leaves = [rnd((b, h, w, cin)), 1.0 + 0.1 * rnd((cin,)),
              0.1 * rnd((cin,)), wt, rnd((co,)), rnd((b, cin))]
    leaves = [x.requires_grad_() for x in leaves]
    kw = dict(num_groups=32, eps=1e-5)

    def plain(x, gw, gb, w_, cb, t):
        return fgc.gn_silu_conv3x3_plain(x, gw, gb, w_, cb, add=t, **kw)

    g = rnd((b, h, w, co))
    case = _grad_case(
        lambda x, gw, gb, w_, cb, t: fgc.gn_silu_conv3x3(x, gw, gb, w_, cb,
                                                         add=t, **kw),
        plain, leaves, g)
    if dtype == torch.bfloat16:
        # both bf16 chains are held against the fp32 gradients of the same
        # inputs: two bf16 chains differ from each other by the rounding of
        # both, so neither is the other's reference
        def truth():
            up = [t.detach().float().requires_grad_() for t in leaves]
            return torch.autograd.grad(plain(*up), up, g.float())

        case["truth"] = truth
    return case


def group_norm_grad_case(dtype, seed):
    """K3's Function at a transformer in-norm of a batch-1 training step."""
    import torch

    from imagdressing_tpu_torch.kernels import fused_groupnorm as fg

    gen = torch.Generator(device="cuda").manual_seed(seed)
    shape = (1, 80, 64, 320)
    x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    w = (1.0 + 0.1 * torch.randn(320, generator=gen, device="cuda")).to(dtype)
    bb = (0.1 * torch.randn(320, generator=gen, device="cuda")).to(dtype)
    g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    leaves = [t.requires_grad_() for t in (x, w, bb)]
    kw = dict(num_groups=32, eps=1e-6, act="none")
    return _grad_case(lambda *a: fg.group_norm_act(*a, **kw),
                      lambda *a: fg.group_norm_act_plain(*a, **kw), leaves,
                      g)


GN_CONV_SHAPES = [(2, 80, 64, 320, 320, True), (2, 20, 16, 2560, 1280, True),
                  (2, 10, 8, 1280, 1280, True), (2, 10, 8, 2560, 1280, True),
                  (2, 20, 16, 1280, 1280, True),
                  (1, 10, 8, 1280, 1280, True), (2, 80, 64, 960, 320, True),
                  (1, 640, 512, 256, 128, False),
                  (1, 160, 128, 512, 512, False), (1, 9, 13, 40, 24, False),
                  # the inpaint preset at 512x512: the top latent level, the
                  # deep levels at 8x8 (64 pixels, split K), a decoder pixel
                  # level
                  (2, 64, 64, 320, 320, True), (2, 8, 8, 1280, 1280, True),
                  (2, 8, 8, 2560, 1280, True), (1, 512, 512, 256, 128, False)]
# the deep UNet shapes K2 is also timed at: 330, 180 and 90 launches per
# `basic` image (M = 160, 640 and 160 pixels)
K2_DEEP_TIMED = ["2x10x8x1280->1280+add", "2x20x16x1280->1280+add",
                 "2x10x8x2560->1280+add"]


def gn_conv_label(b, h, w, cin, co, add):
    return f"{b}x{h}x{w}x{cin}->{co}" + ("+add" if add else "")


# K3 check cases (shape, act, groups, add); the first four are also timed
GN_CASES = [((2, 5120, 320), "none", 32, False),
            ((2, 1280, 640), "none", 32, False),
            ((2, 320, 1280), "none", 32, False),
            ((2, 80, 1280), "none", 32, False),
            ((1, 5120, 320), "none", 32, False),
            ((1, 1280, 640), "none", 32, False),
            ((1, 320, 1280), "none", 32, False),
            ((1, 80, 1280), "none", 32, False),
            ((2, 80, 64, 320), "silu", 32, False),
            ((2, 5120, 320), "silu", 32, True),
            ((1, 77, 40), "none", 8, False),
            ((1, 327680, 128), "silu", 32, True),
            # the inpaint preset's UNet and ControlNet levels at 512x512
            ((2, 4096, 320), "none", 32, False),
            ((2, 1024, 640), "none", 32, False),
            ((2, 256, 1280), "none", 32, False),
            ((2, 64, 1280), "none", 32, False)]
K3_TIMED = [group_norm_label(*a) for a in GN_CASES[:4]]


# a served batch of 4 images: K1 at the CFG batch 8's top and second
# levels and the VAE's mid attention at batch 4; K2 at the top latent level
# (CFG batch 8) and K4 at the decoder's top pixel level at batch 4 (3.4e8
# elements of x); K3 resident at the CFG batch 8 and streaming at the VAE's
# pixel level at batch 4
B4_FLASH_SHAPES = [(8, 5120, 8, 40, True), (8, 1280, 8, 80, True),
                   (4, 5120, 1, 512, False)]
B4_GN_CONV_SHAPES = [(8, 80, 64, 320, 320, True),
                     (4, 640, 512, 256, 128, False)]
B4_GN_CASES = [((8, 5120, 320), "none"), ((4, 327680, 256), "silu")]


# K5 / K6 check shapes: the four UNet self-attention levels of a batch-1
# training step, dual (main UNet, scale 1) and single (garment UNet), and a
# batch-2 case with scale [0, 0.7] (the zero-written reference gradients)
TRAIN_FLASH_SHAPES = [(1, 5120, 8, 40), (1, 1280, 8, 80), (1, 320, 8, 160),
                      (1, 80, 8, 160)]


def check_cases():
    """(kernel name, shape label, case factory(dtype, seed))."""
    cases = []
    # the four UNet levels at 512x640 and at the inpaint preset's 512x512
    # (the ControlNet's trunk runs the same shapes), the VAE's mid attention
    # at both sizes
    for b, s, h, d, dual in [(2, 5120, 8, 40, True), (2, 1280, 8, 80, True),
                             (2, 320, 8, 160, True), (2, 80, 8, 160, True),
                             (1, 5120, 1, 512, False),
                             (2, 4096, 8, 40, True), (2, 1024, 8, 80, True),
                             (2, 256, 8, 160, True), (2, 64, 8, 160, True),
                             (1, 4096, 1, 512, False)]:
        cases.append(("flash_fwd", f"{b}x{s}x{h}x{d}" + ("dual" if dual
                                                          else ""),
                      lambda dt, sd, a=(b, s, h, d, dual):
                      flash_case(*a, dt, sd)))
    # single source with 2S keys: the `concat` garment self-attention
    for s, d in [(5120, 40), (320, 160)]:
        cases.append(("flash_fwd", f"2x{s}/{2 * s}x8x{d}",
                      lambda dt, sd, s=s, d=d:
                      flash_case(2, s, 8, d, False, dt, sd,
                                 lengths=(s, 2 * s, 0))))
    # K1 at ragged lengths (Sq, Skv, Sref): zero-filled tails of the q and
    # key tiles and of the D padding at D = 40, masked keys, scale [0, 0.7]
    for (sq, skv, sref), d in [((100, 100, 37), 40), ((80, 77, 130), 40),
                               ((100, 100, 37), 160), ((80, 77, 130), 160)]:
        cases.append(("flash_fwd", f"2x{sq}/{skv}/{sref}x2x{d}dual[0,0.7]",
                      lambda dt, sd, a=(sq, skv, sref), d=d:
                      flash_case(2, a[0], 2, d, True, dt, sd, lengths=a,
                                 scale=[0.0, 0.7])))
    # K2 / K4: the timed shape, the deep UNet levels where its time goes
    # (split K; batch 1 for the garment UNet and training), a concat input,
    # the VAE's pixel levels, and a ragged shape whose H, W, Cin and Cout
    # fit no tile (8 groups of 5 channels)
    for b, h, w, cin, co, add in GN_CONV_SHAPES:
        name = "gn_silu_conv3x3[vae_pixel]" if h * w > 80 * 64 \
            else "gn_silu_conv3x3"
        cases.append((name, gn_conv_label(b, h, w, cin, co, add),
                      lambda dt, sd, a=(b, h, w, cin, co, add):
                      gn_conv_case(*a, dt, sd, groups=32 if a[3] % 32 == 0
                                   else 8)))
    # K3: the transformer in-norms at the four UNet levels of a CFG step and
    # of the garment pass, conv_norm_out (silu), the GN+conv prologue's
    # function (temb folded, silu), a ragged shape (77 rows, groups of 5
    # channels) and a VAE pixel level in streaming mode
    for shape, act, groups, with_add in GN_CASES:
        cases.append(("group_norm_act",
                      group_norm_label(shape, act, groups, with_add),
                      lambda dt, sd, a=(shape, act), g=groups, t=with_add:
                      group_norm_case(*a, dt, sd, groups=g, with_add=t)))
    train = [(shape, dual, [1.0]) for shape in TRAIN_FLASH_SHAPES
             for dual in (True, False)]
    train.append(((2, 320, 8, 160), True, [0.0, 0.7]))
    for (b, s_, h, d), dual, scale in train:
        label = f"{b}x{s_}x{h}x{d}" + ("dual" if dual else "") + (
            "[0,0.7]" if b == 2 else "")
        cases.append(("flash_fwd_res", label,
                      lambda dt, sd, a=(b, s_, h, d, dual, scale):
                      flash_res_case(*a, dt, sd)))
        cases.append(("flash_bwd", label,
                      lambda dt, sd, a=(b, s_, h, d, dual, scale):
                      flash_bwd_case(*a, dt, sd)))
    # ragged lengths (Sq, Skv, Sref) of the CPU test of the Function's
    # gradients: masked sequence edges, zero-filled D padding at D = 40
    for (sq, skv, sref), d in [((100, 100, 37), 40), ((80, 77, 130), 40),
                               ((100, 100, 37), 160), ((80, 77, 130), 160)]:
        cases.append(("flash_bwd", f"2x{sq}/{skv}/{sref}x2x{d}dual[0,0.7]",
                      lambda dt, sd, a=(sq, skv, sref), d=d:
                      flash_bwd_case(2, a[0], 2, d, True, [0.0, 0.7], dt, sd,
                                     lengths=a)))
    cases.append(("gn_silu_conv3x3.grad", "1x80x64x320->320+add",
                  gn_conv_grad_case))
    cases.append(("group_norm_act.grad", "1x80x64x320none",
                  group_norm_grad_case))
    # K7 at SCHP's shapes (ATR 512 unless noted): the stem, layer3, the
    # decoder's 48 channels, PSP maps of 36 and 1 rows, LIP's 237x237 stem,
    # the decoder/fusion width, and the elu the TPU kernel also computes
    for shape, act in [((1, 256, 256, 128), "none"),
                       ((1, 32, 32, 1024), "none"),
                       ((1, 128, 128, 48), "leaky_relu"),
                       ((1, 6, 6, 512), "leaky_relu"),
                       ((1, 1, 1, 512), "leaky_relu"),
                       ((1, 237, 237, 64), "none"),
                       ((1, 128, 128, 256), "leaky_relu"),
                       ((1, 60, 60, 256), "elu")]:
        cases.append(("bn_act", "x".join(map(str, shape)) + act,
                      lambda dt, sd, a=(shape, act): bn_act_case(*a, dt, sd)))
    # last, so that the cases above keep their seeds (a case's seed is its
    # index): K1-K4 at the shapes of a served batch of 4 images, the UNet's
    # CFG batch 8 (ref scale [0 x 4, 1 x 4]) and the VAE's batch 4
    for b, s, h, d, dual in B4_FLASH_SHAPES:
        cases.append(("flash_fwd", f"{b}x{s}x{h}x{d}" + ("dual" if dual
                                                          else ""),
                      lambda dt, sd, a=(b, s, h, d, dual):
                      flash_case(*a, dt, sd)))
    for b, h, w, cin, co, add in B4_GN_CONV_SHAPES:
        name = "gn_silu_conv3x3[vae_pixel]" if h * w > 80 * 64 \
            else "gn_silu_conv3x3"
        cases.append((name, gn_conv_label(b, h, w, cin, co, add),
                      lambda dt, sd, a=(b, h, w, cin, co, add):
                      gn_conv_case(*a, dt, sd)))
    for shape, act in B4_GN_CASES:
        cases.append(("group_norm_act", group_norm_label(shape, act),
                      lambda dt, sd, a=(shape, act):
                      group_norm_case(*a, dt, sd)))
    return cases


# which kernel computes each output of the multi-output cases
OUTPUT_KERNEL = {("flash_bwd", "dq"): "flash_bwd_dq",
                 ("flash_bwd", "delta"): "flash_bwd_dq",
                 ("flash_bwd", "dk"): "flash_bwd_dkv",
                 ("flash_bwd", "dv"): "flash_bwd_dkv",
                 ("flash_bwd", "dk_ref"): "flash_bwd_dkv",
                 ("flash_bwd", "dv_ref"): "flash_bwd_dkv"}


# K1 is also timed at every level of the main path and at D = 512
K1_TIMED = ["2x5120x8x40dual", "2x1280x8x80dual", "2x320x8x160dual",
            "2x80x8x160dual", "1x5120x1x512"]
# the batch-4 shapes of the served path, also timed
B4_TIMED = [("flash_fwd", "8x5120x8x40dual"), ("flash_fwd", "8x1280x8x80dual"),
            ("flash_fwd", "4x5120x1x512"),
            ("gn_silu_conv3x3", "8x80x64x320->320+add"),
            ("gn_silu_conv3x3[vae_pixel]", "4x640x512x256->128"),
            ("group_norm_act", "8x5120x320none"),
            ("group_norm_act", "4x327680x256silu")]
# the shape each kernel is timed at (the first check case of that name)
TIMED = {"flash_fwd": "2x5120x8x40dual",
         "gn_silu_conv3x3": "2x80x64x320->320+add",
         "gn_silu_conv3x3[vae_pixel]": "1x640x512x256->128",
         "group_norm_act": "2x5120x320none",
         "flash_fwd_res": "1x5120x8x40dual",
         "flash_bwd_dkv": "1x5120x8x40dual",
         "flash_bwd_dq": "1x5120x8x40dual",
         "bn_act": "1x128x128x256leaky_relu"}
# the dtype each kernel is timed in: bf16 on the dressing paths, fp32 on
# the parsing path (the JAX package feeds SCHP float32)
TIMED_DTYPE = {"bn_act": "fp32"}


# cases also run at seeds beside their index: seed 75 is where the bf16
# GN+conv gradient's d(temb) once exceeded its bound against the plain chain
EXTRA_SEEDS = {"gn_silu_conv3x3.grad": (75,)}


def _check_against_truth(name, label, outs, sides, truth):
    """A bf16 case with an fp32 `truth`: each side within TOL["bf16"] of
    it, bounded by the same rule (atol + rtol * max |truth|)."""
    atol, rtol = TOL["bf16"]
    for i, out in enumerate(outs):
        t = truth[i].float()
        ref = t.abs().max().item()
        tol = atol + rtol * ref
        for side, vals in sides:
            err = (vals[i].float() - t).abs().max().item()
            ok = math.isfinite(err) and err <= tol
            emit("check", kernel=name, shape=label, dtype="bf16", output=out,
                 side=side, against="fp32", max_abs_err=err,
                 max_abs_ref=ref, tol=tol, ok=ok)
            if not ok:
                raise SmokeFailure(f"{name} {label} bf16 {out} ({side}) vs "
                                   f"fp32: max abs err {err:.4g} > "
                                   f"{tol:.4g}")


def phase_check():
    """Returns each kernel's max abs error at its TIMED shape and dtype."""
    import torch

    dtypes = {"bf16": torch.bfloat16, "fp32": torch.float32}
    errs = {}
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # fp32 plain convs in full fp32
    runs = [(seed, case) for seed, case in enumerate(check_cases())]
    runs += [(seed, case) for case in check_cases()
             for seed in EXTRA_SEEDS.get(case[0], ())]
    try:
        for seed, (name, label, build) in runs:
            for dn, dt in dtypes.items():
                case = build(dt, seed)
                got = case["kernel"]()
                want = case["plain"]()
                truth = case["truth"]() if "truth" in case else None
                torch.cuda.synchronize()
                outs = case.get("outputs", ("out",))
                if truth is not None:
                    _check_against_truth(name, f"{label} seed {seed}", outs,
                                         (("kernel", got), ("plain", want)),
                                         truth)
                    del case, got, want, truth
                    continue
                if len(outs) == 1:
                    got, want = (got,), (want,)
                for out, a, b in zip(outs, got, want):
                    if a is None and b is None:
                        continue
                    kernel = OUTPUT_KERNEL.get((name, out), name)
                    what = f"{kernel} {label} {dn} {out}"
                    if a is None or b is None or a.shape != b.shape \
                            or a.dtype != b.dtype:
                        raise SmokeFailure(f"{what}: {a} vs {b}")
                    err = (a.float() - b.float()).abs().max().item()
                    ref = b.float().abs().max().item()
                    atol, rtol = {"lse": (LSE_TOL, 0.0),
                                  "delta": DELTA_TOL}.get(out, TOL[dn])
                    tol = atol + rtol * ref
                    ok = math.isfinite(err) and err <= tol
                    emit("check", kernel=kernel, shape=label, dtype=dn,
                         output=out, max_abs_err=err, max_abs_ref=ref,
                         tol=tol, ok=ok)
                    if dn == TIMED_DTYPE.get(kernel, "bf16") \
                            and label == TIMED.get(kernel) and out != "lse":
                        errs[kernel] = max(errs.get(kernel, 0.0), err)
                    if not ok:
                        raise SmokeFailure(f"{what}: max abs err {err:.4g} "
                                           f"> {tol:.4g}")
                del case, got, want
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    return errs


def phase_determinism():
    """K1 and K5, then K6b + K6a, twice on the same inputs at the main
    shapes: bit-identical outputs, lse, O2, gradients and D_i (no atomics, a
    fixed summation order); K2 twice at a split-K shape, at its timed shape
    and at a VAE pixel level (the split partials and the GroupNorm's
    partials added in a fixed order); K3 twice in resident and in
    streaming mode."""
    import torch

    for shape in [(2, 10, 8, 1280, 1280, True), (2, 80, 64, 320, 320, True),
                  (1, 640, 512, 256, 128, False)]:
        case = gn_conv_case(*shape, torch.bfloat16, 8)
        first = case["kernel"]()
        second = case["kernel"]()
        torch.cuda.synchronize()
        same = bool(torch.equal(first, second))
        emit("determinism", kernel="gn_silu_conv3x3",
             shape=gn_conv_label(*shape), dtype="bf16", plan=case["plan"],
             bit_equal={"out": same}, ok=same)
        if not same:
            raise SmokeFailure(f"K2 repeat not bit-identical at {shape}")
        del case, first, second

    # K3 resident (one cluster launch) and streaming (the clusters'
    # partials added by the last cluster to arrive)
    for shape in [(2, 5120, 320), (1, 327680, 128)]:
        case = group_norm_case(shape, "silu", torch.bfloat16, 8,
                               with_add=True)
        first = case["kernel"]()
        second = case["kernel"]()
        torch.cuda.synchronize()
        same = bool(torch.equal(first, second))
        emit("determinism", kernel="group_norm_act",
             shape=group_norm_label(shape, "silu", with_add=True),
             dtype="bf16", plan=case["plan"], bit_equal={"out": same},
             ok=same)
        if not same:
            raise SmokeFailure(f"K3 repeat not bit-identical at {shape}")
        del case, first, second

    for name, case in (
            ("flash_fwd", flash_case(2, 5120, 8, 40, True, torch.bfloat16,
                                     9)),
            ("flash_fwd_res", flash_res_case(1, 5120, 8, 40, True, [1.0],
                                             torch.bfloat16, 9))):
        first = case["kernel"]()
        second = case["kernel"]()
        torch.cuda.synchronize()
        outs = case.get("outputs", ("out",))
        if len(outs) == 1:
            first, second = (first,), (second,)
        same = {out: bool(torch.equal(a, b)) for out, a, b in
                zip(outs, first, second) if a is not None}
        label = "2x5120x8x40dual" if name == "flash_fwd" \
            else "1x5120x8x40dual"
        emit("determinism", kernel=name, shape=label, dtype="bf16",
             bit_equal=same, ok=all(same.values()))
        if not all(same.values()):
            raise SmokeFailure(f"{name} repeat not bit-identical: {same}")
        del case, first, second

    case = flash_bwd_case(1, 5120, 8, 40, True, [1.0], torch.bfloat16, 7)
    first = case["kernel"]()
    second = case["kernel"]()
    torch.cuda.synchronize()
    same = {out: bool(torch.equal(a, b)) for out, a, b in
            zip(case["outputs"], first, second) if a is not None}
    emit("determinism", kernel="flash_bwd", shape="1x5120x8x40dual",
         dtype="bf16",
         bit_equal=same, ok=all(same.values()))
    if not all(same.values()):
        raise SmokeFailure(f"K6 repeat not bit-identical: {same}")


def phase_time():
    """Each kernel's time at its TIMED shape beside its plain version's, the
    library call's and its bound: the larger of its bytes over the HBM rate
    and its operations over the rate of their unit (tensor-core FLOPs; for
    the flash kernels also one exp2 per (q, k) pair and source on the
    special-function units, at the card's maximum SM clock)."""
    import torch

    from imagdressing_tpu_torch.tools.timing import cuda_graph_ms, cuda_ms

    by_label = {(n, lbl): b for n, lbl, b in check_cases()}
    for part in ("dkv", "dq"):
        by_label[(f"flash_bwd_{part}", "1x5120x8x40dual")] = (
            lambda dt, sd, p=part: flash_bwd_case(1, 5120, 8, 40, True, [1.0],
                                                  dt, sd, part=p))
    dtypes = {"bf16": torch.bfloat16, "fp32": torch.float32}
    exp2_rate = exp2_per_ms()

    def timed(name, label, dn):
        case = by_label[(name, label)](dtypes[dn], 1000)
        ms = cuda_ms(case["kernel"])
        plain_ms = cuda_ms(case["plain"])
        library_ms = cuda_ms(case["library"])
        extra = {}
        if case.get("graph"):
            extra = dict(eager_ms=ms, eager_plain_ms=plain_ms,
                         eager_library_ms=library_ms)
            ms, library_ms = (cuda_graph_ms(case[k])
                              for k in ("kernel", "library"))
            if not case.get("plain_eager"):
                plain_ms = cuda_graph_ms(case["plain"])
        if "plan" in case:
            extra["plan"] = case["plan"]
        terms = {"bytes": case["bytes"] / HBM_BYTES_PER_S * 1e3,
                 "tensor": case["flops"] / case.get("flops_per_s",
                                                    BF16_FLOPS_PER_S) * 1e3,
                 "exp2": case.get("exp2", 0.0) / exp2_rate}
        unit = max(terms, key=terms.get)
        row = dict(shape=label, dtype=dn, ms=ms, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=terms[unit],
                   bound_by="bytes" if unit == "bytes" else "operations",
                   bound_unit=unit, bound_terms_ms=terms,
                   tflops=case["flops"] / ms / 1e9, **extra)
        if name == "gn_silu_conv3x3" and label == TIMED[name]:
            # the GN+SiLU prologue alone: one read of x, one write of h
            row["normalize_ms"] = cuda_graph_ms(case["normalize"])
            row["normalize_bound_ms"] = 2.0 * case["x_bytes"] \
                / HBM_BYTES_PER_S * 1e3
        emit("time", kernel=name, **row)
        return row

    timings = {name: timed(name, label, TIMED_DTYPE.get(name, "bf16"))
               for name, label in TIMED.items()}
    for label in K2_DEEP_TIMED:
        timed("gn_silu_conv3x3", label, "bf16")
    for label in K3_TIMED:
        if label != TIMED["group_norm_act"]:
            timed("group_norm_act", label, "bf16")
    # K1 at its other check shapes (every level of the main path, and the
    # VAE's D = 512), K5 at the other training levels
    for label in K1_TIMED:
        if label != TIMED["flash_fwd"]:
            timed("flash_fwd", label, "bf16")
    for b, s_, h, d in TRAIN_FLASH_SHAPES:
        label = f"{b}x{s_}x{h}x{d}dual"
        if label != TIMED["flash_fwd_res"]:
            timed("flash_fwd_res", label, "bf16")
    for name, label in B4_TIMED:
        timed(name, label, "bf16")
    # the pair K6b + K6a in one call, beside the function's own bound: 5
    # products per (q, k) pair (dQ, dK, dV, S and dP once each) and one exp2
    case = by_label[("flash_bwd", "1x5120x8x40dual")](torch.bfloat16, 1000)
    pair_ms = cuda_ms(case["kernel"])
    emit("time_pair", kernels=["flash_bwd_dq", "flash_bwd_dkv"],
         shape="1x5120x8x40dual", dtype="bf16", ms=pair_ms,
         sum_of_kernels_ms=timings["flash_bwd_dq"]["ms"]
         + timings["flash_bwd_dkv"]["ms"],
         library_ms=timings["flash_bwd_dq"]["library_ms"],
         kernel_bounds_ms={k: timings[k]["bound_ms"]
                           for k in ("flash_bwd_dq", "flash_bwd_dkv")},
         function_bound_ms=max(case["flops_5"] / BF16_FLOPS_PER_S * 1e3,
                               case["exp2"] / 2 / exp2_rate),
         function_bound_terms_ms={
             "tensor_5_products": case["flops_5"] / BF16_FLOPS_PER_S * 1e3,
             "exp2_once": case["exp2"] / 2 / exp2_rate})
    return timings


# ---------------------------------------------------------------------------
# Models
# ---------------------------------------------------------------------------


def mini_models():
    """A small fp32 stack on the CPU whose head dims suit the card's kernels
    (multiples of 8), randomly initialised from a CPU generator."""
    import torch

    from imagdressing_tpu_torch.core import config as C
    from imagdressing_tpu_torch.models.clip import CLIPText, CLIPVision
    from imagdressing_tpu_torch.models.resampler import Resampler
    from imagdressing_tpu_torch.models.unet import (
        UNet,
        init_ref_adapters_from_unet,
    )
    from imagdressing_tpu_torch.models.vae import VAE
    from imagdressing_tpu_torch.ops.nn import init_module
    from imagdressing_tpu_torch.pipelines.dressing import DressingModels

    cfgs = dict(
        unet_cfg=C.UNetConfig(block_out_channels=(32, 64, 64, 64),
                              cross_attention_dim=32, attention_num_heads=4,
                              norm_num_groups=8),
        vae_cfg=C.VAEConfig(block_out_channels=(32, 32, 64, 64),
                            norm_num_groups=8),
        text_cfg=C.CLIPTextConfig(vocab_size=256, hidden_size=32,
                                  intermediate_size=64, num_layers=2,
                                  num_heads=4),
        vision_cfg=C.CLIPVisionConfig(hidden_size=48, intermediate_size=96,
                                      num_layers=3, num_heads=4,
                                      image_size=56, patch_size=14,
                                      projection_dim=32),
        resampler_cfg=C.ResamplerConfig(dim=32, depth=1, dim_head=8, heads=4,
                                        num_queries=8, embedding_dim=48,
                                        output_dim=32),
    )
    gen = torch.Generator().manual_seed(0)
    mods = dict(unet=UNet(cfgs["unet_cfg"]), ref_unet=UNet(cfgs["unet_cfg"]),
                resampler=Resampler(cfgs["resampler_cfg"]),
                vae=VAE(cfgs["vae_cfg"]), text=CLIPText(cfgs["text_cfg"]),
                vision=CLIPVision(cfgs["vision_cfg"]))
    for m in mods.values():
        init_module(m, gen)
    mods["ref_adapters"] = init_ref_adapters_from_unet(mods["unet"])
    for m in mods.values():
        m.eval().requires_grad_(False)
    return DressingModels(**cfgs, **mods)


def mini_preset_models():
    """The mini stack with a ControlNet and the IP adapters + ProjPlus, drawn
    from the same CPU generator after the mini stack's own; every ControlNet
    leaf perturbed by 0.05 * N(0, 1) (its output convs start at zero)."""
    import torch

    from imagdressing_tpu_torch.core.config import (
        ControlNetConfig,
        ProjPlusConfig,
    )
    from imagdressing_tpu_torch.models.controlnet import ControlNet
    from imagdressing_tpu_torch.models.resampler import ProjPlus
    from imagdressing_tpu_torch.models.unet import IPAdapters
    from imagdressing_tpu_torch.ops.nn import init_module

    models = mini_models()
    ucfg = models.unet_cfg
    models.controlnet_cfg = ControlNetConfig(unet=ucfg)
    models.projplus_cfg = ProjPlusConfig(
        cross_attention_dim=32, id_embeddings_dim=16, clip_embeddings_dim=48,
        num_tokens=4, depth=1, dim_head=8)
    models.controlnet = ControlNet(models.controlnet_cfg)
    models.ip_adapters = IPAdapters(ucfg)
    models.proj_plus = ProjPlus(models.projplus_cfg)
    gen = torch.Generator().manual_seed(1)
    for name in ("controlnet", "ip_adapters", "proj_plus"):
        m = getattr(models, name)
        init_module(m, gen)
        m.eval().requires_grad_(False)
    with torch.no_grad():
        for prm in models.controlnet.parameters():
            prm.add_(0.05 * torch.randn(prm.shape, generator=gen))
    return models


# (preset, preset overrides) of the mini card-vs-CPU runs
MINI_PRESETS = [("pose", {}), ("ipa_pose", {}),
                ("inpaint", {"strength": 0.99}),
                ("pose", {"sampler": "unipc"})]


def phase_mini_presets():
    """The mini preset stack on the card and on the CPU: `pose`,
    `ipa_pose`, `inpaint` (strength 0.99) and `pose` with UniPC, 64x64, 4
    steps; each output within 1e-3, as `phase_mini`."""
    import numpy as np
    import torch

    from imagdressing_tpu_torch.core.config import PRESETS
    from imagdressing_tpu_torch.pipelines.dressing import DressingPipeline
    from imagdressing_tpu_torch.tools.profile_infer import preset_inputs

    cpu = mini_preset_models()
    gpu = copy.deepcopy(cpu)
    for m in gpu.modules().values():
        m.to("cuda")
    kwargs = preset_inputs(1, 64, 64, 56, 16, 256, 8)
    kwargs["latents"] = np.random.default_rng(9).standard_normal((1, 8, 8, 4))
    tol = 1e-3
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for name, over in MINI_PRESETS:
            preset = dataclasses.replace(PRESETS[name], height=64, width=64,
                                         num_inference_steps=4, **over)
            want = DressingPipeline(cpu, preset, device="cpu")(**kwargs)
            got = DressingPipeline(gpu, preset)(**kwargs)
            err = float(np.abs(got - want).max())
            ok = bool(np.isfinite(got).all()) and err <= tol
            emit("mini_presets", preset=name, sampler=preset.sampler,
                 strength=preset.strength, max_abs_err=err, tol=tol, ok=ok)
            if not ok:
                raise SmokeFailure(f"mini {name} {preset.sampler}: card vs "
                                   f"CPU max abs err {err:.4g}")
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def phase_mini():
    import numpy as np
    import torch

    from imagdressing_tpu_torch.core.config import PRESETS
    from imagdressing_tpu_torch.pipelines.dressing import (
        MODEL_NAMES,
        DressingPipeline,
    )

    cpu = mini_models()
    gpu = copy.deepcopy(cpu)
    for name in MODEL_NAMES:
        getattr(gpu, name).to("cuda")
    preset = dataclasses.replace(PRESETS["basic"], height=64, width=64,
                                 num_inference_steps=4)
    rng = np.random.default_rng(7)
    kwargs = dict(prompt_ids=rng.integers(0, 256, (1, 77)),
                  negative_prompt_ids=rng.integers(0, 256, (1, 77)),
                  ref_image=rng.uniform(-1, 1, (1, 64, 64, 3)),
                  ref_clip_image=rng.standard_normal((1, 56, 56, 3)),
                  latents=rng.standard_normal((1, 8, 8, 4)))
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        want = DressingPipeline(cpu, preset, device="cpu")(**kwargs)
        got = DressingPipeline(gpu, preset)(**kwargs)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    err = float(np.abs(got - want).max())
    tol = 1e-3  # fp32 images in [0, 1]; sum-order differences over 4 steps
    ok = bool(np.isfinite(got).all()) and err <= tol
    emit("mini", max_abs_err=err, tol=tol, ok=ok)
    if not ok:
        raise SmokeFailure(f"mini stack: card vs CPU max abs err {err:.4g}")


def _train_batch(b, h, w, clip_size, vocab, device, seed):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    batch = {
        "person_image": rng.uniform(-1, 1, (b, h, w, 3)),
        "cloth_image": rng.uniform(-1, 1, (b, h, w, 3)),
        "cloth_clip": rng.standard_normal((b, clip_size, clip_size, 3)),
    }
    batch = {k: torch.tensor(v, dtype=torch.float32, device=device)
             for k, v in batch.items()}
    batch["text_ids"] = torch.tensor(rng.integers(0, vocab, (b, 77)),
                                     device=device)
    return batch


def phase_mini_train():
    """Two train steps of the small fp32 stack on the card and on the CPU,
    fed the same draws: loss and grad norm per step within rtol 1e-4 and
    1e-3, the trained weights within 1e-5, 1 % of the second step's AdamW
    update (lr 1e-3; the first step's learning rate is 0). AdamW divides
    each gradient element by its own magnitude, so an element whose
    gradient is close to the fp32 rounding noise of the two devices' sum
    orders moves by a slightly different amount."""
    import dataclasses as dc

    import torch

    from imagdressing_tpu_torch.core.config import TrainConfig
    from imagdressing_tpu_torch.pipelines.dressing import MODEL_NAMES
    from imagdressing_tpu_torch.train import step as tstep

    cpu = mini_models()
    gpu = copy.deepcopy(cpu)
    for name in MODEL_NAMES:
        getattr(gpu, name).to("cuda")
    cfg = TrainConfig(train_batch_size=2, warmup_steps=1, learning_rate=1e-3)
    draws = [tstep.make_draws(0, i, range(2), (8, 8, 4), 1000, "cpu")
             for i in range(2)]
    results = {}
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for dev, models in (("cpu", cpu), ("cuda", gpu)):
            state, frozen, tx = tstep.init_train_state(models, cfg)
            step = tstep.make_train_step(models, cfg, tx)
            batch = _train_batch(2, 64, 64, 56, 256, dev, 3)
            metrics = []
            for d in draws:
                d = tstep.Draws(**{f.name: getattr(d, f.name).to(dev)
                                   for f in dc.fields(tstep.Draws)})
                state, m = step(state, frozen, batch, 0, draws=d)
                metrics.append((float(m["loss"]), float(m["grad_norm"])))
            params = [p.detach().cpu()
                      for p in tstep.trainable_parameters(state.params)]
            results[dev] = (metrics, params)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    (m_cpu, p_cpu), (m_gpu, p_gpu) = results["cpu"], results["cuda"]
    loss_err = max(abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(m_gpu, m_cpu))
    gn_err = max(abs(a[1] - b[1]) / abs(b[1]) for a, b in zip(m_gpu, m_cpu))
    p_diff = torch.cat([(a - b).abs().reshape(-1)
                        for a, b in zip(p_gpu, p_cpu)])
    p_err = p_diff.max().item()
    finite = all(math.isfinite(x) for m in m_gpu for x in m)
    ok = finite and loss_err <= 1e-4 and gn_err <= 1e-3 and p_err <= 1e-5
    emit("mini_train", steps=2, metrics_cuda=m_gpu, metrics_cpu=m_cpu,
         loss_rel_err=loss_err, grad_norm_rel_err=gn_err,
         param_max_abs_err=p_err, params=p_diff.numel(),
         params_over_1e_6=int((p_diff > 1e-6).sum()), ok=ok)
    if not ok:
        raise SmokeFailure("mini training: card vs CPU disagree")


def phase_main(counters):
    import numpy as np
    import torch

    from imagdressing_tpu_torch.core.config import PRESETS
    from imagdressing_tpu_torch.kernels import fused_gn_conv as fgc
    from imagdressing_tpu_torch.pipelines.dressing import (
        DressingModels,
        DressingPipeline,
    )

    t0 = time.perf_counter()
    models = DressingModels.init_random(0).cast(torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    preset = dataclasses.replace(PRESETS["basic"], num_inference_steps=STEPS)
    pipe = DressingPipeline(models, preset)
    h, w = preset.height, preset.width
    rng = np.random.default_rng(0)
    inputs = dict(prompt_ids=rng.integers(0, 49408, (1, 77)),
                  negative_prompt_ids=rng.integers(0, 49408, (1, 77)),
                  ref_image=rng.uniform(-1, 1, (1, h, w, 3)),
                  ref_clip_image=rng.standard_normal((1, 224, 224, 3)),
                  seed=42)
    # warm run, float output: finite values before quantisation
    t0 = time.perf_counter()
    image = pipe(**inputs)
    first_s = time.perf_counter() - t0
    if image.shape != (1, h, w, 3) or image.dtype != np.float32:
        raise SmokeFailure(f"output {image.shape} {image.dtype}")
    if not np.isfinite(image).all() or image.std() == 0:
        raise SmokeFailure("output not finite, or constant")

    # the counted run: counts reset just before, read just after
    for c in counters.values():
        c.reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = pipe(output_uint8=True, **inputs)
    total_s = time.perf_counter() - t0
    launches = {name: (c.count, dict(c.by_shape))
                for name, c in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    stages = dict(pipe.last_stage_seconds)
    if out.dtype != np.uint8 or out.shape != (1, h, w, 3):
        raise SmokeFailure(f"uint8 output {out.shape} {out.dtype}")
    if not np.array_equal(out, np.round(image * 255).astype(np.uint8)):
        raise SmokeFailure("same seed gave another image")
    no_garment = pipe(output_uint8=True, image_scale=0.0, **inputs)
    if np.array_equal(no_garment, out):
        raise SmokeFailure("image_scale=0 gave the same image as 1.0")

    lat_pixels = (h // 8) * (w // 8)
    flash_n, flash_shapes = launches["flash_fwd"]
    conv_n, conv_shapes = launches["gn_silu_conv3x3"]
    pixel_n = sum(n for (_, hh, ww, _, _), n in conv_shapes.items()
                  if hh * ww > lat_pixels)
    counts = {"flash_fwd": flash_n, "gn_silu_conv3x3": conv_n - pixel_n,
              "gn_silu_conv3x3[vae_pixel]": pixel_n,
              "group_norm_act": launches["group_norm_act"][0]}
    plans = {str(k): dataclasses.astuple(fgc.conv_plan(*k))[:4]
             for k in conv_shapes}
    emit("main", steps=STEPS, size=f"{w}x{h}", init_s=init_s,
         first_call_s=first_s, total_s=total_s, stage_s=stages,
         peak_gib=peak / 2**30, launches=counts,
         conv_launches_by_shape={str(k): v for k, v in conv_shapes.items()},
         flash_launches_by_shape={str(k): v
                                  for k, v in flash_shapes.items()},
         group_norm_launches_by_shape={
             str(k): v for k, v in launches["group_norm_act"][1].items()},
         conv_plans_tw_th_bn_splits=plans)
    zero = [k for k, n in counts.items() if n == 0]
    if zero:
        raise SmokeFailure(f"kernels never launched on the main path: {zero}")
    return counts


def expected_launches(steps, controlnet, encodes):
    """K1, K2 (every shape) and K3 launches of one full-width image, from
    the code: per CFG step the main UNet's 16 self-attentions, 22 resnets
    (two GN+convs each) and 16 transformer in-norms + conv_norm_out, and the
    ControlNet's trunk 7, 10 and 7 (no conv_norm_out); the garment UNet's
    capture pass once; each VAE encode one mid attention and 10 resnets,
    the decode one and 14."""
    cn = 1 if controlnet else 0
    return {"flash_fwd": steps * (16 + 7 * cn) + 16 + encodes + 1,
            "gn_silu_conv3x3": steps * (44 + 20 * cn) + 44 + 20 * encodes
            + 28,
            "group_norm_act": steps * (17 + 7 * cn) + 17}


# the presets at full width (cartoon is basic's graph), in the order run
FULL_PRESETS = ("cartoon", "pose", "ipa_pose", "inpaint")


def phase_presets(counters, basic):
    """`cartoon`, `pose`, `ipa_pose` and `inpaint` at full SD1.5 width and
    their preset sizes, bf16, STEPS steps, one `DressingModels` with the
    ControlNet (its zero-initialised output convs filled with random values)
    and the IP adapters: per preset a warm float run, then the counted uint8
    run (counts reset just before, read just after), and the probes: the
    same seed gives the same image; another pose, another face embedding,
    ControlNet scale 0 each give another; every launch count equals
    `expected_launches`, cartoon's equal `basic`'s, pose - cartoon = STEPS x
    (K1 7, K2 20, K3 7), ipa_pose's equal pose's shape by shape."""
    import numpy as np
    import torch

    from imagdressing_tpu_torch.core.config import PRESETS
    from imagdressing_tpu_torch.pipelines.dressing import (
        DressingModels,
        DressingPipeline,
    )
    from imagdressing_tpu_torch.tools.profile_infer import (
        fill_zero_convs,
        preset_inputs,
    )

    t0 = time.perf_counter()
    models = DressingModels.init_random(0, with_controlnet=True,
                                        with_ipa=True)
    fill_zero_convs(models.controlnet)
    models.cast(torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    runs = {}
    for name in FULL_PRESETS:
        preset = dataclasses.replace(PRESETS[name], num_inference_steps=STEPS)
        pipe = DressingPipeline(models, preset)
        h, w = preset.height, preset.width
        inputs = dict(preset_inputs(1, h, w), seed=42)
        t0 = time.perf_counter()
        image = pipe(**inputs)
        first_s = time.perf_counter() - t0
        if image.shape != (1, h, w, 3) or not np.isfinite(image).all() \
                or image.std() == 0:
            raise SmokeFailure(f"{name}: output {image.shape}, not finite "
                               "or constant")
        for c in counters.values():
            c.reset()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = pipe(output_uint8=True, **inputs)
        total_s = time.perf_counter() - t0
        by_shape = {k: dict(c.by_shape) for k, c in counters.items()}
        launches = {k: c.count for k, c in counters.items()}
        peak = torch.cuda.max_memory_allocated()
        stages = dict(pipe.last_stage_seconds)
        if not np.array_equal(out, np.round(image * 255).astype(np.uint8)):
            raise SmokeFailure(f"{name}: the same seed gave another image")
        probes = {}
        if name == "pose":
            probes["other_pose"] = dict(
                inputs, pose_image=1.0 - inputs["pose_image"])
            probes["controlnet_scale_0"] = dict(inputs, controlnet_scale=0.0)
        if name == "ipa_pose":
            probes["other_face"] = dict(
                inputs, faceid_embeds=-inputs["faceid_embeds"])
        moved = {}
        for probe, kw in probes.items():
            moved[probe] = bool(np.abs(pipe(output_uint8=True, **kw)
                                       .astype(np.int16) - out).max() > 0)
        used = STEPS - max(STEPS - int(STEPS * preset.strength), 0) \
            if preset.use_inpaint else STEPS
        want = expected_launches(used, preset.use_controlnet,
                                 2 if preset.use_inpaint else 1)
        runs[name] = dict(launches=launches, by_shape=by_shape)
        emit("presets", preset=name, steps=STEPS, used_steps=used,
             size=f"{w}x{h}", sampler=preset.sampler, init_s=init_s,
             first_call_s=first_s, total_s=total_s, stage_s=stages,
             peak_gib=peak / 2**30, launches=launches,
             expected_launches=want, probes_differ=moved,
             launches_by_shape={k: {str(s): n for s, n in v.items()}
                                for k, v in by_shape.items()})
        if launches != want:
            raise SmokeFailure(f"{name}: launches {launches} != {want}")
        if not all(moved.values()):
            raise SmokeFailure(f"{name}: a probe left the image unchanged: "
                               f"{moved}")
    if runs["cartoon"]["launches"] != basic:
        raise SmokeFailure(f"cartoon {runs['cartoon']['launches']} != basic "
                           f"{basic}")
    delta = {k: runs["pose"]["launches"][k] - runs["cartoon"]["launches"][k]
             for k in counters}
    want = {"flash_fwd": 7 * STEPS, "gn_silu_conv3x3": 20 * STEPS,
            "group_norm_act": 7 * STEPS}
    emit("presets_delta", pose_minus_cartoon=delta, want=want,
         ipa_pose_equals_pose=runs["ipa_pose"] == runs["pose"])
    if delta != want:
        raise SmokeFailure(f"pose - cartoon launches {delta} != {want}")
    if runs["ipa_pose"] != runs["pose"]:
        raise SmokeFailure("ipa_pose launched other kernels than pose")
    return {name: r["launches"] for name, r in runs.items()}


def _sums(modules):
    """fp64 sum of every parameter of each module: a cheap fingerprint."""
    return {name: [p.detach().double().sum().item() for p in m.parameters()]
            for name, m in modules.items()}


# ---------------------------------------------------------------------------
# From checkpoint files: the loader, the HTTP server, the dress CLI
# ---------------------------------------------------------------------------


class _RssPeak(threading.Thread):
    """The largest resident set size of this process seen while running,
    sampled from /proc/self/statm every 2 ms (None where it is unreadable)."""

    def __init__(self):
        super().__init__(daemon=True)
        self.peak, self.done = None, threading.Event()

    @staticmethod
    def rss_gib():
        try:
            with open("/proc/self/statm") as f:
                pages = int(f.read().split()[1])
        except (OSError, ValueError, IndexError):
            return None
        return pages * os.sysconf("SC_PAGE_SIZE") / 2**30

    def run(self):
        while not self.done.wait(0.002):
            rss = self.rss_gib()
            if rss is not None:
                self.peak = max(self.peak or 0.0, rss)

    def stop(self):
        self.done.set()
        self.join()
        return self.peak


def _garment(seed: int, h: int = 600, w: int = 460):
    """A seeded uint8 RGB garment: ramps, stripes and noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([(x * 0.5 + y * 0.3 + 40 * seed) % 256,
                    np.sin(x / (15 + seed)) * 100 + 128, (y / h) * 200], -1)
    return np.clip(img + rng.normal(0, 12, img.shape), 0, 255).astype(
        np.uint8)


def phase_load(root):
    """The full-width `basic` stack in bf16, written as the reference's
    checkpoint files under `root` (`tools/write_checkpoints.py`: diffusers /
    transformers safetensors, the monolithic IMAGDressing .pt) and loaded
    back by `apps.loader.load_dressing_models(..., device="cuda")`: every
    parameter bit-equal to the stack that was written. Returns (the loaded
    stack, the loader's path arguments)."""
    import torch

    from imagdressing_tpu_torch.apps.loader import load_dressing_models
    from imagdressing_tpu_torch.pipelines.dressing import DressingModels
    from imagdressing_tpu_torch.tools.write_checkpoints import (
        write_checkpoints,
    )

    models = DressingModels.init_random(0).cast(torch.bfloat16)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    paths = write_checkpoints(models, root)
    write_s = time.perf_counter() - t0
    sizes = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            rel = os.path.relpath(os.path.join(dirpath, name), root)
            sizes[rel] = os.path.getsize(os.path.join(dirpath, name))
    rss_before = _RssPeak.rss_gib()
    sampler = _RssPeak()
    sampler.start()
    torch.cuda.reset_peak_memory_stats()
    base_alloc = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    loaded = load_dressing_models(**paths, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    peak_rss = sampler.stop()
    peak_dev = torch.cuda.max_memory_allocated() - base_alloc
    n_params = n_bytes = 0
    mismatched = []
    for name, module in models.modules().items():
        want = module.state_dict()
        have = getattr(loaded, name).state_dict()
        if have.keys() != want.keys():
            raise SmokeFailure(f"load: {name} keys differ")
        for k, v in want.items():
            n_params += v.numel()
            n_bytes += v.numel() * v.element_size()
            if have[k].dtype != v.dtype or not torch.equal(have[k], v):
                mismatched.append(f"{name}.{k}")
    emit("load", size="SD1.5 full width", dtype="bf16", write_s=write_s,
         load_s=load_s, file_gb=sum(sizes.values()) / 1e9,
         files_gb={k: v / 1e9 for k, v in sorted(sizes.items())},
         params=n_params, param_gb=n_bytes / 1e9,
         load_gb_per_s=n_bytes / 1e9 / load_s,
         host_rss_before_gib=rss_before, peak_host_rss_gib=peak_rss,
         load_peak_device_gib=peak_dev / 2**30,
         bit_equal=not mismatched, ok=not mismatched)
    if mismatched:
        raise SmokeFailure(f"load: {len(mismatched)} parameters differ, "
                           f"e.g. {mismatched[:3]}")
    return loaded, paths


class _RecordingPipe:
    """The served pipeline, wrapped by this script (the worker is the app's,
    unchanged): records each call's batch, seed and inputs and times it;
    each call numbered in `held` sets its `entered` event, then waits for
    its `release` event before it runs (so requests queue behind it); call
    number `count` runs between a reset and a read of the launch
    counters."""

    def __init__(self, pipe, counters, held, count):
        self.pipe, self.models, self.counters = pipe, pipe.models, counters
        self.calls, self.count = [], count
        self.entered = {n: threading.Event() for n in held}
        self.release = {n: threading.Event() for n in held}

    def __call__(self, **kw):
        import torch

        n = len(self.calls)
        if n in self.release:
            self.entered[n].set()
            if not self.release[n].wait(900):
                raise SmokeFailure("serve: a held call was never released")
        call = dict(batch=kw["ref_image"].shape[0], seed=kw["seed"],
                    inputs=kw)
        if n == self.count:
            for c in self.counters.values():
                c.reset()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = self.pipe(**kw)
        call["s"] = time.perf_counter() - t0
        call["stage_s"] = dict(self.pipe.last_stage_seconds)
        if n == self.count:
            call["launches"] = {k: c.count for k, c in self.counters.items()}
            call["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        self.calls.append(call)
        return out


def _wait_for(cond, what, timeout=600.0):
    t0 = time.monotonic()
    while not cond():
        if time.monotonic() - t0 > timeout:
            raise SmokeFailure(f"serve: timed out waiting for {what}")
        time.sleep(0.002)


def phase_serve(models, paths, counters):
    """The port's HTTP server (`apps.serve.make_handler` on a
    ThreadingHTTPServer at 127.0.0.1, `InferenceWorker(max_batch=4)`) over
    the loaded stack, `basic` at 512x640, STEPS steps, bf16: one warm
    request, held in the pipeline while 4 requests of one batch key (4
    synthetic PNG garments) queue behind it, which the worker must run as
    one batch-4 call (counted launches equal to `expected_launches(STEPS,
    False, 1)`: the counts do not grow with the batch); that call held
    while 2 requests with other seeds queue, which must run in separate
    rounds; then 4 requests sent at once to the idle worker, none held
    (their round trips: what four users wait). Every response a PNG of (640, 512, 3) uint8; the batch-4 images
    bit-equal to a direct `pipe(...)` call on the same preprocessed arrays,
    seed and batch; distinct garments, distinct images."""
    import base64
    import json
    import urllib.request
    from http.server import ThreadingHTTPServer

    import numpy as np
    import torch

    from imagdressing_tpu_torch.apps import image_utils as iu
    from imagdressing_tpu_torch.apps.png import decode_png, encode_png
    from imagdressing_tpu_torch.apps.serve import (
        InferenceWorker,
        garment_inputs,
        make_handler,
    )
    from imagdressing_tpu_torch.apps.tokenizer import load_tokenizer
    from imagdressing_tpu_torch.core.config import PRESETS
    from imagdressing_tpu_torch.pipelines.dressing import DressingPipeline

    preset = dataclasses.replace(PRESETS["basic"], num_inference_steps=STEPS)
    pipe = DressingPipeline(models, preset)
    rec = _RecordingPipe(pipe, counters, held=(0, 1), count=1)
    tokenizer = load_tokenizer(os.path.join(paths["base_dir"], "tokenizer"))
    worker = InferenceWorker(rec, tokenizer, max_batch=4)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(worker, preset))
    port = httpd.server_address[1]
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    garments = {i: _garment(i) for i in range(7)}
    pngs = {i: encode_png(g) for i, g in garments.items()}
    responses, errors = {}, []

    def post(name, i, seed):
        body = json.dumps({"prompt": "a woman in a dress", "seed": seed,
                           "steps": STEPS,
                           "cloth_image": base64.b64encode(pngs[i]).decode()})
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/dress", data=body.encode(),
            headers={"Content-Type": "application/json"})
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(req, timeout=900) as resp:
                out = json.loads(resp.read())
            out["round_trip_s"] = time.perf_counter() - t0
            out["png"] = decode_png(base64.b64decode(out["image"]))
            responses[name] = out
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(f"{name}: {type(e).__name__}: {e}")

    def start(name, i, seed):
        t = threading.Thread(target=post, args=(name, i, seed))
        t.start()
        return t

    try:
        # the warm request (call 0), held while the four queue behind it
        threads = [start("warm", 6, 1)]
        if not rec.entered[0].wait(900):
            raise SmokeFailure("serve: the warm request never reached the "
                               "pipeline")
        for i in range(4):
            threads.append(start(f"b4_{i}", i, 42))
            _wait_for(lambda n=i + 1: worker.queue.qsize() == n,
                      f"{i + 1} queued requests")
        rec.release[0].set()
        # the batch-4 call (call 1), held while two requests of other seeds
        # queue behind it
        if not rec.entered[1].wait(900):
            raise SmokeFailure("serve: the queued requests never ran")
        for j, seed in enumerate((5, 6)):
            threads.append(start(f"seed_{seed}", 4 + j, seed))
            _wait_for(lambda n=j + 1: worker.queue.qsize() == n,
                      f"{j + 1} queued requests")
        rec.release[1].set()
        for t in threads:
            t.join(1200)
            if t.is_alive():
                raise SmokeFailure("serve: a request never returned")
        # four requests sent at once to the idle worker, none held: what
        # four users wait, the app's PNG decode, preparation and encode
        # included (the worker batches whatever has queued when it looks)
        free = [start(f"free_{i}", i, 43) for i in range(4)]
        for t in free:
            t.join(1200)
            if t.is_alive():
                raise SmokeFailure("serve: a request never returned")
    finally:
        for ev in rec.release.values():
            ev.set()
        httpd.shutdown()
        httpd.server_close()
        server.join(30)
    if errors:
        raise SmokeFailure(f"serve: {errors}")
    h, w = preset.height, preset.width
    for name, r in responses.items():
        if r["png"].shape != (h, w, 3) or r["png"].dtype != np.uint8:
            raise SmokeFailure(f"serve: {name} answered {r['png'].shape} "
                               f"{r['png'].dtype}")
    rounds = [(c["batch"], c["seed"]) for c in rec.calls]
    if rounds[:2] != [(1, 1), (4, 42)] or sorted(rounds[2:4]) != [(1, 5),
                                                                (1, 6)] \
            or {sd for _, sd in rounds[4:]} != {43} \
            or sum(b for b, _ in rounds[4:]) != 4:
        raise SmokeFailure(f"serve: pipeline calls {rounds}, expected the "
                           "warm call, one batch of 4, two single rounds, "
                           "then the four unheld requests")
    b4 = rec.calls[1]
    # the same arrays, prepared by this script, through the pipeline directly
    clip_size = models.vision_cfg.image_size
    prepped = [garment_inputs(iu.read_image(pngs[i]), preset, clip_size)
               for i in range(4)]
    direct = pipe(
        prompt_ids=np.stack([tokenizer("a woman in a dress")] * 4),
        negative_prompt_ids=np.stack([tokenizer(iu.DEFAULT_NEGATIVE)] * 4),
        ref_image=np.concatenate([p[0] for p in prepped]),
        ref_clip_image=np.concatenate([p[1] for p in prepped]),
        seed=42, num_inference_steps=STEPS, output_uint8=True)
    served = np.stack([responses[f"b4_{i}"]["png"] for i in range(4)])
    same_inputs = all(np.array_equal(b4["inputs"][k], np.concatenate(
        [p[j] for p in prepped])) for j, k in enumerate(("ref_image",
                                                          "ref_clip_image")))
    bit_equal = bool(np.array_equal(served, direct))
    distinct = all(not np.array_equal(served[a], served[b])
                   for a in range(4) for b in range(a + 1, 4))
    want = expected_launches(STEPS, False, 1)
    emit("serve", preset="basic", size=f"{w}x{h}", steps=STEPS,
         dtype="bf16", max_batch=4, rounds=rounds,
         batch4_call_s=b4["s"], images_per_min_b4=4 * 60.0 / b4["s"],
         batch1_call_s=[c["s"] for c in rec.calls if c["batch"] == 1],
         batch4_stage_s=b4["stage_s"], batch4_peak_gib=b4["peak_gib"],
         batch4_round_trip_s=[responses[f"b4_{i}"]["round_trip_s"]
                              for i in range(4)],
         unheld4_rounds=[b for b, _ in rounds[4:]],
         unheld4_call_s=[c["s"] for c in rec.calls[4:]],
         unheld4_round_trip_s=[responses[f"free_{i}"]["round_trip_s"]
                               for i in range(4)],
         launches=b4["launches"], expected_launches=want,
         inputs_match_direct_prep=same_inputs, bit_equal_direct=bit_equal,
         distinct_garments_distinct_images=distinct,
         ok=bit_equal and distinct and same_inputs
         and b4["launches"] == want)
    if b4["launches"] != want:
        raise SmokeFailure(f"serve: batch-4 launches {b4['launches']} != "
                           f"{want}")
    if not same_inputs:
        raise SmokeFailure("serve: the worker's arrays differ from this "
                           "script's preparation of the same PNGs")
    if not bit_equal:
        raise SmokeFailure("serve: the served batch differs from the direct "
                           "pipeline call")
    if not distinct:
        raise SmokeFailure("serve: two garments gave the same image")
    # the worker thread lives on, idle: let it drop the stack
    rec.pipe = rec.models = None


def phase_dress(paths):
    """`apps.dress.main` on a folder of 5 PNG garments, `--batch_size 4`
    (one full chunk, one ragged chunk padded to 4), `--device cuda`, loading
    from the same files: 5 collages [garment | result] of (640, 1024, 3)
    under the garments' names; the wall time of each chunk's pipeline
    call."""
    from imagdressing_tpu_torch.apps import dress
    from imagdressing_tpu_torch.apps import image_utils as iu
    from imagdressing_tpu_torch.core.config import PRESETS
    from imagdressing_tpu_torch.pipelines import dressing

    root = os.path.dirname(paths["base_dir"])
    cloth_dir, out_dir = (os.path.join(root, d) for d in ("cloths", "out"))
    os.makedirs(cloth_dir)
    names = [f"cloth_{i}.png" for i in range(5)]
    for i, name in enumerate(names):
        iu.write_image(os.path.join(cloth_dir, name), _garment(20 + i))
    chunks = []
    call = dressing.DressingPipeline.__call__

    def timed(self, **kw):
        t0 = time.perf_counter()
        out = call(self, **kw)
        chunks.append(dict(batch=kw["ref_image"].shape[0],
                           s=time.perf_counter() - t0))
        return out

    dressing.DressingPipeline.__call__ = timed
    t0 = time.perf_counter()
    try:
        dress.main(["--base_dir", paths["base_dir"],
                    "--vae_path", paths["vae_path"],
                    "--image_encoder_path", paths["image_encoder_path"],
                    "--model_ckpt", paths["model_ckpt"],
                    "--cloth_dir", cloth_dir, "--batch_size", "4",
                    "--num_inference_steps", str(STEPS),
                    "--output_path", out_dir, "--device", "cuda"])
    finally:
        dressing.DressingPipeline.__call__ = call
    wall_s = time.perf_counter() - t0
    saved = sorted(os.listdir(out_dir))
    shapes = {n: iu.read_image(os.path.join(out_dir, n)).shape for n in saved}
    preset = PRESETS["basic"]
    want = (preset.height, 2 * preset.width, 3)
    ok = saved == names and all(s == want for s in shapes.values()) \
        and [c["batch"] for c in chunks] == [4, 4]
    emit("dress", garments=len(names), batch_size=4, steps=STEPS,
         wall_s=wall_s, chunk_s=[c["s"] for c in chunks],
         chunk_batches=[c["batch"] for c in chunks],
         load_and_prep_s=wall_s - sum(c["s"] for c in chunks),
         saved=saved, collage_shapes={k: list(v) for k, v in shapes.items()},
         ok=ok)
    if not ok:
        raise SmokeFailure(f"dress: saved {saved} {shapes}, chunks {chunks}")
    collage = iu.read_image(os.path.join(out_dir, names[0]))
    if collage[:, preset.width:].std() == 0:
        raise SmokeFailure("dress: a constant result")


def phase_train(counters):
    """The training step at full SD1.5 width, 512x640, batch 1."""
    import torch

    from imagdressing_tpu_torch.core.config import TrainConfig
    from imagdressing_tpu_torch.pipelines.dressing import DressingModels
    from imagdressing_tpu_torch.train import step as tstep

    t0 = time.perf_counter()
    models = DressingModels.init_random(0).cast_for_training(torch.bfloat16)
    cfg = TrainConfig(train_batch_size=1, warmup_steps=2,
                      remat_policy="full")
    state, frozen, tx = tstep.init_train_state(models, cfg)
    step = tstep.make_train_step(models, cfg, tx)
    batch = _train_batch(1, 640, 512, 224, 49408, "cuda", 0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    frozen_before = _sums(frozen)
    train_before = _sums(state.params)

    # the warm step: learning rate 0, so nothing may move yet
    t0 = time.perf_counter()
    state, m = step(state, frozen, batch, seed=0)
    warm_loss = float(m["loss"])
    first_s = time.perf_counter() - t0
    if _sums(state.params) != train_before:
        raise SmokeFailure("the first step (learning rate 0) moved weights")

    for c in counters.values():
        c.reset()
    torch.cuda.reset_peak_memory_stats()
    seconds, losses, norms = [], [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, m = step(state, frozen, batch, seed=0)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    launches = {name: c.count for name, c in counters.items()}
    # K6b and K6a per (b, sq, h, d, dual) and step
    bwd_by_shape = {name: {str(k): n / TRAIN_STEPS
                           for k, n in counters[name].by_shape.items()}
                    for name in ("flash_bwd_dq", "flash_bwd_dkv")}
    peak = torch.cuda.max_memory_allocated()
    moved = {name: a != b for (name, a), b in
             zip(_sums(state.params).items(), train_before.values())}
    emit("train", size="512x640", batch=1, steps=TRAIN_STEPS,
         remat_policy=cfg.remat_policy, init_s=init_s, first_step_s=first_s,
         warm_loss=warm_loss, s_per_step=sorted(seconds)[len(seconds) // 2],
         step_s=seconds, losses=losses, grad_norms=norms,
         peak_gib=peak / 2**30, launches=launches,
         launches_per_step={k: v / TRAIN_STEPS for k, v in launches.items()},
         flash_bwd_per_step_by_shape=bwd_by_shape, trainables_moved=moved)
    zero = [k for k, n in launches.items() if n == 0]
    if zero:
        raise SmokeFailure(f"kernels never launched in training: {zero}")
    per_step = {k: v / TRAIN_STEPS for k, v in launches.items()}
    if per_step != expected_train_launches(cfg.remat_policy):
        raise SmokeFailure(f"training launches {per_step}, derived "
                           f"{expected_train_launches(cfg.remat_policy)}")
    if bwd_by_shape["flash_bwd_dq"] != bwd_by_shape["flash_bwd_dkv"]:
        raise SmokeFailure(f"K6b and K6a launched apart: {bwd_by_shape}")
    if not all(math.isfinite(x) for x in losses + norms):
        raise SmokeFailure(f"non-finite loss or grad norm: {losses} {norms}")
    if not all(moved.values()):
        raise SmokeFailure(f"trainables did not move: {moved}")
    if _sums(frozen) != frozen_before:
        raise SmokeFailure("a frozen parameter changed")
    return launches


def expected_train_launches(policy):
    """Launches of one batch-1 training step at 512x640, from the code. The
    forwards: the garment UNet once (capture mode, no remat) and the main
    UNet, each 16 self-attentions (K5), 22 resnets (two GN+convs each) and
    16 transformer in-norms + conv_norm_out (K3); two VAE encodes without a
    gradient, each one mid attention (K1) and 10 resnets (K2 / K4). The
    backward: K6b and K6a at the main UNet's 16 self-attentions and the
    garment UNet's first 15 (its last layer's output never reaches the
    loss). The main UNet's recompute, of the blocks the gradient passes
    through (all but the first resnet: its input does not depend on the
    garment K/V and the UNet is frozen, so it records no graph): "full"
    and "dots" re-run 21 resnets (K2 x 2) and 16 transformer blocks (K5,
    K3); "names" and "heavy" save conv1 and the flash outputs and re-run
    only the in-norms (K3); "none" re-runs nothing."""
    blocks = policy in ("full", "dots")
    norms = policy != "none"
    return {"flash_fwd": 2, "flash_fwd_res": 32 + 16 * blocks,
            "flash_bwd_dq": 31, "flash_bwd_dkv": 31,
            "gn_silu_conv3x3": 88 + 40 + 42 * blocks,
            "group_norm_act": 34 + 16 * norms}


REMAT_POLICIES = ("full", "dots", "names", "heavy", "none")
REMAT_STEPS = 4


def phase_remat(counters):
    """One 512x640 batch-1 training step from the same weights, batch and
    draws under each remat policy (learning rate 0, so no weight moves):
    the loss (equal across policies), the gradient norm (within 1e-3 of
    "full"'s), peak memory and the median s/step of REMAT_STEPS steps after
    a warm one, and the launches per step, which must equal
    `expected_train_launches` (so "names" and "heavy" launch fewer K5 and
    GN+conv forwards than "full": their recompute returns the saved
    outputs)."""
    import torch

    from imagdressing_tpu_torch.core.config import TrainConfig
    from imagdressing_tpu_torch.pipelines.dressing import DressingModels
    from imagdressing_tpu_torch.train import step as tstep

    models = DressingModels.init_random(0).cast_for_training(torch.bfloat16)
    batch = _train_batch(1, 640, 512, 224, 49408, "cuda", 0)
    draws = tstep.make_draws(0, 0, range(1), (80, 64, 4), 1000, "cuda")
    rows = {}
    for policy in REMAT_POLICIES:
        cfg = TrainConfig(train_batch_size=1, learning_rate=0.0,
                          remat_policy=policy)
        state, frozen, tx = tstep.init_train_state(models, cfg)
        step = tstep.make_train_step(models, cfg, tx)
        state, m = step(state, frozen, batch, 0, draws=draws)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        torch.cuda.synchronize()
        for c in counters.values():
            c.reset()
        torch.cuda.reset_peak_memory_stats()
        seconds = []
        for _ in range(REMAT_STEPS):
            t0 = time.perf_counter()
            state, m = step(state, frozen, batch, 0, draws=draws)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        launches = {k: c.count / REMAT_STEPS for k, c in counters.items()}
        rows[policy] = dict(
            loss=loss, grad_norm=gnorm,
            s_per_step=sorted(seconds)[REMAT_STEPS // 2],
            step_s=seconds,
            peak_gib=torch.cuda.max_memory_allocated() / 2**30,
            launches_per_step=launches,
            expected=expected_train_launches(policy))
        del state, frozen, tx, step, m
        torch.cuda.empty_cache()
    full = rows["full"]
    problems = []
    for policy, row in rows.items():
        rel = abs(row["grad_norm"] - full["grad_norm"]) / full["grad_norm"]
        row.update(grad_norm_rel_to_full=rel,
                   grad_norm_bit_equal_to_full=row["grad_norm"]
                   == full["grad_norm"],
                   loss_equal_to_full=row["loss"] == full["loss"])
        emit("remat", policy=policy, size="512x640", batch=1, **row)
        if not (math.isfinite(row["loss"]) and row["loss"] == full["loss"]):
            problems.append(f"{policy}: loss {row['loss']} vs {full['loss']}")
        if not rel <= 1e-3:
            problems.append(f"{policy}: grad norm {rel:.3g} off full's")
        if row["launches_per_step"] != row["expected"]:
            problems.append(f"{policy}: launches {row['launches_per_step']}"
                            f" vs derived {row['expected']}")
    for policy in ("names", "heavy"):
        for k in ("flash_fwd_res", "gn_silu_conv3x3"):
            if rows[policy]["launches_per_step"][k] >= \
                    full["launches_per_step"][k]:
                problems.append(f"{policy} recomputes {k} as full does")
    del models
    torch.cuda.empty_cache()
    if problems:
        raise SmokeFailure("remat: " + "; ".join(problems))
    return rows


TRAIN_CLI_PAIRS = 4


def _events(path):
    """The records of a TensorBoard event file, both CRCs checked."""
    import struct

    from imagdressing_tpu_torch.train.trackers import _masked_crc

    with open(path, "rb") as f:
        data = f.read()
    records, i = [], 0
    while i < len(data):
        head = data[i:i + 8]
        (length,) = struct.unpack("<Q", head)
        payload = data[i + 12:i + 12 + length]
        crcs = struct.unpack("<II", data[i + 8:i + 12]
                             + data[i + 12 + length:i + 16 + length])
        if crcs != (_masked_crc(head), _masked_crc(payload)):
            raise SmokeFailure(f"train_cli: bad TFRecord CRC in {path}")
        records.append(payload)
        i += 16 + length
    return records


def phase_train_cli(paths, counters):
    """`apps.train_cli.main` at full SD1.5 width from the base files of
    phase_load: TRAIN_CLI_PAIRS synthetic person / garment JPEG pairs
    (768x576) and a manifest; the CLI's resize and crop defaults (shorter
    side 512, crop 640x512), batch 1, 4 steps, `--checkpointing_steps 2`,
    `--report_to all`; then `--resume_from_checkpoint` to step 6; then
    `apps.dress.main --trained_ckpt` of one garment (`basic`, STEPS steps)
    beside the same garment from the base stack. Checks: finite losses, one
    metrics line a step, the TensorBoard files parse, checkpoints 2, 4 and
    6 (max_to_keep 3), the step-4 checkpoint bit-equal to the first run's
    final state, the resumed run starting at step 4, the merged trainables
    equal to the checkpoint's cast to bf16, the frozen weights unchanged by
    the merge, another served image than the base stack's, and the
    launches per step and per image as derived."""
    import gc

    import numpy as np
    import torch

    from imagdressing_tpu_torch.apps import dress, loader, train_cli
    from imagdressing_tpu_torch.apps import image_utils as iu
    from imagdressing_tpu_torch.pipelines.dressing import TRAINABLE_KEYS
    from imagdressing_tpu_torch.runtime import native
    from imagdressing_tpu_torch.train import checkpoint as ck
    from imagdressing_tpu_torch.train import step as tstep

    root = os.path.dirname(paths["base_dir"])
    data = os.path.join(root, "igpair")
    os.makedirs(data)
    items = []
    for i in range(TRAIN_CLI_PAIRS):
        for kind, seed in (("person", 40 + i), ("cloth", 60 + i)):
            iu.write_image(os.path.join(data, f"{kind}{i}.jpg"),
                           _garment(seed, 768, 576))
        items.append({"image_file": f"person{i}.jpg",
                      "cloth_file": f"cloth{i}.jpg",
                      "text": ["a red dress", "a summer shirt"]})
    manifest = os.path.join(data, "manifest.json")
    with open(manifest, "w") as f:
        json.dump(items, f)
    out = os.path.join(root, "train_run")
    ckpt_dir = os.path.join(out, "checkpoints")
    args = ["--data_json_file", manifest, "--data_root_path", data,
            "--base_dir", paths["base_dir"], "--vae_path", paths["vae_path"],
            "--image_encoder_path", paths["image_encoder_path"],
            "--output_dir", out, "--train_batch_size", "1",
            "--checkpointing_steps", "2", "--logging_steps", "1",
            "--learning_rate", "1e-4", "--lr_warmup_steps", "1",
            "--report_to", "all", "--device", "cuda"]

    for c in counters.values():
        c.reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = train_cli.main(args + ["--num_train_steps", "4"])
    first_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {k: c.count / 4 for k, c in counters.items()}
    in_memory = tstep.state_to_host(state)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    saved4, extra4 = ck.read_checkpoint(ckpt_dir, 4)
    differ = [f"{k}.{n}" for k in TRAINABLE_KEYS
              for n, t in in_memory["params"][k].items()
              if not torch.equal(t, saved4["params"][k][n])]
    differ += [k for k, v in in_memory["opt_state"].items()
               if (not torch.equal(v, saved4["opt_state"][k])
                   if torch.is_tensor(v) else v != saved4["opt_state"][k])]
    if saved4["step"] != 4:
        differ.append("step")
    del in_memory

    t0 = time.perf_counter()
    state = train_cli.main(args + ["--num_train_steps", "6",
                                   "--resume_from_checkpoint"])
    resume_s = time.perf_counter() - t0
    final_step = state.step
    del state
    gc.collect()
    torch.cuda.empty_cache()

    with open(os.path.join(out, "metrics.jsonl")) as f:
        lines = [json.loads(ln) for ln in f]
    events = [e for name in sorted(os.listdir(os.path.join(out, "logs")))
              for e in _events(os.path.join(out, "logs", name))]
    steps_saved = ck.saved_steps(ckpt_dir)
    trained = ck.read_checkpoint(ckpt_dir, 6)[0]["params"]

    # serve: the base stack's image, then the trained checkpoint's
    cloth = os.path.join(root, "train_garment.png")
    iu.write_image(cloth, _garment(80))
    merged = {}
    merge = loader.merge_trained_checkpoint

    def recording_merge(models, ckpt):
        frozen = {k: m for k, m in models.modules().items()
                  if k not in TRAINABLE_KEYS}
        merged["frozen_before"] = _sums(frozen)
        models = merge(models, ckpt)
        merged["frozen_after"] = _sums(frozen)
        merged["trainables"] = {
            k: {n: t.detach().cpu()
                for n, t in getattr(models, k).state_dict().items()}
            for k in TRAINABLE_KEYS}
        return models

    served = {}
    loader.merge_trained_checkpoint = recording_merge
    try:
        for tag, extra in (("base", []), ("trained",
                                          ["--trained_ckpt", ckpt_dir])):
            for c in counters.values():
                c.reset()
            t0 = time.perf_counter()
            dress.main(["--base_dir", paths["base_dir"],
                        "--vae_path", paths["vae_path"],
                        "--image_encoder_path", paths["image_encoder_path"],
                        "--model_ckpt", paths["model_ckpt"],
                        "--cloth_path", cloth,
                        "--num_inference_steps", str(STEPS),
                        "--output_path", os.path.join(root, f"served_{tag}"),
                        "--device", "cuda"] + extra)
            served[tag] = dict(
                s=time.perf_counter() - t0,
                image=iu.read_image(os.path.join(
                    root, f"served_{tag}", "train_garment.png")),
                launches={k: c.count for k, c in counters.items()
                          if k in ("flash_fwd", "gn_silu_conv3x3",
                                   "group_norm_act")})
    finally:
        loader.merge_trained_checkpoint = merge
    gc.collect()
    torch.cuda.empty_cache()

    wrong_trained = [f"{k}.{n}" for k in TRAINABLE_KEYS
                     for n, t in trained[k].items()
                     if not torch.equal(merged["trainables"][k][n],
                                        t.to(torch.bfloat16))]
    width = served["base"]["image"].shape[1] // 2
    image_moved = not np.array_equal(served["base"]["image"][:, width:],
                                     served["trained"]["image"][:, width:])
    image_ok = bool(served["trained"]["image"][:, width:].std() > 0)
    want_step = expected_train_launches("full")
    want_image = expected_launches(STEPS, False, 1)
    step_s = [ln["step_time_s"] for ln in lines]
    data_s = [ln["data_time_s"] for ln in lines]
    checks = {
        "losses_finite": all(math.isfinite(ln["loss"])
                             and math.isfinite(ln["grad_norm"])
                             for ln in lines),
        "one_line_a_step": [ln["step"] for ln in lines] == list(range(1, 7)),
        "tensorboard_parses": len(events) == 8
        and sum(b"brain.Event:2" in e for e in events) == 2,
        "checkpoints_2_4_6": steps_saved == [2, 4, 6],
        "step4_bit_equal": not differ and extra4 == {"step": 4},
        "resumed_from_4": final_step == 6 and [ln["step"] for ln in lines][
            4:] == [5, 6],
        "merged_equal_checkpoint_bf16": not wrong_trained,
        "frozen_unchanged": merged["frozen_before"]
        == merged["frozen_after"],
        "image_differs_from_base": image_moved and image_ok,
        "launches_per_step": launches == {k: want_step[k] for k in launches},
        "launches_per_image": all(
            served[t]["launches"] == {k: want_image[k]
                                      for k in served[t]["launches"]}
            for t in served),
    }
    emit("train_cli", size="512x640", batch=1, pairs=TRAIN_CLI_PAIRS,
         jpeg=f"{768}x{576}",
         decoder="native (libjpeg + image_ops.cpp)" if native.available()
         else "PIL + train.data.resize",
         first_run_s=first_s, resume_run_s=resume_s,
         s_per_step=float(np.median(step_s)),
         data_s_per_step=float(np.median(data_s)),
         step_time_s=step_s, data_time_s=data_s,
         images_per_sec=float(np.median([ln["images_per_sec"]
                                         for ln in lines])),
         losses=[ln["loss"] for ln in lines],
         peak_gib=peak / 2**30, launches_per_step=launches,
         expected_per_step={k: want_step[k] for k in launches},
         served_s={t: served[t]["s"] for t in served},
         launches_per_image={t: served[t]["launches"] for t in served},
         checkpoints=steps_saved, state_differs=differ[:5],
         merged_differs=wrong_trained[:5], checks=checks,
         ok=all(checks.values()))
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise SmokeFailure(f"train_cli: {failed}")


def _check_parse_contract(parse, face, hw):
    import numpy as np

    if parse.shape != hw or parse.dtype != np.uint8:
        raise SmokeFailure(f"parse map {parse.shape} {parse.dtype}")
    if face.shape != hw or face.dtype != np.float32:
        raise SmokeFailure(f"face mask {face.shape} {face.dtype}")
    if parse.max() > 18:  # ATR's 0-17 and the neck label 18
        raise SmokeFailure(f"labels {np.unique(parse)}")
    if not np.array_equal(face, (parse == 11).astype(np.float32)):
        raise SmokeFailure("face mask is not the face label")


# logits of the full-width parser, card (TF32 off) vs CPU: fp32 sum-order
# differences through 100+ cuDNN convs, relative to max|ref| (~1e4)
PARSE_RTOL = 1e-3
PARSE_AGREE = 0.999


def phase_parse_check():
    """The full-width parser on a 200x150 photo, on the card and on the CPU
    (K7's plain version) with the same weights: both nets' logits (the
    nets still run at 512 and 473) and the parse maps."""
    import numpy as np
    import torch

    from imagdressing_tpu_torch.preprocess.parsing import infer as pinf
    from imagdressing_tpu_torch.tools.profile_parse import person_photo

    cpu = pinf.Parsing.init_random(0, device="cpu")
    gpu = pinf.Parsing(copy.deepcopy(cpu.atr), copy.deepcopy(cpu.lip))
    img = person_photo(200, 150, 1)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    errs = {}
    try:
        for name, n, size in (("atr", 18, 512), ("lip", 20, 473)):
            want = cpu.logits(torch.from_numpy(img), getattr(cpu, name), n,
                              size)
            got = gpu.logits(torch.from_numpy(img).cuda(),
                             getattr(gpu, name), n, size).cpu()
            ref = want.abs().max().item()
            errs[name] = dict(max_abs_err=(got - want).abs().max().item(),
                              max_abs_ref=ref, tol=PARSE_RTOL * ref,
                              finite=bool(torch.isfinite(got).all()))
        t0 = time.perf_counter()
        want, want_face = cpu(img)
        cpu_s = time.perf_counter() - t0
        got, face = gpu(img)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    _check_parse_contract(got, face, img.shape[:2])
    agree = float((got == want).mean())
    ok = agree >= PARSE_AGREE and all(
        e["finite"] and e["max_abs_err"] <= e["tol"] for e in errs.values())
    emit("parse_check", photo="200x150", logits=errs, parse_agree=agree,
         agree_min=PARSE_AGREE, cpu_call_s=cpu_s,
         labels=sorted(int(v) for v in np.unique(got)), ok=ok)
    if not ok:
        raise SmokeFailure(f"parser card vs CPU: {errs}, agree {agree}")


def phase_parse(counter):
    """`Parsing.__call__` at full width (ResNet-101 SCHP, ATR 512 + LIP
    473, fp32, cuDNN's default TF32 convs) on a 1024x768 photo."""
    import numpy as np
    import torch

    from imagdressing_tpu_torch.preprocess.parsing import infer as pinf
    from imagdressing_tpu_torch.tools.profile_parse import person_photo

    t0 = time.perf_counter()
    parsing = pinf.Parsing.init_random(0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    img = person_photo(1024, 768, 0)
    t0 = time.perf_counter()
    parse, face = parsing(img)
    first_s = time.perf_counter() - t0
    _check_parse_contract(parse, face, img.shape[:2])
    image = torch.from_numpy(img).cuda()
    finite = {name: bool(torch.isfinite(parsing.logits(
                  image, getattr(parsing, name), n, size)).all())
              for name, n, size in (("atr", 18, 512), ("lip", 20, 473))}
    if not all(finite.values()):
        raise SmokeFailure(f"non-finite parser logits: {finite}")

    # the counted run: one call, counts reset just before, read just after
    counter.reset()
    again, _ = parsing(img)
    launches = counter.count
    by_shape = {str(k): v for k, v in counter.by_shape.items()}
    # K7's least time over the whole parse: each launch reads x and writes y
    bound_ms = sum(2.0 * 4 * math.prod(shape) * n
                   for (shape, _, _), n in counter.by_shape.items()
                   ) / HBM_BYTES_PER_S * 1e3
    if not np.array_equal(again, parse):
        raise SmokeFailure("the same photo gave another parse map")

    torch.cuda.reset_peak_memory_stats()
    wall, device, refine = [], [], []
    for _ in range(PARSES):
        t0 = time.perf_counter()
        parsing(img)
        wall.append(time.perf_counter() - t0)
        device.append(parsing.last_device_ms)
        refine.append(parsing.last_stage_seconds["refine"])

    def median(v):
        return sorted(v)[len(v) // 2]

    emit("parse", photo="1024x768", nets="ATR 512 + LIP 473, fp32",
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32, init_s=init_s,
         first_call_s=first_s, call_s=median(wall), call_s_all=wall,
         device_ms={k: median([d[k] for d in device]) for k in device[0]},
         device_ms_all=device, refine_s=median(refine),
         peak_gib=torch.cuda.max_memory_allocated() / 2**30,
         bn_act_launches=launches, bn_act_bound_ms_per_parse=bound_ms,
         bn_act_by_shape=by_shape,
         labels=sorted(int(v) for v in np.unique(parse)))
    if launches != 238:  # 119 InPlaceABNs in each of the two nets
        raise SmokeFailure(f"K7 launched {launches} times in one parse")
    return launches


# the OpenPose nets, card (TF32 off) vs CPU: fp32 sum-order differences
# through 30-40 cuDNN convs, relative to max|ref|, as PARSE_RTOL
OPENPOSE_RTOL = 1e-3
# the person mask, card (TF32 off) vs CPU: a share of pixels; the parse
# beneath it is held at PARSE_AGREE, and the mask's dilations widen a
# flipped parse pixel into a 21x21 patch at most
MASK_AGREE = 0.99


def _max_err(got, want, rtol):
    import torch

    got, want = torch.as_tensor(got).float(), torch.as_tensor(want).float()
    ref = want.abs().max().item()
    return dict(max_abs_err=(got - want).abs().max().item(), max_abs_ref=ref,
                tol=rtol * ref, finite=bool(torch.isfinite(got).all()))


def phase_openpose_check():
    """The OpenPose body, hand and face nets at full width, on the card and
    on the CPU with the same random weights, TF32 off: the body's PAF and
    heatmap at a 384x512 person photo's size (the net at 184x138), the
    hand's heatmaps of a 368-px crop at scale 1 (128x128), the face's of a
    384-px crop (384x384); then each side's keypoints."""
    import numpy as np
    import torch

    from imagdressing_tpu_torch.preprocess.openpose.face import Face, FaceNet
    from imagdressing_tpu_torch.preprocess.openpose.hand import (
        Hand,
        HandPoseNet,
    )
    from imagdressing_tpu_torch.preprocess.openpose.infer import OpenPose
    from imagdressing_tpu_torch.preprocess.openpose.model import BodyPoseNet
    from imagdressing_tpu_torch.tools.profile_parse import person_photo

    body = person_photo(512, 384, 2)
    hand_crop = person_photo(368, 368, 3)[..., ::-1].copy()
    face_crop = person_photo(384, 384, 4)[..., ::-1].copy()
    pairs = {}
    for name, cls, wrap, seed in (("body", BodyPoseNet, OpenPose, 0),
                                  ("hand", HandPoseNet, Hand, 1),
                                  ("face", FaceNet, Face, 2)):
        net = cls.init_random(seed, "cpu")
        pairs[name] = (wrap(net, "cpu"), wrap(copy.deepcopy(net), "cuda"))
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    errs, keypoints = {}, {}
    try:
        cpu, gpu = pairs["body"]
        want = cpu.maps(torch.from_numpy(body))
        got = gpu.maps(torch.from_numpy(body).cuda())
        for name, g, w in zip(("paf", "heatmap"), got, want):
            errs[name] = _max_err(g.cpu(), w, OPENPOSE_RTOL)
        keypoints["body"] = [p(body)["pose_keypoints_2d"] for p in pairs[
            "body"]]
        cpu, gpu = pairs["hand"]
        errs["hand"] = _max_err(
            gpu.heatmaps(torch.from_numpy(hand_crop).cuda(), 368, 128),
            cpu.heatmaps(torch.from_numpy(hand_crop), 368, 128),
            OPENPOSE_RTOL)
        keypoints["hand"] = [p(hand_crop, scales=(1.0,)).tolist()
                             for p in pairs["hand"]]
        cpu, gpu = pairs["face"]
        errs["face"] = _max_err(gpu.heatmaps(face_crop),
                                cpu.heatmaps(face_crop), OPENPOSE_RTOL)
        keypoints["face"] = [p(face_crop).tolist() for p in pairs["face"]]
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    equal = {k: v[0] == v[1] for k, v in keypoints.items()}
    found = {k: int((np.asarray(v[1]) != 0).any(-1).sum())
             for k, v in keypoints.items()}
    ok = all(e["finite"] and e["max_abs_err"] <= e["tol"]
             for e in errs.values())
    emit("openpose_check", body="384x512 photo (net 184x138)",
         hand="368 crop, scale 1", face="384 crop", rtol=OPENPOSE_RTOL,
         maps=errs, keypoints_found_card=found, keypoints_equal=equal,
         keypoints_card={k: v[1] for k, v in keypoints.items()},
         keypoints_cpu={k: v[0] for k, v in keypoints.items()}, ok=ok)
    if not ok:
        raise SmokeFailure(f"OpenPose card vs CPU: {errs}")


def write_preprocess(root):
    """The person path's and the face fusion's random full-width nets as
    the reference's files under `root` (`write_checkpoints --preprocess`),
    the environment variables that name them set; -> the paths."""
    from imagdressing_tpu_torch.tools.write_checkpoints import (
        write_preprocess_checkpoints,
    )

    paths = write_preprocess_checkpoints(root, 0, "cuda")
    for k, v in paths.items():
        if k.startswith("IMAGDRESSING_"):
            os.environ[k] = v
    return paths


def phase_person(root):
    """`person_upper_body_mask` (OpenPose on the photo at 384x512, the SCHP
    parse of the photo, the mask at 512x512) on a synthetic 600x460 person
    photo from the written checkpoints: on the card and on the CPU with the
    same weights, TF32 off, the masks' pixel agreement; then with the
    served setting (cuDNN's default TF32) one warm call and 3 timed calls:
    the stages' wall times and the device time of the OpenPose and parse
    forwards."""
    import numpy as np
    import torch

    from imagdressing_tpu_torch.apps import image_utils as iu
    from imagdressing_tpu_torch.preprocess import mask as pmask
    from imagdressing_tpu_torch.preprocess.openpose import OpenPose
    from imagdressing_tpu_torch.preprocess.parsing.infer import Parsing
    from imagdressing_tpu_torch.tools.profile_parse import person_photo

    path = os.path.join(root, "person.png")
    iu.write_image(path, person_photo(600, 460, 5))
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        t0 = time.perf_counter()
        want = pmask.person_upper_body_mask(path, 512, 512, device="cpu")
        cpu_s = time.perf_counter() - t0
        got = pmask.person_upper_body_mask(path, 512, 512, device="cuda")
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    agree = float((got == want).mean())
    pose = OpenPose.get_default("cuda")
    keypoints = pose(iu.resize(iu.read_image(path), (384, 512), "bicubic"))
    found = int((np.asarray(keypoints["pose_keypoints_2d"]) != 0).any(
        -1).sum())
    stages, device = [], []
    for i in range(4):
        st = {}
        mask = pmask.person_upper_body_mask(path, 512, 512, device="cuda",
                                            stage_seconds=st)
        if i:
            stages.append(st)
            device.append(dict(
                openpose=pose.last_device_ms["body"],
                **Parsing.get_default("cuda").last_device_ms))

    def median(v):
        return sorted(v)[len(v) // 2]

    share = float(mask.mean())
    ok = agree >= MASK_AGREE and mask.shape == (1, 512, 512, 1) \
        and 0 < share < 1
    emit("person", photo="600x460", size="512x512", agree=agree,
         agree_min=MASK_AGREE, parse_agree_min=PARSE_AGREE,
         mask_share=share, mask_share_cpu=float(want.mean()),
         keypoints_found=found,
         why=("random weights: OpenPose assembles no person, so the arm "
              "bands fall back to the parsed arm labels"
              if found == 0 else "keypoints found"),
         cpu_call_s=cpu_s,
         stage_s={k: median([s[k] for s in stages]) for k in stages[0]},
         stage_s_all=stages,
         device_ms={k: median([d[k] for d in device]) for k in device[0]},
         ok=ok)
    if not ok:
        raise SmokeFailure(f"person mask: agree {agree}, share {share}, "
                           f"shape {mask.shape}")


def write_controlnet(root):
    """A full-width random ControlNet (output convs filled), bf16, as the
    reference's diffusers file under `root`; -> its directory."""
    import torch

    from imagdressing_tpu_torch.convert import export_torch as ex
    from imagdressing_tpu_torch.convert import tree_from_module
    from imagdressing_tpu_torch.convert.torch_sd import write_safetensors
    from imagdressing_tpu_torch.core.config import ControlNetConfig, UNetConfig
    from imagdressing_tpu_torch.models.controlnet import ControlNet
    from imagdressing_tpu_torch.ops.nn import init_module
    from imagdressing_tpu_torch.tools.profile_infer import fill_zero_convs

    with torch.device("meta"):
        cn = ControlNet(ControlNetConfig(unet=UNetConfig()))
    cn.to_empty(device="cuda")
    init_module(cn, torch.Generator(device="cuda").manual_seed(7))
    fill_zero_convs(cn)
    cn.to(torch.bfloat16)
    out = os.path.join(root, "controlnet")
    os.makedirs(out)
    write_safetensors(os.path.join(out, "diffusion_pytorch_model.safetensors"),
                      ex.torch_state_dict(ex.export_controlnet(
                          tree_from_module(cn))))
    return out


def phase_dress_person(paths, counters):
    """`apps.dress.main` with `--preset inpaint --model_dir P --cloth_dir
    G` on the written files (the `basic` stack, a ControlNet, the
    preprocessing nets), 2 person photos x 2 garments at batch 1, STEPS
    steps: 4 collages under JAX's `_out_name` names; K1-K4 launches of the
    run equal to 4 x `expected_launches` of one inpaint image, K7's to 2 x
    238 (one parse per person: the person cache); each image's wall."""
    from imagdressing_tpu_torch.apps import dress
    from imagdressing_tpu_torch.apps import image_utils as iu
    from imagdressing_tpu_torch.core.config import PRESETS
    from imagdressing_tpu_torch.pipelines import dressing
    from imagdressing_tpu_torch.tools.profile_parse import person_photo

    root = os.path.dirname(paths["base_dir"])
    cloth_dir, person_dir, out_dir = (os.path.join(root, d) for d in (
        "person_cloths", "persons", "person_out"))
    os.makedirs(cloth_dir)
    os.makedirs(person_dir)
    for i in range(2):
        iu.write_image(os.path.join(cloth_dir, f"top_{i}.png"),
                       _garment(30 + i))
        iu.write_image(os.path.join(person_dir, f"model_{i}.png"),
                       person_photo(600, 460, 10 + i))
    calls = []
    call = dressing.DressingPipeline.__call__

    def timed(self, **kw):
        t0 = time.perf_counter()
        out = call(self, **kw)
        calls.append(time.perf_counter() - t0)
        return out

    for c in counters.values():
        c.reset()
    dressing.DressingPipeline.__call__ = timed
    t0 = time.perf_counter()
    try:
        dress.main(["--base_dir", paths["base_dir"],
                    "--vae_path", paths["vae_path"],
                    "--image_encoder_path", paths["image_encoder_path"],
                    "--model_ckpt", paths["model_ckpt"],
                    "--controlnet_path", paths["controlnet_path"],
                    "--preset", "inpaint", "--cloth_dir", cloth_dir,
                    "--model_dir", person_dir,
                    "--num_inference_steps", str(STEPS),
                    "--output_path", out_dir, "--device", "cuda"])
    finally:
        dressing.DressingPipeline.__call__ = call
    wall_s = time.perf_counter() - t0
    launches = {k: c.count for k, c in counters.items()}
    preset = PRESETS["inpaint"]
    used = STEPS - max(STEPS - int(STEPS * preset.strength), 0)
    one = expected_launches(used, True, 2)
    want = {k: 4 * v for k, v in one.items()}
    want["bn_act"] = 2 * 238
    saved = sorted(os.listdir(out_dir))
    names = [f"model_{p}_top_{c}.png" for p in range(2) for c in range(2)]
    shapes = {n: list(iu.read_image(os.path.join(out_dir, n)).shape)
              for n in saved}
    ok = saved == names and launches == want and len(calls) == 4 \
        and all(v == [preset.height, 2 * preset.width, 3]
                for v in shapes.values())
    emit("dress_person", preset="inpaint", persons=2, garments=2,
         steps=STEPS, used_steps=used, wall_s=wall_s, image_s=calls,
         prep_and_load_s=wall_s - sum(calls), saved=saved,
         collage_shapes=shapes, launches=launches, expected_launches=want,
         ok=ok)
    if not ok:
        raise SmokeFailure(f"dress_person: saved {saved}, launches "
                           f"{launches} != {want}, calls {len(calls)}")
    if iu.read_image(os.path.join(out_dir, names[0]))[
            :, preset.width:].std() == 0:
        raise SmokeFailure("dress_person: a constant result")


def phase_serve_fusion(paths, facenet):
    """The server (`apps.serve`: handler, worker) with the post-process
    `load_post_process("face_fusion:<facenet.pth>", "cuda")` over the
    loaded `basic` stack, STEPS steps: one request with a `fusion_face`
    PNG and one without, same garment and seed. The response without a
    face is bit-equal to a direct pipeline call's image; the one with a
    face equals `FaceFusion(openpose_landmark_fn(Face))` called directly on
    that image and face (the template itself where fewer than 3 landmarks
    are found on both), through the worker's uint8 conversion."""
    import base64
    import json
    import urllib.request
    from http.server import ThreadingHTTPServer

    import numpy as np

    from imagdressing_tpu_torch.apps import image_utils as iu
    from imagdressing_tpu_torch.apps.loader import load_dressing_models
    from imagdressing_tpu_torch.apps.png import decode_png, encode_png
    from imagdressing_tpu_torch.apps.serve import (
        InferenceWorker,
        garment_inputs,
        load_post_process,
        make_handler,
    )
    from imagdressing_tpu_torch.apps.tokenizer import load_tokenizer
    from imagdressing_tpu_torch.core.config import PRESETS
    from imagdressing_tpu_torch.pipelines.dressing import DressingPipeline
    from imagdressing_tpu_torch.postprocess.face_fusion import (
        FaceFusion,
        openpose_landmark_fn,
    )
    from imagdressing_tpu_torch.preprocess.openpose.face import Face
    from imagdressing_tpu_torch.tools.profile_parse import person_photo

    models = load_dressing_models(
        **{k: v for k, v in paths.items() if k != "controlnet_path"},
        device="cuda")
    preset = dataclasses.replace(PRESETS["basic"], num_inference_steps=STEPS)
    pipe = DressingPipeline(models, preset)
    tokenizer = load_tokenizer(os.path.join(paths["base_dir"], "tokenizer"))
    post = load_post_process(f"face_fusion:{facenet}", "cuda")
    worker = InferenceWorker(pipe, tokenizer, max_batch=4, post_process=post)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(worker, preset))
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    cloth = encode_png(_garment(40))
    face = person_photo(256, 256, 41)
    face_png = base64.b64encode(encode_png(face)).decode()
    out = {}
    try:
        for name, extra in (("plain", {}), ("face", {"fusion_face":
                                                     face_png})):
            body = dict(prompt="a woman in a dress", seed=42, steps=STEPS,
                        cloth_image=base64.b64encode(cloth).decode(),
                        **extra)
            req = urllib.request.Request(
                f"http://127.0.0.1:{httpd.server_address[1]}/dress",
                data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            t0 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=900) as resp:
                r = json.loads(resp.read())
            out[name] = (decode_png(base64.b64decode(r["image"])),
                         time.perf_counter() - t0)
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.join(30)
    ref, clip = garment_inputs(iu.read_image(cloth), preset,
                               models.vision_cfg.image_size)
    direct = pipe(prompt_ids=tokenizer("a woman in a dress")[None],
                  negative_prompt_ids=tokenizer(iu.DEFAULT_NEGATIVE)[None],
                  ref_image=ref, ref_clip_image=clip, seed=42,
                  num_inference_steps=STEPS, output_uint8=True)[0]
    landmark_fn = openpose_landmark_fn(Face.from_torch(facenet, "cuda"))
    template = direct.astype(np.float32) / 255.0
    fused = FaceFusion(landmark_fn)(template, face)
    want = np.clip(np.asarray(fused, np.float32) * 255.0, 0,
                   255).round().astype(np.uint8)
    counts = {}
    for name, img in (("result", direct), ("face", face)):
        lm = landmark_fn(img)
        counts[name] = 0 if lm is None else int((lm != 0).any(-1).sum())
    plain_equal = bool(np.array_equal(out["plain"][0], direct))
    fused_equal = bool(np.array_equal(out["face"][0], want))
    unchanged = bool(np.array_equal(want, direct))
    ok = plain_equal and fused_equal
    emit("serve_fusion", preset="basic", steps=STEPS,
         round_trip_s={k: v[1] for k, v in out.items()},
         landmarks_found=counts, fused_is_template=unchanged,
         plain_bit_equal_direct=plain_equal,
         face_equal_direct_fusion=fused_equal, ok=ok)
    if not ok:
        raise SmokeFailure(f"serve_fusion: plain {plain_equal}, fused "
                           f"{fused_equal}")
    worker.pipe = None


# ---------------------------------------------------------------------------
# The SCHP fine-tune, its eval and the try-on metrics
# ---------------------------------------------------------------------------

# the training-mode ABN at SCHP's shapes (layer1 at 473, layer3/4's widths)
ABN_TRAIN_SHAPES = [(1, 119, 119, 256), (1, 60, 60, 512), (1, 60, 60, 2048)]
# card fp32 against the CPU's float64: y and the moments within 1e-5, the
# gradients (fp32 sums over up to 14161 rows) within 1e-4, of max |ref|
ABN_TRAIN_RTOL = {"y": 1e-5, "mean": 1e-5, "var": 1e-5, "dx": 1e-4,
                  "dw": 1e-4, "db": 1e-4}
PARSE_PAIRS = 8
# SCHP fine-tune steps card vs CPU (TF32 off), each from the same state:
# the loss (relative), all parameter gradients in L2 and each leaf's in L2
# (relative), each running statistic (relative to its max). Rounding alone
# moves a gradient of this train-mode net by a few % (two XLA compiles of
# JAX's own trunk differ by 1.8 % in L2: tests/test_torch_parsing_steps.py);
# measured on an H100 80GB HBM3, 700 W (steps 0, 1): loss 0, 3.5e-6; all 2.0e-2, 5.4e-2;
# the worst leaf 2.8e-2, 7.2e-2; statistics 1.2e-4, 2.1e-4
PARSE_TRAIN_TOL = dict(loss=1e-5, l2=0.1, leaf_l2=0.15, stats=5e-4)
K7_PER_FORWARD = 119


def phase_abn_train_check(counter):
    """`abn_train_stats` forward and backward on the card, fp32, at
    ABN_TRAIN_SHAPES for each activation, against the CPU plain path in
    float64 on the same inputs; one K7 launch per forward."""
    import torch

    from imagdressing_tpu_torch.kernels import fused_bn_act as fba

    errs, ok = {}, True
    counter.reset()
    for seed, shape in enumerate(ABN_TRAIN_SHAPES):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        c = shape[-1]
        x = torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5
        w = 1 + 0.3 * torch.randn(c, generator=gen, device="cuda")
        b = 0.3 * torch.randn(c, generator=gen, device="cuda")
        g = torch.randn(shape, generator=gen, device="cuda")
        for act in fba.ACTIVATIONS:
            sides = {}
            for dev, dt in (("cuda", torch.float32), ("cpu", torch.float64)):
                leaves = [t.detach().to(dev, dt).requires_grad_()
                          for t in (x, w, b)]
                y, mean, var = fba.abn_train_stats(*leaves, activation=act)
                (y * g.to(dev, dt)).sum().backward()
                sides[dev] = dict(zip(ABN_TRAIN_RTOL, (
                    t.detach().double().cpu() for t in
                    (y, mean, var, *(v.grad for v in leaves)))))
            row = {}
            for k, rtol in ABN_TRAIN_RTOL.items():
                got, want = sides["cuda"][k], sides["cpu"][k]
                err = (got - want).abs().max().item()
                tol = rtol * want.abs().max().item()
                row[k] = dict(max_abs_err=err, tol=tol)
                ok &= math.isfinite(err) and err <= tol
            errs["x".join(map(str, shape)) + act] = row
    launches = counter.count
    ok &= launches == len(ABN_TRAIN_SHAPES) * len(fba.ACTIVATIONS)
    emit("abn_train_check", dtype="fp32 card vs float64 CPU",
         rtol=ABN_TRAIN_RTOL, cases=errs, bn_act_launches=launches, ok=ok)
    if not ok:
        raise SmokeFailure(f"abn_train: {errs}, K7 launches {launches}")


def write_parsing_data(root):
    """PARSE_PAIRS synthetic 600x460 JPEG person photos and 18-class label PNGs (a
    band of each label, the head's rows ignored as 255) -> (image_dir,
    label_dir)."""
    import numpy as np

    from imagdressing_tpu_torch.apps import image_utils as iu
    from imagdressing_tpu_torch.tools.profile_parse import person_photo

    image_dir, label_dir = (os.path.join(root, d) for d in (
        "parse_images", "parse_labels"))
    os.makedirs(image_dir)
    os.makedirs(label_dir)
    for i in range(PARSE_PAIRS):
        photo = person_photo(600, 460, 70 + i)
        iu.write_image(os.path.join(image_dir, f"p{i}.jpg"), photo)
        gray = photo.astype(np.int64).sum(-1)
        label = ((gray * 18) // (3 * 256 + 1) + i) % 18
        label[:40] = 255
        iu.write_image(os.path.join(label_dir, f"p{i}.png"),
                       label.astype(np.uint8))
    return image_dir, label_dir


def _parse_step_compare():
    """Two SCHP fine-tune steps at 64x64 (batch 2, 6 classes; bn3.weight
    0.25 in every bottleneck, as the CPU test) on the CPU and, from the
    CPU's state before each step (parameters, statistics, momentum), on the
    card, TF32 off. Per step, card vs CPU: the loss, every parameter's
    gradient (each leaf and all leaves in L2), each running statistic
    relative to its max |value|."""
    import numpy as np
    import torch

    from imagdressing_tpu_torch.preprocess.parsing import model as schp
    from imagdressing_tpu_torch.train import parsing_train as pt

    cpu = schp.init(0, 6, "cpu").requires_grad_(True)
    for name, m in cpu.named_modules():
        if name.endswith("bn3"):
            m.weight.data.fill_(0.25)
    gpu = copy.deepcopy(cpu).cuda()
    cfg = pt.ParsingTrainConfig(num_classes=6, learning_rate=2e-2,
                                total_steps=100)
    rng = np.random.default_rng(0)
    label = rng.integers(0, 6, (2, 64, 64))
    batch = {"image": torch.from_numpy(rng.standard_normal(
                 (2, 64, 64, 3)).astype(np.float32)),
             "label": torch.from_numpy(label),
             "edge": torch.from_numpy(pt.edges_from_labels(label))}
    opt_c, opt_g = pt.make_optimizer(cfg, cpu), pt.make_optimizer(cfg, gpu)
    step_c = pt.make_parsing_train_step(cfg, cpu, opt_c)
    step_g = pt.make_parsing_train_step(cfg, gpu, opt_g)
    batch_g = {k: v.cuda() for k, v in batch.items()}

    rows = []
    for i in range(2):
        gpu.load_state_dict(cpu.state_dict())
        for pc, pg in zip(cpu.parameters(), gpu.parameters()):
            m = opt_c.state[pc].get("momentum_buffer")
            if m is not None:
                opt_g.state[pg]["momentum_buffer"] = m.clone().cuda()
        loss_g = float(step_g(i, batch_g)["loss"])
        loss_c = float(step_c(i, batch)["loss"])
        sq_err = sq_ref = leaf = 0.0
        for pc, pg in zip(cpu.parameters(), gpu.parameters()):
            want = pc.grad.double()
            err = pg.grad.double().cpu() - want
            leaf = max(leaf, (err.norm() / want.norm()).item())
            sq_err += (err * err).sum().item()
            sq_ref += (want * want).sum().item()
        stats = max(((bg.cpu() - bc).abs().max() / bc.abs().max()).item()
                    for (k, bc), bg in zip(cpu.named_buffers(),
                                           gpu.buffers()) if "running" in k)
        rows.append(dict(loss_cpu=loss_c, loss_card=loss_g,
                         loss_rel=abs(loss_g - loss_c) / abs(loss_c),
                         grad_l2_rel=(sq_err / sq_ref) ** 0.5,
                         worst_leaf_l2_rel=leaf, stats_rel=stats))
    tol = PARSE_TRAIN_TOL
    ok = all(r["loss_rel"] <= tol["loss"] and r["grad_l2_rel"] <= tol["l2"]
             and r["worst_leaf_l2_rel"] <= tol["leaf_l2"]
             and r["stats_rel"] <= tol["stats"] for r in rows)
    return rows, ok


def phase_parse_train(root, counters):
    """`apps.parsing_cli.main(["train", ...])` at its defaults (ResNet-101
    AugmentCE2P at full width and depth, 18 classes, 473x473, fp32 with
    cuDNN's TF32 convs) on PARSE_PAIRS written pairs: 6 steps at batch 1,
    then 4 steps at --batch_size 4 restored from the first run's
    params.npz. Per run: the loss of each step (finite), s/step (the
    median after the first), peak memory, the launches of every kernel
    (K7: 119 a step, the train-mode ABNs' apply; no other kernel), the
    running statistics moved from where the run started (a fresh net's
    zeros, the restored file's); then 2 steps at 64x64 card vs CPU (TF32
    off). -> the batch-4 run's params.npz and the data dirs."""
    import numpy as np
    import torch

    from imagdressing_tpu_torch.apps import parsing_cli

    image_dir, label_dir = write_parsing_data(root)
    runs, params, ok = {}, None, True
    for batch, steps in ((1, 6), (4, 4)):
        out = os.path.join(root, f"parse_run_b{batch}")
        argv = ["train", "--image_dir", image_dir, "--label_dir", label_dir,
                "--out_dir", out, "--steps", str(steps), "--batch_size",
                str(batch), "--log_every", str(steps)]
        if params:
            argv += ["--restore", params]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.reset()
        t0 = time.perf_counter()
        res = parsing_cli.main(argv)
        wall = time.perf_counter() - t0
        launches = {k: c.count for k, c in counters.items()}
        want = {k: (K7_PER_FORWARD * steps if k == "bn_act" else 0)
                for k in counters}
        start = (np.load(params)["bn1/running_mean"] if params
                 else np.zeros_like(np.load(res["params"])[
                     "bn1/running_mean"]))
        params = res["params"]
        stats = np.load(params)["bn1/running_mean"]
        finite = all(math.isfinite(v) for v in res["losses"])
        moved = bool(np.abs(stats - start).max() > 0)
        runs[f"b{batch}"] = dict(
            steps=steps, s_per_step=sorted(res["step_s"][1:])[
                len(res["step_s"][1:]) // 2], step_s=res["step_s"],
            wall_s=wall, peak_gib=torch.cuda.max_memory_allocated() / 2**30,
            losses=res["losses"], finite=finite, running_stats_moved=moved,
            launches=launches, expected_launches=want,
            launches_per_step={k: v / steps for k, v in launches.items()})
        ok &= finite and moved and launches == want
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        rows, same = _parse_step_compare()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    emit("parse_train", model="SCHP ResNet-101 AugmentCE2P, 18 classes",
         input="473x473 fp32, TF32 convs", pairs=PARSE_PAIRS,
         photo="600x460", runs=runs, card_vs_cpu_64=rows,
         card_vs_cpu_tol=PARSE_TRAIN_TOL, ok=ok and same)
    if not (ok and same):
        raise SmokeFailure(f"parse_train: {runs}, card vs CPU {rows}")
    return params, image_dir, label_dir


def phase_parse_eval(root, params, image_dir, label_dir, counter):
    """`apps.parsing_cli.main(["eval", ..., "--flip", "--scales",
    "0.75,1.0,1.25", "--save_dir", ...])` on the fine-tuned params.npz:
    the mIoU (in [0, 1]), s/image, the PNGs written, and K7's launches,
    exactly 714 (6 forwards of 119 ABNs) per image."""
    from imagdressing_tpu_torch.apps import image_utils as iu
    from imagdressing_tpu_torch.apps import parsing_cli

    preds = os.path.join(root, "parse_preds")
    counter.reset()
    t0 = time.perf_counter()
    miou = parsing_cli.main(["eval", "--image_dir", image_dir, "--label_dir",
                             label_dir, "--restore", params, "--flip",
                             "--scales", "0.75,1.0,1.25", "--save_dir",
                             preds])
    wall = time.perf_counter() - t0
    launches = counter.count
    saved = sorted(os.listdir(preds))
    shapes = {iu.read_image(os.path.join(preds, n)).shape for n in saved}
    want = 6 * K7_PER_FORWARD * PARSE_PAIRS
    ok = 0.0 <= miou <= 1.0 and launches == want \
        and len(saved) == PARSE_PAIRS and shapes == {(473, 473, 3)}
    emit("parse_eval", scales=[0.75, 1.0, 1.25], flip=True,
         images=PARSE_PAIRS, miou=miou, wall_s=wall,
         s_per_image=wall / PARSE_PAIRS, pngs=len(saved),
         bn_act_launches=launches, expected_launches=want, ok=ok)
    if not ok:
        raise SmokeFailure(f"parse_eval: mIoU {miou}, K7 {launches} != "
                           f"{want}, saved {saved}")


def fixed_face_embedding(path):
    """The grid's face embedder (`--face_embedder chip_smoke:
    fixed_face_embedding`): a fixed unit 512-vector per file name."""
    import hashlib

    import numpy as np

    seed = int(hashlib.md5(os.path.basename(path).encode()).hexdigest()[:8],
               16)
    v = np.random.default_rng(seed).standard_normal(512)
    return v / np.linalg.norm(v)


def _run_cli(main, argv):
    """-> (what `main(argv)` printed, its return value)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ret = main(argv)
    return buf.getvalue(), ret


def phase_eval(root, pre):
    """The try-on metrics through `eval.cli.main`: `cami-u` over the dress
    phase's 5 garments and their results (each collage's right half as
    the generated garment crop); `cami-s-grid` over 2 prompts x 2 poses x
    2 faces x 2 garments of those results, with a random full-width
    ViT-B/32 written as a transformers CLIPModel state dict, the OpenPose
    body net of write_preprocess's files and `fixed_face_embedding`, all on
    the card. Then the CLIP text and image embed ms and an OpenPose call's
    wall."""
    import numpy as np
    import torch

    from imagdressing_tpu_torch.apps import image_utils as iu
    from imagdressing_tpu_torch.apps.tokenizer import HashTokenizer
    from imagdressing_tpu_torch.core.config import PRESETS
    from imagdressing_tpu_torch.eval import cli as eval_cli
    from imagdressing_tpu_torch.eval.clip_score import ClipScorer
    from imagdressing_tpu_torch.preprocess.openpose.draw import draw_bodypose
    from imagdressing_tpu_torch.preprocess.openpose.infer import OpenPose
    from imagdressing_tpu_torch.tools.profile_parse import person_photo
    from imagdressing_tpu_torch.tools.write_checkpoints import (
        clip_scorer_state_dict,
    )

    width = PRESETS["basic"].width
    cloths, out = (os.path.join(root, d) for d in ("cloths", "out"))
    crops = os.path.join(root, "gen_crops")
    os.makedirs(crops)
    names = sorted(os.listdir(cloths))
    results = []
    for n in names:
        result = iu.read_image(os.path.join(out, n))[:, width:]
        iu.write_image(os.path.join(crops, n), result)
        results.append(result)
    t0 = time.perf_counter()
    cami_u_line, _ = _run_cli(eval_cli.main, [
        "cami-u", "--cloth_path", cloths, "--cloth_mask_path", crops])
    cami_u_s = (time.perf_counter() - t0) / len(names)
    cami_u = float(cami_u_line.split(":")[-1])

    grid = {d: os.path.join(root, "grid", d) for d in (
        "pose", "face", "cloth", "generated", "cloth_mask")}
    for d in grid.values():
        os.makedirs(d)
    rng = np.random.default_rng(0)
    for j in range(2):
        kps = rng.uniform((40, 60), (340, 460), (18, 2))
        iu.write_image(os.path.join(grid["pose"], f"pose{j}.png"),
                       draw_bodypose(kps, 512, 384))
        iu.write_image(os.path.join(grid["face"], f"face{j}.png"),
                       person_photo(256, 256, 80 + j))
    for c in range(2):
        iu.write_image(os.path.join(grid["cloth"], names[c]),
                       iu.read_image(os.path.join(cloths, names[c])))
        for i in range(2):
            for j in range(2):
                for k in range(2):
                    cell = f"pt_{i}_pose_{j}_face_{k}_{names[c]}"
                    img = results[(c + 2 * j + k) % len(results)]
                    for d in ("generated", "cloth_mask"):
                        iu.write_image(os.path.join(grid[d], cell), img)
    clip_path = os.path.join(root, "clip-vit-b32.bin")
    torch.save(clip_scorer_state_dict(0, "cuda"), clip_path)
    out_json = os.path.join(root, "grid.json")
    prompts = ["a woman in a red dress", "a man in a blue shirt"]
    argv = ["cami-s-grid", "--pose_path", grid["pose"], "--face_path",
            grid["face"], "--cloth_path", grid["cloth"], "--cloth_mask_path",
            grid["cloth_mask"], "--model_path", grid["generated"],
            "--clip_model", clip_path, "--openpose_ckpt",
            pre["IMAGDRESSING_OPENPOSE_CKPT"], "--face_embedder",
            "chip_smoke:fixed_face_embedding", "--num_faces", "2",
            "--out_json", out_json, "--device", "cuda"]
    for p in prompts:
        argv += ["--prompt", p]
    t0 = time.perf_counter()
    grid_line, _ = _run_cli(eval_cli.main, argv)
    grid_s = time.perf_counter() - t0
    with open(out_json) as f:
        result = json.load(f)

    # the scorer's and OpenPose's own times, after a warm call
    scorer = ClipScorer.from_state_dict(torch.load(clip_path),
                                        tokenizer=HashTokenizer(),
                                        device="cuda")
    ids = scorer.tokenizer(prompts[0])[None]
    image = results[0][None].astype(np.float32) / 255.0

    def ms(fn, reps=10):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / reps * 1e3

    text_ms = ms(lambda: scorer.text_embed(ids))
    image_ms = ms(lambda: scorer.image_embed(image))
    pose = OpenPose.from_torch(pre["IMAGDRESSING_OPENPOSE_CKPT"], "cuda")
    view = np.ascontiguousarray(results[0][64:576])[:, 64:448]
    openpose_ms = ms(lambda: pose(view), reps=3)
    cells = result["cells"]
    terms = {k: [c[k] for c in cells if k in c] for k in (
        "cami_us", "pose_term", "face_term", "clip_term")}
    finite = all(math.isfinite(v) for v in
                 [cami_u, result["cami_s_score"]]
                 + [v for t in terms.values() for v in t])
    ok = finite and result["num_cells"] == 16 and result["num_missing"] == 0 \
        and all(-1.0001 <= v <= 1.0001 for v in terms["clip_term"])
    emit("eval", cami_u=cami_u, cami_u_line=cami_u_line.strip(),
         grid_line=grid_line.strip().splitlines()[-1],
         cami_s_score=result["cami_s_score"], cells=result["num_cells"],
         missing=result["num_missing"], terms=terms,
         why_pose_zero=("random OpenPose weights assemble no person, so the "
                        "generated render is empty"
                        if not any(terms["pose_term"]) else None),
         cami_u_s_per_garment=cami_u_s, grid_wall_s=grid_s,
         grid_s_per_cell=grid_s / result["num_cells"],
         clip_text_embed_ms=text_ms, clip_image_embed_ms=image_ms,
         openpose_call_ms=openpose_ms, ok=ok)
    if not ok:
        raise SmokeFailure(f"eval: CAMI-U {cami_u}, grid {result}")



def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        from imagdressing_tpu_torch.kernels import (
            _build,
            flash_attention as fa,
            fused_bn_act as fba,
            fused_gn_conv as fgc,
            fused_groupnorm as fg,
        )
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2

    dev = dict(platform="gpu", kind=torch.cuda.get_device_name(0),
               count=torch.cuda.device_count())
    emit("device", **dev, nvidia_smi=nvidia_smi(), torch=torch.__version__,
         cuda=torch.version.cuda)

    t0 = time.perf_counter()
    per_source = _build.build()
    emit("build", wall_s=time.perf_counter() - t0, per_source_s=per_source)

    try:
        errs = phase_check()
        phase_abn_train_check(fba.COUNTER)
        phase_determinism()
        phase_mini()
        phase_mini_presets()
        phase_mini_train()
        phase_parse_check()
        timings = phase_time()
        inference = {"flash_fwd": fa.COUNTER, "gn_silu_conv3x3": fgc.COUNTER,
                     "group_norm_act": fg.COUNTER}
        counts = phase_main(inference)
        phase_presets(inference, {
            "flash_fwd": counts["flash_fwd"],
            "gn_silu_conv3x3": counts["gn_silu_conv3x3"]
            + counts["gn_silu_conv3x3[vae_pixel]"],
            "group_norm_act": counts["group_norm_act"]})
        training = {"flash_fwd": fa.COUNTER, "gn_silu_conv3x3": fgc.COUNTER,
                    "group_norm_act": fg.COUNTER,
                    "flash_fwd_res": fa.RES_COUNTER,
                    "flash_bwd_dkv": fa.DKV_COUNTER,
                    "flash_bwd_dq": fa.DQ_COUNTER}
        train = phase_train(training)
        phase_remat(training)
        counts["bn_act"] = phase_parse(fba.COUNTER)
        with tempfile.TemporaryDirectory(prefix="_ckpt_smoke_",
                                         dir=ROOT) as root:
            models, paths = phase_load(root)
            phase_serve(models, paths, inference)
            del models
            phase_dress(paths)
            phase_train_cli(paths, training)
            phase_openpose_check()
            pre = write_preprocess(root)
            phase_person(root)
            paths["controlnet_path"] = write_controlnet(root)
            phase_dress_person(paths, dict(inference, bn_act=fba.COUNTER))
            phase_serve_fusion(paths, pre["facenet"])
            all_kernels = dict(training, bn_act=fba.COUNTER)
            params, image_dir, label_dir = phase_parse_train(root,
                                                             all_kernels)
            phase_parse_eval(root, params, image_dir, label_dir, fba.COUNTER)
            phase_eval(root, pre)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    for name in ("flash_fwd_res", "flash_bwd_dkv", "flash_bwd_dq"):
        counts[name] = train[name]  # launches in the counted training run

    kernels = []
    for name, row in timings.items():
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name], launches=counts[name],
            max_abs_err=errs[name], ms=row["ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=row["library_ms"]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
