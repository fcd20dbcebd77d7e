#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`imagdressing_tpu_torch`) on one CUDA card.

Phases, each printing one line:
  1. device: the card's name, count, and `nvidia-smi` name and power limit;
  2. build: the CUDA kernels, compiled from `imagdressing_tpu_torch/kernels/
     csrc` with one nvcc per source, all at once;
  3. check: every kernel against its plain PyTorch version on the card, in
     bf16 and fp32, at the main paths' shapes: the inference kernels (K1
     also at ragged lengths), the training forward with residuals and both
     backward kernels (with K6b's D_i, and at ragged lengths), the GN+conv
     at the deep UNet levels (split K) and at a ragged shape, and the
     gradients of the GN+conv and GroupNorm autograd Functions, K3 at the
     four UNet levels at batch 2 and 1, with the temb fold, at a ragged
     shape and at a VAE pixel level (streaming); then determinism: K1, K5,
     the backward pair, the GN+conv (split K, not, and streaming) and K3
     (resident and streaming) twice on the same inputs must give
     bit-identical results;
  4. mini: a small fp32 stack run end to end on the card and on the CPU (the
     CPU runs every kernel's plain version): the outputs must agree;
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
  8. train: the training step (`train.step`) at full SD1.5 width, 512x640,
     batch 1, bf16 frozen models and fp32 master weights, block remat: one
     warm step, then TRAIN_STEPS timed steps with s/step, peak memory, the
     loss and gradient norm of each step and each kernel's launches;
  9. parse_check: the SCHP human parser (ATR 512 + LIP 473, ResNet-101 at
     full width, random weights) on a 200x150 photo on the card and on the
     CPU with the same weights: the logits of both nets and the parse maps
     must agree (TF32 off);
 10. parse: `Parsing.__call__` at full width on a 1024x768 synthetic person
     photo, cuDNN's default TF32 convs: one warm call, one counted call
     (K7's launches), then PARSES timed calls with the median wall time, the
     device time of both forwards, the host refinement's time, peak memory.
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
    `scale` the ref scales (default [0, 1] at batch 2, the CFG batch).
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
        if scale is None:
            scale = [0.0, 1.0] if b == 2 else [1.0] * b
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
    leaf's gradient; the Function's output must carry its grad_fn."""
    import torch

    def kernel():
        y = fn(*leaves)
        name = type(y.grad_fn).__name__
        if not name.endswith("FunctionBackward"):
            raise SmokeFailure(f"no kernel Function on the graph: {name}")
        return torch.autograd.grad(y, leaves, g)

    return dict(kernel=kernel,
                plain=lambda: torch.autograd.grad(plain(*leaves), leaves, g),
                outputs=tuple(f"d{i}" for i in range(len(leaves))))


def gn_conv_grad_case(dtype, seed):
    """K2's Function (kernel forward, recomputed reference backward) at the
    top UNet level of a batch-1 training step."""
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
    return _grad_case(
        lambda x, gw, gb, w_, cb, t: fgc.gn_silu_conv3x3(x, gw, gb, w_, cb,
                                                         add=t, **kw),
        lambda x, gw, gb, w_, cb, t: fgc.gn_silu_conv3x3_plain(
            x, gw, gb, w_, cb, add=t, **kw),
        leaves, rnd((b, h, w, co)))


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
                  (1, 160, 128, 512, 512, False), (1, 9, 13, 40, 24, False)]
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
            ((1, 327680, 128), "silu", 32, True)]
K3_TIMED = [group_norm_label(*a) for a in GN_CASES[:4]]


# K5 / K6 check shapes: the four UNet self-attention levels of a batch-1
# training step, dual (main UNet, scale 1) and single (garment UNet), and a
# batch-2 case with scale [0, 0.7] (the zero-written reference gradients)
TRAIN_FLASH_SHAPES = [(1, 5120, 8, 40), (1, 1280, 8, 80), (1, 320, 8, 160),
                      (1, 80, 8, 160)]


def check_cases():
    """(kernel name, shape label, case factory(dtype, seed))."""
    cases = []
    for b, s, h, d, dual in [(2, 5120, 8, 40, True), (2, 1280, 8, 80, True),
                             (2, 320, 8, 160, True), (2, 80, 8, 160, True),
                             (1, 5120, 1, 512, False)]:
        cases.append(("flash_fwd", f"{b}x{s}x{h}x{d}" + ("dual" if dual
                                                          else ""),
                      lambda dt, sd, a=(b, s, h, d, dual):
                      flash_case(*a, dt, sd)))
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


def phase_check():
    """Returns each kernel's max abs error at its TIMED shape and dtype."""
    import torch

    dtypes = {"bf16": torch.bfloat16, "fp32": torch.float32}
    errs = {}
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # fp32 plain convs in full fp32
    try:
        for seed, (name, label, build) in enumerate(check_cases()):
            for dn, dt in dtypes.items():
                case = build(dt, seed)
                got = case["kernel"]()
                want = case["plain"]()
                torch.cuda.synchronize()
                outs = case.get("outputs", ("out",))
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


def _sums(modules):
    """fp64 sum of every parameter of each module: a cheap fingerprint."""
    return {name: [p.detach().double().sum().item() for p in m.parameters()]
            for name, m in modules.items()}


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
    if bwd_by_shape["flash_bwd_dq"] != bwd_by_shape["flash_bwd_dkv"]:
        raise SmokeFailure(f"K6b and K6a launched apart: {bwd_by_shape}")
    if not all(math.isfinite(x) for x in losses + norms):
        raise SmokeFailure(f"non-finite loss or grad norm: {losses} {norms}")
    if not all(moved.values()):
        raise SmokeFailure(f"trainables did not move: {moved}")
    if _sums(frozen) != frozen_before:
        raise SmokeFailure("a frozen parameter changed")
    return launches


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
        phase_determinism()
        phase_mini()
        phase_mini_train()
        phase_parse_check()
        timings = phase_time()
        counts = phase_main({"flash_fwd": fa.COUNTER,
                             "gn_silu_conv3x3": fgc.COUNTER,
                             "group_norm_act": fg.COUNTER})
        train = phase_train({"flash_fwd": fa.COUNTER,
                             "gn_silu_conv3x3": fgc.COUNTER,
                             "group_norm_act": fg.COUNTER,
                             "flash_fwd_res": fa.RES_COUNTER,
                             "flash_bwd_dkv": fa.DKV_COUNTER,
                             "flash_bwd_dq": fa.DQ_COUNTER})
        counts["bn_act"] = phase_parse(fba.COUNTER)
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
