"""Time the GroupNorm-family ops of one checkout of the port on a CUDA card:
the GN+SiLU+conv3x3 op (K2, and K4 at the VAE's pixel level) and the fused
GroupNorm (K3), at the shapes where their time goes.

For each op and shape, one JSON line: the device time per call (CUDA-graph
replays, `tools/timing.cuda_graph_ms`), the time per call of back-to-back
eager calls (`cuda_ms`: the host's time per call where the device is
quicker), the bound (the larger of tensor FLOPs over 989 TFLOP/s and bytes
over 3.35 TB/s), and the card's name and power limit; K3's rows also give
the library call (`F.group_norm`, and `F.silu` where the op has it) by
graph and eager, and the plan where the checkout has `gn_plan`. `--root`
names the checkout whose `imagdressing_tpu_torch` is timed (it goes first
on the import path), so the same script times a parent commit and its
change on one card, in turns (parent, change, change, parent). `--sweep`
also times K3 under every resident plan the kernel takes (one line per
plan, with how many of its clusters the card holds at once), and at the
VAE's shapes its plan against the streaming mode.

Usage (on the card's machine, from the repository root):
    python imagdressing_tpu_torch/tools/time_gn_ops.py --root DIR --tag NAME
        [--sweep]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

K2_SHAPES = [(2, 80, 64, 320, 320, True), (2, 10, 8, 1280, 1280, True),
             (2, 20, 16, 1280, 1280, True), (2, 10, 8, 2560, 1280, True),
             (1, 640, 512, 256, 128, False)]
# K3: the four UNet levels of a CFG step (transformer in-norms, act none),
# the same at batch 1 (the garment pass), conv_norm_out (silu) and the K2
# prologue's function at the top level (add = temb, silu); (shape, act, add)
K3_SHAPES = [((2, 5120, 320), "none", False), ((2, 1280, 640), "none", False),
             ((2, 320, 1280), "none", False), ((2, 80, 1280), "none", False),
             ((1, 5120, 320), "none", False), ((1, 1280, 640), "none", False),
             ((1, 320, 1280), "none", False), ((1, 80, 1280), "none", False),
             ((2, 5120, 320), "silu", False), ((2, 5120, 320), "silu", True)]
# the VAE's GroupNorm shapes at 640x512 (batch 1, bf16; the GN+conv
# prologue's), for `--sweep`'s resident-against-streaming lines
VAE_SHAPES = [(1, 327680, 128), (1, 327680, 256), (1, 81920, 128),
              (1, 81920, 256), (1, 81920, 512), (1, 20480, 256),
              (1, 20480, 512), (1, 5120, 512)]
HBM_BYTES_PER_MS = 3.35e9  # H100 SXM, NVIDIA data sheet
BF16_FLOPS_PER_MS = 989e9  # dense bf16 tensor cores, same source


def _row(op, shape, fn, flops, nbytes, timing):
    ms = timing.cuda_graph_ms(fn)
    eager_ms = timing.cuda_ms(fn)
    bound = max(flops / BF16_FLOPS_PER_MS, nbytes / HBM_BYTES_PER_MS)
    return dict(op=op, shape=list(shape), ms=ms, eager_ms=eager_ms,
                bound_ms=bound, tflops=flops / ms / 1e9)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--tag", required=True)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--skip-k2", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    import torch.nn.functional as F

    from imagdressing_tpu_torch.kernels import fused_gn_conv as fgc
    from imagdressing_tpu_torch.kernels import fused_groupnorm as fg
    from imagdressing_tpu_torch.tools import timing

    if not torch.cuda.is_available():
        raise SystemExit("time_gn_ops: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16
    src = os.path.dirname(os.path.dirname(os.path.abspath(fgc.__file__)))

    def rnd(shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(bf)

    def emit(**row):
        print(json.dumps(dict(tag=args.tag, card=card, package=src, **row)),
              flush=True)

    for b, h, w, cin, co, with_add in ([] if args.skip_k2 else K2_SHAPES):
        x = rnd((b, h, w, cin))
        wt = rnd((co, cin, 3, 3), (9 * cin) ** -0.5).contiguous(
            memory_format=torch.channels_last)
        gw, gb, cb = 1 + rnd((cin,), 0.1), rnd((cin,), 0.1), rnd((co,))
        add = rnd((b, cin)) if with_add else None

        def fn(x=x, gw=gw, gb=gb, wt=wt, cb=cb, add=add):
            return fgc.gn_silu_conv3x3(x, gw, gb, wt, cb, num_groups=32,
                                       eps=1e-5, add=add)

        row = _row("gn_silu_conv3x3", (b, h, w, cin, co), fn,
                   2.0 * b * h * w * 9 * cin * co,
                   2.0 * (b * h * w * (cin + co) + 9 * cin * co), timing)
        emit(**row)
        del x, wt
    for shape, act, with_add in K3_SHAPES:
        x = rnd(shape)
        c = shape[-1]
        gw, gb = 1 + rnd((c,), 0.1), rnd((c,), 0.1)
        add = rnd((shape[0], c)) if with_add else None
        eps = 1e-6 if act == "none" else 1e-5
        kw = dict(num_groups=32, eps=eps, act=act, add=add)
        x_ncl = x.transpose(1, 2)

        def library():
            xin = x_ncl + add[:, :, None] if add is not None else x_ncl
            y = F.group_norm(xin, 32, gw, gb, eps)
            return F.silu(y) if act == "silu" else y

        row = _row("group_norm_act", shape,
                   lambda: fg.group_norm_act(x, gw, gb, **kw),
                   0.0, 4.0 * x.numel(), timing)
        row.update(act=act, add=with_add,
                   library_ms=timing.cuda_graph_ms(library),
                   library_eager_ms=timing.cuda_ms(library))
        if hasattr(fg, "gn_plan"):
            plan = fg.gn_plan(*shape, 32, bf, act)
            row["plan"] = dataclasses.asdict(plan)
        emit(**row)
        if args.sweep and hasattr(fg, "gn_plan") and not with_add:
            for _, p in fg._resident_plans(*shape, 32, 2, act):
                ms = timing.cuda_graph_ms(
                    lambda p=p: fg._launch(x, gw, gb, None, 32, eps, act,
                                           plan=p))
                emit(op="group_norm_act.sweep", shape=list(shape), act=act,
                     ms=ms, plan=dataclasses.asdict(p),
                     max_active_clusters=fg.max_active_clusters(p, bf))
    if args.sweep and hasattr(fg, "gn_plan"):
        for shape in VAE_SHAPES:
            x = rnd(shape)
            gw, gb = 1 + rnd((shape[-1],), 0.1), rnd((shape[-1],), 0.1)
            plans = {"plan": fg.gn_plan(*shape, 32, bf, "silu"),
                     "stream": fg.stream_plan(*shape)}
            for name, p in plans.items():
                ms = timing.cuda_graph_ms(
                    lambda p=p: fg._launch(x, gw, gb, None, 32, 1e-5, "silu",
                                           plan=p))
                emit(op="group_norm_act.mode", shape=list(shape), act="silu",
                     which=name, ms=ms, bound_ms=4.0 * x.numel()
                     / HBM_BYTES_PER_MS, plan=dataclasses.asdict(p))
            del x


if __name__ == "__main__":
    main()
