"""Time the GroupNorm-family ops of one checkout of the port on a CUDA card:
the GN+SiLU+conv3x3 op (K2, and K4 at the VAE's pixel level) and the fused
GroupNorm (K3), at the shapes where their time goes.

For each op and shape, one JSON line: the device time per call (CUDA-graph
replays, `tools/timing.cuda_graph_ms`), the time per call of back-to-back
eager calls (`cuda_ms`: the host's time per call where the device is
quicker), the bound (the larger of tensor FLOPs over 989 TFLOP/s and bytes
over 3.35 TB/s), and the card's name and power limit. `--root` names the
checkout whose `imagdressing_tpu_torch` is timed (it goes first on the
import path), so the same script times a parent commit and its change on
one card, in turns (parent, change, change, parent).

Usage (on the card's machine, from the repository root):
    python imagdressing_tpu_torch/tools/time_gn_ops.py --root DIR --tag NAME
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

K2_SHAPES = [(2, 80, 64, 320, 320, True), (2, 10, 8, 1280, 1280, True),
             (2, 20, 16, 1280, 1280, True), (2, 10, 8, 2560, 1280, True),
             (1, 640, 512, 256, 128, False)]
K3_SHAPES = [(2, 5120, 320)]
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
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

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

    for b, h, w, cin, co, with_add in K2_SHAPES:
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
        print(json.dumps(dict(tag=args.tag, card=card, package=src, **row)),
              flush=True)
        del x, wt
    for shape in K3_SHAPES:
        x = rnd(shape)
        gw, gb = 1 + rnd((shape[-1],), 0.1), rnd((shape[-1],), 0.1)
        row = _row("group_norm_act", shape,
                   lambda: fg.group_norm_act(x, gw, gb, num_groups=32,
                                             eps=1e-6),
                   0.0, 4.0 * x.numel(), timing)
        print(json.dumps(dict(tag=args.tag, card=card, package=src, **row)),
              flush=True)


if __name__ == "__main__":
    main()
