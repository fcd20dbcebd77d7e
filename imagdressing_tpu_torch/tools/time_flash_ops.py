"""Time the flash forward of one checkout of the port on a CUDA card: K1
(`flash_attention`, no gradient) at every shape the `basic` path launches
it with, and K5 (`flash_attention_res`, the training forward) at the
training levels.

For each op and shape, one JSON line: the device time per call (CUDA-graph
replays, `tools/timing.cuda_graph_ms`), the time per call of back-to-back
eager calls (`cuda_ms`), the library call's device time (two SDPA forwards
and the scaled sum, graph replays), the bound and its terms (bytes over
3.35 TB/s, tensor FLOPs over 989 TFLOP/s, one exp2 per (q, k) pair and
source run over 132 SMs x 16 per clock at the card's maximum SM clock),
the plan where the checkout has `flash_plan`, and the card's name and
power limit. `--root` names the checkout whose `imagdressing_tpu_torch` is
timed (it goes first on the import path), so the same script times a
parent commit and its change on one card, in turns (parent, change,
change, parent). `--sweep` (a checkout with `flash_plan`) also times every
plan the kernel has at each shape: rows per block, keys per tile, ring
depth.

Usage (on the card's machine, from the repository root):
    python imagdressing_tpu_torch/tools/time_flash_ops.py --root DIR \\
        --tag NAME [--sweep] [--only K1|K5]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

# (b, s, h, d, dual): the main UNet's four self-attention levels (CFG
# batch, scale [0, 1]), the garment UNet's (batch 1, one source) and the
# VAE's mid attention (one head, D = 512)
K1_SHAPES = [(2, 5120, 8, 40, True), (2, 1280, 8, 80, True),
             (2, 320, 8, 160, True), (2, 80, 8, 160, True),
             (1, 5120, 8, 40, False), (1, 1280, 8, 80, False),
             (1, 320, 8, 160, False), (1, 80, 8, 160, False),
             (1, 5120, 1, 512, False)]
# the training levels: the main UNet (two sources, scale 1) and the garment
# UNet (one source), batch 1
K5_SHAPES = [(1, s, 8, d, dual)
             for s, d in ((5120, 40), (1280, 80), (320, 160), (80, 160))
             for dual in (True, False)]
HBM_BYTES_PER_MS = 3.35e9  # H100 SXM, NVIDIA data sheet
BF16_FLOPS_PER_MS = 989e9  # dense bf16 tensor cores, same source
EXP2_PER_CLOCK_PER_SM = 16
SMS = 132


def _smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip() \
        .splitlines()[0]


def _inputs(torch, b, s, h, d, dual, scale, gen):
    t = [torch.randn((b, s, h, d), generator=gen, device="cuda")
         .to(torch.bfloat16) for _ in range(5 if dual else 3)]
    sc = torch.tensor(scale, device="cuda") if dual else None
    return t, sc


def _bound(b, s, h, d, dual, sources, res, exp2_per_ms):
    """(bound ms, terms): sources = (q rows x source) runs per head."""
    n = b * s * h * d
    nbytes = 2.0 * n * ((5 if dual else 3) + 1 + (1 if res and dual else 0))
    if res:
        nbytes += 4.0 * b * h * s * (2 if dual else 1)
    terms = {"bytes": nbytes / HBM_BYTES_PER_MS,
             "tensor": 4.0 * sources * h * s * s * d / BF16_FLOPS_PER_MS,
             "exp2": float(sources * h * s * s) / exp2_per_ms}
    return max(terms.values()), terms


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--tag", required=True)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--only", choices=("K1", "K5"))
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    from imagdressing_tpu_torch.kernels import flash_attention as fa
    from imagdressing_tpu_torch.tools import timing

    if not torch.cuda.is_available():
        raise SystemExit("time_flash_ops: no CUDA device")
    card = _smi("name,power.limit")
    exp2_per_ms = SMS * EXP2_PER_CLOCK_PER_SM * float(
        _smi("clocks.max.sm").split()[0]) * 1e3
    gen = torch.Generator(device="cuda").manual_seed(0)
    src = os.path.dirname(os.path.dirname(os.path.abspath(fa.__file__)))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    has_plan = hasattr(fa, "flash_plan")

    def emit(**row):
        print(json.dumps(dict(tag=args.tag, card=card, package=src, **row)),
              flush=True)

    ops = [("K1", s) for s in K1_SHAPES] + [("K5", s) for s in K5_SHAPES]
    for op, (b, s, h, d, dual) in ops:
        if args.only and op != args.only:
            continue
        res = op == "K5"
        scale = [1.0] * b if res or b == 1 else [0.0, 1.0]
        t, sc = _inputs(torch, b, s, h, d, dual, scale, gen)
        kr, vr = (t[3], t[4]) if dual else (None, None)
        if res:
            def fn(plan=None):
                return fa._launch_fwd(t[0], t[1], t[2], kr, vr, sc, True,
                                      **({"plan": plan} if plan else {}))
        else:
            def fn(plan=None):
                if plan is None:
                    return fa.flash_attention(t[0], t[1], t[2], kr, vr, sc)
                return fa._launch_fwd(t[0], t[1], t[2], kr, vr, sc, False,
                                      plan=plan)

        def library():
            q, k, v = (x.transpose(1, 2) for x in t[:3])
            o = sdpa(q, k, v)
            if dual:
                o = o + sc.view(-1, 1, 1, 1) * sdpa(
                    q, t[3].transpose(1, 2), t[4].transpose(1, 2))
            return o

        sources = b + (sum(x != 0 for x in scale) if dual and not res
                       else (b if dual else 0))
        bound, terms = _bound(b, s, h, d, dual, sources, res, exp2_per_ms)
        plan = fa.flash_plan(b, s, h, d, dual) if has_plan else None
        ms = timing.cuda_graph_ms(fn)
        emit(op=op, shape=[b, s, h, d], dual=dual, scale=scale, ms=ms,
             eager_ms=timing.cuda_ms(fn),
             library_ms=timing.cuda_graph_ms(library), bound_ms=bound,
             bound_terms_ms=terms, over_bound=ms / bound,
             plan=plan and [plan.rows, plan.bkv, plan.stages])
        if args.sweep and plan is not None:
            for rows, bkv in fa.fwd_tiles(d):
                for stages in range(2, fa.MAX_STAGES + 1):
                    p = fa.flash_plan(b, s, h, d, dual, rows, bkv, stages)
                    if p.smem > fa.SMEM_LIMIT:
                        continue
                    emit(op=f"{op} sweep", shape=[b, s, h, d], dual=dual,
                         plan=[rows, bkv, stages],
                         ms=timing.cuda_graph_ms(lambda p=p: fn(p)))
        del t


if __name__ == "__main__":
    main()
