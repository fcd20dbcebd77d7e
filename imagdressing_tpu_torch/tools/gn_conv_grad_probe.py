"""The bf16 gradient check of the GN+SiLU+conv3x3 Function at chosen seeds,
with both bf16 chains held against fp32 gradients of the same inputs.

`chip_smoke.py` checks `gn_silu_conv3x3.grad` (1x80x64x320->320, temb
added) in bf16: the Function (kernel forward, its backward differentiating
`gn_silu_conv3x3_plain`) and autograd of the plain version, each against
the fp32 gradients of the same inputs. This tool builds the check's case at
each seed (a case's seed is its index in `chip_smoke.check_cases()`; the
check also runs seed 75), takes both bf16 gradients twice, and the fp32
gradients of both functions on the same inputs cast up to fp32. One JSON
line per seed and output:

  kernel_vs_plain    max |kernel - plain| in bf16, with the check's rule
                     as `tol` (1e-2 + 1e-2 * max |plain|)
  repeat_bit_equal   whether the second run gave the same bits (both sides)
  kernel_vs_fp32     max |kernel bf16 - kernel chain in fp32|
  plain_vs_fp32      max |plain bf16 - plain chain in fp32|
  fp32_chains        max |kernel chain in fp32 - plain chain in fp32|
  at_worst           at the element of the largest kernel_vs_plain: both
                     bf16 values, the fp32 value and the bf16 spacing there

Usage (on the card's machine, from the repository root):
    python imagdressing_tpu_torch/tools/gn_conv_grad_probe.py --seeds 68 75
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()


def probe(seed: int):
    """One dict per output of the check's case at `seed`."""
    import torch

    import chip_smoke

    case = chip_smoke.gn_conv_grad_case(torch.bfloat16, seed)
    runs = [(case["kernel"](), case["plain"]()) for _ in range(2)]
    fn, plain = case["fns"]
    leaves = [t.detach().float().requires_grad_() for t in case["leaves"]]
    g = case["g"].float()
    k32 = torch.autograd.grad(fn(*leaves), leaves, g)
    p32 = torch.autograd.grad(plain(*leaves), leaves, g)
    torch.cuda.synchronize()
    rows = []
    for i in range(len(leaves)):
        k, p = runs[0][0][i].float(), runs[0][1][i].float()
        diff = (k - p).abs()
        at = int(diff.flatten().argmax())
        ref = p.abs().max().item()
        truth = p32[i].flatten()[at]
        spacing = torch.finfo(torch.bfloat16).eps * 2.0 ** torch.floor(
            torch.log2(truth.abs().clamp_min(1e-30))).item()
        rows.append(dict(
            seed=seed, output=f"d{i}", max_abs_ref=ref,
            kernel_vs_plain=diff.max().item(), tol=1e-2 + 1e-2 * ref,
            repeat_bit_equal=all(torch.equal(runs[0][s][i], runs[1][s][i])
                                 for s in (0, 1)),
            kernel_vs_fp32=(k - k32[i]).abs().max().item(),
            plain_vs_fp32=(p - p32[i]).abs().max().item(),
            fp32_chains=(k32[i] - p32[i]).abs().max().item(),
            at_worst=dict(kernel=k.flatten()[at].item(),
                          plain=p.flatten()[at].item(),
                          kernel_fp32=k32[i].flatten()[at].item(),
                          plain_fp32=truth.item(), bf16_spacing=spacing)))
    return rows


def main(argv=None):
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("gn_conv_grad_probe: needs a CUDA card")
    sys.path.insert(0, ROOT)
    torch.backends.cudnn.allow_tf32 = False  # as chip_smoke's check phase
    card = _card()
    for seed in args.seeds:
        for row in probe(seed):
            print(json.dumps(dict(row, card=card)), flush=True)


if __name__ == "__main__":
    main()
