"""The yardstick of the kernels: the H100's data-sheet peaks and the work
of each kernel launch from its shape (the operations and bytes its inputs
need), copied from the program's `tools/profile_infer.py` so that a change
to the program cannot move it. A launch's bound is the largest of its
tensor FLOPs over the bf16 peak, its bytes over the HBM bandwidth and, for
attention, its exp2 evaluations over the special-function units."""

from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
BF16_FLOPS_PER_S = 989e12      # dense bf16 tensor cores, same source
# exp2 on the special-function units: 132 SMs x 16 per clock at the
# H100's maximum SM clock, 1980 MHz
EXP2_PER_S = 132 * 16 * 1.98e9


def _ref_scale(b):
    """The garment scales of a dual call: an even batch is a CFG batch
    [0 (uncond) x b/2, 1 (cond) x b/2], an odd one all 1 (training)."""
    return [0.0] * (b // 2) + [1.0] * (b // 2) if b % 2 == 0 else [1.0] * b


def flash_exp2(b, s, h, d, dual):
    # one per (q, k) pair and source run; the scale-0 rows of a CFG batch
    # skip the garment pass
    ref_rows = sum(x != 0 for x in _ref_scale(b)) if dual else 0
    return float(h * s * s * (b + ref_rows))


def flash_flops(b, s, h, d, dual):
    return 4.0 * d * flash_exp2(b, s, h, d, dual)


def flash_bytes(b, s, h, d, dual):
    # bf16 q, k, v (k_ref, v_ref) read and out written
    return 2.0 * b * s * h * d * (6 if dual else 4)


def conv_flops(b, h, w, cin, co):
    return 2.0 * b * h * w * 9 * cin * co


def conv_bytes(b, h, w, cin, co):
    # bf16 x, weights and out, each once
    return 2.0 * (b * h * w * (cin + co) + 9 * cin * co)


def gn_bytes(shape, act):
    # bf16 x read and y written, each once
    return 4.0 * math.prod(shape)


def flash_bound_s(key: Tuple) -> float:
    return max(flash_flops(*key) / BF16_FLOPS_PER_S,
               flash_bytes(*key) / HBM_BYTES_PER_S,
               flash_exp2(*key) / EXP2_PER_S)


def conv_bound_s(key: Tuple) -> float:
    return max(conv_flops(*key) / BF16_FLOPS_PER_S,
               conv_bytes(*key) / HBM_BYTES_PER_S)


def gn_bound_s(key: Tuple) -> float:
    return gn_bytes(*key) / HBM_BYTES_PER_S


def bound_s(counts: Dict[Tuple, int], bound) -> float:
    """The least seconds the counted launches could take."""
    return sum(n * bound(key) for key, n in counts.items())


def kernel_seconds(by_name: Dict[str, float], marks: Iterable[str]) -> float:
    """Device seconds of the kernels whose name holds one of `marks`."""
    marks = tuple(marks)
    return sum(s for name, s in by_name.items()
               if any(m in name for m in marks))
