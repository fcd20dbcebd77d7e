"""Write `kernels/csrc/wgmma.cuh`: inline-PTX wrappers of Hopper's
`wgmma.mma_async` m64nNk16 bf16 -> fp32 products, one specialisation per N.

A wgmma instruction names each of its N/2 accumulator registers in the
assembly string, so every N is its own asm statement; this script writes
them out. Two forms per N: `ss` (A and B from shared memory, by matrix
descriptor) and `rs` (A from registers in the mma.sync m16n8k16 fragment
layout, B by descriptor). The transpose flags are template arguments (0:
K-major, 1: MN-major).

Usage, from the repository root:
    python -m imagdressing_tpu_torch.tools.gen_wgmma
"""

from __future__ import annotations

from pathlib import Path

OUT = Path(__file__).resolve().parent.parent / "kernels" / "csrc" / \
    "wgmma.cuh"
SS_N = (32, 64, 128, 160, 256)
RS_N = (16, 32, 40, 64, 80, 128, 160, 256)

HEADER = """\
// Generated by imagdressing_tpu_torch/tools/gen_wgmma.py; do not edit.
//
// Hopper warpgroup products D(64 x N, fp32) += A(64 x 16) * B(16 x N), bf16
// inputs. Wgmma<N>::ss<TA, TB>(d, desc_a, desc_b, scale_d) reads A and B
// from shared memory; Wgmma<N>::rs<TB>(d, a, desc_b, scale_d) takes A from
// four registers per thread (the mma.sync m16n8k16 A fragment of the
// thread's warp, rows 16 * (warp % 4) ..). scale_d = 0 overwrites d.
// Accumulator element j of a thread: n8 chunk j / 4, row g + 8 * (j % 4 / 2)
// of the warp's 16, column 2 t + j % 2 of the chunk (g = lane / 4,
// t = lane % 4).
#pragma once

#include <stdint.h>

template <int N>
struct Wgmma;
"""


def _regs(n: int) -> str:
    return ", ".join(f"%{i}" for i in range(n))


def _outs(n: int) -> str:
    return ", ".join(f'"+f"(d[{i}])' for i in range(n))


def spec(n: int) -> str:
    r = n // 2
    parts = [f"\ntemplate <>\nstruct Wgmma<{n}> {{"]
    if n in SS_N:
        parts.append(f"""\
  template <int TA, int TB>
  static __device__ __forceinline__ void ss(float* d, uint64_t da,
                                            uint64_t db, int scale_d) {{
    asm volatile(
        "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{r + 2}, 0;\\n"
        "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "
        "{{{_regs(r)}}}, %{r}, %{r + 1}, p, 1, 1, %{r + 3}, %{r + 4};\\n}}\\n"
        : {_outs(r)}
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  }}""")
    if n in RS_N:
        parts.append(f"""\
  template <int TB>
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a,
                                            uint64_t db, int scale_d) {{
    asm volatile(
        "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{r + 5}, 0;\\n"
        "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "
        "{{{_regs(r)}}}, {{%{r}, %{r + 1}, %{r + 2}, %{r + 3}}}, %{r + 4}, "
        "p, 1, 1, %{r + 6};\\n}}\\n"
        : {_outs(r)}
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
          "n"(TB));
  }}""")
    parts.append("};")
    return "\n".join(parts) + "\n"


def main() -> None:
    text = HEADER + "".join(spec(n) for n in sorted(set(SS_N) | set(RS_N)))
    OUT.write_text(text)
    print(OUT)


if __name__ == "__main__":
    main()
