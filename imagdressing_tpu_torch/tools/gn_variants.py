"""Where the resident GroupNorm's time goes: K3 (`kernels/csrc/gn_stats.cuh:
gn_resident`) against diagnostic variants built from patched copies of the
package under `_build/variants/`:

- `empty` returns at once: the cluster launch alone;
- `loadonly` returns once its rows have landed: launch, mbarrier and TMA
  loads;
- `nodsmem` adds its own partials instead of reading its peers' through
  distributed shared memory (the cluster barriers stay);
- `nocluster` also drops the cluster barriers;
- `nostore` normalizes but writes nothing.

The variants' outputs are wrong by design: only their times mean anything.
Each is timed by `time_gn_ops.py --skip-k2`, one process each, in turns
(full, the variants, full); one JSON line per shape and variant.

Usage (on the card's machine, from the repository root):
    python -m imagdressing_tpu_torch.tools.gn_variants
"""

from __future__ import annotations

import pathlib
import shutil
import subprocess
import sys

PKG = pathlib.Path(__file__).resolve().parents[1]
WORK = PKG / "_build" / "variants"
_HEAD = ("    gn_resident(const GnArgs a, const __grid_constant__ CUtensorMap "
         "xmap) {\n")
_RANKS = ("  const int tid = threadIdx.x, rank = blockIdx.x, cs = gridDim.x, "
          "b = blockIdx.z;\n")
PATCHES = {
    "empty": [(_HEAD, _HEAD + "  if (a.M > 0) return;\n")],
    "loadonly": [("  const bool active = rl < lanes;\n",
                  "  for (int i = 0; i < a.nboxes; ++i) mbar_wait(&bar[i], 0);\n"
                  "  if (a.M > 0) return;\n  const bool active = rl < lanes;\n")],
    "nodsmem": [("cluster_sum(part + tid, cs)", "part[tid]")],
    "nocluster": [(_RANKS, _RANKS.replace("cs = gridDim.x", "cs = 1"))],
    "nostore": [("      store8(y + (size_t)r * a.C, v);\n",
                 "      if (v[0] == 12345.f) store8(y + (size_t)r * a.C, v);\n")],
}


def make_variant(name: str) -> pathlib.Path:
    """A copy of the package with `name`'s patch applied to gn_stats.cuh;
    returns the directory to put first on the import path."""
    root = WORK / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(PKG, root / PKG.name,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    src = root / PKG.name / "kernels" / "csrc" / "gn_stats.cuh"
    text = src.read_text()
    for old, new in PATCHES[name]:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: gn_stats.cuh no longer has "
                               f"{old.strip()!r}")
        text = text.replace(old, new)
    src.write_text(text)
    return root


def main() -> None:
    roots = {"full": PKG.parent, **{n: make_variant(n) for n in PATCHES}}
    tool = PKG / "tools" / "time_gn_ops.py"
    for tag in ("full", *PATCHES, "full"):
        subprocess.run([sys.executable, str(tool), "--root", str(roots[tag]),
                        "--tag", tag, "--skip-k2"], check=True)


if __name__ == "__main__":
    main()
