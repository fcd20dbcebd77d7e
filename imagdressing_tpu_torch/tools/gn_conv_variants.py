"""Where the bf16 GN+conv's time goes: the op (`kernels/csrc/gn_conv.cu`)
against two diagnostic variants of its conv kernel, built from patched
copies of the package under `_build/variants/`:

- `noload` asks for no tile after the ring's first fill; the products run
  on the stale tiles, so what is left is the tensor work, the barriers,
  the statistics, the normalize pass and the epilogue;
- `nomma` issues no products, so what is left is the tile loads and the
  rest without the tensor work.

The variants' outputs are wrong by design: only their times mean anything.
The three are timed by `time_gn_ops.py`, one process each, in turns (full,
noload, nomma, full); one JSON line per op, shape and variant.

Usage (on the card's machine, from the repository root):
    python -m imagdressing_tpu_torch.tools.gn_conv_variants
"""

from __future__ import annotations

import pathlib
import shutil
import subprocess
import sys

PKG = pathlib.Path(__file__).resolve().parents[1]
WORK = PKG / "_build" / "variants"
PATCHES = {
    "noload": [
        ("    if (tid == 0 && i >= 1 && i - 1 + STAGES < nk) "
         "load(i - 1 + STAGES);\n", ""),
        ("    mbar_wait(&full[st], (i / STAGES) & 1);\n",
         "    if (i < STAGES) mbar_wait(&full[st], 0);\n"),
    ],
    "nomma": [
        ("      Wgmma<BN>::template ss<0, 0>(acc, desc_sw128(At + 32 * kk), "
         "desc_sw128(Bt + 32 * kk), 1);\n", "      ;\n"),
    ],
}


def make_variant(name: str) -> pathlib.Path:
    """A copy of the package with `name`'s patch applied to gn_conv.cu;
    returns the directory to put first on the import path."""
    root = WORK / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(PKG, root / PKG.name,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    src = root / PKG.name / "kernels" / "csrc" / "gn_conv.cu"
    text = src.read_text()
    for old, new in PATCHES[name]:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: gn_conv.cu no longer has "
                               f"{old.strip()!r}")
        text = text.replace(old, new)
    src.write_text(text)
    return root


def main() -> None:
    roots = {"full": PKG.parent, **{n: make_variant(n) for n in PATCHES}}
    tool = PKG / "tools" / "time_gn_ops.py"
    for tag in ("full", "noload", "nomma", "full"):
        subprocess.run([sys.executable, str(tool), "--root", str(roots[tag]),
                        "--tag", tag], check=True)


if __name__ == "__main__":
    main()
