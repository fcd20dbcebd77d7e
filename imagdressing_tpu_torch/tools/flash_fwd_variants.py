"""Where the bf16 flash forward's time goes: K1 and K5's wgmma kernel
(`kernels/csrc/flash_fwd.cu:flash_fwd_wgmma`) against diagnostic variants,
built from patched copies of the package under `_build/variants/`:

- `noload` asks for no key / value tile after the ring's first fill; the
  products run on the stale tiles, so what is left is the tensor work, the
  softmax and the epilogue;
- `nomma` issues no products (S = Q K^T and O += P V), so what is left is
  the loads, the softmax on stale scores and the epilogue;
- `noexp2` takes the FFMA's result as the probability instead of its exp2,
  so the special-function units do no work per score;
- `nosoftmax` leaves out the online softmax (row max, exp2, row sums,
  the rescale), so P is the raw scores: what is left is the loads, the
  products and the synchronisation;
- `noload_nomma` leaves out both the reloads and the products: the
  softmax and the synchronisation alone;
- `nopingpong` lets the two consumer warpgroups issue their products
  without taking turns.

The variants' outputs are wrong by design (`nopingpong`'s excepted): only
their times mean anything. Each is timed by `time_flash_ops.py --only K1`,
one process each, in turns (full, the variants, full); one JSON line per
shape and variant.

Usage (on the card's machine, from the repository root):
    python -m imagdressing_tpu_torch.tools.flash_fwd_variants
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
        ("        if (t >= stages) mbar_wait(&empty[st], ph ^ 1);\n",
         "        if (t >= stages) break;\n"),
        ("    mbar_wait(&full[st], ph);\n",
         "    if (t < stages) mbar_wait(&full[st], ph);\n"),
    ],
    "nomma": [
        ("      Wgmma<BKV>::template ss<0, 0>(s, desc_kmajor<BQ>(Qw, kk), "
         "desc_kmajor<BKV>(Kt, kk), kk);\n", "      ;\n"),
        ("      Wgmma<DN>::template rs<1>(o, pf[kk], desc_mnmajor<BKV>(Vt, kk), "
         "1);\n", "      ;\n"),
    ],
    "noexp2": [
        ("      s[j] = fast_exp2(fmaf(s[j], c, (j & 2) ? -mc1 : -mc0));\n",
         "      s[j] = fmaf(s[j], c, (j & 2) ? -mc1 : -mc0);\n"),
    ],
    "nosoftmax": [
        ("    // (softmax begins)\n", "#if 0\n"),
        ("    // (softmax ends)\n", "#endif\n"),
    ],
    "nopingpong": [
        ("constexpr bool PINGPONG = true;\n",
         "constexpr bool PINGPONG = false;\n"),
    ],
}


PATCHES["noload_nomma"] = PATCHES["noload"] + PATCHES["nomma"]


def make_variant(name: str) -> pathlib.Path:
    """A copy of the package with `name`'s patch applied to flash_fwd.cu;
    returns the directory to put first on the import path."""
    root = WORK / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(PKG, root / PKG.name,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    src = root / PKG.name / "kernels" / "csrc" / "flash_fwd.cu"
    text = src.read_text()
    for old, new in PATCHES[name]:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: flash_fwd.cu no longer has "
                               f"{old.strip()!r}")
        text = text.replace(old, new)
    src.write_text(text)
    return root


def main() -> None:
    roots = {"full": PKG.parent, **{n: make_variant(n) for n in PATCHES}}
    tool = PKG / "tools" / "time_flash_ops.py"
    for tag in ("full", *PATCHES, "full"):
        subprocess.run([sys.executable, str(tool), "--root", str(roots[tag]),
                        "--tag", tag, "--only", "K1"], check=True)


if __name__ == "__main__":
    main()
