"""Where the time of one human parse goes on a CUDA card: the SCHP parser
(`preprocess/parsing/infer.Parsing`, ATR 512 + LIP 473, ResNet-101 at full
width, random fp32 weights) on a synthetic 1024x768 person photo.

One warm call, then one call under `torch.profiler`. Prints one JSON object:
the wall time and its stages (host clock), the device's busy share of the
wall window, device time by kernel class and by kernel, the number of
device operations, and the host refinement's costliest functions (cProfile
over one `refine` of the same label maps). `person_photo` is the photo
`chip_smoke.py` parses too.

Usage (on the card's machine, from the repository root):
    python -m imagdressing_tpu_torch.tools.profile_parse [HxW] [cudnn_tf32]
"""

from __future__ import annotations

import cProfile
import json
import os
import pstats
import sys
import time
from collections import defaultdict

# kernel-name markers, checked in order
CLASSES = (
    ("K7 bn_act", ("bn_act_kernel",)),
    ("cuDNN convolution", ("fprop", "conv", "winograd", "xmma", "dgrad")),
    ("cuBLAS GEMM", ("gemm", "nvjet", "cutlass", "cublas")),
    ("pooling / interpolation", ("pool", "upsample", "interp")),
    ("gather (warps)", ("gather", "index")),
)


def classify(name: str) -> str:
    low = name.lower()
    for label, marks in CLASSES:
        if any(m in low for m in marks):
            return label
    return "elementwise / cat / copy"


def person_photo(h: int, w: int, seed: int):
    """A synthetic person photo, uint8 RGB (h, w, 3): a graded backdrop,
    skin-toned head and arms, a shirt, trousers, and sensor noise, all
    from `seed`."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] / np.array([h, w])[:, None, None]
    img = np.empty((h, w, 3))
    img[:] = rng.uniform(150, 230, 3) * (0.8 + 0.2 * yy[..., None])

    def ellipse(cy, cx, ry, rx, rgb):
        inside = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1
        img[inside] = rgb

    skin, shirt, pants = (rng.uniform(lo, hi, 3) for lo, hi in
                          ((150, 230), (20, 200), (20, 120)))
    ellipse(0.72, 0.44, 0.26, 0.08, pants)
    ellipse(0.72, 0.56, 0.26, 0.08, pants)
    ellipse(0.42, 0.27, 0.2, 0.05, skin)
    ellipse(0.42, 0.73, 0.2, 0.05, skin)
    ellipse(0.42, 0.5, 0.2, 0.2, shirt)
    ellipse(0.17, 0.5, 0.09, 0.08, skin)
    img += rng.normal(0, 4, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def main(size: str = "1024x768", tf32: str = "default") -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from imagdressing_tpu_torch.kernels import fused_bn_act as fba
    from imagdressing_tpu_torch.preprocess.parsing import infer as pinf

    if tf32 != "default":
        torch.backends.cudnn.allow_tf32 = tf32 == "1"
    h, w = (int(t) for t in size.split("x"))
    parsing = pinf.Parsing.init_random(0)
    img = person_photo(h, w, 0)
    parsing(img)  # warm: kernel build, cuDNN plans, allocator
    fba.COUNTER.reset()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        parsing(img)
        wall = time.perf_counter() - t0
    by_kernel, by_class = {}, defaultdict(float)
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0.0)
        if us <= 0:
            continue
        by_kernel[e.key] = (us / 1e3, e.count)
        by_class[classify(e.key)] += us / 1e3
    device_ms = sum(by_class.values())
    if device_ms <= 0:
        raise RuntimeError("the profiler recorded no device time")

    image = torch.from_numpy(img).cuda()
    atr, lip = (parsing.logits(image, getattr(parsing, n), c, s).argmax(
        -1).cpu().numpy() for n, c, s in (("atr", 18, 512), ("lip", 20, 473)))
    stats = cProfile.Profile()
    stats.runcall(pinf.refine, atr, lip)
    st = pstats.Stats(stats)
    refine = sorted(((f"{fn[2]} ({os.path.basename(fn[0])}:{fn[1]})",
                      v[3] * 1e3) for fn, v in st.stats.items()),
                    key=lambda kv: -kv[1])[:8]
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:15]
    result = dict(
        device=torch.cuda.get_device_name(0), photo=size,
        cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
        wall_ms=wall * 1e3, device_ms=device_ms,
        device_busy_share=device_ms / (wall * 1e3),
        stage_ms={k: v * 1e3 for k, v in parsing.last_stage_seconds.items()},
        event_ms=parsing.last_device_ms,
        device_ops=sum(n for _, n in by_kernel.values()),
        bn_act_launches=fba.COUNTER.count,
        class_ms=dict(sorted(by_class.items(), key=lambda kv: -kv[1])),
        top_kernels=[dict(name=k[:120], ms=ms, calls=n)
                     for k, (ms, n) in top],
        refine_cumulative_ms=dict(refine))
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main(*sys.argv[1:3])
