"""The decision of `correct`: the plain reference redoes each sampled
request or item from the inputs the benchmark made (garment and pose
images, prompt texts, the call's seed and the row the request had in its
call) with weights drawn again from the seed, in float32 with TF32 off, and
the image the program served is held against it.

The number compared: the root mean square, in uint8 levels, of the served
image less the reference image times 255, the worst over the samples. A
sample that was not answered, whose call row is unknown or whose image
cannot be read reads +inf. With `control`, the reference run again with
every product in float8 (`stack.Precision("fp8")`) stands in the program's
place: its image, rounded to uint8, is judged instead of the served one."""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from benchmark.lib import synth, weights
from benchmark.reference import pipeline as ref


def image_error(served: np.ndarray, reference01: torch.Tensor) -> Dict:
    """{rms, max} of served uint8 (H, W, 3) against a reference image in
    [0, 1], in uint8 levels."""
    want = reference01.double().cpu().numpy() * 255.0
    if served.shape != want.shape:
        return {"rms": math.inf, "max": math.inf}
    diff = served.astype(np.float64) - want
    return {"rms": float(np.sqrt(np.mean(diff * diff))),
            "max": float(np.abs(diff).max())}


def _served(sample) -> np.ndarray:
    if sample.get("served") is not None:
        return sample["served"]
    return synth.png_decode(sample["served_png"])


def run_check(run, control: bool = False) -> Dict:
    """Readings over the run's samples: {"image_rms_levels": worst,
    "per_sample": [...]}; with `control`, of the float8 control's images."""
    cfg, dev = run.config, run.device
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        drawn = weights.draw(run.shapes, run.seed, dev, run.dtype)
        w32 = {}
        for name in list(drawn):
            w32[name] = {k: v.float() for k, v in drawn[name].items()}
            del drawn[name]
        if dev == "cuda":
            torch.cuda.empty_cache()
        per: List[Dict] = []
        noise_of = {}
        for s in run.samples:
            entry = {"name": s["name"]}
            per.append(entry)
            if s["call"] is None or s["row"] is None or (
                    s.get("served") is None and s.get("served_png") is None):
                entry.update(rms=math.inf, error="no answer or no call row")
                continue
            call = s["call"]
            key = (call["seed"], call["batch"])
            if key not in noise_of:
                noise_of[key] = ref.initial_noise(call["seed"], call["batch"],
                                                  cfg["height"], cfg["width"],
                                                  dev)
            noise = noise_of[key][s["row"]:s["row"] + 1]
            g = s["garment"]()
            kw = dict(prompt_ids=s["prompt_ids"][None],
                      negative_ids=s["negative_ids"][None],
                      ref_image=g["ref_image"][None],
                      ref_clip_image=g["ref_clip_image"][None], noise=noise,
                      steps=s["steps"],
                      pose_image=None if s["pose"] is None
                      else s["pose"]()[None])
            with torch.no_grad():
                want = ref.generate(w32, cfg, **kw)[0]
                if control:
                    low = ref.generate(w32, cfg, precision="fp8", **kw)[0]
                    got = torch.round(low * 255.0).to(torch.uint8).cpu() \
                        .numpy()
                else:
                    try:
                        got = _served(s)
                    except ValueError as e:
                        entry.update(rms=math.inf, error=str(e))
                        got = None
                if got is not None:
                    entry.update(image_error(got, want))
        return {"image_rms_levels": max((e["rms"] for e in per),
                                        default=math.inf),
                "per_sample": per}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev[0]
        torch.backends.cudnn.allow_tf32 = prev[1]
