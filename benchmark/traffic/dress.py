"""Folder traffic: a catalogue of garments dressed in a set of poses, in
chunks of `batch`, by the benchmark's copy of `apps/dress.py`'s chunk
loop (the CLI itself loads checkpoint files): per chunk, read and prepare
each garment and its pose map from PNG files with `apps.image_utils`, one
`DressingPipeline` call, then the collages encoded and written. Items run
garment-major within pose, as the CLI's grid does, over and over until the
window closes."""

from __future__ import annotations

import os
import time
from typing import Dict, List

import numpy as np

from benchmark.lib import synth
from benchmark.reference.pipeline import (
    DEFAULT_NEGATIVE,
    HashTokenizer,
    prepare_garment,
    prepare_pose,
)


def warm_batches(params: Dict) -> List[int]:
    return [params["batch"]]


def _write_inputs(run, root: str) -> List[tuple]:
    p = run.params
    os.makedirs(root, exist_ok=True)
    h, w = p["garment_size"]
    cloths = []
    for g in range(p["n_garments"]):
        path = os.path.join(root, f"cloth_{g:03d}.png")
        with open(path, "wb") as f:
            f.write(synth.png_encode(synth.garment(run.seed, g, h, w)))
        cloths.append(path)
    ph, pw = p["pose_size"]
    poses = []
    for q in range(p["n_poses"]):
        path = os.path.join(root, f"pose_{q:03d}.png")
        with open(path, "wb") as f:
            f.write(synth.png_encode(synth.pose_map(run.seed, q, ph, pw)))
        poses.append(path)
    return [(c, q) for q in poses for c in cloths]


def drive(run) -> None:
    from imagdressing_tpu_torch.apps import image_utils as iu
    from imagdressing_tpu_torch.apps.tokenizer import load_tokenizer

    p, cfg = run.params, run.config
    root = os.path.join(run.tmpdir, "dress")
    items = _write_inputs(run, root)
    out_dir = os.path.join(root, "out")
    os.makedirs(out_dir, exist_ok=True)
    tokenizer = load_tokenizer("")
    if run.tiny:
        tokenizer = type(tokenizer)(cfg["text"]["vocab_size"])
    preset = run.pipe.pipe.preset
    clip_size = run.pipe.models.vision_cfg.image_size
    prompt, bs = p["prompt"], p["batch"]
    pose_cache: Dict[str, np.ndarray] = {}
    run.chunks = []
    w0, w1 = run.begin_window()
    k = 0
    while time.monotonic() < w1:
        t0 = time.monotonic()
        chunk = [items[(k * bs + j) % len(items)] for j in range(bs)]
        # -- the CLI's chunk loop (apps/dress.py), pose path only --
        prepped = [iu.prepare_garment(c, preset.height, preset.width,
                                      clip_size=clip_size) for c, _ in chunk]
        for _, pose_path in chunk:
            if pose_path not in pose_cache:
                pose = iu.resize(iu.read_image(pose_path),
                                 (preset.width, preset.height))
                pose_cache[pose_path] = (pose.astype(np.float32)
                                         / 255.0)[None]
        b = len(chunk)
        n_calls = len(run.calls_all)
        out = run.pipe(
            prompt_ids=np.repeat(tokenizer(prompt)[None], b, axis=0),
            negative_prompt_ids=np.repeat(
                tokenizer(iu.DEFAULT_NEGATIVE)[None], b, axis=0),
            ref_image=np.concatenate([x[0] for x in prepped]),
            ref_clip_image=np.concatenate([x[1] for x in prepped]),
            seed=p["seed"], num_inference_steps=p["steps"],
            pose_image=np.concatenate([pose_cache[q] for _, q in chunk]))
        files = []
        for i in range(b):
            garment = iu.resize(prepped[i][2], (preset.width, preset.height),
                                "bicubic")
            collage = iu.image_grid([garment] + iu.to_uint8(out[i:i + 1]),
                                    1, 2)
            name = os.path.join(out_dir, f"{k:05d}_{i}.png")
            iu.write_image(name, collage)
            files.append(name)
        # -- end of the CLI's loop --
        run.chunks.append(dict(t0=t0, t1=time.monotonic(), images=b,
                               call=run.calls_all[n_calls], files=files,
                               items=[(k * bs + j) % len(items)
                                      for j in range(bs)]))
        k += 1
    run.end_window()
    run.samples = _samples(run, items)


def _samples(run, items) -> List[Dict]:
    p, cfg = run.params, run.config
    rng = synth.rng_for(run.seed, 7)
    done = [(c, i) for c, chunk in enumerate(run.chunks)
            for i in range(chunk["images"])]
    k = min(run.check["samples"], len(done))
    picks = sorted(rng.choice(len(done), k, replace=False).tolist()) \
        if k else []
    h, w = p["garment_size"]
    tok = HashTokenizer(cfg["text"]["vocab_size"])
    ph, pw = p["pose_size"]
    out = []
    for n in picks:
        c, i = done[n]
        chunk = run.chunks[c]
        item = chunk["items"][i]
        g, q = item % p["n_garments"], item // p["n_garments"]
        with open(chunk["files"][i], "rb") as f:
            collage = synth.png_decode(f.read())
        out.append(dict(
            name=f"chunk {c} item {i}", served=collage[:, collage.shape[1]
                                                       // 2:],
            call=chunk["call"], row=i, prompt_ids=tok(p["prompt"]),
            negative_ids=tok(DEFAULT_NEGATIVE), steps=p["steps"],
            pose=lambda q=q: prepare_pose(synth.pose_map(run.seed, q, ph, pw),
                                          cfg["height"], cfg["width"]),
            garment=lambda g=g, h=h, w=w: prepare_garment(
                synth.garment(run.seed, g, h, w), cfg["height"],
                cfg["width"], cfg["vision"]["image_size"], "bilinear")))
    return out
