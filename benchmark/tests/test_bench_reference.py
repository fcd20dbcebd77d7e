"""The plain reference against the program's CPU path on the program's
small stack (float32: every kernel's plain version): the same images from
the same weights, inputs and noise, for the basic and the ControlNet
presets; the float8 control is far off; every weight but the vision
tower's unused top is read."""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark.lib import program, weights
from benchmark.reference import pipeline as ref
from test_bench_arith import tiny_config


@pytest.fixture(scope="module", params=["imagdressing-basic",
                                        "imagdressing-pose"])
def case(request):
    torch.set_num_threads(2)
    cfg = tiny_config(request.param)
    shapes = program.state_shapes(cfg)
    sds = weights.draw(shapes, 11, "cpu", torch.float32)
    pipe = program.pipeline(cfg, sds, "cpu", torch.float32)
    pipe.preset = dataclasses.replace(pipe.preset, num_inference_steps=3)
    w32 = {m: {k: v.float() for k, v in sd.items()} for m, sd in sds.items()}
    rng = np.random.default_rng(1)
    b, h, w = 2, cfg["height"], cfg["width"]
    inputs = dict(prompt_ids=rng.integers(0, 250, (b, 77)),
                  negative_ids=rng.integers(0, 250, (b, 77)),
                  ref_image=rng.uniform(-1, 1, (b, h, w, 3)).astype(
                      np.float32),
                  ref_clip_image=rng.standard_normal((b, 56, 56, 3)).astype(
                      np.float32),
                  pose_image=rng.uniform(0, 1, (b, h, w, 3)).astype(
                      np.float32) if cfg["controlnet"] else None)
    return cfg, pipe, w32, inputs


def _program(pipe, inputs, seed):
    kw = {k: v for k, v in inputs.items() if v is not None}
    kw["negative_prompt_ids"] = kw.pop("negative_ids")
    return pipe(seed=seed, **kw)


def test_reference_agrees_with_the_program(case):
    cfg, pipe, w32, inputs = case
    got = _program(pipe, inputs, seed=42)
    noise = ref.initial_noise(42, 2, cfg["height"], cfg["width"], "cpu")
    used = {}
    want = ref.generate(w32, cfg, noise=noise, steps=3, used=used, **inputs)
    assert float(np.abs(got - want.numpy()).max()) < 1e-4
    assert float(want.std()) > 0.05          # not a blank image
    unused = ref.unused_keys(w32, used)
    assert set(unused) <= {"vision"}
    assert all(k.startswith(("layers.2.", "post_layernorm",
                             "visual_projection"))
               for k in unused.get("vision", []))


def test_float8_control_is_far_off(case):
    cfg, _, w32, inputs = case
    noise = ref.initial_noise(42, 2, cfg["height"], cfg["width"], "cpu")
    exact = ref.generate(w32, cfg, noise=noise, steps=3, **inputs)
    low = ref.generate(w32, cfg, noise=noise, steps=3, precision="fp8",
                       **inputs)
    rms = float(((low - exact) * 255).pow(2).mean().sqrt())
    assert rms > 3.0


def test_rows_draw_their_calls_noise(case):
    cfg = case[0]
    four = ref.initial_noise(42, 4, cfg["height"], cfg["width"], "cpu")
    again = ref.initial_noise(42, 4, cfg["height"], cfg["width"], "cpu")
    assert torch.equal(four, again)
    assert four.shape == (4, cfg["height"] // 8, cfg["width"] // 8, 4)


def test_preparation_matches_the_apps():
    from imagdressing_tpu_torch.apps import image_utils as iu
    from imagdressing_tpu_torch.apps.serve import garment_inputs
    from imagdressing_tpu_torch.core.config import PRESETS
    from imagdressing_tpu_torch.train.data import clip_preprocess_np

    from benchmark.lib import synth

    cloth = synth.garment(3, 2, 613, 471)
    mine = ref.prepare_garment(cloth, 640, 512, 224, "bicubic")
    vae, clip = garment_inputs(cloth, PRESETS["basic"], 224)
    assert np.array_equal(mine["ref_image"], vae[0])
    assert np.array_equal(mine["ref_clip_image"], clip[0])
    folder = ref.prepare_garment(cloth, 640, 512, 224, "bilinear")
    path = synth.png_encode(cloth)
    vae2, clip2, _ = iu.prepare_garment(path, 640, 512, 224)
    assert np.array_equal(folder["ref_image"], vae2[0])
    assert np.array_equal(clip_preprocess_np(iu.resize_img(cloth)),
                          folder["ref_clip_image"])
    pose = synth.pose_map(3, 1, 96, 80)
    assert np.array_equal(ref.prepare_pose(pose, 64, 48),
                          iu.resize(pose, (48, 64)).astype(np.float32)
                          / 255.0)
    from imagdressing_tpu_torch.apps.tokenizer import HashTokenizer

    assert np.array_equal(ref.HashTokenizer()("a Red dress"),
                          HashTokenizer()("a Red dress"))
