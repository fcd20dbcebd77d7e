"""The benchmark's arithmetic on the CPU: model FLOPs against
`FlopCounterMode` over the plain reference, the roofline functions against
the program's per-shape functions they were copied from, the rate
arithmetic (failures counted), and the synthetic inputs."""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.lib import flops, readers, roofline, synth
from benchmark.reference import pipeline as ref
from conftest import ROOT


def tiny_config(name="imagdressing-pose"):
    from benchmark.run import tiny

    cfg = json.loads((ROOT / f"benchmark/configs/{name}.json").read_text())
    cell = {"params": {}, "check": {}, "trace": {}}
    tiny(cfg, cell)
    return cfg


@pytest.mark.parametrize("name", ["imagdressing-basic", "imagdressing-pose"])
def test_call_flops_match_the_counter_over_real_tensors(name):
    from benchmark.lib import program, weights

    cfg = tiny_config(name)
    shapes = program.state_shapes(cfg)
    w = {m: {k: v.float() for k, v in sd.items()}
         for m, sd in weights.draw(shapes, 7, "cpu", torch.float32).items()}
    b, steps, h, wd = 2, 3, cfg["height"], cfg["width"]
    rng = np.random.default_rng(0)
    kw = dict(prompt_ids=rng.integers(0, 250, (b, 77)),
              negative_ids=rng.integers(0, 250, (b, 77)),
              ref_image=rng.uniform(-1, 1, (b, h, wd, 3)),
              ref_clip_image=rng.standard_normal((b, 56, 56, 3)),
              noise=torch.randn(b, h // 8, wd // 8, 4),
              pose_image=rng.uniform(0, 1, (b, h, wd, 3))
              if cfg["controlnet"] else None)
    with FlopCounterMode(display=False) as counter:
        ref.generate(w, cfg, steps=steps, **kw)
    assert flops.call_flops(cfg, shapes, b, steps) == pytest.approx(
        counter.get_total_flops(), rel=1e-12)


def test_roofline_functions_match_the_programs():
    from imagdressing_tpu_torch.tools import profile_infer as pi

    for key in [(8, 5120, 8, 40, True), (4, 5120, 1, 512, False),
                (2, 1280, 8, 80, True), (4, 80, 8, 160, False)]:
        assert roofline.flash_flops(*key) == pi._flash_flops(*key)
        assert roofline.flash_bytes(*key) == pi._flash_bytes(*key)
        assert roofline.flash_exp2(*key) == pi._flash_exp2(*key)
    for key in [(8, 80, 64, 320, 320), (4, 640, 512, 256, 128)]:
        assert roofline.conv_bytes(*key) == pi._conv_bytes(*key)
    assert roofline.gn_bytes((8, 5120, 320), "none") \
        == pi._gn_bytes((8, 5120, 320), "none")
    # K1 at the served batch-4 shape: the exp2 bound of PERF.md's table
    assert roofline.flash_bound_s((8, 5120, 8, 40, True)) * 1e3 \
        == pytest.approx(0.6018, abs=1e-4)


def test_roofline_share_from_counts_and_kernel_time():
    counts = {(8, 5120, 8, 40, True): 3}
    bound = roofline.bound_s(counts, roofline.flash_bound_s)
    run = SimpleNamespace(trace={
        "counts": {"flash": counts},
        "by_name": {"void flash_fwd_wgmma<40>(...)": 2 * bound,
                    "elementwise": 5.0}})
    assert readers.attn_roofline(run) == pytest.approx(50.0)
    assert readers.attn_roofline(SimpleNamespace(trace=None)) is None


def _request(due, done, ok=True, sent=None, latency=0.5):
    return {"due": due, "sent": due if sent is None else sent, "done": done,
            "ok": ok, "latency_s": latency}


def test_rate_counts_the_share_inside_the_window():
    reqs = [_request(0.0, 2.0), _request(2.0, 4.0),
            _request(9.0, 11.0),                  # half inside
            _request(5.0, 6.0, ok=False)]         # failed: not an image
    run = SimpleNamespace(window=(0.0, 10.0), requests=reqs, chunks=None)
    assert readers.images_per_min(run) == pytest.approx(2.5 * 6.0)
    chunks = [{"t0": 8.0, "t1": 12.0, "images": 4}]
    run = SimpleNamespace(window=(0.0, 10.0), requests=None, chunks=chunks)
    assert readers.images_per_min(run) == pytest.approx(2 * 6.0)
    assert readers.overlap_share(1.0, 1.0, 0.0, 2.0) == 1.0


def test_png_round_trip_and_the_programs_encoder():
    from imagdressing_tpu_torch.apps.png import decode_png, encode_png

    img = synth.garment(5, 0, 37, 53)
    assert np.array_equal(synth.png_decode(synth.png_encode(img)), img)
    assert np.array_equal(decode_png(synth.png_encode(img)), img)
    assert np.array_equal(synth.png_decode(encode_png(img)), img)


def test_inputs_are_the_same_set_for_every_seed():
    params = {"n_garments": 16, "subject_words": [3, 12],
              "prompt_suffix": ", best quality, high quality",
              "n_requests": 64}
    p1, p2 = (synth.request_plan(s, params) for s in (3, 2 ** 31 + 77))
    assert p1["prompt"] != p2["prompt"]
    for p in (p1, p2):
        assert all(t.endswith(params["prompt_suffix"]) for t in p["prompt"])
        # within CLIP's 77 tokens: BOS, at most 75 words, EOS
        assert max(len(t.split()) for t in p["prompt"]) <= 16
        assert len(set(p["prompt"])) == 64
        for k in range(4):
            assert sorted(p["garment"][16 * k:16 * (k + 1)]) \
                == list(range(16))
    assert sorted(len(t.split()) for t in p1["prompt"]) \
        == sorted(len(t.split()) for t in p2["prompt"])
    assert np.array_equal(synth.garment(9, 1, 20, 30),
                          synth.garment(9, 1, 20, 30))
