"""Whole runs of every cell on the CPU (`--device cpu --tiny`, the
program's small stack in float32), past the harness's look for a chip:
the result line as the contract has it, `correct` true for the program,
and false for the float8 control put in the program's place and for the
program with its timed path broken underneath (a DDIM step that returns
its state unchanged, half of a batch left out and the mean of the rest
served in its place, an image altered where it is produced). The cells
run on one chip, so no exchange between chips can be left out. The card
test runs a short window of each cell on the card."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import ROOT

# every workload file: the cells of BENCHMARK.json and the served cell that
# was measured and is kept out of it until its runs agree (PERF.md, Open
# questions)
CELLS = sorted(p.stem for p in (ROOT / "benchmark/workloads").glob("*.json"))
LISTED = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _run_subprocess(cell, *extra):
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", cell,
         "--seed", "3000000019", "--seconds", "3", "--device", "cpu",
         "--tiny", *extra], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1]), out.stderr


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_end_to_end_on_the_cpu(cell):
    result, err = _run_subprocess(cell, "--trace", "0")
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics",
                                "device"]
    assert list(result)[-1] == "compared"
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] > 0
    assert "setup_s" in result["metrics"]
    assert len(result["metrics"]) >= (2 if cell in LISTED else 1)
    assert "compared image_rms_levels" in err.strip().splitlines()[-1]


def test_a_traced_run_reads_the_host_layers():
    result, _ = _run_subprocess("pose.dress_b4", "--trace", "1")
    m = result["metrics"]
    for name in ("dress_host_s.dress", "denoise_ms_per_step.dress",
                 "mfu.dress", "device_idle.dress"):
        assert name in m
    # no card: no kernel was launched, so no roofline is read
    assert "attn_roofline.dress" not in m
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(result["device"])


def test_the_control_in_the_programs_place_reads_not_correct():
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", "pose.dress_b4",
         "--seconds", "2", "--device", "cpu", "--tiny", "--control",
         "--seeds", "5,3000000027"], cwd=ROOT, capture_output=True,
        text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [json.loads(x) for x in out.stdout.strip().splitlines()]
    assert len(lines) == 2
    for result in lines:
        assert result["correct"] is False
        c = result["compared"]["image_rms_levels"]
        assert c["limit"] < c["value"] < 1e30


def test_no_result_without_the_program(tmp_path):
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark")
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "3", "--device", "cpu", "--tiny"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert out.returncode != 0
    assert not out.stdout.strip()


# ---------------------------------------------------------------------------
# In-process runs with the timed path replaced or broken
# ---------------------------------------------------------------------------


class _Wrapped:
    """The program's pipeline with its call replaced by `fn(pipe, kw)`."""

    def __init__(self, pipe, fn):
        self.pipe, self.fn = pipe, fn
        self.models, self.preset = pipe.models, pipe.preset
        self.last_stage_seconds = {}

    def __call__(self, **kw):
        out = self.fn(self.pipe, kw)
        self.last_stage_seconds = dict(self.pipe.last_stage_seconds) or {
            "denoise": 1.0}
        return out


def _in_process(monkeypatch, capsys, cell, fn):
    from benchmark import run
    from benchmark.lib import program

    made = program.pipeline

    def pipeline(config, sds, device, dtype):
        pipe = made(config, sds, device, dtype)
        w32 = {m: {k: v.float().clone() for k, v in sd.items()}
               for m, sd in sds.items()}
        return _Wrapped(pipe, lambda p, kw: fn(p, kw, config, w32))

    monkeypatch.setattr(program, "pipeline", pipeline)
    capsys.readouterr()
    assert run.main(["--workload", cell, "--seed", "3000000021",
                     "--seconds", "3", "--device", "cpu", "--tiny"]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _float8_reference(pipe, kw, config, w32):
    from benchmark.reference import pipeline as ref

    b = kw["ref_image"].shape[0]
    steps = kw.get("num_inference_steps") or pipe.preset.num_inference_steps
    seed = kw.get("seed") or pipe.preset.seed
    img = ref.generate(
        w32, config, prompt_ids=kw["prompt_ids"],
        negative_ids=kw["negative_prompt_ids"], ref_image=kw["ref_image"],
        ref_clip_image=kw["ref_clip_image"],
        noise=ref.initial_noise(seed, b, config["height"], config["width"],
                                "cpu"),
        steps=steps, pose_image=kw.get("pose_image"), precision="fp8")
    return np.round(img.numpy() * 255.0).astype(np.uint8) \
        if kw.get("output_uint8") else img.numpy()


@pytest.mark.parametrize("cell", CELLS)
def test_the_float8_control_is_not_correct(monkeypatch, capsys, cell):
    result = _in_process(monkeypatch, capsys, cell, _float8_reference)
    assert result["correct"] is False


def _frozen_step(pipe, kw, config, w32):
    from imagdressing_tpu_torch.samplers import ddim

    real = ddim.step
    ddim.step = lambda sched, eps, t, sample, n, eta=0.0, noise=None: sample
    try:
        return pipe(**kw)
    finally:
        ddim.step = real


def _half_batch(pipe, kw, config, w32):
    b = kw["ref_image"].shape[0]
    if b == 1:
        return pipe(**kw)
    half = (b + 1) // 2
    rows = {k: v[:half] if isinstance(v, np.ndarray) and v.shape[:1] == (b,)
            else v for k, v in kw.items()}
    out = pipe(**rows)
    mean = out.astype(np.float64).mean(axis=0, keepdims=True)
    rest = np.repeat(mean, b - half, axis=0).round().astype(out.dtype)
    return np.concatenate([out, rest])


def _altered_image(pipe, kw, config, w32):
    out = pipe(**kw).copy()
    top = 255 if out.dtype == np.uint8 else 1.0
    out[:, :16, :16] = top - out[:, :16, :16]
    return out


@pytest.mark.parametrize("fault", [_frozen_step, _half_batch, _altered_image])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(monkeypatch, capsys, cell, fault):
    result = _in_process(monkeypatch, capsys, cell, fault)
    assert result["correct"] is False


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_the_card(card, cell):
    assert torch.cuda.device_count() >= 1
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", cell,
         "--seed", "3000000023", "--seconds", "8", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["device"]["platform"] == "gpu"
