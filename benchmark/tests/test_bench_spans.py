"""The span metrics (`benchmark/lib/spans.py`) on traced CPU runs
(`--device cpu --tiny`): the pose cell's `.dress` readers read the
program's spans and leave out the ControlNet's device time, which only a
card gives; the served cell's `.rate` readers, which BENCHMARK.json does
not list while that cell is out, read its queue and decode spans. And the
arithmetic of the idle share under open image spans."""

import json
from types import SimpleNamespace

from benchmark.lib import spans
from test_bench_run import _run_subprocess

DRESS = ("dress_read_s.dress", "dress_write_s.dress",
         "device_idle_image_io.dress", "denoise_enqueue_ms_per_step.dress")


def test_a_traced_dress_run_reads_the_span_metrics():
    result, _ = _run_subprocess("pose.dress_b4", "--trace", "1")
    m = result["metrics"]
    for name in DRESS:
        assert name in m, name
    assert m["dress_read_s.dress"]["value"] > 0
    assert m["dress_write_s.dress"]["value"] > 0
    assert 0 <= m["device_idle_image_io.dress"]["value"] <= 100
    assert m["denoise_enqueue_ms_per_step.dress"]["value"] > 0
    # no card, no device time: the ControlNet's share is not read
    assert "controlnet_ms_per_step.dress" not in m


def test_a_traced_served_run_reads_the_rate_span_metrics(monkeypatch,
                                                          capsys):
    from benchmark import run

    listed = run.cell_metrics

    def cell_metrics(bench, cell, kind):
        if kind == "per_layer":
            return [{"name": "serve_queue_s.rate", "unit": "s"},
                    {"name": "serve_decode_s.rate", "unit": "s"}]
        return listed(bench, cell, kind)

    monkeypatch.setattr(run, "cell_metrics", cell_metrics)
    capsys.readouterr()
    assert run.main(["--workload", "basic.serve_closed8", "--seed",
                     "3000000029", "--seconds", "3", "--device", "cpu",
                     "--tiny", "--trace", "1"]) == 0
    m = json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "metrics"]
    assert m["serve_queue_s.rate"]["value"] >= 0
    assert m["serve_decode_s.rate"]["value"] > 0


def _span(i, name, t0, t1, parent=None):
    return {"name": name, "id": i, "parent": parent, "trace_id": None,
            "thread": 1, "t0": t0, "t1": t1, "attrs": {}}


def test_idle_under_image_spans(monkeypatch):
    """Root image spans [1, 3] and [4, 5] (a nested one adds nothing, a
    span of another name nothing) over device activity [2, 4.5] in the
    window [0, 10]: idle under them 1 + 0.5 s, 15 %."""
    every = [_span(1, "image.prepare_garment", 1.0, 3.0),
             _span(2, "image.read", 1.5, 2.5, parent=1),
             _span(3, "image.write", 4.0, 5.0),
             _span(4, "pipeline.call", 5.0, 9.0)]
    from imagdressing_tpu_torch.core import profiling

    monkeypatch.setattr(profiling, "spans", lambda: every)
    tracer = SimpleNamespace(t_start=0.0, t_stop=10.0,
                             device_events=lambda: [("k", 2.0, 4.5)])
    run = SimpleNamespace(tracer=tracer)
    assert abs(spans.device_idle_image_io(run) - 15.0) < 1e-9
    assert spans.traced(SimpleNamespace(tracer=None)) is None
