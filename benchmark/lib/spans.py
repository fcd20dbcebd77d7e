"""The program's own spans (`imagdressing_tpu_torch.core.profiling.span`)
inside a `--trace 1` run's traced window, and what the span metrics of
`benchmark/metrics/` read from them, beside the harness's own records of
the window's chunks and calls. A program without the recorder reads
nothing: every function here then returns None."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from benchmark.lib import readers
from benchmark.lib.trace import busy_intervals


def traced(run) -> Optional[Tuple[List[Dict], Dict[int, Dict]]]:
    """(the spans that start and end inside the traced window, every span
    the program kept by id), or None where there is no traced window or
    the program records no spans."""
    tracer = run.tracer
    if tracer is None or tracer.t_start is None or tracer.t_stop is None:
        return None
    try:
        from imagdressing_tpu_torch.core import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    if read is None:
        return None
    every = read()
    w0, w1 = tracer.t_start, tracer.t_stop
    return ([s for s in every if s["t0"] >= w0 and s["t1"] <= w1],
            {s["id"]: s for s in every})


def is_image_root(s: Dict, by_id: Dict[int, Dict]) -> bool:
    """An `image.*` span that no other `image.*` span encloses."""
    if not s["name"].startswith("image."):
        return False
    parent = by_id.get(s["parent"])
    return parent is None or not parent["name"].startswith("image.")


def _image_roots(run):
    found = traced(run)
    if found is None:
        return None
    inside, by_id = found
    return [s for s in inside if is_image_root(s, by_id)]


def _seconds_in(spans: Sequence[Dict], a: float, b: float) -> float:
    return sum(s["t1"] - s["t0"] for s in spans
               if s["t0"] >= a and s["t1"] <= b)


def dress_read(run) -> Optional[float]:
    """Median over the chunks whose inputs were read inside the traced
    window of the seconds of root image spans between the chunk's start
    and its call's start (PNG decode, resizes, the CLIP view)."""
    roots = _image_roots(run)
    if roots is None or not run.chunks:
        return None
    w0, w1 = run.tracer.t_start, run.tracer.t_stop
    return readers.median(
        _seconds_in(roots, c["t0"], c["call"]["t0"]) for c in run.chunks
        if c["t0"] >= w0 and c["call"]["t0"] <= w1)


def dress_write(run) -> Optional[float]:
    """Median over the chunks whose collages were written inside the traced
    window of the seconds of root image spans between the call's end and
    the chunk's end (the garment's resize, the PNG encode and write)."""
    roots = _image_roots(run)
    if roots is None or not run.chunks:
        return None
    w0, w1 = run.tracer.t_start, run.tracer.t_stop
    return readers.median(
        _seconds_in(roots, c["call"]["t1"], c["t1"]) for c in run.chunks
        if c["call"]["t1"] >= w0 and c["t1"] <= w1)


def _overlap(xs: Sequence[Tuple[float, float]],
             ys: Sequence[Tuple[float, float]]) -> float:
    """The length of the intersection of two sorted disjoint interval
    lists."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0.0, b - a)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def device_idle_image_io(run) -> Optional[float]:
    """The share of the traced window in which a root image span is open on
    the host and the device runs nothing, in %."""
    roots = _image_roots(run)
    if roots is None:
        return None
    w0, w1 = run.tracer.t_start, run.tracer.t_stop
    io = busy_intervals([(s["name"], s["t0"], s["t1"]) for s in roots])
    busy = busy_intervals(run.tracer.device_events())
    io_s = sum(b - a for a, b in io)
    return 100.0 * (io_s - _overlap(io, busy)) / (w1 - w0)


def _call_of(s: Dict, by_id: Dict[int, Dict]) -> Optional[Dict]:
    while s is not None and s["name"] != "pipeline.call":
        s = by_id.get(s["parent"])
    return s


def _steps(run, batch: int) -> Optional[List[Dict]]:
    found = traced(run)
    if found is None:
        return None
    inside, by_id = found
    out = []
    for s in inside:
        if s["name"] == "denoise.step":
            call = _call_of(s, by_id)
            if call is not None and call["attrs"].get("batch") == batch:
                out.append(s)
    return out


def denoise_enqueue_ms_per_step(run, batch: int) -> Optional[float]:
    """Median host seconds of a `denoise.step` span (the time to enqueue
    one CFG step) in the traced calls at `batch`, in ms."""
    steps = _steps(run, batch)
    return None if steps is None else readers.median(
        1e3 * (s["t1"] - s["t0"]) for s in steps)


def controlnet_ms_per_step(run, batch: int) -> Optional[float]:
    """Median device time of the ControlNet call of a step (the step span's
    `controlnet_device_s`, from CUDA events; absent without a card) in the
    traced calls at `batch`, in ms."""
    steps = _steps(run, batch)
    return None if steps is None else readers.median(
        1e3 * s["attrs"]["controlnet_device_s"] for s in steps
        if "controlnet_device_s" in s["attrs"])


def median_seconds(run, name: str) -> Optional[float]:
    """Median seconds of the spans named `name` in the traced window."""
    found = traced(run)
    if found is None:
        return None
    return readers.median(s["t1"] - s["t0"] for s in found[0]
                          if s["name"] == name)
