"""Tracing and step timing (port of `imagdressing_tpu/core/profiling.py`).

  * `trace(log_dir)`: `torch.profiler` over a block (host and, on a card,
    device activity), written as a Chrome trace into `log_dir`;
  * `annotate(name)`: a named range that `torch.profiler` records and, on a
    card, an NVTX range (what a CUDA timeline shows);
  * `device_summary(prof, wall_ms)`: a profiled window's device time,
    busy share, kernel launches and costliest device ops;
  * `StepTimer`: the host-side data / step time split of the reference
    implementation's log line; with a device given, `step_done`
    synchronises it first, as the JAX package blocks on the result.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Dict, Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block; writes `log_dir/trace.json` (Chrome format)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named region in profiler traces (and an NVTX range on a card)."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def device_summary(prof, wall_ms: float, top: int = 10) -> Dict[str, Any]:
    """A profiled window (device activity recorded) -> its device ms (the
    kernels' own time), busy share of the wall, kernel launches, and the
    `top` device ops by time [name, ms, launches]."""
    from torch.autograd import DeviceType

    rows = []
    for row in prof.key_averages():
        if row.device_type == DeviceType.CUDA:
            ms = getattr(row, "self_device_time_total",
                         getattr(row, "self_cuda_time_total", 0.0)) / 1e3
            rows.append([row.key, ms, row.count])
    rows.sort(key=lambda r: -r[1])
    device = sum(r[1] for r in rows)
    return {"wall_ms": wall_ms, "device_ms": device,
            "busy_share": device / wall_ms if wall_ms else 0.0,
            "launches": sum(r[2] for r in rows), "top_device_ops": rows[:top]}


class StepTimer:
    """data_time / step_time of the last step (reference train.py's log
    line): `data_done()` after the batch is ready, `step_done()` after the
    step; `device` (a CUDA device) is synchronised before the step's clock
    is read, so the step time includes its device work."""

    def __init__(self, device: Optional[torch.device] = None):
        self.device = torch.device(device) if device is not None else None
        self._t = time.perf_counter()
        self.data_time = 0.0
        self.step_time = 0.0

    def data_done(self) -> None:
        now = time.perf_counter()
        self.data_time = now - self._t
        self._t = now

    def step_done(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.step_time = now - self._t
        self._t = now

    def metrics(self) -> Dict[str, float]:
        return {"data_time": self.data_time, "step_time": self.step_time}
