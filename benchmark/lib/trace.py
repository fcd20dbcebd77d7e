"""The traced window of a `--trace 1` run: `torch.profiler` recording the
device's activity only, started and stopped at pipeline-call boundaries,
and what is read from it: the union of device intervals (busy seconds),
device seconds by kernel name, the idle gaps by what the host was doing,
and the program's launch counters over exactly the traced calls."""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple


class Tracer:
    """Profile from the first call that starts at or after `start_at`
    (monotonic seconds) to the first call that starts `span_s` later, or to
    `finish()`. `counters` {name: the program's LaunchCounter} are reset at
    the start and read at the stop."""

    def __init__(self, start_at: float, span_s: float, counters: Dict):
        self.start_at, self.span_s = start_at, span_s
        self.counters = counters
        self.prof = None
        self.t_start: Optional[float] = None
        self.t_stop: Optional[float] = None
        self.wall_ns0 = 0
        self.counts: Dict[str, Dict] = {}

    @staticmethod
    def activities():
        """The device's activity; on a host without a card (the CPU tests)
        the host's, so that the same path runs and reads no device time."""
        import torch

        act = torch.profiler.ProfilerActivity
        return [act.CUDA] if torch.cuda.is_available() else [act.CPU]

    @staticmethod
    def warm() -> None:
        """Start and stop the profiler once (its first start initialises
        CUPTI, which takes long): done in set-up, not in the window."""
        import torch

        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]):
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def at_call(self, now: float) -> None:
        if self.t_stop is not None:
            return
        if self.prof is None and now >= self.start_at:
            self._start()
        elif self.prof is not None and now >= self.t_start + self.span_s:
            self._stop(now)

    def _start(self) -> None:
        import torch

        for c in self.counters.values():
            c.reset()
        self.prof = torch.profiler.profile(activities=self.activities())
        self.prof.start()
        self.wall_ns0 = time.time_ns()
        self.t_start = time.monotonic()

    def _stop(self, now: float) -> None:
        self.counts = {k: dict(c.by_shape) for k, c in self.counters.items()}
        self.prof.stop()
        self.t_stop = now

    def finish(self) -> None:
        """Stop a profile still running (the window closed first)."""
        if self.prof is not None and self.t_stop is None:
            self._stop(time.monotonic())

    def device_events(self) -> List[Tuple[str, float, float]]:
        """(name, start, end) of every device activity, in monotonic
        seconds, clipped to the traced window."""
        from torch.autograd import DeviceType

        out = []
        kineto = getattr(self.prof.profiler, "kineto_results", None)
        if kineto is not None:
            for e in kineto.events():
                if e.device_type() != DeviceType.CUDA:
                    continue
                t0 = self.t_start + (e.start_ns() - self.wall_ns0) / 1e9
                out.append((e.name(), t0, t0 + e.duration_ns() / 1e9))
        else:
            for e in self.prof.events():
                if e.device_type != DeviceType.CUDA:
                    continue
                out.append((e.name, self.t_start + e.time_range.start / 1e6,
                            self.t_start + e.time_range.end / 1e6))
        clipped = []
        for name, a, b in out:
            a, b = max(a, self.t_start), min(b, self.t_stop)
            if b > a:
                clipped.append((name, a, b))
        return clipped


def busy_intervals(events: Sequence[Tuple[str, float, float]]
                   ) -> List[Tuple[float, float]]:
    """The union of the events' intervals, as sorted disjoint intervals."""
    merged: List[List[float]] = []
    for _, a, b in sorted(events, key=lambda e: e[1]):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def host_label(t: float, calls: Sequence[Dict]) -> str:
    """What the host was doing at monotonic time t: inside a pipeline call,
    its stage (from the pipeline's stage clock, laid back from the call's
    end), or "between calls"."""
    for c in calls:
        if c["t0"] <= t <= c["t1"]:
            end = c["t1"]
            for stage, sec in reversed(list(c["stages"].items())):
                if t >= end - sec:
                    return f"in call: {stage}"
                end -= sec
            return "in call: before the first stage"
    return "between calls"


def summarize(tracer: Tracer, calls: Sequence[Dict], top: int = 10) -> Dict:
    """busy_s, window_s, device seconds by kernel name, the top device ops
    and the idle seconds by host activity, the launch counts of the traced
    calls and the calls themselves."""
    events = tracer.device_events()
    window = (tracer.t_start, tracer.t_stop)
    busy = busy_intervals(events)
    busy_s = sum(b - a for a, b in busy)
    by_name: Dict[str, float] = defaultdict(float)
    for name, a, b in events:
        by_name[name] += b - a
    idle: Dict[str, float] = defaultdict(float)
    edges = [window[0]] + [t for iv in busy for t in iv] + [window[1]]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            idle[host_label((a + b) / 2, calls)] += b - a
    traced_calls = [c for c in calls
                    if c["t0"] >= window[0] and c["t1"] <= window[1]]
    return dict(
        busy_s=busy_s, window_s=window[1] - window[0], by_name=dict(by_name),
        device_ops=[[n[:120], s] for n, s in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:top]],
        idle_gaps=[[n, s] for n, s in sorted(
            idle.items(), key=lambda kv: -kv[1])[:top]],
        counts=tracer.counts, calls=traced_calls)
