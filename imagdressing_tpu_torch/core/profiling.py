"""Tracing and step timing (port of `imagdressing_tpu/core/profiling.py`).

  * `trace(log_dir)`: `torch.profiler` over a block (host and, on a card,
    device activity), written as a Chrome trace into `log_dir`;
  * `span(name, **attrs)`: the program's one span recorder. While a
    `torch.profiler` session runs in the process (`trace()`, or any other,
    such as the benchmark's traced window), each span keeps its name, start
    and end on `time.monotonic()`, its parent (the enclosing span of the
    same thread), its thread, a `trace_id` shared by the spans of one
    chunk, request or call, and its attributes (counts: bytes, pixels,
    batch, steps), in one bounded buffer that `spans()` reads and `clear()`
    empties; it is also a `record_function` range, so the Chrome trace
    shows it over the kernels. With no session a site costs a flag check
    and a `with` that does nothing;
  * `device_summary(prof, wall_ms)`: a profiled window's device time,
    busy share, kernel launches and costliest device ops;
  * `StepTimer`: the host-side data / step time split of the reference
    implementation's log line; with a device given, `step_done`
    synchronises it first, as the JAX package blocks on the result.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from typing import Any, Deque, Dict, Iterator, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler


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


# spans kept: the oldest go first (a traced window of the dress loop makes
# ~100 a chunk)
SPAN_BUFFER = 1 << 14

_spans: Deque[Dict[str, Any]] = collections.deque(maxlen=SPAN_BUFFER)
_spans_lock = threading.Lock()
_span_ids = itertools.count(1)
_trace_ids = itertools.count(1)
_open = threading.local()  # .stack: this thread's open spans, innermost last


def recording() -> bool:
    """Whether spans record: a `torch.profiler` session runs in this
    process. The module flag is process-wide; the C-level
    `torch._C._autograd._profiler_enabled()` reads False on threads other
    than the one that started the session (the serve app's handlers)."""
    return _autograd_profiler._is_profiler_enabled


def next_trace_id() -> int:
    """A new id for the spans of one request (process-wide, from 1)."""
    return next(_trace_ids)


def _stack() -> List[Dict[str, Any]]:
    stack = getattr(_open, "stack", None)
    if stack is None:
        stack = _open.stack = []
    return stack


def _new(name: str, trace_id, attrs: Dict[str, Any]) -> Dict[str, Any]:
    stack = _stack()
    parent = stack[-1] if stack else None
    if trace_id is None and parent is not None:
        trace_id = parent["trace_id"]
    return {"name": name, "id": next(_span_ids),
            "parent": None if parent is None else parent["id"],
            "trace_id": trace_id, "thread": threading.get_ident(),
            "t0": None, "t1": None, "attrs": attrs}


def _keep(record: Dict[str, Any]) -> None:
    with _spans_lock:
        _spans.append(record)


class Span:
    """An open span (`span()` while recording). `record` is the dict that
    `spans()` returns once it ends; `set(**attrs)` adds attributes, also
    after the end (values known only later, such as device times)."""

    __slots__ = ("record", "_range")

    def __init__(self, name: str, trace_id, attrs: Dict[str, Any]):
        self.record = _new(name, trace_id, attrs)
        self._range = torch.profiler.record_function(name)

    def set(self, **attrs) -> None:
        self.record["attrs"].update(attrs)

    def __enter__(self) -> "Span":
        _stack().append(self.record)
        self._range.__enter__()
        self.record["t0"] = time.monotonic()
        return self

    def __exit__(self, *exc) -> None:
        self.record["t1"] = time.monotonic()
        self._range.__exit__(*exc)
        _stack().pop()
        _keep(self.record)


class _Off:
    """What `span()` returns with no profiler session: does nothing."""

    __slots__ = ()

    def set(self, **attrs) -> None:
        pass

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> None:
        pass


_OFF = _Off()


def span(name: str, trace_id=None, **attrs):
    """A span over a `with` block; the block gets a `Span` (or, with no
    profiler session, an object whose `set` does nothing). `trace_id`
    None: the enclosing span's."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return Span(name, trace_id, attrs)


def record(name: str, t0: float, t1: float, trace_id=None,
           **attrs) -> Optional[Dict[str, Any]]:
    """A span of an interval that has already passed (monotonic t0, t1),
    under the enclosing span of this thread; None with no session."""
    if not _autograd_profiler._is_profiler_enabled:
        return None
    r = _new(name, trace_id, attrs)
    r["t0"], r["t1"] = t0, t1
    _keep(r)
    return r


def current() -> Optional[Dict[str, Any]]:
    """The innermost open span of this thread (its record), or None."""
    stack = getattr(_open, "stack", None)
    return stack[-1] if stack else None


def spans() -> List[Dict[str, Any]]:
    """The ended spans in the buffer, oldest first: dicts of name, id,
    parent (an id or None), trace_id, thread, t0, t1, attrs."""
    with _spans_lock:
        return list(_spans)


def clear() -> None:
    with _spans_lock:
        _spans.clear()


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
