"""The benchmark's wrapper around the program's pipeline: it records every
call (when, how many rows, which prompts in which rows, the pipeline's own
stage clock) and, in a traced run, starts and stops the profiler at call
boundaries, so that the traced window holds whole calls and the launch
counters cover exactly the calls in it."""

from __future__ import annotations

import hashlib
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from benchmark.lib.trace import Tracer


def row_digest(prompt_ids: np.ndarray) -> str:
    """The key of one row's prompt ids (what identifies a request)."""
    return hashlib.sha1(np.asarray(prompt_ids, np.int32).tobytes()).hexdigest()


class RecordingPipe:
    """Calls the program's pipeline and records each call. `calls` holds
    {t0, t1, batch, steps, rows (prompt digests), stages}; `tracer` (or
    None) is told of every call's start."""

    def __init__(self, pipe, tracer: Optional[Tracer] = None):
        self.pipe, self.models = pipe, pipe.models
        self.tracer = tracer
        self.calls: List[Dict] = []
        self.recording = False
        self._lock = threading.Lock()

    def __call__(self, **kw):
        t0 = time.monotonic()
        if self.tracer is not None and self.recording:
            self.tracer.at_call(t0)
        out = self.pipe(**kw)
        t1 = time.monotonic()
        if self.recording:
            steps = kw.get("num_inference_steps") \
                or self.pipe.preset.num_inference_steps
            with self._lock:
                self.calls.append(dict(
                    t0=t0, t1=t1, batch=int(kw["ref_image"].shape[0]),
                    steps=int(steps), seed=kw.get("seed"),
                    rows=[row_digest(r) for r in kw["prompt_ids"]],
                    stages=dict(self.pipe.last_stage_seconds)))
        return out
