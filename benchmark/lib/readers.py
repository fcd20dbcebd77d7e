"""The arithmetic behind the metric files of `benchmark/metrics/`: each file
names its metric's layer, unit, source and the end-to-end metric it moves,
and calls one of these on the finished run. A reader that finds nothing to
read returns None, and the metric is left out of the result line."""

from __future__ import annotations

import statistics
from typing import Iterable, List, Optional

from benchmark.lib import roofline


def overlap_share(a: float, b: float, w0: float, w1: float) -> float:
    """The share of [a, b] that lies inside the window [w0, w1]."""
    if b <= a:
        return 1.0 if w0 <= a <= w1 else 0.0
    return max(0.0, min(b, w1) - max(a, w0)) / (b - a)


def median(values: Iterable[float]) -> Optional[float]:
    xs = list(values)
    return statistics.median(xs) if xs else None


def images_per_min(run) -> Optional[float]:
    """Images of the window per minute: every answered request (or written
    chunk) counted by the share of its time, from when it was due to when
    it was done, that lies inside the window."""
    w0, w1 = run.window
    if run.requests is not None:
        done = sum(overlap_share(r["due"], r["done"], w0, w1)
                   for r in run.requests if r["ok"])
    else:
        done = sum(c["images"] * overlap_share(c["t0"], c["t1"], w0, w1)
                   for c in run.chunks)
    return done * 60.0 / (w1 - w0)


def window_requests(run) -> List[dict]:
    w0, w1 = run.window
    return [r for r in run.requests if w0 <= r["due"] < w1]


def window_calls(run) -> List[dict]:
    w0, w1 = run.window
    return [c for c in run.calls_all if w0 <= c["t0"] < w1]


def batch_mean(run) -> Optional[float]:
    calls = window_calls(run)
    return sum(c["batch"] for c in calls) / len(calls) if calls else None


def serve_overhead(run) -> Optional[float]:
    """Median over the window's answered requests of (round trip - the
    pipeline call's wall, as the worker reports it)."""
    if run.requests is None:
        return None
    return median(r["done"] - r["sent"] - r["latency_s"]
                  for r in window_requests(run) if r["ok"])


def dress_host(run) -> Optional[float]:
    """Median over the window's chunks of (chunk wall - its call's wall)."""
    if not run.chunks:
        return None
    w0, w1 = run.window
    return median((c["t1"] - c["t0"]) - (c["call"]["t1"] - c["call"]["t0"])
                  for c in run.chunks if w0 <= c["t0"] < w1)


def denoise_ms_per_step(run, batch: int) -> Optional[float]:
    return median(1e3 * c["stages"]["denoise"] / c["steps"]
                  for c in window_calls(run) if c["batch"] == batch)


def mfu(run) -> Optional[float]:
    """Model FLOPs of the window's calls (each by its share inside the
    window) over the window at the bf16 peak, in %."""
    from benchmark.lib.flops import call_flops

    w0, w1 = run.window
    work = sum(overlap_share(c["t0"], c["t1"], w0, w1)
               * call_flops(run.config, run.shapes, c["batch"], c["steps"])
               for c in run.calls_all)
    if not work:
        return None
    return 100.0 * work / ((w1 - w0) * roofline.BF16_FLOPS_PER_S)


def device_idle(run) -> Optional[float]:
    t = run.trace
    if t is None or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def _counted(run, name):
    counts = run.trace["counts"].get(name) if run.trace else None
    return counts or None


def attn_roofline(run) -> Optional[float]:
    """K1's share of its roofline over the traced calls: the least time of
    the launches the program counted over the device time of the flash
    forward kernels, in %."""
    counts = _counted(run, "flash")
    if counts is None:
        return None
    spent = roofline.kernel_seconds(run.trace["by_name"], ("flash_fwd",))
    if spent <= 0:
        return None
    return 100.0 * roofline.bound_s(counts, roofline.flash_bound_s) / spent


# the GroupNorm family: K2's wgmma conv, its split-K reduce and its
# GroupNorm prologue, K3's resident and streaming GroupNorms
GN_FAMILY = ("gn_conv3x3", "splitk_reduce", "gn_resident", "gn_stream_stats",
             "gn_apply")


def gnconv_roofline(run) -> Optional[float]:
    """The GroupNorm family's share of its roofline: the least time of the
    counted GN+SiLU+conv3x3 (K2, K4) and GroupNorm (K3) launches over the
    device time of all their kernels, in %."""
    conv = _counted(run, "gn_conv")
    if conv is None:
        return None
    bound = roofline.bound_s(conv, roofline.conv_bound_s)
    bound += roofline.bound_s(_counted(run, "group_norm") or {},
                              roofline.gn_bound_s)
    spent = roofline.kernel_seconds(run.trace["by_name"], GN_FAMILY)
    return 100.0 * bound / spent if spent > 0 else None
