"""CUDA-event timing shared by `chip_smoke.py` and the profiling tools."""

from __future__ import annotations

from typing import Callable


def cuda_ms(fn: Callable[[], object], target_ms: float = 300.0) -> float:
    """Mean device time of fn() in ms: one warm call, one call to size the
    run, then a run of 3 to 200 back-to-back calls between two events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    n = max(3, min(200, int(target_ms / max(start.elapsed_time(end), 1e-3))))
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def cuda_graph_ms(fn: Callable[[], object], calls: int = 20,
                  replays: int = 20) -> float:
    """Device time of one fn() in ms, for calls shorter than their own host
    cost (a few microseconds of kernel behind tens of microseconds of
    Python): `calls` calls captured in one CUDA graph, replayed `replays`
    times between two events. The host work runs once, at capture; inputs
    stay where fn() left them (a tensor under 50 MB stays in L2)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm outside the capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)
