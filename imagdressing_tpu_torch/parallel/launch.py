"""Start the ranks of a world on this host (what torchrun does, from
Python): one process per rank, started with the `spawn` method, each with
RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT set on a free
local port, so that `core.mesh.init_from_env` joins them. The apps call it
when `--data_parallel` / `--tensor_parallel` ask for more than one rank;
the tests start their gloo ranks through it.

`spawn` waits for every rank under one deadline, raises the first rank's
error with its traceback, and kills every rank still alive when it leaves,
so a rank that hangs in a collective cannot outlive the call.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import queue
import socket
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple


def plan(data_parallel: int, tensor_parallel: int, device: str,
         allow_cpu_mesh: bool = False) -> Tuple[int, int]:
    """(data, model) of the apps' --data_parallel / --tensor_parallel:
    data -1 takes every visible card the model split leaves (on the CPU,
    one rank; inside a launched world, the world's ranks). Raises
    SystemExit for more cards than are visible (no CPU stands in for a
    missing card) and for CPU ranks without `allow_cpu_mesh` (gloo CPU
    ranks are for tests and development)."""
    import torch

    model = max(tensor_parallel, 1)
    if "WORLD_SIZE" in os.environ:
        world = int(os.environ["WORLD_SIZE"])
        data = data_parallel if data_parallel > 0 else world // model
        if data * model != world:
            raise SystemExit(f"--data_parallel {data_parallel} x "
                             f"--tensor_parallel {model} in a world of "
                             f"{world} ranks")
    elif torch.device(device).type == "cuda":
        cards = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if cards == 0 and data_parallel in (-1, 1) and model == 1:
            from imagdressing_tpu_torch.pipelines.dressing import (
                resolve_device,
            )

            resolve_device(device)  # raises: no card at all
        data = data_parallel if data_parallel > 0 else cards // model
        if data < 1 or data * model > cards:
            raise SystemExit(
                f"--data_parallel {data_parallel} x --tensor_parallel "
                f"{model} needs {max(data, 1) * model} GPUs; {cards} "
                "visible")
    else:
        data = data_parallel if data_parallel > 0 else 1
    if torch.device(device).type == "cpu" and data * model > 1 \
            and not allow_cpu_mesh:
        raise SystemExit("CPU ranks (gloo) need --allow_cpu_mesh: they are "
                         "for tests and development")
    return data, model


def join(device: str, data: int, model: int):
    """Join the launched world (`core.mesh.init_from_env`: NCCL for card
    ranks, one card each; gloo for CPU ranks) -> its (data, model)
    `core.mesh.Mesh`."""
    import torch

    from imagdressing_tpu_torch.core import mesh as mesh_lib

    kind = torch.device(device).type
    dev = mesh_lib.init_from_env("nccl" if kind == "cuda" else "gloo",
                                 device_type=kind)
    return mesh_lib.make_mesh(data, model, device=dev)


def run_app(entry: Callable, argv: Sequence[str], body: Callable, *,
            data_parallel: int, tensor_parallel: int, device: str,
            allow_cpu_mesh: bool = False, rank0_result: bool = False):
    """An app's ranks, from its --data_parallel / --tensor_parallel flags
    (`plan`): inside a launched world, join it, return body(mesh) and
    leave it; outside one, start the ranks, each rerunning entry(argv)
    (more than one asked for; returns None, or with `rank0_result` what
    entry(argv) returned on rank 0, which must pickle), or return
    body(None) here."""
    from imagdressing_tpu_torch.core import mesh as mesh_lib

    data, model = plan(data_parallel, tensor_parallel, device,
                       allow_cpu_mesh)
    if not mesh_lib.launched():
        if data * model == 1:
            return body(None)
        # an app runs as long as it is asked to: no deadline of its own
        # (the ranks' collectives keep the process group's timeout)
        out = spawn(_app_rank, data * model,
                    (entry, list(argv), rank0_result), timeout=float("inf"))
        return out[0] if rank0_result else None
    mesh = join(device, data, model)
    try:
        return body(mesh)
    finally:
        mesh_lib.destroy()


def _app_rank(entry: Callable, argv: List[str], keep: bool) -> Any:
    result = entry(argv)
    return result if keep else None  # else it stays in the rank's process


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(rank: int, world: int, port: int) -> Dict[str, str]:
    return {"RANK": str(rank), "WORLD_SIZE": str(world),
            "LOCAL_RANK": str(rank), "MASTER_ADDR": "127.0.0.1",
            "MASTER_PORT": str(port)}


def _rank_main(job: str, rank: int, world: int, port: int, threads,
               results) -> None:
    os.environ.update(rank_env(rank, world, port))
    try:
        with open(job, "rb") as f:
            fn, args = pickle.load(f)  # written by `spawn` for its ranks
        if threads:
            import torch

            torch.set_num_threads(threads)
        results.put((rank, True, fn(*args)))
    except BaseException:  # noqa: BLE001 -- reported to the parent
        results.put((rank, False, traceback.format_exc()))


def spawn(fn: Callable, nprocs: int, args: Sequence[Any] = (), *,
          timeout: float = 600.0, threads: Optional[int] = None
          ) -> List[Any]:
    """Run fn(*args) in `nprocs` new processes as ranks 0..nprocs-1 of one
    world; returns their results in rank order. `fn` must be importable by
    its module and name (a module-level function), and its arguments and
    result picklable. `threads` sets each rank's torch CPU threads."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    # the function and its arguments go through a file: a rank that dies
    # while it starts never reads its pipe, and a large argument written
    # into that pipe would block `start` with no deadline
    tmp = tempfile.TemporaryDirectory(prefix="ranks-")
    job = os.path.join(tmp.name, "job.pkl")
    with open(job, "wb") as f:
        pickle.dump((fn, tuple(args)), f)
    procs = [ctx.Process(target=_rank_main,
                         args=(job, r, nprocs, port, threads, results),
                         name=f"rank{r}")
             for r in range(nprocs)]
    out: Dict[int, Any] = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while len(out) < nprocs:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"ranks {sorted(set(range(nprocs)) - set(out))} gave "
                    f"no result within {timeout:.0f} s")
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [p.name for r, p in enumerate(procs)
                        if r not in out and p.exitcode is not None]
                if dead:
                    raise RuntimeError(f"{dead} exited without a result")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            out[rank] = value
        for p in procs:
            # an app's ranks have no deadline (inf), which join cannot take
            left = deadline - time.monotonic()
            p.join(timeout=None if left == float("inf") else max(left, 1.0))
        return [out[r] for r in range(nprocs)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            if p.pid is not None:
                p.join(timeout=10)
        results.close()
        tmp.cleanup()
