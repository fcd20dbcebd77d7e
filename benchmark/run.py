"""The benchmark of `imagdressing_tpu_torch` on an NVIDIA GPU.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

One run is one process: set-up (the program's kernels built or loaded from
its build directory in the checkout, the weights drawn on the device from
the seed and loaded through the program's own `from_state_dicts`, the
cell's shapes warmed, the traffic's server and clients started), then
`--seconds` of the cell's traffic, then the check of what the window
produced against the plain reference, and one JSON line on stdout (the
contract of BENCHMARK.json). With `--trace 1` the metrics are the cell's
per-layer metrics, read from a profiled stretch of whole calls inside the
window; with `--trace 0` its end-to-end metrics.

Everything is found by name: the cell in `benchmark/workloads/<cell>.json`,
its configuration in `benchmark/configs/<config>.json`, its traffic driver
in `benchmark/traffic/<driver>.py`, each metric's reader in
`benchmark/metrics/<metric>.py`, and which metrics a cell reports in
BENCHMARK.json.

`--device cpu --tiny` runs the same path on the CPU with the program's
small test stack (the CPU tests do); `--control` puts the float8 control
in the program's place in the check (the served images are replaced by
the reference's in float8, so a sound check reads `correct` false);
`--seeds a,b,...` runs one seed after another in one process
(calibration)."""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "benchmark"
# no JAX in the process that prints the result (compared by top-level name)
FORBIDDEN = ("jax", "jaxlib", "flax", "imagdressing_tpu")


def _caches() -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    cache = ROOT / "_bench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_metric(name: str):
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: str, kind: str):
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


def tiny(config: dict, cell: dict) -> None:
    """The program's small test stack at 64 x 64 in float32 and a small
    traffic of the same shape, for the CPU path."""
    import dataclasses

    from imagdressing_tpu_torch.pipelines.dressing import model_configs

    small = model_configs(small=True)
    for key, name in (("unet", "unet_cfg"), ("vae", "vae_cfg"),
                      ("text", "text_cfg"), ("vision", "vision_cfg"),
                      ("resampler", "resampler_cfg")):
        config[key] = {k: list(v) if isinstance(v, tuple) else v
                       for k, v in dataclasses.asdict(small[name]).items()}
    config.update(height=64, width=64, dtype="float32")
    p = cell["params"]
    p.update(steps=2, n_garments=3, garment_size=[72, 56], n_requests=400)
    if "pose_size" in p:
        p.update(pose_size=[72, 56], n_poses=2)
    cell["check"]["samples"] = 8
    cell["trace"]["start"], cell["trace"]["seconds"] = 0.2, 1.0


class Run:
    """One run's state: what set-up made, what the window recorded, what
    the readers read."""

    def __init__(self, args, seed: int, bench: dict, cell: dict,
                 config: dict, t_start: float):
        self.args, self.seed, self.bench = args, seed, bench
        self.cell, self.config = cell, config
        self.params, self.check = cell["params"], cell["check"]
        self.seconds = float(args.seconds)
        self.device, self.tiny = args.device, args.tiny
        self.t_start = t_start
        self.marks = {}  # set-up phase -> monotonic time at its end
        self.window = None
        self.setup_s = None
        self.requests = None
        self.chunks = None
        self.samples = []
        self.trace = None
        self.tracer = None
        self.pipe = None
        self.calls_all = []  # every call the recorder saw, window and drain
        self.tmpdir = tempfile.mkdtemp(prefix="bench-")

    def begin_window(self):
        w0 = time.monotonic()
        self.window = (w0, w0 + self.seconds)
        self.setup_s = w0 - self.t_start
        self.marks["server and clients"] = w0
        self.pipe.recording = True
        if self.tracer is not None:
            t = self.cell["trace"]
            self.tracer.start_at = w0 + t["start"] * self.seconds
            self.tracer.span_s = t["seconds"]
        return self.window

    def end_window(self) -> None:
        if self.tracer is not None:
            self.tracer.finish()


def _warm(run, driver, pipe) -> None:
    """One one-step call at every batch the cell's traffic forms."""
    import numpy as np

    cfg = run.config
    h, w, c = cfg["height"], cfg["width"], cfg["vision"]["image_size"]
    for b in driver.warm_batches(run.params):
        kw = dict(prompt_ids=np.zeros((b, 77), np.int64),
                  negative_prompt_ids=np.zeros((b, 77), np.int64),
                  ref_image=np.zeros((b, h, w, 3), np.float32),
                  ref_clip_image=np.zeros((b, c, c, 3), np.float32),
                  num_inference_steps=1, output_uint8=True)
        if cfg.get("controlnet"):
            kw["pose_image"] = np.zeros((b, h, w, 3), np.float32)
        pipe(**kw)


def finite(x: float) -> float:
    """JSON has no infinity: a failed request or an unread sample, which
    reads +inf, prints as 1e30."""
    return x if math.isfinite(x) else 1e30


def _power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def once(args, seed: int, t_start: float) -> int:
    import torch

    from benchmark.lib import check, program, recorder, trace, weights

    bench = load_json(ROOT / "BENCHMARK.json")
    cell = load_json(BENCH / "workloads" / f"{args.workload}.json")
    config = load_json(BENCH / "configs" / f"{cell['config']}.json")
    if args.tiny:
        tiny(config, cell)
    run = Run(args, seed, bench, cell, config, t_start)
    run.dtype = getattr(torch, config["dtype"])
    driver = importlib.import_module(f"benchmark.traffic.{cell['traffic']}")
    try:
        import imagdressing_tpu_torch.pipelines.dressing  # noqa: F401

        run.marks["import"] = time.monotonic()
        program.build_kernels(args.device)
        run.marks["build"] = time.monotonic()
        run.shapes = program.state_shapes(config)
        sds = weights.draw(run.shapes, seed, args.device, run.dtype)
        pipe = program.pipeline(config, sds, args.device, run.dtype)
        del sds
        if args.device == "cuda":
            torch.cuda.empty_cache()
        run.marks["weights"] = time.monotonic()
        _warm(run, driver, pipe)
        run.marks["warm-up"] = time.monotonic()
        tracer = None
        if args.trace:
            if args.device == "cuda":
                trace.Tracer.warm()
            tracer = trace.Tracer(math.inf, 0.0, program.kernel_counters())
        run.tracer = tracer
        run.pipe = recorder.RecordingPipe(pipe, tracer)
        run.calls_all = run.pipe.calls
        del pipe
        if args.device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        driver.drive(run)
        peak = (torch.cuda.max_memory_allocated()
                if args.device == "cuda" else 0)
        if tracer is not None and tracer.t_start is not None:
            run.trace = trace.summarize(tracer, run.calls_all)
        run.pipe = None  # the program's state goes
        gc.collect()
        if args.device == "cuda":
            torch.cuda.empty_cache()
        readings = check.run_check(run, control=args.control)
    finally:
        shutil.rmtree(run.tmpdir, ignore_errors=True)

    found = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if found:
        print(f"the process holds {found}: the port may not load JAX or the "
              "JAX package", file=sys.stderr)
        return 3

    kind = "per_layer" if args.trace else "end_to_end"
    metrics = {}
    for m in cell_metrics(bench, args.workload, kind):
        value = load_metric(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": finite(value), "unit": m["unit"]}
    limits = cell["check"]["limits"]
    compared = {k: {"value": finite(readings[k]), "limit": v}
                for k, v in limits.items()}
    correct = all(c["value"] <= c["limit"] for c in compared.values())
    if run.requests is not None:
        w0, w1 = run.window
        due = [r for r in run.requests if w0 <= r["due"] < w1]
        attempted, failed = len(due), sum(not r["ok"] for r in due)
    else:
        attempted = sum(c["images"] for c in run.chunks)
        failed = 0
    device = {"platform": "gpu" if args.device == "cuda" else "cpu",
              "kind": (torch.cuda.get_device_name(0)
                       if args.device == "cuda" else "cpu"),
              "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device}
    if run.trace is not None:
        device.update(busy_s=run.trace["busy_s"],
                      window_s=run.trace["window_s"])
        result["breakdown"] = {"device_ops": run.trace["device_ops"],
                               "idle_gaps": run.trace["idle_gaps"]}
    result["compared"] = compared
    # the earlier lines: the card, the calls, the samples, the generator
    err = sys.stderr
    if args.device == "cuda":
        print(f"card: {_power_limit()}", file=err)
    calls = run.calls_all
    t, split = run.t_start, []
    for phase, end in run.marks.items():
        split.append(f"{phase} {end - t:.3f}")
        t = end
    print(f"setup_s split: {', '.join(split)} s", file=err)
    print(f"calls: {len(calls)}, batches "
          f"{sorted({c['batch'] for c in calls})}", file=err)
    walls = sorted(c["t1"] - c["t0"] for c in calls)
    print(f"call wall median {walls[len(walls) // 2] if walls else None} s",
          file=err)
    for s in readings["per_sample"]:
        print(f"sample {json.dumps(s)}", file=err)
    print(json.dumps(result), flush=True)
    for name, c in compared.items():
        print(f"compared {name}: {c['value']} (limit {c['limit']})",
              file=err)
    err.flush()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0, choices=(0, 1))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--tiny", action="store_true",
                    help="the program's small test stack (CPU tests)")
    ap.add_argument("--control", action="store_true",
                    help="the float8 control in the program's place in the "
                         "check (calibration)")
    ap.add_argument("--seeds", default=None,
                    help="comma-separated seeds, one run each, in this "
                         "process (calibration)")
    args = ap.parse_args(argv)
    _caches()
    cell = load_json(BENCH / "workloads" / f"{args.workload}.json")
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < int(cell["chips"]):
            print(f"no result: {cell['chips']} CUDA device(s) needed, "
                  f"available={torch.cuda.is_available()}", file=sys.stderr)
            return 2
    seeds = [int(s) for s in args.seeds.split(",")] if args.seeds \
        else [args.seed]
    rc, t_start = 0, T_START
    for seed in seeds:
        rc = once(args, seed, t_start) or rc
        t_start = time.monotonic()
    return rc


if __name__ == "__main__":
    sys.exit(main())
