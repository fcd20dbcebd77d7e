"""Metric trackers (a copy of `imagdressing_tpu/train/trackers.py`; the
port imports nothing of the JAX package): jsonl (default) + a
dependency-free TensorBoard writer.

The reference implementation wires `--report_to tensorboard/wandb` through
accelerate (its train.py). Here the default sink stays the append-only jsonl
any dashboard can tail, and `--report_to tensorboard` additionally writes a
real TensorBoard event file -- encoded by hand (TFRecord framing +
Event/Summary protobuf wire format + masked CRC32C), so no
tensorflow/tensorboardX dependency is needed. `wandb`/`comet` are thin
adapters over their packages when installed (offline mode by default);
without the package they raise pointing at PARITY.md's "tracker sinks"
decision -- tensorboard+jsonl are the supported sinks.
"""

from __future__ import annotations

import json
import os
import socket
import struct
import time
from typing import Dict, Iterable, Optional

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli), table-driven pure python — TFRecord checksums.

_CRC_TABLE = []


def _crc_table():
    if not _CRC_TABLE:
        poly = 0x82F63B78  # reversed Castagnoli polynomial
        for n in range(256):
            c = n
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            _CRC_TABLE.append(c)
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Protobuf wire-format encoding for the two messages TensorBoard reads.
#
#   Event    { double wall_time=1; int64 step=2; string file_version=3;
#              Summary summary=5; }
#   Summary  { repeated Value value=1; }
#   Value    { string tag=1; float simple_value=2; }


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _double_field(field: int, v: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", v)


def _float_field(field: int, v: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", v)


def _int64_field(field: int, v: int) -> bytes:
    return _tag(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _bytes_field(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def _summary(values: Dict[str, float]) -> bytes:
    out = b""
    for tag_name, v in values.items():
        value_msg = _bytes_field(1, tag_name.encode("utf-8")) + _float_field(
            2, float(v)
        )
        out += _bytes_field(1, value_msg)
    return out


def _event(wall_time: float, step: Optional[int] = None,
           file_version: Optional[str] = None,
           values: Optional[Dict[str, float]] = None) -> bytes:
    out = _double_field(1, wall_time)
    if step is not None:
        out += _int64_field(2, step)
    if file_version is not None:
        out += _bytes_field(3, file_version.encode("utf-8"))
    if values:
        out += _bytes_field(5, _summary(values))
    return out


def _tfrecord(payload: bytes) -> bytes:
    length = struct.pack("<Q", len(payload))
    return (
        length
        + struct.pack("<I", _masked_crc(length))
        + payload
        + struct.pack("<I", _masked_crc(payload))
    )


class TensorBoardTracker:
    """Writes `events.out.tfevents.*` files TensorBoard loads natively."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        fname = "events.out.tfevents.%010d.%s" % (
            int(time.time()), socket.gethostname(),
        )
        self.path = os.path.join(logdir, fname)
        self._f = open(self.path, "ab")
        # TensorBoard skips files without the version header event
        self._f.write(_tfrecord(_event(time.time(),
                                       file_version="brain.Event:2")))
        self._f.flush()

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        scalars = {
            k: float(v) for k, v in metrics.items()
            if isinstance(v, (int, float)) and k != "step"
        }
        self._f.write(_tfrecord(_event(time.time(), step=step,
                                       values=scalars)))
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class JsonlTracker:
    """Append-only metrics.jsonl (the historical default sink)."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self._f = open(path, "a", buffering=1)

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        self._f.write(json.dumps(dict(metrics, step=step)) + "\n")

    def close(self) -> None:
        self._f.close()


class MultiTracker:
    def __init__(self, trackers: Iterable):
        self.trackers = list(trackers)

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        for t in self.trackers:
            t.log(step, metrics)

    def close(self) -> None:
        for t in self.trackers:
            t.close()


class WandbTracker:
    """Thin adapter over the `wandb` package (the reference's tracker).

    Runs in offline mode unless WANDB_MODE overrides it, so it works on
    air-gapped hosts and the run syncs later with `wandb sync`.
    Raises ImportError when wandb isn't installed — `make_tracker` turns
    that into the documented PARITY.md pointer.
    """

    def __init__(self, output_dir: str, project: str = "imagdressing_tpu"):
        import wandb  # an optional dependency

        os.makedirs(output_dir, exist_ok=True)
        self._run = wandb.init(
            project=project,
            dir=output_dir,
            mode=os.environ.get("WANDB_MODE", "offline"),
        )

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        scalars = {
            k: float(v) for k, v in metrics.items()
            if isinstance(v, (int, float)) and k != "step"
        }
        self._run.log(scalars, step=step)

    def close(self) -> None:
        self._run.finish()


class CometTracker:
    """Thin adapter over `comet_ml` (OfflineExperiment; sync with
    `comet upload`). Same contract as WandbTracker."""

    def __init__(self, output_dir: str, project: str = "imagdressing_tpu"):
        import comet_ml  # an optional dependency

        os.makedirs(output_dir, exist_ok=True)
        self._exp = comet_ml.OfflineExperiment(
            project_name=project, offline_directory=output_dir,
        )

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        scalars = {
            k: float(v) for k, v in metrics.items()
            if isinstance(v, (int, float)) and k != "step"
        }
        self._exp.log_metrics(scalars, step=step)

    def close(self) -> None:
        self._exp.end()


class NullTracker:
    """What a rank other than 0 logs to: nothing."""

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        pass

    def close(self) -> None:
        pass


def make_tracker(report_to: str, output_dir: str, *, rank: int = 0):
    """The reference's --report_to seat: 'jsonl' (default),
    'tensorboard', 'all' (both), plus 'wandb'/'comet' when their packages
    are installed (offline-mode adapters). Without them the error points
    at PARITY.md ("tracker sinks"), which records tensorboard+jsonl as the
    supported sinks. Only rank 0 writes: any other rank gets a
    `NullTracker` (its metrics are the same global numbers)."""
    if report_to not in ("jsonl", "tensorboard", "all", "wandb", "comet"):
        raise ValueError(f"unknown --report_to {report_to!r}")
    if rank != 0:
        return NullTracker()
    jsonl = JsonlTracker(os.path.join(output_dir, "metrics.jsonl"))
    if report_to == "jsonl":
        return jsonl
    if report_to == "tensorboard":
        return MultiTracker(
            [jsonl, TensorBoardTracker(os.path.join(output_dir, "logs"))]
        )
    if report_to == "all":
        return MultiTracker(
            [jsonl, TensorBoardTracker(os.path.join(output_dir, "logs"))]
        )
    if report_to in ("wandb", "comet"):
        cls = WandbTracker if report_to == "wandb" else CometTracker
        try:
            return MultiTracker([jsonl, cls(output_dir)])
        except ImportError as e:
            raise ValueError(
                f"--report_to {report_to} needs the {report_to} package, "
                "which this zero-egress image does not ship; tensorboard + "
                "jsonl are the supported sinks here (see PARITY.md, "
                "'tracker sinks'). On a machine with the package installed "
                "this flag works offline and syncs later."
            ) from e
    raise ValueError(f"unknown --report_to {report_to!r}")
