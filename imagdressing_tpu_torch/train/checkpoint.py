"""Training checkpoints (port of `imagdressing_tpu/train/checkpoint.py`, whose
orbax format the port does not use).

Layout: one directory per saved step under the manager's directory,

    <directory>/<step>/state.pt     the train state as CPU tensors and
                                    numbers (`train.step.state_to_host`):
                                    the fp32 master trainables' state dicts,
                                    the optimizer's moments and counters, step
    <directory>/<step>/extra.json   the caller's JSON (when given)

written under a temporary name and renamed into place, so a run killed
mid-save leaves no directory that `latest_step` would pick. Read with
`torch.load(weights_only=True)`: tensors, numbers and containers only.

`save` copies the state to host memory before it returns (the trainer
updates its modules in place, so a copy taken later would hold a later
step's weights); with `async_save` only the file write runs on a thread.

Over several ranks every rank calls `save`, `wait` and `restore` in the
same order: `save` gathers a split state (ZeRO-2 shards, TP slices) into
the whole host form, so that the files are those one device writes, and
only rank 0 writes them; `wait` ends with a barrier over the group, so no
rank reads a checkpoint that rank 0 is still writing. `restore` loads the
whole form and each rank keeps its part: a run saved over 2 ranks resumes
on 1, and `apps.dress --trained_ckpt` reads it.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import torch

from imagdressing_tpu_torch.core import mesh as mesh_lib
from imagdressing_tpu_torch.train.step import (
    TrainState,
    state_from_host,
    state_to_host,
)

STATE_FILE = "state.pt"
EXTRA_FILE = "extra.json"


def saved_steps(directory: str) -> List[int]:
    """The steps with a complete checkpoint under `directory`, ascending."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(n) for n in os.listdir(directory)
                  if n.isdigit()
                  and os.path.isfile(os.path.join(directory, n, STATE_FILE)))


def latest_step(directory: str) -> Optional[int]:
    steps = saved_steps(directory)
    return steps[-1] if steps else None


def read_checkpoint(directory: str, step: int
                    ) -> Tuple[Dict[str, Any], Optional[dict]]:
    """-> (host state as `state_to_host` gives it, extra or None)."""
    path = os.path.join(directory, str(step))
    # mapped, not read: a caller that keeps only the weights (serving)
    # touches only their pages
    host = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                      weights_only=True, mmap=True)
    extra = None
    if os.path.isfile(os.path.join(path, EXTRA_FILE)):
        with open(os.path.join(path, EXTRA_FILE), encoding="utf-8") as f:
            extra = json.load(f)
    return host, extra


class CheckpointManager:
    def __init__(self, directory: str, *, max_to_keep: int = 3,
                 async_save: bool = True, rank: int = 0, group=None):
        """`rank`: this process's global rank (only 0 writes); `group`:
        the ranks that save together (None: this process alone)."""
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.async_save = async_save
        self.rank = rank
        self.group = group
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    def save(self, state: TrainState, extra: Optional[dict] = None) -> bool:
        """Checkpoint `state` at its step; False (and nothing written) when
        that step is already saved."""
        self.wait()
        step = int(state.step)
        if step in saved_steps(self.directory):
            return False
        host = state_to_host(state)
        if self.rank != 0:
            return True
        if self.async_save:
            self._thread = threading.Thread(
                target=self._write_guarded, args=(step, host, extra),
                daemon=False)
            self._thread.start()
        else:
            self._write(step, host, extra)
        return True

    def _write_guarded(self, step, host, extra) -> None:
        try:
            self._write(step, host, extra)
        except Exception as e:  # noqa: BLE001 -- re-raised by wait()
            self._error = e

    def _write(self, step: int, host: Dict[str, Any],
               extra: Optional[dict]) -> None:
        os.makedirs(self.directory, exist_ok=True)
        final = os.path.join(self.directory, str(step))
        tmp = os.path.join(self.directory, f".{step}.tmp-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(host, os.path.join(tmp, STATE_FILE))
        if extra is not None:
            with open(os.path.join(tmp, EXTRA_FILE), "w",
                      encoding="utf-8") as f:
                json.dump(extra, f)
        shutil.rmtree(final, ignore_errors=True)  # an incomplete one
        os.replace(tmp, final)
        for old in saved_steps(self.directory)[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))

    def restore(self, state_template: TrainState
                ) -> Tuple[Optional[TrainState], Optional[dict]]:
        """The latest checkpoint loaded into the template's modules and
        devices -> (state, extra), or (None, None) when there is none."""
        self.wait()
        step = latest_step(self.directory)
        if step is None:
            return None, None
        host, extra = read_checkpoint(self.directory, step)
        return state_from_host(state_template, host), extra

    def wait(self) -> None:
        """Block until the pending write is on disk (on every rank of the
        group); re-raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        mesh_lib.barrier(self.group)
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def close(self) -> None:
        self.wait()
