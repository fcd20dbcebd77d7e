"""The (data, model) layout of ranks (port of `imagdressing_tpu/core/mesh.py`).

The reference trains on 10 GPUs through DeepSpeed ZeRO-2 over NCCL; the JAX
package declares a (data, model) device mesh and lets XLA emit the
collectives. The port runs one process per rank, each driving one device,
and issues the collectives itself through `torch.distributed`:

  data   data parallelism: the batch is split over it, gradients are
         averaged over it, and the ZeRO-2 optimizer state is split over it;
  model  tensor parallelism (`core/tp.py`): attention and feed-forward
         projections split over it, everything else replicated.

Rank r sits at (r // model, r % model). Its model group is the ranks of its
data index, its data group the ranks of its model index. Every collective
here is the identity on a group of None: a one-process layout needs no
process group at all, and an unsplit model has no model group. Inside a
world the data group is real even for one rank, so that one NCCL rank runs
the collectives it would run among many.

The backend is an explicit argument of `init_from_env`: NCCL on the card,
gloo for CPU ranks (gloo also carries CUDA tensors, which two ranks on one
card need: NCCL refuses two ranks on one GPU). Nothing switches backend or
device behind the caller's back.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
# every rendezvous and collective gives up after this long
DEFAULT_TIMEOUT = datetime.timedelta(seconds=600)


@dataclasses.dataclass
class Mesh:
    """This rank's place in a (data, model) layout and its process groups
    (None: no process group, or an unsplit model)."""

    data: int
    model: int
    rank: int
    device: torch.device
    data_group: Any = None
    model_group: Any = None
    world_group: Any = None

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def data_rank(self) -> int:
        return self.rank // self.model

    @property
    def model_rank(self) -> int:
        return self.rank % self.model


def launched() -> bool:
    """True inside a launched world: torchrun's or `parallel.launch.spawn`'s
    environment (WORLD_SIZE set)."""
    return "WORLD_SIZE" in os.environ


def init_from_env(backend: str, *, device_type: str = "cuda",
                  share_devices: bool = False,
                  timeout: datetime.timedelta = DEFAULT_TIMEOUT
                  ) -> torch.device:
    """Join the world that RANK, WORLD_SIZE, LOCAL_RANK and MASTER_ADDR /
    MASTER_PORT describe (as torchrun sets them), over `backend` ("nccl"
    or "gloo"), and make this rank's device current. A CUDA rank takes
    card LOCAL_RANK; with `share_devices`, LOCAL_RANK modulo the visible
    count (ranks sharing a card need gloo). Returns the device."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r} (nccl | gloo)")
    env = os.environ
    rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    local = int(env.get("LOCAL_RANK", rank))
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA rank on a host without a card")
        cards = torch.cuda.device_count()
        if local >= cards and not share_devices:
            raise RuntimeError(f"local rank {local} with {cards} visible "
                               "cards")
        device = torch.device("cuda", local % cards)
        torch.cuda.set_device(device)
    elif device_type == "cpu":
        if backend == "nccl":
            raise ValueError("NCCL carries CUDA tensors only; CPU ranks "
                             "need gloo")
        device = torch.device("cpu")
    else:
        raise ValueError(f"device type {device_type!r} (cuda | cpu)")
    init = (f"tcp://{env.get('MASTER_ADDR', '127.0.0.1')}:"
            f"{env['MASTER_PORT']}")
    dist.init_process_group(backend, init_method=init, rank=rank,
                            world_size=world, timeout=timeout)
    return device


def destroy() -> None:
    """Leave the world, if this process joined one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def make_mesh(data: int = -1, model: int = 1, *,
              device: Optional[torch.device] = None) -> Mesh:
    """The (data, model) layout over the current world (one rank when no
    process group is initialised); data=-1 takes every rank the model
    split leaves. Every rank must call it, with the same arguments: it
    creates the process groups."""
    if dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
    else:
        world, rank = 1, 0
    if model < 1 or world % model:
        raise ValueError(f"{world} ranks do not split into model={model}")
    if data == -1:
        data = world // model
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} over {world} ranks")
    device = torch.device(device) if device is not None else \
        torch.device("cpu")
    mesh = Mesh(data=data, model=model, rank=rank, device=device)
    if not (dist.is_available() and dist.is_initialized()):
        return mesh
    mesh.world_group = dist.group.WORLD
    if model == 1:
        mesh.data_group = dist.group.WORLD
        return mesh
    # the same calls in the same order on every rank
    for d in range(data):
        group = dist.new_group([d * model + m for m in range(model)])
        if d == mesh.data_rank:
            mesh.model_group = group
    if data > 1:
        for m in range(model):
            group = dist.new_group([d * model + m for d in range(data)])
            if m == mesh.model_rank:
                mesh.data_group = group
    return mesh


# ---------------------------------------------------------------------------
# Collectives over a group (None: this rank alone, the identity). The
# reference's NCCL collectives map onto these.
# ---------------------------------------------------------------------------


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of x over the group (a new tensor)."""
    if group is None:
        return x
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


def pmean(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else psum(x, group) / group_size(group)


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """The group's x concatenated along dim 0 in rank order."""
    if group is None:
        return x
    n = group_size(group)
    x = x.contiguous()
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out


def reduce_scatter(x: torch.Tensor, group) -> torch.Tensor:
    """Sum x over the group and keep this rank's 1/n along dim 0 (whose
    length n must divide)."""
    if group is None:
        return x
    n = group_size(group)
    if x.shape[0] % n:
        raise ValueError(f"dim 0 of {tuple(x.shape)} does not split {n} ways")
    x = x.contiguous()
    out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, x, group=group)
    return out


def broadcast_object(obj: Any, group=None, src: int = 0) -> Any:
    """`obj` of global rank `src`, on every rank of the group."""
    if group is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=group)
    return box[0]


def barrier(group) -> None:
    if group is not None:
        dist.barrier(group=group)
