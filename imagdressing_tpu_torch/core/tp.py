"""Tensor parallelism for the UNets over the `model` group (port of
`imagdressing_tpu/core/tp.py`).

The JAX package annotates the weights with `_spec_for_path`'s rules and
lets GSPMD insert the collectives. The port applies the same rules itself,
Megatron-style, by swapping the split projections for modules that hold
this rank's slice:

  column split (the output dim, this rank's heads): to_q / to_k / to_v of
    both attentions, the garment adapters' to_k_ref / to_v_ref and the IP
    adapters' to_k_ip / to_v_ip, whose K/V reach the same heads;
  GEGLU up-projection: the fused (2 * inner, D) weight is split as its two
    halves, h and gate each by rank, so `chunk(2)` of a rank's output pairs
    h with its own gate (the JAX rules split the fused dim and reshard; the
    trade-off `imagdressing_tpu/core/tp.py` names);
  row split (the input dim), then a sum over the group: to_out and the
    feed-forward down-projection, whose bias is added once, after the sum;
  everything else is replicated.

The attention runs the rank's heads (heads / model) through the same
kernels. Around a split region `copy_to_model` is the identity forward and
sums the input gradient over the group backward, `reduce_from_model` sums
the partial outputs forward and passes the gradient through backward, so
the replicated parameters see the whole gradient on every rank. Both sums
run in fp32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from imagdressing_tpu_torch.core.mesh import group_size
from imagdressing_tpu_torch.ops.nn import Linear

# the models whose projections split (the JAX package splits the UNets; the
# adapters follow them so that their K/V land on the rank's heads)
TP_MODELS = ("unet", "ref_unet", "ref_adapters", "ip_adapters")
COLUMN = frozenset({"to_q", "to_k", "to_v", "to_k_ref", "to_v_ref",
                    "to_k_ip", "to_v_ip"})


def tp_kind(name: str) -> Optional[str]:
    """How a parameter of a `TP_MODELS` state dict splits: "column",
    "geglu", "row" or None (replicated), by its key."""
    parts = name.split(".")
    if len(parts) < 2:
        return None
    module, leaf = parts[-2], parts[-1]
    if module in COLUMN:
        return "column"
    ff = len(parts) >= 3 and parts[-3] == "ff"
    if ff and module == "proj":
        return "geglu"
    if (module == "to_out" or (ff and module == "out")) and leaf == "weight":
        return "row"
    return None


def shard_tensor(kind: Optional[str], full: torch.Tensor, rank: int,
                 size: int) -> torch.Tensor:
    """This rank's slice of a whole parameter (a view)."""
    if kind is None or size == 1:
        return full
    if kind == "column":
        return full.chunk(size, 0)[rank]
    if kind == "row":
        return full.chunk(size, 1)[rank]
    h, gate = full.chunk(2, 0)
    return torch.cat([h.chunk(size, 0)[rank], gate.chunk(size, 0)[rank]])


def unshard_tensor(kind: Optional[str], shards) -> torch.Tensor:
    """The whole parameter from the group's slices, in rank order."""
    if kind is None or len(shards) == 1:
        return shards[0]
    if kind == "column":
        return torch.cat(shards, 0)
    if kind == "row":
        return torch.cat(shards, 1)
    halves = [s.chunk(2, 0) for s in shards]
    return torch.cat([h for h, _ in halves] + [g for _, g in halves], 0)


def gather_tensor(kind: Optional[str], shard: torch.Tensor, group
                  ) -> torch.Tensor:
    """`unshard_tensor` of every rank's slice, on every rank (a
    collective: each rank of the group calls it)."""
    n = group_size(group)
    if kind is None or n == 1:
        return shard
    shard = shard.contiguous()
    parts = [torch.empty_like(shard) for _ in range(n)]
    dist.all_gather(parts, shard, group=group)
    return unshard_tensor(kind, parts)


def _sum_fp32(x: torch.Tensor, group) -> torch.Tensor:
    y = x.to(torch.float32, copy=True)
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_fp32(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum_fp32(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceFromModel.apply(x, group)


class ColumnParallelLinear(Linear):
    """This rank's output rows of a Linear (column split, or GEGLU's two
    halves); the input's gradient is summed over the group."""

    def __init__(self, weight: torch.Tensor, bias: Optional[torch.Tensor],
                 group):
        nn.Module.__init__(self)
        self.weight = nn.Parameter(weight)
        self.bias = None if bias is None else nn.Parameter(bias)
        self.group = group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(copy_to_model(x, self.group), self.weight, self.bias)


class RowParallelLinear(ColumnParallelLinear):
    """This rank's input columns of a Linear; the partial products are
    summed over the group, then the (replicated) bias is added."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = reduce_from_model(F.linear(x, self.weight), self.group)
        return y if self.bias is None else y + self.bias


def split_module(module: nn.Module, rank: int, size: int, group
                 ) -> nn.Module:
    """Swap every split projection of a `TP_MODELS` module for this rank's
    slice (copies, so the whole weights can be freed), in place; returns
    the module. A size of 1 leaves it as it is."""
    if size == 1:
        return module
    for parent_name, parent in list(module.named_modules()):
        for name, child in list(parent.named_children()):
            path = f"{parent_name}.{name}" if parent_name else name
            kind = tp_kind(path + ".weight")
            if kind is None or not isinstance(child, Linear) \
                    or isinstance(child, ColumnParallelLinear):
                continue
            w = shard_tensor(kind, child.weight.detach(), rank, size).clone()
            b = child.bias
            if b is not None:
                b = shard_tensor(tp_kind(path + ".bias"), b.detach(), rank,
                                 size).clone()
            cls = RowParallelLinear if kind == "row" else ColumnParallelLinear
            new = cls(w, b, group).requires_grad_(child.weight.requires_grad)
            setattr(parent, name, new)
    return module


def split_models(models, mesh) -> None:
    """`split_module` over the stack's `TP_MODELS` for the mesh's model
    rank, in place. The heads must divide the model split."""
    if mesh.model == 1:
        return
    heads = models.unet_cfg.attention_num_heads
    if heads % mesh.model:
        raise ValueError(f"{heads} attention heads do not split "
                         f"{mesh.model} ways")
    for name in TP_MODELS:
        module = getattr(models, name, None)
        if module is not None:
            split_module(module, mesh.model_rank, mesh.model,
                         mesh.model_group)
