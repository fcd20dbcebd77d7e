"""Conditioning-as-data for the denoising UNet (port of
`imagdressing_tpu/models/conditioning.py`).

Every conditioning signal is an explicit input of the UNet call, never a
patched attention processor: the garment K/V on the self-attention layers,
the text, IP-Adapter and garment-cross K/V on the cross-attention layers
(each timestep-invariant, so projected once before the sampling loop), the
per-row scales that let one CFG batch carry [uncond; cond], and the
ControlNet's residuals. A LoRA is folded into the projection weights once
(`fold_lora`), so the loop runs no extra product for it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import torch
from torch import nn

KV = Dict[str, Tuple[torch.Tensor, torch.Tensor]]
Scale = Union[float, torch.Tensor]


@dataclasses.dataclass
class Conditioning:
    """All per-call conditioning for the denoising UNet."""

    # {attn1 layer name: (k_ref, v_ref)}, each (B, S_layer, C_layer): garment
    # K/V, precomputed once per image
    ref_kv: Optional[KV] = None
    # scalar or (B,) garment-attention scale; the CFG batch uses [0, s]
    ref_scale: Scale = 1.0
    # {attn2 layer name: (k_ip, v_ip)}, each (B, num_tokens, C_layer): the
    # IP-Adapter face-token K/V, added to the cross-attention with ip_scale
    ip_kv: Optional[KV] = None
    ip_scale: Scale = 1.0
    # the ControlNet's 12 skip residuals (matching the UNet's skip list) and
    # its mid residual, added in the UNet's compute dtype
    down_block_residuals: Optional[Sequence[torch.Tensor]] = None
    mid_block_residual: Optional[torch.Tensor] = None
    # {attn2 layer name: (k_txt, v_txt)}: text K/V, constant across steps
    cross_kv: Optional[KV] = None
    # how ref_kv joins the self-attention: "parallel" (a second softmax over
    # the garment tokens, added with ref_scale; the shipped scheme) or
    # "concat" (the garment tokens appended to the key/value source under
    # one softmax; ref_kv then comes from the base to_k / to_v)
    ref_mode: str = "parallel"
    # {attn2 layer name: (k_ref, v_ref)}: a garment branch on the
    # cross-attention layers, added with ref_scale
    ref_cross_kv: Optional[KV] = None

    def __post_init__(self):
        if self.ref_mode not in ("parallel", "concat"):
            raise ValueError(f"ref_mode {self.ref_mode!r} (parallel | concat)")


LoraParams = Mapping[str, Mapping[str, torch.Tensor]]


@torch.no_grad()
def fold_lora(attn: nn.Module, lora_params: LoraParams,
              lora_scale: float) -> nn.Module:
    """Fold LoRA deltas into an attention module's projections, in place:
    W' = W + lora_scale * (up @ down) for each projection named in
    `lora_params` ("to_q" | "to_k" | "to_v" | "to_out"), whose entries are
    {"down": (rank, in), "up": (out, rank)} in the port's (out, in) layout
    (diffusers' LoRALinearLayer, network_alpha None: no rank rescale). The
    delta is cast to the weight's dtype before the scaled add, as the JAX
    package does. Returns `attn`."""
    for name, lp in lora_params.items():
        weight = getattr(attn, name).weight
        delta = (lp["up"] @ lp["down"]).to(device=weight.device,
                                           dtype=weight.dtype)
        weight.copy_(weight + lora_scale * delta)
    return attn
