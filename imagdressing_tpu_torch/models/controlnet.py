"""SD1.5 ControlNet (the openpose and inpaint variants), NHWC (port of
`imagdressing_tpu/models/controlnet.py`).

The trunk is the UNet's encoder half: `ControlNet` is a `UNet` built with
`encoder_only=True` (conv_in, the time embedding, the down and mid blocks;
no up blocks) and runs through `UNet.forward(..., down_only=True)`, so its
resnets run K2, its transformer in-norms K3 and its self-attention K1, as
the main UNet's do. The conditioning embedding (eight pixel-level convs)
stays cuDNN convs: the JAX package runs it through XLA, not Pallas.

Outputs: 12 down residuals (one per UNet skip) and the mid residual, each
a zero-initialised 1x1 conv of the trunk's activation times
`conditioning_scale`. Module attributes follow the JAX tree:
`controlnet_cond_embedding.{conv_in,blocks.i,conv_out}`,
`controlnet_down_blocks.i`, `controlnet_mid_block`.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from imagdressing_tpu_torch.core.config import ControlNetConfig
from imagdressing_tpu_torch.models.conditioning import Conditioning
from imagdressing_tpu_torch.models.unet import UNet, skip_channels
from imagdressing_tpu_torch.ops.nn import Conv2d

Residuals = Tuple[Tuple[torch.Tensor, ...], torch.Tensor]


class CondEmbedding(nn.Module):
    """diffusers' ControlNetConditioningEmbedding: conv_in, then per
    channel pair a conv and a stride-2 conv, SiLU after each, and a
    zero-initialised conv_out to the trunk's width."""

    def __init__(self, cin: int, chs: Tuple[int, ...], cout: int):
        super().__init__()
        self.conv_in = Conv2d(cin, chs[0], 3, padding=1)
        self.blocks = nn.ModuleList()
        for i in range(len(chs) - 1):
            self.blocks.append(Conv2d(chs[i], chs[i], 3, padding=1))
            self.blocks.append(Conv2d(chs[i], chs[i + 1], 3, stride=2,
                                      padding=1))
        self.conv_out = Conv2d(chs[-1], cout, 3, padding=1)

    def forward(self, cond_image: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) condition image -> (B, H/f, W/f, C0)."""
        h = F.silu(self.conv_in(cond_image))
        for conv in self.blocks:
            h = F.silu(conv(h))
        return self.conv_out(h)


class ControlNet(UNet):
    def __init__(self, cfg: ControlNetConfig):
        super().__init__(cfg.unet, encoder_only=True)
        self.controlnet_cfg = cfg
        chs = cfg.unet.block_out_channels
        self.controlnet_cond_embedding = CondEmbedding(
            cfg.conditioning_channels, cfg.conditioning_embedding_channels,
            chs[0])
        self.controlnet_down_blocks = nn.ModuleList(
            [Conv2d(c, c, 1) for c in skip_channels(cfg.unet)])
        self.controlnet_mid_block = Conv2d(chs[-1], chs[-1], 1)

    def reset_parameters(self, gen: torch.Generator) -> None:
        """The output convs start at zero (the ControlNet paper): a fresh
        ControlNet adds exactly nothing. Runs after the children's init."""
        del gen
        zero = [self.controlnet_cond_embedding.conv_out,
                self.controlnet_mid_block, *self.controlnet_down_blocks]
        with torch.no_grad():
            for conv in zero:
                conv.weight.zero_()
                conv.bias.zero_()

    def cond_embedding(self, cond_image: torch.Tensor) -> torch.Tensor:
        """The timestep-invariant conditioning embedding, computed once
        before the sampling loop (`precompute_cond_embedding` in the JAX
        package), in the weights' dtype."""
        w = self.controlnet_cond_embedding.conv_in.weight
        return self.controlnet_cond_embedding(cond_image.to(w.dtype))

    def forward(self, sample: torch.Tensor,
                timesteps: Union[int, torch.Tensor],
                encoder_hidden_states: torch.Tensor, *,
                cond_emb: torch.Tensor,
                conditioning_scale: Union[float, torch.Tensor] = 1.0,
                cond: Optional[Conditioning] = None) -> Residuals:
        """-> (12 down residuals, mid residual), each times
        `conditioning_scale`. `cond` may carry the text K/V (`cross_kv`),
        hoisted out of the loop as the main UNet's are."""
        skips, mid, _ = super().forward(
            sample, timesteps, encoder_hidden_states, cond, down_only=True,
            conv_in_extra=cond_emb)
        down = tuple(conv(s) * conditioning_scale
                     for conv, s in zip(self.controlnet_down_blocks, skips))
        return down, self.controlnet_mid_block(mid) * conditioning_scale
