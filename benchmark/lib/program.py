"""The program under test, `imagdressing_tpu_torch`, as the benchmark drives
it: its configuration objects built from a configuration file, its modules'
parameter names and shapes (what the benchmark draws), the stack loaded
through its own `DressingModels.from_state_dicts`, and its pipeline.

Only this module, the traffic drivers and `run.py` import the program; the
reference imports nothing of it."""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch


def _fields(cls, values: dict):
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: tuple(v) if isinstance(v, list) else v
                  for k, v in values.items() if k in names})


def model_configs(config: dict) -> Dict[str, object]:
    """The program's `model_configs` dict for a configuration file."""
    from imagdressing_tpu_torch.core import config as pc

    out = dict(unet_cfg=_fields(pc.UNetConfig, config["unet"]),
               vae_cfg=_fields(pc.VAEConfig, config["vae"]),
               text_cfg=_fields(pc.CLIPTextConfig, config["text"]),
               vision_cfg=_fields(pc.CLIPVisionConfig, config["vision"]),
               resampler_cfg=_fields(pc.ResamplerConfig, config["resampler"]),
               projplus_cfg=pc.ProjPlusConfig())
    if config.get("controlnet"):
        cn = pc.ControlNetConfig(unet=out["unet_cfg"])
        stated = tuple(config["controlnet_cfg"]
                       ["conditioning_embedding_channels"])
        if cn.conditioning_embedding_channels != stated:
            raise ValueError(f"the program's ControlNet embeds through "
                             f"{cn.conditioning_embedding_channels}, the "
                             f"configuration states {stated}")
    return out


def state_shapes(config: dict) -> Dict[str, Dict[str, Tuple[int, ...]]]:
    """{model: {state-dict key: shape}} of the stack the program builds for
    `config` (built on the meta device: nothing is allocated)."""
    from imagdressing_tpu_torch.pipelines.dressing import DressingModels

    models = DressingModels._build(model_configs(config),
                                   torch.device("meta"),
                                   bool(config.get("controlnet")))
    return {name: {k: tuple(v.shape) for k, v in m.state_dict().items()}
            for name, m in models.modules().items()}


def pipeline(config: dict, state_dicts, device: str, dtype: torch.dtype):
    """The program's `DressingPipeline` for `config`, its models loaded from
    `state_dicts` by `DressingModels.from_state_dicts`."""
    from imagdressing_tpu_torch.core.config import PRESETS
    from imagdressing_tpu_torch.pipelines.dressing import (
        DressingModels,
        DressingPipeline,
    )

    models = DressingModels.from_state_dicts(
        state_dicts, model_configs(config), device=device, dtype=dtype)
    preset = dataclasses.replace(
        PRESETS[config["preset"]], height=config["height"],
        width=config["width"], guidance_scale=config["guidance_scale"],
        image_scale=config["image_scale"],
        controlnet_conditioning_scale=config.get(
            "controlnet_conditioning_scale", 1.0))
    return DressingPipeline(models, preset, device=device)


def kernel_counters():
    """The program's launch counters by shape: K1 (the inference flash
    forward), K2 (GroupNorm+SiLU+conv3x3) and K3 (GroupNorm)."""
    from imagdressing_tpu_torch.kernels import flash_attention as fa
    from imagdressing_tpu_torch.kernels import fused_gn_conv as fgc
    from imagdressing_tpu_torch.kernels import fused_groupnorm as fg

    return {"flash": fa.COUNTER, "gn_conv": fgc.COUNTER, "group_norm": fg.COUNTER}


def build_kernels(device: str) -> None:
    """Build (or load from the checkout's build directory) every CUDA
    source of the program, all at once."""
    if device == "cuda":
        from imagdressing_tpu_torch.kernels import _build

        _build.build()
