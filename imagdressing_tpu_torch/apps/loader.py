"""Model-stack assembly from local checkpoint files (port of
`imagdressing_tpu/apps/loader.py`).

One loader for all presets. Expects an SD1.5-style checkpoint layout on
local disk:

  base_dir/
    unet/diffusion_pytorch_model.(bin|safetensors)      # main + garment arch
    text_encoder/pytorch_model.(bin|safetensors)
    tokenizer/{vocab.json, merges.txt}
  vae_path: sd-vae-ft-mse diffusion_pytorch_model.*
  image_encoder_path: CLIP ViT-H pytorch_model.*
  model_ckpt: IMAGDressing-v1_512.pt  (monolithic, key "module")
  controlnet_path (optional), ip_ckpt (optional)

Each file goes through `convert.torch_sd` to the JAX-layout tree, then
`convert.params_from_jax` to the port's state dicts, which
`DressingModels.from_state_dicts` copies into modules built without random
initialisation, in the requested dtype, on the requested device.

The orbax overlay of a trained checkpoint (the JAX package's
`restore_trained_params` / `merge_trained_checkpoint`) waits for the port's
training checkpoints (`train/checkpoint.py`, ROADMAP).
"""

from __future__ import annotations

import glob
import os
from typing import Any, Dict, Optional

import torch

from imagdressing_tpu_torch.convert import params_from_jax
from imagdressing_tpu_torch.convert import torch_sd as cv
from imagdressing_tpu_torch.core.config import (
    CLIPTextConfig,
    CLIPVisionConfig,
    ControlNetConfig,
    ProjPlusConfig,
    ResamplerConfig,
    UNetConfig,
    VAEConfig,
)
from imagdressing_tpu_torch.models.conditioning import fold_lora
from imagdressing_tpu_torch.models.resampler import Resampler
from imagdressing_tpu_torch.models.unet import (
    UNet,
    adapter_key,
    attn_layer_names,
)
from imagdressing_tpu_torch.ops.nn import init_module
from imagdressing_tpu_torch.pipelines.dressing import (
    Device,
    DressingModels,
    resolve_device,
)

TRAINED_CKPT_PENDING = (
    "--trained_ckpt (an orbax checkpoint of the JAX trainer) is not "
    "supported by the PyTorch port yet: it waits for the port's training "
    "checkpoints (train/checkpoint.py; ROADMAP Queue 1, training)")


def _find_weights(path: str) -> str:
    for pat in ("*.safetensors", "*.bin", "*.pt", "*.pth"):
        hits = sorted(glob.glob(os.path.join(path, pat)))
        if hits:
            return hits[0]
    if os.path.isfile(path):
        return path
    raise FileNotFoundError(f"no weight file under {path}")


def load_dressing_models(
    *,
    base_dir: str,
    vae_path: str,
    image_encoder_path: str,
    model_ckpt: Optional[str] = None,
    controlnet_path: Optional[str] = None,
    ip_ckpt: Optional[str] = None,
    lora_scale: float = 0.0,
    dtype: Optional[torch.dtype] = torch.bfloat16,
    device: Device = "cuda",
    unet_cfg: Optional[UNetConfig] = None,
    vae_cfg: Optional[VAEConfig] = None,
    text_cfg: Optional[CLIPTextConfig] = None,
    vision_cfg: Optional[CLIPVisionConfig] = None,
    resampler_cfg: Optional[ResamplerConfig] = None,
    projplus_cfg: Optional[ProjPlusConfig] = None,
) -> DressingModels:
    """The dressing stack from the reference's files, in `dtype` (None:
    fp32, as the JAX loader's dtype=None) on `device` (default the card;
    raises on a host without one unless device="cpu"). Configs default to
    the SD1.5 stack the reference ships; pass overrides for other bases
    (SD2-class dims, test-scale models, ...)."""
    dev = resolve_device(device)
    unet_cfg = unet_cfg or UNetConfig()
    configs = dict(unet_cfg=unet_cfg, vae_cfg=vae_cfg or VAEConfig(),
                   text_cfg=text_cfg or CLIPTextConfig(),
                   vision_cfg=vision_cfg or CLIPVisionConfig(),
                   resampler_cfg=resampler_cfg or ResamplerConfig(),
                   projplus_cfg=projplus_cfg or ProjPlusConfig())

    unet_sd = cv.load_torch_file(_find_weights(os.path.join(base_dir, "unet")))
    text_sd = cv.load_torch_file(
        _find_weights(os.path.join(base_dir, "text_encoder")))
    vae_sd = cv.load_torch_file(_find_weights(vae_path))
    vision_sd = cv.load_torch_file(_find_weights(image_encoder_path))

    unet_params = cv.convert_unet(unet_sd, unet_cfg)
    tree: Dict[str, Any] = {"unet": unet_params}
    if model_ckpt:
        split = cv.convert_imagdressing_checkpoint(
            cv.load_torch_file(model_ckpt)["module"], unet_cfg,
            configs["resampler_cfg"])
        tree.update(ref_unet=split["ref_unet"],
                    ref_adapters=split["ref_adapters"],
                    resampler=split["resampler"])
    tree.update(vae=cv.convert_vae(vae_sd, configs["vae_cfg"]),
                text=cv.convert_clip_text(text_sd, configs["text_cfg"]),
                vision=cv.convert_clip_vision(vision_sd,
                                              configs["vision_cfg"]))
    if controlnet_path:
        tree["controlnet"] = cv.convert_controlnet(
            cv.load_torch_file(_find_weights(controlnet_path)),
            ControlNetConfig(unet=unet_cfg))
    lora = None
    if ip_ckpt:
        ipa = cv.convert_ip_adapter_faceid(
            cv.load_torch_file(ip_ckpt), unet_cfg, configs["projplus_cfg"])
        tree.update(proj_plus=ipa["proj_plus"],
                    ip_adapters=ipa["ip_adapters"])
        lora = (ipa["lora_attn1"], ipa["lora_attn2"])

    state_dicts = params_from_jax(tree)
    if not model_ckpt:
        # training-from-scratch init (the reference's train.py): the garment
        # UNet a copy of the base, the adapters from the base attn1
        # to_k/to_v, the Resampler randomly initialised
        state_dicts["ref_unet"] = dict(state_dicts["unet"])
        state_dicts["ref_adapters"] = _ref_adapters_from_unet(
            state_dicts["unet"], unet_cfg)
        state_dicts["resampler"] = _random_resampler(
            configs["resampler_cfg"])
    # the faceid LoRA deltas are folded into the frozen projections once
    # (the reference applies them per call via its LoRA processors), in
    # fp32 before the cast, as the JAX loader does; without a fold the
    # stack is built in its final dtype
    fold = lora is not None and lora_scale > 0
    models = DressingModels.from_state_dicts(
        state_dicts, configs, device=dev,
        dtype=torch.float32 if fold or dtype is None else dtype)
    if fold:
        _fold_unet_lora(models.unet, *lora, lora_scale)
    if dtype is not None:
        models.cast(dtype)
    return models


def _ref_adapters_from_unet(unet_sd: Dict[str, torch.Tensor],
                            cfg: UNetConfig) -> Dict[str, torch.Tensor]:
    """The RefAdapters state dict whose to_k_ref / to_v_ref are copies of
    the UNet's attn1 to_k / to_v (`unet.init_ref_adapters_from_unet`)."""
    out = {}
    for name in attn_layer_names(cfg, "attn1"):
        attn1 = name[:-len(".processor")]
        for proj in ("k", "v"):
            out[f"{adapter_key(name)}.to_{proj}_ref.weight"] = \
                unet_sd[f"{attn1}.to_{proj}.weight"]
    return out


def _random_resampler(cfg: ResamplerConfig) -> Dict[str, torch.Tensor]:
    """A Resampler initialised from `torch.Generator().manual_seed(0)` (the
    JAX loader draws its own from `PRNGKey(0)`: other numbers)."""
    resampler = Resampler(cfg)
    init_module(resampler, torch.Generator().manual_seed(0))
    return resampler.state_dict()


@torch.no_grad()
def _fold_unet_lora(unet: UNet, lora_attn1: Dict[str, Any],
                    lora_attn2: Dict[str, Any], scale: float) -> None:
    """Fold the IP-Adapter-FaceID LoRA trees (per layer name, JAX layout:
    down (in, rank), up (rank, out)) into the UNet's attn1 / attn2
    projections in place, through `conditioning.fold_lora`, whose layout is
    the port's: down (rank, in), up (out, rank)."""
    for which, loras in (("attn1", lora_attn1), ("attn2", lora_attn2)):
        for name, lora in loras.items():
            port = {proj: {"down": torch.as_tensor(lp["down"]).float().T,
                           "up": torch.as_tensor(lp["up"]).float().T}
                    for proj, lp in lora.items()}
            attn = getattr(unet.attention_block(name), which)
            fold_lora(attn, port, scale)
