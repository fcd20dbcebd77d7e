"""The inverse converters: JAX-layout parameter trees -> the reference's
checkpoint names (port of `imagdressing_tpu/convert/export_torch.py`, plus
the models that file does not cover).

`export_unet`, `export_resampler`, `export_imagdressing_module` and
`save_checkpoint` are the JAX package's: the monolithic `.pt` format
`{"module": {ref_unet.*, unet.*, proj.*, adapter_modules.{idx}.*}}` that the
reference's DeepSpeed save produces and its inference scripts prefix-split.
`export_vae`, `export_clip_text`, `export_clip_vision`, `export_controlnet`,
`export_proj_plus` and `export_ip_adapter_faceid` invert the other
converters of `convert/torch_sd.py` (diffusers, transformers and the
IP-Adapter-FaceID bin), so that `tools/write_checkpoints.py` can write a
whole stack in the reference's files. Each is the exact inverse of its
converter: `convert_x(export_x(tree)) == tree` leaf for leaf.

A tree's leaves are numpy arrays (exported as fp32, as the JAX package
does) or torch tensors (exported in their own dtype, so a bf16 stack
writes bf16 files).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from imagdressing_tpu_torch.convert.torch_sd import (
    adapter_module_index_map,
    transpose,
)
from imagdressing_tpu_torch.core.config import UNetConfig

StateDict = Dict[str, Any]


def _arr(a):
    """A leaf as written: a torch tensor on the CPU in its own dtype, else
    fp32 numpy (the JAX copy's `_np32`)."""
    if torch.is_tensor(a):
        return a.detach().to("cpu")
    return np.asarray(a, dtype=np.float32)


def _set_linear(sd: StateDict, prefix: str, p: Dict) -> None:
    sd[f"{prefix}.weight"] = _arr(p["kernel"]).T
    if "bias" in p:
        sd[f"{prefix}.bias"] = _arr(p["bias"])


def _set_conv(sd: StateDict, prefix: str, p: Dict) -> None:
    sd[f"{prefix}.weight"] = transpose(_arr(p["kernel"]), (3, 2, 0, 1))
    if "bias" in p:
        sd[f"{prefix}.bias"] = _arr(p["bias"])


def _set_norm(sd: StateDict, prefix: str, p: Dict) -> None:
    sd[f"{prefix}.weight"] = _arr(p["scale"])
    sd[f"{prefix}.bias"] = _arr(p["bias"])


def _set_attention(sd: StateDict, prefix: str, p: Dict) -> None:
    _set_linear(sd, f"{prefix}.to_q", p["to_q"])
    _set_linear(sd, f"{prefix}.to_k", p["to_k"])
    _set_linear(sd, f"{prefix}.to_v", p["to_v"])
    _set_linear(sd, f"{prefix}.to_out.0", p["to_out"])


def _set_transformer_block(sd: StateDict, prefix: str, p: Dict) -> None:
    _set_norm(sd, f"{prefix}.norm1", p["norm1"])
    _set_attention(sd, f"{prefix}.attn1", p["attn1"])
    _set_norm(sd, f"{prefix}.norm2", p["norm2"])
    _set_attention(sd, f"{prefix}.attn2", p["attn2"])
    _set_norm(sd, f"{prefix}.norm3", p["norm3"])
    _set_linear(sd, f"{prefix}.ff.net.0.proj", p["ff"]["proj"])
    _set_linear(sd, f"{prefix}.ff.net.2", p["ff"]["out"])


def _set_transformer2d(sd: StateDict, prefix: str, p: Dict) -> None:
    _set_norm(sd, f"{prefix}.norm", p["norm"])
    _set_linear(sd, f"{prefix}.proj_in", p["proj_in"])
    for i, blk in enumerate(p["transformer_blocks"]):
        _set_transformer_block(sd, f"{prefix}.transformer_blocks.{i}", blk)
    _set_linear(sd, f"{prefix}.proj_out", p["proj_out"])


def _set_resnet(sd: StateDict, prefix: str, p: Dict) -> None:
    _set_norm(sd, f"{prefix}.norm1", p["norm1"])
    _set_conv(sd, f"{prefix}.conv1", p["conv1"])
    _set_norm(sd, f"{prefix}.norm2", p["norm2"])
    _set_conv(sd, f"{prefix}.conv2", p["conv2"])
    if "time_emb_proj" in p:
        _set_linear(sd, f"{prefix}.time_emb_proj", p["time_emb_proj"])
    if "conv_shortcut" in p:
        _set_conv(sd, f"{prefix}.conv_shortcut", p["conv_shortcut"])


def _set_blocks(sd: StateDict, prefix: str, blocks, sampler: str) -> None:
    """Down or up blocks: resnets, attentions (absent or empty where the
    level has none) and the down- or upsampler."""
    for i, block in enumerate(blocks):
        for j, r in enumerate(block["resnets"]):
            _set_resnet(sd, f"{prefix}.{i}.resnets.{j}", r)
        for j, a in enumerate(block.get("attentions", [])):
            _set_transformer2d(sd, f"{prefix}.{i}.attentions.{j}", a)
        for j, s in enumerate(block.get(sampler, [])):
            _set_conv(sd, f"{prefix}.{i}.{sampler}.{j}.conv", s["conv"])


def _set_trunk(sd: StateDict, params: Dict[str, Any]) -> None:
    """conv_in, the time embedding, the down and the mid blocks: the part of
    the UNet the ControlNet shares."""
    _set_conv(sd, "conv_in", params["conv_in"])
    for name in ("linear_1", "linear_2"):
        _set_linear(sd, f"time_embedding.{name}",
                    params["time_embedding"][name])
    _set_blocks(sd, "down_blocks", params["down_blocks"], "downsamplers")
    for j, r in enumerate(params["mid_block"]["resnets"]):
        _set_resnet(sd, f"mid_block.resnets.{j}", r)
    for j, a in enumerate(params["mid_block"]["attentions"]):
        _set_transformer2d(sd, f"mid_block.attentions.{j}", a)


def export_unet(params: Dict[str, Any]) -> StateDict:
    """UNet tree -> diffusers UNet2DConditionModel names (the inverse of
    `torch_sd.convert_unet`)."""
    sd: StateDict = {}
    _set_trunk(sd, params)
    _set_blocks(sd, "up_blocks", params["up_blocks"], "upsamplers")
    _set_norm(sd, "conv_norm_out", params["conv_norm_out"])
    _set_conv(sd, "conv_out", params["conv_out"])
    return sd


def _set_perceiver_layer(sd: StateDict, prefix: str, layer: Dict) -> None:
    attn, ff = layer["attn"], layer["ff"]
    _set_norm(sd, f"{prefix}.0.norm1", attn["norm1"])
    _set_norm(sd, f"{prefix}.0.norm2", attn["norm2"])
    _set_linear(sd, f"{prefix}.0.to_q", attn["to_q"])
    _set_linear(sd, f"{prefix}.0.to_kv", attn["to_kv"])
    _set_linear(sd, f"{prefix}.0.to_out", attn["to_out"])
    _set_norm(sd, f"{prefix}.1.0", ff["norm"])
    _set_linear(sd, f"{prefix}.1.1", ff["fc1"])
    _set_linear(sd, f"{prefix}.1.3", ff["fc2"])


def export_resampler(params: Dict[str, Any]) -> StateDict:
    """Resampler tree -> the reference Resampler's names (the inverse of
    `torch_sd.convert_resampler`)."""
    sd: StateDict = {"latents": _arr(params["latents"])}
    _set_linear(sd, "proj_in", params["proj_in"])
    for i, layer in enumerate(params["layers"]):
        _set_perceiver_layer(sd, f"layers.{i}", layer)
    _set_linear(sd, "proj_out", params["proj_out"])
    _set_norm(sd, "norm_out", params["norm_out"])
    return sd


def export_imagdressing_module(
    params: Dict[str, Any],
    unet_cfg: Optional[UNetConfig] = None,
) -> StateDict:
    """Trainable params {ref_unet, ref_adapters, resampler} (+ optional
    frozen `unet`) -> the flat `"module"` dict of the reference checkpoint.

    adapter_modules uses the interleaved attn1/attn2 index order of
    diffusers' attn_processors (`adapter_module_index_map`); odd (CAttn)
    indices are paramless and emit nothing, as in the reference.
    """
    unet_cfg = unet_cfg or UNetConfig()
    module: StateDict = {}
    for k, v in export_unet(params["ref_unet"]).items():
        module[f"ref_unet.{k}"] = v
    if "unet" in params:
        for k, v in export_unet(params["unet"]).items():
            module[f"unet.{k}"] = v
    for k, v in export_resampler(params["resampler"]).items():
        module[f"proj.{k}"] = v
    adapters = params["ref_adapters"]
    for idx, name in adapter_module_index_map(unet_cfg):
        if name in adapters:
            for proj in ("to_k_ref", "to_v_ref"):
                module[f"adapter_modules.{idx}.{proj}.weight"] = _arr(
                    adapters[name][proj]["kernel"]).T
    return module


def _torch(v) -> torch.Tensor:
    if torch.is_tensor(v):
        return v.contiguous()
    return torch.from_numpy(np.ascontiguousarray(v))


def torch_state_dict(sd: StateDict) -> Dict[str, torch.Tensor]:
    """A state dict of numpy / torch leaves -> contiguous torch tensors."""
    return {k: _torch(v) for k, v in sd.items()}


def save_checkpoint(path: str, module: StateDict) -> None:
    """Serialize `{"module": ...}` as a torch `.pt` the reference stack
    loads directly (torch.load -> ["module"] -> prefix split)."""
    torch.save({"module": torch_state_dict(module)}, path)


# ---------------------------------------------------------------------------
# The models the JAX package's exporter does not cover
# ---------------------------------------------------------------------------


def _set_vae_mid(sd: StateDict, prefix: str, p: Dict) -> None:
    for j, r in enumerate(p["resnets"]):
        _set_resnet(sd, f"{prefix}.resnets.{j}", r)
    a = p["attentions"][0]
    _set_norm(sd, f"{prefix}.attentions.0.group_norm", a["group_norm"])
    for key, name in (("to_q", "to_q"), ("to_k", "to_k"), ("to_v", "to_v"),
                      ("to_out", "to_out.0")):
        _set_linear(sd, f"{prefix}.attentions.0.{name}", a[key])


def export_vae(params: Dict[str, Any]) -> StateDict:
    """VAE tree -> diffusers AutoencoderKL names (the modern to_q / to_k /
    to_v / to_out.0 attention; the inverse of `torch_sd.convert_vae`)."""
    sd: StateDict = {}
    for part, blocks, sampler in (("encoder", "down_blocks", "downsamplers"),
                                  ("decoder", "up_blocks", "upsamplers")):
        p = params[part]
        _set_conv(sd, f"{part}.conv_in", p["conv_in"])
        _set_blocks(sd, f"{part}.{blocks}", p[blocks], sampler)
        _set_vae_mid(sd, f"{part}.mid_block", p["mid_block"])
        _set_norm(sd, f"{part}.conv_norm_out", p["conv_norm_out"])
        _set_conv(sd, f"{part}.conv_out", p["conv_out"])
    _set_conv(sd, "quant_conv", params["quant_conv"])
    _set_conv(sd, "post_quant_conv", params["post_quant_conv"])
    return sd


def _set_clip_layers(sd: StateDict, prefix: str, layers) -> None:
    for i, p in enumerate(layers):
        pre = f"{prefix}.encoder.layers.{i}"
        _set_norm(sd, f"{pre}.layer_norm1", p["layer_norm1"])
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _set_linear(sd, f"{pre}.self_attn.{proj}", p["self_attn"][proj])
        _set_norm(sd, f"{pre}.layer_norm2", p["layer_norm2"])
        _set_linear(sd, f"{pre}.mlp.fc1", p["mlp"]["fc1"])
        _set_linear(sd, f"{pre}.mlp.fc2", p["mlp"]["fc2"])


def export_clip_text(params: Dict[str, Any]) -> StateDict:
    """CLIP text tree -> transformers CLIPTextModel names (the inverse of
    `torch_sd.convert_clip_text`)."""
    pre = "text_model"
    sd: StateDict = {
        f"{pre}.embeddings.token_embedding.weight":
            _arr(params["token_embedding"]["embedding"]),
        f"{pre}.embeddings.position_embedding.weight":
            _arr(params["position_embedding"]["embedding"]),
    }
    _set_clip_layers(sd, pre, params["layers"])
    _set_norm(sd, f"{pre}.final_layer_norm", params["final_layer_norm"])
    return sd


def export_clip_vision(params: Dict[str, Any]) -> StateDict:
    """CLIP vision tree -> transformers CLIPVisionModelWithProjection names
    (the inverse of `torch_sd.convert_clip_vision`)."""
    pre = "vision_model"
    sd: StateDict = {
        f"{pre}.embeddings.class_embedding": _arr(params["class_embedding"]),
        f"{pre}.embeddings.patch_embedding.weight": transpose(
            _arr(params["patch_embedding"]["kernel"]), (3, 2, 0, 1)),
        f"{pre}.embeddings.position_embedding.weight":
            _arr(params["position_embedding"]["embedding"]),
    }
    _set_norm(sd, f"{pre}.pre_layrnorm", params["pre_layrnorm"])
    _set_clip_layers(sd, pre, params["layers"])
    _set_norm(sd, f"{pre}.post_layernorm", params["post_layernorm"])
    if "visual_projection" in params:
        sd["visual_projection.weight"] = _arr(
            params["visual_projection"]["kernel"]).T
    return sd


def export_controlnet(params: Dict[str, Any]) -> StateDict:
    """ControlNet tree -> diffusers ControlNetModel names (the inverse of
    `torch_sd.convert_controlnet`)."""
    sd: StateDict = {}
    _set_trunk(sd, params)
    ce = params["controlnet_cond_embedding"]
    _set_conv(sd, "controlnet_cond_embedding.conv_in", ce["conv_in"])
    for i, blk in enumerate(ce["blocks"]):
        _set_conv(sd, f"controlnet_cond_embedding.blocks.{i}", blk)
    _set_conv(sd, "controlnet_cond_embedding.conv_out", ce["conv_out"])
    for i, p in enumerate(params["controlnet_down_blocks"]):
        _set_conv(sd, f"controlnet_down_blocks.{i}", p)
    _set_conv(sd, "controlnet_mid_block", params["controlnet_mid_block"])
    return sd


def export_proj_plus(params: Dict[str, Any]) -> StateDict:
    """ProjPlus tree -> ProjPlusModel names (the inverse of
    `torch_sd.convert_proj_plus`)."""
    sd: StateDict = {}
    _set_linear(sd, "proj.0", params["proj"]["fc1"])
    _set_linear(sd, "proj.2", params["proj"]["fc2"])
    _set_norm(sd, "norm", params["norm"])
    pr = params["perceiver_resampler"]
    _set_linear(sd, "perceiver_resampler.proj_in", pr["proj_in"])
    for i, layer in enumerate(pr["layers"]):
        _set_perceiver_layer(sd, f"perceiver_resampler.layers.{i}", layer)
    _set_linear(sd, "perceiver_resampler.proj_out", pr["proj_out"])
    _set_norm(sd, "perceiver_resampler.norm_out", pr["norm_out"])
    return sd


def export_ip_adapter_faceid(
    proj_plus: Dict[str, Any],
    ip_adapters: Dict[str, Any],
    unet_cfg: Optional[UNetConfig] = None,
    lora_attn1: Optional[Dict[str, Any]] = None,
    lora_attn2: Optional[Dict[str, Any]] = None,
) -> Dict[str, StateDict]:
    """{proj_plus, ip_adapters keyed by attn2 layer name, LoRA trees keyed
    by layer name (JAX layout: down (in, rank), up (rank, out))} -> the
    IP-Adapter-FaceID bin's {"image_proj": ..., "ip_adapter": ...} (the
    inverse of `torch_sd.convert_ip_adapter_faceid`)."""
    unet_cfg = unet_cfg or UNetConfig()
    ip: StateDict = {}
    loras = {**(lora_attn1 or {}), **(lora_attn2 or {})}
    for idx, name in adapter_module_index_map(unet_cfg):
        if name in ip_adapters:
            for proj in ("to_k_ip", "to_v_ip"):
                ip[f"{idx}.{proj}.weight"] = _arr(
                    ip_adapters[name][proj]["kernel"]).T
        for proj, lp in loras.get(name, {}).items():
            ip[f"{idx}.{proj}_lora.down.weight"] = _arr(lp["down"]).T
            ip[f"{idx}.{proj}_lora.up.weight"] = _arr(lp["up"]).T
    return {"image_proj": export_proj_plus(proj_plus), "ip_adapter": ip}
