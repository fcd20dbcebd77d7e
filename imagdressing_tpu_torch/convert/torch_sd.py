"""Reference checkpoint files -> the JAX-layout parameter tree (port of
`imagdressing_tpu/convert/torch_sd.py`).

Handles every artifact the reference stack loads:
  * diffusers UNet2DConditionModel / AutoencoderKL / ControlNetModel
  * transformers CLIPTextModel / CLIPVisionModelWithProjection
  * the monolithic IMAGDressing-v1_512.pt with top-level key "module" and
    prefixes ref_unet. / unet. / proj. / adapter_modules.
  * ip-adapter-faceid-plusv2_sd15.bin with "image_proj" / "ip_adapter" dicts

Each converter returns the JAX package's tree (nested dicts and lists,
linear kernels (in, out), conv kernels HWIO, norms `scale`, embeddings
`embedding`), which `convert.params_from_jax` maps onto the port's modules:
one mapping for both packages. The one difference from the JAX copy is the
leaf type: a torch tensor from a file stays a torch tensor in the file's
dtype (a transposed view, no copy), where JAX converts it to fp32 numpy.
The values are the same; a bf16 checkpoint is not widened on the host.

Quirk parity: the reference builds `unet_dict` from the checkpoint but never
loads it into the main UNet (the main UNet keeps the base SD weights).
`convert_imagdressing_checkpoint` reproduces that by default
(load_main_unet=False).

`.safetensors` files are read by the port's own reader (`read_safetensors`,
so that the port needs no safetensors package) and written by
`write_safetensors`; `.bin` / `.pt` / `.pth` go through `torch.load`.
"""

from __future__ import annotations

import json
import math
import os
import struct
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from imagdressing_tpu_torch.core.config import (
    CLIPTextConfig,
    CLIPVisionConfig,
    ControlNetConfig,
    ProjPlusConfig,
    ResamplerConfig,
    UNetConfig,
    VAEConfig,
)
from imagdressing_tpu_torch.models.unet import attn_layer_names


def _np(t):
    """A leaf as read: numpy stays numpy, a torch tensor is detached on the
    CPU in its own dtype."""
    if isinstance(t, np.ndarray):
        return t
    return t.detach().to("cpu")


def transpose(w, axes):
    """`np.transpose` of a numpy array or a torch tensor."""
    return w.permute(*axes) if torch.is_tensor(w) else np.transpose(w, axes)


def _linear(sd: Dict, prefix: str, bias: bool = True) -> Dict[str, Any]:
    p = {"kernel": _np(sd[f"{prefix}.weight"]).T}
    if bias and f"{prefix}.bias" in sd:
        p["bias"] = _np(sd[f"{prefix}.bias"])
    return p


def _conv(sd: Dict, prefix: str) -> Dict[str, Any]:
    w = _np(sd[f"{prefix}.weight"])
    p = {"kernel": transpose(w, (2, 3, 1, 0))}  # OIHW -> HWIO
    if f"{prefix}.bias" in sd:
        p["bias"] = _np(sd[f"{prefix}.bias"])
    return p


def _conv1x1_as_linear(sd: Dict, prefix: str) -> Dict[str, Any]:
    """1x1 conv (or Linear in newer diffusers) -> linear kernel (in,out)."""
    w = _np(sd[f"{prefix}.weight"])
    if w.ndim == 4:
        w = w[:, :, 0, 0]
    p = {"kernel": w.T}
    if f"{prefix}.bias" in sd:
        p["bias"] = _np(sd[f"{prefix}.bias"])
    return p


def _norm(sd: Dict, prefix: str) -> Dict[str, Any]:
    return {"scale": _np(sd[f"{prefix}.weight"]),
            "bias": _np(sd[f"{prefix}.bias"])}


def _attention(sd: Dict, prefix: str) -> Dict[str, Any]:
    return {
        "to_q": _conv1x1_as_linear(sd, f"{prefix}.to_q"),
        "to_k": _conv1x1_as_linear(sd, f"{prefix}.to_k"),
        "to_v": _conv1x1_as_linear(sd, f"{prefix}.to_v"),
        "to_out": _conv1x1_as_linear(sd, f"{prefix}.to_out.0"),
    }


def _transformer_block(sd: Dict, prefix: str) -> Dict[str, Any]:
    return {
        "norm1": _norm(sd, f"{prefix}.norm1"),
        "attn1": _attention(sd, f"{prefix}.attn1"),
        "norm2": _norm(sd, f"{prefix}.norm2"),
        "attn2": _attention(sd, f"{prefix}.attn2"),
        "norm3": _norm(sd, f"{prefix}.norm3"),
        "ff": {
            "proj": _linear(sd, f"{prefix}.ff.net.0.proj"),
            "out": _linear(sd, f"{prefix}.ff.net.2"),
        },
    }


def _transformer2d(sd: Dict, prefix: str, n_layers: int) -> Dict[str, Any]:
    return {
        "norm": _norm(sd, f"{prefix}.norm"),
        "proj_in": _conv1x1_as_linear(sd, f"{prefix}.proj_in"),
        "transformer_blocks": [
            _transformer_block(sd, f"{prefix}.transformer_blocks.{i}")
            for i in range(n_layers)
        ],
        "proj_out": _conv1x1_as_linear(sd, f"{prefix}.proj_out"),
    }


def _resnet(sd: Dict, prefix: str, time_emb: bool = True) -> Dict[str, Any]:
    p = {
        "norm1": _norm(sd, f"{prefix}.norm1"),
        "conv1": _conv(sd, f"{prefix}.conv1"),
        "norm2": _norm(sd, f"{prefix}.norm2"),
        "conv2": _conv(sd, f"{prefix}.conv2"),
    }
    if time_emb and f"{prefix}.time_emb_proj.weight" in sd:
        p["time_emb_proj"] = _linear(sd, f"{prefix}.time_emb_proj")
    if f"{prefix}.conv_shortcut.weight" in sd:
        p["conv_shortcut"] = _conv(sd, f"{prefix}.conv_shortcut")
    return p


def _down_blocks(sd: Dict, cfg: UNetConfig) -> List[Dict[str, Any]]:
    blocks = []
    tl = cfg.transformer_layers_per_block
    for i in range(len(cfg.block_out_channels)):
        block: Dict[str, Any] = {"resnets": [], "attentions": []}
        for j in range(cfg.layers_per_block):
            block["resnets"].append(_resnet(sd, f"down_blocks.{i}.resnets.{j}"))
            if cfg.down_block_has_attn[i]:
                block["attentions"].append(
                    _transformer2d(sd, f"down_blocks.{i}.attentions.{j}", tl))
        if f"down_blocks.{i}.downsamplers.0.conv.weight" in sd:
            block["downsamplers"] = [
                {"conv": _conv(sd, f"down_blocks.{i}.downsamplers.0.conv")}]
        blocks.append(block)
    return blocks


def _mid_block(sd: Dict, cfg: UNetConfig) -> Dict[str, Any]:
    return {
        "resnets": [_resnet(sd, "mid_block.resnets.0"),
                    _resnet(sd, "mid_block.resnets.1")],
        "attentions": [_transformer2d(sd, "mid_block.attentions.0",
                                      cfg.transformer_layers_per_block)],
    }


def _time_embedding(sd: Dict) -> Dict[str, Any]:
    return {"linear_1": _linear(sd, "time_embedding.linear_1"),
            "linear_2": _linear(sd, "time_embedding.linear_2")}


# ---------------------------------------------------------------------------
# UNet
# ---------------------------------------------------------------------------


def convert_unet(sd: Dict, cfg: UNetConfig = UNetConfig()) -> Dict[str, Any]:
    params: Dict[str, Any] = {
        "conv_in": _conv(sd, "conv_in"),
        "time_embedding": _time_embedding(sd),
        "down_blocks": _down_blocks(sd, cfg),
        "mid_block": _mid_block(sd, cfg),
        "up_blocks": [],
    }
    tl = cfg.transformer_layers_per_block
    for i in range(len(cfg.block_out_channels)):
        block: Dict[str, Any] = {"resnets": [], "attentions": []}
        for j in range(cfg.layers_per_block + 1):
            block["resnets"].append(_resnet(sd, f"up_blocks.{i}.resnets.{j}"))
            if cfg.up_block_has_attn[i]:
                block["attentions"].append(
                    _transformer2d(sd, f"up_blocks.{i}.attentions.{j}", tl))
        if f"up_blocks.{i}.upsamplers.0.conv.weight" in sd:
            block["upsamplers"] = [
                {"conv": _conv(sd, f"up_blocks.{i}.upsamplers.0.conv")}]
        params["up_blocks"].append(block)
    params["conv_norm_out"] = _norm(sd, "conv_norm_out")
    params["conv_out"] = _conv(sd, "conv_out")
    return params


# ---------------------------------------------------------------------------
# VAE
# ---------------------------------------------------------------------------


def _vae_attention(sd: Dict, prefix: str) -> Dict[str, Any]:
    # modern diffusers: to_q/to_k/to_v/to_out.0; legacy: query/key/value/proj_attn
    names = (("to_q", "to_k", "to_v", "to_out.0")
             if f"{prefix}.to_q.weight" in sd
             else ("query", "key", "value", "proj_attn"))
    out = {"group_norm": _norm(sd, f"{prefix}.group_norm")}
    for key, name in zip(("to_q", "to_k", "to_v", "to_out"), names):
        out[key] = _conv1x1_as_linear(sd, f"{prefix}.{name}")
    return out


def _vae_mid(sd: Dict, prefix: str) -> Dict[str, Any]:
    return {
        "resnets": [_resnet(sd, f"{prefix}.resnets.0", time_emb=False),
                    _resnet(sd, f"{prefix}.resnets.1", time_emb=False)],
        "attentions": [_vae_attention(sd, f"{prefix}.attentions.0")],
    }


def convert_vae(sd: Dict, cfg: VAEConfig = VAEConfig()) -> Dict[str, Any]:
    n = len(cfg.block_out_channels)
    enc: Dict[str, Any] = {
        "conv_in": _conv(sd, "encoder.conv_in"),
        "down_blocks": [],
        "mid_block": _vae_mid(sd, "encoder.mid_block"),
        "conv_norm_out": _norm(sd, "encoder.conv_norm_out"),
        "conv_out": _conv(sd, "encoder.conv_out"),
    }
    for i in range(n):
        pre = f"encoder.down_blocks.{i}"
        block = {"resnets": [_resnet(sd, f"{pre}.resnets.{j}", time_emb=False)
                             for j in range(cfg.layers_per_block)]}
        if f"{pre}.downsamplers.0.conv.weight" in sd:
            block["downsamplers"] = [
                {"conv": _conv(sd, f"{pre}.downsamplers.0.conv")}]
        enc["down_blocks"].append(block)

    dec: Dict[str, Any] = {
        "conv_in": _conv(sd, "decoder.conv_in"),
        "mid_block": _vae_mid(sd, "decoder.mid_block"),
        "conv_norm_out": _norm(sd, "decoder.conv_norm_out"),
        "conv_out": _conv(sd, "decoder.conv_out"),
        "up_blocks": [],
    }
    for i in range(n):
        pre = f"decoder.up_blocks.{i}"
        block = {"resnets": [_resnet(sd, f"{pre}.resnets.{j}", time_emb=False)
                             for j in range(cfg.layers_per_block + 1)]}
        if f"{pre}.upsamplers.0.conv.weight" in sd:
            block["upsamplers"] = [
                {"conv": _conv(sd, f"{pre}.upsamplers.0.conv")}]
        dec["up_blocks"].append(block)

    return {
        "encoder": enc,
        "decoder": dec,
        "quant_conv": _conv(sd, "quant_conv"),
        "post_quant_conv": _conv(sd, "post_quant_conv"),
    }


# ---------------------------------------------------------------------------
# CLIP
# ---------------------------------------------------------------------------


def _clip_layer(sd: Dict, prefix: str) -> Dict[str, Any]:
    return {
        "layer_norm1": _norm(sd, f"{prefix}.layer_norm1"),
        "self_attn": {
            "q_proj": _linear(sd, f"{prefix}.self_attn.q_proj"),
            "k_proj": _linear(sd, f"{prefix}.self_attn.k_proj"),
            "v_proj": _linear(sd, f"{prefix}.self_attn.v_proj"),
            "out_proj": _linear(sd, f"{prefix}.self_attn.out_proj"),
        },
        "layer_norm2": _norm(sd, f"{prefix}.layer_norm2"),
        "mlp": {
            "fc1": _linear(sd, f"{prefix}.mlp.fc1"),
            "fc2": _linear(sd, f"{prefix}.mlp.fc2"),
        },
    }


def convert_clip_text(sd: Dict, cfg: CLIPTextConfig = CLIPTextConfig()
                      ) -> Dict[str, Any]:
    pre = "text_model."
    return {
        "token_embedding": {
            "embedding": _np(sd[f"{pre}embeddings.token_embedding.weight"])},
        "position_embedding": {
            "embedding": _np(sd[f"{pre}embeddings.position_embedding.weight"])},
        "layers": [_clip_layer(sd, f"{pre}encoder.layers.{i}")
                   for i in range(cfg.num_layers)],
        "final_layer_norm": _norm(sd, f"{pre}final_layer_norm"),
    }


def convert_clip_vision(sd: Dict, cfg: CLIPVisionConfig = CLIPVisionConfig()
                        ) -> Dict[str, Any]:
    pre = "vision_model."
    w = _np(sd[f"{pre}embeddings.patch_embedding.weight"])  # (O,3,14,14)
    params = {
        "class_embedding": _np(sd[f"{pre}embeddings.class_embedding"]),
        "patch_embedding": {"kernel": transpose(w, (2, 3, 1, 0))},
        "position_embedding": {
            "embedding": _np(sd[f"{pre}embeddings.position_embedding.weight"])},
        "pre_layrnorm": _norm(sd, f"{pre}pre_layrnorm"),
        "layers": [_clip_layer(sd, f"{pre}encoder.layers.{i}")
                   for i in range(cfg.num_layers)],
        "post_layernorm": _norm(sd, f"{pre}post_layernorm"),
    }
    if "visual_projection.weight" in sd:
        params["visual_projection"] = {
            "kernel": _np(sd["visual_projection.weight"]).T}
    return params


# ---------------------------------------------------------------------------
# ControlNet
# ---------------------------------------------------------------------------


def convert_controlnet(sd: Dict, cfg: ControlNetConfig = ControlNetConfig()
                       ) -> Dict[str, Any]:
    ucfg = cfg.unet
    trunk: Dict[str, Any] = {
        "conv_in": _conv(sd, "conv_in"),
        "time_embedding": _time_embedding(sd),
        "down_blocks": _down_blocks(sd, ucfg),
        "mid_block": _mid_block(sd, ucfg),
    }
    n = len(ucfg.block_out_channels)
    n_zero = 1 + sum(ucfg.layers_per_block + (1 if i != n - 1 else 0)
                     for i in range(n))
    ce_blocks = []
    i = 0
    while f"controlnet_cond_embedding.blocks.{i}.weight" in sd:
        ce_blocks.append(_conv(sd, f"controlnet_cond_embedding.blocks.{i}"))
        i += 1
    trunk["controlnet_cond_embedding"] = {
        "conv_in": _conv(sd, "controlnet_cond_embedding.conv_in"),
        "blocks": ce_blocks,
        "conv_out": _conv(sd, "controlnet_cond_embedding.conv_out"),
    }
    trunk["controlnet_down_blocks"] = [
        _conv(sd, f"controlnet_down_blocks.{i}") for i in range(n_zero)]
    trunk["controlnet_mid_block"] = _conv(sd, "controlnet_mid_block")
    return trunk


# ---------------------------------------------------------------------------
# Resampler / ProjPlus / adapters
# ---------------------------------------------------------------------------


def _perceiver_layer(sd: Dict, prefix: str) -> Dict[str, Any]:
    """layers.{i}.0 (PerceiverAttention), layers.{i}.1 (FeedForward
    Sequential [LN, Linear, GELU, Linear])."""
    return {
        "attn": {
            "norm1": _norm(sd, f"{prefix}.0.norm1"),
            "norm2": _norm(sd, f"{prefix}.0.norm2"),
            "to_q": _linear(sd, f"{prefix}.0.to_q"),
            "to_kv": _linear(sd, f"{prefix}.0.to_kv"),
            "to_out": _linear(sd, f"{prefix}.0.to_out"),
        },
        "ff": {
            "norm": _norm(sd, f"{prefix}.1.0"),
            "fc1": _linear(sd, f"{prefix}.1.1"),
            "fc2": _linear(sd, f"{prefix}.1.3"),
        },
    }


def convert_resampler(sd: Dict, cfg: ResamplerConfig = ResamplerConfig()
                      ) -> Dict[str, Any]:
    """The reference Resampler's names: latents, proj_in, proj_out,
    norm_out, layers.{i}.{0,1}."""
    return {
        "latents": _np(sd["latents"]),
        "proj_in": _linear(sd, "proj_in"),
        "layers": [_perceiver_layer(sd, f"layers.{i}")
                   for i in range(cfg.depth)],
        "proj_out": _linear(sd, "proj_out"),
        "norm_out": _norm(sd, "norm_out"),
    }


def convert_proj_plus(sd: Dict, cfg: ProjPlusConfig = ProjPlusConfig()
                      ) -> Dict[str, Any]:
    """ProjPlusModel's names: proj.0/proj.2, norm,
    perceiver_resampler.{proj_in,proj_out,norm_out,layers.{i}.{0,1}}."""
    pr = "perceiver_resampler"
    return {
        "proj": {"fc1": _linear(sd, "proj.0"), "fc2": _linear(sd, "proj.2")},
        "norm": _norm(sd, "norm"),
        "perceiver_resampler": {
            "proj_in": _linear(sd, f"{pr}.proj_in"),
            "layers": [_perceiver_layer(sd, f"{pr}.layers.{i}")
                       for i in range(cfg.depth)],
            "proj_out": _linear(sd, f"{pr}.proj_out"),
            "norm_out": _norm(sd, f"{pr}.norm_out"),
        },
    }


def adapter_module_index_map(cfg: UNetConfig = UNetConfig()
                             ) -> List[Tuple[int, str]]:
    """(index, layer_name) for the reference's `adapter_modules` ModuleList.

    diffusers' attn_processors interleaves attn1/attn2 per transformer
    block in module-registration order: down_blocks -> up_blocks ->
    mid_block. Even positions are RefS (attn1) processors with
    to_k_ref/to_v_ref weights; odd positions are paramless CAttn (attn2)
    processors, but both consume an index.
    """
    pairs = []
    for n1, n2 in zip(attn_layer_names(cfg, "attn1"),
                      attn_layer_names(cfg, "attn2")):
        pairs += [(len(pairs), n1), (len(pairs) + 1, n2)]
    return pairs


def convert_imagdressing_checkpoint(
    module_sd: Dict,
    unet_cfg: UNetConfig = UNetConfig(),
    resampler_cfg: ResamplerConfig = ResamplerConfig(),
    *,
    load_main_unet: bool = False,
) -> Dict[str, Any]:
    """Split + convert the monolithic training checkpoint (the `"module"`
    sub-dict of IMAGDressing-v1_512.pt). Returns
    {ref_unet, resampler, ref_adapters[, unet]}.

    load_main_unet=False reproduces the shipped behavior: the reference
    builds `unet_dict` but never loads it.
    """
    prefixed: Dict[str, Dict] = {"ref_unet": {}, "unet": {}, "proj": {},
                                 "adapter_modules": {}}
    for k, v in module_sd.items():
        for pre in prefixed:
            if k.startswith(pre + "."):
                prefixed[pre][k[len(pre) + 1:]] = v
                break

    adapters = prefixed["adapter_modules"]
    out: Dict[str, Any] = {
        "ref_unet": convert_unet(prefixed["ref_unet"], unet_cfg),
        "resampler": convert_resampler(prefixed["proj"], resampler_cfg),
        "ref_adapters": {},
    }
    for idx, name in adapter_module_index_map(unet_cfg):
        if f"{idx}.to_k_ref.weight" in adapters:
            out["ref_adapters"][name] = {
                proj: {"kernel": _np(adapters[f"{idx}.{proj}.weight"]).T}
                for proj in ("to_k_ref", "to_v_ref")}
    if load_main_unet and prefixed["unet"]:
        out["unet"] = convert_unet(prefixed["unet"], unet_cfg)
    return out


def convert_ip_adapter_faceid(
    state_dict: Dict,
    unet_cfg: UNetConfig = UNetConfig(),
    projplus_cfg: ProjPlusConfig = ProjPlusConfig(),
) -> Dict[str, Any]:
    """ip-adapter-faceid-plusv2_sd15.bin -> {proj_plus, ip_adapters,
    lora_attn1, lora_attn2}.

    The bin has {"image_proj": ..., "ip_adapter": {"{idx}.to_k_ip.weight",
    "{idx}.to_{q,k,v,out}_lora.{down,up}.weight", ...}} where idx follows
    the interleaved attn_processors order. LoRA trees are returned per
    layer name in the JAX layout, down (in, rank) and up (rank, out);
    `apps.loader` folds them into the UNet.
    """
    ip_sd = state_dict["ip_adapter"]
    out: Dict[str, Any] = {
        "proj_plus": convert_proj_plus(state_dict["image_proj"], projplus_cfg),
        "ip_adapters": {},
        "lora_attn1": {},
        "lora_attn2": {},
    }
    for idx, name in adapter_module_index_map(unet_cfg):
        is_attn1 = ".attn1." in name
        if not is_attn1 and f"{idx}.to_k_ip.weight" in ip_sd:
            out["ip_adapters"][name] = {
                proj: {"kernel": _np(ip_sd[f"{idx}.{proj}.weight"]).T}
                for proj in ("to_k_ip", "to_v_ip")}
        lora = {}
        for proj in ("to_q", "to_k", "to_v", "to_out"):
            dk = f"{idx}.{proj}_lora.down.weight"
            if dk in ip_sd:
                lora[proj] = {
                    "down": _np(ip_sd[dk]).T,  # (in, rank)
                    "up": _np(ip_sd[f"{idx}.{proj}_lora.up.weight"]).T,
                }
        if lora:
            out["lora_attn1" if is_attn1 else "lora_attn2"][name] = lora
    return out


# ---------------------------------------------------------------------------
# Files
# ---------------------------------------------------------------------------

# safetensors dtype names <-> torch dtypes, the types the port reads and writes
SAFETENSORS_DTYPES = {"F32": torch.float32, "F16": torch.float16,
                      "BF16": torch.bfloat16, "I64": torch.int64}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A `.safetensors` file -> {name: CPU tensor}: an 8-byte little-endian
    header length, a JSON header {name: {dtype, shape, data_offsets}} (and
    an optional "__metadata__"), then the raw little-endian bytes. The file
    is read once into one buffer; each tensor is a view of it."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(os.fstat(f.fileno()).st_size - 8 - n)
        if f.readinto(data) != len(data):
            raise ValueError(f"{path}: short read")
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = SAFETENSORS_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}; "
                             f"the reader covers {sorted(SAFETENSORS_DTYPES)}")
        start, end = info["data_offsets"]
        shape = info["shape"]
        count = math.prod(shape)
        if end - start != count * dtype.itemsize or end > len(data):
            raise ValueError(f"{path}: {name}: {end - start} bytes for "
                             f"{shape} {info['dtype']}")
        t = torch.frombuffer(data, dtype=dtype, count=count, offset=start) \
            if count else torch.empty(0, dtype=dtype)
        out[name] = t.reshape(shape)
    return out


def write_safetensors(path: str, tensors: Dict[str, torch.Tensor]) -> None:
    """{name: tensor} -> a `.safetensors` file that `read_safetensors` (and
    the safetensors package) reads: names in sorted order, each tensor's
    bytes contiguous, the header padded with spaces to a multiple of 8."""
    names = {v: k for k, v in SAFETENSORS_DTYPES.items()}
    header, offset = {}, 0
    for name in sorted(tensors):
        t = tensors[name]
        if t.dtype not in names:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors "
                             "name here")
        size = t.numel() * t.element_size()
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + size]}
        offset += size
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for name in sorted(tensors):
            t = tensors[name].detach().to("cpu").contiguous().reshape(-1)
            f.write(t.view(torch.uint8).numpy())


def load_torch_file(path: str) -> Dict:
    """A checkpoint file -> its dict: `.safetensors` by `read_safetensors`,
    anything else by `torch.load` on the CPU (the reference's pickles, so
    weights_only=False: load only files you trust)."""
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    return torch.load(path, map_location="cpu", weights_only=False)
