"""CLIP text (ViT-L/14) and vision (ViT-H/14) towers in PyTorch (port of
`imagdressing_tpu/models/clip.py`), also at the CAMI scorer's ViT-B/32
(`eval/clip_score.py`). Attention here is the plain path
(`ops.attention.attention`), as in the JAX package: 77, 257 and 50
tokens. `vision_pooled_embed` and `clip_preprocess` are the projected image
embedding and CLIPImageProcessor's resize and normalisation."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from imagdressing_tpu_torch.core.config import CLIPTextConfig, CLIPVisionConfig
from imagdressing_tpu_torch.ops import attention as attn_ops
from imagdressing_tpu_torch.ops.resize import jax_resize
from imagdressing_tpu_torch.ops.nn import (
    Conv2d,
    Embedding,
    Linear,
    Norm,
    layer_norm,
    quick_gelu,
)

# CLIPImageProcessor's normalisation (the JAX package's models/clip.py)
CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


class SelfAttn(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.q_proj = Linear(hidden, hidden)
        self.k_proj = Linear(hidden, hidden)
        self.v_proj = Linear(hidden, hidden)
        self.out_proj = Linear(hidden, hidden)


class MLP(nn.Module):
    def __init__(self, hidden: int, intermediate: int):
        super().__init__()
        self.fc1 = Linear(hidden, intermediate)
        self.fc2 = Linear(intermediate, hidden)


class EncoderLayer(nn.Module):
    def __init__(self, hidden: int, intermediate: int):
        super().__init__()
        self.layer_norm1 = Norm(hidden)
        self.self_attn = SelfAttn(hidden)
        self.layer_norm2 = Norm(hidden)
        self.mlp = MLP(hidden, intermediate)

    def forward(self, x: torch.Tensor, num_heads: int, act, eps: float,
                causal: bool) -> torch.Tensor:
        h = layer_norm(x, self.layer_norm1.weight, self.layer_norm1.bias,
                       eps=eps)
        ap = self.self_attn
        q, k, v = ap.q_proj(h), ap.k_proj(h), ap.v_proj(h)
        if causal:
            b, s, c = q.shape
            d = c // num_heads
            qh, kh, vh = (t.reshape(b, s, num_heads, d) for t in (q, k, v))
            logits = torch.einsum("bqhd,bkhd->bhqk", qh.float(),
                                  kh.float()) / d**0.5
            mask = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
            logits = logits.masked_fill(~mask, -1e9)
            probs = torch.softmax(logits, dim=-1).to(q.dtype)
            out = torch.einsum("bhqk,bkhd->bqhd", probs, vh).reshape(b, s, c)
        else:
            out = attn_ops.attention(q, k, v, num_heads)
        x = x + ap.out_proj(out)
        h = layer_norm(x, self.layer_norm2.weight, self.layer_norm2.bias,
                       eps=eps)
        return x + self.mlp.fc2(act(self.mlp.fc1(h)))


def _act(name: str):
    return quick_gelu if name == "quick_gelu" else F.gelu


class CLIPText(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = Embedding(cfg.max_position_embeddings,
                                            cfg.hidden_size)
        self.layers = nn.ModuleList(
            [EncoderLayer(cfg.hidden_size, cfg.intermediate_size)
             for _ in range(cfg.num_layers)])
        self.final_layer_norm = Norm(cfg.hidden_size)

    def forward(self, input_ids: torch.Tensor, *, clip_skip: int = 0
                ) -> torch.Tensor:
        """input_ids (B, 77) -> last hidden state after the final LayerNorm
        (B, 77, hidden). clip_skip=k drops the last k encoder layers."""
        cfg = self.cfg
        s = input_ids.shape[1]
        x = self.token_embedding.weight[input_ids] \
            + self.position_embedding.weight[:s]
        layers = list(self.layers)
        if clip_skip:
            layers = layers[:len(layers) - clip_skip]
        for lp in layers:
            x = lp(x, cfg.num_heads, _act(cfg.hidden_act), cfg.layer_norm_eps,
                   causal=True)
        return layer_norm(x, self.final_layer_norm.weight,
                          self.final_layer_norm.bias, eps=cfg.layer_norm_eps)


class CLIPVision(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.cfg = cfg
        self.class_embedding = nn.Parameter(torch.empty(cfg.hidden_size))
        self.patch_embedding = Conv2d(3, cfg.hidden_size, cfg.patch_size,
                                      stride=cfg.patch_size, bias=False)
        self.position_embedding = Embedding(cfg.seq_len, cfg.hidden_size)
        self.pre_layrnorm = Norm(cfg.hidden_size)  # sic: HF's name
        self.layers = nn.ModuleList(
            [EncoderLayer(cfg.hidden_size, cfg.intermediate_size)
             for _ in range(cfg.num_layers)])
        self.post_layernorm = Norm(cfg.hidden_size)
        self.visual_projection = Linear(cfg.hidden_size, cfg.projection_dim,
                                        bias=False)

    def reset_parameters(self, gen: torch.Generator) -> None:
        """normal(0, 0.02) for the embeddings and projections, as the JAX
        package initialises them."""
        with torch.no_grad():
            for p in (self.class_embedding, self.patch_embedding.weight,
                      self.visual_projection.weight):
                p.normal_(0.0, 0.02, generator=gen)

    def forward(self, pixel_values: torch.Tensor, *, penultimate: bool = True
                ) -> torch.Tensor:
        """pixel_values (B, 224, 224, 3) CLIP-normalized NHWC.
        penultimate=True -> hidden_states[-2] (B, 257, hidden), the
        Resampler input; False -> last hidden state (no post-LN)."""
        cfg = self.cfg
        b = pixel_values.shape[0]
        patches = self.patch_embedding(pixel_values).reshape(
            b, -1, cfg.hidden_size)
        cls = self.class_embedding.to(patches.dtype).expand(b, 1, -1)
        x = torch.cat([cls, patches], dim=1) \
            + self.position_embedding.weight.to(patches.dtype)
        x = layer_norm(x, self.pre_layrnorm.weight, self.pre_layrnorm.bias,
                       eps=cfg.layer_norm_eps)
        n_layers = cfg.num_layers - 1 if penultimate else cfg.num_layers
        for lp in list(self.layers)[:n_layers]:
            x = lp(x, cfg.num_heads, _act(cfg.hidden_act), cfg.layer_norm_eps,
                   causal=False)
        return x


def vision_pooled_embed(vision: CLIPVision, last_hidden: torch.Tensor
                        ) -> torch.Tensor:
    """post_layernorm(CLS) @ visual_projection: CLIPVisionModelWith
    Projection's image_embeds, from the last hidden state (B, S, hidden)
    -> (B, projection_dim)."""
    pooled = layer_norm(last_hidden[:, 0], vision.post_layernorm.weight,
                        vision.post_layernorm.bias,
                        eps=vision.cfg.layer_norm_eps)
    return vision.visual_projection(pooled)


def clip_preprocess(images01: torch.Tensor, size: int = 224) -> torch.Tensor:
    """(B, H, W, 3) in [0, 1] -> (B, size, size, 3) CLIP-normalized: JAX's
    bicubic resize (`ops.resize.jax_resize`, antialiased when shrinking),
    clipped to [0, 1], CLIPImageProcessor's mean and std."""
    x = jax_resize(images01, size, size).clamp(0.0, 1.0)
    mean = torch.tensor(CLIP_IMAGE_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(CLIP_IMAGE_STD, dtype=x.dtype, device=x.device)
    return (x - mean) / std
