"""Perceiver resamplers (port of `imagdressing_tpu/models/resampler.py`):
`Resampler`, which turns the garment's CLIP-H states into the cloth prompt
tokens, and `ProjPlus`, the IP-Adapter-FaceID-Plus projector (an id
embedding to face tokens, refined by `FaceResampler` over the face crop's
CLIP-H states). Plain PyTorch: the JAX package runs them through XLA."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from imagdressing_tpu_torch.core.config import ProjPlusConfig, ResamplerConfig
from imagdressing_tpu_torch.ops.nn import Linear, Norm, layer_norm


class PerceiverAttention(nn.Module):
    def __init__(self, dim: int, dim_head: int, heads: int):
        super().__init__()
        inner = dim_head * heads
        self.dim_head, self.heads = dim_head, heads
        self.norm1 = Norm(dim)
        self.norm2 = Norm(dim)
        self.to_q = Linear(dim, inner, bias=False)
        self.to_kv = Linear(dim, inner * 2, bias=False)
        self.to_out = Linear(inner, dim, bias=False)

    def forward(self, x: torch.Tensor, latents: torch.Tensor) -> torch.Tensor:
        """latents (B, n2, D) attend over concat(x (B, n1, D), latents)."""
        x = layer_norm(x, self.norm1.weight, self.norm1.bias)
        latents = layer_norm(latents, self.norm2.weight, self.norm2.bias)
        b, n2, _ = latents.shape
        q = self.to_q(latents)
        k, v = self.to_kv(torch.cat([x, latents], dim=1)).chunk(2, dim=-1)

        def heads_first(t):
            return t.reshape(b, t.shape[1], self.heads,
                             self.dim_head).transpose(1, 2)

        qh, kh, vh = heads_first(q), heads_first(k), heads_first(v)
        # two-sided dim_head**-0.25 scaling, fp32 logits and softmax
        s = self.dim_head ** -0.25
        logits = torch.einsum("bhqd,bhkd->bhqk", (qh * s).float(),
                              (kh * s).float())
        probs = torch.softmax(logits, dim=-1).to(vh.dtype)
        out = torch.einsum("bhqk,bhkd->bhqd", probs, vh)
        return self.to_out(out.transpose(1, 2).reshape(b, n2, -1))


class FF(nn.Module):
    def __init__(self, dim: int, mult: int):
        super().__init__()
        self.norm = Norm(dim)
        self.fc1 = Linear(dim, dim * mult, bias=False)
        self.fc2 = Linear(dim * mult, dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = layer_norm(x, self.norm.weight, self.norm.bias)
        return self.fc2(F.gelu(self.fc1(h)))


class ResamplerLayer(nn.Module):
    def __init__(self, dim: int, dim_head: int, heads: int, ff_mult: int):
        super().__init__()
        self.attn = PerceiverAttention(dim, dim_head, heads)
        self.ff = FF(dim, ff_mult)


def _perceiver(layers: nn.ModuleList, x: torch.Tensor,
               latents: torch.Tensor) -> torch.Tensor:
    for layer in layers:
        latents = layer.attn(x, latents) + latents
        latents = layer.ff(latents) + latents
    return latents


class Resampler(nn.Module):
    def __init__(self, cfg: ResamplerConfig):
        super().__init__()
        self.cfg = cfg
        self.latents = nn.Parameter(torch.empty(1, cfg.num_queries, cfg.dim))
        self.proj_in = Linear(cfg.embedding_dim, cfg.dim)
        self.layers = nn.ModuleList(
            [ResamplerLayer(cfg.dim, cfg.dim_head, cfg.heads, cfg.ff_mult)
             for _ in range(cfg.depth)])
        self.proj_out = Linear(cfg.dim, cfg.output_dim)
        self.norm_out = Norm(cfg.output_dim)

    def reset_parameters(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.latents.normal_(0.0, self.cfg.dim ** -0.5, generator=gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: CLIP-vision penultimate states (B, 257, embedding_dim) ->
        cloth tokens (B, num_queries, output_dim)."""
        latents = self.latents.to(x.dtype).expand(x.shape[0], -1, -1)
        latents = _perceiver(self.layers, self.proj_in(x), latents)
        return layer_norm(self.proj_out(latents), self.norm_out.weight,
                          self.norm_out.bias)


class FaceResampler(nn.Module):
    """FacePerceiverResampler: the face tokens attend over the face crop's
    CLIP-H states; heads = cross_attention_dim / dim_head."""

    def __init__(self, cfg: ProjPlusConfig):
        super().__init__()
        dim = cfg.cross_attention_dim
        self.proj_in = Linear(cfg.clip_embeddings_dim, dim)
        self.layers = nn.ModuleList(
            [ResamplerLayer(dim, cfg.dim_head, dim // cfg.dim_head,
                            cfg.ff_mult) for _ in range(cfg.depth)])
        self.proj_out = Linear(dim, dim)
        self.norm_out = Norm(dim)

    def forward(self, latents: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """latents (B, num_tokens, dim) face tokens; x (B, 257, 1280)."""
        latents = _perceiver(self.layers, self.proj_in(x), latents)
        return layer_norm(self.proj_out(latents), self.norm_out.weight,
                          self.norm_out.bias)


class ProjMLP(nn.Module):
    def __init__(self, cfg: ProjPlusConfig):
        super().__init__()
        idd = cfg.id_embeddings_dim
        self.fc1 = Linear(idd, idd * 2)
        self.fc2 = Linear(idd * 2, cfg.cross_attention_dim * cfg.num_tokens)


class ProjPlus(nn.Module):
    """IP-Adapter-FaceID-Plus projector (`apply_proj_plus`)."""

    def __init__(self, cfg: ProjPlusConfig):
        super().__init__()
        self.cfg = cfg
        self.proj = ProjMLP(cfg)
        self.norm = Norm(cfg.cross_attention_dim)
        self.perceiver_resampler = FaceResampler(cfg)

    def forward(self, id_embeds: torch.Tensor, clip_embeds: torch.Tensor, *,
                shortcut: bool = True, scale: float = 1.0) -> torch.Tensor:
        """id_embeds (B, id_dim) face embedding, clip_embeds (B, 257, 1280)
        CLIP-H penultimate states of the face crop -> face tokens (B,
        num_tokens, cross_attention_dim): fc1, exact GELU, fc2, LayerNorm,
        then the Perceiver (plus the LayerNormed tokens times `scale` with
        `shortcut`)."""
        cfg = self.cfg
        x = self.proj.fc2(F.gelu(self.proj.fc1(id_embeds)))
        x = layer_norm(x.reshape(-1, cfg.num_tokens, cfg.cross_attention_dim),
                       self.norm.weight, self.norm.bias)
        out = self.perceiver_resampler(x, clip_embeds)
        return x + scale * out if shortcut else out
