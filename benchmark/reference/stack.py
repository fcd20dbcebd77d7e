"""Plain PyTorch reference of the IMAGDressing-v1 stack on SD1.5: the UNet
(main, garment capture and the ControlNet trunk), the ControlNet's
conditioning embedding and output convs, the AutoencoderKL, the CLIP text
and vision towers, the cloth Resampler and the garment adapters.

Functional: each model is a state dict read by key (`Params`), with the key
names of the checkpoints the benchmark draws (see `benchmark/lib/weights.py`).
Activations are NCHW for convolutions and (B, S, C) for the transformers.
Every product goes through `Precision`: float32 with TF32 off is the
reference; "fp8" rounds both operands of every linear, convolution and
attention product to float8 e4m3 with a per-tensor scale (the control that
a lower precision must fail). Norms, softmax and elementwise work stay in
float32 in both.

The architectures follow diffusers' UNet2DConditionModel, ControlNetModel
and AutoencoderKL, transformers' CLIPTextModel / CLIPVisionModel and the
IP-Adapter Resampler, at the widths of the configuration file. Departures:
none in the mathematics; the garment attention of a row whose scale is 0 is
not computed (it adds nothing)."""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # largest float8 e4m3fn value


class Precision:
    """The arithmetic of the products: "fp32" (exact float32 operands) or
    "fp8" (operands rounded to float8 e4m3fn, scaled per tensor)."""

    def __init__(self, mode: str = "fp32"):
        if mode not in ("fp32", "fp8"):
            raise ValueError(f"precision {mode!r} (fp32 | fp8)")
        self.mode = mode
        self._weights: Dict[int, torch.Tensor] = {}

    def act(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "fp32":
            return x
        amax = x.detach().abs().amax().float().clamp_min(1e-30)
        scale = FP8_MAX / amax
        return (x * scale).to(torch.float8_e4m3fn).float() / scale

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        """A weight as the products read it (rounded once per tensor)."""
        if self.mode == "fp32":
            return w
        key = id(w)
        if key not in self._weights:
            self._weights[key] = self.act(w)
        return self._weights[key]


class Params:
    """A model's state dict seen from a key prefix; records every key read,
    so that a run can show that the reference used every weight."""

    def __init__(self, sd: Dict[str, torch.Tensor], prec: Precision,
                 prefix: str = "", used: Optional[set] = None):
        self.sd, self.prec, self.prefix = sd, prec, prefix
        self.used = set() if used is None else used

    def __getitem__(self, key: str) -> torch.Tensor:
        full = self.prefix + key
        self.used.add(full)
        return self.sd[full]

    def has(self, key: str) -> bool:
        return self.prefix + key in self.sd

    def get(self, key: str) -> Optional[torch.Tensor]:
        return self[key] if self.has(key) else None

    def sub(self, prefix: str) -> "Params":
        return Params(self.sd, self.prec, self.prefix + prefix + ".",
                      self.used)

    def unused(self) -> List[str]:
        return sorted(k for k in self.sd if k.startswith(self.prefix)
                      and k not in self.used)


# ---------------------------------------------------------------------------
# Operations
# ---------------------------------------------------------------------------


def linear(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    w = p.prec.weight(p[name + ".weight"])
    return F.linear(p.prec.act(x), w, p.get(name + ".bias"))


def conv(p: Params, name: str, x: torch.Tensor, *, stride: int = 1,
         padding: int = 0) -> torch.Tensor:
    w = p.prec.weight(p[name + ".weight"])
    return F.conv2d(p.prec.act(x), w, p.get(name + ".bias"), stride=stride,
                    padding=padding)


def group_norm(p: Params, name: str, x: torch.Tensor, groups: int,
               eps: float) -> torch.Tensor:
    return F.group_norm(x, groups, p[name + ".weight"], p[name + ".bias"],
                        eps)


def layer_norm(p: Params, name: str, x: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), p[name + ".weight"],
                        p[name + ".bias"], eps)


def attention(prec: Precision, q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor, heads: int, *, causal: bool = False,
              scale: Optional[float] = None) -> torch.Tensor:
    """Multi-head softmax attention over (B, S, C) projections."""
    b, sq, c = q.shape
    d = c // heads

    def split(t):
        return t.reshape(b, t.shape[1], heads, d).transpose(1, 2)

    qh, kh, vh = split(q), split(k), split(v)
    logits = torch.matmul(prec.act(qh), prec.act(kh).transpose(-1, -2))
    logits = logits * (d ** -0.5 if scale is None else scale)
    if causal:
        mask = torch.ones(sq, kh.shape[2], dtype=torch.bool,
                          device=q.device).triu(1)
        logits = logits.masked_fill(mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    out = torch.matmul(prec.act(probs), prec.act(vh))
    return out.transpose(1, 2).reshape(b, sq, c)


def timestep_embedding(t: torch.Tensor, dim: int, flip_sin_to_cos: bool,
                       freq_shift: float) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / (half - freq_shift))
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half:], emb[:, :half]], dim=-1)
    return emb


def to_tokens(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, H*W, C)."""
    return x.flatten(2).transpose(1, 2)


def to_map(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, H*W, C) -> (B, C, H, W)."""
    return x.transpose(1, 2).reshape(x.shape[0], x.shape[2], h, w)


# ---------------------------------------------------------------------------
# UNet (main, garment capture, ControlNet trunk)
# ---------------------------------------------------------------------------


def attn_layer_name(prefix: str, which: str, layer: int = 0) -> str:
    """diffusers' attention processor name of a transformer block."""
    return f"{prefix}.transformer_blocks.{layer}.{which}.processor"


def resnet(p: Params, x: torch.Tensor, temb: Optional[torch.Tensor],
           groups: int, eps: float) -> torch.Tensor:
    h = conv(p, "conv1", F.silu(group_norm(p, "norm1", x, groups, eps)),
             padding=1)
    if temb is not None:
        h = h + linear(p, "time_emb_proj", F.silu(temb))[:, :, None, None]
    h = conv(p, "conv2", F.silu(group_norm(p, "norm2", h, groups, eps)),
             padding=1)
    if p.has("conv_shortcut.weight"):
        x = conv(p, "conv_shortcut", x)
    return x + h


class UNetCond:
    """What a UNet call is conditioned on beyond its context: the garment
    K/V per self-attention layer with one scale per row, and the
    ControlNet's residuals; `captured` collects the self-attention inputs
    (the garment UNet's capture run)."""

    def __init__(self, ref_kv=None, ref_scale: Sequence[float] = (),
                 down_residuals=None, mid_residual=None, captured=None):
        self.ref_kv = ref_kv
        self.ref_scale = list(ref_scale)
        self.down_residuals = down_residuals
        self.mid_residual = mid_residual
        self.captured = captured


def transformer2d(p: Params, cfg: dict, x: torch.Tensor, ctx: torch.Tensor,
                  prefix: str, cond: UNetCond) -> torch.Tensor:
    b, c, h, w = x.shape
    heads = cfg["attention_num_heads"]
    hid = group_norm(p, "norm", x, cfg["norm_num_groups"], 1e-6)
    hid = linear(p, "proj_in", to_tokens(hid))
    for li in range(cfg["transformer_layers_per_block"]):
        bp = p.sub(f"transformer_blocks.{li}")
        name = attn_layer_name(prefix, "attn1", li)
        nh = layer_norm(bp, "norm1", hid)
        if cond.captured is not None:
            cond.captured[name] = nh
        a1 = bp.sub("attn1")
        q = linear(a1, "to_q", nh)
        out = attention(p.prec, q, linear(a1, "to_k", nh),
                        linear(a1, "to_v", nh), heads)
        if cond.ref_kv is not None and name in cond.ref_kv:
            k_ref, v_ref = cond.ref_kv[name]
            rows = [i for i, s in enumerate(cond.ref_scale) if s != 0.0]
            if rows:
                idx = torch.tensor(rows, device=q.device)
                scale = torch.tensor([cond.ref_scale[i] for i in rows],
                                     device=q.device).reshape(-1, 1, 1)
                extra = attention(p.prec, q[idx], k_ref[idx], v_ref[idx],
                                  heads)
                out = out.index_add(0, idx, scale * extra)
        hid = hid + linear(a1, "to_out", out)
        a2 = bp.sub("attn2")
        q2 = linear(a2, "to_q", layer_norm(bp, "norm2", hid))
        hid = hid + linear(a2, "to_out", attention(
            p.prec, q2, linear(a2, "to_k", ctx), linear(a2, "to_v", ctx),
            heads))
        hg = linear(bp, "ff.proj", layer_norm(bp, "norm3", hid))
        hh, gate = hg.chunk(2, dim=-1)
        hid = hid + linear(bp, "ff.out", hh * F.gelu(gate))
    hid = linear(p, "proj_out", hid)
    return to_map(hid, h, w) + x


def unet(p: Params, cfg: dict, sample: torch.Tensor, t: torch.Tensor,
         ctx: torch.Tensor, cond: Optional[UNetCond] = None, *,
         down_only: bool = False,
         conv_in_extra: Optional[torch.Tensor] = None):
    """sample (B, C, H, W), t (B,), ctx (B, L, D). Returns eps (B, C, H,
    W); with down_only (the ControlNet trunk) the skips and the mid
    output."""
    cond = cond or UNetCond()
    chs = cfg["block_out_channels"]
    n, lpb = len(chs), cfg["layers_per_block"]
    g, eps = cfg["norm_num_groups"], cfg["norm_eps"]
    has_attn = cfg["down_block_has_attn"]
    te = timestep_embedding(t, chs[0], cfg["flip_sin_to_cos"],
                            cfg["freq_shift"])
    temb = linear(p, "time_embedding.linear_2",
                  F.silu(linear(p, "time_embedding.linear_1", te)))
    h = conv(p, "conv_in", sample, padding=1)
    if conv_in_extra is not None:
        h = h + conv_in_extra
    skips = [h]
    for i in range(n):
        for j in range(lpb):
            h = resnet(p.sub(f"down_blocks.{i}.resnets.{j}"), h, temb, g, eps)
            if has_attn[i]:
                prefix = f"down_blocks.{i}.attentions.{j}"
                h = transformer2d(p.sub(prefix), cfg, h, ctx, prefix, cond)
            skips.append(h)
        if i != n - 1:
            h = conv(p, f"down_blocks.{i}.downsamplers.0.conv", h, stride=2,
                     padding=1)
            skips.append(h)
    h = resnet(p.sub("mid_block.resnets.0"), h, temb, g, eps)
    h = transformer2d(p.sub("mid_block.attentions.0"), cfg, h, ctx,
                      "mid_block.attentions.0", cond)
    h = resnet(p.sub("mid_block.resnets.1"), h, temb, g, eps)
    if down_only:
        return skips, h
    if cond.down_residuals is not None:
        skips = [s + r for s, r in zip(skips, cond.down_residuals)]
        h = h + cond.mid_residual
    up_attn = list(reversed(has_attn))
    for i in range(n):
        for j in range(lpb + 1):
            h = torch.cat([h, skips.pop()], dim=1)
            h = resnet(p.sub(f"up_blocks.{i}.resnets.{j}"), h, temb, g, eps)
            if up_attn[i]:
                prefix = f"up_blocks.{i}.attentions.{j}"
                h = transformer2d(p.sub(prefix), cfg, h, ctx, prefix, cond)
        if i != n - 1:
            h = F.interpolate(h, scale_factor=2.0, mode="nearest")
            h = conv(p, f"up_blocks.{i}.upsamplers.0.conv", h, padding=1)
    h = F.silu(group_norm(p, "conv_norm_out", h, g, eps))
    return conv(p, "conv_out", h, padding=1)


def attn1_layer_names(cfg: dict) -> List[str]:
    """The self-attention layers in diffusers' processor order."""
    names = []
    lpb, has_attn = cfg["layers_per_block"], cfg["down_block_has_attn"]
    for i, has in enumerate(has_attn):
        names += [attn_layer_name(f"down_blocks.{i}.attentions.{j}", "attn1")
                  for j in range(lpb) if has]
    for i, has in enumerate(reversed(has_attn)):
        names += [attn_layer_name(f"up_blocks.{i}.attentions.{j}", "attn1")
                  for j in range(lpb + 1) if has]
    return names + [attn_layer_name("mid_block.attentions.0", "attn1")]


def ref_kv(p: Params, captured: Dict[str, torch.Tensor]):
    """The garment adapters' K/V of each captured self-attention input."""
    out = {}
    for name, hidden in captured.items():
        ad = p.sub(name.replace(".", "_"))
        out[name] = (linear(ad, "to_k_ref", hidden),
                     linear(ad, "to_v_ref", hidden))
    return out


# ---------------------------------------------------------------------------
# ControlNet
# ---------------------------------------------------------------------------


def controlnet(p: Params, cfg: dict, sample: torch.Tensor, t: torch.Tensor,
               ctx: torch.Tensor, cond_emb: torch.Tensor, scale: float):
    """-> (down residuals, mid residual) of the ControlNet trunk."""
    skips, mid = unet(p, cfg, sample, t, ctx, down_only=True,
                      conv_in_extra=cond_emb)
    down = [conv(p, f"controlnet_down_blocks.{i}", s) * scale
            for i, s in enumerate(skips)]
    return down, conv(p, "controlnet_mid_block", mid) * scale


def controlnet_cond_embedding(p: Params, image: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) condition image -> the trunk's conv_in addend: a conv,
    then pairs of a conv and a stride-2 conv, SiLU after each, and conv_out."""
    e = p.sub("controlnet_cond_embedding")
    h = F.silu(conv(e, "conv_in", image, padding=1))
    i = 0
    while e.has(f"blocks.{i}.weight"):
        h = F.silu(conv(e, f"blocks.{i}", h, stride=1 + i % 2, padding=1))
        i += 1
    return conv(e, "conv_out", h, padding=1)


# ---------------------------------------------------------------------------
# VAE
# ---------------------------------------------------------------------------


def _vae_mid(p: Params, x: torch.Tensor, g: int, eps: float) -> torch.Tensor:
    x = resnet(p.sub("resnets.0"), x, None, g, eps)
    a = p.sub("attentions.0")
    b, c, h, w = x.shape
    hid = to_tokens(group_norm(a, "group_norm", x, g, eps))
    out = attention(p.prec, linear(a, "to_q", hid), linear(a, "to_k", hid),
                    linear(a, "to_v", hid), 1)
    x = x + to_map(linear(a, "to_out", out), h, w)
    return resnet(p.sub("resnets.1"), x, None, g, eps)


def vae_encode_mean(p: Params, cfg: dict, images: torch.Tensor
                    ) -> torch.Tensor:
    """(B, 3, H, W) in [-1, 1] -> the latent distribution's mean."""
    e = p.sub("encoder")
    g, eps = cfg["norm_num_groups"], cfg["norm_eps"]
    n = len(cfg["block_out_channels"])
    h = conv(e, "conv_in", images, padding=1)
    for i in range(n):
        for j in range(cfg["layers_per_block"]):
            h = resnet(e.sub(f"down_blocks.{i}.resnets.{j}"), h, None, g, eps)
        if i != n - 1:
            h = conv(e, f"down_blocks.{i}.downsamplers.0.conv",
                     F.pad(h, (0, 1, 0, 1)), stride=2)
    h = _vae_mid(e.sub("mid_block"), h, g, eps)
    h = conv(e, "conv_out", F.silu(group_norm(e, "conv_norm_out", h, g, eps)),
             padding=1)
    return conv(p, "quant_conv", h)[:, :cfg["latent_channels"]]


def vae_decode(p: Params, cfg: dict, latents: torch.Tensor) -> torch.Tensor:
    """Latents already divided by the scaling factor -> images in [-1, 1]
    (unclipped)."""
    d = p.sub("decoder")
    g, eps = cfg["norm_num_groups"], cfg["norm_eps"]
    n = len(cfg["block_out_channels"])
    h = conv(d, "conv_in", conv(p, "post_quant_conv", latents), padding=1)
    h = _vae_mid(d.sub("mid_block"), h, g, eps)
    for i in range(n):
        for j in range(cfg["layers_per_block"] + 1):
            h = resnet(d.sub(f"up_blocks.{i}.resnets.{j}"), h, None, g, eps)
        if i != n - 1:
            h = F.interpolate(h, scale_factor=2.0, mode="nearest")
            h = conv(d, f"up_blocks.{i}.upsamplers.0.conv", h, padding=1)
    h = F.silu(group_norm(d, "conv_norm_out", h, g, eps))
    return conv(d, "conv_out", h, padding=1)


# ---------------------------------------------------------------------------
# CLIP towers and the Resampler
# ---------------------------------------------------------------------------


def _quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def _encoder_layer(p: Params, x: torch.Tensor, heads: int, act, eps: float,
                   causal: bool) -> torch.Tensor:
    h = layer_norm(p, "layer_norm1", x, eps)
    a = p.sub("self_attn")
    out = attention(p.prec, linear(a, "q_proj", h), linear(a, "k_proj", h),
                    linear(a, "v_proj", h), heads, causal=causal)
    x = x + linear(a, "out_proj", out)
    h = layer_norm(p, "layer_norm2", x, eps)
    return x + linear(p, "mlp.fc2", act(linear(p, "mlp.fc1", h)))


def _act(name: str):
    return _quick_gelu if name == "quick_gelu" else F.gelu


def clip_text(p: Params, cfg: dict, ids: torch.Tensor,
              clip_skip: int = 0) -> torch.Tensor:
    """(B, 77) token ids -> the last hidden state after the final norm."""
    x = p["token_embedding.weight"][ids] \
        + p["position_embedding.weight"][:ids.shape[1]]
    for li in range(cfg["num_layers"] - clip_skip):
        x = _encoder_layer(p.sub(f"layers.{li}"), x, cfg["num_heads"],
                           _act(cfg["hidden_act"]), cfg["layer_norm_eps"],
                           causal=True)
    return layer_norm(p, "final_layer_norm", x, cfg["layer_norm_eps"])


def clip_vision_penultimate(p: Params, cfg: dict, pixels: torch.Tensor
                            ) -> torch.Tensor:
    """(B, 3, 224, 224) CLIP-normalised -> hidden_states[-2]."""
    b = pixels.shape[0]
    patches = to_tokens(conv(p, "patch_embedding", pixels,
                             stride=cfg["patch_size"]))
    cls = p["class_embedding"].reshape(1, 1, -1).expand(b, 1, -1)
    x = torch.cat([cls, patches], dim=1) + p["position_embedding.weight"]
    x = layer_norm(p, "pre_layrnorm", x, cfg["layer_norm_eps"])
    for li in range(cfg["num_layers"] - 1):
        x = _encoder_layer(p.sub(f"layers.{li}"), x, cfg["num_heads"],
                           _act(cfg["hidden_act"]), cfg["layer_norm_eps"],
                           causal=False)
    return x


def resampler(p: Params, cfg: dict, x: torch.Tensor) -> torch.Tensor:
    """CLIP-H penultimate states (B, 257, 1280) -> cloth tokens (B, 16,
    768): a Perceiver whose latents attend over [inputs; latents] with the
    two-sided dim_head ** -0.25 scaling."""
    latents = p["latents"].expand(x.shape[0], -1, -1)
    x = linear(p, "proj_in", x)
    heads = cfg["heads"]
    for li in range(cfg["depth"]):
        a = p.sub(f"layers.{li}.attn")
        xn = layer_norm(a, "norm1", x)
        ln = layer_norm(a, "norm2", latents)
        q = linear(a, "to_q", ln)
        k, v = linear(a, "to_kv", torch.cat([xn, ln], dim=1)).chunk(2, -1)
        out = attention(p.prec, q, k, v, heads,
                        scale=1.0 / math.sqrt(cfg["dim_head"]))
        latents = linear(a, "to_out", out) + latents
        f = p.sub(f"layers.{li}.ff")
        latents = linear(f, "fc2", F.gelu(linear(
            f, "fc1", layer_norm(f, "norm", latents)))) + latents
    return layer_norm(p, "norm_out", linear(p, "proj_out", latents))
