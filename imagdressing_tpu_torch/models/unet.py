"""SD1.5-class UNet2DConditionModel in PyTorch, NHWC (port of
`imagdressing_tpu/models/unet.py`).

One module serves three roles: the main UNet (`forward(..., cond)` with
dual-KV self-attention, the IP-Adapter and garment-cross branches of the
cross-attention and the ControlNet's residuals), the garment UNet
(`forward(..., capture=True)`, which also returns every self-attention
layer's input) and, built with `encoder_only=True`, the ControlNet's trunk
(`forward(..., down_only=True)`: the skips, the mid output and temb). Module
attribute names follow the JAX parameter tree, so `convert` maps one path to
one state-dict key.

Kernels on this path: every resnet GN+SiLU+conv3x3 (K2,
`kernels/fused_gn_conv.py`), the transformer in-norm and `conv_norm_out`
(K3, `kernels/fused_groupnorm.py`) and every self-attention (K1 for
inference; K5 forward and K6a/K6b backward under autograd,
`kernels/flash_attention.py`, through `ops/attention.py`; the `concat`
self-attention and the garment-cross branch run K1 single-source, the
IP-Adapter branch over its few face tokens stays plain, as in the JAX
package).

Training: `forward(..., remat=True, remat_policy=...)` recomputes blocks in
the backward (`torch.utils.checkpoint`, non-reentrant), with the JAX
package's policies (`resolve_remat_policy`): "full" saves nothing inside a
resnet or transformer block; "dots" saves every matmul output; "names" the
resnet conv1 output and the pre-projection self-attention output (JAX's
`rematsave_conv` / `rematsave_attn`); "heavy" both; "none" recomputes
nothing. Capture mode never remats: the captured hidden states are a side
output.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, List, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from imagdressing_tpu_torch.core.config import UNetConfig
from imagdressing_tpu_torch.kernels.fused_gn_conv import gn_silu_conv3x3
from imagdressing_tpu_torch.kernels.fused_groupnorm import group_norm_act
from imagdressing_tpu_torch.models.conditioning import KV, Conditioning
from imagdressing_tpu_torch.ops import attention as attn_ops
from imagdressing_tpu_torch.ops.nn import (
    Conv2d,
    Linear,
    Norm,
    Upsample2xConv,
    geglu,
    layer_norm,
    timestep_embedding,
)


def attn_layer_names(cfg: UNetConfig, which: str = "attn1") -> List[str]:
    """Attention layer names in diffusers' attn_processors order (down
    blocks, up blocks, mid), as the JAX package names them."""
    names = []
    for i, has in enumerate(cfg.down_block_has_attn):
        if has:
            for j in range(cfg.layers_per_block):
                names.append(f"down_blocks.{i}.attentions.{j}"
                             f".transformer_blocks.0.{which}.processor")
    for i, has in enumerate(cfg.up_block_has_attn):
        if has:
            for j in range(cfg.layers_per_block + 1):
                names.append(f"up_blocks.{i}.attentions.{j}"
                             f".transformer_blocks.0.{which}.processor")
    names.append(f"mid_block.attentions.0.transformer_blocks.0.{which}.processor")
    return names


def attn_layer_dims(cfg: UNetConfig) -> Dict[str, int]:
    """{attention layer name: channels of its block}, attn1 and attn2."""
    dims = {}
    for which in ("attn1", "attn2"):
        for name in attn_layer_names(cfg, which):
            parts = name.split(".")
            if parts[0] == "mid_block":
                ch = cfg.block_out_channels[-1]
            elif parts[0] == "down_blocks":
                ch = cfg.block_out_channels[int(parts[1])]
            else:
                ch = tuple(reversed(cfg.block_out_channels))[int(parts[1])]
            dims[name] = ch
    return dims


def skip_channels(cfg: UNetConfig) -> List[int]:
    """Channels of each down-path skip, in the order the up path pops them
    last-first (conv_in, then each resnet and downsampler)."""
    chs = [cfg.block_out_channels[0]]
    for i, c in enumerate(cfg.block_out_channels):
        chs.extend([c] * cfg.layers_per_block)
        if i != len(cfg.block_out_channels) - 1:
            chs.append(c)
    return chs


def _add_scaled(out: torch.Tensor, extra: torch.Tensor,
                scale: Union[float, torch.Tensor]) -> torch.Tensor:
    """out + scale * extra summed in fp32, cast back to out's dtype; scale a
    Python number, a 0-d or a per-row (B,) tensor."""
    if torch.is_tensor(scale):
        scale = scale.float()
        if scale.ndim > 0:
            scale = scale.reshape(-1, 1, 1)
    else:
        scale = float(scale)
    return (out.float() + scale * extra.float()).to(out.dtype)


def adapter_key(layer_name: str) -> str:
    """Module key of a layer's ref adapter (module names cannot hold '.')."""
    return layer_name.replace(".", "_")


class Attention(nn.Module):
    def __init__(self, query_dim: int, context_dim: Optional[int] = None):
        super().__init__()
        ctx = context_dim or query_dim
        self.to_q = Linear(query_dim, query_dim, bias=False)
        self.to_k = Linear(ctx, query_dim, bias=False)
        self.to_v = Linear(ctx, query_dim, bias=False)
        self.to_out = Linear(query_dim, query_dim)


class FeedForward(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        inner = dim * 4
        self.proj = Linear(dim, inner * 2)
        self.out = Linear(inner, dim)


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, context_dim: int):
        super().__init__()
        self.norm1 = Norm(dim)
        self.attn1 = Attention(dim)
        self.norm2 = Norm(dim)
        self.attn2 = Attention(dim, context_dim)
        self.norm3 = Norm(dim)
        self.ff = FeedForward(dim)


class Transformer2D(nn.Module):
    def __init__(self, dim: int, context_dim: int, n_layers: int):
        super().__init__()
        self.norm = Norm(dim)
        self.proj_in = Linear(dim, dim)
        self.transformer_blocks = nn.ModuleList(
            [TransformerBlock(dim, context_dim) for _ in range(n_layers)])
        self.proj_out = Linear(dim, dim)


class Resnet(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, temb_ch: int):
        super().__init__()
        self.norm1 = Norm(in_ch)
        self.conv1 = Conv2d(in_ch, out_ch, 3, padding=1)
        self.time_emb_proj = Linear(temb_ch, out_ch)
        self.norm2 = Norm(out_ch)
        self.conv2 = Conv2d(out_ch, out_ch, 3, padding=1)
        self.conv_shortcut = (Conv2d(in_ch, out_ch, 1)
                              if in_ch != out_ch else None)


class Resampling(nn.Module):
    """Holder of a down- or upsampler's `conv` (the JAX tree's nesting)."""

    def __init__(self, conv: nn.Module):
        super().__init__()
        self.conv = conv


class Block(nn.Module):
    def __init__(self):
        super().__init__()
        self.resnets = nn.ModuleList()
        self.attentions = nn.ModuleList()


class TimeEmbedding(nn.Module):
    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.linear_1 = Linear(in_dim, dim)
        self.linear_2 = Linear(dim, dim)


class UNet(nn.Module):
    """`encoder_only=True` builds conv_in, the time embedding, the down and
    mid blocks only: the ControlNet's trunk."""

    def __init__(self, cfg: UNetConfig, *, encoder_only: bool = False):
        super().__init__()
        self.cfg = cfg
        self.encoder_only = encoder_only
        chs = cfg.block_out_channels
        n = len(chs)
        temb = cfg.time_embed_dim
        ctx, tl = cfg.cross_attention_dim, cfg.transformer_layers_per_block
        self.conv_in = Conv2d(cfg.in_channels, chs[0], 3, padding=1)
        self.time_embedding = TimeEmbedding(chs[0], temb)

        self.down_blocks = nn.ModuleList()
        out_ch = chs[0]
        for i, ch in enumerate(chs):
            in_ch, out_ch = out_ch, ch
            block = Block()
            for j in range(cfg.layers_per_block):
                block.resnets.append(Resnet(in_ch if j == 0 else out_ch,
                                            out_ch, temb))
                if cfg.down_block_has_attn[i]:
                    block.attentions.append(Transformer2D(out_ch, ctx, tl))
            if i != n - 1:
                block.downsamplers = nn.ModuleList([Resampling(
                    Conv2d(out_ch, out_ch, 3, stride=2, padding=1))])
            self.down_blocks.append(block)

        self.mid_block = Block()
        self.mid_block.resnets.extend([Resnet(chs[-1], chs[-1], temb),
                                       Resnet(chs[-1], chs[-1], temb)])
        self.mid_block.attentions.append(Transformer2D(chs[-1], ctx, tl))
        if encoder_only:
            return

        self.up_blocks = nn.ModuleList()
        rev = list(reversed(chs))
        out_ch = rev[0]
        for i, ch in enumerate(rev):
            prev_out, out_ch = out_ch, ch
            in_ch = rev[min(i + 1, n - 1)]
            block = Block()
            for j in range(cfg.layers_per_block + 1):
                skip_ch = in_ch if j == cfg.layers_per_block else out_ch
                res_in = prev_out if j == 0 else out_ch
                block.resnets.append(Resnet(res_in + skip_ch, out_ch, temb))
                if cfg.up_block_has_attn[i]:
                    block.attentions.append(Transformer2D(out_ch, ctx, tl))
            if i != n - 1:
                block.upsamplers = nn.ModuleList(
                    [Resampling(Upsample2xConv(out_ch))])
            self.up_blocks.append(block)

        self.conv_norm_out = Norm(chs[0])
        self.conv_out = Conv2d(chs[0], cfg.out_channels, 3, padding=1)

    # ------------------------------------------------------------------
    def _resnet(self, p: Resnet, x: torch.Tensor, temb: torch.Tensor
                ) -> torch.Tensor:
        g, eps = self.cfg.norm_num_groups, self.cfg.norm_eps
        h = gn_silu_conv3x3(x, p.norm1.weight, p.norm1.bias, p.conv1.weight,
                            p.conv1.bias, num_groups=g, eps=eps)
        t = p.time_emb_proj(F.silu(temb))
        # +temb folds into the fused statistics of norm2
        h = gn_silu_conv3x3(h, p.norm2.weight, p.norm2.bias, p.conv2.weight,
                            p.conv2.bias, num_groups=g, eps=eps, add=t)
        if p.conv_shortcut is not None:
            x = p.conv_shortcut(x)
        return x + h

    def _self_attention(self, p: Attention, x: torch.Tensor, name: str,
                        cond: Conditioning) -> torch.Tensor:
        heads = self.cfg.attention_num_heads
        q, k, v = p.to_q(x), p.to_k(x), p.to_v(x)
        if cond.ref_kv is not None and name in cond.ref_kv:
            k_ref, v_ref = cond.ref_kv[name]
            if cond.ref_mode == "concat":
                # the garment tokens join the key / value source: one softmax
                # over 2S keys
                k = torch.cat([k, k_ref.to(q.dtype)], dim=1)
                v = torch.cat([v, v_ref.to(q.dtype)], dim=1)
                out = attn_ops.self_attention(q, k, v, heads)
            else:
                out = attn_ops.dual_kv_attention(
                    q, k, v, k_ref.to(q.dtype), v_ref.to(q.dtype),
                    cond.ref_scale, heads)
        else:
            out = attn_ops.self_attention(q, k, v, heads)
        return p.to_out(out)

    def _cross_attention(self, p: Attention, x: torch.Tensor,
                         context: torch.Tensor, name: str,
                         cond: Conditioning) -> torch.Tensor:
        heads = self.cfg.attention_num_heads
        q = p.to_q(x)
        if cond.cross_kv is not None and name in cond.cross_kv:
            k, v = (t.to(q.dtype) for t in cond.cross_kv[name])
        else:
            k, v = p.to_k(context), p.to_v(context)
        out = attn_ops.attention(q, k, v, heads)
        if cond.ref_cross_kv is not None and name in cond.ref_cross_kv:
            k_ref, v_ref = (t.to(q.dtype) for t in cond.ref_cross_kv[name])
            out = _add_scaled(
                out, attn_ops.self_attention(q, k_ref, v_ref, heads),
                cond.ref_scale)
        if cond.ip_kv is not None and name in cond.ip_kv:
            k_ip, v_ip = (t.to(q.dtype) for t in cond.ip_kv[name])
            out = _add_scaled(out, attn_ops.attention(q, k_ip, v_ip, heads),
                              cond.ip_scale)
        return p.to_out(out)

    def _transformer2d(self, p: Transformer2D, x: torch.Tensor,
                       context: torch.Tensor, prefix: str,
                       cond: Conditioning,
                       captured: Optional[Dict[str, torch.Tensor]]
                       ) -> torch.Tensor:
        b, h, w, c = x.shape
        hidden = group_norm_act(x, p.norm.weight, p.norm.bias,
                                num_groups=self.cfg.norm_num_groups,
                                eps=1e-6, act="none")
        hidden = p.proj_in(hidden.reshape(b, h * w, c))
        for li, bp in enumerate(p.transformer_blocks):
            attn1 = f"{prefix}.transformer_blocks.{li}.attn1.processor"
            attn2 = f"{prefix}.transformer_blocks.{li}.attn2.processor"
            norm_hidden = layer_norm(hidden, bp.norm1.weight, bp.norm1.bias)
            if captured is not None:
                # the self-attention INPUT is what the garment UNet caches
                captured[attn1] = norm_hidden
            hidden = hidden + self._self_attention(bp.attn1, norm_hidden,
                                                   attn1, cond)
            hidden = hidden + self._cross_attention(
                bp.attn2, layer_norm(hidden, bp.norm2.weight, bp.norm2.bias),
                context, attn2, cond)
            ff_in = layer_norm(hidden, bp.norm3.weight, bp.norm3.bias)
            hidden = hidden + bp.ff.out(
                geglu(ff_in, bp.ff.proj.weight, bp.ff.proj.bias))
        hidden = p.proj_out(hidden)
        return hidden.reshape(b, h, w, c) + x

    def forward(self, sample: torch.Tensor,
                timesteps: Union[int, torch.Tensor],
                encoder_hidden_states: torch.Tensor,
                cond: Optional[Conditioning] = None, *,
                capture: bool = False, down_only: bool = False,
                conv_in_extra: Optional[torch.Tensor] = None,
                remat: bool = False, remat_policy: Optional[str] = None):
        """sample (B, H, W, C_in) NHWC latents; timesteps scalar or (B,) (a
        device tensor keeps the call free of host-to-device copies);
        encoder_hidden_states (B, L, D_ctx). Returns the eps prediction
        (B, H, W, C_out), and with capture=True also {attn1 layer name:
        self-attention input (B, S, C)}; with down_only=True (the ControlNet
        trunk) (skips, mid output, temb), `conv_in_extra` added to conv_in's
        output. remat=True (training) recomputes blocks in the backward
        under `remat_policy` (None is "full"; see `resolve_remat_policy`)."""
        cfg = self.cfg
        if self.encoder_only and not down_only:
            raise ValueError("an encoder-only UNet runs with down_only=True")
        resnet_fn, transformer_fn = self._resnet, self._transformer2d
        policy = resolve_remat_policy(remat_policy)
        if remat and not capture and policy is not None:
            kw = dict(use_reentrant=False)
            if policy.context_fn is not None:
                kw["context_fn"] = policy.context_fn
            if not policy.saves_conv:

                def resnet_fn(p, x, temb):
                    return checkpoint(self._resnet, p, x, temb, **kw)

            def transformer_fn(p, x, context, prefix, cond, captured):
                return checkpoint(self._transformer2d, p, x, context, prefix,
                                  cond, None, **kw)

        cond = cond if cond is not None else Conditioning()
        b = sample.shape[0]
        ts = torch.as_tensor(timesteps, device=sample.device).reshape(-1)
        ts = ts.expand(b)
        t_emb = timestep_embedding(ts, cfg.block_out_channels[0],
                                   flip_sin_to_cos=cfg.flip_sin_to_cos,
                                   freq_shift=cfg.freq_shift)
        te = self.time_embedding
        temb = te.linear_2(F.silu(te.linear_1(t_emb.to(sample.dtype))))
        captured: Optional[Dict[str, torch.Tensor]] = {} if capture else None
        context = encoder_hidden_states.to(sample.dtype)

        h = self.conv_in(sample)
        if conv_in_extra is not None:
            # the ControlNet's conditioning embedding joins the trunk here
            h = h + conv_in_extra.to(h.dtype)
        skips = [h]
        for i, block in enumerate(self.down_blocks):
            for j, rp in enumerate(block.resnets):
                h = resnet_fn(rp, h, temb)
                if cfg.down_block_has_attn[i]:
                    h = transformer_fn(block.attentions[j], h, context,
                                       f"down_blocks.{i}.attentions.{j}",
                                       cond, captured)
                skips.append(h)
            if hasattr(block, "downsamplers"):
                h = block.downsamplers[0].conv(h)
                skips.append(h)

        mid = self.mid_block
        h = resnet_fn(mid.resnets[0], h, temb)
        h = transformer_fn(mid.attentions[0], h, context,
                           "mid_block.attentions.0", cond, captured)
        h = resnet_fn(mid.resnets[1], h, temb)
        if down_only:
            return skips, h, temb

        # the ControlNet's residuals, added in the compute dtype
        if cond.down_block_residuals is not None:
            skips = [s + r.to(s.dtype)
                     for s, r in zip(skips, cond.down_block_residuals)]
        if cond.mid_block_residual is not None:
            h = h + cond.mid_block_residual.to(h.dtype)

        for i, block in enumerate(self.up_blocks):
            for j, rp in enumerate(block.resnets):
                h = torch.cat([h, skips.pop()], dim=-1)
                h = resnet_fn(rp, h, temb)
                if cfg.up_block_has_attn[i]:
                    h = transformer_fn(block.attentions[j], h, context,
                                       f"up_blocks.{i}.attentions.{j}",
                                       cond, captured)
            if hasattr(block, "upsamplers"):
                h = block.upsamplers[0].conv(h)

        h = group_norm_act(h, self.conv_norm_out.weight,
                           self.conv_norm_out.bias,
                           num_groups=cfg.norm_num_groups, eps=cfg.norm_eps,
                           act="silu")
        h = self.conv_out(h)
        if capture:
            return h, captured
        return h

    def attention_block(self, layer_name: str) -> TransformerBlock:
        """The transformer block that owns `layer_name`."""
        parts = layer_name.split(".")
        if parts[0] == "mid_block":
            tp = self.mid_block.attentions[0]
        else:
            tp = getattr(self, parts[0])[int(parts[1])].attentions[int(parts[3])]
        return tp.transformer_blocks[int(parts[-3])]


# the matmuls of the "dots" policy as the dispatcher sees them (F.linear
# and einsum lower to these), the JAX package's `dots_saveable`
DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
           torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default)
# the named saves of "names": the flash forward's outputs (out, and the
# LSE and O2 its backward reads), `rematsave_attn` of the JAX package
NAMED_SAVE_OPS = (torch.ops.imagdressing_tpu_torch.flash_fwd_res.default,)
REMAT_POLICIES = ("full", "dots", "names", "heavy", "none")


class RematPolicy:
    """A resolved remat policy: `context_fn` for `torch.utils.checkpoint`
    (None: save nothing, "full"), and whether conv1 outputs are saved.

    `saves_conv` ("names", "heavy") runs the resnets outside any
    checkpoint: `GnSiluConv3x3Function` saves only its inputs and recomputes
    its chain in its own backward, so an unchecked resnet keeps exactly the
    block input, conv1's output (JAX's `rematsave_conv`) and the small
    temb projection's input, and no GN+conv kernel runs again in the
    backward. A checkpoint that saved conv1's output would still re-launch
    conv2's kernel, which the recompute has to pass through."""

    def __init__(self, dots: bool, names: bool):
        self.saves_conv = names
        save = (DOT_OPS if dots else ()) + (NAMED_SAVE_OPS if names else ())
        self.context_fn: Optional[Callable] = None
        if save:
            self.context_fn = functools.partial(
                create_selective_checkpoint_contexts,
                functools.partial(_save_ops, frozenset(save)))


def _save_ops(save, ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in save \
        else CheckpointPolicy.PREFER_RECOMPUTE


def resolve_remat_policy(name: Optional[str]) -> Optional[RematPolicy]:
    """The training remat knob (`TrainConfig.remat_policy`), with the JAX
    package's meanings (`imagdressing_tpu/models/unet.py:
    resolve_remat_policy`):

      "full" (or None): save nothing inside a block; the whole block
              forward re-runs in the backward. Least memory.
      "dots": save every matmul output (q/k/v/out projections, proj_in /
              proj_out, both feed-forward matmuls, the time-embedding
              projections, the plain attention's products). The GN+conv
              and flash kernels re-run.
      "names": save the resnet conv1 outputs and the self-attention's flash
              forward outputs; linears re-run, the GN+conv and flash
              forwards do not.
      "heavy": "dots" plus "names": the recompute holds no conv and no
              flash forward, only norms and elementwise chains.
      "none": no recompute (returns None).

    The cross-attention's output is not saved under "names": its plain
    backward needs the softmax probabilities, which the recompute rebuilds
    from q and k anyway, so the save would cost memory and spare no op."""
    if name not in (None,) + REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {name!r} "
                         "(full | dots | names | heavy | none)")
    if name == "none":
        return None
    return RematPolicy(dots=name in ("dots", "heavy"),
                       names=name in ("names", "heavy"))


# ---------------------------------------------------------------------------
# Garment K/V: the hoisted CacheAttnProcessor path
# ---------------------------------------------------------------------------


class RefAdapter(nn.Module):
    """Trainable to_k_ref / to_v_ref of one self-attention layer."""

    def __init__(self, dim: int):
        super().__init__()
        self.to_k_ref = Linear(dim, dim, bias=False)
        self.to_v_ref = Linear(dim, dim, bias=False)


class RefAdapters(nn.ModuleDict):
    """The per-layer adapters, keyed by `adapter_key(layer name)`; calling it
    is `precompute_ref_kv`, so that `torch.func.functional_call` can run it
    on cast copies of its weights (the trainer's mixed precision)."""

    def forward(self, captured: Dict[str, torch.Tensor]) -> KV:
        return precompute_ref_kv(self, captured)


def init_ref_adapters_from_unet(unet: UNet) -> RefAdapters:
    """Adapters initialised from the UNet's own attn1 to_k/to_v (the
    reference's training init). The weights are cloned, never shared: the
    adapters train while the UNet stays frozen."""
    out = RefAdapters()
    for name in attn_layer_names(unet.cfg, "attn1"):
        attn1 = unet.attention_block(name).attn1
        ad = RefAdapter(attn1.to_k.weight.shape[0]).to(attn1.to_k.weight)
        with torch.no_grad():
            ad.to_k_ref.weight.copy_(attn1.to_k.weight)
            ad.to_v_ref.weight.copy_(attn1.to_v.weight)
        out[adapter_key(name)] = ad
    return out


def precompute_ref_kv(adapters: nn.ModuleDict,
                      captured: Dict[str, torch.Tensor]) -> KV:
    """Project the captured garment hidden states to per-layer K/V once."""
    out = {}
    for name, hidden in captured.items():
        ad = adapters[adapter_key(name)]
        out[name] = (ad.to_k_ref(hidden), ad.to_v_ref(hidden))
    return out


def precompute_cross_kv(unet: UNet, encoder_hidden_states: torch.Tensor
                        ) -> KV:
    """Text K/V per cross-attention layer, constant across the steps (the
    down and mid layers only of an encoder-only UNet)."""
    out = {}
    for name in attn_layer_names(unet.cfg, "attn2"):
        if unet.encoder_only and name.startswith("up_blocks"):
            continue
        attn2 = unet.attention_block(name).attn2
        out[name] = (attn2.to_k(encoder_hidden_states),
                     attn2.to_v(encoder_hidden_states))
    return out


# ---------------------------------------------------------------------------
# IP-Adapter K/V (IP-Adapter-FaceID-Plus: to_k_ip / to_v_ip per attn2 layer)
# ---------------------------------------------------------------------------


class IPAdapter(nn.Module):
    """to_k_ip / to_v_ip of one cross-attention layer: face tokens
    (cross_attention_dim) to the layer's channels."""

    def __init__(self, context_dim: int, dim: int):
        super().__init__()
        self.to_k_ip = Linear(context_dim, dim, bias=False)
        self.to_v_ip = Linear(context_dim, dim, bias=False)


class IPAdapters(nn.ModuleDict):
    """The per-layer IP adapters, keyed by `adapter_key(attn2 layer name)`."""

    def __init__(self, cfg: UNetConfig):
        dims = attn_layer_dims(cfg)
        super().__init__({
            adapter_key(name): IPAdapter(cfg.cross_attention_dim, dims[name])
            for name in attn_layer_names(cfg, "attn2")})
        self.cfg = cfg


def precompute_ip_kv(adapters: IPAdapters, ip_tokens: torch.Tensor) -> KV:
    """Per-cross-attention-layer IP K/V of the face tokens (B, n, D_ctx),
    once before the sampling loop."""
    out = {}
    for name in attn_layer_names(adapters.cfg, "attn2"):
        ad = adapters[adapter_key(name)]
        out[name] = (ad.to_k_ip(ip_tokens), ad.to_v_ip(ip_tokens))
    return out
