"""SCHP human-parsing network (AugmentCE2P: ResNet-101 + PSP + edge branch +
decoder + fusion) in PyTorch, NHWC.

Port of `imagdressing_tpu/preprocess/parsing/model.py` (`apply`, `init`,
`convert_torch`):

  stem: 3x conv3x3 (3->64 s2, 64->64, 64->128) each + ABN, maxpool3x3 s2
  layer1..4: bottlenecks [3, 4, 23, 3]; layer4 stride 1 dilation 2
  PSP(2048->512, sizes 1/2/3/6) -> decoder(512 + layer1) -> seg logits
  edge branch over layer1/2/3; fusion(cat(parsing_fea 256, edge_fea 768))

Every norm is an InPlaceABN (activation "none" inside the residual blocks,
leaky_relu 0.01 elsewhere). In inference form it is run by K7
(`kernels/fused_bn_act.abn_inference`): 119 launches per forward. Passing a
`BNTrainCtx` to `SCHP.forward` selects the train mode of the fine-tune
(`_abn` with `BNTrainCtx` in the JAX package): batch statistics through
`abn_train_stats` (one K7 launch each for the apply), synced over the
context's process group, each ABN's (module, mean, var) collected for the
running-statistics EMA. The convs
are cuDNN through `ops.nn.conv2d` (XLA convs outside any Pallas kernel in
the JAX package). Weights are OIHW in channels_last memory, so each conv
writes a dense NHWC tensor and K7 reads it without a copy.

Module attribute paths follow the JAX tree's keys (`fushion` as the
reference spells it), so `convert.parsing_params_from_jax` loads
`schp.init`'s tree unchanged; `load_schp_state_dict` maps the reference
checkpoints' names (`exp-schp-201908301523-atr.pth`, or the ONNX exports'
initializers) onto the module.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from imagdressing_tpu_torch.kernels.fused_bn_act import (
    abn_inference,
    abn_train_stats,
)
from imagdressing_tpu_torch.ops.nn import Conv2d
from imagdressing_tpu_torch.pipelines.dressing import resolve_device

LAYERS = (3, 4, 23, 3)
NUM_CLASSES_ATR = 18
NUM_CLASSES_LIP = 20


@dataclasses.dataclass
class BNTrainCtx:
    """Train-mode batch norm for one forward: batch statistics (averaged
    over `group`, a torch.distributed process group, where given:
    InPlaceABNSync) in place of the running ones; each ABN appends
    (module, mean, var) to `stats`."""

    group: object = None
    stats: List = dataclasses.field(default_factory=list)


class ABN(nn.Module):
    """InPlaceABN: affine parameters and running statistics, folded and
    applied by K7; with a `BNTrainCtx`, batch statistics instead."""

    def __init__(self, c: int, activation: str):
        super().__init__()
        self.activation = activation
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x: torch.Tensor,
                ctx: Optional[BNTrainCtx] = None) -> torch.Tensor:
        if ctx is None:
            return abn_inference(x, self.weight, self.bias,
                                 self.running_mean, self.running_var,
                                 activation=self.activation)
        y, mean, var = abn_train_stats(x, self.weight, self.bias,
                                       activation=self.activation,
                                       group=ctx.group)
        ctx.stats.append((self, mean, var))
        return y


def _conv(cin: int, cout: int, k: int, *, stride: int = 1, padding: int = 0,
          dilation: int = 1, bias: bool = False) -> Conv2d:
    return Conv2d(cin, cout, k, stride=stride, padding=padding,
                  dilation=dilation, bias=bias)


class ConvABN(nn.Module):
    """conv (no bias) -> ABN; the JAX tree's {"conv": ..., "bn": ...}."""

    def __init__(self, cin: int, cout: int, k: int = 1, *, stride: int = 1,
                 padding: int = 0, activation: str = "leaky_relu"):
        super().__init__()
        self.conv = _conv(cin, cout, k, stride=stride, padding=padding)
        self.bn = ABN(cout, activation)

    def forward(self, x: torch.Tensor,
                ctx: Optional[BNTrainCtx] = None) -> torch.Tensor:
        return self.bn(self.conv(x), ctx)


class Bottleneck(nn.Module):
    def __init__(self, inplanes: int, planes: int, *, stride: int,
                 dilation: int, downsample: bool):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 1)
        self.bn1 = ABN(planes, "none")
        self.conv2 = _conv(planes, planes, 3, stride=stride, padding=dilation,
                           dilation=dilation)
        self.bn2 = ABN(planes, "none")
        self.conv3 = _conv(planes, planes * 4, 1)
        self.bn3 = ABN(planes * 4, "none")
        self.downsample = (ConvABN(inplanes, planes * 4, stride=stride,
                                   activation="none") if downsample else None)

    def forward(self, x: torch.Tensor,
                ctx: Optional[BNTrainCtx] = None) -> torch.Tensor:
        out = _relu(self.bn1(self.conv1(x), ctx), ctx)
        out = _relu(self.bn2(self.conv2(out), ctx), ctx)
        out = self.bn3(self.conv3(out), ctx)
        if self.downsample is not None:
            x = self.downsample(x, ctx)
        return _relu(out + x if ctx is not None else out.add_(x), ctx)


def _relu(x: torch.Tensor, ctx: Optional[BNTrainCtx]) -> torch.Tensor:
    """In place for inference; out of place in train mode, where autograd
    keeps the ABN's output for its backward."""
    return F.relu_(x) if ctx is None else F.relu(x)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def resize_align_corners(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Bilinear, align_corners=True, NHWC (`_resize_bilinear` of the JAX
    package; torch F.interpolate in the reference)."""
    if x.shape[1:3] == (h, w):
        return x
    return _nhwc(F.interpolate(_nchw(x), size=(h, w), mode="bilinear",
                               align_corners=True))


class PSP(nn.Module):
    def __init__(self):
        super().__init__()
        self.stages = nn.ModuleList(ConvABN(2048, 512) for _ in range(4))
        self.bottleneck = ConvABN(2048 + 4 * 512, 512, 3, padding=1)

    def forward(self, x5: torch.Tensor,
                ctx: Optional[BNTrainCtx] = None) -> torch.Tensor:
        h, w = x5.shape[1:3]
        priors = []
        for stage, size in zip(self.stages, (1, 2, 3, 6)):
            # torch's floor/ceil bins are the JAX `_adaptive_avg_pool`'s
            pooled = _nhwc(F.adaptive_avg_pool2d(_nchw(x5), size))
            priors.append(resize_align_corners(stage(pooled, ctx), h, w))
        priors.append(x5)
        return self.bottleneck(torch.cat(priors, dim=-1), ctx)


class Edge(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = ConvABN(256, 256)
        self.conv2 = ConvABN(512, 256)
        self.conv3 = ConvABN(1024, 256)
        self.conv4 = _conv(256, 2, 3, padding=1, bias=True)
        self.conv5 = _conv(6, 2, 1, bias=True)

    def forward(self, x2, x3, x4, ctx: Optional[BNTrainCtx] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        lh, lw = x2.shape[1:3]
        e1f, e2f, e3f = (self.conv1(x2, ctx), self.conv2(x3, ctx),
                         self.conv3(x4, ctx))
        e1, e2, e3 = self.conv4(e1f), self.conv4(e2f), self.conv4(e3f)
        e2f, e3f = (resize_align_corners(t, lh, lw) for t in (e2f, e3f))
        e2, e3 = (resize_align_corners(t, lh, lw) for t in (e2, e3))
        edge_logits = self.conv5(torch.cat([e1, e2, e3], dim=-1))
        return edge_logits, torch.cat([e1f, e2f, e3f], dim=-1)


class Decoder(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = ConvABN(512, 256)
        self.conv2 = ConvABN(256, 48)
        self.conv3a = ConvABN(304, 256)
        self.conv3b = ConvABN(256, 256)

    def forward(self, context: torch.Tensor, x2: torch.Tensor,
                ctx: Optional[BNTrainCtx] = None) -> torch.Tensor:
        lh, lw = x2.shape[1:3]
        xt = resize_align_corners(self.conv1(context, ctx), lh, lw)
        xd = torch.cat([xt, self.conv2(x2, ctx)], dim=-1)
        return self.conv3b(self.conv3a(xd, ctx), ctx)


class Fusion(nn.Module):
    def __init__(self, num_classes: int):
        super().__init__()
        self.conv1 = ConvABN(256 + 768, 256)
        self.conv2 = _conv(256, num_classes, 1, bias=True)

    def forward(self, x: torch.Tensor,
                ctx: Optional[BNTrainCtx] = None) -> torch.Tensor:
        return self.conv2(self.conv1(x, ctx))


class SCHP(nn.Module):
    """image (B, H, W, 3) normalized -> (fusion_logits (B, H/4, W/4,
    num_classes), edge_logits (B, H/4, W/4, 2)): `schp.apply` in inference
    mode, or in the fine-tune's train mode with a `BNTrainCtx`. The ONNX
    wrapper of the reference consumes the fusion logits."""

    def __init__(self, num_classes: int = NUM_CLASSES_ATR):
        super().__init__()
        self.conv1 = _conv(3, 64, 3, stride=2, padding=1)
        self.bn1 = ABN(64, "none")
        self.conv2 = _conv(64, 64, 3, padding=1)
        self.bn2 = ABN(64, "none")
        self.conv3 = _conv(64, 128, 3, padding=1)
        self.bn3 = ABN(128, "none")
        inplanes = 128
        for li, (blocks, planes, stride, dilation) in enumerate(
                zip(LAYERS, (64, 128, 256, 512), (1, 2, 2, 1), (1, 1, 1, 2))):
            layer = nn.ModuleList()
            for bi in range(blocks):
                layer.append(Bottleneck(
                    inplanes if bi == 0 else planes * 4, planes,
                    stride=stride if bi == 0 else 1, dilation=dilation,
                    downsample=bi == 0))
            setattr(self, f"layer{li + 1}", layer)
            inplanes = planes * 4
        self.context_encoding = PSP()
        self.edge = Edge()
        self.decoder = Decoder()
        self.fushion = Fusion(num_classes)

    @property
    def num_classes(self) -> int:
        return self.fushion.conv2.weight.shape[0]

    def forward(self, image: torch.Tensor,
                bn_ctx: Optional[BNTrainCtx] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        ctx = bn_ctx
        x = _relu(self.bn1(self.conv1(image), ctx), ctx)
        x = _relu(self.bn2(self.conv2(x), ctx), ctx)
        x = _relu(self.bn3(self.conv3(x), ctx), ctx)
        # maxpool 3x3 s2 p1; torch pads with -inf as the JAX reduce_window
        x = _nhwc(F.max_pool2d(_nchw(x), 3, stride=2, padding=1))
        feats = []
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            for block in layer:
                x = block(x, ctx)
            feats.append(x)
        x2, x3, x4, x5 = feats
        context = self.context_encoding(x5, ctx)
        xd = self.decoder(context, x2, ctx)
        edge_logits, edge_fea = self.edge(x2, x3, x4, ctx)
        fusion_logits = self.fushion(torch.cat([xd, edge_fea], dim=-1), ctx)
        return fusion_logits, edge_logits


def init(seed: int, num_classes: int = NUM_CLASSES_ATR,
         device: Union[str, torch.device] = "cuda") -> SCHP:
    """Random SCHP with the JAX `init`'s shapes and distribution: convs
    N(0, 0.05), conv biases 0, BN identity (weight 1, bias 0, mean 0,
    var 1). Drawn from a torch.Generator on `device`: one seed gives other
    numbers on the CPU and on a card, and other numbers than the JAX init.
    Raises for CUDA on a host without a card."""
    device = resolve_device(device)
    with torch.device(device):
        net = SCHP(num_classes)
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, Conv2d):
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen,
                                           device=device) * 0.05)
                if m.bias is not None:
                    m.bias.zero_()
    return net.eval().requires_grad_(False)


# module path -> the reference checkpoint's name (the inverse of the JAX
# `convert_torch` reading order)
_REFERENCE_NAMES = (
    (r"^(layer\d\.\d+\.downsample)\.conv\.", r"\1.0."),
    (r"^(layer\d\.\d+\.downsample)\.bn\.", r"\1.1."),
    (r"^context_encoding\.stages\.(\d)\.conv\.",
     r"context_encoding.stages.\1.1."),
    (r"^context_encoding\.stages\.(\d)\.bn\.",
     r"context_encoding.stages.\1.2."),
    (r"^context_encoding\.bottleneck\.conv\.",
     "context_encoding.bottleneck.0."),
    (r"^context_encoding\.bottleneck\.bn\.", "context_encoding.bottleneck.1."),
    (r"^(edge|decoder)\.conv(\d)\.conv\.", r"\1.conv\2.0."),
    (r"^(edge|decoder)\.conv(\d)\.bn\.", r"\1.conv\2.1."),
    (r"^decoder\.conv3a\.conv\.", "decoder.conv3.0."),
    (r"^decoder\.conv3a\.bn\.", "decoder.conv3.1."),
    (r"^decoder\.conv3b\.conv\.", "decoder.conv3.2."),
    (r"^decoder\.conv3b\.bn\.", "decoder.conv3.3."),
    (r"^fushion\.conv1\.conv\.", "fushion.0."),
    (r"^fushion\.conv1\.bn\.", "fushion.1."),
    (r"^fushion\.conv2\.", "fushion.3."),
)


def reference_name(key: str) -> str:
    """A module state-dict key -> the SCHP checkpoint's name for it."""
    for pattern, repl in _REFERENCE_NAMES:
        new, n = re.subn(pattern, repl, key)
        if n:
            return new
    return key


def load_schp_state_dict(sd: Mapping[str, object],
                         num_classes: int = NUM_CLASSES_ATR,
                         device: Union[str, torch.device] = "cuda") -> SCHP:
    """An SCHP checkpoint's state dict (torch tensors or numpy arrays,
    `module.` prefixes allowed, extra keys ignored) -> SCHP, the
    counterpart of the JAX `convert_torch`. The checkpoint's OIHW conv
    weights load into the module's channels_last parameters unchanged."""
    sd = {k[len("module."):] if k.startswith("module.") else k: v
          for k, v in sd.items()}
    got = np.asarray(sd["fushion.3.weight"]).shape[0]
    if got != num_classes:
        raise ValueError(f"checkpoint produces {got} classes, caller "
                         f"expects {num_classes}")
    with torch.device(resolve_device(device)):
        net = SCHP(num_classes)
    state: Dict[str, torch.Tensor] = {}
    for key in net.state_dict():
        name = reference_name(key)
        if name not in sd:
            raise KeyError(f"SCHP checkpoint has no {name!r} (for {key})")
        v = sd[name]
        state[key] = (v if isinstance(v, torch.Tensor)
                      else torch.from_numpy(np.array(v))).float()
    net.load_state_dict(state)
    return net.eval().requires_grad_(False)


def check_num_classes(net: Optional[SCHP], num_classes: int) -> None:
    """The JAX `apply`'s guard: a net whose logit width is not the one the
    caller expects fails loudly."""
    if net is not None and net.num_classes != num_classes:
        raise ValueError(f"net produces {net.num_classes} classes, caller "
                         f"expects {num_classes}")
