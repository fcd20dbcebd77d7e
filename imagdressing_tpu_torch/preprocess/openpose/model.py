"""The CMU CPM pose networks (the OpenPose body, hand and face models) in
PyTorch, NHWC. Port of `imagdressing_tpu/preprocess/openpose/model.py`
(the body net; the hand and face nets in `hand.py` / `face.py` share the
`CPMNet` base here).

Body: a VGG-style trunk (conv1_1 .. conv4_4_CPM, three 2x2 VALID max pools,
stride 8, 128-channel features F), stage 1 as two branches over F (PAF 38
channels, heatmap 19), stages 2-6 as two branches over concat(PAF, heat, F)
(185 channels) with 7x7 convs. No ReLU after a branch's last conv.

The convs are cuDNN (`ops.nn.Conv2d`, OIHW in channels_last memory): the
JAX package runs them as XLA convs, outside any Pallas kernel. Each conv is
a submodule named as the JAX tree's layer, so `state_dict_from_jax` (through
`convert.openpose_params_from_jax`) loads the JAX tree and
`load_reference_state_dict` the reference's `.pth` files, whose keys are
bare (`conv1_1.weight`) or prefixed (`model0.conv1_1.weight`).
"""

from __future__ import annotations

from typing import List, Mapping, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from imagdressing_tpu_torch.ops.nn import Conv2d

Device = Union[str, torch.device]
Layer = Tuple[str, int, int, int]  # (name, in, out, kernel); "pool" = 2x2

TRUNK: List[Layer] = [
    ("conv1_1", 3, 64, 3), ("conv1_2", 64, 64, 3), ("pool", 0, 0, 0),
    ("conv2_1", 64, 128, 3), ("conv2_2", 128, 128, 3), ("pool", 0, 0, 0),
    ("conv3_1", 128, 256, 3), ("conv3_2", 256, 256, 3),
    ("conv3_3", 256, 256, 3), ("conv3_4", 256, 256, 3), ("pool", 0, 0, 0),
    ("conv4_1", 256, 512, 3), ("conv4_2", 512, 512, 3),
    ("conv4_3_CPM", 512, 256, 3), ("conv4_4_CPM", 256, 128, 3),
]

PAF_CH, HEAT_CH = 38, 19


def stage1_names(branch: int) -> List[Layer]:
    L = f"L{branch}"
    out = PAF_CH if branch == 1 else HEAT_CH
    return [
        (f"conv5_1_CPM_{L}", 128, 128, 3),
        (f"conv5_2_CPM_{L}", 128, 128, 3),
        (f"conv5_3_CPM_{L}", 128, 128, 3),
        (f"conv5_4_CPM_{L}", 128, 512, 1),
        (f"conv5_5_CPM_{L}", 512, out, 1),
    ]


def stageN_names(stage: int, branch: int) -> List[Layer]:
    L = f"L{branch}"
    out = PAF_CH if branch == 1 else HEAT_CH
    return [
        (f"Mconv1_stage{stage}_{L}", 185, 128, 7),
        (f"Mconv2_stage{stage}_{L}", 128, 128, 7),
        (f"Mconv3_stage{stage}_{L}", 128, 128, 7),
        (f"Mconv4_stage{stage}_{L}", 128, 128, 7),
        (f"Mconv5_stage{stage}_{L}", 128, 128, 7),
        (f"Mconv6_stage{stage}_{L}", 128, 128, 1),
        (f"Mconv7_stage{stage}_{L}", 128, out, 1),
    ]


class CPMNet(nn.Module):
    """A CPM net: one `Conv2d` submodule per named layer of `layers` (in
    the JAX `init`'s order), and `run`, the JAX `_run`."""

    def __init__(self, layers: Sequence[Sequence[Layer]]):
        super().__init__()
        for group in layers:
            for name, cin, cout, k in group:
                if name != "pool":
                    self.add_module(name, Conv2d(cin, cout, k,
                                                 padding=(k - 1) // 2))

    def run(self, layers: Sequence[Layer], x: torch.Tensor, *,
            final_relu_skip: bool) -> torch.Tensor:
        for idx, (name, _, _, _) in enumerate(layers):
            if name == "pool":
                x = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(
                    0, 2, 3, 1)
                continue
            x = getattr(self, name)(x)
            if not (final_relu_skip and idx == len(layers) - 1):
                x = F.relu(x)
        return x

    @classmethod
    def init_random(cls, seed: int, device: Device = "cpu") -> "CPMNet":
        """Every conv with `nn.param_init_conv`'s distribution (weight and
        bias uniform in +-1/sqrt(fan_in)), drawn from one torch.Generator
        on `device` in layer order: other numbers than the JAX init."""
        with torch.device(device):
            net = cls()
        gen = torch.Generator(device=device).manual_seed(seed)
        for m in net.modules():
            if isinstance(m, Conv2d):
                m.reset_parameters(gen)
        return net.eval().requires_grad_(False)

    @classmethod
    def from_state_dict(cls, sd: Mapping[str, object],
                        device: Device = "cpu") -> "CPMNet":
        """A reference checkpoint's state dict (OIHW tensors or arrays)
        -> the net: each key's layer is `key.split(".")[-2]`, as the JAX
        `convert_torch` reads it, so `model0.conv1_1.weight` and
        `conv1_1.weight` both load."""
        state = {}
        for key, v in sd.items():
            parts = key.split(".")
            if parts[-1] not in ("weight", "bias"):
                continue
            t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
                np.array(v))
            state[f"{parts[-2]}.{parts[-1]}"] = t.float()
        with torch.device(device):
            net = cls()
        net.load_state_dict(state)
        return net.eval().requires_grad_(False)


class BodyPoseNet(CPMNet):
    """The body net (`model.py:apply`): image (B, H, W, 3), already
    (pixel / 256 - 0.5) BGR -> (paf (B, H/8, W/8, 38), heatmap (B, H/8,
    W/8, 19))."""

    def __init__(self):
        groups = [TRUNK]
        for branch in (1, 2):
            groups.append(stage1_names(branch))
            groups += [stageN_names(s, branch) for s in range(2, 7)]
        super().__init__(groups)

    def forward(self, image: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        feat = self.run(TRUNK, image, final_relu_skip=False)
        paf = self.run(stage1_names(1), feat, final_relu_skip=True)
        heat = self.run(stage1_names(2), feat, final_relu_skip=True)
        for stage in range(2, 7):
            x = torch.cat([paf, heat, feat], -1)
            paf = self.run(stageN_names(stage, 1), x, final_relu_skip=True)
            heat = self.run(stageN_names(stage, 2), x, final_relu_skip=True)
        return paf, heat
