"""Typed configuration tree of the PyTorch port.

Field-for-field copy of `imagdressing_tpu/core/config.py` for the modules the
port carries; the port keeps its own copy so that it never imports the JAX
package. Dtypes are `torch.dtype`s.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """SD1.5-class UNet2DConditionModel architecture."""

    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    down_block_has_attn: Tuple[bool, ...] = (True, True, True, False)
    cross_attention_dim: int = 768
    attention_num_heads: int = 8
    transformer_layers_per_block: int = 1
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    freq_shift: int = 0
    flip_sin_to_cos: bool = True

    @property
    def up_block_has_attn(self) -> Tuple[bool, ...]:
        return tuple(reversed(self.down_block_has_attn))

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """AutoencoderKL (`stabilityai/sd-vae-ft-mse`) architecture."""

    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    norm_eps: float = 1e-6
    scaling_factor: float = 0.18215


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    """CLIP ViT-L/14 text tower (SD1.5 text encoder)."""

    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    """CLIP ViT-H/14 vision tower (the IP-Adapter image encoder)."""

    hidden_size: int = 1280
    intermediate_size: int = 5120
    num_layers: int = 32
    num_heads: int = 16
    image_size: int = 224
    patch_size: int = 14
    layer_norm_eps: float = 1e-5
    hidden_act: str = "gelu"
    projection_dim: int = 1024

    @property
    def seq_len(self) -> int:
        return (self.image_size // self.patch_size) ** 2 + 1


@dataclasses.dataclass(frozen=True)
class ResamplerConfig:
    """Perceiver resampler producing the cloth prompt tokens."""

    dim: int = 768
    depth: int = 4
    dim_head: int = 64
    heads: int = 12
    num_queries: int = 16
    embedding_dim: int = 1280
    output_dim: int = 768
    ff_mult: int = 4


@dataclasses.dataclass(frozen=True)
class ProjPlusConfig:
    """IP-Adapter-FaceID-Plus projector: the id embedding to `num_tokens`
    face tokens, refined by a Perceiver over the face crop's CLIP-H states."""

    cross_attention_dim: int = 768
    id_embeddings_dim: int = 512
    clip_embeddings_dim: int = 1280
    num_tokens: int = 4
    depth: int = 4
    dim_head: int = 64
    ff_mult: int = 4


@dataclasses.dataclass(frozen=True)
class ControlNetConfig:
    """SD1.5 ControlNet (the openpose and inpaint variants share it; both
    take a 3-channel condition image, inpaint marks masked pixels with -1).
    The trunk is the UNet's encoder half with `unet`'s architecture."""

    conditioning_channels: int = 3
    conditioning_embedding_channels: Tuple[int, ...] = (16, 32, 96, 256)
    unet: UNetConfig = dataclasses.field(default_factory=UNetConfig)


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """DDIM schedule hyperparameters (inference defaults)."""

    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    steps_offset: int = 1
    set_alpha_to_one: bool = False
    timestep_spacing: str = "leading"
    rescale_betas_zero_snr: bool = False
    prediction_type: str = "epsilon"


@dataclasses.dataclass(frozen=True)
class DTypePolicy:
    """Mixed-precision policy: bf16 compute, fp32 norm statistics and softmax
    accumulation (the kernels accumulate in fp32 whatever the input type)."""

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    norm_dtype: torch.dtype = torch.float32



@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """One preset == one reference entry script. `control_guidance_start` /
    `_end` window the ControlNet per step (step i of n keeps its residuals
    iff start <= i/n and (i+1)/n <= end); `eta` is the DDIM variance (0:
    deterministic; the multistep samplers take none); `sampler` is "ddim",
    "dpm2m" (DPM-Solver++(2M)) or "unipc"; `lora_scale` is folded into the
    weights by whoever loads a LoRA checkpoint (`conditioning.fold_lora`),
    not by the pipeline."""

    name: str = "basic"
    height: int = 640
    width: int = 512
    num_inference_steps: int = 50
    guidance_scale: float = 7.5
    image_scale: float = 1.0
    ipa_scale: float = 0.0
    lora_scale: float = 0.0
    controlnet_conditioning_scale: float = 1.0
    control_guidance_start: float = 0.0
    control_guidance_end: float = 1.0
    eta: float = 0.0
    clip_skip: int = 0
    use_controlnet: bool = False
    use_ipa: bool = False
    use_inpaint: bool = False
    strength: float = 1.0
    seed: int = 42
    sampler: str = "ddim"


PRESETS = {
    "basic": PipelineConfig(name="basic"),
    # the same graph as basic, another checkpoint
    "cartoon": PipelineConfig(name="cartoon"),
    # + the openpose ControlNet
    "pose": PipelineConfig(name="pose", use_controlnet=True),
    # + IP-Adapter-FaceID-Plus
    "ipa_pose": PipelineConfig(name="ipa_pose", use_controlnet=True,
                               use_ipa=True, guidance_scale=7.0,
                               image_scale=0.9, ipa_scale=0.9,
                               lora_scale=0.2),
    # + the inpaint ControlNet and the mask recomposition
    "inpaint": PipelineConfig(name="inpaint", use_controlnet=True,
                              use_inpaint=True, height=512, width=512,
                              guidance_scale=5.0, strength=0.99),
}
SAMPLERS = ("ddim", "dpm2m", "unipc")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters (reference run.sh:4-19 + train.py defaults),
    field for field as the JAX package's `TrainConfig`. The port runs
    `remat_policy` "full" (block recompute) and "none"; the selective
    policies "dots", "names" and "heavy" are not ported."""

    learning_rate: float = 5e-5
    weight_decay: float = 1e-2
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    max_grad_norm: float = 1.0  # zero_stage2_config.json:23
    warmup_steps: int = 2000
    train_batch_size: int = 5  # per device
    gradient_accumulation_steps: int = 1
    noise_offset: float = 0.05  # train.py:92,530-535
    snr_gamma: Optional[float] = None  # min-SNR weighting (train.py:575-598)
    num_train_steps: int = 200_000
    checkpointing_steps: int = 2000
    resolution_h: int = 640
    resolution_w: int = 512
    # CFG dropout probabilities (IGPair.py:61-69)
    drop_image_prob: float = 0.05
    drop_text_prob: float = 0.05
    drop_both_prob: float = 0.05
    seed: int = 42
    remat_policy: str = "full"
    # parallelism
    data_axis: str = "data"
    shard_optimizer_states: bool = True  # ZeRO-2 equivalent
