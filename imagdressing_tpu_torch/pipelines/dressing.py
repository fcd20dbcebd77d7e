"""The virtual-dressing pipeline: one implementation, five presets (port of
`imagdressing_tpu/pipelines/dressing.py`):

  basic    - garment-only dressing
  cartoon  - the same graph, another checkpoint
  pose     - + the openpose ControlNet
  ipa_pose - + IP-Adapter-FaceID-Plus face tokens
  inpaint  - + the inpaint ControlNet and the per-step mask recomposition

each with the DDIM (eta >= 0), DPM-Solver++(2M) or UniPC sampler.

Structure, as in the JAX package: the garment UNet runs once per call in
capture mode; garment, text and IP K/V and the ControlNet's conditioning
embedding are computed once, before the sampling loop; CFG is one batch-2B
UNet call per step with the per-row garment scale [0, s], so only the cond
half sees the garment (the flash kernel skips the garment pass for the
scale-0 rows), and one ControlNet call on the same batch. Inside the loop
no tensor is copied from the host and nothing is read back: timesteps are
device tensors made once, step coefficients are host numbers, the eta noise
comes from a generator on the device.

The device is explicit: every entry point defaults to "cuda" and raises
when no card is present, unless the caller passes device="cpu", which runs
every kernel's plain PyTorch version (the CPU tests do this).

Over several ranks (`mesh`, a `core.mesh.Mesh`, as the JAX package's
(data, model) mesh), every rank builds the pipeline and makes the same
calls: over the data group each rank generates its rows of the batch (a
ragged batch padded with its last row to a multiple of the group, sliced
back after the decode) and the images are gathered to every rank; over the
model group the UNets and their adapters are split (`core/tp.py`). The
eta > 0 noise of each data rank comes from its own stream.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Dict, Iterator, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from imagdressing_tpu_torch.convert import params_from_jax
from imagdressing_tpu_torch.core import mesh as mesh_lib
from imagdressing_tpu_torch.core import profiling
from imagdressing_tpu_torch.core import tp as tp_lib
from imagdressing_tpu_torch.core.config import (
    SAMPLERS,
    CLIPTextConfig,
    CLIPVisionConfig,
    ControlNetConfig,
    PipelineConfig,
    ProjPlusConfig,
    ResamplerConfig,
    SchedulerConfig,
    UNetConfig,
    VAEConfig,
)
from imagdressing_tpu_torch.models.clip import CLIPText, CLIPVision
from imagdressing_tpu_torch.models.conditioning import Conditioning
from imagdressing_tpu_torch.models.controlnet import ControlNet
from imagdressing_tpu_torch.models.resampler import ProjPlus, Resampler
from imagdressing_tpu_torch.models.unet import (
    IPAdapters,
    UNet,
    init_ref_adapters_from_unet,
    precompute_cross_kv,
    precompute_ip_kv,
    precompute_ref_kv,
)
from imagdressing_tpu_torch.models.vae import VAE
from imagdressing_tpu_torch.ops.nn import init_module
from imagdressing_tpu_torch.samplers import ddim, dpm, unipc

Device = Union[str, torch.device]
MODEL_NAMES = ("unet", "ref_unet", "ref_adapters", "resampler", "vae",
               "text", "vision")
# the models of the pose / inpaint (ControlNet) and ipa_pose presets, present
# where the stack was built with them
OPTIONAL_MODEL_NAMES = ("controlnet", "ip_adapters", "proj_plus")
# the reference's requires_grad split (train.py:371-378): the garment UNet,
# its 16 RefS adapters and the cloth Resampler train; the rest is frozen
TRAINABLE_KEYS = ("ref_unet", "ref_adapters", "resampler")


def resolve_device(device: Device) -> torch.device:
    """torch.device(device); raises for CUDA on a host without a card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels")
    return dev


def model_configs(small: bool = False) -> Dict[str, object]:
    """{unet_cfg, vae_cfg, text_cfg, vision_cfg, resampler_cfg,
    projplus_cfg}: the full SD1.5 stack, or the JAX package's `small=True`
    test stack (the ProjPlus config is used where the stack has IP
    adapters)."""
    if not small:
        return dict(unet_cfg=UNetConfig(), vae_cfg=VAEConfig(),
                    text_cfg=CLIPTextConfig(), vision_cfg=CLIPVisionConfig(),
                    resampler_cfg=ResamplerConfig(),
                    projplus_cfg=ProjPlusConfig())
    return dict(
        unet_cfg=UNetConfig(block_out_channels=(16, 32, 64, 64),
                            cross_attention_dim=32, attention_num_heads=4,
                            norm_num_groups=8),
        vae_cfg=VAEConfig(block_out_channels=(16, 16, 32, 32),
                          norm_num_groups=8),
        text_cfg=CLIPTextConfig(vocab_size=256, hidden_size=32,
                                intermediate_size=64, num_layers=2,
                                num_heads=4),
        vision_cfg=CLIPVisionConfig(hidden_size=48, intermediate_size=96,
                                    num_layers=3, num_heads=4, image_size=56,
                                    patch_size=14, projection_dim=32),
        resampler_cfg=ResamplerConfig(dim=32, depth=1, dim_head=8, heads=4,
                                      num_queries=8, embedding_dim=48,
                                      output_dim=32),
        projplus_cfg=ProjPlusConfig(cross_attention_dim=32,
                                    id_embeddings_dim=16,
                                    clip_embeddings_dim=48, num_tokens=4,
                                    depth=1, dim_head=8),
    )


@dataclasses.dataclass
class DressingModels:
    """Every model of the presets, on one device: those of `basic`, and
    where built with them the ControlNet (pose, inpaint) and the IP
    adapters with their ProjPlus projector (ipa_pose)."""

    unet_cfg: UNetConfig
    vae_cfg: VAEConfig
    text_cfg: CLIPTextConfig
    vision_cfg: CLIPVisionConfig
    resampler_cfg: ResamplerConfig
    unet: UNet
    ref_unet: UNet
    ref_adapters: nn.ModuleDict
    resampler: Resampler
    vae: VAE
    text: CLIPText
    vision: CLIPVision
    controlnet: Optional[ControlNet] = None
    ip_adapters: Optional[IPAdapters] = None
    proj_plus: Optional[ProjPlus] = None
    controlnet_cfg: Optional[ControlNetConfig] = None
    projplus_cfg: Optional[ProjPlusConfig] = None

    @classmethod
    def _build(cls, configs: Dict[str, object], device: torch.device,
               with_controlnet: bool = False, with_ipa: bool = False,
               dtype: torch.dtype = torch.float32) -> "DressingModels":
        """The modules of `configs` (`model_configs`' keys) in `dtype` on
        `device`, their parameters allocated and not initialised: built on
        the meta device, then materialised with `to_empty`."""
        cfgs = dict(configs)
        projplus_cfg = cfgs.pop("projplus_cfg")
        ucfg = cfgs["unet_cfg"]
        with torch.device("meta"):
            unet = UNet(ucfg)
            models = dict(
                unet=unet, ref_unet=UNet(ucfg),
                ref_adapters=init_ref_adapters_from_unet(unet),
                resampler=Resampler(cfgs["resampler_cfg"]),
                vae=VAE(cfgs["vae_cfg"]), text=CLIPText(cfgs["text_cfg"]),
                vision=CLIPVision(cfgs["vision_cfg"]))
            if with_controlnet:
                cfgs["controlnet_cfg"] = ControlNetConfig(unet=ucfg)
                models["controlnet"] = ControlNet(cfgs["controlnet_cfg"])
            if with_ipa:
                cfgs["projplus_cfg"] = projplus_cfg
                models["ip_adapters"] = IPAdapters(ucfg)
                models["proj_plus"] = ProjPlus(projplus_cfg)
        for m in models.values():
            m.to(dtype).to_empty(device=device).eval().requires_grad_(False)
        return cls(**cfgs, **models)

    @classmethod
    def init_random(cls, seed: int = 0, *, small: bool = False,
                    with_controlnet: bool = False, with_ipa: bool = False,
                    device: Device = "cuda") -> "DressingModels":
        """Random-weight stack from `torch.Generator(device).manual_seed(seed)`
        (full SD1.5 widths, or the tiny test stack with small=True), with
        the ControlNet and the IP adapters + ProjPlus where asked; the
        `basic` models draw first, so they do not depend on those flags.
        The ref adapters start as clones of the main UNet's attn1
        to_k/to_v; the ControlNet's output convs start at zero."""
        dev = resolve_device(device)
        models = cls._build(model_configs(small), dev, with_controlnet,
                            with_ipa)
        gen = torch.Generator(device=dev).manual_seed(seed)
        for name, module in models.modules().items():
            if name != "ref_adapters":
                init_module(module, gen)
        models.ref_adapters = init_ref_adapters_from_unet(models.unet)
        models.ref_adapters.eval().requires_grad_(False)
        return models

    @classmethod
    def from_state_dicts(cls, state_dicts: Dict[str, Dict[str, torch.Tensor]],
                         configs: Dict[str, object], *,
                         device: Device = "cuda",
                         dtype: torch.dtype = torch.float32
                         ) -> "DressingModels":
        """The stack of `configs` (`model_configs`' keys) holding
        `state_dicts` ({model name: state dict}, as `convert.params_from_jax`
        returns them) in `dtype` on `device`; a `controlnet` / `ip_adapters`
        entry builds those models. No random initialisation: every
        parameter is allocated once and copied from its state dict (strict:
        every model of `MODEL_NAMES` needs one, with matching keys)."""
        missing = [n for n in MODEL_NAMES if n not in state_dicts]
        if missing:
            raise KeyError(f"no state dict for {missing}")
        models = cls._build(configs, resolve_device(device),
                            "controlnet" in state_dicts,
                            "ip_adapters" in state_dicts, dtype)
        for name, sd in state_dicts.items():
            getattr(models, name).load_state_dict(sd)
        return models

    @classmethod
    def from_jax_params(cls, params: Dict[str, object], *,
                        small: bool = False,
                        device: Device = "cuda") -> "DressingModels":
        """Load the JAX package's `DressingModels.params` (nested dicts of
        numpy arrays, see `convert.params_from_jax`) into the port's
        modules; `small` picks the same configs as the JAX stack's, and the
        tree's `controlnet` / `ip_adapters` entries build those models."""
        return cls.from_state_dicts(params_from_jax(params),
                                    model_configs(small), device=device)

    def cast(self, dtype: torch.dtype) -> "DressingModels":
        """Cast every parameter in place (bf16 for production inference);
        returns self."""
        for module in self.modules().values():
            module.to(dtype)
        return self

    def cast_for_training(self, compute_dtype: torch.dtype = torch.bfloat16
                          ) -> "DressingModels":
        """The trainer's precision split, in place: the frozen models in the
        compute dtype, the trainable ones (`TRAINABLE_KEYS`) as fp32 master
        weights; returns self."""
        for name, module in self.modules().items():
            module.to(torch.float32 if name in TRAINABLE_KEYS
                      else compute_dtype)
        return self

    def modules(self) -> Dict[str, nn.Module]:
        """{name: module} for every model present: `MODEL_NAMES`, then those
        of `OPTIONAL_MODEL_NAMES` the stack was built with."""
        names = MODEL_NAMES + tuple(n for n in OPTIONAL_MODEL_NAMES
                                    if getattr(self, n) is not None)
        return {name: getattr(self, name) for name in names}

    @property
    def device(self) -> torch.device:
        return self.unet.conv_in.weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.unet.conv_in.weight.dtype


class _StageClock:
    """Seconds per pipeline stage, in order, each stage a `with
    stage(name)` block and a child span of `pipeline.call` (its host time
    is the time to enqueue it). A stage runs from the end of the one
    before (the first from the clock's start) to its own end. On a card
    the boundaries are CUDA events, read in `finish` after the call's
    final copy to the host, so a stage's time is the device's and no
    stage synchronises the device; on the CPU they are the host clock.
    `device_time(key)` times a block on the card into the innermost open
    span's attribute `key`, while spans record."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.seconds: Dict[str, float] = {}
        self._start = self._now()
        self._ends = []  # (stage, its end)
        self._timed = []  # (span record, attribute, start, end)

    def _now(self):
        if not self.cuda:
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record(torch.cuda.current_stream(self.device))
        return event

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        with profiling.span(name):
            yield
            self._ends.append((name, self._now()))

    def device_time(self, key: str):
        record = profiling.current() \
            if self.cuda and profiling.recording() else None
        return _UNTIMED if record is None else self._time(record, key)

    @contextlib.contextmanager
    def _time(self, record, key: str) -> Iterator[None]:
        start = self._now()
        yield
        self._timed.append((record, key, start, self._now()))

    def finish(self) -> Dict[str, float]:
        """The stages' seconds; call after the call's copy to the host (on
        a card the last event then waits for nothing)."""
        if self.cuda:
            self._ends[-1][1].synchronize()

            def between(a, b):
                return a.elapsed_time(b) / 1e3
        else:
            def between(a, b):
                return b - a
        prev = self._start
        for name, end in self._ends:
            self.seconds[name] = between(prev, end)
            prev = end
        for record, key, start, end in self._timed:
            record["attrs"][key] = between(start, end)
        return self.seconds


_UNTIMED = contextlib.nullcontext()


def resize_nearest(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, h, w, C), nearest, sampling at half-pixel
    centres as `jax.image.resize(..., "nearest")` does: source index
    floor((i + 0.5) * H / h), computed in fp32 (going 16 -> 4 it takes rows
    2, 6, 10, 14; `F.interpolate(mode="nearest")` would take 0, 4, 8, 12)."""

    def index(n_in: int, n_out: int) -> torch.Tensor:
        pos = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) \
            * np.float32(n_in) / np.float32(n_out)
        return torch.from_numpy(np.floor(pos).astype(np.int64)).to(x.device)

    x = x.index_select(1, index(x.shape[1], h))
    return x.index_select(2, index(x.shape[2], w))


def controlnet_keep(n: int, start: float, end: float) -> Tuple[bool, ...]:
    """diffusers' controlnet_keep over the n used steps: step i keeps its
    residuals iff start <= i/n and (i+1)/n <= end (fp32, as the JAX
    pipeline compares them)."""
    lo = np.arange(n, dtype=np.float32) / np.float32(n)
    hi = np.arange(1, n + 1, dtype=np.float32) / np.float32(n)
    off = (lo < np.float32(start)) | (hi > np.float32(end))
    return tuple(bool(not o) for o in off)


def eta_seed(seed: int, shard: Optional[int] = None) -> int:
    """The seed of the eta > 0 noise stream, apart from the one that draws
    the initial latents; data rank `shard`'s own stream under data
    parallelism (rank 0's is one process's: SeedSequence drops a trailing
    zero word)."""
    words = [seed, 0x657461] + ([] if shard is None else [shard])
    return int(np.random.SeedSequence(words).generate_state(
        1, np.uint64)[0])


def _pad_rows(x, n: int):
    """x with its last row repeated to n rows (numpy or a tensor)."""
    if x is None or x.shape[0] == n:
        return x
    extra = n - x.shape[0]
    if torch.is_tensor(x):
        return torch.cat([x, x[-1:].expand(extra, *x.shape[1:])])
    x = np.asarray(x)
    return np.concatenate([x, np.repeat(x[-1:], extra, axis=0)])


class DressingPipeline:
    """Callable dressing pipeline for one preset. The argument names follow
    the JAX package's `DressingPipeline.__call__`; arrays are NHWC. After
    each call `last_stage_seconds` holds each stage's seconds, in order
    (on a card the device's, from CUDA events; on the CPU the host's).
    While a profiler session runs, a call records the spans
    `pipeline.call` (batch, steps, preset), a child per stage, and a
    `denoise.step` per sampling step (`core.profiling.span`)."""

    def __init__(self, models: DressingModels, preset: PipelineConfig,
                 sched_cfg: SchedulerConfig = SchedulerConfig(), *,
                 device: Device = "cuda",
                 mesh: Optional[mesh_lib.Mesh] = None):
        """`mesh`: generate over its ranks; with a model split the
        stack's UNets and adapters are split in place."""
        self.device = resolve_device(device)
        if models.device.type != self.device.type:
            raise ValueError(f"models on {models.device}, pipeline on "
                             f"{self.device}")
        if preset.sampler not in SAMPLERS:
            raise ValueError(f"unknown sampler {preset.sampler!r}; expected "
                             + "/".join(SAMPLERS))
        if preset.use_controlnet and models.controlnet is None:
            raise ValueError(f"preset {preset.name!r} needs a ControlNet "
                             "(init_random(..., with_controlnet=True))")
        if preset.use_ipa and models.ip_adapters is None:
            raise ValueError(f"preset {preset.name!r} needs the IP adapters "
                             "(init_random(..., with_ipa=True))")
        if mesh is not None:
            tp_lib.split_models(models, mesh)
        self.mesh = mesh
        self.models = models
        self.preset = preset
        self.schedule = ddim.make_schedule(sched_cfg)
        self.last_stage_seconds: Dict[str, float] = {}

    def _tensor(self, x, dtype=None) -> torch.Tensor:
        if not torch.is_tensor(x):
            x = torch.tensor(np.asarray(x))  # a copy: inputs may be read-only
        return x.to(device=self.device, dtype=dtype)

    @staticmethod
    def _require(preset: PipelineConfig, **inputs) -> None:
        missing = [k for k, v in inputs.items() if v is None]
        if missing:
            raise ValueError(f"preset {preset.name!r} needs {missing}")

    @torch.inference_mode()
    def __call__(self, *, prompt_ids, negative_prompt_ids, ref_image,
                 ref_clip_image, latents=None, seed: Optional[int] = None,
                 num_inference_steps: Optional[int] = None,
                 guidance_scale: Optional[float] = None,
                 image_scale: Optional[float] = None,
                 controlnet_scale: Optional[float] = None,
                 control_guidance_start: Optional[float] = None,
                 control_guidance_end: Optional[float] = None,
                 eta: Optional[float] = None, pose_image=None,
                 faceid_embeds=None, face_clip_image=None, person_image=None,
                 mask_image=None, output_uint8: bool = False) -> np.ndarray:
        """prompt_ids / negative_prompt_ids (B, 77) int; ref_image (B, H, W,
        3) garment in [-1, 1]; ref_clip_image (B, 224, 224, 3)
        CLIP-normalized; latents (B, H/8, W/8, 4) initial noise, else drawn
        from `torch.Generator(device).manual_seed(seed)` (other numbers
        than the JAX package's `jax.random` for the same seed; so is the
        eta > 0 noise, from a generator seeded by `eta_seed(seed)`).
        pose (B, H, W, 3) in [0, 1]: the ControlNet's condition (pose and
        inpaint); ipa_pose: faceid_embeds (B, id_dim) and face_clip_image
        (B, 224, 224, 3); inpaint: person_image (B, H, W, 3) in [-1, 1] and
        mask_image (B, H, W, 1) in {0, 1} (1 = regenerate). Returns images
        (B, H, W, 3) in [0, 1] float32, or uint8 with output_uint8=True.
        Over a mesh, every rank passes the whole batch and gets every
        image."""
        rows = dict(prompt_ids=prompt_ids,
                    negative_prompt_ids=negative_prompt_ids,
                    ref_image=ref_image, ref_clip_image=ref_clip_image,
                    latents=latents, pose_image=pose_image,
                    faceid_embeds=faceid_embeds,
                    face_clip_image=face_clip_image,
                    person_image=person_image, mask_image=mask_image)
        call = dict(num_inference_steps=num_inference_steps,
                    guidance_scale=guidance_scale, image_scale=image_scale,
                    controlnet_scale=controlnet_scale,
                    control_guidance_start=control_guidance_start,
                    control_guidance_end=control_guidance_end, eta=eta,
                    output_uint8=output_uint8,
                    seed=self.preset.seed if seed is None else seed)
        data = 1 if self.mesh is None else self.mesh.data
        b_user = ref_image.shape[0]
        with profiling.span("pipeline.call", batch=int(b_user),
                            steps=int(num_inference_steps
                                      or self.preset.num_inference_steps),
                            preset=self.preset.name):
            if data == 1:
                return self._generate(**rows, **call)
            b = -(-b_user // data) * data
            if latents is None:
                # the padded global batch's noise, as one device would draw
                # it
                f = 2 ** (len(self.models.vae_cfg.block_out_channels) - 1)
                gen = torch.Generator(device=self.device).manual_seed(
                    call["seed"])
                rows["latents"] = torch.randn(
                    (b, self.preset.height // f, self.preset.width // f, 4),
                    generator=gen, device=self.device)
            lo = self.mesh.data_rank * (b // data)
            local = {k: None if v is None
                     else _pad_rows(v, b)[lo:lo + b // data]
                     for k, v in rows.items()}
            return self._generate(**local, **call,
                                  eta_shard=self.mesh.data_rank,
                                  gather=True)[:b_user]

    def _generate(self, *, prompt_ids, negative_prompt_ids, ref_image,
                  ref_clip_image, latents, seed, num_inference_steps,
                  guidance_scale, image_scale, controlnet_scale,
                  control_guidance_start, control_guidance_end, eta,
                  pose_image, faceid_embeds, face_clip_image, person_image,
                  mask_image, output_uint8, eta_shard=None, gather=False):
        p, m, dev = self.preset, self.models, self.device
        steps = num_inference_steps or p.num_inference_steps
        g = p.guidance_scale if guidance_scale is None else guidance_scale
        s = p.image_scale if image_scale is None else image_scale
        seed = p.seed if seed is None else seed
        eta = float(p.eta if eta is None else eta)
        cd = m.dtype
        sf = m.vae_cfg.scaling_factor
        clock = _StageClock(dev)
        if p.use_controlnet:
            self._require(p, pose_image=pose_image)
        if p.use_ipa:
            self._require(p, faceid_embeds=faceid_embeds,
                          face_clip_image=face_clip_image)
        if p.use_inpaint:
            self._require(p, person_image=person_image, mask_image=mask_image)

        ref_image = self._tensor(ref_image, torch.float32)
        b = ref_image.shape[0]
        if latents is None:
            f = 2 ** (len(m.vae_cfg.block_out_channels) - 1)
            gen = torch.Generator(device=dev).manual_seed(seed)
            latents = torch.randn((b, p.height // f, p.width // f, 4),
                                  generator=gen, device=dev)
        noise = self._tensor(latents, torch.float32)

        # 1. text encoding of [uncond; cond]
        with clock.stage("text"):
            ids = torch.cat([self._tensor(negative_prompt_ids, torch.long),
                             self._tensor(prompt_ids, torch.long)])
            text_embeds = m.text(ids, clip_skip=p.clip_skip).to(cd)
        # 2. garment tokens: CLIP-vision penultimate states -> Resampler
        with clock.stage("garment_tokens"):
            clip_hidden = m.vision(self._tensor(ref_clip_image, cd),
                                   penultimate=True)
            cloth_tokens = m.resampler(clip_hidden)
        # 3. garment latents and the capture run (batch B, t = 0)
        with clock.stage("vae_encode"):
            ref_latents = m.vae.encode_mean(ref_image.to(cd)) * sf
        with clock.stage("garment_unet"):
            _, captured = m.ref_unet(ref_latents, 0, cloth_tokens,
                                     capture=True)
        # 4. K/V hoisted out of the loop, duplicated for the CFG batch
        with clock.stage("kv_precompute"):
            ref_kv = {name: (torch.cat([k, k]), torch.cat([v, v]))
                      for name, (k, v) in precompute_ref_kv(
                          m.ref_adapters, captured).items()}
            ref_scale = torch.cat([torch.zeros(b, device=dev),
                                   torch.full((b,), float(s), device=dev)])
            cond = Conditioning(ref_kv=ref_kv, ref_scale=ref_scale,
                                cross_kv=precompute_cross_kv(m.unet,
                                                             text_embeds))
            if p.use_ipa:
                # face tokens of the cond half; the uncond half's from a
                # zeroed id embedding and a zeroed face crop
                face_clip = self._tensor(face_clip_image, cd)
                faceid = self._tensor(faceid_embeds, cd)
                tokens = [m.proj_plus(fid, m.vision(img, penultimate=True))
                          for fid, img in ((torch.zeros_like(faceid),
                                            torch.zeros_like(face_clip)),
                                           (faceid, face_clip))]
                cond.ip_kv = precompute_ip_kv(m.ip_adapters,
                                              torch.cat(tokens))
                cond.ip_scale = torch.full((2 * b,), float(p.ipa_scale),
                                           device=dev)

        # 5. the schedule; inpaint: truncated by strength, the person latents
        #    and the mask at the latent size
        ts_full = ddim.timesteps(self.schedule, steps)
        t_start = 0
        post_fn: Optional[ddim.PostStepFn] = None
        lat = noise * self.schedule.init_noise_sigma
        if p.use_inpaint:
            with clock.stage("person_encode"):
                t_start = max(steps - int(steps * p.strength), 0)
                image_latents = (m.vae.encode_mean(
                    self._tensor(person_image, cd)) * sf).float()
                if p.strength < 1.0:
                    lat = ddim.add_noise(self.schedule, image_latents, noise,
                                         int(ts_full[t_start]))
                mask = resize_nearest(self._tensor(mask_image, torch.float32),
                                      *lat.shape[1:3])
                keep_mask = 1.0 - mask

                def post_fn(x, t_next, is_last):
                    # re-noise the known region to the next timestep with
                    # the initial noise (the original latents after the last
                    # step) and paste it around the generated region
                    known = image_latents if is_last else ddim.add_noise(
                        self.schedule, image_latents, noise, t_next)
                    return keep_mask * known + mask * x

        ts_used = ts_full[t_start:]
        ts_dev = torch.as_tensor(ts_used.astype(np.int64), device=dev)
        t_of = {int(t): ts_dev[i] for i, t in enumerate(ts_used)}

        # 6. the ControlNet's conditioning embedding, text K/V and window
        control = {}
        if p.use_controlnet:
            with clock.stage("control_embedding"):
                pose = self._tensor(pose_image, torch.float32)
                keep = controlnet_keep(
                    len(ts_used),
                    p.control_guidance_start if control_guidance_start is None
                    else control_guidance_start,
                    p.control_guidance_end if control_guidance_end is None
                    else control_guidance_end)
                control = dict(
                    cn_emb=m.controlnet.cond_embedding(
                        torch.cat([pose, pose])),
                    cn_keep={int(t): k for t, k in zip(ts_used, keep)},
                    cn_scale=float(p.controlnet_conditioning_scale
                                   if controlnet_scale is None
                                   else controlnet_scale),
                    cn_cond=Conditioning(cross_kv=precompute_cross_kv(
                        m.controlnet, text_embeds)))
        eps_fn = self._eps_fn(cond, text_embeds, t_of, g, clock, **control)

        # 7. the sampling loop, a `denoise.step` span a step
        with clock.stage("denoise"):
            if p.sampler == "ddim":
                gen = (torch.Generator(device=dev).manual_seed(
                    eta_seed(seed, eta_shard)) if eta else None)
                ts_next = ddim.next_timesteps(ts_used)
                for i, t in enumerate(ts_used):
                    with profiling.span("denoise.step", t=int(t)):
                        eps = eps_fn(lat, int(t))
                        step_noise = (torch.randn(lat.shape, generator=gen,
                                                  device=dev)
                                      if eta else None)
                        # prev_t from the full step count, also when
                        # truncated
                        lat = ddim.step(self.schedule, eps, int(t), lat,
                                        steps, eta=eta, noise=step_noise)
                        if post_fn is not None:
                            lat = post_fn(lat, int(ts_next[i]),
                                          i == len(ts_used) - 1)
            else:
                loop = unipc.sample_loop if p.sampler == "unipc" \
                    else dpm.sample_loop

                def stepped(x, t):
                    with profiling.span("denoise.step", t=t):
                        return eps_fn(x, t)

                lat = loop(self.schedule, stepped, lat, steps,
                           t_start=t_start, post_fn=post_fn)
        # 8. decode, and the copy to the host that ends the call
        with clock.stage("vae_decode"):
            images = m.vae.decode((lat / sf).to(cd))
            out = (images.float() * 0.5 + 0.5).clamp(0.0, 1.0)
            if output_uint8:
                out = torch.round(out * 255.0).to(torch.uint8)
            if gather:
                out = mesh_lib.all_gather(out, self.mesh.data_group)
            out = out.cpu().numpy()
        self.last_stage_seconds = clock.finish()
        return out

    def _eps_fn(self, cond: Conditioning, text_embeds: torch.Tensor,
                t_of: Dict[int, torch.Tensor], guidance: float,
                clock: _StageClock, *,
                cn_emb: Optional[torch.Tensor] = None,
                cn_keep: Optional[Dict[int, bool]] = None,
                cn_scale: float = 1.0,
                cn_cond: Optional[Conditioning] = None
                ) -> Callable[[torch.Tensor, int], torch.Tensor]:
        """eps(lat, t): one CFG-batched UNet call (and ControlNet call, on
        the steps its window keeps; on the others its residuals would be
        exactly zero) at integer timestep t, the guidance applied. While
        spans record on a card, the two calls' device seconds go to the
        step's span (`controlnet_device_s`, `unet_device_s`)."""
        m = self.models
        cd = m.dtype

        def eps_fn(lat: torch.Tensor, t: int) -> torch.Tensor:
            lat_in = torch.cat([lat, lat]).to(cd)
            tt = t_of[t]
            step_cond = cond
            if cn_emb is not None and cn_keep[t]:
                with clock.device_time("controlnet_device_s"):
                    down, mid = m.controlnet(lat_in, tt, text_embeds,
                                             cond_emb=cn_emb,
                                             conditioning_scale=cn_scale,
                                             cond=cn_cond)
                step_cond = dataclasses.replace(
                    cond, down_block_residuals=down, mid_block_residual=mid)
            with clock.device_time("unet_device_s"):
                eps = m.unet(lat_in, tt, text_embeds, step_cond).float()
            eps_uncond, eps_text = eps.chunk(2)
            return eps_uncond + guidance * (eps_text - eps_uncond)

        return eps_fn
