"""The reference try-on: the reference scripts' pipeline (text, garment
tokens, garment latents and the capture run, DDIM with classifier-free
guidance over [uncond; cond] rows whose garment scales are [0, s], the
optional openpose ControlNet, the VAE decode), in plain PyTorch through
`stack`, and the inputs it works out for itself from what the benchmark
hands both sides: the garment and pose images as uint8 arrays, the prompt
texts and the call's seed.

`prepare_*` redo the apps' preparation (the reference scripts' snap-to-64
resize, PIL-style antialiased bilinear / bicubic resizes, CLIPImageProcessor)
with `F.interpolate`; `HashTokenizer` is the stand-in tokenizer the served
and folder paths use when no vocabulary file is present."""

from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import stack

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
DEFAULT_NEGATIVE = (
    "bare, naked, nude, undressed, monochrome, lowres, bad anatomy, "
    "worst quality, low quality")


class HashTokenizer:
    """Words hashed (md5) into the vocabulary: BOS, ids, EOS, EOS-padded to
    77."""

    def __init__(self, vocab_size: int = 49408, max_length: int = 77):
        self.vocab_size, self.max_length = vocab_size, max_length
        self.bos, self.eos = vocab_size - 2, vocab_size - 1

    def __call__(self, text: str) -> np.ndarray:
        ids = [int(hashlib.md5(w.encode()).hexdigest(), 16)
               % (self.vocab_size - 2) for w in text.lower().split()]
        full = [self.bos] + ids[:self.max_length - 2] + [self.eos]
        full += [self.eos] * (self.max_length - len(full))
        return np.asarray(full, np.int32)


# ---------------------------------------------------------------------------
# Image preparation
# ---------------------------------------------------------------------------


def resize(img: np.ndarray, w: int, h: int, mode: str = "bilinear"
           ) -> np.ndarray:
    """uint8 (H, W, C) -> uint8 (h, w, C), antialiased when shrinking, each
    separable pass rounded to uint8 (channels-last uint8 interpolation)."""
    x = torch.from_numpy(np.ascontiguousarray(img)).permute(2, 0, 1)[None]
    x = x.contiguous(memory_format=torch.channels_last)
    y = F.interpolate(x, size=(h, w), mode=mode, align_corners=False,
                      antialias=True)
    return y[0].permute(1, 2, 0).contiguous().numpy()


def snap_resize(img: np.ndarray, max_side: int = 640, min_side: int = 512,
                base: int = 64) -> np.ndarray:
    """The reference scripts' resize_img: short side to min_side, long side
    to max_side, each side down to a multiple of `base` (bilinear)."""
    h, w = img.shape[:2]
    ratio = min_side / min(h, w)
    w, h = round(ratio * w), round(ratio * h)
    ratio = max_side / max(h, w)
    img = resize(img, round(ratio * w), round(ratio * h))
    return resize(img, (round(ratio * w) // base) * base,
                  (round(ratio * h) // base) * base)


def clip_view(img: np.ndarray, size: int = 224) -> np.ndarray:
    """CLIPImageProcessor: shortest side to `size` (bicubic), centre crop,
    [0, 1], normalised."""
    h, w = img.shape[:2]
    if h < w:
        nh, nw = size, max(size, round(w * size / h))
    else:
        nh, nw = max(size, round(h * size / w)), size
    x = resize(img, nw, nh, "bicubic")
    top, left = (x.shape[0] - size) // 2, (x.shape[1] - size) // 2
    x = x[top:top + size, left:left + size].astype(np.float32) / 255.0
    return (x - np.asarray(CLIP_MEAN, np.float32)) \
        / np.asarray(CLIP_STD, np.float32)


def prepare_garment(cloth: np.ndarray, height: int, width: int,
                    clip_size: int, vae_mode: str) -> Dict[str, np.ndarray]:
    """An uploaded garment -> its VAE view in [-1, 1] and its CLIP view.
    The served path resizes the VAE view bicubic, the folder path bilinear."""
    cloth = snap_resize(cloth)
    vae = resize(cloth, width, height, vae_mode).astype(np.float32)
    return {"ref_image": vae / 127.5 - 1.0,
            "ref_clip_image": clip_view(cloth, clip_size)}


def prepare_pose(pose: np.ndarray, height: int, width: int) -> np.ndarray:
    return resize(pose, width, height).astype(np.float32) / 255.0


# ---------------------------------------------------------------------------
# DDIM
# ---------------------------------------------------------------------------


class DDIM:
    """diffusers' DDIMScheduler (epsilon prediction, eta 0), float64 tables."""

    def __init__(self, cfg: dict):
        t = cfg["num_train_timesteps"]
        if cfg["beta_schedule"] != "scaled_linear":
            raise ValueError(cfg["beta_schedule"])
        betas = np.linspace(cfg["beta_start"] ** 0.5, cfg["beta_end"] ** 0.5,
                            t, dtype=np.float64) ** 2
        self.alphas = np.cumprod(1.0 - betas)
        self.final = 1.0 if cfg["set_alpha_to_one"] else self.alphas[0]
        self.total, self.offset = t, cfg["steps_offset"]
        if cfg["timestep_spacing"] != "leading":
            raise ValueError(cfg["timestep_spacing"])

    def timesteps(self, n: int) -> List[int]:
        ratio = self.total // n
        return [int(i * ratio + self.offset) for i in reversed(range(n))]

    def step(self, eps: torch.Tensor, t: int, x: torch.Tensor, n: int
             ) -> torch.Tensor:
        prev = t - self.total // n
        a_t = float(self.alphas[t])
        a_prev = float(self.alphas[prev] if prev >= 0 else self.final)
        x0 = (x - (1.0 - a_t) ** 0.5 * eps) / a_t ** 0.5
        return a_prev ** 0.5 * x0 + (1.0 - a_prev) ** 0.5 * eps


# ---------------------------------------------------------------------------
# The try-on
# ---------------------------------------------------------------------------


def _nchw(x: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32),
                           device=device).permute(0, 3, 1, 2)


def generate(weights: Dict[str, Dict[str, torch.Tensor]], config: dict, *,
             prompt_ids: np.ndarray, negative_ids: np.ndarray,
             ref_image: np.ndarray, ref_clip_image: np.ndarray,
             noise: torch.Tensor, steps: int,
             pose_image: Optional[np.ndarray] = None,
             precision: str = "fp32",
             used: Optional[Dict[str, set]] = None) -> torch.Tensor:
    """Images (B, H, W, 3) in [0, 1] float32 for B rows: prompt ids (B,
    77), garment views (B, H, W, 3) and (B, 224, 224, 3), the initial noise
    (B, H/8, W/8, 4) NHWC, and for the ControlNet preset the pose maps (B,
    H, W, 3) in [0, 1]. `weights` {model: float32 state dict} on the
    device; `used` collects the keys read per model."""
    prec = stack.Precision(precision)
    dev = noise.device
    used = {} if used is None else used

    def params(name):
        return stack.Params(weights[name], prec,
                            used=used.setdefault(name, set()))

    unet_cfg, vae_cfg = config["unet"], config["vae"]
    sf = vae_cfg["scaling_factor"]
    b = noise.shape[0]
    ids = torch.as_tensor(np.concatenate([negative_ids, prompt_ids]),
                          dtype=torch.long, device=dev)
    text = stack.clip_text(params("text"), config["text"], ids)
    hidden = stack.clip_vision_penultimate(
        params("vision"), config["vision"], _nchw(ref_clip_image, dev))
    tokens = stack.resampler(params("resampler"), config["resampler"], hidden)
    ref_lat = stack.vae_encode_mean(params("vae"), vae_cfg,
                                    _nchw(ref_image, dev)) * sf
    captured: Dict[str, torch.Tensor] = {}
    stack.unet(params("ref_unet"), unet_cfg, ref_lat,
               torch.zeros(b, device=dev), tokens,
               stack.UNetCond(captured=captured))
    kv = {name: (torch.cat([k, k]), torch.cat([v, v])) for name, (k, v)
          in stack.ref_kv(params("ref_adapters"), captured).items()}
    scale = [0.0] * b + [float(config["image_scale"])] * b
    cn = None
    if config.get("controlnet"):
        pose = _nchw(pose_image, dev)
        cn = params("controlnet")
        cn_emb = stack.controlnet_cond_embedding(cn, torch.cat([pose, pose]))
    unet_p = params("unet")
    sched = DDIM(config["scheduler"])
    g = float(config["guidance_scale"])
    lat = noise.permute(0, 3, 1, 2).float()
    for t in sched.timesteps(steps):
        x = torch.cat([lat, lat])
        tt = torch.full((2 * b,), t, device=dev)
        cond = stack.UNetCond(ref_kv=kv, ref_scale=scale)
        if cn is not None:
            cond.down_residuals, cond.mid_residual = stack.controlnet(
                cn, unet_cfg, x, tt, text, cn_emb,
                float(config["controlnet_conditioning_scale"]))
        eps = stack.unet(unet_p, unet_cfg, x, tt, text, cond)
        e_u, e_c = eps.chunk(2)
        lat = sched.step(e_u + g * (e_c - e_u), t, lat, steps)
    images = stack.vae_decode(params("vae"), vae_cfg, lat / sf)
    return (images * 0.5 + 0.5).clamp(0.0, 1.0).permute(0, 2, 3, 1)


def unused_keys(weights: Dict[str, Dict[str, torch.Tensor]],
                used: Dict[str, set]) -> Dict[str, List[str]]:
    """{model: keys of its state dict that no reference step read}."""
    out = {}
    for name, sd in weights.items():
        missing = sorted(set(sd) - used.get(name, set()))
        if missing:
            out[name] = missing
    return out


def initial_noise(seed: int, batch: int, height: int, width: int,
                  device) -> torch.Tensor:
    """The initial latents of a call of `batch` rows drawn from `seed`: a
    standard normal (batch, H/8, W/8, 4) from the device's generator, as
    the reference scripts' pipeline draws them from its generator."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return torch.randn((batch, height // 8, width // 8, 4), generator=gen,
                       device=device)


def tokenize(tokenizer: HashTokenizer, texts: Sequence[str]) -> np.ndarray:
    return np.stack([tokenizer(t) for t in texts])
