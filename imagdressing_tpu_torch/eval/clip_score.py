"""CLIP text-image similarity for CAMI-S (port of `imagdressing_tpu/eval/
clip_score.py`).

The reference scores with OpenAI CLIP ViT-B/32 (`clip.load("ViT-B/32")`,
metric/eval_s.py): the cosine of the projected, normalized text and image
embeddings. Here the port's CLIP towers (`models/clip.py`) run the same
configuration, loaded from a transformers `CLIPModel` state dict through
`convert/torch_sd.py`, on the card unless the caller asks for the CPU. The
50 image tokens and 77 text tokens go through the plain attention
(`ops.attention`), as in the JAX package.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from imagdressing_tpu_torch.apps.tokenizer import load_tokenizer
from imagdressing_tpu_torch.convert import state_dict_from_jax
from imagdressing_tpu_torch.convert.torch_sd import (
    convert_clip_text,
    convert_clip_vision,
    load_torch_file,
)
from imagdressing_tpu_torch.core.config import CLIPTextConfig, CLIPVisionConfig
from imagdressing_tpu_torch.models.clip import (
    CLIPText,
    CLIPVision,
    clip_preprocess,
    vision_pooled_embed,
)
from imagdressing_tpu_torch.ops.resize import jax_resize
from imagdressing_tpu_torch.pipelines.dressing import resolve_device

Device = Union[str, torch.device]

VIT_B32_TEXT = CLIPTextConfig(hidden_size=512, intermediate_size=2048,
                              num_layers=12, num_heads=8)
VIT_B32_VISION = CLIPVisionConfig(
    hidden_size=768, intermediate_size=3072, num_layers=12, num_heads=12,
    image_size=224, patch_size=32, projection_dim=512,
    # every OpenAI CLIP checkpoint uses quick_gelu; the config's default
    # gelu is the garment encoder's (ViT-H)
    hidden_act="quick_gelu")


class ClipScorer:
    """text (CLIPText), vision (CLIPVision with its projection) and the
    text projection (hidden, proj), all on one device."""

    def __init__(self, text: CLIPText, vision: CLIPVision,
                 text_projection: torch.Tensor, tokenizer=None,
                 device: Device = "cuda"):
        self.device = resolve_device(device)
        self.text = text.to(self.device).eval().requires_grad_(False)
        self.vision = vision.to(self.device).eval().requires_grad_(False)
        self.text_projection = text_projection.to(self.device,
                                                  torch.float32)
        self.tokenizer = tokenizer

    @classmethod
    def from_state_dict(cls, sd, text_cfg: CLIPTextConfig = VIT_B32_TEXT,
                        vision_cfg: CLIPVisionConfig = VIT_B32_VISION,
                        tokenizer=None, device: Device = "cuda"
                        ) -> "ClipScorer":
        """A transformers CLIPModel state dict -> the scorer. The file's
        text_projection.weight is (proj, hidden) and the scorer multiplies
        pooled @ W, so it is transposed (ViT-B/32's is square: a missed
        transpose would be silent)."""
        dev = resolve_device(device)
        with torch.device(dev):
            text, vision = CLIPText(text_cfg), CLIPVision(vision_cfg)
        for module, tree in ((text, convert_clip_text(sd, text_cfg)),
                             (vision, convert_clip_vision(sd, vision_cfg))):
            module.load_state_dict({k: v.float() for k, v in
                                    state_dict_from_jax(tree).items()})
        proj = sd["text_projection.weight"]
        proj = (proj.float() if torch.is_tensor(proj) else
                torch.from_numpy(np.asarray(proj, np.float32))).t()
        return cls(text, vision, proj, tokenizer, dev)

    @classmethod
    def from_torch(cls, clip_model_path: str, tokenizer_path: str = "",
                   device: Device = "cuda") -> "ClipScorer":
        """A transformers CLIPModel (ViT-B/32) file and, optionally, the
        directory of its tokenizer's vocab.json / merges.txt."""
        if not tokenizer_path:
            print("WARNING: no --clip_tokenizer given: falling back to the "
                  "test HashTokenizer, whose ids are NOT the CLIP vocab; "
                  "text similarities will be meaningless", flush=True)
        return cls.from_state_dict(load_torch_file(clip_model_path),
                                   tokenizer=load_tokenizer(tokenizer_path),
                                   device=device)

    @torch.no_grad()
    def text_embed(self, ids) -> torch.Tensor:
        """(B, 77) token ids -> the projected text features (B, proj),
        pooled at the EOS position (the largest id in the CLIP vocab)."""
        ids = torch.as_tensor(np.asarray(ids), device=self.device).long()
        hidden = self.text(ids)
        pooled = hidden[torch.arange(ids.shape[0], device=self.device),
                        ids.argmax(-1)]
        return pooled @ self.text_projection

    @torch.no_grad()
    def image_embed(self, images01) -> torch.Tensor:
        """(B, H, W, 3) in [0, 1] -> the projected image features (B,
        proj). OpenAI CLIP's preprocessing: the shortest edge resized
        (bicubic) to the model's size, then a centre crop (a square resize
        would squash the 640x512 try-ons)."""
        x = torch.as_tensor(np.asarray(images01, np.float32),
                            device=self.device)
        h, w = x.shape[1:3]
        size = self.vision.cfg.image_size
        if (h, w) != (size, size):
            scale = size / min(h, w)
            nh, nw = max(size, round(h * scale)), max(size, round(w * scale))
            x = jax_resize(x, nh, nw)
            top, left = (nh - size) // 2, (nw - size) // 2
            x = x[:, top:top + size, left:left + size]
        last = self.vision(clip_preprocess(x, size), penultimate=False)
        return vision_pooled_embed(self.vision, last)

    def similarity(self, text: str, image01: np.ndarray) -> float:
        """The cosine of the text's and the image's embeddings (the
        reference's calculate_clip_similarity)."""
        t = self.text_embed(self.tokenizer(text)[None])
        i = self.image_embed(np.asarray(image01)[None])
        t = t / t.norm(dim=-1, keepdim=True)
        i = i / i.norm(dim=-1, keepdim=True)
        return float((t * i).sum())
