"""Write a port stack as the reference's checkpoint files.

The layout `apps.loader.load_dressing_models` reads (the real checkpoints
are not in the repository, so the loader's tests and `chip_smoke.py` load
synthetic ones written here from a seeded stack):

  ROOT/base/unet/diffusion_pytorch_model.safetensors   diffusers UNet names
  ROOT/base/text_encoder/model.safetensors             transformers CLIPText
  ROOT/base/tokenizer/                                 no vocab: the loader
                                                       falls back to
                                                       HashTokenizer
  ROOT/vae/diffusion_pytorch_model.safetensors         diffusers AutoencoderKL
  ROOT/image_encoder/model.safetensors                 CLIPVisionModelWith-
                                                       Projection
  ROOT/IMAGDressing-v1_512.pt                          {"module": ref_unet.*,
                                                       proj.*, adapter_modules.*}
  ROOT/controlnet/diffusion_pytorch_model.safetensors  where the stack has one
  ROOT/ip-adapter-faceid-plusv2_sd15.bin               where the stack has IP
                                                       adapters (+ a random
                                                       LoRA with lora_rank > 0)

and with `--preprocess` (`write_preprocess_checkpoints`) the nets of the
person-photo path and the face fusion, at full width, random:

  ROOT/preprocess/body_pose_model.pth    OpenPose body, bare layer keys
  ROOT/preprocess/hand_pose_model.pth    OpenPose hand
  ROOT/preprocess/facenet.pth            OpenPose face
  ROOT/preprocess/exp-schp-atr.pth       SCHP ATR and LIP, {"state_dict":
  ROOT/preprocess/exp-schp-lip.pth       {"module." + reference name}}

`clip_scorer_state_dict` draws the CAMI-S scorer, a random ViT-B/32, as a
transformers `CLIPModel` state dict (`torch.save` it for `eval.cli
cami-s-grid --clip_model`).

Every tensor keeps the stack's dtype, so a bf16 stack writes bf16 files.
Each model goes through `convert.tree_from_module` and the inverse
converters of `convert/export_torch.py`, so loading the files back gives
the same parameters bit for bit (the LoRA, when written, is folded in at
load time where lora_scale > 0).

  python -m imagdressing_tpu_torch.tools.write_checkpoints --out DIR \\
      [--small] [--dtype bf16] [--controlnet] [--ipa [--lora_rank 4]] \\
      [--preprocess] [--device cpu]

The stack is drawn on the card unless `--device cpu` is given; without a
card the default raises, as the other entry points do. It prints the
loader's path flags and, with `--preprocess`, the environment variables
that `dress --model_path / --model_dir` reads and the server's
`--post_process face_fusion:` flag.
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Dict, Optional

import torch

from imagdressing_tpu_torch.convert import export_torch as ex
from imagdressing_tpu_torch.convert import tree_from_module
from imagdressing_tpu_torch.convert.torch_sd import write_safetensors
from imagdressing_tpu_torch.models.unet import adapter_key, attn_layer_names
from imagdressing_tpu_torch.pipelines.dressing import DressingModels
from imagdressing_tpu_torch.preprocess.openpose.face import FaceNet
from imagdressing_tpu_torch.preprocess.openpose.hand import HandPoseNet
from imagdressing_tpu_torch.preprocess.openpose.model import BodyPoseNet
from imagdressing_tpu_torch.preprocess.parsing import model as schp


def _by_layer(module, names):
    tree = tree_from_module(module)
    return {name: tree[adapter_key(name)] for name in names}


def random_lora(models: DressingModels, rank: int, seed: int = 0
                ) -> Dict[str, Dict[str, Any]]:
    """{"lora_attn1", "lora_attn2": {layer name: {to_q, to_k, to_v, to_out:
    {down (in, rank), up (rank, out)}}}}, JAX layout, N(0, 0.05^2) from
    `torch.Generator().manual_seed(seed)`, in the stack's dtype."""
    gen = torch.Generator().manual_seed(seed)
    out: Dict[str, Dict[str, Any]] = {}
    for which in ("attn1", "attn2"):
        out[f"lora_{which}"] = {}
        for name in attn_layer_names(models.unet_cfg, which):
            attn = getattr(models.unet.attention_block(name), which)
            lora = {}
            for proj in ("to_q", "to_k", "to_v", "to_out"):
                d_out, d_in = getattr(attn, proj).weight.shape
                lora[proj] = {
                    "down": (torch.randn(d_in, rank, generator=gen)
                             * 0.05).to(models.dtype),
                    "up": (torch.randn(rank, d_out, generator=gen)
                           * 0.05).to(models.dtype)}
            out[f"lora_{which}"][name] = lora
    return out


def write_checkpoints(models: DressingModels, root: str, *,
                      lora: Optional[Dict[str, Any]] = None
                      ) -> Dict[str, str]:
    """Write `models` under `root` (layout above); `lora` ({"lora_attn1",
    "lora_attn2"} as `random_lora` returns) goes into the FaceID bin.
    Returns `load_dressing_models`' path arguments: base_dir, vae_path,
    image_encoder_path, model_ckpt and, where written, controlnet_path and
    ip_ckpt."""
    def st(path, sd):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        write_safetensors(path, ex.torch_state_dict(sd))
        return path

    base = os.path.join(root, "base")
    st(os.path.join(base, "unet", "diffusion_pytorch_model.safetensors"),
       ex.export_unet(tree_from_module(models.unet)))
    st(os.path.join(base, "text_encoder", "model.safetensors"),
       ex.export_clip_text(tree_from_module(models.text)))
    os.makedirs(os.path.join(base, "tokenizer"), exist_ok=True)
    paths = dict(
        base_dir=base,
        vae_path=os.path.dirname(st(
            os.path.join(root, "vae", "diffusion_pytorch_model.safetensors"),
            ex.export_vae(tree_from_module(models.vae)))),
        image_encoder_path=os.path.dirname(st(
            os.path.join(root, "image_encoder", "model.safetensors"),
            ex.export_clip_vision(tree_from_module(models.vision)))),
        model_ckpt=os.path.join(root, "IMAGDressing-v1_512.pt"))
    ex.save_checkpoint(paths["model_ckpt"], ex.export_imagdressing_module(
        {"ref_unet": tree_from_module(models.ref_unet),
         "resampler": tree_from_module(models.resampler),
         "ref_adapters": _by_layer(models.ref_adapters, attn_layer_names(
             models.unet_cfg, "attn1"))},
        models.unet_cfg))
    if models.controlnet is not None:
        paths["controlnet_path"] = os.path.dirname(st(
            os.path.join(root, "controlnet",
                         "diffusion_pytorch_model.safetensors"),
            ex.export_controlnet(tree_from_module(models.controlnet))))
    if models.ip_adapters is not None:
        paths["ip_ckpt"] = os.path.join(root,
                                        "ip-adapter-faceid-plusv2_sd15.bin")
        faceid = ex.export_ip_adapter_faceid(
            tree_from_module(models.proj_plus),
            _by_layer(models.ip_adapters,
                      attn_layer_names(models.unet_cfg, "attn2")),
            models.unet_cfg, **(lora or {}))
        torch.save({k: ex.torch_state_dict(v) for k, v in faceid.items()},
                   paths["ip_ckpt"])
    return paths


def write_preprocess_checkpoints(root: str, seed: int = 0,
                                 device="cpu") -> Dict[str, str]:
    """Random full-width OpenPose body / hand / face nets and the SCHP ATR
    / LIP pair, drawn on `device` from `seed` (body seed, hand seed + 1,
    face seed + 2, ATR seed + 3, LIP seed + 4), written under
    `root/preprocess` in the reference's key layouts. Returns {the
    environment variables IMAGDRESSING_OPENPOSE_CKPT, IMAGDRESSING_ATR_CKPT,
    IMAGDRESSING_LIP_CKPT: paths, "facenet": path, "hand": path}."""
    out = os.path.join(root, "preprocess")
    os.makedirs(out, exist_ok=True)

    def save(name, sd):
        path = os.path.join(out, name)
        torch.save({k: v.detach().cpu().contiguous() for k, v in sd.items()},
                   path)
        return path

    paths = {}
    for key, name, cls, k in (
            ("IMAGDRESSING_OPENPOSE_CKPT", "body_pose_model.pth",
             BodyPoseNet, 0),
            ("hand", "hand_pose_model.pth", HandPoseNet, 1),
            ("facenet", "facenet.pth", FaceNet, 2)):
        paths[key] = save(name, cls.init_random(seed + k, device).state_dict())
    for key, name, n, k in (
            ("IMAGDRESSING_ATR_CKPT", "exp-schp-atr.pth",
             schp.NUM_CLASSES_ATR, 3),
            ("IMAGDRESSING_LIP_CKPT", "exp-schp-lip.pth",
             schp.NUM_CLASSES_LIP, 4)):
        sd = schp.init(seed + k, n, device).state_dict()
        path = os.path.join(out, name)
        torch.save({"state_dict": {
            "module." + schp.reference_name(key_): v.detach().cpu().contiguous()
            for key_, v in sd.items()}}, path)
        paths[key] = path
    return paths


def clip_scorer_state_dict(seed: int = 0, device="cuda", text_cfg=None,
                           vision_cfg=None) -> Dict[str, torch.Tensor]:
    """A random CLIP model (default: the CAMI-S scorer's ViT-B/32,
    `eval.clip_score.VIT_B32_*`) as a transformers `CLIPModel` state dict
    on the CPU: text and vision towers by the port's init drawn on
    `device` from `seed`, through `export_clip_text` / `export_clip_vision`,
    and a text projection N(0, 0.02) of (proj, hidden)."""
    from imagdressing_tpu_torch.eval.clip_score import (
        VIT_B32_TEXT,
        VIT_B32_VISION,
    )
    from imagdressing_tpu_torch.models.clip import CLIPText, CLIPVision
    from imagdressing_tpu_torch.ops.nn import init_module
    from imagdressing_tpu_torch.pipelines.dressing import resolve_device

    text_cfg = text_cfg or VIT_B32_TEXT
    vision_cfg = vision_cfg or VIT_B32_VISION
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.device(dev):
        text, vision = CLIPText(text_cfg), CLIPVision(vision_cfg)
        proj = torch.randn(vision_cfg.projection_dim, text_cfg.hidden_size,
                           generator=gen) * 0.02
    init_module(text, gen)
    init_module(vision, gen)
    sd = {**ex.export_clip_text(tree_from_module(text)),
          **ex.export_clip_vision(tree_from_module(vision)),
          "text_projection.weight": proj}
    return {k: v.cpu() for k, v in ex.torch_state_dict(sd).items()}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", required=True)
    p.add_argument("--small", action="store_true",
                   help="the tiny test stack instead of full SD1.5 widths")
    p.add_argument("--dtype", default="fp32", choices=["fp32", "bf16"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--controlnet", action="store_true")
    p.add_argument("--ipa", action="store_true")
    p.add_argument("--lora_rank", type=int, default=0)
    p.add_argument("--preprocess", action="store_true",
                   help="also the OpenPose body / hand / face nets and the "
                        "SCHP pair (full width, random)")
    p.add_argument("--device", default="cuda",
                   help="where the random stack is drawn; cpu only when "
                   "asked for")
    args = p.parse_args(argv)
    models = DressingModels.init_random(
        args.seed, small=args.small, with_controlnet=args.controlnet,
        with_ipa=args.ipa, device=args.device)
    if args.dtype == "bf16":
        models.cast(torch.bfloat16)
    lora = random_lora(models, args.lora_rank, args.seed) \
        if args.ipa and args.lora_rank else None
    for k, v in write_checkpoints(models, args.out, lora=lora).items():
        print(f"--{k} {v}")
    if args.preprocess:
        pre = write_preprocess_checkpoints(args.out, args.seed, args.device)
        for k, v in pre.items():
            if k.startswith("IMAGDRESSING_"):
                print(f"{k}={v}")
        print(f"--post_process face_fusion:{pre['facenet']}")


if __name__ == "__main__":
    main()
