"""Unified inference CLI (port of `imagdressing_tpu/apps/dress.py`).

  python -m imagdressing_tpu_torch.apps.dress --preset basic    --cloth_path X
  python -m imagdressing_tpu_torch.apps.dress --preset cartoon  --cloth_path X
  python -m imagdressing_tpu_torch.apps.dress --preset pose     --cloth_path X --pose_path P
  python -m imagdressing_tpu_torch.apps.dress --preset ipa_pose --cloth_path X --pose_path P --face_path F
  python -m imagdressing_tpu_torch.apps.dress --preset inpaint  --cloth_path X --model_path M

Argument names track the reference CLIs (--cloth_path / --model_ckpt /
--output_path). Folder mode (--cloth_dir) batches garments on the card
(--batch_size; the ragged last chunk is padded to the batch). --pose_dir /
--face_dir / --model_dir reproduce the reference folder scripts' nested
cross-product loops (factor x cloth) with their f"{factor}_{cloth}.png"
output naming. Each output is the collage [garment | result].

A person photo (--model_path / --model_dir, the `inpaint` preset) becomes
the pipeline's person_image, its automatic upper-body mask
(`preprocess/mask.person_upper_body_mask`: OpenPose and the SCHP parse on
the same device, from the checkpoints named by IMAGDRESSING_OPENPOSE_CKPT,
IMAGDRESSING_ATR_CKPT and IMAGDRESSING_LIP_CKPT) and the inpaint
ControlNet's condition, once per photo.

--trained_ckpt lays the latest checkpoint of the port's trainer
(`apps.train_cli`'s `<output_dir>/checkpoints`) over the loaded stack: the
garment UNet, its adapters and the Resampler, cast to the compute dtype.

Runs on the card (`--device cuda`, the default; raises on a host without
one) or, with `--device cpu`, with every kernel's plain version.

Over several GPUs, one process per rank (the JAX CLI's (data, model)
mesh): `--data_parallel N` (-1: every visible GPU) splits each batch's
rows over N ranks, `--tensor_parallel M` splits the UNets over M
(`core/tp.py`). The CLI starts the N x M ranks itself, or runs as one rank
of a world torchrun started (`torchrun --nproc_per_node 4 -m
imagdressing_tpu_torch.apps.dress --data_parallel 4 ...`); the ranks join
over NCCL, each on its own GPU, and rank 0 writes the images. The batch is
at least N. Asking for more GPUs than are visible raises (no CPU stands
in); `--allow_cpu_mesh` runs CPU ranks over gloo (tests).

Spans (`core.profiling`, while a profiler session runs): `dress.chunk`
a chunk (its index the trace_id), over the `image.*` spans of its inputs,
the pipeline's `pipeline.call`, and `dress.collage` (the collages' resize,
grid and write).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="IMAGDressing (PyTorch)")
    p.add_argument("--preset", default="basic",
                   choices=["basic", "cartoon", "pose", "ipa_pose", "inpaint"])
    p.add_argument("--model_ckpt", default="ckpt/IMAGDressing-v1_512.pt")
    p.add_argument("--base_dir", default="ckpt/Realistic_Vision_V4.0_noVAE",
                   help="SD1.5 checkpoint dir (unet/, text_encoder/, "
                        "tokenizer/)")
    p.add_argument("--vae_path", default="ckpt/sd-vae-ft-mse")
    p.add_argument("--image_encoder_path", default="ckpt/image_encoder")
    p.add_argument("--controlnet_path", default=None)
    p.add_argument("--ip_ckpt", default=None)
    p.add_argument("--trained_ckpt", default=None,
                   help="a checkpoints/ dir of the port's trainer: its "
                        "latest step's trained weights replace the "
                        "garment UNet, adapters and Resampler")
    p.add_argument("--cloth_path", type=str, default=None)
    p.add_argument("--cloth_dir", type=str, default=None)
    p.add_argument("--pose_path", type=str, default=None)
    p.add_argument("--pose_dir", type=str, default=None,
                   help="cross-product over pose images (the reference "
                        "folder scripts' nested loops)")
    p.add_argument("--face_path", type=str, default=None)
    p.add_argument("--face_dir", type=str, default=None,
                   help="cross-product over face photos")
    p.add_argument("--model_path", type=str, default=None,
                   help="person photo for outfit-swap inpainting")
    p.add_argument("--model_dir", type=str, default=None,
                   help="cross-product over person photos")
    p.add_argument("--prompt", type=str, default=None)
    p.add_argument("--negative_prompt", type=str, default=None)
    p.add_argument("--output_path", type=str, default="./output_sd_base")
    p.add_argument("--num_inference_steps", type=int, default=None)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--guidance_scale", type=float, default=None)
    p.add_argument("--image_scale", type=float, default=None)
    p.add_argument("--controlnet_scale", type=float, default=None)
    p.add_argument("--control_guidance_start", type=float, default=None,
                   help="ControlNet step window lower bound in [0,1] "
                        "(diffusers controlnet_keep; default 0)")
    p.add_argument("--control_guidance_end", type=float, default=None,
                   help="ControlNet step window upper bound in [0,1] "
                        "(default 1)")
    p.add_argument("--eta", type=float, default=None,
                   help="DDIM stochasticity in [0,1] (diffusers eta; 0 = "
                        "deterministic, ddim sampler only)")
    p.add_argument("--clip_skip", type=int, default=None,
                   help="drop the last k CLIP text layers (diffusers "
                        "clip_skip; anime checkpoints conventionally use 2)")
    p.add_argument("--lora_scale", type=float, default=0.2)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--batch_size", type=int, default=1,
                   help="garments per device batch in --cloth_dir mode")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the card, default) or 'cpu' (every "
                        "kernel's plain version)")
    p.add_argument("--data_parallel", type=int, default=1,
                   help="ranks the batch rows split over (-1: every "
                        "visible GPU)")
    p.add_argument("--tensor_parallel", type=int, default=1,
                   help="ranks each UNet is split over (core/tp.py)")
    p.add_argument("--allow_cpu_mesh", action="store_true",
                   help="permit CPU ranks over gloo (tests only)")
    p.add_argument("--sampler", default=None,
                   choices=[None, "ddim", "unipc", "dpm2m"])
    return p


def main(argv=None):
    from imagdressing_tpu_torch.parallel import launch

    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_argparser().parse_args(argv)
    if not args.cloth_dir and not args.cloth_path:
        raise SystemExit("one of --cloth_path / --cloth_dir is required")
    launch.run_app(main, argv, lambda mesh: _dress(args, mesh),
                   data_parallel=args.data_parallel,
                   tensor_parallel=args.tensor_parallel, device=args.device,
                   allow_cpu_mesh=args.allow_cpu_mesh)


def _dress(args, mesh):
    from imagdressing_tpu_torch.apps import image_utils as iu
    from imagdressing_tpu_torch.apps.loader import (
        load_dressing_models,
        merge_trained_checkpoint,
    )
    from imagdressing_tpu_torch.apps.tokenizer import load_tokenizer
    from imagdressing_tpu_torch.core import profiling
    from imagdressing_tpu_torch.core.config import PRESETS
    from imagdressing_tpu_torch.pipelines.dressing import DressingPipeline

    device = args.device if mesh is None else mesh.device
    writer = mesh is None or mesh.rank == 0

    preset = PRESETS[args.preset]
    if args.sampler:
        preset = dataclasses.replace(preset, sampler=args.sampler)
    if args.height:
        preset = dataclasses.replace(preset, height=args.height)
    if args.width:
        preset = dataclasses.replace(preset, width=args.width)
    if args.clip_skip is not None:
        preset = dataclasses.replace(preset, clip_skip=args.clip_skip)
    models = load_dressing_models(
        base_dir=args.base_dir,
        vae_path=args.vae_path,
        image_encoder_path=args.image_encoder_path,
        model_ckpt=args.model_ckpt,
        controlnet_path=args.controlnet_path,
        ip_ckpt=args.ip_ckpt,
        lora_scale=args.lora_scale if preset.use_ipa else 0.0,
        device=device,
    )
    if args.trained_ckpt:
        models = merge_trained_checkpoint(models, args.trained_ckpt)
    tokenizer = load_tokenizer(os.path.join(args.base_dir, "tokenizer"))
    pipe = DressingPipeline(models, preset, device=device, mesh=mesh)

    prompt = args.prompt or (
        "A beautiful woman, confident smile expression, best quality, "
        "high quality" if args.preset == "cartoon" else iu.DEFAULT_PROMPT)
    negative = args.negative_prompt or iu.DEFAULT_NEGATIVE

    img_exts = (".jpg", ".jpeg", ".png", ".bmp", ".webp")

    def list_images(d):
        files = sorted(os.path.join(d, f) for f in os.listdir(d)
                       if f.lower().endswith(img_exts))
        if not files:
            raise SystemExit(f"no images found in {d}")
        return files

    cloths = list_images(args.cloth_dir) if args.cloth_dir \
        else [args.cloth_path]
    # cross-product factors (the reference folder scripts' nested loops:
    # outer factor file, inner cloth file); a plain --xxx_path is the
    # degenerate one-element factor
    poses = list_images(args.pose_dir) if args.pose_dir else [args.pose_path]
    faces = list_images(args.face_dir) if args.face_dir else [args.face_path]
    persons = list_images(args.model_dir) if args.model_dir \
        else [args.model_path]
    os.makedirs(args.output_path, exist_ok=True)

    # per-path preprocessing caches: a factor image is prepared once no
    # matter how many grid rows reuse it
    pose_cache, face_cache, person_cache = {}, {}, {}

    def extras_for(pose_path, face_path, person_path):
        ex = {}
        if pose_path:
            if pose_path not in pose_cache:
                pose = iu.resize(iu.read_image(pose_path),
                                 (preset.width, preset.height))
                pose_cache[pose_path] = (pose.astype(np.float32)
                                         / 255.0)[None]
            ex["pose_image"] = pose_cache[pose_path]
        if face_path:
            if face_path not in face_cache:
                from imagdressing_tpu_torch.preprocess.face import (
                    face_embeds_from_image,
                )

                face_cache[face_path] = face_embeds_from_image(face_path)
            ex["faceid_embeds"], ex["face_clip_image"] = face_cache[face_path]
        if person_path:
            if person_path not in person_cache:
                from imagdressing_tpu_torch.preprocess.mask import (
                    make_inpaint_condition,
                    person_upper_body_mask,
                )

                person = iu.prepare_person(person_path, preset.height,
                                           preset.width)
                mask = person_upper_body_mask(person_path, preset.height,
                                              preset.width, device=device)
                # the inpaint ControlNet's condition: the person in [0, 1]
                # with the masked pixels at -1
                cond = make_inpaint_condition((person[0] + 1.0) / 2.0,
                                              mask[0, ..., 0])
                person_cache[person_path] = {"person_image": person,
                                             "mask_image": mask,
                                             "pose_image": cond}
            ex.update(person_cache[person_path])
        return ex

    def out_name(item):
        cloth_path, pose_path, face_path, person_path = item
        stems = [os.path.splitext(os.path.basename(p))[0]
                 for p, is_dir in ((pose_path, args.pose_dir),
                                   (face_path, args.face_dir),
                                   (person_path, args.model_dir))
                 if is_dir and p]
        cloth_name = os.path.basename(cloth_path)
        if not stems:
            return cloth_name  # single-factor mode keeps the garment name
        # the reference's naming: f"{factor}_{cloth}.png"
        return "_".join(stems + [os.path.splitext(cloth_name)[0]]) + ".png"

    # factor-major order like the reference's nested loops; the device batch
    # dim then chews through the flat grid instead of looping serially
    items = [(c, pp, fp, mp) for pp in poses for fp in faces
             for mp in persons for c in cloths]

    bs = max(1, args.batch_size, 1 if mesh is None else mesh.data)
    for start in range(0, len(items), bs):
        with profiling.span("dress.chunk", trace_id=start // bs):
            chunk = items[start:start + bs]
            n_real = len(chunk)
            # pad the ragged final chunk by repeating its last row: one
            # batch size for the whole run
            if n_real < bs and start > 0:
                chunk = chunk + [chunk[-1]] * (bs - n_real)
            prepped = [iu.prepare_garment(
                item[0], preset.height, preset.width,
                clip_size=models.vision_cfg.image_size) for item in chunk]
            extras = [extras_for(*item[1:]) for item in chunk]
            b = len(chunk)
            # every row carries the same factor kinds (the lists are
            # homogeneous)
            batched_extra = {k: np.concatenate([e[k] for e in extras])
                             for k in extras[0]}
            out = pipe(
                prompt_ids=np.repeat(tokenizer(prompt)[None], b, axis=0),
                negative_prompt_ids=np.repeat(tokenizer(negative)[None], b,
                                              axis=0),
                ref_image=np.concatenate([p[0] for p in prepped]),
                ref_clip_image=np.concatenate([p[1] for p in prepped]),
                seed=args.seed,
                num_inference_steps=args.num_inference_steps,
                guidance_scale=args.guidance_scale,
                image_scale=args.image_scale,
                controlnet_scale=args.controlnet_scale,
                control_guidance_start=args.control_guidance_start,
                control_guidance_end=args.control_guidance_end,
                eta=args.eta,
                **batched_extra,
            )
            with profiling.span("dress.collage"):
                for i, item in enumerate(chunk[:n_real] if writer else ()):
                    garment = iu.resize(prepped[i][2],
                                        (preset.width, preset.height),
                                        "bicubic")
                    collage = iu.image_grid(
                        [garment] + iu.to_uint8(out[i:i + 1]), 1, 2)
                    name = out_name(item)
                    iu.write_image(os.path.join(args.output_path, name),
                                   collage)
                    print("saved", name, flush=True)


if __name__ == "__main__":
    main()
