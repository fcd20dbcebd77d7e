"""Weights-day parity runbook (port of `imagdressing_tpu/tools/parity.py`):
one command that takes a machine from "has the reference checkpoints" to
"seed-fixed fp32 parity of the port verified, stage by stage".

`--dry-run` drives the same record -> manifest -> replay -> gate -> image
sequence on the port's small random stack, for the four reference
pipelines, with no weights (`--device cpu` runs it on the CPU).

On a machine with the checkpoints, laid out as the reference README's
ckpt/ tree (Realistic_Vision_V4.0_noVAE, sd-vae-ft-mse, image_encoder,
control_v11p_sd15_openpose, IMAGDressing-v1_512.pt):

  1. In a diffusers environment (torch + diffusers + transformers, the
     reference repository on sys.path for ProjPlus), once per preset:
       python -m imagdressing_tpu.tools.record_reference record \\
           --preset basic \\
           --base_dir ckpt/Realistic_Vision_V4.0_noVAE \\
           --vae_path ckpt/sd-vae-ft-mse \\
           --image_encoder_path ckpt/image_encoder \\
           --controlnet_path ckpt/control_v11p_sd15_openpose \\
           --seed 42 --steps 30 --out tests/goldens/ref_base.npz
     (the other presets write <stem>_<preset>.npz; ipa_pose with
     --ipa_ckpt, or its ProjPlus is random and cannot be replayed).
  2. On the card, in this repository:
       python -m imagdressing_tpu_torch.tools.parity \\
           --golden tests/goldens/ref_base.npz \\
           --base_dir ckpt/Realistic_Vision_V4.0_noVAE \\
           --vae_path ckpt/sd-vae-ft-mse \\
           --image_encoder_path ckpt/image_encoder \\
           --controlnet_path ckpt/control_v11p_sd15_openpose \\
           --model_ckpt ckpt/IMAGDressing-v1_512.pt [--ipa_ckpt F.bin]
     which writes the torch manifest beside each golden, replays every
     recorded tensor through the port's models in fp32 (TF32 off) and
     compares it at atol 5e-3 + rtol 1e-3 * max|golden|, then prints the
     command that renders the seed-42 image for a visual diff against the
     reference's published outputs.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np

from imagdressing_tpu_torch.tools import record_reference as rr

PRESETS = ("basic", "pose", "ipa_pose", "inpaint")


def _step(n: int, msg: str) -> None:
    print(f"[parity {n}] {msg}", flush=True)


def run_dry(out_dir: str, device: str = "cuda") -> dict:
    """Synthetic end to end: every stage of the weights-day flow with the
    port's small random stack (no weights needed), for all four reference
    pipelines, on `device`; writes `parity_report.json` and `seed42.png`
    into `out_dir` and returns the report."""
    from imagdressing_tpu_torch.apps.png import encode_png
    from imagdressing_tpu_torch.core.config import PRESETS as PIPELINES
    from imagdressing_tpu_torch.pipelines.dressing import (
        DressingPipeline,
        resolve_device,
    )

    resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    per_preset = {}
    for preset_name in PRESETS:
        golden = os.path.join(out_dir, f"ref_dryrun_{preset_name}.npz")
        _step(1, f"record {preset_name} golden (the port's synthetic stack "
                 "stands in for diffusers)")
        rr.record_synthetic(golden, seed=42, steps=4, preset=preset_name,
                            device=device)

        _step(2, f"replay {preset_name} golden through the port's stack + "
                 "fp32-tolerance compare")
        errors = rr.replay(golden, device=device)
        w = max(errors.values())
        print(f"  {len(errors)} tensors compared, worst max-err {w:.2e}")
        per_preset[preset_name] = {
            "golden": golden,
            "tensors_compared": sorted(errors),
            "worst_max_err": w,
        }

    _step(3, "render the seed-42 image (basic preset)")
    models = rr.synthetic_models(42, device=device)
    preset = dataclasses.replace(PIPELINES["basic"], height=64, width=64,
                                 num_inference_steps=2)
    rng = np.random.default_rng(42)
    vs = models.vision_cfg.image_size
    img = DressingPipeline(models, preset, device=device)(
        prompt_ids=rng.integers(0, models.text_cfg.vocab_size, (1, 77)),
        negative_prompt_ids=rng.integers(0, models.text_cfg.vocab_size,
                                         (1, 77)),
        ref_image=rng.standard_normal((1, 64, 64, 3)).astype(
            np.float32).clip(-1, 1),
        ref_clip_image=rng.standard_normal((1, vs, vs, 3)).astype(np.float32),
        seed=42, output_uint8=True)
    img_path = os.path.join(out_dir, "seed42.png")
    with open(img_path, "wb") as f:
        f.write(encode_png(np.asarray(img[0])))

    report = {
        "mode": "dry-run",
        "device": device,
        "presets": per_preset,
        "tensors_compared_total": sum(len(v["tensors_compared"])
                                      for v in per_preset.values()),
        "worst_max_err": max(v["worst_max_err"] for v in per_preset.values()),
        "image": img_path,
        "ok": True,
    }
    rp = os.path.join(out_dir, "parity_report.json")
    with open(rp, "w", encoding="utf-8") as f:
        json.dump(report, f, indent=2)
    _step(4, f"PARITY DRY-RUN OK -> {rp}")
    return report


def _golden_path(template: str, preset: str) -> str:
    return (template if preset == "basic"
            else template.replace(".npz", f"_{preset}.npz"))


def _recorder_command(args, preset: str, out: str) -> str:
    ipa = f" \\\n      --ipa_ckpt {args.ipa_ckpt}" \
        if preset == "ipa_pose" and args.ipa_ckpt else ""
    return ("  python -m imagdressing_tpu.tools.record_reference record \\\n"
            f"      --preset {preset} \\\n"
            f"      --base_dir {args.base_dir} --vae_path {args.vae_path} \\\n"
            f"      --image_encoder_path {args.image_encoder_path} \\\n"
            f"      --controlnet_path {args.controlnet_path}{ipa} \\\n"
            f"      --seed {args.seed} --steps {args.steps} --out {out}")


def run_real(args) -> dict:
    """The weights-day flow, per preset (all four reference pipelines by
    default). Each stage prints what is missing when its prerequisite is
    absent, so the runbook guides itself."""
    presets = [s.strip() for s in args.presets.split(",") if s.strip()]
    if "ipa_pose" in presets and not args.ipa_ckpt:
        print("  ipa_pose left out: without --ipa_ckpt the recorder draws a "
              "random ProjPlus that no replay can rebuild; record and "
              "replay it with the same --ipa_ckpt")
        presets.remove("ipa_pose")
    if not presets:
        sys.exit(2)
    goldens = {pr: _golden_path(args.golden, pr) for pr in presets}
    missing = {pr: g for pr, g in goldens.items() if not os.path.exists(g)}
    if missing:
        _step(1, "goldens missing: record them in a diffusers environment "
                 "(torch, diffusers, transformers; the reference repository "
                 "on sys.path):")
        for pr, g in missing.items():
            print(_recorder_command(args, pr, g))
        print("  then re-run this command.")
        sys.exit(2)
    _step(1, f"goldens present: {', '.join(goldens.values())}")

    for path in (args.base_dir, args.vae_path, args.image_encoder_path,
                 args.model_ckpt, args.controlnet_path, args.ipa_ckpt):
        if path and not os.path.exists(path):
            print(f"  checkpoint path missing: {path} (reference README "
                  "ckpt/ layout)")
            sys.exit(2)

    _step(2, "write the torch weights manifest beside each golden")
    manifest = {
        "kind": "torch",
        "base_dir": args.base_dir,
        "vae_path": args.vae_path,
        "image_encoder_path": args.image_encoder_path,
        "model_ckpt": args.model_ckpt,
        "controlnet_path": args.controlnet_path,
        "ip_ckpt": args.ipa_ckpt,
    }
    for g in goldens.values():
        with open(rr.manifest_path_for(g), "w", encoding="utf-8") as f:
            json.dump(manifest, f, indent=2)
    mpath = rr.manifest_path_for(goldens[presets[0]])

    _step(3, "replay goldens through the converted weights (fp32 parity, "
             f"{args.device})")
    models = rr.build_models_from_manifest(manifest, args.device)
    errors = {}
    for pr, g in goldens.items():
        e = rr.replay(g, models)
        print(f"  [{pr}] {len(e)} tensors compared, worst max-err "
              f"{max(e.values()):.2e}")
        errors.update({f"{pr}::{k}": v for k, v in e.items()})
    golden = goldens[presets[0]]

    _step(4, "the pytest gate is now armed: run it")
    print("  python -m pytest tests/test_goldens.py -q")

    _step(5, "render the seed-42 image for the visual diff")
    print(
        "  python -m imagdressing_tpu_torch.apps.dress --preset basic \\\n"
        f"      --base_dir {args.base_dir} --vae_path {args.vae_path} \\\n"
        f"      --image_encoder_path {args.image_encoder_path} \\\n"
        f"      --model_ckpt {args.model_ckpt} \\\n"
        "      --cloth_path <garment.jpg> --seed 42 --output_path parity_out\n"
        "  and compare against the reference's published outputs "
        "(assets/compare_magic2.png style).")

    report = {
        "mode": "weights",
        "device": args.device,
        "golden": golden,
        "manifest": mpath,
        "tensors_compared": sorted(errors),
        "worst_max_err": max(errors.values()),
        "ok": True,
    }
    rp = os.path.join(os.path.dirname(golden) or ".", "parity_report.json")
    with open(rp, "w", encoding="utf-8") as f:
        json.dump(report, f, indent=2)
    _step(6, f"PARITY OK -> {rp}")
    return report


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dry-run", action="store_true",
                   help="execute the full flow on the port's synthetic "
                        "stack (no weights needed)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--out_dir", default="parity_out",
                   help="dry-run artifact directory")
    p.add_argument("--golden", default="tests/goldens/ref_base.npz",
                   help="basic-preset golden path; other presets use "
                        "<stem>_<preset>.npz beside it")
    p.add_argument("--presets", default=",".join(PRESETS),
                   help="comma list of reference pipelines to verify")
    p.add_argument("--controlnet_path",
                   default="ckpt/control_v11p_sd15_openpose")
    p.add_argument("--ipa_ckpt", default=None,
                   help="IP-Adapter-FaceID-Plus .bin (ipa_pose: the "
                        "recorder's --ipa_ckpt)")
    p.add_argument("--base_dir", default="ckpt/Realistic_Vision_V4.0_noVAE")
    p.add_argument("--vae_path", default="ckpt/sd-vae-ft-mse")
    p.add_argument("--image_encoder_path", default="ckpt/image_encoder")
    p.add_argument("--model_ckpt", default="ckpt/IMAGDressing-v1_512.pt")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--steps", type=int, default=30)
    args = p.parse_args(argv)
    if args.dry_run:
        return run_dry(args.out_dir, args.device)
    return run_real(args)


if __name__ == "__main__":
    main()
