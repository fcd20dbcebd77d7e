"""Golden-activation replay and comparison (port of
`imagdressing_tpu/tools/record_reference.py`).

Seed-fixed numerical parity against the reference pipelines needs the
reference's diffusers stack and its checkpoints. The work splits in two:

  1. Recording runs in a diffusers environment with the reference's
     checkpoints: `python -m imagdressing_tpu.tools.record_reference record
     ...` (the JAX package's recorder; it imports torch, diffusers and
     transformers only) writes a golden .npz of deterministic intermediate
     tensors, the format both packages read. The port has no `record`: it
     runs the reference's own stack, which the port does not import.
  2. `replay` (here): build the port's stack from the golden's manifest,
     run the golden's recorded inputs through it in fp32 with TF32 off, and
     compare every recorded tensor at atol 5e-3 + rtol 1e-3 * max|golden|.

`record-synthetic` records a golden with the port's own small random stack
(no diffusers needed), so the same replay gate runs before weights exist.

    python -m imagdressing_tpu_torch.tools.record_reference replay \\
        --golden tests/goldens/ref_base.npz [--device cpu]

Every entry point runs on the card (`--device cuda`, the default) unless
asked for the CPU, and raises on a host without one.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from imagdressing_tpu_torch.pipelines.dressing import (
    Device,
    DressingModels,
    resize_nearest,
    resolve_device,
)
from imagdressing_tpu_torch.samplers import ddim

RECORD_SPEC = {
    # name: (description, producing call in the reference)
    "text_embeds": "CLIPTextModel(prompt_ids).last_hidden_state",
    "clip_vision_penult": "image_encoder(pixel, output_hidden_states=True).hidden_states[-2]",
    "cloth_tokens": "Resampler(clip_vision_penult)",
    "ref_latents": "vae.encode(ref_image).latent_dist.mean * 0.18215",
    "sa_hidden::<layer>": "CacheAttnProcessor caches per attn1 layer (cond half)",
    "eps_step0": "unet(latents, t0, ...) first-step noise prediction",
    "final_latents": "latents after the full DDIM loop",
}

# Per-preset extra surfaces: the basic spec alone would leave three of the
# four reference pipelines unverified.
PRESET_EXTRA_SPEC = {
    "basic": {},
    "pose": {
        "cn_down_res_step0::<i>": "ControlNet down-block residuals at the "
        "first step, cond half, conditioning_scale=1 "
        "(IMAGDressing_v1_pipeline_controlnet.py:586-626)",
        "cn_mid_res_step0": "ControlNet mid residual at the first step",
    },
    "ipa_pose": {
        "cn_down_res_step0::<i>": "as pose",
        "cn_mid_res_step0": "as pose",
        "face_clip_penult": "image_encoder(face_pixels).hidden_states[-2]",
        "face_tokens": "ProjPlusModel(faceid_embeds, face_clip_penult, "
        "shortcut=True) (IMAGDressing_v1_pipeline_ipa_controlnet.py:513-557, "
        "adapter/resampler.py:250)",
    },
    "inpaint": {
        "image_latents_nhwc": "vae.encode(person).latent_dist.mean * sf "
        "(IMAGDressing_v1_pipeline_controlnet_inpainting.py:350-362)",
        "mask_latent_nhwc": "nearest-resized inpaint mask at latent res",
        "recomposed_latents_step0_nhwc": "latents after DDIM step 0 + the "
        "timesteps[1] re-noise/paste recomposition (:487-500)",
    },
}

# the recorded inputs a golden carries besides its outputs
INPUT_KEYS = ("prompt_ids", "ref_image_nhwc", "clip_pixels_nhwc",
               "init_latents_nhwc", "steps", "preset", "pose_cond_nhwc",
               "faceid_embeds", "face_clip_pixels_nhwc", "person_image_nhwc",
               "mask_image_nhwc")

# the port's own synthetic goldens (the JAX package's "synthetic_small"
# names weights drawn by jax.random, which the port cannot rebuild)
SYNTHETIC_KIND = "synthetic_small_torch"


def missing_surfaces(names, preset: str):
    """The surfaces of RECORD_SPEC and of `preset`'s PRESET_EXTRA_SPEC that
    no name in `names` records."""
    missing = []
    for spec in {**RECORD_SPEC, **PRESET_EXTRA_SPEC.get(preset, {})}:
        prefix = spec.split("::")[0]
        if not any(n == spec or n.startswith(prefix) for n in names):
            missing.append(spec)
    return missing


def compare(golden_path: str, computed: Dict[str, np.ndarray],
            *, atol: float = 5e-3, rtol: float = 1e-3) -> Dict[str, float]:
    """Diff computed tensors against a golden .npz; returns max abs errors
    and raises AssertionError listing failures. A narrow golden must not
    read as full parity: one that lacks a spec surface (RECORD_SPEC and its
    preset's extras) fails, as does a key not computed, a shape or a value
    beyond atol + rtol * max|golden|."""
    with np.load(golden_path) as f:
        golden = dict(f)
    errors = {}
    preset = str(golden["preset"]) if "preset" in golden else "basic"
    failures = [f"golden lacks RECORD_SPEC surface {spec!r}: parity is not "
                "checked for it"
                for spec in missing_surfaces(golden, preset)]
    for name, want in golden.items():
        if want.dtype.kind in "US":  # metadata strings (e.g. "preset")
            continue
        if name not in computed:
            failures.append(f"{name}: not computed")
            continue
        got = np.asarray(computed[name], np.float32)
        if got.shape != want.shape:
            failures.append(f"{name}: shape {got.shape} vs {want.shape}")
            continue
        err = float(np.max(np.abs(got - want)))
        errors[name] = err
        tol = atol + rtol * float(np.max(np.abs(want)))
        if not err <= tol:
            failures.append(f"{name}: max err {err:.2e} > tol {tol:.2e}")
    if failures:
        raise AssertionError("golden mismatches:\n  " + "\n  ".join(failures))
    return errors


def manifest_path_for(golden_path: str) -> str:
    base = golden_path[:-4] if golden_path.endswith(".npz") else golden_path
    return base + ".manifest.json"


@contextlib.contextmanager
def fp32_precision():
    """fp32 parity mode on the card: cuDNN convolutions and cuBLAS products
    in full fp32 (PyTorch lets cuDNN run fp32 convolutions in TF32 by
    default); the settings are restored on the way out."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved[0]
        torch.backends.cuda.matmul.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def perturb_controlnet(models: DressingModels, seed: int = 9) -> None:
    """Every ControlNet parameter + 0.05 * N(0, 1) (numpy, in parameter
    order): a fresh ControlNet's output convs are zero, so its residuals
    would be exactly zero and no comparison of them could fail."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for prm in models.controlnet.parameters():
            noise = rng.standard_normal(tuple(prm.shape))
            prm.add_(torch.from_numpy(0.05 * noise).to(prm))


def synthetic_models(seed: int = 0, *, with_controlnet: bool = False,
                     with_ipa: bool = False, small: bool = True,
                     device: Device = "cuda") -> DressingModels:
    """The random stack of a synthetic golden: drawn on the CPU generator
    (the CPU's and the card's generators draw other numbers for one seed,
    so a golden recorded on one device replays on the other with the same
    weights), the ControlNet perturbed, then moved to `device`."""
    dev = resolve_device(device)
    models = DressingModels.init_random(
        seed, small=small, with_controlnet=with_controlnet,
        with_ipa=with_ipa, device="cpu")
    if with_controlnet:
        perturb_controlnet(models)
    for module in models.modules().values():
        module.to(dev)
    return models


def build_models_from_manifest(manifest: Dict,
                               device: Device = "cuda") -> DressingModels:
    """-> DressingModels per the manifest's "kind", in fp32 on `device`.

    synthetic_small_torch: the port's small random stack
    (`synthetic_models`). torch: the reference's checkpoints through
    `apps.loader.load_dressing_models`, with the ControlNet and the
    IP-Adapter-FaceID checkpoint where the manifest names them.
    synthetic_small (the JAX package's goldens): refused; those weights come
    from jax.random."""
    kind = manifest.get("kind")
    if kind == SYNTHETIC_KIND:
        return synthetic_models(
            int(manifest.get("seed", 0)),
            with_controlnet=bool(manifest.get("with_controlnet", False)),
            with_ipa=bool(manifest.get("with_ipa", False)), device=device)
    if kind == "torch":
        from imagdressing_tpu_torch.apps.loader import load_dressing_models

        return load_dressing_models(
            base_dir=manifest["base_dir"],
            vae_path=manifest["vae_path"],
            image_encoder_path=manifest["image_encoder_path"],
            model_ckpt=manifest.get("model_ckpt"),
            controlnet_path=manifest.get("controlnet_path"),
            ip_ckpt=manifest.get("ip_ckpt"),
            dtype=None,  # fp32 parity mode
            device=device)
    if kind == "synthetic_small":
        raise ValueError(
            "a 'synthetic_small' manifest names the JAX package's stack, "
            "drawn by jax.random, which the port cannot rebuild: pass "
            "models= built from that stack's parameters by "
            "convert.params_from_jax (DressingModels.from_jax_params)")
    raise ValueError(f"unknown golden-manifest kind {kind!r}")


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def compute_with_stack(golden: Dict[str, np.ndarray], models: DressingModels
                       ) -> Dict[str, np.ndarray]:
    """Replay the golden's recorded inputs through the port's stack on its
    device, fp32 with TF32 off, producing every RECORD_SPEC tensor the
    golden carries (same keys, NHWC layouts)."""
    dev = models.device

    def t(key, dtype=torch.float32):
        return torch.as_tensor(np.asarray(golden[key]), dtype=dtype,
                               device=dev)

    m = models
    computed: Dict[str, np.ndarray] = {
        k: golden[k] for k in INPUT_KEYS if k in golden}
    sched = ddim.make_schedule()
    steps = int(golden["steps"]) if "steps" in golden else 0
    ts = ddim.timesteps(sched, steps) if steps else None
    eps_cache = {}

    def eps0(text_embeds, lat0):
        # the first step's eps, shared by eps_step0, the loop's first step
        # and the inpaint recomposition
        if "eps" not in eps_cache:
            eps_cache["eps"] = m.unet(lat0, int(ts[0]), text_embeds).float()
        return eps_cache["eps"]

    with fp32_precision(), torch.inference_mode():
        text_embeds = m.text(t("prompt_ids", torch.long))
        computed["text_embeds"] = _np(text_embeds)

        clip_hidden = None
        if "clip_pixels_nhwc" in golden:
            clip_hidden = m.vision(t("clip_pixels_nhwc"), penultimate=True)
            computed["clip_vision_penult"] = _np(clip_hidden)
        if any(k == "cloth_tokens" or k.startswith("sa_hidden::")
               for k in golden):
            cloth_tokens = m.resampler(clip_hidden)
            computed["cloth_tokens"] = _np(cloth_tokens)

        ref_latents = None
        if "ref_image_nhwc" in golden:
            ref_latents = m.vae.encode_mean(t("ref_image_nhwc")) \
                * m.vae_cfg.scaling_factor
            computed["ref_latents_nhwc"] = _np(ref_latents)
        if any(k.startswith("sa_hidden::") for k in golden):
            # garment capture run at t=0 with cloth tokens (the reference's
            # CacheAttnProcessor pass, IMAGDressing_v1_pipeline.py:465-479)
            _, captured = m.ref_unet(ref_latents, 0, cloth_tokens,
                                     capture=True)
            for name, hidden in captured.items():
                computed[f"sa_hidden::{name}"] = _np(hidden)

        lat0 = t("init_latents_nhwc") if "init_latents_nhwc" in golden \
            else None

        # ---- ControlNet residual taps at the first step (pose/ipa_pose) ----
        if any(k.startswith("cn_down_res_step0::") for k in golden):
            cn = m.controlnet
            down_res, mid_res = cn(
                lat0, int(ts[0]), text_embeds,
                cond_emb=cn.cond_embedding(t("pose_cond_nhwc")),
                conditioning_scale=1.0)
            for i, r in enumerate(down_res):
                computed[f"cn_down_res_step0::{i:02d}"] = _np(r)
            computed["cn_mid_res_step0"] = _np(mid_res)

        # ---- ProjPlus face tokens (ipa_pose) --------------------------------
        if "face_tokens" in golden:
            face_hidden = m.vision(t("face_clip_pixels_nhwc"),
                                   penultimate=True)
            computed["face_clip_penult"] = _np(face_hidden)
            computed["face_tokens"] = _np(m.proj_plus(
                t("faceid_embeds"), face_hidden, shortcut=True, scale=1.0))

        # ---- Inpaint mask / masked latents + step-0 recomposition -----------
        if "recomposed_latents_step0_nhwc" in golden:
            image_latents = m.vae.encode_mean(t("person_image_nhwc")) \
                * m.vae_cfg.scaling_factor
            computed["image_latents_nhwc"] = _np(image_latents)
            mask_latent = resize_nearest(t("mask_image_nhwc"),
                                         *lat0.shape[1:3])
            computed["mask_latent_nhwc"] = _np(mask_latent)
            lat1 = ddim.step(sched, eps0(text_embeds, lat0), int(ts[0]),
                             lat0, steps)
            # strength=1.0 schedule: init latents ARE the noise; re-noise the
            # known region to timesteps[1] and paste (pipeline post_fn)
            init_proper = ddim.add_noise(sched, image_latents, lat0,
                                         int(ts[1]))
            computed["recomposed_latents_step0_nhwc"] = _np(
                (1.0 - mask_latent) * init_proper + mask_latent * lat1)

        if "eps_step0_nhwc" in golden or "final_latents_nhwc" in golden:
            computed["eps_step0_nhwc"] = _np(eps0(text_embeds, lat0))
            if "final_latents_nhwc" in golden:
                lat = lat0
                for i, step_t in enumerate(ts):
                    eps = eps0(text_embeds, lat0) if i == 0 \
                        else m.unet(lat, int(step_t), text_embeds).float()
                    lat = ddim.step(sched, eps, int(step_t), lat, steps)
                computed["final_latents_nhwc"] = _np(lat)
    return computed


def replay(golden_path: str, models: Optional[DressingModels] = None, *,
           atol: float = 5e-3, rtol: float = 1e-3,
           device: Device = "cuda") -> Dict[str, float]:
    """The armed golden gate: build the stack from the golden's manifest
    (or $IMAGDRESSING_GOLDEN_MANIFEST) on `device` unless `models` is
    given, replay, and compare. Raises AssertionError on a mismatch,
    FileNotFoundError when no manifest exists."""
    with np.load(golden_path) as f:
        golden = dict(f)
    if models is None:
        mpath = os.environ.get("IMAGDRESSING_GOLDEN_MANIFEST",
                               manifest_path_for(golden_path))
        if not os.path.exists(mpath):
            raise FileNotFoundError(
                f"golden {golden_path} has no weights manifest at {mpath} "
                "(set IMAGDRESSING_GOLDEN_MANIFEST or drop a "
                ".manifest.json beside it)")
        with open(mpath, "r", encoding="utf-8") as f:
            models = build_models_from_manifest(json.load(f), device)
    computed = compute_with_stack(golden, models)
    return compare(golden_path, computed, atol=atol, rtol=rtol)


def synthetic_inputs(models: DressingModels, preset: str, *, seed: int = 0,
                     steps: int = 4, size: int = 64
                     ) -> Dict[str, np.ndarray]:
    """The recorded inputs of a synthetic `preset` golden at size x size
    (numpy from `seed`), with a None placeholder for each output to
    record, the full spec surface of the preset."""
    if preset not in PRESET_EXTRA_SPEC:
        raise ValueError(
            f"unknown preset {preset!r}; expected {sorted(PRESET_EXTRA_SPEC)}")
    rng = np.random.default_rng(seed)
    h = w = size
    vs = models.vision_cfg.image_size
    f32 = np.float32
    want = {
        "prompt_ids": rng.integers(
            0, models.text_cfg.vocab_size, (1, 77)).astype(np.int32),
        "ref_image_nhwc": rng.standard_normal((1, h, w, 3)).astype(
            f32).clip(-1, 1),
        "clip_pixels_nhwc": rng.standard_normal((1, vs, vs, 3)).astype(f32),
        "init_latents_nhwc": rng.standard_normal(
            (1, h // 8, w // 8, 4)).astype(f32),
        "steps": np.int32(steps),
        "preset": np.str_(preset),
        "eps_step0_nhwc": None,
        "final_latents_nhwc": None,
        "cloth_tokens": None,
        "sa_hidden::_probe": None,  # triggers the capture pass
    }
    if preset in ("pose", "ipa_pose"):
        want["pose_cond_nhwc"] = rng.random((1, h, w, 3)).astype(f32)
        want["cn_down_res_step0::_probe"] = None
    if preset == "ipa_pose":
        want["faceid_embeds"] = rng.standard_normal(
            (1, models.projplus_cfg.id_embeddings_dim)).astype(f32)
        want["face_clip_pixels_nhwc"] = rng.standard_normal(
            (1, vs, vs, 3)).astype(f32)
        want["face_tokens"] = None
    if preset == "inpaint":
        want["person_image_nhwc"] = rng.standard_normal(
            (1, h, w, 3)).astype(f32).clip(-1, 1)
        want["mask_image_nhwc"] = (
            rng.random((1, h, w, 1)) > 0.5).astype(f32)
        want["recomposed_latents_step0_nhwc"] = None
    return want


def record_golden(out_path: str, models: DressingModels, preset: str, *,
                  seed: int = 0, steps: int = 4, size: int = 64
                  ) -> Dict[str, np.ndarray]:
    """Record `preset`'s synthetic golden with `models` to `out_path`;
    returns what was written."""
    computed = compute_with_stack(
        synthetic_inputs(models, preset, seed=seed, steps=steps, size=size),
        models)
    computed["preset"] = np.str_(preset)
    np.savez_compressed(out_path, **computed)
    return computed


def record_synthetic(out_path: str, *, seed: int = 0, steps: int = 4,
                     preset: str = "basic", device: Device = "cuda") -> None:
    """Record a full-surface golden with the port's OWN small random stack
    (no diffusers needed), and its manifest beside it: the artifact runs
    through the same replay gate a real reference golden does. `preset`
    also records that pipeline's extra surfaces (PRESET_EXTRA_SPEC)."""
    if preset not in PRESET_EXTRA_SPEC:
        raise ValueError(
            f"unknown preset {preset!r}; expected {sorted(PRESET_EXTRA_SPEC)}")
    manifest = {
        "kind": SYNTHETIC_KIND, "seed": seed,
        "with_controlnet": preset in ("pose", "ipa_pose", "inpaint"),
        "with_ipa": preset == "ipa_pose",
    }
    models = build_models_from_manifest(manifest, device)
    record_golden(out_path, models, preset, seed=seed, steps=steps)
    mpath = manifest_path_for(out_path)
    with open(mpath, "w", encoding="utf-8") as f:
        json.dump(manifest, f)
    print(f"recorded synthetic golden ({preset})", out_path, "+", mpath)


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)
    sub.add_parser("spec", help="print the tensors a recorder must dump")
    pc = sub.add_parser("compare")
    pc.add_argument("--golden", required=True)
    pc.add_argument("--computed", required=True,
                    help=".npz computed by the port with matching keys")
    pp = sub.add_parser(
        "replay", help="build the stack from the golden's manifest, replay "
                       "its inputs through the port's models, and compare")
    pp.add_argument("--golden", required=True)
    ps = sub.add_parser(
        "record-synthetic",
        help="record a small-random-stack golden + manifest (arms the gate "
             "without reference weights)")
    ps.add_argument("--out", default="ref_synthetic_torch.npz")
    ps.add_argument("--seed", type=int, default=0)
    ps.add_argument("--steps", type=int, default=4)
    ps.add_argument("--preset", default="basic",
                    choices=sorted(PRESET_EXTRA_SPEC))
    for sp in (pp, ps):
        sp.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.cmd == "spec":
        print(json.dumps(RECORD_SPEC, indent=2))
    elif args.cmd == "replay":
        errors = replay(args.golden, device=args.device)
        print(json.dumps({k: round(v, 8) for k, v in errors.items()},
                         indent=2))
        print("PARITY OK")
    elif args.cmd == "record-synthetic":
        record_synthetic(args.out, seed=args.seed, steps=args.steps,
                         preset=args.preset, device=args.device)
    else:
        errors = compare(args.golden, dict(np.load(args.computed)))
        print(json.dumps({k: round(v, 8) for k, v in errors.items()},
                         indent=2))
        print("PARITY OK")


if __name__ == "__main__":
    main()
