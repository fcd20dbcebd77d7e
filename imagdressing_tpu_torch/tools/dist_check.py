"""Two ranks against one process, on the mini stack (a small fp32 stack
whose head dims suit the card's kernels): the ZeRO-2 and tensor-parallel
training steps, a split checkpoint, data- and tensor-parallel generation,
the server's broadcast rounds and the parser's synced fine-tune step.

    python -m imagdressing_tpu_torch.tools.dist_check [--device cpu]

starts two gloo ranks (`parallel.launch.spawn`; on a card both share it,
which NCCL refuses), runs `rank_main` in each and `single` in this process
on the same inputs, and prints each result's largest difference from the
one-process run. `tests/test_torch_parallel.py` (CPU, also against the JAX
package's steps) and `chip_smoke.py`'s dist_check phase (the card) call the
same functions.

Each scenario's inputs are numpy arrays from a seed; the draws of the
training steps can be given (the CPU tests pass the JAX package's).
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import os
import tempfile
from typing import Any, Dict, Optional

import numpy as np
import torch

# the global batch of the training scenarios and its image size
TRAIN_B, TRAIN_HW = 2, 64
# a ragged batch for data-parallel generation (padded to 4 over 2 ranks)
GEN_B, GEN_HW, GEN_STEPS = 3, 64, 2
# the parser's fine-tune: SCHP at full width, 64x64, 6 classes, batch 2;
# every bottleneck's bn3.weight at 0.25 (test_torch_parsing_steps.py: the
# random-init net in train mode amplifies rounding ~1e5x at gamma 1)
PARSER_CLASSES, PARSER_HW, PARSER_B = 6, 64, 2
# parameters and statistics of the parser kept for the comparisons
PARSER_LEAVES = ("conv1.weight", "bn1.weight", "layer1.0.conv1.weight",
                 "layer4.2.bn3.weight", "fushion.conv2.weight",
                 "fushion.conv2.bias", "edge.conv4.weight")
PARSER_STATS = ("bn1.running_mean", "bn1.running_var",
                "layer4.2.bn3.running_mean", "layer4.2.bn3.running_var")


def mini_models():
    """The mini stack in fp32 on the CPU, randomly initialised from a CPU
    generator (so the same weights on any device it moves to)."""
    from imagdressing_tpu_torch.core import config as C
    from imagdressing_tpu_torch.models.clip import CLIPText, CLIPVision
    from imagdressing_tpu_torch.models.resampler import Resampler
    from imagdressing_tpu_torch.models.unet import (
        UNet,
        init_ref_adapters_from_unet,
    )
    from imagdressing_tpu_torch.models.vae import VAE
    from imagdressing_tpu_torch.ops.nn import init_module
    from imagdressing_tpu_torch.pipelines.dressing import DressingModels

    cfgs = dict(
        unet_cfg=C.UNetConfig(block_out_channels=(32, 64, 64, 64),
                              cross_attention_dim=32, attention_num_heads=4,
                              norm_num_groups=8),
        vae_cfg=C.VAEConfig(block_out_channels=(32, 32, 64, 64),
                            norm_num_groups=8),
        text_cfg=C.CLIPTextConfig(vocab_size=256, hidden_size=32,
                                  intermediate_size=64, num_layers=2,
                                  num_heads=4),
        vision_cfg=C.CLIPVisionConfig(hidden_size=48, intermediate_size=96,
                                      num_layers=3, num_heads=4,
                                      image_size=56, patch_size=14,
                                      projection_dim=32),
        resampler_cfg=C.ResamplerConfig(dim=32, depth=1, dim_head=8, heads=4,
                                        num_queries=8, embedding_dim=48,
                                        output_dim=32),
    )
    gen = torch.Generator().manual_seed(0)
    mods = dict(unet=UNet(cfgs["unet_cfg"]), ref_unet=UNet(cfgs["unet_cfg"]),
                resampler=Resampler(cfgs["resampler_cfg"]),
                vae=VAE(cfgs["vae_cfg"]), text=CLIPText(cfgs["text_cfg"]),
                vision=CLIPVision(cfgs["vision_cfg"]))
    for m in mods.values():
        init_module(m, gen)
    mods["ref_adapters"] = init_ref_adapters_from_unet(mods["unet"])
    for m in mods.values():
        m.eval().requires_grad_(False)
    return DressingModels(**cfgs, **mods)


def mini_preset_models():
    """The mini stack with a ControlNet and the IP adapters + ProjPlus, drawn
    from the same CPU generator after the mini stack's own; every ControlNet
    leaf perturbed by 0.05 * N(0, 1) (its output convs start at zero)."""
    from imagdressing_tpu_torch.core.config import (
        ControlNetConfig,
        ProjPlusConfig,
    )
    from imagdressing_tpu_torch.models.controlnet import ControlNet
    from imagdressing_tpu_torch.models.resampler import ProjPlus
    from imagdressing_tpu_torch.models.unet import IPAdapters
    from imagdressing_tpu_torch.ops.nn import init_module

    models = mini_models()
    ucfg = models.unet_cfg
    models.controlnet_cfg = ControlNetConfig(unet=ucfg)
    models.projplus_cfg = ProjPlusConfig(
        cross_attention_dim=32, id_embeddings_dim=16, clip_embeddings_dim=48,
        num_tokens=4, depth=1, dim_head=8)
    models.controlnet = ControlNet(models.controlnet_cfg)
    models.ip_adapters = IPAdapters(ucfg)
    models.proj_plus = ProjPlus(models.projplus_cfg)
    gen = torch.Generator().manual_seed(1)
    for name in ("controlnet", "ip_adapters", "proj_plus"):
        m = getattr(models, name)
        init_module(m, gen)
        m.eval().requires_grad_(False)
    with torch.no_grad():
        for prm in models.controlnet.parameters():
            prm.add_(0.05 * torch.randn(prm.shape, generator=gen))
    return models


def _to(models, device):
    for m in models.modules().values():
        m.to(device)
    return models


def train_batch(seed: int = 3) -> Dict[str, np.ndarray]:
    """The training scenarios' global batch (numpy, from a seed)."""
    rng = np.random.default_rng(seed)
    b, hw = TRAIN_B, TRAIN_HW
    return {
        "person_image": rng.uniform(-1, 1, (b, hw, hw, 3)).astype(np.float32),
        "cloth_image": rng.uniform(-1, 1, (b, hw, hw, 3)).astype(np.float32),
        "cloth_clip": rng.standard_normal((b, 56, 56, 3)).astype(np.float32),
        "text_ids": rng.integers(0, 256, (b, 77)).astype(np.int64),
    }


def port_draws(steps: int = 2) -> list:
    """Per step, the global batch's draws as the port makes them (seed 0)."""
    from imagdressing_tpu_torch.train import step as tstep

    return [{f.name: getattr(d, f.name).numpy()
             for f in dataclasses.fields(tstep.Draws)}
            for d in (tstep.make_draws(0, i, range(TRAIN_B),
                                       (TRAIN_HW // 8, TRAIN_HW // 8, 4),
                                       1000, "cpu") for i in range(steps))]


def train_config():
    """The recipe of the training golden (tests/test_train.py's): lr 1e-3
    after a warmup of 2 (the first update is a no-op)."""
    from imagdressing_tpu_torch.core.config import TrainConfig

    return TrainConfig(train_batch_size=TRAIN_B, warmup_steps=2,
                       learning_rate=1e-3)


def gen_inputs(b: int = GEN_B, seed: int = 5) -> Dict[str, np.ndarray]:
    """Every input of `basic` and `pose` at GEN_HW, with explicit latents."""
    rng = np.random.default_rng(seed)
    hw = GEN_HW
    return dict(
        prompt_ids=rng.integers(0, 256, (b, 77)),
        negative_prompt_ids=rng.integers(0, 256, (b, 77)),
        ref_image=rng.uniform(-1, 1, (b, hw, hw, 3)).astype(np.float32),
        ref_clip_image=rng.standard_normal((b, 56, 56, 3)).astype(np.float32),
        latents=rng.standard_normal((b, hw // 8, hw // 8, 4)).astype(
            np.float32),
        pose_image=rng.random((b, hw, hw, 3)).astype(np.float32))


def gen_preset(name: str):
    from imagdressing_tpu_torch.core.config import PRESETS

    return dataclasses.replace(PRESETS[name], height=GEN_HW, width=GEN_HW,
                               num_inference_steps=GEN_STEPS)


def parser_batch(seed: int = 0) -> Dict[str, np.ndarray]:
    from imagdressing_tpu_torch.train.parsing_train import edges_from_labels

    rng = np.random.default_rng(seed)
    b, hw = PARSER_B, PARSER_HW
    batch = {"image": rng.standard_normal((b, hw, hw, 3)).astype(np.float32),
             "label": rng.integers(0, PARSER_CLASSES, (b, hw, hw)).astype(
                 np.int32)}
    batch["edge"] = edges_from_labels(batch["label"])
    return batch


def parser_net(device):
    """SCHP at full width from `schp.init(0)`, every bn3.weight at 0.25."""
    from imagdressing_tpu_torch.preprocess.parsing import model as schp

    net = schp.init(0, PARSER_CLASSES, device)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith("bn3.weight"):
                p.fill_(0.25)
    return net.requires_grad_(True)


def parser_config():
    from imagdressing_tpu_torch.train.parsing_train import ParsingTrainConfig

    # Lovász sorts the errors of the whole batch: not split by rank (the
    # JAX package's sharded test turns it off too)
    return ParsingTrainConfig(num_classes=PARSER_CLASSES, learning_rate=2e-2,
                              total_steps=100, lovasz_weight=0.0)


# ---------------------------------------------------------------------------
# the scenarios, on one rank of a mesh (mesh=None: one process)
# ---------------------------------------------------------------------------


def _tensors(arrays: Dict[str, np.ndarray], device, rows=slice(None)):
    return {k: torch.as_tensor(np.asarray(v)[rows]).to(device)
            for k, v in arrays.items()}


def _rows(mesh, b: int) -> slice:
    if mesh is None:
        return slice(None)
    lb = b // mesh.data
    return slice(mesh.data_rank * lb, (mesh.data_rank + 1) * lb)


def _flat_host(state) -> Dict[str, np.ndarray]:
    """The trainables and the moments of a state in the whole host form."""
    from imagdressing_tpu_torch.train import step as tstep

    host = tstep.state_to_host(state)
    params = torch.cat([t.reshape(-1).float()
                        for k in tstep.TRAINABLE_KEYS
                        for t in host["params"][k].values()])
    return {"params": params.numpy(),
            "mu": host["opt_state"]["mu"].float().numpy(),
            "nu": host["opt_state"]["nu"].numpy()}


def train_steps(kind: str, device, mesh, draws, batch, ckpt_dir=None
                ) -> Dict[str, Any]:
    """Two steps of the mini stack: kind "single" (`make_train_step` on the
    whole batch), "zero2" (`shard_train_step`, this rank's rows) or "tp"
    (`tp_train_step`, the whole batch). -> losses, grad norms, the whole
    trainables and moments after, the local moments' length; zero2 also
    saves a checkpoint into `ckpt_dir` and then makes a step with a NaN in
    data rank 0's first image, which must change nothing."""
    from imagdressing_tpu_torch.train import step as tstep
    from imagdressing_tpu_torch.train.checkpoint import CheckpointManager

    models = _to(mini_models(), device)
    cfg = train_config()
    state, frozen, tx = tstep.init_train_state(models, cfg)
    if kind == "single":
        step = tstep.make_train_step(models, cfg, tx)
    else:
        make = tstep.shard_train_step if kind == "zero2" \
            else tstep.tp_train_step
        step, state, frozen = make(models, cfg, tx, mesh, state, frozen)
    rows = _rows(mesh, TRAIN_B) if kind == "zero2" else slice(None)
    local = _tensors(batch, device, rows)
    out: Dict[str, Any] = {"loss": [], "grad_norm": []}
    for d in draws:
        draw = tstep.Draws(**_tensors(d, device, rows))
        state, m = step(state, frozen, local, 1, draws=draw)
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
    out.update(_flat_host(state))
    out["local_moments"] = int(state.opt_state.mu.numel())
    if kind != "zero2":
        return out
    if ckpt_dir is not None:
        ckpt = CheckpointManager(ckpt_dir, async_save=False,
                                 rank=mesh.rank, group=mesh.world_group)
        ckpt.save(state, {"step": state.step})
        ckpt.wait()
    before = [p.detach().clone()
              for p in tstep.trainable_parameters(state.params)]
    opt_before = dataclasses.replace(state.opt_state)
    bad = {k: v.clone() for k, v in local.items()}
    if mesh.data_rank == 0:
        bad["person_image"][0, 0, 0, 0] = float("nan")
    draw = tstep.Draws(**_tensors(draws[-1], device, rows))
    after, m = step(state, frozen, bad, 1, draws=draw)
    out["nonfinite_grad_norm"] = float(m["grad_norm"])
    out["nonfinite_params_kept"] = all(
        torch.equal(a, b) for a, b in zip(
            before, tstep.trainable_parameters(after.params)))
    out["nonfinite_opt_kept"] = all(
        torch.equal(getattr(after.opt_state, f), getattr(opt_before, f))
        for f in ("mu", "nu")) and after.opt_state.count == opt_before.count
    return out


def tp_forward(device, mesh) -> np.ndarray:
    """The main UNet of the mini stack, split over the mesh's model group
    (unsplit without one), on numpy inputs with the garment K/V (parallel
    mode, per-row scale) and the text K/V precomputed."""
    from imagdressing_tpu_torch.core import tp as tp_lib
    from imagdressing_tpu_torch.models.conditioning import Conditioning
    from imagdressing_tpu_torch.models.unet import (
        precompute_cross_kv,
        precompute_ref_kv,
    )

    models = _to(mini_models(), device)
    if mesh is not None:
        tp_lib.split_models(models, mesh)
    rng = np.random.default_rng(11)
    x = torch.as_tensor(rng.standard_normal((2, 16, 16, 4)),
                        dtype=torch.float32, device=device)
    ctx = torch.as_tensor(rng.standard_normal((2, 77, 32)),
                          dtype=torch.float32, device=device)
    with torch.inference_mode():
        _, captured = models.ref_unet(x, 0, ctx[:, :8], capture=True)
        cond = Conditioning(
            ref_kv=precompute_ref_kv(models.ref_adapters, captured),
            ref_scale=torch.tensor([0.0, 1.0], device=device),
            cross_kv=precompute_cross_kv(models.unet, ctx))
        out = models.unet(x, torch.tensor([5, 500], device=device), ctx,
                          cond)
    return out.float().cpu().numpy()


def generate(kind: str, device, mesh=None, control=None) -> np.ndarray:
    """`pose` on the ragged batch (kind "pose": over the data group, or each
    row alone without a mesh), `pose` on its first two rows through the
    server's `MeshPipe` / `follow` rounds ("serve"), or `basic` on two rows
    (kind "basic": the UNets split over the mesh's model group, or whole
    without a mesh). -> images (B, H, W, 3) in [0, 1]."""
    from imagdressing_tpu_torch.apps.serve import MeshPipe, follow
    from imagdressing_tpu_torch.pipelines.dressing import DressingPipeline
    from imagdressing_tpu_torch.tools.profile_infer import fill_zero_convs

    inputs = gen_inputs()
    if kind == "basic":
        models = _to(mini_models(), device)
        pipe = DressingPipeline(models, gen_preset("basic"), device=device,
                                mesh=mesh)
        two = {k: v[:2] for k, v in inputs.items() if k != "pose_image"}
        return pipe(**two)
    models = _to(mini_preset_models(), device)
    fill_zero_convs(models.controlnet)
    pipe = DressingPipeline(models, gen_preset("pose"), device=device,
                            mesh=mesh)
    if kind == "serve":
        two = {k: v[:2] for k, v in inputs.items()}
        if mesh.rank != 0:
            follow(pipe, control)
            return None
        served = MeshPipe(pipe, control)
        try:
            return served(**two)
        finally:
            served.close()
    if mesh is not None:
        return pipe(**inputs)
    return np.concatenate([pipe(**{k: v[i:i + 1] for k, v in inputs.items()})
                           for i in range(GEN_B)])


def parser_step(device, mesh=None) -> Dict[str, Any]:
    """One fine-tune step of the parser: over the mesh's data group
    (`shard_parsing_train_step`, this rank's rows) or on one process (the
    whole batch). -> the loss, PARSER_LEAVES' update, PARSER_STATS after."""
    from imagdressing_tpu_torch.train.parsing_train import (
        make_optimizer,
        make_parsing_train_step,
        shard_parsing_train_step,
    )

    net = parser_net(device)
    cfg = parser_config()
    opt = make_optimizer(cfg, net)
    sd = net.state_dict()
    before = {k: sd[k].detach().clone() for k in PARSER_LEAVES}
    if mesh is None:
        step = make_parsing_train_step(cfg, net, opt)
    else:
        step = shard_parsing_train_step(cfg, net, opt, mesh)
    batch = _tensors(parser_batch(), device, _rows(mesh, PARSER_B))
    loss = float(step(0, batch)["loss"])
    sd = net.state_dict()
    out = {"loss": loss}
    for k in PARSER_LEAVES:
        out[f"update/{k}"] = (sd[k] - before[k]).cpu().numpy()
    for k in PARSER_STATS:
        out[f"stat/{k}"] = sd[k].cpu().numpy()
    return out


def _counts() -> Dict[str, int]:
    from imagdressing_tpu_torch.kernels import (
        flash_attention as fa,
        fused_bn_act as fba,
        fused_gn_conv as fgc,
        fused_groupnorm as fg,
    )

    return {"flash_fwd": fa.COUNTER.count,
            "flash_fwd_res": fa.RES_COUNTER.count,
            "flash_bwd_dkv": fa.DKV_COUNTER.count,
            "flash_bwd_dq": fa.DQ_COUNTER.count,
            "gn_silu_conv3x3": fgc.COUNTER.count,
            "group_norm_act": fg.COUNTER.count, "bn_act": fba.COUNTER.count}


def _reset_counts() -> None:
    from imagdressing_tpu_torch.kernels import (
        flash_attention as fa,
        fused_bn_act as fba,
        fused_gn_conv as fgc,
        fused_groupnorm as fg,
    )

    for c in (fa.COUNTER, fa.RES_COUNTER, fa.DKV_COUNTER, fa.DQ_COUNTER,
              fgc.COUNTER, fg.COUNTER, fba.COUNTER):
        c.reset()


def _counted(fn, launches: Dict[str, Dict[str, int]], name: str):
    _reset_counts()
    out = fn()
    launches[name] = _counts()
    return out


# ---------------------------------------------------------------------------
# the ranks and the one-process run
# ---------------------------------------------------------------------------


def rank_main(spec: Dict[str, Any]) -> Dict[str, Any]:
    """One rank of the 2-rank world (`parallel.launch.spawn`): joins over
    gloo on spec["device"] (both ranks on one card there), runs the
    scenarios of spec["parts"] and returns their results (numpy) and each
    scenario's kernel launches on this rank."""
    from imagdressing_tpu_torch.core import mesh as mesh_lib

    device = mesh_lib.init_from_env(
        "gloo", device_type=spec["device"], share_devices=True,
        timeout=datetime.timedelta(seconds=spec.get("timeout_s", 120)))
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        data = mesh_lib.make_mesh(2, 1, device=device)
        model = mesh_lib.make_mesh(1, 2, device=device)
        control = torch.distributed.new_group(backend="gloo")
        parts = spec["parts"]
        out: Dict[str, Any] = {"launches": {}}
        n = out["launches"]
        if "train" in parts:
            out["zero2"] = _counted(lambda: train_steps(
                "zero2", device, data, spec["draws"], spec["batch"],
                spec.get("ckpt_dir")), n, "zero2")
            out["tp"] = _counted(lambda: train_steps(
                "tp", device, model, spec["draws"], spec["batch"]), n, "tp")
            out["tp_forward"] = tp_forward(device, model)
        if "generate" in parts:
            out["pose"] = _counted(lambda: generate("pose", device, data), n,
                                   "pose")
            out["serve"] = generate("serve", device, data, control)
            out["basic_tp"] = generate("basic", device, model)
        if "parser" in parts:
            out["parser"] = _counted(lambda: parser_step(device, data), n,
                                     "parser")
        return out
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
        mesh_lib.destroy()


def single(spec: Dict[str, Any]) -> Dict[str, Any]:
    """The same scenarios on one process, on the whole batches."""
    device = torch.device(spec["device"])
    parts = spec["parts"]
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        out: Dict[str, Any] = {}
        if "train" in parts:
            out["train"] = train_steps("single", device, None, spec["draws"],
                                       spec["batch"])
            out["tp_forward"] = tp_forward(device, None)
        if "generate" in parts:
            out["pose"] = generate("pose", device)
            out["basic"] = generate("basic", device)
        if "parser" in parts:
            out["parser"] = parser_step(device)
        return out
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def make_spec(device: str, parts=("train", "generate", "parser"),
              draws: Optional[list] = None, ckpt_dir: Optional[str] = None
              ) -> Dict[str, Any]:
    return {"device": device, "parts": tuple(parts),
            "draws": port_draws() if draws is None else draws,
            "batch": train_batch(), "ckpt_dir": ckpt_dir}


def run_ranks(spec: Dict[str, Any], threads: Optional[int] = None,
              timeout: float = 600.0) -> list:
    from imagdressing_tpu_torch.parallel import launch

    return launch.spawn(rank_main, 2, (spec,), timeout=timeout,
                        threads=threads)


def differences(ranks: list, one: Dict[str, Any]) -> Dict[str, float]:
    """The largest difference of each 2-rank result from the one-process
    run (relative for losses and norms, absolute otherwise), and between
    the ranks where both hold the result."""
    r0, r1 = ranks
    d: Dict[str, float] = {}

    def rel(a, b):
        return float(np.max(np.abs(np.asarray(a) - np.asarray(b))
                            / np.abs(np.asarray(b))))

    def ab(a, b):
        return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))

    if "zero2" in r0:
        for kind in ("zero2", "tp"):
            for k in ("loss", "grad_norm"):
                d[f"{kind}/{k}"] = rel(r0[kind][k], one["train"][k])
            for k in ("params", "mu", "nu"):
                d[f"{kind}/{k}"] = ab(r0[kind][k], one["train"][k])
                d[f"{kind}/{k}/ranks"] = ab(r0[kind][k], r1[kind][k])
        d["tp_forward"] = ab(r0["tp_forward"], one["tp_forward"])
    if "pose" in r0:
        d["pose"] = ab(r0["pose"], one["pose"])
        d["pose/ranks"] = ab(r0["pose"], r1["pose"])
        d["serve"] = ab(r0["serve"], one["pose"][:2])
        d["basic_tp"] = ab(r0["basic_tp"], one["basic"])
    if "parser" in r0:
        p, q = r0["parser"], one["parser"]
        d["parser/loss"] = rel(p["loss"], q["loss"])
        d["parser/update_l2"] = max(
            float(np.linalg.norm(p[f"update/{k}"] - q[f"update/{k}"])
                  / np.linalg.norm(q[f"update/{k}"])) for k in PARSER_LEAVES)
        d["parser/stats"] = max(ab(p[f"stat/{k}"], q[f"stat/{k}"])
                                for k in PARSER_STATS)
    return d


def main(argv=None) -> None:
    import json

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        spec = make_spec(args.device, ckpt_dir=os.path.join(tmp, "ckpt"))
        ranks = run_ranks(spec, threads=2 if args.device == "cpu" else None)
    print(json.dumps(differences(ranks, single(spec)), indent=1))


if __name__ == "__main__":
    main()
