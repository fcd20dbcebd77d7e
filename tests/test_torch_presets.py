"""The port's presets beyond `basic` (cartoon, pose, ipa_pose, inpaint) and
its samplers (DDIM with eta >= 0, DPM-Solver++(2M), UniPC) against the JAX
package.

One JAX small stack (`DressingModels.init_random(PRNGKey(0), small=True,
with_controlnet=True, with_ipa=True)`, the stack of the
`ref_synthetic_{pose,ipa_pose,inpaint}.npz` goldens) is built once. A fresh
ControlNet's output convs are zero, so its residuals are exactly zero; the
parity tests and the presets golden therefore perturb every ControlNet leaf
by 0.05 * N(0, 1) (numpy, seed 9). The perturbed stack is converted with
`params_from_jax`; the unperturbed ControlNet is kept for the golden replay.
Each module is held against its JAX function on the same inputs (numpy
from a seed), at `replay()`'s tolerance, atol 5e-3 + rtol 1e-3 * max|want|,
unless a test says otherwise; the pipelines against
`tests/goldens/torch_presets_tiny.npz` (JAX `DressingPipeline` outputs,
64x64, 4 steps, explicit latents) within atol 2e-3. Everything runs in fp32
on the CPU (each kernel's plain version).

Re-record the presets golden (JAX on the CPU, a few minutes of compile):

    JAX_PLATFORMS=cpu python tests/test_torch_presets.py

The stack's parameters come from `tests/goldens/jax_small_stack.npz`, what
`init_random` gives them (its eager calls compile a few hundred small XLA
programs, ~40 s in a fresh process), laid into the tree that tracing
`init_random` gives (`jax.eval_shape`: no compile); `test_torch_pipeline.py`
reads the same file. Re-record it with `JAX_PLATFORMS=cpu python
tests/test_torch_presets.py stack`; `test_small_stack_golden_is_current`
(slow) checks it against a live `init_random`.
"""

import copy
import dataclasses
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagdressing_tpu.core.config import PRESETS as JAX_PRESETS
from imagdressing_tpu.core.config import UNetConfig as JaxUNetConfig
from imagdressing_tpu.models import conditioning as jcond
from imagdressing_tpu.models import controlnet as jcontrolnet
from imagdressing_tpu.models import resampler as jresampler
from imagdressing_tpu.models import unet as junet
from imagdressing_tpu.pipelines.dressing import DressingModels as JaxModels
from imagdressing_tpu.pipelines.dressing import (
    DressingPipeline as JaxPipeline,
)
from imagdressing_tpu.samplers import ddim as jddim
from imagdressing_tpu.samplers import dpm as jdpm
from imagdressing_tpu.samplers import unipc as junipc
from imagdressing_tpu_torch.convert import params_from_jax, state_dict_from_jax
from imagdressing_tpu_torch.core import profiling
from imagdressing_tpu_torch.core.config import PRESETS, UNetConfig
from imagdressing_tpu_torch.models.conditioning import Conditioning, fold_lora
from imagdressing_tpu_torch.models.controlnet import ControlNet
from imagdressing_tpu_torch.models.unet import Attention, UNet, adapter_key
from imagdressing_tpu_torch.pipelines.dressing import (
    DressingModels,
    DressingPipeline,
    resize_nearest,
)
from imagdressing_tpu_torch.samplers import ddim, dpm, unipc
from imagdressing_tpu_torch.tools.record_reference import (
    INPUT_KEYS,
    PRESET_EXTRA_SPEC,
    compute_with_stack,
)

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
PRESETS_GOLDEN = os.path.join(GOLDENS, "torch_presets_tiny.npz")
MODULES_GOLDEN = os.path.join(GOLDENS, "jax_preset_modules_tiny.npz")
STACK_GOLDEN = os.path.join(GOLDENS, "jax_small_stack.npz")
ATOL, RTOL = 5e-3, 1e-3
# the golden's cases: (preset, preset overrides, call arguments), 64x64,
# 4 steps
CASES = {
    "pose": ("pose", {}, {}),
    "pose_window_end_0.5": ("pose", {}, {"control_guidance_end": 0.5}),
    "ipa_pose": ("ipa_pose", {}, {}),
    "inpaint": ("inpaint", {"strength": 0.99}, {}),
    "inpaint_dpm2m": ("inpaint", {"strength": 0.75, "sampler": "dpm2m"}, {}),
    "pose_unipc": ("pose", {"sampler": "unipc"}, {}),
}


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _close(got, want, what=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = ATOL + RTOL * float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{what}: max err {err:.3g} > {tol:.3g}"


def _perturb(tree, seed=9):
    """Every leaf + 0.05 * N(0, 1) (numpy), so the zero-init output convs
    of a fresh ControlNet give residuals that are not zero."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(a.dtype),
        tree)


def _path_key(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)


def _init_small(key):
    return JaxModels.init_random(key, small=True, with_controlnet=True,
                                 with_ipa=True)


def record_small_stack():
    """`_init_small(PRNGKey(0))`'s parameters, keyed by tree path."""
    params = _init_small(jax.random.PRNGKey(0)).params
    return {_path_key(p): np.asarray(a) for p, a in
            jax.tree_util.tree_flatten_with_path(params)[0]}


def small_stack():
    """`_init_small(PRNGKey(0))` from STACK_GOLDEN: the configs and the
    tree from tracing it, the values from the file (numpy leaves)."""
    box = {}

    def init(key):
        box["models"] = _init_small(key)
        return box["models"].params

    paths, tree = jax.tree_util.tree_flatten_with_path(
        jax.eval_shape(init, jax.random.PRNGKey(0)))
    golden = np.load(STACK_GOLDEN)
    params = jax.tree_util.tree_unflatten(
        tree, [golden[_path_key(p)] for p, _ in paths])
    return dataclasses.replace(box["models"], params=params)


def _jax_stack():
    """(JAX models with the perturbed ControlNet, their numpy params, the
    unperturbed ControlNet's numpy params)."""
    jm = small_stack()
    params = jax.tree.map(np.asarray, jm.params)
    plain_cn = params["controlnet"]
    params = dict(params, controlnet=_perturb(plain_cn))
    jm = dataclasses.replace(jm, params=jax.tree.map(jnp.asarray, params))
    return jm, params, plain_cn


@pytest.fixture(scope="module")
def stacks():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    jm, params, plain_cn = _jax_stack()
    port = DressingModels.from_jax_params(params, small=True, device="cpu")
    plain = ControlNet(port.controlnet_cfg).eval()
    plain.load_state_dict(params_from_jax({"controlnet": plain_cn})
                          ["controlnet"])
    yield jm, port, plain
    torch.set_num_threads(n)


def _inputs(b=1, seed=0):
    """Every input any preset takes, 64x64 images, numpy from a seed; the
    mask is random per pixel, so a resize convention shows."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return dict(
        prompt_ids=rng.integers(0, 255, (b, 77)).astype(np.int32),
        negative_prompt_ids=rng.integers(0, 255, (b, 77)).astype(np.int32),
        ref_image=rng.standard_normal((b, 64, 64, 3)).astype(f32).clip(-1, 1),
        ref_clip_image=rng.standard_normal((b, 56, 56, 3)).astype(f32),
        latents=rng.standard_normal((b, 8, 8, 4)).astype(f32),
        pose_image=rng.random((b, 64, 64, 3)).astype(f32),
        faceid_embeds=rng.standard_normal((b, 16)).astype(f32),
        face_clip_image=rng.standard_normal((b, 56, 56, 3)).astype(f32),
        person_image=rng.standard_normal((b, 64, 64, 3)).astype(f32).clip(
            -1, 1),
        mask_image=(rng.random((b, 64, 64, 1)) > 0.5).astype(f32),
    )


def _preset(presets, name, **over):
    return dataclasses.replace(presets[name], height=64, width=64,
                               num_inference_steps=4, **over)


# ---------------------------------------------------------------------------
# Configuration
# ---------------------------------------------------------------------------


def test_presets_match_jax():
    """Every preset of the JAX package, field for field."""
    assert set(PRESETS) == set(JAX_PRESETS)
    for name, want in JAX_PRESETS.items():
        assert dataclasses.asdict(PRESETS[name]) == dataclasses.asdict(want), \
            name


# ---------------------------------------------------------------------------
# Modules against their JAX functions
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def modules_golden():
    with np.load(MODULES_GOLDEN) as f:
        return dict(f)


def _controlnet_inputs():
    rng = np.random.default_rng(1)
    lat = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    text = rng.standard_normal((2, 77, 32)).astype(np.float32)
    pose = rng.random((2, 64, 64, 3)).astype(np.float32)
    return lat, np.array([981, 981], np.int32), text, pose


def test_controlnet_residuals_match_jax(stacks, modules_golden):
    """The 12 down and the mid residual of the perturbed ControlNet at a CFG
    batch of 2, conditioning_scale 0.7, against `controlnet.apply` (its
    values in MODULES_GOLDEN, see `record_modules_golden`)."""
    _, port, _ = stacks
    lat, t, text, pose = _controlnet_inputs()
    want_down = [modules_golden[f"cn_down_{i:02d}"] for i in range(12)]
    want_mid = modules_golden["cn_mid"]
    with torch.inference_mode():
        cn = port.controlnet
        down, mid = cn(_t(lat), _t(t, torch.long), _t(text),
                       cond_emb=cn.cond_embedding(_t(pose)),
                       conditioning_scale=0.7)
    assert len(down) == 12
    for i, (a, b) in enumerate(zip(down, want_down)):
        _close(a, b, f"down {i}")
    _close(mid, want_mid, "mid")
    assert float(np.abs(np.asarray(want_mid)).max()) > 1e-3


@pytest.mark.parametrize("shortcut", [True, False])
def test_proj_plus_matches_jax(stacks, shortcut):
    jm, port, _ = stacks
    rng = np.random.default_rng(2)
    ids = rng.standard_normal((2, 16)).astype(np.float32)
    clip = rng.standard_normal((2, 17, 48)).astype(np.float32)
    want = jax.jit(lambda p, a, c: jresampler.apply_proj_plus(
        p, jm.projplus_cfg, a, c, shortcut=shortcut, scale=0.6))(
        jm.params["proj_plus"], jnp.asarray(ids), jnp.asarray(clip))
    with torch.inference_mode():
        got = port.proj_plus(_t(ids), _t(clip), shortcut=shortcut, scale=0.6)
    _close(got, want, "face tokens")


# a two-level UNet (attention at the top level and the mid block): every
# conditioning branch of the transformer blocks and the residual taps, at a
# fraction of the small stack's compile time
PICO = dict(block_out_channels=(16, 32), down_block_has_attn=(True, False),
            layers_per_block=1, cross_attention_dim=32,
            attention_num_heads=4, norm_num_groups=8)


def _pico_case():
    """The PICO UNet's JAX config and parameters (0.2 * N(0, 1), numpy) and
    the inputs of `test_unet_conditioning_branches_match_jax`."""
    jcfg = JaxUNetConfig(**PICO)
    rng = np.random.default_rng(3)
    shapes = jax.eval_shape(lambda: junet.init(jax.random.PRNGKey(0), jcfg))
    params = jax.tree.map(lambda s: (0.2 * rng.standard_normal(s.shape)
                                     ).astype(np.float32), shapes)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 77, 32)).astype(np.float32)
    t = np.array([500, 500], np.int32)
    dims = junet.attn_layer_dims(jcfg)
    seqs = {n: 64 if n.startswith("down") else 16
            for n in junet.attn_layer_names(jcfg, "attn1")}

    def kv(names, n_tokens):
        return {n: tuple(rng.standard_normal(
            (2, n_tokens(n), dims[n])).astype(np.float32) for _ in range(2))
            for n in names}

    ref_kv = kv(junet.attn_layer_names(jcfg, "attn1"), seqs.get)
    ip_kv = kv(junet.attn_layer_names(jcfg, "attn2"), lambda n: 4)
    cross_ref = kv(junet.attn_layer_names(jcfg, "attn2"), lambda n: 6)
    skips, mid, _ = jax.eval_shape(lambda: junet.apply(
        params, jcfg, x, t, ctx, down_only=True))
    down_res = tuple((0.3 * rng.standard_normal(s.shape)).astype(np.float32)
                     for s in skips)
    mid_res = (0.3 * rng.standard_normal(mid.shape)).astype(np.float32)
    return jcfg, params, dict(
        x=x, t=t, ctx=ctx, ref_kv=ref_kv, ip_kv=ip_kv, cross_ref=cross_ref,
        down=down_res, mid=mid_res,
        ref_scale=np.array([0.0, 0.8], np.float32),
        ip_scale=np.array([0.3, 0.9], np.float32))


def test_unet_conditioning_branches_match_jax(modules_golden):
    """UNet eps at a CFG batch of 2 against `unet.apply` (its values in
    MODULES_GOLDEN, see `record_modules_golden`): (a) dual-KV garment
    self-attention with ref_scale [0, 0.8], the IP-Adapter branch (4 face
    tokens, ip_scale [0.3, 0.9]), the garment-cross branch (6 tokens) and
    the ControlNet residuals on every skip and the mid output; (b) the
    `concat` self-attention (garment K/V joined to the key source, 2S keys
    under one softmax)."""
    _, params, c = _pico_case()
    x, t, ctx, ref_kv = c["x"], c["t"], c["ctx"], c["ref_kv"]
    unet = UNet(UNetConfig(**PICO)).eval()
    unet.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray,
                                                          params)))

    def tkv(d):
        return {n: (_t(k), _t(v)) for n, (k, v) in d.items()}

    with torch.inference_mode():
        got_a = unet(_t(x), _t(t, torch.long), _t(ctx), Conditioning(
            ref_kv=tkv(ref_kv), ref_scale=_t(c["ref_scale"]),
            ip_kv=tkv(c["ip_kv"]), ip_scale=_t(c["ip_scale"]),
            ref_cross_kv=tkv(c["cross_ref"]),
            down_block_residuals=[_t(r) for r in c["down"]],
            mid_block_residual=_t(c["mid"])))
        got_b = unet(_t(x), _t(t, torch.long), _t(ctx), Conditioning(
            ref_kv=tkv(ref_kv), ref_mode="concat"))
        plain = unet(_t(x), _t(t, torch.long), _t(ctx))
    _close(got_a, modules_golden["unet_parallel"],
           "parallel + ip + ref-cross + residuals")
    _close(got_b, modules_golden["unet_concat"], "concat")
    # each variant is live
    assert float((got_a - plain).abs().max()) > 1e-3
    assert float((got_b - plain).abs().max()) > 1e-3


def test_fold_lora_matches_jax():
    """W' = W + s * (down @ up) on all four projections, in the port's (out,
    in) layout (LoRA down (rank, in), up (out, rank)) against the JAX
    (in, out) layout."""
    rng = np.random.default_rng(4)
    dim, ctx, rank = 32, 24, 8
    attn = Attention(dim, ctx)
    jparams, lora_j, lora_t = {}, {}, {}
    for name, cin in (("to_q", dim), ("to_k", ctx), ("to_v", ctx),
                      ("to_out", dim)):
        w = rng.standard_normal((cin, dim)).astype(np.float32)
        down = rng.standard_normal((cin, rank)).astype(np.float32)
        up = rng.standard_normal((rank, dim)).astype(np.float32)
        jparams[name] = {"kernel": jnp.asarray(w)}
        lora_j[name] = {"down": jnp.asarray(down), "up": jnp.asarray(up)}
        lora_t[name] = {"down": _t(down.T), "up": _t(up.T)}
        getattr(attn, name).weight.data.copy_(_t(w.T))
    want = jcond.fold_lora(jparams, lora_j, 0.2)
    assert fold_lora(attn, lora_t, 0.2) is attn
    for name in jparams:
        np.testing.assert_allclose(getattr(attn, name).weight.detach().numpy(),
                                   np.asarray(want[name]["kernel"]).T,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("t", [981, 21, 1])
def test_ddim_eta_step_matches_jax(t):
    """eta 0.7 with the same given noise (the last step's prev_t < 0 uses
    final_alpha_cumprod); atol 1e-5 as the eta = 0 step test."""
    rng = np.random.default_rng(t)
    eps, x, noise = (rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
                     for _ in range(3))
    want = jddim.step(jddim.make_schedule(), jnp.asarray(eps), jnp.asarray(t),
                      jnp.asarray(x), 50, eta=0.7, noise=jnp.asarray(noise))
    got = ddim.step(ddim.make_schedule(), _t(eps), t, _t(x), 50, eta=0.7,
                    noise=_t(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    with pytest.raises(ValueError, match="noise"):
        ddim.step(ddim.make_schedule(), _t(eps), t, _t(x), 50, eta=0.7)


@pytest.mark.parametrize("t_start,with_post", [(0, False), (3, True)])
@pytest.mark.parametrize("sampler", ["dpm2m", "unipc"])
def test_multistep_sample_loop_matches_jax(sampler, t_start, with_post):
    """`sample_loop` on a toy eps_fn over 10 steps, whole or truncated, with
    a post-step hook that reads (t_next, is_last) as the JAX scans pass
    them; atol 1e-4 on latents of order 1."""
    jloop = {"dpm2m": jdpm, "unipc": junipc}[sampler].sample_loop
    tloop = {"dpm2m": dpm, "unipc": unipc}[sampler].sample_loop
    x = np.random.default_rng(5).standard_normal((1, 4, 4, 4)).astype(
        np.float32)

    def jeps(lat, t):
        return 0.5 * jnp.tanh(lat) + 1e-4 * t

    def teps(lat, t):
        return 0.5 * torch.tanh(lat) + 1e-4 * t

    def jpost(lat, t_next, is_last):
        return jnp.where(is_last, 0.5 * lat, 0.9 * lat + 1e-4 * t_next)

    def tpost(lat, t_next, is_last):
        return 0.5 * lat if is_last else 0.9 * lat + 1e-4 * t_next

    want = jloop(jddim.make_schedule(), jeps, jnp.asarray(x), 10,
                 t_start=t_start, post_fn=jpost if with_post else None)
    got = tloop(ddim.make_schedule(), teps, _t(x), 10, t_start=t_start,
                post_fn=tpost if with_post else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("src,dst", [((64, 64), (8, 8)), ((16, 16), (4, 4)),
                                     ((100, 75), (13, 10)),
                                     ((7, 5), (3, 11))])
def test_mask_resize_matches_jax_nearest(src, dst):
    """The inpaint mask to the latent size: `jax.image.resize(...,
    "nearest")` samples at half-pixel centres, which `F.interpolate`'s
    "nearest" does not. Exact."""
    x = np.random.default_rng(6).random((2, *src, 1)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, *dst, 1), "nearest")
    np.testing.assert_array_equal(resize_nearest(_t(x), *dst).numpy(),
                                  np.asarray(want))


# ---------------------------------------------------------------------------
# Stage replay of the synthetic preset goldens
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("preset", ["pose", "ipa_pose", "inpaint"])
def test_replays_ref_synthetic_preset(stacks, preset):
    """The preset stages of the port's `tools/record_reference.
    compute_with_stack`: the step-0 ControlNet residuals (exactly zero: the
    golden's ControlNet is fresh; checked for shape and value with the
    unperturbed ControlNet), the ProjPlus face tokens, the person latents,
    the mask at the latent size and the step-0 inpaint recomposition."""
    _, port, plain_cn = stacks
    g = dict(np.load(os.path.join(GOLDENS, f"ref_synthetic_{preset}.npz")))
    extra = tuple(s.split("::")[0] for s in PRESET_EXTRA_SPEC[preset])
    inputs = {k: v for k, v in g.items()
              if k in INPUT_KEYS or k.startswith(extra)}
    computed = compute_with_stack(
        inputs, dataclasses.replace(port, controlnet=plain_cn))
    got = {k: v for k, v in computed.items() if k.startswith(extra)}
    assert len(got) == {"pose": 13, "ipa_pose": 15, "inpaint": 3}[preset]
    for k, v in got.items():
        _close(v, g[k], k)
    if "mask_latent_nhwc" in g:  # the resize convention shows here
        np.testing.assert_array_equal(got["mask_latent_nhwc"],
                                      g["mask_latent_nhwc"])


# ---------------------------------------------------------------------------
# Pipelines against the JAX golden
# ---------------------------------------------------------------------------


def _run(pipeline_cls, models, presets, case, **call):
    name, over, args = CASES[case]
    pipe = pipeline_cls(models, _preset(presets, name, **over),
                        **({"device": "cpu"} if presets is PRESETS else {}))
    return pipe(**_inputs(), **args, **call)


def record_presets_golden():
    """Each CASES entry through the JAX package's jitted `DressingPipeline`
    on the perturbed stack (fp16, as `tiny_basic_v1.npz`)."""
    jm, _, _ = _jax_stack()
    return {case: np.asarray(_run(JaxPipeline, jm, JAX_PRESETS, case),
                             np.float16) for case in CASES}


@pytest.fixture(scope="module")
def presets_golden():
    return dict(np.load(PRESETS_GOLDEN))


@pytest.mark.parametrize("case", list(CASES))
def test_preset_pipeline_matches_jax_golden(stacks, presets_golden, case):
    """The port's `DressingPipeline` on the golden's recipe: CFG, the
    ControlNet (window included), the IP branch, the inpaint recomposition
    and each sampler in the port; atol 2e-3 (fp16 golden)."""
    _, port, _ = stacks
    out = _run(DressingPipeline, port, PRESETS, case)
    assert out.dtype == np.float32 and out.shape == (1, 64, 64, 3)
    np.testing.assert_allclose(out, presets_golden[case].astype(np.float32),
                               atol=2e-3)


def record_modules_golden():
    """The JAX functions the module tests hold the port against: the
    perturbed ControlNet's residuals on `_controlnet_inputs` (jitted
    `controlnet.apply`) and the PICO UNet's two conditioning cases
    (`unet.apply`)."""
    jm, _, _ = _jax_stack()
    lat, t, text, pose = _controlnet_inputs()
    down, mid = jax.jit(lambda p, x, tt, c, img: jcontrolnet.apply(
        p, jm.controlnet_cfg, x, tt, c, cond_image=img,
        conditioning_scale=0.7))(jm.params["controlnet"], lat, t, text, pose)
    out = {f"cn_down_{i:02d}": r for i, r in enumerate(down)}
    out["cn_mid"] = mid
    jcfg, params, c = _pico_case()

    @jax.jit
    def jax_eps(params, c):
        a = junet.apply(params, jcfg, c["x"], c["t"], c["ctx"],
                        jcond.Conditioning(
                            ref_kv=c["ref_kv"], ref_scale=c["ref_scale"],
                            ip_kv=c["ip_kv"], ip_scale=c["ip_scale"],
                            ref_cross_kv=c["cross_ref"],
                            down_block_residuals=c["down"],
                            mid_block_residual=c["mid"]))
        b = junet.apply(params, jcfg, c["x"], c["t"], c["ctx"],
                        jcond.Conditioning(ref_kv=c["ref_kv"],
                                           ref_mode="concat"))
        return a, b

    out["unet_parallel"], out["unet_concat"] = jax_eps(params, c)
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.slow
def test_modules_golden_is_current(modules_golden):
    """The stored module outputs against a live recompute with the JAX
    package."""
    live = record_modules_golden()
    assert set(live) == set(modules_golden)
    for k, v in live.items():
        np.testing.assert_allclose(v, modules_golden[k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)


@pytest.mark.slow
def test_presets_golden_is_current(presets_golden):
    """The stored golden against a live recompute with the JAX package."""
    live = record_presets_golden()
    assert set(live) == set(presets_golden)
    for k, v in live.items():
        np.testing.assert_array_equal(v, presets_golden[k], err_msg=k)


# ---------------------------------------------------------------------------
# Properties
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sampler,eta", [("ddim", 0.0), ("ddim", 1.0),
                                         ("dpm2m", 0.0), ("unipc", 0.0)])
@pytest.mark.parametrize("preset", ["cartoon", "pose", "ipa_pose",
                                    "inpaint"])
def test_every_preset_runs_with_every_sampler(stacks, preset, sampler, eta):
    """2 steps at 64x64: an image of the right shape in [0, 1]."""
    _, port, _ = stacks
    pipe = DressingPipeline(port, _preset(PRESETS, preset, sampler=sampler,
                                          eta=eta), device="cpu")
    out = pipe(**_inputs(), num_inference_steps=2)
    assert out.shape == (1, 64, 64, 3) and out.dtype == np.float32
    assert np.isfinite(out).all() and out.min() >= 0 and out.max() <= 1


def test_controlnet_guidance_window(stacks):
    """Step i keeps its residuals iff start <= i/n and (i+1)/n <= end: the
    defaults equal the explicit full window, the empty window equals
    controlnet_scale 0, and half windows differ from both and from each
    other (as the JAX package's test_controlnet_guidance_window)."""
    _, port, _ = stacks
    pipe = DressingPipeline(port, _preset(PRESETS, "pose"), device="cpu")
    kw = _inputs()

    def run(**call):
        return pipe(**kw, **call)

    base = run()
    np.testing.assert_array_equal(
        base, run(control_guidance_start=0.0, control_guidance_end=1.0))
    off = run(control_guidance_end=0.0)
    np.testing.assert_allclose(off, run(controlnet_scale=0.0), atol=1e-6)
    assert np.abs(base - off).max() > 1e-4
    early = run(control_guidance_end=0.5)
    late = run(control_guidance_start=0.5)
    for windowed in (early, late):
        assert np.abs(windowed - base).max() > 1e-4
        assert np.abs(windowed - off).max() > 1e-4
    assert np.abs(early - late).max() > 1e-4


def test_ddim_eta_is_seeded(stacks):
    """eta > 0: the same seed gives the same image; another seed or eta 0
    another (the initial latents given, so only the step noise differs)."""
    _, port, _ = stacks
    pipe = DressingPipeline(port, _preset(PRESETS, "pose"), device="cpu")
    kw = _inputs()
    a = pipe(**kw, seed=7, eta=1.0)
    np.testing.assert_array_equal(a, pipe(**kw, seed=7, eta=1.0))
    assert np.abs(a - pipe(**kw, seed=8, eta=1.0)).max() > 1e-3
    assert np.abs(a - pipe(**kw, seed=7)).max() > 1e-3


def test_batch_of_two_equals_two_single_runs(stacks):
    """A batch-2 `pose` run (CFG batch [uncond 2; cond 2], the residuals of
    the ControlNet on the same batch) equals two batch-1 runs row by row."""
    _, port, _ = stacks
    pipe = DressingPipeline(port, _preset(PRESETS, "pose"), device="cpu")
    both = pipe(**_inputs(b=2, seed=3))
    for row in range(2):
        one = {k: v[row:row + 1] for k, v in _inputs(b=2, seed=3).items()}
        np.testing.assert_allclose(both[row:row + 1], pipe(**one), atol=1e-5)


# `last_stage_seconds`' keys, in order, by preset
STAGES = {
    "basic": ["text", "garment_tokens", "vae_encode", "garment_unet",
              "kv_precompute", "denoise", "vae_decode"],
    "pose": ["text", "garment_tokens", "vae_encode", "garment_unet",
             "kv_precompute", "control_embedding", "denoise", "vae_decode"],
    "inpaint": ["text", "garment_tokens", "vae_encode", "garment_unet",
                "kv_precompute", "person_encode", "control_embedding",
                "denoise", "vae_decode"],
}


@pytest.mark.parametrize("preset", sorted(STAGES))
def test_stage_seconds_keep_their_keys_and_order(stacks, preset):
    """Each stage's seconds (the host's on the CPU), in the stages' order;
    together within the call's wall."""
    _, port, _ = stacks
    pipe = DressingPipeline(port, _preset(PRESETS, preset), device="cpu")
    t0 = time.perf_counter()
    pipe(**_inputs(), num_inference_steps=2)
    wall = time.perf_counter() - t0
    assert list(pipe.last_stage_seconds) == STAGES[preset]
    assert min(pipe.last_stage_seconds.values()) >= 0
    assert sum(pipe.last_stage_seconds.values()) <= wall


@pytest.mark.parametrize("sampler", ["ddim", "unipc"])
def test_a_traced_call_records_its_stages_and_steps(stacks, sampler):
    """Under a profiler a call records one `pipeline.call` span, whose
    children are its stages in order, and a `denoise.step` span a step
    under the `denoise` stage; on the CPU no device time."""
    _, port, _ = stacks
    pipe = DressingPipeline(port, _preset(PRESETS, "pose", sampler=sampler),
                            device="cpu")
    profiling.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        pipe(**_inputs(b=2), num_inference_steps=2)
    spans = profiling.spans()
    profiling.clear()
    [call] = [s for s in spans if s["name"] == "pipeline.call"]
    assert call["attrs"] == {"batch": 2, "steps": 2, "preset": "pose"}
    stages = [s for s in spans if s["parent"] == call["id"]]
    assert [s["name"] for s in stages] == STAGES["pose"]
    denoise = stages[STAGES["pose"].index("denoise")]
    steps = [s for s in spans if s["name"] == "denoise.step"]
    assert len(steps) == 2
    for s in steps:
        assert s["parent"] == denoise["id"]
        assert denoise["t0"] <= s["t0"] <= s["t1"] <= denoise["t1"]
        assert "controlnet_device_s" not in s["attrs"]


def test_fresh_controlnet_adds_nothing():
    """init_random keeps the ControlNet's output convs at zero, as the JAX
    package's init does: every residual is exactly zero."""
    models = DressingModels.init_random(0, small=True, with_controlnet=True,
                                        device="cpu")
    cn = models.controlnet
    with torch.inference_mode():
        down, mid = cn(torch.randn(1, 8, 8, 4), 981, torch.randn(1, 77, 32),
                       cond_emb=cn.cond_embedding(torch.rand(1, 64, 64, 3)))
    assert all(not r.any() for r in down) and not mid.any()
    assert sum(p.numel() for p in cn.parameters()) > 0
    # no up blocks: the state dict holds the JAX tree's keys only
    prefixes = {k.split(".")[0] for k in cn.state_dict()}
    assert prefixes == {"conv_in", "time_embedding", "down_blocks",
                        "mid_block", "controlnet_cond_embedding",
                        "controlnet_down_blocks", "controlnet_mid_block"}


def test_ip_adapters_keyed_by_layer(stacks):
    """The converter maps the JAX tree's attn2 layer names to
    `adapter_key`s; the IP K/V cover every cross-attention layer."""
    jm, port, _ = stacks
    assert set(port.ip_adapters.keys()) == {
        adapter_key(n) for n in jm.params["ip_adapters"]}
    assert list(port.ip_adapters.keys()) == [
        adapter_key(n) for n in junet.attn_layer_names(jm.unet_cfg, "attn2")]


def test_presets_check_their_inputs_and_models(stacks):
    _, port, _ = stacks
    kw = {k: v for k, v in _inputs().items() if k != "pose_image"}
    with pytest.raises(ValueError, match="pose_image"):
        DressingPipeline(port, _preset(PRESETS, "pose"), device="cpu")(**kw)
    bare = copy.copy(port)
    bare.controlnet = None
    with pytest.raises(ValueError, match="ControlNet"):
        DressingPipeline(bare, _preset(PRESETS, "inpaint"), device="cpu")
    with pytest.raises(ValueError, match="unknown sampler"):
        DressingPipeline(port, _preset(PRESETS, "pose", sampler="euler"),
                         device="cpu")


def test_new_entry_points_default_to_cuda(stacks):
    """Without a card, the preset stacks and pipelines raise unless
    device='cpu' is given."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    _, port, _ = stacks
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DressingModels.init_random(0, small=True, with_controlnet=True,
                                   with_ipa=True)
    for name in ("cartoon", "pose", "ipa_pose", "inpaint"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DressingPipeline(port, PRESETS[name])


@pytest.mark.slow
def test_small_stack_golden_is_current():
    """The stored parameters against a live `init_random`, bit for bit."""
    live = record_small_stack()
    golden = np.load(STACK_GOLDEN)
    assert set(live) == set(golden.files)
    for k, v in live.items():
        np.testing.assert_array_equal(v, golden[k], err_msg=k)


if __name__ == "__main__":
    import sys

    # the settings tests/conftest.py gives the suite
    os.environ.setdefault("IMAGDRESSING_DISABLE_PALLAS", "1")
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_threefry_partitionable", True)
    # `python tests/test_torch_presets.py stack` re-records the stack's
    # parameters, `... modules` the module outputs; without an argument,
    # the presets golden
    path, record = ((STACK_GOLDEN, record_small_stack) if "stack" in sys.argv
                    else (MODULES_GOLDEN, record_modules_golden)
                    if "modules" in sys.argv
                    else (PRESETS_GOLDEN, record_presets_golden))
    np.savez_compressed(path, **record())
    print("wrote", path, os.path.getsize(path), "bytes")
