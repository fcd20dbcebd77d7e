"""The port's plain primitives, DDIM sampler and training pieces (the
forward noising, SNR, the optimizer, block remat) against the JAX package,
and a static check that the port imports nothing of JAX.

Inputs are made with numpy from a seed and fed to both; fp32 on the CPU.
"""

import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import optax

from imagdressing_tpu.core.config import SchedulerConfig as JaxSchedulerConfig
from imagdressing_tpu.core.config import TrainConfig as JaxTrainConfig
from imagdressing_tpu.ops import nn as jnn
from imagdressing_tpu.samplers import ddim as jddim
from imagdressing_tpu.train import step as jstep
from imagdressing_tpu_torch.core.config import TrainConfig
from imagdressing_tpu_torch.ops import nn as tnn
from imagdressing_tpu_torch.pipelines.dressing import DressingModels
from imagdressing_tpu_torch.samplers import ddim as tddim
from imagdressing_tpu_torch.train import step as tstep

PORT_DIR = pathlib.Path(__file__).resolve().parent.parent / \
    "imagdressing_tpu_torch"


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _conv_w(w_hwio):
    return _t(w_hwio).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)


@pytest.mark.parametrize("stride,padding", [
    (2, ((0, 1), (0, 1))),  # the VAE downsampler's asymmetric pad
    (1, 1),
    (2, 1),
])
def test_conv2d_matches_jax(stride, padding):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 12, 16)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 16, 24)) * 0.1).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    want = jnn.conv2d({"kernel": jnp.asarray(w), "bias": jnp.asarray(b)},
                      jnp.asarray(x), stride=stride, padding=padding)
    got = tnn.conv2d(_t(x), _conv_w(w), _t(b), stride=stride, padding=padding)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_upsample2x_conv_matches_jax():
    """The subpixel fold: one low-resolution conv == upsample + conv3x3."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 5, 7, 16)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 16, 16)) * 0.1).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    want = jnn.upsample2x_conv({"kernel": jnp.asarray(w),
                                "bias": jnp.asarray(b)}, jnp.asarray(x))
    got = tnn.upsample2x_conv(_t(x), _t(w).permute(3, 2, 0, 1), _t(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("dim", [320, 17])
def test_timestep_embedding_matches_jax(dim):
    ts = np.array([0, 1, 500, 999], np.int32)
    want = jnn.timestep_embedding(jnp.asarray(ts), dim)
    got = tnn.timestep_embedding(_t(ts), dim)
    # fp32 arguments up to 999 rad: one ulp of the argument (6e-5) moves
    # sin/cos by as much, and the two exp implementations differ by an ulp
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


def test_group_norm_matches_jax():
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((2, 6, 5, 64)) * 3 + 1).astype(np.float32)
    w, b = (rng.standard_normal(64).astype(np.float32) for _ in range(2))
    want = jnn.group_norm({"scale": jnp.asarray(w), "bias": jnp.asarray(b)},
                          jnp.asarray(x), num_groups=8, eps=1e-6)
    got = tnn.group_norm(_t(x), _t(w), _t(b), num_groups=8, eps=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_geglu_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 7, 32)).astype(np.float32)
    w = (rng.standard_normal((32, 256)) * 0.1).astype(np.float32)
    b = rng.standard_normal(256).astype(np.float32)
    want = jnn.geglu({"kernel": jnp.asarray(w), "bias": jnp.asarray(b)},
                     jnp.asarray(x))
    got = tnn.geglu(_t(x), _t(w.T), _t(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("steps", [4, 30, 50])
def test_ddim_timesteps_match_jax(steps):
    want = jddim.timesteps(jddim.make_schedule(), steps)
    got = tddim.timesteps(tddim.make_schedule(), steps)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tddim.make_schedule().alphas_cumprod,
                                  jddim.make_schedule().alphas_cumprod)


@pytest.mark.parametrize("t", [981, 21, 1])
def test_ddim_step_matches_jax(t):
    """Includes the last step (prev_t < 0: final_alpha_cumprod)."""
    rng = np.random.default_rng(t)
    eps = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    x = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    want = jddim.step(jddim.make_schedule(), jnp.asarray(eps),
                      jnp.asarray(t), jnp.asarray(x), 50)
    got = tddim.step(tddim.make_schedule(), _t(eps), t, _t(x), 50)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_training_schedule_add_noise_and_snr_match_jax():
    """The zero-SNR, trailing training schedule: forward noising and SNR at
    timesteps across the range (the last has alpha_bar 0), fp32."""
    jsched = jddim.make_schedule(JaxSchedulerConfig(
        rescale_betas_zero_snr=True, timestep_spacing="trailing"))
    tsched = tddim.make_schedule(tddim.TRAIN_SCHEDULER)
    np.testing.assert_array_equal(tsched.alphas_cumprod,
                                  jsched.alphas_cumprod)
    rng = np.random.default_rng(4)
    t = np.array([0, 1, 388, 911, 999], np.int32)
    x = rng.standard_normal((5, 8, 8, 4)).astype(np.float32)
    eps = rng.standard_normal((5, 8, 8, 4)).astype(np.float32)
    want = jddim.add_noise(jsched, jnp.asarray(x), jnp.asarray(eps),
                           jnp.asarray(t))
    got = tddim.add_noise(tsched, _t(x), _t(eps), _t(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    np.testing.assert_allclose(
        tddim.compute_snr(tsched, _t(t)).numpy(),
        np.asarray(jddim.compute_snr(jsched, jnp.asarray(t))), rtol=1e-6)


def _optimizer_case(scales, accum, seed=8):
    """Params and a gradient sequence (accum gradients per update), each
    update's gradients scaled by `scales` (NaN: one leaf becomes NaN)."""
    rng = np.random.default_rng(seed)
    shapes = {"a": (4, 3), "b": (5,), "c": (2, 2, 2)}
    params = {k: rng.standard_normal(v).astype(np.float32)
              for k, v in shapes.items()}
    grads = []
    for sc in scales:
        for _ in range(accum):
            g = {k: (rng.standard_normal(v) * 0.5).astype(np.float32)
                 for k, v in shapes.items()}
            if np.isnan(sc):
                g["b"][1] = np.nan
            else:
                g = {k: v * sc for k, v in g.items()}
            grads.append(g)
    return params, grads


@pytest.mark.parametrize("accum,scales", [(1, [3.0, np.nan, 0.05]),
                                          (2, [3.0, 0.05])])
def test_optimizer_matches_optax(accum, scales):
    """The port's optimizer against the JAX package's `make_optimizer`
    (optax): LR warmup from 0, a global norm above max_grad_norm (clipped),
    a NaN gradient (skipped: no update, the moments and count kept), a small
    finite gradient; and gradient accumulation (MultiSteps). fp32 params and
    second moments to 1e-6 relative, the bf16 first moments exactly."""
    kw = dict(learning_rate=1e-2, warmup_steps=2, weight_decay=1e-2,
              gradient_accumulation_steps=accum)
    params, grads = _optimizer_case(scales, accum)
    keys = sorted(params)
    jtx = jstep.make_optimizer(JaxTrainConfig(**kw))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jtx.init(jp)
    ttx = tstep.make_optimizer(TrainConfig(**kw))
    tp = [_t(params[k].copy()) for k in keys]
    tstate = ttx.init(tp)
    for i, g in enumerate(grads):
        ju, jstate = jtx.update({k: jnp.asarray(v) for k, v in g.items()},
                                jstate, jp)
        jp = optax.apply_updates(jp, ju)
        tu, tstate = ttx.update([_t(g[k]) for k in keys], tstate, tp)
        tstep.apply_updates(tp, tu)
        for k, a in zip(keys, tp):
            np.testing.assert_allclose(a.numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7,
                                       err_msg=f"update {i} {k}")
    inner = jstate.inner_opt_state if accum > 1 else jstate
    adam = inner.inner_state[1][0]
    finite = sum(not np.isnan(sc) for sc in scales)
    assert tstate.count == int(adam.count) == finite
    assert tstate.total_notfinite == int(inner.total_notfinite)
    sizes = [params[k].size for k in keys]
    for k, mu, nu in zip(keys, tstate.mu.split(sizes),
                         tstate.nu.split(sizes)):
        assert mu.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            mu.float().numpy(),
            np.asarray(adam.mu[k], np.float32).reshape(-1), err_msg=k)
        np.testing.assert_allclose(nu.numpy(),
                                   np.asarray(adam.nu[k]).reshape(-1),
                                   rtol=1e-6, err_msg=k)


def test_accumulation_recovers_after_a_nonfinite_step():
    """With accumulation, a NaN micro-batch skips that one update; the next
    accumulation starts from zeros and updates again. (optax.MultiSteps
    resets its buffer as 0 * acc, which keeps a NaN, so the JAX package's
    chain would skip every later update: the port does not copy that.)"""
    cfg = TrainConfig(learning_rate=1e-2, warmup_steps=0,
                      gradient_accumulation_steps=2)
    params, grads = _optimizer_case([np.nan, 0.05], 2, seed=9)
    keys = sorted(params)
    tx = tstep.make_optimizer(cfg)
    tp = [_t(params[k].copy()) for k in keys]
    state = tx.init(tp)
    moved = []
    for g in grads:
        before = [p.clone() for p in tp]
        updates, state = tx.update([_t(g[k]) for k in keys], state, tp)
        tstep.apply_updates(tp, updates)
        moved.append(any(not torch.equal(a, b) for a, b in zip(before, tp)))
    assert moved == [False, False, False, True]
    assert state.count == 1 and state.total_notfinite == 1
    assert all(torch.isfinite(p).all() for p in tp)


@pytest.fixture(scope="module")
def small_unet():
    models = DressingModels.init_random(0, small=True, device="cpu")
    return models.unet.requires_grad_(True)


def test_block_remat_gives_the_same_gradients(small_unet):
    """remat "full" (torch.utils.checkpoint per resnet and transformer
    block) against no remat: the same loss and gradients, fp32."""
    rng = np.random.default_rng(10)
    x = _t(rng.standard_normal((2, 8, 8, 4)).astype(np.float32))
    ctx = _t(rng.standard_normal((2, 77, 32)).astype(np.float32))
    params = list(small_unet.parameters())
    out = {}
    for remat in (False, True):
        y = small_unet(x, torch.tensor([5, 700]), ctx, remat=remat,
                       remat_policy="full")
        out[remat] = (y, torch.autograd.grad(y.square().mean(), params))
    torch.testing.assert_close(out[True][0], out[False][0], rtol=0, atol=0)
    for a, b in zip(out[True][1], out[False][1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("policy", ["full", "dots", "names", "heavy"])
def test_remat_policy_matches_no_remat(small_unet, policy, monkeypatch):
    """Every remat policy recomputes, never changes, the math: the loss and
    every parameter gradient against the remat-free backward at the JAX
    package's tolerances (`tests/test_unet.py`'s
    test_remat_policies_match_no_remat: loss rtol 1e-6, gradients rtol
    1e-5, atol 1e-6). And the named saves work: under "names" and "heavy"
    the backward runs no flash forward (K5's op) and no GN+conv forward
    again, under "full" and "dots" each runs twice."""
    from imagdressing_tpu_torch.kernels import flash_attention as fa
    from imagdressing_tpu_torch.kernels import fused_gn_conv as fgc

    calls = {"flash": 0, "gn_conv": 0}

    def counted(fn, key):
        def wrapped(*args):
            calls[key] += 1
            return fn(*args)
        return wrapped

    monkeypatch.setattr(fa, "flash_attention_res",
                        counted(fa.flash_attention_res, "flash"))
    monkeypatch.setattr(fgc, "_forward", counted(fgc._forward, "gn_conv"))
    rng = np.random.default_rng(3)
    x = _t(rng.standard_normal((1, 16, 16, 4)).astype(np.float32))
    ctx = _t(rng.standard_normal((1, 77, 32)).astype(np.float32))
    params = list(small_unet.parameters())
    out = {}
    for remat in (False, True):
        for k in calls:
            calls[k] = 0
        y = small_unet(x, torch.tensor([500]), ctx, remat=remat,
                       remat_policy=policy)
        loss = y.square().mean()
        out[remat] = (loss, torch.autograd.grad(loss, params),
                      dict(calls))
    torch.testing.assert_close(out[True][0], out[False][0], rtol=1e-6,
                               atol=0)
    for a, b in zip(out[True][1], out[False][1]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    once = out[False][2]
    assert once["flash"] == 16 and once["gn_conv"] == 44  # the small UNet
    recomputes = 1 if policy in ("full", "dots") else 0
    assert out[True][2] == {k: n * (1 + recomputes) for k, n in once.items()}


def test_port_imports_no_jax():
    """No module of the port, nor `chip_smoke.py` or the card tests (both run
    where JAX is not installed), imports jax, flax or the JAX package, nor
    orbax, safetensors, cv2 or transformers (the port reads checkpoints and
    images itself); PIL only inside a function (JPEG), never at module
    level. Read from the source: the interpreter's site setup may preload
    jax, so `sys.modules` cannot tell."""
    banned = ("jax", "jaxlib", "flax", "imagdressing_tpu", "orbax",
              "safetensors", "cv2", "transformers")
    files = sorted(PORT_DIR.rglob("*.py")) + [
        PORT_DIR.parent / "chip_smoke.py",
        PORT_DIR.parent / "tests" / "test_torch_gpu.py"]
    assert len(files) > 10
    # the preset slice's modules, the apps slice's, the preprocessing
    # slice's, the training CLI's and the parser fine-tune / eval slice's
    # are among them
    names = {str(f.relative_to(PORT_DIR.parent)) for f in files}
    port = "imagdressing_tpu_torch/"
    assert {port + m for m in (
        "models/controlnet.py", "samplers/dpm.py", "samplers/unipc.py",
        "convert/torch_sd.py", "convert/export_torch.py", "apps/loader.py",
        "apps/tokenizer.py", "apps/image_utils.py", "apps/png.py",
        "apps/serve.py", "apps/dress.py", "preprocess/face.py",
        "train/data.py", "tools/write_checkpoints.py", "ops/resize.py",
        "preprocess/imgproc.py", "preprocess/mask.py",
        "preprocess/openpose/__init__.py", "preprocess/openpose/model.py",
        "preprocess/openpose/hand.py", "preprocess/openpose/face.py",
        "preprocess/openpose/infer.py", "preprocess/openpose/draw.py",
        "postprocess/__init__.py", "postprocess/face_fusion.py",
        "runtime/native.py", "train/checkpoint.py", "train/trackers.py",
        "core/profiling.py", "apps/train_cli.py", "apps/parsing_cli.py",
        "train/parsing_losses.py", "train/parsing_train.py",
        "eval/__init__.py", "eval/cami.py", "eval/clip_score.py",
        "eval/grid.py", "eval/cli.py", "tools/profile_parse_train.py")} <= names
    for path in files:
        tree = ast.parse(path.read_text(), str(path))
        in_functions = {id(n) for f in ast.walk(tree)
                        if isinstance(f, (ast.FunctionDef,
                                          ast.AsyncFunctionDef))
                        for n in ast.walk(f)}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in banned, f"{path}: imports {name}"
                assert top != "PIL" or id(node) in in_functions, \
                    f"{path}: imports PIL at module level"
