"""The port's `basic` slice and its training step end to end against the
JAX package.

One JAX small stack (`DressingModels.init_random(PRNGKey(0), small=True)`,
the stack every golden here was recorded with) is built once and converted
with `params_from_jax`. The port then replays `ref_synthetic_tiny.npz` stage
by stage, as `tools/record_reference.compute_with_stack` does, runs its
`DressingPipeline` on the recipe of `test_tiny_config_seed_fixed_regression`,
and replays `torch_train_step_tiny.npz`: the JAX package's jitted
`make_train_step` on the recipe of `tests/test_train.py` (batch of 2 at
64x64, `TrainConfig(train_batch_size=2, warmup_steps=2,
learning_rate=1e-3)`), with the random draws its loss took from its keys.
Everything runs in fp32 on the CPU (each kernel's plain version).

Re-record the training golden (JAX on the CPU, a few minutes of compile):

    JAX_PLATFORMS=cpu python tests/test_torch_pipeline.py
"""

import copy
import dataclasses
import os
import sys

import jax
import numpy as np
import pytest
import torch

from imagdressing_tpu.pipelines.dressing import DressingModels as JaxModels
from imagdressing_tpu_torch.core.config import PRESETS
from imagdressing_tpu_torch.models.conditioning import Conditioning
from imagdressing_tpu_torch.models.unet import (
    adapter_key,
    attn_layer_names,
    init_ref_adapters_from_unet,
    precompute_ref_kv,
)
from imagdressing_tpu_torch.pipelines.dressing import (
    DressingModels,
    DressingPipeline,
)
from imagdressing_tpu_torch.samplers import ddim
from imagdressing_tpu_torch.train import step as tstep

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
TRAIN_GOLDEN = os.path.join(GOLDENS, "torch_train_step_tiny.npz")
BF16_GOLDEN = os.path.join(GOLDENS, "torch_basic_bf16_tiny.npz")
# replay()'s tolerance: atol 5e-3 + rtol 1e-3 * max|golden|
ATOL, RTOL = 5e-3, 1e-3
# the JAX leaves whose gradients and trained values the training golden keeps
# (model / JAX tree path): both convs and norms of the K2/K3 backward,
# attention projections around K5/K6, the adapters, the Resampler, and the
# garment UNet's output conv, which the loss never reaches (zero gradient)
TRAIN_LEAVES = (
    "ref_unet/conv_in/kernel",
    "ref_unet/down_blocks/0/resnets/0/conv1/kernel",
    "ref_unet/down_blocks/0/resnets/0/norm1/scale",
    "ref_unet/down_blocks/0/attentions/0/norm/scale",
    "ref_unet/down_blocks/1/attentions/0/transformer_blocks/0/attn1/to_q/kernel",
    "ref_unet/down_blocks/2/resnets/0/time_emb_proj/kernel",
    "ref_unet/mid_block/attentions/0/transformer_blocks/0/attn1/to_k/kernel",
    "ref_unet/up_blocks/1/attentions/2/transformer_blocks/0/attn1/to_v/kernel",
    "ref_unet/conv_out/kernel",
    "ref_adapters/down_blocks.0.attentions.0.transformer_blocks.0.attn1"
    ".processor/to_k_ref/kernel",
    "ref_adapters/mid_block.attentions.0.transformer_blocks.0.attn1"
    ".processor/to_v_ref/kernel",
    "resampler/latents",
    "resampler/layers/0/attn/to_kv/kernel",
    "resampler/proj_in/kernel",
)
TRAIN_MODELS = ("ref_unet", "ref_adapters", "resampler")


@pytest.fixture(scope="module")
def port():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    jm = JaxModels.init_random(jax.random.PRNGKey(0), small=True)
    params = jax.tree.map(np.asarray, jm.params)
    yield DressingModels.from_jax_params(params, small=True, device="cpu")
    torch.set_num_threads(n)


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


@pytest.fixture(scope="module")
def replayed(port):
    """Every tensor of ref_synthetic_tiny.npz, computed by the port."""
    g = dict(np.load(os.path.join(GOLDENS, "ref_synthetic_tiny.npz")))
    m = port
    out = {}
    with torch.inference_mode():
        text = m.text(_t(g["prompt_ids"], torch.long))
        out["text_embeds"] = text
        clip_hidden = m.vision(_t(g["clip_pixels_nhwc"]), penultimate=True)
        out["clip_vision_penult"] = clip_hidden
        cloth = m.resampler(clip_hidden)
        out["cloth_tokens"] = cloth
        ref_latents = m.vae.encode_mean(_t(g["ref_image_nhwc"])) \
            * m.vae_cfg.scaling_factor
        out["ref_latents_nhwc"] = ref_latents
        _, captured = m.ref_unet(ref_latents, 0, cloth, capture=True)
        for name, hidden in captured.items():
            out[f"sa_hidden::{name}"] = hidden
        sched = ddim.make_schedule()
        steps = int(g["steps"])
        ts = ddim.timesteps(sched, steps)
        lat = _t(g["init_latents_nhwc"])
        out["eps_step0_nhwc"] = m.unet(lat, int(ts[0]), text)
        for t in ts:
            lat = ddim.step(sched, m.unet(lat, int(t), text), int(t), lat,
                            steps)
        out["final_latents_nhwc"] = lat
    return g, {k: v.numpy() for k, v in out.items()}


@pytest.mark.parametrize("stage", [
    "text_embeds", "clip_vision_penult", "cloth_tokens", "ref_latents_nhwc",
    "sa_hidden::", "eps_step0_nhwc", "final_latents_nhwc",
])
def test_replays_ref_synthetic_tiny(replayed, stage):
    golden, got = replayed
    keys = [k for k in golden if k == stage or
            (stage.endswith("::") and k.startswith(stage))]
    assert keys, stage
    for k in keys:
        want = golden[k]
        assert got[k].shape == want.shape, k
        tol = ATOL + RTOL * float(np.abs(want).max())
        err = float(np.abs(got[k] - want).max())
        assert err <= tol, f"{k}: max err {err:.3g} > {tol:.3g}"


def test_basic_pipeline_matches_tiny_golden(port):
    """The recipe of test_tiny_config_seed_fixed_regression: the JAX
    pipeline's own initial noise (jax.random under the suite's threefry
    setting) goes in as `latents`; CFG, dual-KV and DDIM run in the port.
    atol 2e-3, as the JAX regression test (fp16 golden)."""
    want = np.load(os.path.join(GOLDENS, "tiny_basic_v1.npz"))["output"]
    preset = dataclasses.replace(PRESETS["basic"], height=64, width=64,
                                 num_inference_steps=4)
    pipe = DressingPipeline(port, preset, device="cpu")
    kwargs, noise = _basic_tiny_inputs()
    out = pipe(latents=noise, **kwargs)
    assert out.dtype == np.float32 and out.shape == (1, 64, 64, 3)
    np.testing.assert_allclose(out, want.astype(np.float32), atol=2e-3)
    # the garment reaches the output only through the cond half's scale
    assert not np.array_equal(out, pipe(latents=noise, image_scale=0.0,
                                        **kwargs))
    q = pipe(latents=noise, output_uint8=True, **kwargs)
    np.testing.assert_array_equal(q, np.round(out * 255).astype(np.uint8))


def _basic_tiny_inputs():
    """The inputs of `test_basic_pipeline_matches_tiny_golden`, with the JAX
    pipeline's own initial noise as `latents`."""
    rng = np.random.default_rng(1234)
    kwargs = dict(
        prompt_ids=rng.integers(0, 255, (1, 77)),
        negative_prompt_ids=rng.integers(0, 255, (1, 77)),
        ref_image=rng.standard_normal((1, 64, 64, 3)).astype(
            np.float32).clip(-1, 1),
        ref_clip_image=rng.standard_normal((1, 56, 56, 3)).astype(np.float32),
    )
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(99), (1, 8, 8, 4)))
    return kwargs, noise


def record_bf16_golden():
    """JAX's `DressingPipeline` on `models.cast(jnp.bfloat16)` (the small
    stack of `port`, 64x64, 4 DDIM steps) with `_basic_tiny_inputs`."""
    import jax.numpy as jnp

    from imagdressing_tpu.core.config import PRESETS as JAX_PRESETS
    from imagdressing_tpu.pipelines.dressing import (
        DressingPipeline as JaxPipeline,
    )

    jm = JaxModels.init_random(jax.random.PRNGKey(0), small=True)
    preset = dataclasses.replace(JAX_PRESETS["basic"], height=64, width=64,
                                 num_inference_steps=4)
    kwargs, noise = _basic_tiny_inputs()
    out = JaxPipeline(jm.cast(jnp.bfloat16), preset)(latents=noise, **kwargs)
    return {"output": np.asarray(out, np.float32)}


def test_basic_pipeline_bf16_matches_jax(port):
    """The bf16 leg: the port's stack cast to bf16 (every kernel's plain
    version in bf16 on the CPU) against JAX's pipeline on the bf16-cast
    stack (`torch_basic_bf16_tiny.npz`, `record_bf16_golden`), same
    latents, outputs in [0, 1]. Measured: max |port - JAX| 3.56e-2, mean
    3.9e-3, means 1.9e-4 apart; each side's own bf16 run is as far from its
    fp32 run (port 3.59e-2 max, 3.2e-3 mean; JAX 3.42e-2, 3.6e-3), where
    the fp32 legs agree to 2.4e-4. So the gap is bf16 rounding taken at
    different points (XLA rounds once per fused chain, eager PyTorch after
    each op), not a different function. The Pallas kernel's softmax scale
    folded into bf16 q (ROADMAP Queue 3, `csrc/flash_fwd.cu:46`) is not on
    this path: the JAX suite runs with Pallas off, so JAX's attention here
    is `_xla_sdpa`, which scales the fp32 logits as the port does. Bounds:
    max 5e-2, mean 6e-3, means 1e-3; and the bf16 run differs from the fp32
    one (it ran in bf16)."""
    want = np.load(BF16_GOLDEN)["output"]
    preset = dataclasses.replace(PRESETS["basic"], height=64, width=64,
                                 num_inference_steps=4)
    kwargs, noise = _basic_tiny_inputs()
    out = DressingPipeline(copy.deepcopy(port).cast(torch.bfloat16), preset,
                           device="cpu")(latents=noise, **kwargs)
    assert out.dtype == np.float32 and out.shape == want.shape
    err = np.abs(out - want)
    assert err.max() <= 5e-2 and err.mean() <= 6e-3, (err.max(), err.mean())
    assert abs(float(out.mean() - want.mean())) <= 1e-3
    fp32 = DressingPipeline(port, preset, device="cpu")(latents=noise,
                                                       **kwargs)
    assert np.abs(out - fp32).max() > 1e-3


def test_ref_scale_zero_reaches_the_uncond_half_only(port):
    """CFG batch with ref_scale [0, s]: the uncond row equals a run with no
    garment K/V at all; the cond row does not."""
    m = port
    rng = np.random.default_rng(5)
    with torch.inference_mode():
        ref = _t(rng.standard_normal((1, 8, 8, 4)))
        cloth = _t(rng.standard_normal((1, 8, 32)))
        _, captured = m.ref_unet(ref, 0, cloth, capture=True)
        kv = {n: (torch.cat([k, k]), torch.cat([v, v]))
              for n, (k, v) in precompute_ref_kv(m.ref_adapters,
                                                 captured).items()}
        lat = _t(rng.standard_normal((2, 8, 8, 4)))
        text = _t(rng.standard_normal((2, 77, 32)))
        cond = Conditioning(ref_kv=kv, ref_scale=torch.tensor([0.0, 1.0]))
        eps = m.unet(lat, 981, text, cond)
        plain = m.unet(lat, 981, text)
    assert set(kv) == set(attn_layer_names(m.unet_cfg, "attn1"))
    torch.testing.assert_close(eps[0], plain[0], rtol=0, atol=1e-6)
    assert (eps[1] - plain[1]).abs().max() > 1e-3


def test_ref_adapters_are_copies(port):
    unet = port.unet
    adapters = init_ref_adapters_from_unet(unet)
    name = attn_layer_names(port.unet_cfg, "attn1")[0]
    attn1 = unet.attention_block(name).attn1
    ad = adapters[adapter_key(name)]
    assert torch.equal(ad.to_k_ref.weight, attn1.to_k.weight)
    assert ad.to_k_ref.weight.data_ptr() != attn1.to_k.weight.data_ptr()
    with torch.no_grad():
        ad.to_k_ref.weight.add_(1.0)
    assert not torch.equal(ad.to_k_ref.weight, attn1.to_k.weight)


def test_entry_points_default_to_cuda(port):
    """Without a card, an entry point raises unless device='cpu' is given."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DressingPipeline(port, PRESETS["basic"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DressingModels.init_random(0, small=True)


# ---------------------------------------------------------------------------
# Training step
# ---------------------------------------------------------------------------


def _train_batch():
    """The batch of tests/test_train.py's setup, as numpy arrays."""
    rng = np.random.default_rng(0)
    return {
        "person_image": rng.standard_normal((2, 64, 64, 3)).astype(
            np.float32).clip(-1, 1),
        "cloth_image": rng.standard_normal((2, 64, 64, 3)).astype(
            np.float32).clip(-1, 1),
        "cloth_clip": rng.standard_normal((2, 56, 56, 3)).astype(np.float32),
        "text_ids": rng.integers(0, 255, (2, 77)).astype(np.int32),
    }


def _port_leaf(model: str, path: str) -> str:
    """A JAX tree path -> the port's parameter name (convert.py's mapping)."""
    from imagdressing_tpu_torch.convert import _convert_leaf
    from imagdressing_tpu_torch.models.unet import adapter_key

    parts = path.split("/")
    if model == "ref_adapters":
        parts[0] = adapter_key(parts[0])
    return _convert_leaf(tuple(parts), np.zeros((1, 1)))[0]


def _port_layout(path: str, arr: np.ndarray) -> np.ndarray:
    from imagdressing_tpu_torch.convert import _convert_leaf

    return _convert_leaf(tuple(path.split("/")), arr)[1].numpy()


def _flatten(tree):
    """{"model/path/to/leaf": array} of a JAX tree of dicts and lists."""
    from imagdressing_tpu_torch.convert import _leaves

    return {"/".join(p): a for p, a in _leaves(jax.tree.map(np.asarray,
                                                             tree))}


def record_train_golden():
    """The training golden, computed with the JAX package: the draws of two
    steps (the same `jax.random` calls as its loss_fn), the step-0 loss,
    gradient norms and TRAIN_LEAVES gradients from
    `jax.value_and_grad(loss_fn)`, and two steps of `jax.jit(make_train_step)`
    (losses, grad norms, TRAIN_LEAVES after step 2)."""
    import jax.numpy as jnp

    from imagdressing_tpu.core.config import TrainConfig as JaxTrainConfig
    from imagdressing_tpu.train import step as jstep

    jm = JaxModels.init_random(jax.random.PRNGKey(0), small=True)
    cfg = JaxTrainConfig(train_batch_size=2, warmup_steps=2,
                         learning_rate=1e-3)
    state, frozen, tx = jstep.init_train_state(jm, cfg)
    batch = {k: jnp.asarray(v) for k, v in _train_batch().items()}
    rng = jax.random.PRNGKey(1)
    b, shape = 2, (8, 8, 4)
    out = {}

    def keys_at(step):
        return jstep._example_keys(rng, jnp.int32(step), jnp.arange(b))

    for step in (0, 1):
        ks = jax.vmap(lambda k: jax.random.split(k, 5))(keys_at(step))

        def normal(i, shp):
            return jax.vmap(lambda k: jax.random.normal(k, shp, jnp.float32))(
                ks[:, i])

        out[f"draws{step}/eps_latents"] = normal(0, shape)
        out[f"draws{step}/eps_cloth"] = normal(1, shape)
        out[f"draws{step}/noise"] = normal(2, shape)
        out[f"draws{step}/noise_offset"] = normal(3, (1, 1, shape[-1]))
        out[f"draws{step}/timesteps"] = jax.vmap(
            lambda k: jax.random.randint(k, (), 0, 1000))(ks[:, 4])

    loss_fn = jstep.make_loss_fn(jm, cfg)
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
        state.params, frozen, batch, keys_at(0))
    out["loss0"] = loss
    out["grad_norm0"] = jnp.sqrt(sum(jnp.sum(g * g)
                                     for g in jax.tree.leaves(grads)))
    for m in TRAIN_MODELS:
        out[f"grad_norm0/{m}"] = jnp.sqrt(sum(
            jnp.sum(g * g) for g in jax.tree.leaves(grads[m])))
    flat_g = _flatten(grads)
    for leaf in TRAIN_LEAVES:
        out[f"grad0/{leaf}"] = flat_g[leaf]

    step_fn = jax.jit(jstep.make_train_step(jm, cfg, tx))
    for i in (1, 2):
        state, metrics = step_fn(state, frozen, batch, rng)
        out[f"step{i}/loss"] = metrics["loss"]
        out[f"step{i}/grad_norm"] = metrics["grad_norm"]
    flat_p = _flatten(state.params)
    for leaf in TRAIN_LEAVES:
        out[f"step2/{leaf}"] = flat_p[leaf]
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def train_golden():
    return dict(np.load(TRAIN_GOLDEN))


@pytest.fixture
def trainer(port):
    """A copy of the port's stack set up for training (fp32 throughout, as
    the JAX golden), the golden's TrainConfig, and the batch as tensors."""
    from imagdressing_tpu_torch.core.config import TrainConfig

    models = copy.deepcopy(port)
    cfg = TrainConfig(train_batch_size=2, warmup_steps=2, learning_rate=1e-3)
    state, frozen, tx = tstep.init_train_state(models, cfg)
    batch = {k: torch.as_tensor(v) for k, v in _train_batch().items()}
    batch["text_ids"] = batch["text_ids"].long()
    return models, cfg, state, frozen, tx, batch


def _golden_draws(golden, step):
    return tstep.Draws(**{
        f: torch.as_tensor(golden[f"draws{step}/{f}"])
        for f in ("eps_latents", "eps_cloth", "noise", "noise_offset",
                  "timesteps")})


def _named(state):
    return {f"{m}/{n}": p for m in TRAIN_MODELS
            for n, p in state.params[m].named_parameters()}


def _leaf_close(got: torch.Tensor, want: np.ndarray, leaf: str, what: str,
                atol: float, rtol: float):
    want = _port_layout(leaf.split("/", 1)[1], want)
    got = got.detach().numpy()
    assert got.shape == want.shape, (what, leaf, got.shape, want.shape)
    tol = atol + rtol * float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{what} {leaf}: max err {err:.3g} > {tol:.3g}"


def test_loss_from_draws_matches_jax_golden(trainer, train_golden):
    """The loss core on the golden's step-0 draws: the loss (rtol 1e-5),
    the global and per-model gradient norms (rtol 1e-4) and the gradients
    of TRAIN_LEAVES (atol 1e-6 + rtol 2e-4 * max|golden|), fp32."""
    models, cfg, state, frozen, _, batch = trainer
    g = train_golden
    loss = tstep.make_loss_fn(models, cfg)(state.params, frozen, batch,
                                           _golden_draws(g, 0))
    np.testing.assert_allclose(float(loss.detach()), g["loss0"], rtol=1e-5)
    named = _named(state)
    params = list(named.values())
    grads = dict(zip(named, torch.autograd.grad(loss, params,
                                                allow_unused=True)))
    grads = {k: torch.zeros_like(named[k]) if v is None else v
             for k, v in grads.items()}
    np.testing.assert_allclose(float(tstep.global_norm(list(grads.values()))),
                               g["grad_norm0"], rtol=1e-4)
    for m in TRAIN_MODELS:
        norm = tstep.global_norm([v for k, v in grads.items()
                                  if k.startswith(m + "/")])
        np.testing.assert_allclose(float(norm), g[f"grad_norm0/{m}"],
                                   rtol=1e-4, err_msg=m)
    for leaf in TRAIN_LEAVES:
        m, path = leaf.split("/", 1)
        _leaf_close(grads[f"{m}/{_port_leaf(m, path)}"], g[f"grad0/{leaf}"],
                    leaf, "grad", 1e-6, 2e-4)


def test_train_steps_match_jax_golden(trainer, train_golden):
    """Two steps of make_train_step on the golden's draws: the losses and
    grad norms of both (rtol 1e-4); the first step's learning rate is 0, so
    the trainables move only at the second; after it TRAIN_LEAVES match
    (atol 2e-6 + rtol 1e-4 * max|golden|: the AdamW step is about 5e-4 per
    element), the frozen models are unchanged."""
    models, cfg, state, frozen, tx, batch = trainer
    g = train_golden
    step = tstep.make_train_step(models, cfg, tx)
    frozen_before = [p.clone() for m in frozen.values()
                     for p in m.parameters()]
    for i in (1, 2):
        before = [p.detach().clone() for p in _named(state).values()]
        state, metrics = step(state, frozen, batch, seed=1,
                              draws=_golden_draws(g, i - 1))
        np.testing.assert_allclose(float(metrics["loss"]), g[f"step{i}/loss"],
                                   rtol=1e-4)
        np.testing.assert_allclose(float(metrics["grad_norm"]),
                                   g[f"step{i}/grad_norm"], rtol=1e-4)
        moved = any(not torch.equal(a, p)
                    for a, p in zip(before, _named(state).values()))
        assert moved == (i == 2), f"step {i}: params moved = {moved}"
    assert state.step == 2
    named = _named(state)
    for leaf in TRAIN_LEAVES:
        m, path = leaf.split("/", 1)
        _leaf_close(named[f"{m}/{_port_leaf(m, path)}"], g[f"step2/{leaf}"],
                    leaf, "param", 2e-6, 1e-4)
    after = [p for m in frozen.values() for p in m.parameters()]
    assert all(torch.equal(a, b) for a, b in zip(frozen_before, after))


def test_train_draws_do_not_depend_on_batch_layout():
    """An example's draws come from (seed, step, global index) alone."""
    both = tstep.make_draws(3, 5, [0, 1], (4, 4, 4), 1000, "cpu")
    second = tstep.make_draws(3, 5, [1], (4, 4, 4), 1000, "cpu")
    for f in dataclasses.fields(tstep.Draws):
        assert torch.equal(getattr(both, f.name)[1:],
                           getattr(second, f.name)), f.name
    other_step = tstep.make_draws(3, 6, [1], (4, 4, 4), 1000, "cpu")
    assert not torch.equal(other_step.noise, second.noise)


@pytest.mark.slow
def test_train_golden_is_current(train_golden):
    """The stored golden against a live recompute with the JAX package."""
    live = record_train_golden()
    assert set(live) == set(train_golden)
    for k, v in live.items():
        np.testing.assert_allclose(v, train_golden[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)


if __name__ == "__main__":
    # the settings tests/conftest.py gives the suite
    os.environ.setdefault("IMAGDRESSING_DISABLE_PALLAS", "1")
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_threefry_partitionable", True)
    # `python tests/test_torch_pipeline.py bf16` re-records the bf16 leg's
    # golden (~1 min); without an argument, the training golden
    path, record = ((BF16_GOLDEN, record_bf16_golden) if "bf16" in sys.argv
                    else (TRAIN_GOLDEN, record_train_golden))
    np.savez_compressed(path, **record())
    print("wrote", path, os.path.getsize(path), "bytes")
