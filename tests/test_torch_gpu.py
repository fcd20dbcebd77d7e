"""The port's CUDA kernels, pipeline, training step and human parser on a
card (marker `gpu`).

Each kernel is held against its plain PyTorch version on the same device at
one shape of the main paths (512x640, SD1.5 widths; SCHP's ragged shapes
for K7), every wrapper returns a tensor with a grad_fn when a gradient is
needed, the full-width `basic` pipeline runs a few steps, the full-width
training step two, and the full-width human parser one call. Whether a card
is present is decided in the `cuda` fixture, so every worker collects the
same tests; without a card they skip. This file imports no JAX: on the card's machine run it with

    python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from imagdressing_tpu_torch.core.config import PRESETS, TrainConfig
from imagdressing_tpu_torch.kernels import (
    flash_attention as fa,
    fused_bn_act as fba,
    fused_gn_conv as fgc,
    fused_groupnorm as fg,
)
from imagdressing_tpu_torch.pipelines.dressing import (
    DressingModels,
    DressingPipeline,
)
from imagdressing_tpu_torch.preprocess.parsing.infer import Parsing
from imagdressing_tpu_torch.train import step as tstep

pytestmark = pytest.mark.gpu

# bf16: a few output quanta at |y| ~ 1; fp32: sum-order differences only
TOL = {torch.bfloat16: (1e-2, 1e-2), torch.float32: (2e-4, 1e-4)}


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # plain fp32 convs in full fp32
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = tf32


def _close(got, want, dtype):
    atol, rtol = TOL[dtype]
    err = (got.float() - want.float()).abs().max().item()
    tol = atol + rtol * want.float().abs().max().item()
    assert err <= tol, f"max abs err {err:.3g} > {tol:.3g}"


def _randn(gen, shape, dtype, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_kernel_matches_plain(cuda, dtype):
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, kr, vr = (_randn(gen, (2, 5120, 8, 40), dtype) for _ in range(5))
    scale = torch.tensor([0.0, 1.0], device="cuda")
    n0 = fa.COUNTER.count
    got = fa.flash_attention(q, k, v, kr, vr, scale)
    torch.cuda.synchronize()
    assert fa.COUNTER.count == n0 + 1
    _close(got, fa.flash_attention_plain(q, k, v, kr, vr, scale), dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,s,h,d,dual", [
    (2, 5120, 8, 40, True), (2, 1280, 8, 80, True), (2, 320, 8, 160, True),
    (2, 80, 8, 160, True), (1, 5120, 8, 40, False), (1, 1280, 8, 80, False),
    (1, 320, 8, 160, False), (1, 80, 8, 160, False),
    (1, 5120, 1, 512, False)])
def test_flash_kernel_matches_plain_at_every_level(cuda, b, s, h, d, dual,
                                                   dtype):
    """K1 at every self-attention level of the `basic` path (the main UNet's
    CFG batch with scale [0, 1], the garment UNet's batch 1) and the VAE's
    D = 512 mid attention."""
    gen = torch.Generator(device="cuda").manual_seed(s + d)
    q, k, v = (_randn(gen, (b, s, h, d), dtype) for _ in range(3))
    ref = ()
    if dual:
        ref = (_randn(gen, (b, s, h, d), dtype),
               _randn(gen, (b, s, h, d), dtype),
               torch.tensor([0.0, 1.0], device="cuda"))
    got = fa.flash_attention(q, k, v, *ref)
    torch.cuda.synchronize()
    _close(got, fa.flash_attention_plain(q, k, v, *ref), dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [40, 160])
@pytest.mark.parametrize("sq,skv,sref", [(100, 100, 37), (80, 77, 130)])
def test_flash_forward_ragged_matches_plain(cuda, sq, skv, sref, d, dtype):
    """K1 and K5 at ragged lengths, scale [0, 0.7]: the zero-filled tails
    of the q and key tiles (and of the D padding at D = 40), the masked
    keys; K1 skips the scale-0 row's reference pass, K5 does not."""
    gen = torch.Generator(device="cuda").manual_seed(sq + skv + d)
    q = _randn(gen, (2, sq, 2, d), dtype)
    k, v = (_randn(gen, (2, skv, 2, d), dtype) for _ in range(2))
    kr, vr = (_randn(gen, (2, sref, 2, d), dtype) for _ in range(2))
    scale = torch.tensor([0.0, 0.7], device="cuda")
    got = fa.flash_attention(q, k, v, kr, vr, scale)
    res = fa.flash_attention_res(q, k, v, kr, vr, scale)
    torch.cuda.synchronize()
    _close(got, fa.flash_attention_plain(q, k, v, kr, vr, scale), dtype)
    want = fa.flash_attention_res_plain(q, k, v, kr, vr, scale)
    _close(res[0], want[0], dtype)
    _close(res[2], want[2], dtype)
    assert (res[1] - want[1]).abs().max().item() <= 1e-3  # base-2 lse


def test_flash_forward_is_deterministic(cuda):
    """K1 at the CFG batch and K5 at the training shape, twice on the same
    inputs: bit-identical out, lse and O2 (no atomics)."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    q, k, v, kr, vr = (_randn(gen, (2, 5120, 8, 40), torch.bfloat16)
                       for _ in range(5))
    scale = torch.tensor([0.0, 1.0], device="cuda")
    assert torch.equal(fa.flash_attention(q, k, v, kr, vr, scale),
                       fa.flash_attention(q, k, v, kr, vr, scale))
    one = [x[1:].contiguous() for x in (q, k, v, kr, vr)]
    s1 = torch.ones(1, device="cuda")
    first = fa.flash_attention_res(*one, s1)
    second = fa.flash_attention_res(*one, s1)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gn_conv_kernel_matches_plain(cuda, dtype):
    gen = torch.Generator(device="cuda").manual_seed(1)
    b, h, w, cin, co = 2, 80, 64, 320, 320
    x = _randn(gen, (b, h, w, cin), dtype)
    gw, gb = _randn(gen, (cin,), dtype), _randn(gen, (cin,), dtype)
    wt = _randn(gen, (co, cin, 3, 3), dtype, (9 * cin) ** -0.5).contiguous(
        memory_format=torch.channels_last)
    cb, t = _randn(gen, (co,), dtype), _randn(gen, (b, cin), dtype)
    args = (x, gw, gb, wt, cb)
    got = fgc.gn_silu_conv3x3(*args, num_groups=32, eps=1e-5, add=t)
    want = fgc.gn_silu_conv3x3_plain(*args, num_groups=32, eps=1e-5, add=t)
    torch.cuda.synchronize()
    _close(got, want, dtype)


def _gn_conv_args(seed, b, h, w, cin, co, with_add):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    bf = torch.bfloat16
    x = _randn(gen, (b, h, w, cin), bf)
    gw, gb = 1 + _randn(gen, (cin,), bf, 0.1), _randn(gen, (cin,), bf, 0.1)
    wt = _randn(gen, (co, cin, 3, 3), bf, (9 * cin) ** -0.5).contiguous(
        memory_format=torch.channels_last)
    cb = _randn(gen, (co,), bf)
    t = _randn(gen, (b, cin), bf) if with_add else None
    kw = dict(num_groups=32 if cin % 32 == 0 else 8, eps=1e-5, add=t)
    return (x, gw, gb, wt, cb), kw


@pytest.mark.parametrize("shape,split", [((2, 10, 8, 1280, 1280, True), True),
                                         ((1, 9, 13, 40, 24, False), None)])
def test_gn_conv_bf16_split_k_and_ragged_match_plain(cuda, shape, split):
    """The bf16 conv at the deepest UNet level of a CFG step, which the
    plan splits along K, and at a shape whose H, W, Cin and Cout fit no
    tile (zero-filled borders, channel tail and N tail)."""
    if split is not None:
        assert (fgc.conv_plan(*shape[:5]).splits > 1) == split
    args, kw = _gn_conv_args(8, *shape)
    n0 = fgc.COUNTER.count
    got = fgc.gn_silu_conv3x3(*args, **kw)
    want = fgc.gn_silu_conv3x3_plain(*args, **kw)
    torch.cuda.synchronize()
    assert fgc.COUNTER.count == n0 + 1
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    _close(got, want, torch.bfloat16)


def test_gn_conv_split_k_is_deterministic(cuda):
    """The split partials are added in a fixed order: two runs on the same
    inputs give the same bits."""
    shape = (2, 20, 16, 2560, 1280, True)
    assert fgc.conv_plan(*shape[:5]).splits > 1
    args, kw = _gn_conv_args(9, *shape)
    first = fgc.gn_silu_conv3x3(*args, **kw)
    second = fgc.gn_silu_conv3x3(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


# K3's shapes: the four UNet levels of a CFG step (batch 2) and of the
# garment pass (batch 1), a ragged shape whose rows fit no box and whose
# groups are 5 channels wide, and a VAE pixel level that fits no cluster
# (streaming mode); (B, M, C, groups, resident)
GN_SHAPES = [(2, 5120, 320, 32, True), (2, 1280, 640, 32, True),
             (2, 320, 1280, 32, True), (2, 80, 1280, 32, True),
             (1, 5120, 320, 32, True), (1, 1280, 640, 32, True),
             (1, 320, 1280, 32, True), (1, 80, 1280, 32, True),
             (1, 77, 40, 8, True), (1, 327680, 128, 32, False)]


def _gn_args(seed, b, m, c, groups, with_add, dtype):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = _randn(gen, (b, m, c), dtype)
    w, bb = 1 + _randn(gen, (c,), dtype, 0.1), _randn(gen, (c,), dtype, 0.1)
    t = _randn(gen, (b, c), dtype) if with_add else None
    # with add: the GN+conv prologue's function (temb folded, SiLU)
    kw = dict(num_groups=groups, eps=1e-5 if with_add else 1e-6,
              act="silu" if with_add else "none", add=t)
    return (x, w, bb), kw


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("with_add", [False, True])
@pytest.mark.parametrize("b,m,c,groups,resident", GN_SHAPES)
def test_group_norm_kernel_matches_plain(cuda, b, m, c, groups, resident,
                                         with_add, dtype):
    """K3 in the mode its plan documents, one launch counted, against the
    plain version."""
    args, kw = _gn_args(2, b, m, c, groups, with_add, dtype)
    assert fg.gn_plan(b, m, c, groups, dtype, kw["act"]).resident == resident
    n0 = fg.COUNTER.count
    got = fg.group_norm_act(*args, **kw)
    want = fg.group_norm_act_plain(*args, **kw)
    torch.cuda.synchronize()
    assert fg.COUNTER.count == n0 + 1
    assert got.shape == want.shape and got.dtype == dtype
    _close(got, want, dtype)


@pytest.mark.parametrize("b,m,c", [(2, 5120, 320), (1, 327680, 128)])
def test_group_norm_is_deterministic(cuda, b, m, c):
    """Resident and streaming: the cluster's partials and the clusters'
    partials are added in a fixed order, so repeats give the same bits."""
    args, kw = _gn_args(3, b, m, c, 32, True, torch.bfloat16)
    first = fg.group_norm_act(*args, **kw)
    second = fg.group_norm_act(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_full_width_pipeline_runs_through_the_kernels(cuda):
    """Full SD1.5 widths, 512x640, bf16, 2 steps: a uint8 image, every
    kernel launched."""
    models = DressingModels.init_random(0).cast(torch.bfloat16)
    pipe = DressingPipeline(models, PRESETS["basic"])
    rng = np.random.default_rng(0)
    counters = (fa.COUNTER, fgc.COUNTER, fg.COUNTER)
    for c in counters:
        c.reset()
    out = pipe(prompt_ids=rng.integers(0, 49408, (1, 77)),
               negative_prompt_ids=rng.integers(0, 49408, (1, 77)),
               ref_image=rng.uniform(-1, 1, (1, 640, 512, 3)),
               ref_clip_image=rng.standard_normal((1, 224, 224, 3)),
               num_inference_steps=2, output_uint8=True)
    assert out.shape == (1, 640, 512, 3) and out.dtype == np.uint8
    assert out.std() > 0
    assert all(c.count > 0 for c in counters)


@pytest.mark.parametrize("preset,used,encodes", [("pose", 2, 1),
                                                 ("ipa_pose", 2, 1),
                                                 ("inpaint", 1, 2)])
def test_full_width_presets_run_through_the_kernels(cuda, preset, used,
                                                    encodes):
    """The ControlNet presets at full SD1.5 width and their sizes, bf16, 2
    steps (inpaint's strength 0.99 uses 1): a uint8 image, and per step the
    main UNet's and the ControlNet's launches of K1 (16 + 7), K2 (44 + 20)
    and K3 (17 + 7), plus the garment pass and the VAE's."""
    models = DressingModels.init_random(0, with_controlnet=True,
                                        with_ipa=True).cast(torch.bfloat16)
    p = PRESETS[preset]
    pipe = DressingPipeline(models, p)
    h, w = p.height, p.width
    rng = np.random.default_rng(0)
    counters = (fa.COUNTER, fgc.COUNTER, fg.COUNTER)
    for c in counters:
        c.reset()
    out = pipe(prompt_ids=rng.integers(0, 49408, (1, 77)),
               negative_prompt_ids=rng.integers(0, 49408, (1, 77)),
               ref_image=rng.uniform(-1, 1, (1, h, w, 3)),
               ref_clip_image=rng.standard_normal((1, 224, 224, 3)),
               pose_image=rng.uniform(0, 1, (1, h, w, 3)),
               faceid_embeds=rng.standard_normal((1, 512)),
               face_clip_image=rng.standard_normal((1, 224, 224, 3)),
               person_image=rng.uniform(-1, 1, (1, h, w, 3)),
               mask_image=np.ones((1, h, w, 1), np.float32),
               num_inference_steps=2, output_uint8=True)
    assert out.shape == (1, h, w, 3) and out.dtype == np.uint8
    assert out.std() > 0
    assert [c.count for c in counters] == [
        used * 23 + 16 + encodes + 1, used * 64 + 44 + 20 * encodes + 28,
        used * 24 + 17]


def test_wrappers_return_a_grad_fn_under_grad(cuda):
    """Every CUDA wrapper, asked for a gradient, returns its Function's
    output (and the gradient reaches the inputs); without one, no grad_fn."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    bf = torch.bfloat16
    q, k, v, kr, vr = (_randn(gen, (1, 320, 8, 160), bf).requires_grad_()
                       for _ in range(5))
    x = _randn(gen, (1, 20, 16, 640), bf).requires_grad_()
    gw, gb = _randn(gen, (640,), bf), _randn(gen, (640,), bf)
    wt = _randn(gen, (640, 640, 3, 3), bf, 0.01).contiguous(
        memory_format=torch.channels_last).requires_grad_()
    cb = _randn(gen, (640,), bf)
    outs = {
        "FlashAttentionFunctionBackward": (
            fa.flash_attention(q, k, v, kr, vr, 1.0), (q, kr)),
        "GnSiluConv3x3FunctionBackward": (
            fgc.gn_silu_conv3x3(x, gw, gb, wt, cb, num_groups=32, eps=1e-5),
            (x, wt)),
        "GroupNormActFunctionBackward": (
            fg.group_norm_act(x, gw, gb, num_groups=32, eps=1e-6), (x,)),
    }
    for name, (y, leaves) in outs.items():
        assert type(y.grad_fn).__name__ == name
        grads = torch.autograd.grad(y.float().square().sum(), leaves)
        assert all(torch.isfinite(g).all() and g.abs().sum() > 0
                   for g in grads), name
    with torch.no_grad():
        assert fa.flash_attention(q, k, v).grad_fn is None


def test_flash_backward_refuses_wide_heads(cuda):
    """D = 512 (the VAE mid attention) runs only without a gradient."""
    q = torch.randn((1, 64, 1, 512), device="cuda",
                    dtype=torch.bfloat16).requires_grad_()
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q, q, q)
    with torch.no_grad():
        assert fa.flash_attention(q, q, q).shape == q.shape


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_backward_kernels_match_plain(cuda, dtype):
    """K5 residuals and K6a/K6b gradients against the plain versions at the
    1280-token level, batch 2 with scale [0, 0.7]: the scale-0 row's
    reference gradients are written as zeros."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    q, k, v, kr, vr, g = (_randn(gen, (2, 1280, 8, 80), dtype)
                          for _ in range(6))
    scale = torch.tensor([0.0, 0.7], device="cuda")
    res = fa.flash_attention_res(q, k, v, kr, vr, scale)
    want = fa.flash_attention_res_plain(q, k, v, kr, vr, scale)
    for a, b in zip(res, want):
        _close(a, b, dtype)
    got = fa.flash_attention_bwd(q, k, v, kr, vr, scale, *want, g)
    want = fa.flash_attention_bwd_plain(q, k, v, kr, vr, scale, *want, g)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        _close(a, b, dtype)
    assert not got[3][0].any() and not got[4][0].any()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [40, 160])
@pytest.mark.parametrize("sq,skv,sref", [(100, 100, 37), (80, 77, 130)])
def test_flash_backward_ragged_matches_plain(cuda, sq, skv, sref, d, dtype):
    """K6b + K6a at the ragged lengths of the CPU test of the Function's
    gradients (masked sequence edges; at D = 40 the zero-filled padding
    columns), scale [0, 0.7]: the gradients and K6b's D_i against the plain
    versions."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    q, g = (_randn(gen, (2, sq, 2, d), dtype) for _ in range(2))
    k, v = (_randn(gen, (2, skv, 2, d), dtype) for _ in range(2))
    kr, vr = (_randn(gen, (2, sref, 2, d), dtype) for _ in range(2))
    scale = torch.tensor([0.0, 0.7], device="cuda")
    res = fa.flash_attention_res_plain(q, k, v, kr, vr, scale)
    got, delta = fa._launch_bwd(q, k, v, kr, vr, scale, *res, g)
    want = fa.flash_attention_bwd_plain(q, k, v, kr, vr, scale, *res, g)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        _close(a, b, dtype)
    want_delta = fa.flash_attention_delta_plain(g, res[0], res[2], scale)
    err = (delta - want_delta).abs().max().item()
    assert err <= 1e-5 + 1e-5 * want_delta.abs().max().item(), err
    assert not got[3][0].any() and not got[4][0].any()


def test_flash_backward_is_deterministic(cuda):
    """The pair twice on the same inputs at the main training shape gives
    bit-identical gradients and D_i: no atomics, a fixed summation order."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    q, k, v, kr, vr, g = (_randn(gen, (1, 5120, 8, 40), torch.bfloat16)
                          for _ in range(6))
    scale = torch.tensor([1.0], device="cuda")
    res = fa.flash_attention_res_plain(q, k, v, kr, vr, scale)
    first = fa._launch_bwd(q, k, v, kr, vr, scale, *res, g)
    second = fa._launch_bwd(q, k, v, kr, vr, scale, *res, g)
    torch.cuda.synchronize()
    for a, b in zip((*first[0], first[1]), (*second[0], second[1])):
        assert torch.equal(a, b)


def test_full_width_training_step_runs_through_the_kernels(cuda):
    """Full SD1.5 widths, 512x640, batch 1, bf16 + fp32 masters: two steps,
    finite losses, the training kernels launched."""
    models = DressingModels.init_random(0).cast_for_training(torch.bfloat16)
    cfg = TrainConfig(train_batch_size=1, warmup_steps=1)
    state, frozen, tx = tstep.init_train_state(models, cfg)
    step = tstep.make_train_step(models, cfg, tx)
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = {"person_image": torch.rand((1, 640, 512, 3), generator=gen,
                                        device="cuda") * 2 - 1,
             "cloth_image": torch.rand((1, 640, 512, 3), generator=gen,
                                       device="cuda") * 2 - 1,
             "cloth_clip": torch.randn((1, 224, 224, 3), generator=gen,
                                       device="cuda"),
             "text_ids": torch.randint(0, 49408, (1, 77), generator=gen,
                                       device="cuda")}
    counters = (fa.RES_COUNTER, fa.DKV_COUNTER, fa.DQ_COUNTER, fgc.COUNTER,
                fg.COUNTER)
    for c in counters:
        c.reset()
    for _ in range(2):
        state, metrics = step(state, frozen, batch, seed=0)
        assert np.isfinite(float(metrics["loss"]))
        assert np.isfinite(float(metrics["grad_norm"]))
    assert all(c.count > 0 for c in counters)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,act", [((1, 237, 237, 48), "leaky_relu"),
                                       ((1, 3, 3, 512), "none"),
                                       ((1, 1, 1, 2048), "elu")])
def test_bn_act_kernel_matches_plain(cuda, shape, act, dtype):
    """K7 at ragged shapes: an odd row count with C = 48 (six bf16
    vectors), a PSP map of 9 rows, a single row."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    c = shape[-1]
    x = _randn(gen, shape, dtype, 2.0)
    params = (1 + _randn(gen, (c,), torch.float32, 0.3),
              _randn(gen, (c,), torch.float32, 0.3),
              _randn(gen, (c,), torch.float32, 0.5),
              torch.rand(c, generator=gen, device="cuda") + 0.3)
    n0 = fba.COUNTER.count
    got = fba.abn_inference(x, *params, activation=act)
    want = fba.abn_inference_plain(x, *params, activation=act)
    torch.cuda.synchronize()
    assert fba.COUNTER.count == n0 + 1
    assert got.dtype == dtype and got.shape == x.shape
    _close(got, want, dtype)


def test_bn_act_refuses_a_non_contiguous_input(cuda):
    x = torch.randn((1, 8, 8, 64), device="cuda")
    p = torch.ones(64, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        fba.abn_inference(x.transpose(1, 2), p, p, p, p)


@pytest.mark.parametrize("act", ["leaky_relu", "elu", "none"])
def test_abn_train_matches_the_cpu_in_float64(cuda, act):
    """The training-mode ABN on the card (fp32 moments, one K7 launch for
    the apply, the inverse-recompute backward) against the CPU plain path
    in float64 on the same inputs, (2, 30, 30, 256): y and the moments
    within 1e-5, dx, dw, db within 1e-4 * max of the float64 values (fp32
    sums over 1800 rows)."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    shape, c = (2, 30, 30, 256), 256
    x = _randn(gen, shape, torch.float32, 2.0) + 0.5
    w = 1 + _randn(gen, (c,), torch.float32, 0.3)
    b = _randn(gen, (c,), torch.float32, 0.3)
    g = _randn(gen, shape, torch.float32)
    sides = {}
    for dev, dt in (("cuda", torch.float32), ("cpu", torch.float64)):
        leaves = [t.detach().to(dev, dt).requires_grad_() for t in (x, w, b)]
        n0 = fba.COUNTER.count
        y, mean, var = fba.abn_train_stats(*leaves, activation=act)
        launched = fba.COUNTER.count - n0
        (y * g.to(dev, dt)).sum().backward()
        sides[dev] = [t.detach().double().cpu() for t in
                      (y, mean, var, *(v.grad for v in leaves))]
        if dev == "cuda":
            assert launched == 1
    for i, (got, want) in enumerate(zip(sides["cuda"], sides["cpu"])):
        rtol = 1e-5 if i < 3 else 1e-4
        assert (got - want).abs().max() <= rtol * want.abs().max()


def test_parsing_train_step_runs_through_k7(cuda):
    """Two SCHP fine-tune steps at full width and depth on the card (64x64,
    batch 2, 6 classes): finite losses, 119 K7 launches a step (one per
    ABN, the train-mode apply), moved running statistics."""
    from imagdressing_tpu_torch.preprocess.parsing import model as schp
    from imagdressing_tpu_torch.train import parsing_train as pt

    net = schp.init(0, 6).requires_grad_(True)
    cfg = pt.ParsingTrainConfig(num_classes=6, total_steps=10)
    step = pt.make_parsing_train_step(cfg, net, pt.make_optimizer(cfg, net))
    rng = np.random.default_rng(0)
    label = rng.integers(0, 6, (2, 64, 64))
    batch = {"image": torch.randn(2, 64, 64, 3, device="cuda"),
             "label": torch.from_numpy(label).cuda(),
             "edge": torch.from_numpy(pt.edges_from_labels(label)).cuda()}
    rm0 = net.bn1.running_mean.clone()
    for i in range(2):
        fba.COUNTER.reset()
        loss = step(i, batch)["loss"]
        assert torch.isfinite(loss) and fba.COUNTER.count == 119
    assert (net.bn1.running_mean - rm0).abs().max() > 0


def test_full_width_parsing_returns_the_contract(cuda):
    """The SCHP parser at full width (ATR 512 + LIP 473) on a 200x150
    photo: a uint8 map with labels 0-18, the face mask of label 11, and
    K7 launched at all 2 x 119 InPlaceABNs."""
    parsing = Parsing.init_random(0)
    img = np.random.default_rng(0).integers(0, 256, (200, 150, 3), np.uint8)
    fba.COUNTER.reset()
    parse, face = parsing(img)
    assert parse.shape == (200, 150) and parse.dtype == np.uint8
    assert face.shape == (200, 150) and face.dtype == np.float32
    assert parse.max() <= 18
    assert np.array_equal(face, (parse == 11).astype(np.float32))
    assert fba.COUNTER.count == 238
    assert set(parsing.last_device_ms) == {"atr", "lip"}
