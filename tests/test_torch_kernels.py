"""The port's kernel modules against the JAX package's Pallas kernels.

On this CPU host each port wrapper runs its plain PyTorch version (the
tensor lies on the CPU); the JAX side runs its Pallas kernel through the
interpreter (`INTERPRET=True`, as its own tests do) or its XLA reference.
Gradients go through the port's autograd Functions (the plain K5 forward and
K6 backward for the flash attention; the recomputed reference chains for
K2/K3) and through `jax.grad` of the JAX functions. Same inputs, made with
numpy from a seed. fp32 tolerances are those of the JAX kernel tests or
tighter.
"""

import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import imagdressing_tpu.kernels.flash_attention as jfa
import imagdressing_tpu.kernels.fused_gn_conv as jfgc
import imagdressing_tpu.kernels.fused_groupnorm as jfg
from imagdressing_tpu_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_delta_plain,
    flash_attention_res_plain,
)
from imagdressing_tpu_torch.core.config import UNetConfig, VAEConfig
from imagdressing_tpu_torch.kernels import flash_attention as tfa
from imagdressing_tpu_torch.kernels import fused_gn_conv as fgc
from imagdressing_tpu_torch.kernels import fused_groupnorm as fg
from imagdressing_tpu_torch.kernels.fused_gn_conv import gn_silu_conv3x3
from imagdressing_tpu_torch.kernels.fused_groupnorm import group_norm_act


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _conv_w(w_hwio):
    """HWIO numpy -> the port's OIHW channels_last weight."""
    return _t(w_hwio).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)


# ---------------------------------------------------------------------------
# K1: dual-KV flash forward
# ---------------------------------------------------------------------------


@pytest.fixture
def fa_interpret():
    jfa.INTERPRET = True
    yield
    jfa.INTERPRET = False


@pytest.mark.parametrize("dual", [True, False])
@pytest.mark.parametrize("d", [40, 80])
def test_flash_matches_pallas_interpret(fa_interpret, d, dual):
    """S=256 (the smallest length the Pallas kernel takes), ref_scale
    [0, 0.7]: the uncond row skips the garment pass. fp32, atol 1e-4
    (the JAX kernel test allows 2e-3 against fp64)."""
    rng = np.random.default_rng(3)
    q, k, v, kr, vr = (rng.standard_normal((2, 256, 2, d)).astype(np.float32)
                       for _ in range(5))
    scale = np.array([0.0, 0.7], np.float32)
    if dual:
        want = jax.jit(jfa.flash_attention)(
            *map(jnp.asarray, (q, k, v, kr, vr, scale)))
        got = flash_attention(*map(_t, (q, k, v, kr, vr, scale)))
    else:
        want = jax.jit(jfa.flash_attention)(*map(jnp.asarray, (q, k, v)))
        got = flash_attention(*map(_t, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_flash_wide_head_dim_matches_pallas_interpret(fa_interpret):
    """D=512 single head, the VAE mid attention; atol 1e-4 (JAX: 5e-3)."""
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal((1, 256, 1, 512)).astype(np.float32)
               for _ in range(3))
    want = jax.jit(jfa.flash_attention)(*map(jnp.asarray, (q, k, v)))
    got = flash_attention(*map(_t, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("sq,skv,sref", [(80, 80, 80), (100, 100, 37),
                                         (320, 77, 130)])
def test_flash_ragged_matches_xla_forward(sq, skv, sref):
    """Lengths the Pallas kernel does not take (the port's kernel masks the
    ragged edge), against the JAX forward's XLA math; fp32, atol 1e-5."""
    rng = np.random.default_rng(sq + sref)
    q = rng.standard_normal((2, sq, 2, 40)).astype(np.float32)
    k, v = (rng.standard_normal((2, skv, 2, 40)).astype(np.float32)
            for _ in range(2))
    kr, vr = (rng.standard_normal((2, sref, 2, 40)).astype(np.float32)
              for _ in range(2))
    scale = np.array([0.0, 0.7], np.float32)
    want = jax.jit(jfa._xla_forward_equiv)(
        *map(jnp.asarray, (q, k, v, kr, vr, scale)))
    got = flash_attention(*map(_t, (q, k, v, kr, vr, scale)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    # the scale-0 row is exactly the single-source attention
    single = flash_attention(*map(_t, (q, k, v)))
    assert torch.equal(got[0], single[0])


def test_flash_bf16_matches_pallas_interpret(fa_interpret):
    """The bf16 leg: K1's plain version on bf16 inputs against the JAX
    kernel in interpret mode on the same bf16 inputs, S=256, D=40, dual,
    scale [0, 0.7]. Tolerance 2**-8 + 4e-3: one bf16 rounding of each
    output (a full bf16 quantum below |y| = 1, 2**-8; max|ref| is ~0.8) plus
    the JAX kernel's temperature shift, which folds 1/sqrt(D) into bf16 q
    (~0.2 % of the logits, PARITY.md) where the port keeps the scale in fp32:
    up to ~0.2 % of a logit spread of a few units through both sources. The
    error measured with this seed is 0.0049."""
    rng = np.random.default_rng(3)
    q, k, v, kr, vr = (rng.standard_normal((2, 256, 2, 40)).astype(np.float32)
                       for _ in range(5))
    scale = np.array([0.0, 0.7], np.float32)
    want = jax.jit(jfa.flash_attention)(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, kr, vr)),
        jnp.asarray(scale))
    got = flash_attention(*(_t(x).to(torch.bfloat16) for x in (q, k, v, kr, vr)),
                          _t(scale))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=2.0 ** -8 + 4e-3, rtol=0)


# the batches the full-width paths run: the UNets at 1 (the garment pass, a
# training step), 2 (a CFG step of one image) and 8 (a CFG step of the
# server's batch of 4); the VAE at 1, 2 and 4
UNET_BATCHES = (1, 2, 8)
VAE_BATCHES = (1, 2, 4)


def _full_width_flash_shapes():
    """(b, sq, h, d) of every flash forward (K1, and K5 under a gradient) of
    the full-width paths at 512x640 (`basic`, `pose`, `ipa_pose`, training)
    and 512x512 (`inpaint`): each UNet self-attention level with attention
    (main and garment UNet and the ControlNet's trunk, UNET_BATCHES) and
    the VAE's single-head mid attention (VAE_BATCHES); then the same for the
    tiny test stacks (`small=True` and `chip_smoke.py`'s mini stack, 64x64 images)
    where the head dim meets the card's rule (a multiple of 8). The
    `concat` self-attention's 2S keys and the garment-cross branch run at
    these q shapes: the plan has no key length."""
    shapes = set()
    stacks = [(UNetConfig(), VAEConfig(), 640, 512),
              (UNetConfig(), VAEConfig(), 512, 512),
              (UNetConfig(block_out_channels=(16, 32, 64, 64),
                          attention_num_heads=4),
               VAEConfig(block_out_channels=(16, 16, 32, 32)), 64, 64),
              (UNetConfig(block_out_channels=(32, 64, 64, 64),
                          attention_num_heads=4),
               VAEConfig(block_out_channels=(32, 32, 64, 64)), 64, 64)]
    for u, v, hh, ww in stacks:
        lh, lw = hh // 8, ww // 8
        levels = [lvl for lvl, a in enumerate(u.down_block_has_attn) if a]
        levels.append(len(u.block_out_channels) - 1)  # the mid block
        for b in UNET_BATCHES:
            for lvl in levels:
                d = u.block_out_channels[lvl] // u.attention_num_heads
                if d % 8 == 0:
                    shapes.add((b, (lh >> lvl) * (lw >> lvl),
                                u.attention_num_heads, d))
        for b in VAE_BATCHES:
            shapes.add((b, lh * lw, 1, v.block_out_channels[-1]))
    return sorted(shapes)


def test_flash_plan_keeps_the_kernel_limits():
    """The bf16 forward's plan at every flash shape of the full-width paths
    and the tiny test stacks, with one and two sources: shared memory within
    the 227 KB a block may use, rows a multiple of 64 (one consumer
    warpgroup each, at most two), the contraction a multiple of 16 covering
    D, the output columns an instantiated N width (up to D = 160 one block
    covering D; the VAE's D = 512 in blocks of 256), tiles the kernel is
    built with, a ring of at least two stages, and the grid the kernel
    launches."""
    shapes = _full_width_flash_shapes()
    assert (2, 5120, 8, 40) in shapes and (2, 80, 8, 160) in shapes \
        and (1, 5120, 1, 512) in shapes and (2, 64, 4, 8) in shapes \
        and (2, 4096, 8, 40) in shapes and (1, 4096, 1, 512) in shapes \
        and (8, 5120, 8, 40) in shapes and (8, 1280, 8, 80) in shapes \
        and (4, 5120, 1, 512) in shapes
    assert {d for *_, d in shapes if d > tfa.MAX_GRAD_HEAD_DIM} == {512}
    for b, sq, h, d in shapes:
        for dual in (True, False):
            p = tfa.flash_plan(b, sq, h, d, dual)
            what = (b, sq, h, d, dual, p)
            assert p.smem <= tfa.SMEM_LIMIT == 232448, what
            assert p.smem == tfa.fwd_smem(p.rows, p.bkv, p.stages, p.dn,
                                          p.dk, dual), what
            assert p.rows in (64, 128) and p.rows % 64 == 0, what
            assert p.dk % 16 == 0 and p.dk >= d, what
            if d <= tfa.MAX_GRAD_HEAD_DIM:
                assert p.dk < d + 16 and p.dn in tfa.FWD_WIDTHS, what
                assert p.dn >= d, what
            else:
                assert (p.dn, p.dk) == (tfa.WIDE_DN, tfa.WIDE_DK), what
            assert (p.rows, p.bkv) in tfa.fwd_tiles(d), what
            assert 2 <= p.stages <= tfa.MAX_STAGES, what
            assert p.blocks == b * h * -(-sq // p.rows) * -(-d // p.dn), what


# ---------------------------------------------------------------------------
# K5: forward with residuals; K6a/K6b: backward
# ---------------------------------------------------------------------------


def _fold(x):  # (B, S, H, D) -> (BH, S, D), the JAX kernels' layout
    b, s, h, d = x.shape
    return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(b * h, s, d)


def test_flash_residuals_match_pallas_interpret():
    """K5: out, the base-2 lse of each source (lane 0 of JAX's lane-
    replicated layout) and O2, S=256, D=40, dual with scale [0, 0.7] (no row
    is skipped), fp32: atol 1e-4 on out/O2, 1e-4 on lse (in bits)."""
    rng = np.random.default_rng(11)
    b, s, h, d = 2, 256, 2, 40
    q, k, v, kr, vr = (rng.standard_normal((b, s, h, d)).astype(np.float32)
                       for _ in range(5))
    scale = np.array([0.0, 0.7], np.float32)
    out, lse, o2 = jfa._flash_call_res(
        _fold(q), jnp.concatenate([_fold(k), _fold(kr)], axis=1),
        jnp.concatenate([_fold(v), _fold(vr)], axis=1), jnp.asarray(scale),
        num_heads=h, sm_scale=d ** -0.5, block_q=128, block_k=128,
        num_sources=2, interpret=True)
    got_out, got_lse, got_o2 = flash_attention_res_plain(
        *map(_t, (q, k, v, kr, vr, scale)))

    def unfold(x):  # (BH, S, D) -> (B, S, H, D)
        return np.asarray(x).reshape(b, h, s, d).transpose(0, 2, 1, 3)

    np.testing.assert_allclose(got_out.numpy(), unfold(out), atol=1e-4)
    np.testing.assert_allclose(got_o2.numpy(), unfold(o2), atol=1e-4)
    assert got_lse.shape == (b, h, 2, s)
    np.testing.assert_allclose(
        got_lse.numpy(), np.asarray(lse)[..., 0].reshape(b, h, 2, s),
        atol=1e-4)


def _grads_port(args, g, dual):
    ts = [_t(a).requires_grad_() for a in args]
    out = flash_attention(*ts[:5], ts[5]) if dual else flash_attention(*ts)
    assert type(out.grad_fn).__name__ == "FlashAttentionFunctionBackward"
    return [x.numpy() for x in torch.autograd.grad(out, ts, _t(g))]


@pytest.mark.parametrize("dual", [True, False])
def test_flash_grads_match_pallas_interpret(fa_interpret, dual):
    """The Function (K5 + K6a + K6b plain versions) against jax.grad of the
    JAX `flash_attention` through its Pallas forward-with-residuals and
    backward kernels in interpret mode: dq, dk, dv (and dk_ref, dv_ref,
    d scale). S=256, D=40, scale [0, 0.7], fp32, atol 1e-4 (the issue's
    bound is 5e-3 / rtol 1e-3)."""
    rng = np.random.default_rng(12 + dual)
    b, s, h, d = 2, 256, 2, 40
    args = [rng.standard_normal((b, s, h, d)).astype(np.float32)
            for _ in range(5 if dual else 3)]
    if dual:
        args.append(np.array([0.0, 0.7], np.float32))
    g = rng.standard_normal((b, s, h, d)).astype(np.float32)

    def loss(*a):
        return jnp.sum(jfa.flash_attention(*a) * g)

    want = jax.jit(jax.grad(loss, argnums=tuple(range(len(args)))))(
        *map(jnp.asarray, args))
    got = _grads_port(args, g, dual)
    for i, (x, y) in enumerate(zip(got, want)):
        np.testing.assert_allclose(x, np.asarray(y), atol=1e-4,
                                   err_msg=f"grad {i}")


@pytest.mark.parametrize("sq,skv,sref", [(100, 100, 37), (80, 77, 130)])
def test_flash_grads_ragged_match_xla_autodiff(sq, skv, sref):
    """Ragged lengths (the Pallas kernels take none): the Function's
    gradients against jax.grad of the JAX forward's XLA math
    (`_xla_forward_equiv`), fp32, atol 2e-5 + rtol 1e-5 (d scale is a sum
    of 2e4 products)."""
    rng = np.random.default_rng(sq + skv + sref)
    b, h, d = 2, 2, 40
    args = [rng.standard_normal((b, n, h, d)).astype(np.float32)
            for n in (sq, skv, skv, sref, sref)]
    args.append(np.array([0.0, 0.7], np.float32))
    g = rng.standard_normal((b, sq, h, d)).astype(np.float32)

    def loss(*a):
        return jnp.sum(jfa._xla_forward_equiv(*a) * g)

    want = jax.jit(jax.grad(loss, argnums=tuple(range(6))))(
        *map(jnp.asarray, args))
    got = _grads_port(args, g, True)
    for i, (x, y) in enumerate(zip(got, want)):
        np.testing.assert_allclose(x, np.asarray(y), atol=2e-5, rtol=1e-5,
                                   err_msg=f"grad {i}")
    # the scale-0 row's reference gradients are exactly zero
    assert not got[3][0].any() and not got[4][0].any()


@pytest.mark.parametrize("dual", [True, False])
def test_flash_delta_matches_bwd_di(dual):
    """The D_i that K6b writes for K6a, against the JAX kernels' in-kernel
    `_bwd_di` per (batch row, head, source): from the stored out and o2,
    scale [0, 0.7]. fp32, atol 1e-6 of max|ref| (sum order only)."""
    rng = np.random.default_rng(21 + dual)
    b, s, h, d = 2, 64, 2, 40
    g, out, o2 = (rng.standard_normal((b, s, h, d)).astype(np.float32)
                  for _ in range(3))
    scale = np.array([0.0, 0.7], np.float32)
    got = flash_attention_delta_plain(
        _t(g), _t(out), _t(o2) if dual else None,
        _t(scale) if dual else None).numpy()
    nsrc = 2 if dual else 1
    assert got.shape == (b, h, nsrc, s) and got.dtype == np.float32
    want = np.stack([np.stack([np.stack([
        np.asarray(jfa._bwd_di(
            jnp.asarray(g[i, :, j]), jnp.asarray(out[i, :, j])[None],
            jnp.asarray(o2[i, :, j])[None] if dual else None,
            jnp.float32(scale[i] if dual else 0.0), src == 1, nsrc))[:, 0]
        for src in range(nsrc)]) for j in range(h)]) for i in range(b)])
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


# ---------------------------------------------------------------------------
# K2 / K4: GroupNorm(+temb)+SiLU+conv3x3
# ---------------------------------------------------------------------------


def _gn_conv_inputs(shape, with_add, seed):
    b, h, w, cin, co = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    gw = rng.standard_normal(cin).astype(np.float32)
    gb = rng.standard_normal(cin).astype(np.float32)
    wt = (rng.standard_normal((3, 3, cin, co)) * 0.05).astype(np.float32)
    cb = rng.standard_normal(co).astype(np.float32)
    t = rng.standard_normal((b, cin)).astype(np.float32) if with_add else None
    return x, gw, gb, t, wt, cb


def _port_gn_conv(x, gw, gb, t, wt, cb):
    return gn_silu_conv3x3(_t(x), _t(gw), _t(gb), _conv_w(wt), _t(cb),
                           num_groups=32, eps=1e-5,
                           add=None if t is None else _t(t)).numpy()


@pytest.mark.parametrize("with_add", [False, True])
@pytest.mark.parametrize("shape", [(2, 8, 32, 256, 256), (1, 20, 16, 384, 128),
                                   (2, 8, 32, 256, 512)])
def test_gn_conv_matches_pallas_interpret(with_add, shape):
    """K2 (`_kernel`) shapes of the JAX kernel test; fp32, atol 2e-4."""
    x, gw, gb, t, wt, cb = _gn_conv_inputs(shape, with_add, 0)
    want = jax.jit(functools.partial(
        jfgc._fused_call, num_groups=32, eps=1e-5, act="silu",
        interpret=True))(*map(lambda a: None if a is None else
                              jnp.asarray(a), (x, gw, gb, t, wt, cb)))
    np.testing.assert_allclose(_port_gn_conv(x, gw, gb, t, wt, cb),
                               np.asarray(want), atol=2e-4)


@pytest.mark.parametrize("shape,with_add", [((1, 64, 128, 128, 128), False),
                                            ((2, 64, 128, 128, 256), True)])
def test_gn_conv_matches_windowed_interpret(shape, with_add):
    """K4 (`_windowed_kernel`), the same function on the VAE-style shapes
    of the JAX kernel test; the port's one op covers it. fp32, atol 2e-4."""
    x, gw, gb, t, wt, cb = _gn_conv_inputs(shape, with_add, 4)
    want = jax.jit(functools.partial(
        jfgc._windowed_call, num_groups=32, eps=1e-5, act="silu",
        interpret=True))(*map(lambda a: None if a is None else
                              jnp.asarray(a), (x, gw, gb, t, wt, cb)))
    np.testing.assert_allclose(_port_gn_conv(x, gw, gb, t, wt, cb),
                               np.asarray(want), atol=2e-4)


def _full_width_gn_conv_shapes():
    """(b, h, w, cin, cout) of every GN+SiLU+conv3x3 of the full-width paths
    at 512x640 (`basic`, `pose`, `ipa_pose`, training) and 512x512
    (`inpaint`): the UNet's resnets (main and garment UNet; the ControlNet's
    trunk runs the down and mid ones) at the latent size, UNET_BATCHES, and
    the VAE's encoder and decoder resnets at VAE_BATCHES; each resnet's
    conv1 (cin -> cout) and conv2 (cout -> cout)."""
    u, v = UNetConfig(), VAEConfig()
    res = []  # (level, cin, cout) of each resnet
    ch, nl = u.block_out_channels, u.layers_per_block
    skips, cin = [ch[0]], ch[0]
    for lvl, co in enumerate(ch):
        for _ in range(nl):
            res.append((lvl, cin, co))
            cin = co
            skips.append(co)
        if lvl < len(ch) - 1:
            skips.append(co)
    res += [(len(ch) - 1, cin, cin)] * 2
    for lvl, co in reversed(list(enumerate(ch))):
        for _ in range(nl + 1):
            res.append((lvl, cin + skips.pop(), co))
            cin = co
    shapes = set()
    sizes = ((640, 512), (512, 512))
    for b in UNET_BATCHES:
        for (ih, iw), (lvl, ci, co) in itertools.product(sizes, res):
            h, w = (ih // 8) >> lvl, (iw // 8) >> lvl
            shapes |= {(b, h, w, ci, co), (b, h, w, co, co)}
    vres, cin = [], v.block_out_channels[0]
    for lvl, co in enumerate(v.block_out_channels):  # encoder, 640x512 down
        for _ in range(v.layers_per_block):
            vres.append((lvl, cin, co))
            cin = co
    vres += [(len(v.block_out_channels) - 1, cin, cin)] * 4  # two mids
    for lvl, co in reversed(list(enumerate(v.block_out_channels))):
        for _ in range(v.layers_per_block + 1):  # decoder, 80x64 up
            vres.append((lvl, cin, co))
            cin = co
    for b in VAE_BATCHES:
        for (ih, iw), (lvl, ci, co) in itertools.product(sizes, vres):
            h, w = ih >> lvl, iw >> lvl
            shapes |= {(b, h, w, ci, co), (b, h, w, co, co)}
    return sorted(shapes)


def test_conv_plan_keeps_the_kernel_limits():
    """The bf16 conv's plan for every GN+conv shape of the full-width paths:
    tiles the kernel has (128 pixels of power-of-two rows, TMA boxes of at
    most 256, an instantiated N width), K splits of 1 .. K steps in
    balanced ranges, shared memory within the 227 KB a block may use, and at
    least one block per SM where M <= 640 pixels."""
    shapes = _full_width_gn_conv_shapes()
    assert (2, 10, 8, 2560, 1280) in shapes and (1, 640, 512, 256, 128) \
        in shapes and (2, 80, 64, 960, 320) in shapes \
        and (2, 8, 8, 2560, 1280) in shapes and (1, 512, 512, 256, 128) \
        in shapes and (8, 80, 64, 320, 320) in shapes \
        and (4, 640, 512, 256, 128) in shapes
    for b, h, w, cin, co in shapes:
        p = fgc.conv_plan(b, h, w, cin, co)
        what = (b, h, w, cin, co, p)
        assert p.tw * p.th == fgc.BLOCK_PIXELS and p.tw & (p.tw - 1) == 0, \
            what
        assert max(p.tw, p.th, p.bn) <= 256 and p.bn in fgc.STAGES, what
        assert fgc.conv_smem_bytes(p.bn) <= fgc.SMEM_LIMIT, what
        assert p.ksteps == 9 * -(-cin // fgc.K_STEP_CHANNELS), what
        assert 1 <= p.splits <= min(p.ksteps, fgc.MAX_SPLITS), what
        steps = [(s + 1) * p.ksteps // p.splits - s * p.ksteps // p.splits
                 for s in range(p.splits)]
        assert sum(steps) == p.ksteps and max(steps) - min(steps) <= 1, what
        assert p.mtiles == b * -(-h // p.th) * -(-w // p.tw), what
        assert p.ntiles * p.bn >= co > (p.ntiles - 1) * p.bn, what
        if b * h * w <= 640:
            assert p.blocks >= fgc.SMS, what


def _full_width_group_norm_shapes():
    """(b, m, c, act) of every GroupNorm of the full-width paths at 512x640
    and 512x512 and of the VAE's encode and decode: K3 at each UNet level
    (transformer in-norms of the UNets and the ControlNet's trunk, act none;
    conv_norm_out, silu) at the UNET_BATCHES, and the GN+SiLU prologue of
    every GN+conv (K2, K4)."""
    u = UNetConfig()
    latents = ((80, 64), (64, 64))
    shapes = {(b, (lh >> lvl) * (lw >> lvl), ch, "none")
              for b in UNET_BATCHES for lh, lw in latents
              for lvl, ch in enumerate(u.block_out_channels)}
    shapes |= {(b, lh * lw, u.block_out_channels[0], "silu")
               for b in UNET_BATCHES for lh, lw in latents}
    shapes |= {(b, h * w, cin, "silu")
               for b, h, w, cin, _ in _full_width_gn_conv_shapes()}
    return sorted(shapes)


def test_gn_plan_keeps_the_kernel_limits():
    """The GroupNorm plan (K3, and the K2/K4 prologue) for every GroupNorm
    shape of the full-width paths, bf16 and fp32: resident slabs of whole
    groups, a multiple of 16 bytes wide and at least MIN_SEGMENT_BYTES, TMA
    boxes of at most 256 rows landing 128-byte aligned, every block with
    rows and every row in a block, clusters of at most 8 (no non-portable
    attribute), shared memory within the 227 KB a block may use; streaming
    exactly where no resident plan fits (the VAE's pixel levels), its
    clusters covering every row; the fp32 GN+conv's streaming statistics
    within the same limits."""
    shapes = _full_width_group_norm_shapes()
    assert (2, 5120, 320, "none") in shapes and (1, 327680, 256, "silu") \
        in shapes and (2, 80, 1280, "none") in shapes \
        and (2, 4096, 320, "none") in shapes and (2, 64, 1280, "none") \
        in shapes and (1, 262144, 128, "silu") in shapes \
        and (8, 5120, 320, "none") in shapes \
        and (4, 327680, 256, "silu") in shapes
    modes = {}
    for b, m, c, act in shapes:
        for dtype in (torch.bfloat16, torch.float32):
            item = dtype.itemsize
            p = fg.gn_plan(b, m, c, 32, dtype, act)
            what = (b, m, c, act, dtype, p)
            assert 1 <= p.cs <= fg.MAX_CLUSTER <= 8, what
            assert p.smem <= fg.SMEM_LIMIT, what
            fits = list(fg._resident_plans(b, m, c, 32, item, act))
            assert p.resident == bool(fits), what
            if p.resident:
                assert p.sw % (c // 32) == 0 and c % p.sw == 0, what
                assert p.sw * item % 16 == 0, what
                assert fg.MIN_SEGMENT_BYTES <= p.sw * item, what
                assert p.sw <= fg.MAX_SLAB and p.box_rows <= fg.BOX_ROWS, what
                assert p.box_rows * p.sw * item % 128 == 0, what
                assert 1 <= p.nboxes <= fg.MAX_BOXES, what
                assert (p.cs - 1) * p.rpb < m <= p.cs * p.rpb, what
                assert p.blocks == b * (c // p.sw) * p.cs, what
                assert p.smem == fg.resident_smem(p.rpb, p.sw, item), what
                assert p.workspace_floats(b, c) == 0, what
            else:
                assert p.nclusters * p.cs * p.rows_per_block >= m, what
                assert (p.nclusters - 1) * p.cs * p.rows_per_block < m, what
                assert p.workspace_floats(b, c) == \
                    2 * b * p.nclusters * c + 2 * b * c, what
            modes[(b, m, c, act, item)] = p.resident
            s = fg.stream_plan(b, m, c)  # the fp32 GN+conv's statistics
            assert not s.resident and s.smem <= fg.SMEM_LIMIT
            assert s.nclusters * s.cs * s.rows_per_block >= m
    # every bf16 UNet GroupNorm is one launch; the VAE's pixel levels stream
    assert all(modes[(b, m, c, a, i)] for b, m, c, a, i in modes
               if m <= 80 * 64 and c >= 320 and i == 2)
    assert not modes[(1, 327680, 256, "silu", 2)]
    assert not modes[(1, 327680, 128, "silu", 2)]


# ---------------------------------------------------------------------------
# K3: GroupNorm(+add)+act
# ---------------------------------------------------------------------------


@pytest.fixture
def gn_interpret():
    jfg.INTERPRET = True
    yield
    jfg.INTERPRET = False


@pytest.mark.parametrize("act", ["silu", "none"])
@pytest.mark.parametrize("with_add", [False, True])
def test_group_norm_matches_pallas_interpret(gn_interpret, act, with_add):
    """The JAX kernel test's shape; fp32, atol 2e-5 (JAX test: 5e-6 between
    its kernel and its own reference, which share XLA's sum order)."""
    rng = np.random.default_rng(0)
    b, h, w, c, g = 2, 8, 16, 320, 32
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    wt = rng.standard_normal(c).astype(np.float32)
    bs = rng.standard_normal(c).astype(np.float32)
    t = rng.standard_normal((b, c)).astype(np.float32) if with_add else None
    want = jax.jit(jfg.fused_group_norm_act, static_argnums=(4, 5, 6))(
        jnp.asarray(x), jnp.asarray(wt), jnp.asarray(bs),
        None if t is None else jnp.asarray(t), g, 1e-5, act)
    got = group_norm_act(_t(x), _t(wt), _t(bs), num_groups=g, eps=1e-5,
                         act=act, add=None if t is None else _t(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("with_add", [False, True])
def test_gn_conv_grads_match_jax(with_add):
    """K2's Function (kernel forward, recomputed reference backward) against
    jax.grad of JAX `fused_gn_silu_conv` (its custom VJP differentiates
    `_xla_reference`): every input's gradient, fp32, atol 1e-4."""
    x, gw, gb, t, wt, cb = _gn_conv_inputs((2, 8, 12, 64, 32), with_add, 5)
    g = np.random.default_rng(6).standard_normal((2, 8, 12, 32)).astype(
        np.float32)
    names = ["x", "gw", "gb", "w", "cb"] + (["add"] if with_add else [])

    def loss(x_, gw_, gb_, w_, cb_, *add):
        y = jfgc.fused_gn_silu_conv(x_, gw_, gb_, add[0] if add else None,
                                    w_, cb_, 32, 1e-5, "silu")
        return jnp.sum(y * g)

    jargs = [x, gw, gb, wt, cb] + ([t] if with_add else [])
    want = jax.jit(jax.grad(loss, argnums=tuple(range(len(jargs)))))(
        *map(jnp.asarray, jargs))
    tx, tgw, tgb, tcb = (_t(a).requires_grad_() for a in (x, gw, gb, cb))
    tw = _conv_w(wt).requires_grad_()
    tt = _t(t).requires_grad_() if with_add else None
    y = gn_silu_conv3x3(tx, tgw, tgb, tw, tcb, num_groups=32, eps=1e-5,
                        add=tt)
    assert type(y.grad_fn).__name__ == "GnSiluConv3x3FunctionBackward"
    leaves = [tx, tgw, tgb, tw, tcb] + ([tt] if with_add else [])
    got = torch.autograd.grad(y, leaves, _t(g))
    got = [a.numpy() for a in got]
    got[3] = got[3].transpose(2, 3, 1, 0)  # OIHW -> HWIO
    for name, a, b in zip(names, got, want):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-4, err_msg=name)


@pytest.mark.parametrize("act,with_add", [("none", False), ("silu", True)])
def test_group_norm_grads_match_jax(act, with_add):
    """K3's Function against jax.grad of JAX `fused_group_norm_act`, fp32,
    atol 2e-5."""
    rng = np.random.default_rng(9)
    b, h, w, c = 2, 8, 16, 64
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    wt, bs = (rng.standard_normal(c).astype(np.float32) for _ in range(2))
    t = rng.standard_normal((b, c)).astype(np.float32) if with_add else None
    g = rng.standard_normal((b, h, w, c)).astype(np.float32)

    def loss(x_, w_, b_, *add):
        y = jfg.fused_group_norm_act(x_, w_, b_, add[0] if add else None, 32,
                                     1e-5, act)
        return jnp.sum(y * g)

    jargs = [x, wt, bs] + ([t] if with_add else [])
    want = jax.jit(jax.grad(loss, argnums=tuple(range(len(jargs)))))(
        *map(jnp.asarray, jargs))
    leaves = [_t(a).requires_grad_() for a in jargs]
    y = group_norm_act(*leaves[:3], num_groups=32, eps=1e-5, act=act,
                       add=leaves[3] if with_add else None)
    assert type(y.grad_fn).__name__ == "GroupNormActFunctionBackward"
    got = torch.autograd.grad(y, leaves, _t(g))
    for i, (a, b_) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), atol=2e-5,
                                   err_msg=f"grad {i}")


def test_wrappers_skip_the_function_without_grad():
    """Inference keeps the forward kernels alone: no grad_fn without grad."""
    x = torch.randn(1, 4, 4, 32, requires_grad=True)
    w, b = torch.ones(32), torch.zeros(32)
    with torch.no_grad():
        assert group_norm_act(x, w, b, num_groups=8, eps=1e-5).grad_fn is None
        q = torch.randn(1, 16, 1, 8, requires_grad=True)
        assert flash_attention(q, q, q).grad_fn is None


def test_wrappers_reject_unknown_device():
    """A wrapper runs the plain version for CPU tensors only; any other
    device is refused, never silently computed elsewhere."""
    x = torch.empty((1, 4, 4, 32), device="meta")
    with pytest.raises(ValueError, match="device"):
        group_norm_act(x, torch.empty(32, device="meta"),
                       torch.empty(32, device="meta"), num_groups=8, eps=1e-5)
    q = torch.empty((1, 16, 1, 8), device="meta")
    with pytest.raises(ValueError, match="device"):
        flash_attention(q, q, q)
