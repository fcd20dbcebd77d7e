"""The port's `ops/deform_conv.deform_conv2d` (DCN v1/v2) against the JAX
package's op and against detectron2's bilinear rule.

The two packages differ in a one-pixel band around the input: a sample
point with -1 < y < 0 or H-1 < y < H (likewise in x) is clamped to the
border pixel at full weight by the JAX op, and weighed by its distance with
the outside corner read as zero by detectron2's `deformable_im2col_bilinear`
(which the port follows). So the comparisons with JAX move every sample out
of that band; the detectron2 test puts samples in it. Inputs are numpy from
a seed; fp32 on the CPU. Tolerances: forward atol 1e-5, gradients
1e-4 * max|jax.grad|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from imagdressing_tpu.ops.deform_conv import deform_conv2d as jax_deform
from imagdressing_tpu_torch.ops.deform_conv import deform_conv2d

# (batch, H, W, C, O, k, stride, padding, dilation, with mask and bias)
CONFIGS = [(2, 7, 6, 3, 4, 3, 1, 1, 1, False),
           (2, 7, 6, 3, 4, 3, 1, 1, 1, True),
           (1, 9, 8, 4, 5, 3, 2, 1, 1, True),
           (2, 8, 7, 3, 4, 3, 1, 2, 2, True)]


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _inputs(cfg, seed, spread=2.0):
    b, h, w, c, o, k, s, p, d, modulated = cfg
    rng = np.random.default_rng(seed)
    ho = (h + 2 * p - d * (k - 1) - 1) // s + 1
    wo = (w + 2 * p - d * (k - 1) - 1) // s + 1
    f32 = np.float32
    x = rng.standard_normal((b, h, w, c)).astype(f32)
    off = rng.uniform(-spread, spread, (b, ho, wo, 2 * k * k)).astype(f32)
    weight = (0.2 * rng.standard_normal((k, k, c, o))).astype(f32)
    bias = rng.standard_normal(o).astype(f32) if modulated else None
    mask = rng.uniform(0, 1, (b, ho, wo, k * k)).astype(f32) \
        if modulated else None
    return x, off, weight, bias, mask, (ho, wo)


def _sample_points(off, ho, wo, k, s, p, d):
    """(B, Ho, Wo, K) sample rows and columns of `off`."""
    taps = np.arange(k * k)
    by = (np.arange(ho) * s - p)[:, None, None] + (taps // k) * d
    bx = (np.arange(wo) * s - p)[None, :, None] + (taps % k) * d
    o = off.reshape(*off.shape[:3], k * k, 2)
    return by + o[..., 0], bx + o[..., 1]


def _out_of_band(cfg, off, hw):
    """`off` with each sample in [-1, 0) or [H-1, H] (and likewise in x)
    moved 1.25 px outward, where both rules read zero; the closed end at
    H-1 keeps JAX's clamped gradient (zero there) out too."""
    b, h, w, c, o, k, s, p, d, _ = cfg
    py, px = _sample_points(off, *hw, k, s, p, d)
    o5 = off.reshape(*off.shape[:3], k * k, 2).copy()
    for axis, pos, n in ((0, py, h), (1, px, w)):
        low = (pos >= -1) & (pos < 0)
        high = (pos >= n - 1) & (pos <= n)
        o5[..., axis] += np.where(low, -1.25, 0) + np.where(high, 1.25, 0)
    return o5.reshape(off.shape).astype(np.float32)


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def test_deform_conv2d_matches_jax_off_the_border_band():
    """Forward at stride 1 and 2 and dilation 2, with and without the DCNv2
    mask and a bias; atol 1e-5."""
    for i, cfg in enumerate(CONFIGS):
        x, off, weight, bias, mask, hw = _inputs(cfg, i)
        off = _out_of_band(cfg, off, hw)
        s, p, d = cfg[6:9]
        want = jax_deform(_j(x), _j(off), _j(weight), _j(bias), _j(mask),
                          stride=s, padding=p, dilation=d)
        got = deform_conv2d(_t(x), _t(off), _t(weight), _t(bias), _t(mask),
                            stride=s, padding=p, dilation=d)
        assert got.shape == want.shape, cfg
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   err_msg=str(cfg))


def test_deform_conv2d_grads_match_jax():
    """d(sum(out * G)) with respect to x, offsets, weight and mask against
    `jax.grad`, within 1e-4 * max|jax.grad| each."""
    for i, cfg in enumerate(CONFIGS[1:]):
        x, off, weight, bias, mask, hw = _inputs(cfg, 10 + i)
        off = _out_of_band(cfg, off, hw)
        s, p, d = cfg[6:9]
        g = np.random.default_rng(20 + i).standard_normal(
            (x.shape[0], *hw, weight.shape[-1])).astype(np.float32)

        def jloss(x_, off_, w_, m_):
            out = jax_deform(x_, off_, w_, _j(bias), m_, stride=s,
                             padding=p, dilation=d)
            return jnp.sum(out * g)

        want = jax.grad(jloss, argnums=(0, 1, 2, 3))(
            _j(x), _j(off), _j(weight), _j(mask))
        leaves = [_t(a).requires_grad_() for a in (x, off, weight, mask)]
        out = deform_conv2d(leaves[0], leaves[1], leaves[2], _t(bias),
                            leaves[3], stride=s, padding=p, dilation=d)
        (out * _t(g)).sum().backward()
        for name, leaf, ref in zip(("x", "offsets", "weight", "mask"),
                                   leaves, want):
            ref = np.asarray(ref)
            tol = 1e-4 * float(np.abs(ref).max())
            np.testing.assert_allclose(leaf.grad.numpy(), ref, atol=tol,
                                       rtol=0, err_msg=f"{cfg} d{name}")


def _detectron2_bilinear(img, y, x):
    """detectron2's `dmcn_im2col_bilinear` on one (H, W, C) image: each
    corner outside the image reads zero."""
    h, w, _ = img.shape
    y0, x0 = int(np.floor(y)), int(np.floor(x))
    ly, lx = y - y0, x - x0
    val = np.zeros(img.shape[-1])
    for yi, wy in ((y0, 1 - ly), (y0 + 1, ly)):
        for xi, wx in ((x0, 1 - lx), (x0 + 1, lx)):
            if 0 <= yi <= h - 1 and 0 <= xi <= w - 1:
                val += wy * wx * img[yi, xi]
    return val


def _detectron2_deform_conv(x, off, weight, bias, mask, s, p, d):
    """detectron2's modulated_deformable_im2col + GEMM, in float64 loops:
    a sample is read only where -1 < y < H and -1 < x < W."""
    b, h, w, c = x.shape
    k = weight.shape[0]
    ho, wo = off.shape[1:3]
    col = np.zeros((b, ho, wo, k * k, c))
    for n in range(b):
        for i in range(ho):
            for j in range(wo):
                for t in range(k * k):
                    y = i * s - p + (t // k) * d + float(off[n, i, j, 2 * t])
                    xx = j * s - p + (t % k) * d \
                        + float(off[n, i, j, 2 * t + 1])
                    if -1 < y < h and -1 < xx < w:
                        m = 1.0 if mask is None else float(mask[n, i, j, t])
                        col[n, i, j, t] = m * _detectron2_bilinear(
                            x[n].astype(np.float64), y, xx)
    out = col.reshape(b, ho, wo, -1) @ weight.reshape(-1, weight.shape[-1])
    return out + (0.0 if bias is None else bias)


def test_deform_conv2d_follows_detectron2_border_rule():
    """(a) A 1x1 kernel on a 4x4 ramp: dy = -0.5 at row 0 reads half of
    x[0, 2] (detectron2: 1.0; JAX clamps to the border pixel: 2.0), and
    dy = +0.5 at row 3 half of x[3, 2] (7.0 against JAX's 14.0); the
    gradient with respect to that dy is the pixel's value (JAX: 0).
    (b) Seeded offsets with many samples in the band against a numpy
    transcription of detectron2's rule, atol 1e-5. (c) Zero offsets give
    `F.conv2d`."""
    ramp = np.arange(16, dtype=np.float32).reshape(1, 4, 4, 1)
    off = np.zeros((1, 4, 4, 2), np.float32)
    off[0, 0, 2, 0], off[0, 3, 2, 0] = -0.5, 0.5
    one = np.ones((1, 1, 1, 1), np.float32)
    off_t = _t(off).requires_grad_()
    got = deform_conv2d(_t(ramp), off_t, _t(one), padding=0)
    jax_got = np.asarray(jax_deform(_j(ramp), _j(off), _j(one), padding=0))
    assert (got[0, 0, 2, 0].item(), got[0, 3, 2, 0].item()) == (1.0, 7.0)
    assert (jax_got[0, 0, 2, 0], jax_got[0, 3, 2, 0]) == (2.0, 14.0)
    got[0, 0, 2, 0].backward()
    assert off_t.grad[0, 0, 2, 0].item() == 2.0
    jax_dy = jax.grad(lambda o: jax_deform(_j(ramp), o, _j(one),
                                           padding=0)[0, 0, 2, 0])(_j(off))
    assert float(jax_dy[0, 0, 2, 0]) == 0.0

    band = 0
    for i, cfg in enumerate(CONFIGS):
        x, off, weight, bias, mask, hw = _inputs(cfg, 30 + i, spread=1.5)
        s, p, d = cfg[6:9]
        py, px = _sample_points(off, *hw, cfg[5], s, p, d)
        h, w = cfg[1:3]
        band += int((((py > -1) & (py < 0)) | ((py > h - 1) & (py < h))
                     | ((px > -1) & (px < 0))
                     | ((px > w - 1) & (px < w))).sum())
        want = _detectron2_deform_conv(x, off, weight, bias, mask, s, p, d)
        got = deform_conv2d(_t(x), _t(off), _t(weight), _t(bias), _t(mask),
                            stride=s, padding=p, dilation=d)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5,
                                   err_msg=str(cfg))
    assert band >= 100, band

    x, off, weight, bias, _, _ = _inputs(CONFIGS[2], 40)
    got = deform_conv2d(_t(x), torch.zeros_like(_t(off)), _t(weight),
                        _t(bias), stride=2, padding=1)
    want = F.conv2d(_t(x).permute(0, 3, 1, 2),
                    _t(weight).permute(3, 2, 0, 1), _t(bias), stride=2,
                    padding=1).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
