"""The port's preprocessing against the JAX package and OpenCV, on the CPU.

The resamplers (`ops/resize.py`) against `jax.image.resize` and
`cv2.resize`; the raster, filter and morphology helpers
(`preprocess/imgproc.py`) against the OpenCV calls they replace; the
OpenPose host assembly and `draw_bodypose` against the JAX package's; the
inpaint mask (`preprocess/mask.py`) against JAX's `get_mask_location` and
`person_upper_body_mask` (OpenPose and the parser stubbed in both packages
by the same keypoints and parse). cv2 is used here only, never in the port.
Inputs are made with numpy from a seed.
"""

import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from scipy import ndimage

from imagdressing_tpu.preprocess import mask as jmask
from imagdressing_tpu.preprocess.openpose import draw as jdraw
from imagdressing_tpu.preprocess.openpose import infer as jinfer
from imagdressing_tpu_torch.ops import resize as rs
from imagdressing_tpu_torch.preprocess import imgproc as ip
from imagdressing_tpu_torch.preprocess import mask as pmask
from imagdressing_tpu_torch.preprocess.openpose import draw as pdraw
from imagdressing_tpu_torch.preprocess.openpose import infer as pinfer
from test_preprocess import _synthetic_keypoints, _synthetic_parse

# the largest component: the port fills its full border, the JAX package
# OpenCV's TC89_L1 approximation of it, so the masks differ along the
# border only (measured over the cases below: 0.59-0.74 % of the mask's
# pixels, every one within 6.1 px of JAX's border; lower_body equal)
MASK_SHARE, MASK_BAND = 0.01, 8.0


# ---------------------------------------------------------------------------
# Resamplers
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("hw_in,hw_out", [((5, 7), (40, 56)),
                                          ((23, 18), (184, 144)),
                                          ((40, 56), (13, 9)),
                                          ((64, 48), (31, 50))])
def test_jax_resize_matches_jax(hw_in, hw_out):
    """Up, down and mixed, on N(0, 1): within 1e-5 (fp32 sums)."""
    x = np.random.default_rng(0).standard_normal(
        (1,) + hw_in + (3,)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1,) + hw_out + (3,),
                                       "bicubic"))
    got = rs.jax_resize(torch.from_numpy(x), *hw_out).numpy()
    assert np.abs(got - want).max() <= 1e-5


@pytest.mark.parametrize("hw_in,hw_out", [((512, 384), (184, 138)),
                                          ((50, 40), (64, 64)),
                                          ((60, 60), (184, 184))])
def test_cv2_resizes_match_cv2(hw_in, hw_out):
    """INTER_CUBIC on float32 in [0, 255] within 4e-5 of the range (OpenCV
    sums in float32), on uint8 within 1 level at under 0.2 % of the pixels;
    INTER_NEAREST exactly."""
    rng = np.random.default_rng(1)
    h, w = hw_out
    x = rng.uniform(0, 255, hw_in + (3,)).astype(np.float32)
    got = rs.cv2_resize_cubic(torch.from_numpy(x), w, h).numpy()
    want = cv2.resize(x, (w, h), interpolation=cv2.INTER_CUBIC)
    assert np.abs(got - want).max() <= 4e-5 * 255
    xu = rng.integers(0, 256, hw_in + (3,), dtype=np.uint8)
    got = rs.cv2_resize_cubic(torch.from_numpy(xu), w, h).numpy()
    want = cv2.resize(xu, (w, h), interpolation=cv2.INTER_CUBIC)
    diff = np.abs(got.astype(int) - want)
    assert got.dtype == np.uint8 and diff.max() <= 1
    assert (diff > 0).mean() < 2e-3
    labels = rng.integers(0, 19, hw_in, dtype=np.uint8)
    np.testing.assert_array_equal(
        rs.cv2_resize_nearest(labels, w, h),
        cv2.resize(labels, (w, h), interpolation=cv2.INTER_NEAREST))


# ---------------------------------------------------------------------------
# OpenCV's drawing, filters and morphology
# ---------------------------------------------------------------------------


def test_drawing_matches_cv2():
    """Lines, filled convex polygons (whole and 16.16 sub-pixel vertices),
    filled circles, ellipse2Poly and convex hulls, in and beyond the
    canvas: pixel for pixel. Thick polylines inside the canvas too."""
    rng = np.random.default_rng(2)
    h, w = 64, 48
    for _ in range(150):
        c = tuple(int(v) for v in rng.integers(-10, 70, 2))
        axes = (int(rng.integers(0, 40)), int(rng.integers(0, 8)))
        angle = int(rng.integers(-180, 360))
        poly = cv2.ellipse2Poly(c, axes, angle, 0, 360, 1)
        np.testing.assert_array_equal(ip.ellipse2poly(c, axes, angle), poly)
        a, b = np.zeros((h, w, 3), np.uint8), np.zeros((h, w, 3), np.uint8)
        cv2.fillConvexPoly(a, poly, (255, 10, 3))
        ip.fill_convex_poly(b, poly, (255, 10, 3))
        np.testing.assert_array_equal(a, b)
        fixed = cv2.convexHull(rng.integers(-5 << 16, 45 << 16, (4, 2)).astype(
            np.int32)).reshape(-1, 2)
        a, b = np.zeros((h, w), np.uint8), np.zeros((h, w), np.uint8)
        cv2.fillConvexPoly(a, fixed, 1, cv2.LINE_8, 16)
        ip.fill_convex_poly(b, fixed, 1, 16)
        np.testing.assert_array_equal(a, b)
        r = int(rng.integers(0, 30))
        a, b = np.zeros((h, w), np.uint8), np.zeros((h, w), np.uint8)
        cv2.circle(a, c, r, 255, -1)
        ip.circle(b, c, r, 255)
        np.testing.assert_array_equal(a, b)
        p, q = (tuple(int(v) for v in rng.integers(-30, 90, 2))
                for _ in range(2))
        a, b = np.zeros((h, w), np.uint8), np.zeros((h, w), np.uint8)
        cv2.line(a, p, q, 255)
        ip.line(b, p, q, 255)
        np.testing.assert_array_equal(a, b)
        pts = rng.integers(0, 48, (10, 2))
        a, b = np.zeros((h, w), np.float32), np.zeros((h, w), np.float32)
        cv2.fillConvexPoly(a, cv2.convexHull(pts.astype(np.int32)), 1.0)
        ip.fill_convex_poly(b, ip.convex_hull(pts), 1.0)
        np.testing.assert_array_equal(a, b)
        pts = np.stack([rng.integers(0, w, 3), rng.integers(0, h, 3)], 1)
        lw = int(rng.integers(2, 20))
        a, b = np.zeros((h, w), np.uint8), np.zeros((h, w), np.uint8)
        cv2.polylines(a, [pts.astype(np.int32)], False, 255, lw, cv2.LINE_8)
        ip.polylines(b, pts, 255, lw)
        np.testing.assert_array_equal(a, b)


def test_thick_lines_beyond_the_canvas_differ_on_outline_pixels():
    """A known difference (ROADMAP Queue 3): where a thick line's ends lie
    beyond the canvas, OpenCV's quad outline steps differently from the
    port's `polylines` (its composition of fillConvexPoly and circles), so
    the rasters differ along OpenCV's edge: measured at most 80 pixels of a
    draw, 0.38 % of all pixels over these draws, every one within 2 px of
    OpenCV's edge."""
    rng = np.random.default_rng(3)
    h, w = 64, 48
    diff = total = 0
    for _ in range(150):
        pts = rng.integers(-20, 80, (3, 2)).astype(np.int32)
        lw = int(rng.integers(2, 20))
        a, b = np.zeros((h, w), np.uint8), np.zeros((h, w), np.uint8)
        cv2.polylines(a, [pts], False, 255, lw, cv2.LINE_8)
        ip.polylines(b, pts, 255, lw)
        d = a != b
        assert d.sum() <= 100
        diff, total = diff + d.sum(), total + a.size
        if d.any():
            edge = (a > 0) ^ ndimage.binary_erosion(a > 0)
            assert ndimage.distance_transform_edt(~edge)[d].max() <= 2.0
    assert diff / total < 0.01


def test_filters_and_morphology_match_cv2():
    """GaussianBlur (8-bit: exactly; float: 1e-6), erode and dilate
    (exactly), pyrDown / pyrUp (1e-6, odd and even sizes) and warpAffine
    INTER_LINEAR + BORDER_REFLECT (1e-5)."""
    rng = np.random.default_rng(4)
    x = rng.integers(0, 256, (60, 50, 3), dtype=np.uint8)
    np.testing.assert_array_equal(ip.gaussian_blur_u8(x, 0.8),
                                  cv2.GaussianBlur(x, (0, 0), 0.8))
    f = rng.random((60, 50)).astype(np.float32)
    assert np.abs(ip.gaussian_blur(f, 13, 2.1)
                  - cv2.GaussianBlur(f, (13, 13), 2.1)).max() <= 1e-6
    for k in (1, 4, 5):
        np.testing.assert_array_equal(
            ip.erode_box(f, k), cv2.erode(f, np.ones((k, k), np.float32)))
    m = (rng.random((60, 50)) > 0.97).astype(np.float32)
    np.testing.assert_array_equal(
        ip.dilate5(m, 3),
        cv2.dilate(m, np.ones((5, 5), np.uint16), iterations=3) > 0)
    for shape in [(60, 50, 3), (61, 47, 3), (7, 5), (2, 3)]:
        f = rng.random(shape).astype(np.float32)
        down = cv2.pyrDown(f)
        assert np.abs(ip.pyr_down(f) - down).max() <= 1e-6
        assert np.abs(ip.pyr_up(down, shape[1::-1])
                      - cv2.pyrUp(down, dstsize=shape[1::-1])).max() <= 1e-6
    img = rng.random((50, 40, 3)).astype(np.float32)
    mat = cv2.getRotationMatrix2D((20, 25), 17, 1.3).astype(np.float32)
    want = cv2.warpAffine(img, mat, (45, 55), flags=cv2.INTER_LINEAR,
                          borderMode=cv2.BORDER_REFLECT)
    assert np.abs(ip.warp_affine_reflect(img, mat, 45, 55) - want).max() \
        <= 1e-5


# ---------------------------------------------------------------------------
# OpenPose host assembly and rendering
# ---------------------------------------------------------------------------


def person_maps(h=96, w=72, people=2, seed=5):
    """Synthetic heat / PAF maps of `people` stick figures: a Gaussian
    blob per joint and a unit PAF band along each limb."""
    rng = np.random.default_rng(seed)
    heat = np.zeros((h, w, 19))
    paf = np.zeros((h, w, 38))
    yy, xx = np.mgrid[0:h, 0:w]
    for p in range(people):
        joints = np.stack([rng.uniform(6, w - 6, 18),
                           rng.uniform(6, h - 6, 18)], 1)
        joints[:, 0] = joints[:, 0] / people + p * w / people
        for j, (x, y) in enumerate(joints):
            heat[:, :, j] = np.maximum(heat[:, :, j], np.exp(
                -((yy - y) ** 2 + (xx - x) ** 2) / (2 * 3.0 ** 2)))
        for (a, b), (ca, cb) in zip(jinfer.LIMB_SEQ, jinfer.MAP_IDX):
            pa, pb = joints[a - 1], joints[b - 1]
            v = pb - pa
            n = np.hypot(*v)
            u = v / max(n, 1e-3)
            t = ((xx - pa[0]) * u[0] + (yy - pa[1]) * u[1])
            d = np.abs((xx - pa[0]) * u[1] - (yy - pa[1]) * u[0])
            band = (t >= 0) & (t <= n) & (d <= 2)
            paf[band, ca - 19] = u[0]
            paf[band, cb - 19] = u[1]
    return heat, paf


@pytest.mark.parametrize("maps", ["jax_synthetic", "two_people"])
def test_find_peaks_and_assemble_match_jax(maps):
    """`_find_peaks` and `_assemble` on the JAX test's two-joint maps and
    on two synthetic stick figures: exactly equal."""
    if maps == "jax_synthetic":
        h, w = 64, 48
        heat = np.zeros((h, w, 19))
        paf = np.zeros((h, w, 38))
        yy, xx = np.mgrid[0:h, 0:w]
        heat[:, :, 1] = np.exp(-((yy - 16) ** 2 + (xx - 24) ** 2) / 32.0)
        heat[:, :, 2] = np.exp(-((yy - 40) ** 2 + (xx - 24) ** 2) / 32.0)
        paf[16:41, 20:29, 32 - 19] = 1.0
    else:
        heat, paf = person_maps()
        h = heat.shape[0]
    want = jinfer._find_peaks(heat, 0.1)
    got = pinfer._find_peaks(heat, 0.1)
    assert got == want
    wc, wp = jinfer._assemble(want, paf, h, 0.05)
    gc, gp = pinfer._assemble(got, paf, h, 0.05)
    np.testing.assert_array_equal(gc, wc)
    np.testing.assert_array_equal(gp, wp)
    if maps == "two_people":
        assert len(gp) >= 1


@pytest.mark.parametrize("case", ["synthetic", "random", "scaled"])
def test_draw_bodypose_matches_jax(case):
    """The stick render, pixel for pixel: the JAX test's keypoints, random
    keypoints with missing joints and some near or past the edges, and a
    render at another size than the keypoints' space."""
    rng = np.random.default_rng(6)
    kps = np.asarray(_synthetic_keypoints()["pose_keypoints_2d"])
    h, w, src = 512, 384, None
    if case == "random":
        kps = np.stack([rng.uniform(-10, 394, 18), rng.uniform(-10, 522, 18)],
                       1)
        kps[rng.random(18) < 0.2] = 0.0
    if case == "scaled":
        h, w, src = 640, 512, (384, 512)
    np.testing.assert_array_equal(
        pdraw.draw_bodypose(kps, h, w, src_size=src),
        jdraw.draw_bodypose(kps, h, w, src_size=src))


# ---------------------------------------------------------------------------
# The inpaint mask
# ---------------------------------------------------------------------------


def two_components():
    parse = _synthetic_parse()
    parse[400:470, 20:80] = 4  # a second garment blob apart from the body
    return parse


def assert_masks_close(got, want):
    """Equal but along JAX's border: a share of the mask's pixels and a
    band around its border."""
    assert got.shape == want.shape and got.dtype == want.dtype
    diff = got != want
    if not diff.any():
        return
    assert diff.sum() <= MASK_SHARE * (want > 0).sum()
    inside = want > 0
    border = inside ^ ndimage.binary_erosion(inside)
    assert ndimage.distance_transform_edt(~border)[diff].max() <= MASK_BAND


@pytest.mark.parametrize("parse", ["synthetic", "two_components"])
@pytest.mark.parametrize("category", ["upper_body", "dresses", "lower_body"])
@pytest.mark.parametrize("model_type", ["hd", "dc"])
def test_get_mask_location_matches_jax(parse, category, model_type):
    """Every category and arm width on the JAX test's parse and keypoints
    and on a parse with a second component (which the largest-component
    step drops)."""
    pm = _synthetic_parse() if parse == "synthetic" else two_components()
    kps = _synthetic_keypoints()
    want, want_gray = jmask.get_mask_location(model_type, category, pm, kps)
    got, got_gray = pmask.get_mask_location(model_type, category, pm, kps)
    assert_masks_close(got, want)
    np.testing.assert_array_equal(got_gray, (got > 0) * np.uint8(127))
    assert set(np.unique(got)) <= {0, 255}
    if parse == "two_components":
        assert (got[400:470, 20:80] == 0).all()
    if category == "lower_body":  # no arm band: only the contour step
        np.testing.assert_array_equal(got, want)


def test_get_mask_location_refuses_what_jax_refuses():
    pm, kps = _synthetic_parse(), _synthetic_keypoints()
    with pytest.raises(ValueError):
        pmask.get_mask_location("bad", "upper_body", pm, kps)
    with pytest.raises(NotImplementedError):
        pmask.get_mask_location("hd", "shoes", pm, kps)


def test_make_inpaint_condition_matches_jax():
    rng = np.random.default_rng(7)
    person = rng.random((64, 48, 3)).astype(np.float32)
    mask = (rng.random((64, 48)) > 0.6).astype(np.float32)
    want = jmask.make_inpaint_condition(person, mask)
    got = pmask.make_inpaint_condition(person, mask)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_person_upper_body_mask_matches_jax(monkeypatch, tmp_path):
    """The whole person path with OpenPose and the parser stubbed in both
    packages by the same keypoints and parse: the keypoint net sees the
    photo resized to 384x512 (PIL's bicubic in JAX, within 1 level), the
    parser the photo itself, and the (1, 512, 512, 1) masks agree as
    `get_mask_location`'s do."""
    import imagdressing_tpu.preprocess.openpose as jop_pkg
    import imagdressing_tpu.preprocess.parsing as jparse_pkg
    from imagdressing_tpu_torch.preprocess.openpose import OpenPose
    from imagdressing_tpu_torch.preprocess.parsing.infer import Parsing

    rng = np.random.default_rng(8)
    photo = rng.integers(0, 256, (600, 460, 3), dtype=np.uint8)
    path = os.path.join(tmp_path, "person.png")
    Image.fromarray(photo).save(path)
    parse = cv2.resize(_synthetic_parse(), (460, 600),
                       interpolation=cv2.INTER_NEAREST)
    kps = _synthetic_keypoints()
    seen = {}

    def stubs(tag):
        def pose(img):
            seen[tag + "_pose"] = img
            return kps

        def parser(img):
            seen[tag + "_parse"] = img
            return parse, (parse == 11).astype(np.float32)

        return pose, parser

    jpose, jparser = stubs("jax")
    monkeypatch.setattr(jop_pkg.OpenPose, "get_default",
                        classmethod(lambda cls: jpose))
    monkeypatch.setattr(jparse_pkg.Parsing, "get_default",
                        classmethod(lambda cls: jparser))
    ppose, pparser = stubs("port")
    monkeypatch.setattr(OpenPose, "get_default",
                        classmethod(lambda cls, device="cuda": ppose))
    monkeypatch.setattr(Parsing, "get_default",
                        classmethod(lambda cls, device="cuda": pparser))
    want = jmask.person_upper_body_mask(path, 512, 512)
    stages = {}
    got = pmask.person_upper_body_mask(path, 512, 512, device="cpu",
                                       stage_seconds=stages)
    assert set(stages) == {"openpose", "parse", "mask"}
    assert seen["port_pose"].shape == (512, 384, 3)
    assert np.abs(seen["port_pose"].astype(int)
                  - seen["jax_pose"]).max() <= 1
    np.testing.assert_array_equal(seen["port_parse"], seen["jax_parse"])
    assert got.shape == (1, 512, 512, 1) and got.dtype == np.float32
    assert_masks_close(got[0, ..., 0], want[0, ..., 0])
