"""The port's face fusion (`postprocess/face_fusion.py`) against the JAX
package's cv2-based one, on the CPU: each step on the same seeded inputs
(floats within 2e-3, uint8 within 1 level), the `FaceFusion` rules, the
server hook with a base64 face, and `openpose_landmark_fn` over the port's
`Face` against JAX's over the same weights.
"""

import base64
import io

import numpy as np
import pytest
from PIL import Image

from imagdressing_tpu.postprocess import face_fusion as jff
from imagdressing_tpu.preprocess.openpose import face as jface
from imagdressing_tpu_torch.convert import openpose_params_from_jax
from imagdressing_tpu_torch.postprocess import face_fusion as pff
from imagdressing_tpu_torch.preprocess.openpose import face as pface
from test_torch_openpose import GOLDEN as OPENPOSE_GOLDEN
from test_torch_openpose import hand_layers, numpy_tree

FLOAT_TOL = 2e-3


def landmarks(cx, cy, r, n=12, seed=0):
    """n points on a jittered ellipse around (cx, cy)."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 2 * np.pi, n, endpoint=False)
    pts = np.stack([cx + r * np.cos(t), cy + 1.2 * r * np.sin(t)], 1)
    return (pts + rng.normal(0, 1.0, pts.shape)).astype(np.float32)


def images(seed=1, h=72, w=64):
    """A template and a user photo in [0, 1]: smooth fields plus noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] / np.array([h, w])[:, None, None]
    tpl = np.stack([0.3 + 0.4 * yy, 0.5 + 0.2 * np.sin(6 * xx),
                    0.2 + 0.5 * xx * yy], -1)
    usr = np.stack([0.7 - 0.3 * xx, 0.4 + 0.3 * yy, 0.6 + 0.2 * np.cos(
        5 * yy)], -1)
    noise = rng.normal(0, 0.03, (2, h, w, 3))
    return [np.clip(a + n, 0, 1).astype(np.float32)
            for a, n in zip((tpl, usr), noise)]


def test_umeyama_matches_jax():
    src, dst = landmarks(30, 30, 10, seed=2), landmarks(35, 28, 14, seed=3)
    np.testing.assert_allclose(pff.umeyama(src, dst), jff.umeyama(src, dst),
                               atol=1e-6)
    pts = np.zeros((4, 2), np.float32)
    np.testing.assert_array_equal(pff.umeyama(pts, pts + 3),
                                  jff.umeyama(pts, pts + 3))


@pytest.mark.parametrize("feather", [0.12, 0.3])
def test_hull_mask_matches_jax(feather):
    lm = landmarks(30, 36, 12, seed=4)
    got = pff.hull_mask((72, 64, 3), lm, feather=feather)
    want = jff.hull_mask((72, 64, 3), lm, feather=feather)
    assert got.dtype == want.dtype
    assert np.abs(got - want).max() <= FLOAT_TOL
    one = np.full((3, 2), 7.0, np.float32)  # zero span: the bare hull
    np.testing.assert_array_equal(pff.hull_mask((16, 16), one),
                                  jff.hull_mask((16, 16), one))


def test_color_transfer_and_pyramid_blend_match_jax():
    tpl, usr = images()
    mask = jff.hull_mask(tpl.shape, landmarks(32, 36, 14, seed=5))
    assert np.abs(pff.color_transfer(usr, tpl, mask)
                  - jff.color_transfer(usr, tpl, mask)).max() <= FLOAT_TOL
    for levels in (1, 3, 4):
        got = pff.pyramid_blend(usr, tpl, mask, levels)
        want = jff.pyramid_blend(usr, tpl, mask, levels)
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= FLOAT_TOL
    # an odd-sized frame (pyrUp to 2n - 1)
    tpl, usr = images(6, 37, 29)
    mask = jff.hull_mask(tpl.shape, landmarks(14, 18, 8, seed=7))
    assert np.abs(pff.pyramid_blend(usr, tpl, mask)
                  - jff.pyramid_blend(usr, tpl, mask)).max() <= FLOAT_TOL


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_fuse_face_matches_jax(dtype):
    tpl, usr = images(8)
    lm_t, lm_u = landmarks(32, 36, 12, seed=9), landmarks(28, 30, 10,
                                                          seed=10)
    if dtype == "uint8":
        tpl = (tpl * 255).astype(np.uint8)
        usr = (usr * 255).astype(np.uint8)
    got = pff.fuse_face(tpl, usr, lm_t, lm_u)
    want = jff.fuse_face(tpl, usr, lm_t, lm_u)
    assert got.dtype == want.dtype and got.shape == want.shape
    if dtype == "uint8":
        assert np.abs(got.astype(int) - want).max() <= 1
    else:
        assert np.abs(got - want).max() <= FLOAT_TOL
    assert np.abs(got.astype(np.float32) - tpl).max() > 0


def test_face_fusion_rules_match_jax():
    """No landmarks, or fewer than 3 found on both images (the [0, 0]
    rows), give the template back; otherwise both packages fuse alike."""
    tpl, usr = images(11)
    lm = landmarks(32, 36, 12, seed=12)
    few = lm.copy()
    few[2:] = 0
    for fn in (lambda img: None, lambda img: few):
        got = pff.FaceFusion(fn)(tpl, usr)
        np.testing.assert_array_equal(got, tpl)
        np.testing.assert_array_equal(jff.FaceFusion(fn)(tpl, usr), tpl)
    got = pff.FaceFusion(lambda img: lm)(tpl, usr)
    want = jff.FaceFusion(lambda img: lm)(tpl, usr)
    assert np.abs(got - want).max() <= FLOAT_TOL


def test_make_post_process_with_a_base64_face():
    tpl, usr = images(13)
    lm = landmarks(32, 36, 12, seed=14)
    buf = io.BytesIO()
    Image.fromarray((usr * 255).astype(np.uint8)).save(buf, format="PNG")
    b64 = base64.b64encode(buf.getvalue()).decode()
    got_post = pff.make_post_process(lambda img: lm)
    want_post = jff.make_post_process(lambda img: lm)
    np.testing.assert_array_equal(got_post(tpl, {}), tpl)
    got = got_post(tpl, {"fusion_face": b64})
    want = want_post(tpl, {"fusion_face": b64})
    assert np.abs(got - want).max() <= FLOAT_TOL


def landmark_photo():
    return (images(15, 50, 40)[0] * 255).astype(np.uint8)


def test_openpose_landmark_fn_matches_jax():
    """The landmark function over the port's `Face` and over JAX's with the
    same random weights (inference size 64, threshold -1 so that every part
    is found; JAX's result is `tests/goldens/jax_openpose_tiny.npz`, see
    `tests/test_torch_openpose.py`): the same 70 rows but for argmax
    near-ties of the flat random maps (fp32 sum order; measured: 1 row,
    1 px), at most 3 rows and 2 px."""
    net = pface.FaceNet()
    net.load_state_dict(openpose_params_from_jax(
        numpy_tree(hand_layers(jface), 2)))
    got_fn = pff.openpose_landmark_fn(pface.Face(
        net, "cpu", inference_size=64, threshold=-1.0))
    with np.load(OPENPOSE_GOLDEN) as f:
        want = f["landmark_fn"]
    got = got_fn(landmark_photo())
    assert got.shape == (70, 2) and got.dtype == np.float32
    rows = (got != want).any(1)
    assert rows.sum() <= 3 and np.abs(got - want).max() <= 2
