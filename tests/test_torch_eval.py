"""The port's try-on metrics (`eval/`) against the JAX package, on the CPU.

The CAMI-U / CAMI-S functions on synthetic garments (smooth random
images, so that corners and textures exist) against `imagdressing_tpu.
eval.cami`; the OpenCV pieces the port rewrote without cv2 (INTER_LINEAR
of uint8 and float images, INTER_AREA, cornerHarris, dilate) against cv2;
`ClipScorer` at a tiny configuration against JAX's from the same
transformers `CLIPModel` state dict (`tools/write_checkpoints.
clip_scorer_state_dict`); `cami_s_grid` and the pose renderer against
JAX's with the same injected callables; `eval.cli cami-u` / `cami-s`
against JAX's printed lines. Inputs are made with numpy from a seed.
"""

import hashlib

import cv2
import numpy as np
import pytest
import torch

import imagdressing_tpu.eval.cami as jcami
import imagdressing_tpu.eval.cli as jcli
import imagdressing_tpu.eval.grid as jgrid
from imagdressing_tpu.apps.tokenizer import HashTokenizer as JaxHashTokenizer
from imagdressing_tpu.core.config import CLIPTextConfig as JTextCfg
from imagdressing_tpu.core.config import CLIPVisionConfig as JVisionCfg
from imagdressing_tpu.eval.clip_score import ClipScorer as JaxScorer
from imagdressing_tpu_torch.apps.tokenizer import HashTokenizer
from imagdressing_tpu_torch.core.config import CLIPTextConfig, CLIPVisionConfig
from imagdressing_tpu_torch.eval import cami as pcami
from imagdressing_tpu_torch.eval import cli as pcli
from imagdressing_tpu_torch.eval import grid as pgrid
from imagdressing_tpu_torch.eval.clip_score import ClipScorer
from imagdressing_tpu_torch.ops.resize import (
    cv2_resize_area_u8,
    cv2_resize_linear,
    cv2_resize_linear_u8,
)
from imagdressing_tpu_torch.preprocess.imgproc import corner_harris, dilate3
from imagdressing_tpu_torch.tools.write_checkpoints import (
    clip_scorer_state_dict,
)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def garment(seed, h=96, w=80):
    """A smooth random uint8 BGR image with a few hard-edged patches."""
    rng = np.random.default_rng(seed)
    img = cv2.GaussianBlur(rng.integers(0, 256, (h, w, 3)).astype(np.uint8),
                           (0, 0), 3)
    for _ in range(4):
        y, x = rng.integers(0, h - 16), rng.integers(0, w - 16)
        img[y:y + 12, x:x + 12] = rng.integers(0, 256, 3)
    return img


# ---------------------------------------------------------------------------
# OpenCV pieces
# ---------------------------------------------------------------------------

SIZES = [((100, 80), (64, 48)), ((600, 460), (473, 473)),
         ((473, 473), (591, 591)), ((37, 53), (90, 20)), ((256, 256),
                                                         (128, 128))]


@pytest.mark.parametrize("src,dst", SIZES)
def test_linear_resizes_match_cv2(src, dst):
    """uint8 INTER_LINEAR bit-equal (gray and BGR); float INTER_LINEAR
    within 1e-6 (measured <= 4.8e-7 on N(0, 1))."""
    (h, w), (oh, ow) = src, dst
    rng = np.random.default_rng(h + w)
    for shape in ((h, w), (h, w, 3)):
        img = rng.integers(0, 256, shape).astype(np.uint8)
        np.testing.assert_array_equal(cv2_resize_linear_u8(img, ow, oh),
                                      cv2.resize(img, (ow, oh)))
    f = rng.standard_normal((h, w, 3)).astype(np.float32)
    got = cv2_resize_linear(torch.from_numpy(f), ow, oh)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), cv2.resize(f, (ow, oh)), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("src", [(640, 512), (600, 460), (1024, 768),
                                 (513, 390)])
def test_area_resize_matches_cv2(src):
    """uint8 INTER_AREA to 384x512 (the pose renderer's view), fractional
    and integer factors: bit-equal."""
    img = np.random.default_rng(src[0]).integers(0, 256, src + (3,)).astype(
        np.uint8)
    np.testing.assert_array_equal(
        cv2_resize_area_u8(img, 384, 512),
        cv2.resize(img, (384, 512), interpolation=cv2.INTER_AREA))


@pytest.mark.parametrize("shape", [(64, 48), (96, 80), (67, 45), (512, 384)])
def test_corner_harris_and_dilate_match_cv2(shape):
    """cornerHarris(2, 3, 0.04) on integer gray: bit-equal at widths whose
    rows OpenCV runs fully vectorised; at others (45) a few pixels differ by
    float32 rounding: bound 1e-6 * max and 0.1 % of pixels. dilate:
    bit-equal."""
    gray = np.float32(cv2.cvtColor(garment(shape[1], *shape),
                                   cv2.COLOR_BGR2GRAY))
    want = cv2.cornerHarris(gray, blockSize=2, ksize=3, k=0.04)
    got = corner_harris(gray)
    assert got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    assert (got != want).mean() <= 1e-3
    np.testing.assert_array_equal(dilate3(want), cv2.dilate(want, None))


# ---------------------------------------------------------------------------
# CAMI functions
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pair():
    ref = garment(1)
    gen = np.clip(garment(1).astype(np.int32) + np.random.default_rng(
        2).integers(-20, 21, ref.shape), 0, 255).astype(np.uint8)
    return ref, gen


def test_ssim_lbp_and_correlation_match_jax(pair):
    ref, gen = pair
    assert pcami.ssim(ref, gen) == pytest.approx(jcami.ssim(ref, gen),
                                                 rel=1e-12)
    gray = pcami._to_gray(ref)
    np.testing.assert_array_equal(gray, jcami._to_gray(ref))
    np.testing.assert_array_equal(pcami.local_binary_pattern(gray),
                                  jcami.local_binary_pattern(gray))
    assert pcami.lbp_histogram_correlation(ref, gen) == pytest.approx(
        jcami.lbp_histogram_correlation(ref, gen), rel=1e-12)


@pytest.mark.parametrize("seed", [1, 3, 4])
def test_harris_keypoints_match_jax(seed):
    """The same keypoint set as JAX's (which calls cv2) on synthetic
    garments."""
    img = garment(seed)
    got = pcami.harris_keypoints(img)
    assert len(got) > 0
    np.testing.assert_array_equal(got, jcami.harris_keypoints(img))


def test_cami_u_and_keypoint_matching_match_jax(pair):
    """CAMI-U with the reference resized (96x80 -> 64x48 and the same
    size), and the 0.99 sentinel for a generated image without corners."""
    ref, gen = pair
    small = cv2.resize(gen, (48, 64))
    for g in (gen, small):
        assert pcami.cami_u(ref, g) == pytest.approx(jcami.cami_u(ref, g),
                                                     rel=1e-12)
    kp = pcami.harris_keypoints(ref)
    assert pcami.keypoint_matching(kp, np.zeros((0, 2))) == 0.99
    assert pcami.keypoint_matching(kp, kp[::-1]) == \
        jcami.keypoint_matching(kp, kp[::-1]) == 0.0


def test_pose_overlap_and_cami_s_match_jax():
    """Renders whose uint8 channel sums would wrap (255 + 1 = 0 mod 256):
    both packages widen to int64."""
    rng = np.random.default_rng(5)
    p1 = (rng.random((32, 24, 3)) < 0.3) * rng.integers(0, 256, (32, 24, 3))
    p2 = (rng.random((32, 24, 3)) < 0.3) * rng.integers(0, 256, (32, 24, 3))
    p1, p2 = p1.astype(np.uint8), p2.astype(np.uint8)
    p1[0, 0] = (255, 1, 0)
    e1, e2 = (v / np.linalg.norm(v) for v in rng.standard_normal((2, 16)))
    assert pcami.pose_overlap(p1, p2) == jcami.pose_overlap(p1, p2)
    assert pcami.cami_s(p1, p2, e1, e2, 0.3) == pytest.approx(
        jcami.cami_s(p1, p2, e1, e2, 0.3), rel=1e-15)


# ---------------------------------------------------------------------------
# CLIP scorer
# ---------------------------------------------------------------------------

TINY_TEXT = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                 num_layers=2, num_heads=2)
TINY_VISION = dict(hidden_size=64, intermediate_size=128, num_layers=2,
                   num_heads=2, image_size=32, patch_size=8,
                   projection_dim=48, hidden_act="quick_gelu")


def test_clip_scorer_matches_jax():
    """Text and image embeddings within 1e-5 * max, the similarity within
    1e-6; the image (40x50) goes through the shortest-edge bicubic resize
    and centre crop, and through `clip_preprocess`."""
    from imagdressing_tpu.convert.torch_sd import (
        convert_clip_text,
        convert_clip_vision,
    )

    sd = clip_scorer_state_dict(0, "cpu", CLIPTextConfig(**TINY_TEXT),
                                CLIPVisionConfig(**TINY_VISION))
    port = ClipScorer.from_state_dict(
        sd, CLIPTextConfig(**TINY_TEXT), CLIPVisionConfig(**TINY_VISION),
        HashTokenizer(256), "cpu")
    jt, jv = JTextCfg(**TINY_TEXT), JVisionCfg(**TINY_VISION)
    jax_scorer = JaxScorer(convert_clip_text(sd, jt),
                           convert_clip_vision(sd, jv),
                           sd["text_projection.weight"].numpy().T, jt, jv,
                           tokenizer=JaxHashTokenizer(256))
    ids = np.stack([HashTokenizer(256)(t) for t in ("a red dress",
                                                    "a blue shirt")])
    image = np.random.default_rng(0).random((1, 40, 50, 3)).astype(
        np.float32)
    for got, want in ((port.text_embed(ids), jax_scorer.text_embed(ids)),
                      (port.image_embed(image),
                       jax_scorer.image_embed(image))):
        want = np.asarray(want)
        assert got.shape == want.shape
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    assert port.similarity("a red dress", image[0]) == pytest.approx(
        jax_scorer.similarity("a red dress", image[0]), abs=1e-6)


# ---------------------------------------------------------------------------
# The grid and the CLIs
# ---------------------------------------------------------------------------


def _unit(path):
    """A unit embedding keyed by the file's basename."""
    seed = int(hashlib.md5(path.rsplit("/", 1)[-1].encode()).hexdigest()[:8],
               16)
    v = np.random.default_rng(seed).standard_normal(16)
    return v / np.linalg.norm(v)


def _clip(text, img01):
    return float(img01.mean()) + 0.01 * len(text)


def _render(image_rgb, h, w):
    return cv2.resize((image_rgb > 128).astype(np.uint8) * 255, (w, h),
                      interpolation=cv2.INTER_NEAREST)


@pytest.fixture(scope="module")
def grid_dirs(tmp_path_factory):
    """2 poses x 2 faces x 2 cloths (a PNG and a JPEG) of generated images
    for 2 prompts, one cell's garment crop missing and a stray text file."""
    root = tmp_path_factory.mktemp("grid")
    d = {}
    for name in ("pose", "face", "cloth", "generated", "cloth_mask"):
        (root / name).mkdir()
        d[name] = str(root / name)
    rng = np.random.default_rng(0)
    for j in range(2):
        pose = np.zeros((64, 48, 3), np.uint8)
        pose[8 + 4 * j:56, 18:30] = (255, 0, 85 * j)
        cv2.imwrite(f"{d['pose']}/p{j}.png", pose)
        cv2.imwrite(f"{d['face']}/face_{j}.png", garment(10 + j, 32, 32))
    (root / "cloth" / "notes.txt").write_text("not an image")
    for c, cloth in enumerate(("a.png", "b.jpg")):
        cv2.imwrite(f"{d['cloth']}/{cloth}", garment(20 + c, 64, 48))
        for i in range(2):
            for j in range(2):
                for k in range(2):
                    name = f"pt_{i}_pose_{j}_face_{k}_{cloth}"
                    cv2.imwrite(f"{d['generated']}/{name}",
                                garment(int(rng.integers(1 << 30)), 64, 48))
                    if (i, j, k, c) != (1, 0, 1, 0):
                        cv2.imwrite(f"{d['cloth_mask']}/{name}",
                                    garment(int(rng.integers(1 << 30)), 64,
                                            48))
    return d


def test_cami_s_grid_matches_jax(grid_dirs):
    """The same folders and injected callables: an equal result (order,
    names, scores, the missing cell)."""
    d = grid_dirs
    args = (["a woman in a dress", "a man"], d["pose"], d["face"],
            d["cloth"], d["generated"], d["cloth_mask"])
    kw = dict(clip_fn=_clip, face_embed_fn=_unit, pose_render_fn=_render,
              num_faces=2)
    got = pgrid.cami_s_grid(*args, **kw)
    want = jgrid.cami_s_grid(*args, **kw)
    assert got == want
    assert got["num_cells"] == 16 and got["num_missing"] == 1


def test_pose_renderer_matches_jax():
    """`make_pose_renderer` with a stand-in OpenPose whose keypoints depend
    on the 384x512 view it is given: the INTER_AREA view and the render
    equal JAX's."""
    def openpose(view):
        assert view.shape == (512, 384, 3)
        base = np.asarray(view[::40, ::40, 0], np.float64).ravel()[:36]
        kps = np.stack([base[:18] + 20, 2 * base[18:36] + 10], 1)
        kps[::5] = 0
        return {"pose_keypoints_2d": kps.tolist()}

    img = cv2.cvtColor(garment(7, 640, 512), cv2.COLOR_BGR2RGB)
    got = pgrid.make_pose_renderer(openpose)(img, 64, 48)
    want = jgrid.make_pose_renderer(openpose)(img, 64, 48)
    np.testing.assert_array_equal(got, want)


def test_eval_cli_prints_jax_numbers(grid_dirs, tmp_path, capsys):
    """`cami-u` over a cloth folder (a stray text file and a garment
    without a generated crop score 0 in both) and
    `cami-s` on two renders and an embeddings file: the same lines as the
    JAX CLI's."""
    d = grid_dirs
    gen = tmp_path / "gen"
    gen.mkdir()
    cv2.imwrite(str(gen / "a.png"), garment(30, 64, 48))
    embeds = tmp_path / "e.npy"
    np.save(embeds, np.stack([_unit("x"), _unit("y")]))
    for argv in (["cami-u", "--cloth_path", d["cloth"], "--cloth_mask_path",
                  str(gen)],
                 ["cami-s", "--pose_path", f"{d['pose']}/p0.png",
                  "--gen_pose_path", f"{d['pose']}/p1.png",
                  "--face_embeds", str(embeds), "--clip_similarity",
                  "0.25"]):
        pcli.main(argv)
        got = capsys.readouterr().out
        jcli.main(argv)
        want = capsys.readouterr().out
        assert got == want and "_score: " in got
