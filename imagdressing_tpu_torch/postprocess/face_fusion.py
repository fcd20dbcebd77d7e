"""Landmark-driven face fusion: the server's `face_fusion:` post-process.
Port of `imagdressing_tpu/postprocess/face_fusion.py`.

  1. facial landmarks on both images: any `landmark_fn(rgb_uint8) -> (N, 2)
     float [x, y] | None`; `openpose_landmark_fn` runs the OpenPose FaceNet
     (70 points) on the device;
  2. the closed-form Umeyama similarity (user -> template landmarks);
  3. a feathered convex-hull mask around the template's landmarks;
  4. Reinhard per-channel colour transfer inside the mask;
  5. a multi-band (Laplacian pyramid) blend.

Steps 2-5 run on the host in float32, as in the JAX package, with
`preprocess/imgproc.py` in place of OpenCV (warpAffine, convexHull +
fillConvexPoly, erode, GaussianBlur, pyrDown / pyrUp).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from imagdressing_tpu_torch.preprocess import imgproc

LandmarkFn = Callable[[np.ndarray], Optional[np.ndarray]]


def umeyama(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Least-squares similarity transform (scale * R | t) mapping src ->
    dst, (N, 2) point sets -> a 2x3 float32 affine. Closed form (Umeyama
    1991), reflection-free."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s, mu_d = src.mean(0), dst.mean(0)
    sc, dc = src - mu_s, dst - mu_d
    cov = dc.T @ sc / len(src)
    u, d, vt = np.linalg.svd(cov)
    s = np.eye(2)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        s[1, 1] = -1.0
    rot = u @ s @ vt
    var_s = (sc ** 2).sum(1).mean()
    scale = float(np.trace(np.diag(d) @ s) / var_s) if var_s > 0 else 1.0
    t = mu_d - scale * rot @ mu_s
    return np.concatenate([scale * rot, t[:, None]], axis=1).astype(
        np.float32)


def hull_mask(shape, landmarks: np.ndarray, *, feather: float = 0.12,
              shrink: float = 0.06) -> np.ndarray:
    """Feathered convex-hull mask (H, W) float32 in [0, 1] around the
    landmarks: the hull eroded by `shrink` of its diagonal, then blurred
    with sigma `feather` of the diagonal."""
    h, w = shape[:2]
    mask = np.zeros((h, w), np.float32)
    pts = np.round(np.asarray(landmarks, np.float64)).astype(np.int32)
    imgproc.fill_convex_poly(mask, imgproc.convex_hull(pts), 1.0)
    span = float(np.linalg.norm(pts.max(0) - pts.min(0)))
    if span <= 0:
        return mask
    k = max(1, int(round(span * shrink)))
    mask = imgproc.erode_box(mask, k)
    sigma = max(1.0, span * feather)
    ksize = int(sigma * 3) * 2 + 1
    mask = imgproc.gaussian_blur(mask, ksize, sigma)
    return np.clip(mask, 0.0, 1.0)


def color_transfer(src: np.ndarray, ref: np.ndarray,
                   mask: np.ndarray) -> np.ndarray:
    """Match src's per-channel mean / std to ref's inside mask (Reinhard).
    src / ref (H, W, 3) float, mask (H, W) in [0, 1]."""
    w = mask[..., None]
    tot = w.sum()
    if tot < 1.0:
        return src

    def stats(img):
        mu = (img * w).sum((0, 1)) / tot
        var = (w * (img - mu) ** 2).sum((0, 1)) / tot
        return mu, np.sqrt(np.maximum(var, 1e-8))

    mu_s, sd_s = stats(src)
    mu_r, sd_r = stats(ref)
    return (src - mu_s) * (sd_r / sd_s) + mu_r


def pyramid_blend(fg: np.ndarray, bg: np.ndarray, mask: np.ndarray,
                  levels: int = 4) -> np.ndarray:
    """Multi-band blend: fg where mask = 1, bg where 0. A level is added
    only while the downsampled mask stays saturated somewhere (max > 0.95),
    as in the JAX package."""
    levels = max(1, min(levels, int(np.log2(max(1, min(mask.shape[:2]))))))
    gf, gb = [fg.astype(np.float32)], [bg.astype(np.float32)]
    gm = [mask.astype(np.float32)]
    for _ in range(levels - 1):
        down = imgproc.pyr_down(gm[-1])
        if down.max() <= 0.95 or min(down.shape[:2]) < 2:
            break
        gf.append(imgproc.pyr_down(gf[-1]))
        gb.append(imgproc.pyr_down(gb[-1]))
        gm.append(down)
    levels = len(gm)
    out = None
    for i in reversed(range(levels)):
        if i == levels - 1:
            lf, lb = gf[i], gb[i]
        else:
            size = gf[i].shape[1::-1]
            lf = gf[i] - imgproc.pyr_up(gf[i + 1], size)
            lb = gb[i] - imgproc.pyr_up(gb[i + 1], size)
        m = gm[i][..., None]
        band = m * lf + (1.0 - m) * lb
        out = band if out is None else (
            imgproc.pyr_up(out, band.shape[1::-1]) + band)
    return out


def fuse_face(template: np.ndarray, user: np.ndarray,
              template_landmarks: np.ndarray, user_landmarks: np.ndarray,
              *, color_match: bool = True, feather: float = 0.12,
              levels: int = 4) -> np.ndarray:
    """Fuse the user's face into the template at the template's landmarks.
    template / user (H, W, 3) float in [0, 1] or uint8; the result in the
    template's dtype and range."""
    as_uint8 = template.dtype == np.uint8
    tpl = template.astype(np.float32) / (255.0 if as_uint8 else 1.0)
    usr = np.asarray(user, np.float32)
    if user.dtype == np.uint8:
        usr = usr / 255.0
    h, w = tpl.shape[:2]
    m = umeyama(np.asarray(user_landmarks, np.float32),
                np.asarray(template_landmarks, np.float32))
    warped = imgproc.warp_affine_reflect(usr, m, w, h)
    mask = hull_mask(tpl.shape, template_landmarks, feather=feather)
    if color_match:
        warped = color_transfer(warped, tpl, mask)
    fused = pyramid_blend(warped, tpl, mask, levels=levels)
    fused = np.clip(fused, 0.0, 1.0)
    if as_uint8:
        return (fused * 255.0 + 0.5).astype(np.uint8)
    return fused.astype(template.dtype)


def openpose_landmark_fn(face) -> LandmarkFn:
    """LandmarkFn over an OpenPose `Face` (70 landmarks, [0, 0] where a
    part is missing; the net on the face's device). Keeps the full 70-row
    array, or None when fewer than 3 rows were found."""

    def fn(rgb: np.ndarray) -> Optional[np.ndarray]:
        pts = np.asarray(face(rgb[..., ::-1]), np.float32)  # RGB -> BGR
        detected = ~(pts == 0).all(axis=-1)
        return pts if detected.sum() >= 3 else None

    return fn


class FaceFusion:
    """Face fusion as a callable: landmarks on both images, then
    `fuse_face`; the template comes back unchanged where either image has
    no landmarks or fewer than 3 are found on both."""

    def __init__(self, landmark_fn: LandmarkFn, *, color_match: bool = True,
                 feather: float = 0.12, levels: int = 4):
        self.landmark_fn = landmark_fn
        self.color_match = color_match
        self.feather = feather
        self.levels = levels

    def __call__(self, template: np.ndarray,
                 user: np.ndarray) -> np.ndarray:
        def to_u8(x):
            return x if x.dtype == np.uint8 else (
                np.clip(x, 0, 1) * 255).astype(np.uint8)

        lm_t = self.landmark_fn(to_u8(np.asarray(template)))
        lm_u = self.landmark_fn(to_u8(np.asarray(user)))
        if lm_t is None or lm_u is None:
            return template
        n = min(len(lm_t), len(lm_u))
        lm_t, lm_u = lm_t[:n], lm_u[:n]
        # indexed landmark sets ([0, 0] = missing): rows found on BOTH
        good = ~((lm_t == 0).all(-1) | (lm_u == 0).all(-1))
        lm_t, lm_u = lm_t[good], lm_u[good]
        if len(lm_t) < 3:
            return template
        return fuse_face(template, user, lm_t, lm_u,
                         color_match=self.color_match, feather=self.feather,
                         levels=self.levels)


def make_post_process(landmark_fn: LandmarkFn, *,
                      face_key: str = "fusion_face", **fusion_kwargs):
    """The server's post-process hook: fuses `payload[face_key]` (an (H, W,
    3) array or a base64-encoded image, PNG or, with PIL, JPEG) into each
    image; requests without the key pass through."""
    fusion = FaceFusion(landmark_fn, **fusion_kwargs)

    def post_process(img, payload):
        face = payload.get(face_key)
        if face is None:
            return img
        if isinstance(face, (str, bytes)):
            import base64

            from imagdressing_tpu_torch.apps.image_utils import read_image

            face = read_image(base64.b64decode(face))
        return fusion(img, np.asarray(face))

    return post_process
