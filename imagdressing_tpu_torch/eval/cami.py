"""CAMI-U / CAMI-S evaluation metrics (port of `imagdressing_tpu/eval/
cami.py`; the reference's metric/eval.py and eval_s.py), in numpy and scipy
with OpenCV's and skimage's semantics and without either:

  * SSIM and LBP as skimage computes them (uniform filter; bilinear
    neighbours with zero outside the image);
  * Harris corners through `preprocess.imgproc.corner_harris` and
    `dilate3` (cv2.cornerHarris(block 2, ksize 3, k 0.04) and cv2.dilate);
  * CAMI-U's resize of the reference garment through
    `ops.resize.cv2_resize_linear_u8` (cv2.resize's INTER_LINEAR).

The reference's quirks are kept as the JAX package keeps them:
keypoint_matching returns 0.99 when the generated image has 0 or more than
5000 corners; the LBP histogram's bins arange(0, 65) count the codes <= 63
only; pose_overlap widens to int64 before summing the channels (the
reference's uint8 sums can wrap to 0; PARITY.md).

CAMI-U = SSIM + (1 - keypoint distance) + LBP histogram correlation
CAMI-S = pose overlap + face cosine + CLIP text-image similarity
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import uniform_filter

from imagdressing_tpu_torch.ops.resize import cv2_resize_linear_u8
from imagdressing_tpu_torch.preprocess.imgproc import corner_harris, dilate3


def _to_gray(img: np.ndarray) -> np.ndarray:
    """BGR (cv2's channel order) -> float64 gray. uint8 goes through
    cv2.cvtColor(BGR2GRAY)'s fixed-point weights and rounding: the Harris
    threshold and the LBP bit compares act on the rounded gray."""
    if img.ndim == 2:
        return img.astype(np.float64)
    b, g, r = img[..., 0], img[..., 1], img[..., 2]
    if img.dtype == np.uint8:
        y = (r.astype(np.int64) * 4899 + g.astype(np.int64) * 9617
             + b.astype(np.int64) * 1868 + (1 << 13)) >> 14
        return y.astype(np.float64)
    return 0.114 * b + 0.587 * g + 0.299 * r


def ssim(img1: np.ndarray, img2: np.ndarray, *, data_range: float = 255.0,
         win_size: int = 7, K1: float = 0.01, K2: float = 0.03) -> float:
    """skimage.metrics.structural_similarity(multichannel=True): a 7x7
    uniform window, the mean over channels."""
    img1 = img1.astype(np.float64)
    img2 = img2.astype(np.float64)
    if img1.ndim == 2:
        img1, img2 = img1[..., None], img2[..., None]
    n = win_size ** 2
    cov_norm = n / (n - 1)
    c1 = (K1 * data_range) ** 2
    c2 = (K2 * data_range) ** 2
    pad = (win_size - 1) // 2
    vals = []
    for c in range(img1.shape[-1]):
        x, y = img1[..., c], img2[..., c]
        ux, uy = uniform_filter(x, win_size), uniform_filter(y, win_size)
        uxx = uniform_filter(x * x, win_size)
        uyy = uniform_filter(y * y, win_size)
        uxy = uniform_filter(x * y, win_size)
        vx = cov_norm * (uxx - ux * ux)
        vy = cov_norm * (uyy - uy * uy)
        vxy = cov_norm * (uxy - ux * uy)
        s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / (
            (ux ** 2 + uy ** 2 + c1) * (vx + vy + c2))
        vals.append(s[pad:-pad, pad:-pad].mean())
    return float(np.mean(vals))


def local_binary_pattern(gray: np.ndarray, P: int = 8, R: float = 1.0
                         ) -> np.ndarray:
    """skimage's 'default' LBP: P neighbours on a circle of radius R
    (bilinear, zero outside the image), each compared with the centre,
    packed little-endian."""
    gray = gray.astype(np.float64)
    h, w = gray.shape
    out = np.zeros((h, w), np.float64)
    pad = int(np.ceil(R)) + 1
    gp = np.pad(gray, pad, constant_values=0.0)
    rows, cols = np.mgrid[0:h, 0:w]
    for p in range(P):
        theta = 2.0 * np.pi * p / P
        r = rows - R * np.sin(theta) + pad
        c = cols + R * np.cos(theta) + pad
        r0 = np.floor(r).astype(int)
        c0 = np.floor(c).astype(int)
        fr, fc = r - r0, c - c0
        val = (gp[r0, c0] * (1 - fr) * (1 - fc)
               + gp[r0 + 1, c0] * fr * (1 - fc)
               + gp[r0, c0 + 1] * (1 - fr) * fc
               + gp[r0 + 1, c0 + 1] * fr * fc)
        # skimage's tolerance on interpolated values
        out += ((val - gray) >= -1e-6 * np.abs(val)) * (1 << p)
    return out


def harris_keypoints(img_bgr: np.ndarray) -> np.ndarray:
    """The reference's extract_clothing_keypoints: Harris response (block
    2, ksize 3, k 0.04) of the gray image, dilated, the (row, col) of every
    pixel above 1 % of its maximum."""
    dst = dilate3(corner_harris(np.float32(_to_gray(img_bgr))))
    return np.argwhere(dst > 0.01 * dst.max())


def keypoint_matching(kp1: np.ndarray, kp2: np.ndarray) -> float:
    """The mean distance from each of kp1 to its nearest in kp2 over the
    512 * sqrt(2) diagonal; 0.99 when kp2 has 0 or more than 5000 points."""
    kp1, kp2 = np.asarray(kp1), np.asarray(kp2)
    if len(kp2) == 0 or len(kp2) > 5000:
        return 0.99
    d = np.linalg.norm(kp1[:, None, :] - kp2[None, :, :], axis=2)
    return float(np.mean(d.min(axis=1)) / (512.0 * np.sqrt(2.0)))


def lbp_histogram_correlation(img1_bgr: np.ndarray, img2_bgr: np.ndarray,
                              P: int = 8, R: float = 1.0) -> float:
    """cv2.compareHist(HISTCMP_CORREL) of the two LBP density histograms
    over bins arange(0, P**2 + 1) (codes <= 63: the reference's bins)."""
    bins = np.arange(0, P ** 2 + 1)
    h1, _ = np.histogram(local_binary_pattern(_to_gray(img1_bgr), P, R),
                         bins=bins, density=True)
    h2, _ = np.histogram(local_binary_pattern(_to_gray(img2_bgr), P, R),
                         bins=bins, density=True)
    h1 = h1 - h1.mean()
    h2 = h2 - h2.mean()
    denom = np.sqrt((h1 ** 2).sum() * (h2 ** 2).sum())
    return float((h1 * h2).sum() / denom) if denom > 0 else 1.0


def cami_u(reference_bgr: np.ndarray, generated_bgr: np.ndarray) -> float:
    """SSIM + (1 - keypoint distance) + texture correlation of the
    reference garment (resized to the generated one's size) and the
    generated garment, uint8 BGR."""
    h, w = generated_bgr.shape[:2]
    reference_bgr = cv2_resize_linear_u8(reference_bgr, w, h)
    kp1 = harris_keypoints(reference_bgr)
    kp2 = harris_keypoints(generated_bgr)
    return (ssim(reference_bgr, generated_bgr)
            + (1.0 - keypoint_matching(kp1, kp2))
            + lbp_histogram_correlation(reference_bgr, generated_bgr))


def pose_overlap(pose1_rgb: np.ndarray, pose2_rgb: np.ndarray) -> float:
    """The share of pose1's non-zero render pixels that are non-zero in
    pose2 too, the channels summed in int64."""
    p1 = np.asarray(pose1_rgb, np.int64)
    p2 = np.asarray(pose2_rgb, np.int64)
    m1 = p1[..., 0] + p1[..., 1] + p1[..., 2]
    m2 = p2[..., 0] + p2[..., 1] + p2[..., 2]
    num = np.count_nonzero(m1) * 1.0
    overlap = np.count_nonzero(m1 * m2) * 1.0
    return overlap / num if num > 0 else 0.0


def face_cosine(embed1: np.ndarray, embed2: np.ndarray) -> float:
    """The cosine of two normed face embeddings."""
    return float(np.dot(embed1, embed2.T))


def cami_s(pose1_rgb: np.ndarray, pose2_rgb: np.ndarray,
           face_embed1: np.ndarray, face_embed2: np.ndarray,
           clip_similarity: float) -> float:
    """pose overlap + face cosine + the CLIP text-image similarity (from
    `eval.clip_score` or any scorer)."""
    return (pose_overlap(pose1_rgb, pose2_rgb)
            + face_cosine(face_embed1, face_embed2) + clip_similarity)
