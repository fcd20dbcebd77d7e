"""OpenPose body-pose inference: the CPM net on the device, peak and limb
assembly on the host. Port of `imagdressing_tpu/preprocess/openpose/
infer.py` (`OpenPose.detect` / `__call__`), with its output contract.

On the device: the BGR flip, the single scale 0.5 * 368 / H (OpenCV's cubic
resize), the stride-8 pad with 128, the normalisation (x / 256 - 0.5), the
net, and JAX's bicubic resize of the maps to the padded scaled size, the
crop of the pad, and the resize to (H, W). The (H, W, 57) maps come to the
host as float64, where the Gaussian-filtered peak NMS (sigma 3, thre1
0.1), the PAF line integrals (10 samples, thre2 0.05, distance prior), the
greedy bipartite limb matching and the person filter (>= 4 parts, mean
score >= 0.4) run as the JAX package runs them.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from scipy.ndimage import gaussian_filter

from imagdressing_tpu_torch.ops.resize import cv2_resize_cubic, jax_resize
from imagdressing_tpu_torch.pipelines.dressing import resolve_device
from imagdressing_tpu_torch.preprocess.openpose.model import (
    BodyPoseNet,
    Device,
)

# limb connections (1-indexed keypoints) and their PAF channel pairs
LIMB_SEQ = [
    [2, 3], [2, 6], [3, 4], [4, 5], [6, 7], [7, 8], [2, 9], [9, 10],
    [10, 11], [2, 12], [12, 13], [13, 14], [2, 1], [1, 15], [15, 17],
    [1, 16], [16, 18], [3, 17], [6, 18],
]
MAP_IDX = [
    [31, 32], [39, 40], [33, 34], [35, 36], [41, 42], [43, 44], [19, 20],
    [21, 22], [23, 24], [25, 26], [27, 28], [29, 30], [47, 48], [49, 50],
    [53, 54], [51, 52], [55, 56], [37, 38], [45, 46],
]


def _find_peaks(heatmap: np.ndarray, thre1: float) -> List[List[Tuple]]:
    """Per-part peak lists [(x, y, score, global_id), ...]."""
    all_peaks = []
    counter = 0
    for part in range(18):
        raw = heatmap[:, :, part]
        smooth = gaussian_filter(raw, sigma=3)
        up = np.zeros_like(smooth)
        up[1:, :] = smooth[:-1, :]
        down = np.zeros_like(smooth)
        down[:-1, :] = smooth[1:, :]
        left = np.zeros_like(smooth)
        left[:, 1:] = smooth[:, :-1]
        right = np.zeros_like(smooth)
        right[:, :-1] = smooth[:, 1:]
        is_peak = ((smooth >= up) & (smooth >= down) & (smooth >= left)
                   & (smooth >= right) & (smooth > thre1))
        ys, xs = np.nonzero(is_peak)
        peaks = [(int(x), int(y), float(raw[y, x]), counter + i)
                 for i, (x, y) in enumerate(zip(xs, ys))]
        counter += len(peaks)
        all_peaks.append(peaks)
    return all_peaks


def _score_limb(paf_xy: np.ndarray, a, b, img_h: int, thre2: float,
                mid_num: int = 10):
    """PAF line integral between candidate endpoints a, b -> (ok, score)."""
    vec = np.asarray(b[:2], np.float64) - np.asarray(a[:2], np.float64)
    norm = max(1e-3, float(np.hypot(*vec)))
    u = vec / norm
    xs = np.round(np.linspace(a[0], b[0], mid_num)).astype(int)
    ys = np.round(np.linspace(a[1], b[1], mid_num)).astype(int)
    samples = paf_xy[ys, xs]  # (mid_num, 2)
    proj = samples @ u
    score = float(proj.mean()) + min(0.5 * img_h / norm - 1.0, 0.0)
    ok = (np.count_nonzero(proj > thre2) > 0.8 * mid_num) and score > 0
    return ok, score


def _assemble(all_peaks, paf: np.ndarray, img_h: int, thre2: float):
    """Greedy bipartite limb matching + person assembly; peak ids are
    float64 in `persons`, compared by equality as the JAX package does."""
    connections: List[Optional[np.ndarray]] = []
    for limb, chans in zip(LIMB_SEQ, MAP_IDX):
        cand_a = all_peaks[limb[0] - 1]
        cand_b = all_peaks[limb[1] - 1]
        if not cand_a or not cand_b:
            connections.append(None)
            continue
        paf_xy = paf[:, :, [chans[0] - 19, chans[1] - 19]]
        scored = []
        for i, a in enumerate(cand_a):
            for j, b in enumerate(cand_b):
                ok, s = _score_limb(paf_xy, a, b, img_h, thre2)
                if ok:
                    scored.append((i, j, s))
        scored.sort(key=lambda t: t[2], reverse=True)
        used_a, used_b, rows = set(), set(), []
        for i, j, s in scored:
            if i in used_a or j in used_b:
                continue
            rows.append([cand_a[i][3], cand_b[j][3], s, i, j])
            used_a.add(i)
            used_b.add(j)
            if len(rows) >= min(len(cand_a), len(cand_b)):
                break
        connections.append(np.asarray(rows) if rows else np.zeros((0, 5)))

    candidate = np.asarray([p for part in all_peaks for p in part],
                           np.float64).reshape(-1, 4)

    persons = -np.ones((0, 20))
    for k, conn in enumerate(connections):
        if conn is None or len(conn) == 0:
            continue
        ia, ib = LIMB_SEQ[k][0] - 1, LIMB_SEQ[k][1] - 1
        for row in conn:
            pa, pb, score = row[0], row[1], row[2]
            hits = [j for j in range(len(persons))
                    if persons[j][ia] == pa or persons[j][ib] == pb]
            if len(hits) == 1:
                j = hits[0]
                if persons[j][ib] != pb:
                    persons[j][ib] = pb
                    persons[j][-1] += 1
                    persons[j][-2] += candidate[int(pb), 2] + score
            elif len(hits) >= 2:
                j1, j2 = hits[0], hits[1]
                overlap = ((persons[j1][:-2] >= 0)
                           & (persons[j2][:-2] >= 0)).sum()
                if overlap == 0:
                    persons[j1][:-2] += persons[j2][:-2] + 1
                    persons[j1][-2:] += persons[j2][-2:]
                    persons[j1][-2] += score
                    persons = np.delete(persons, j2, 0)
                else:
                    persons[j1][ib] = pb
                    persons[j1][-1] += 1
                    persons[j1][-2] += candidate[int(pb), 2] + score
            elif k < 17:
                new = -np.ones(20)
                new[ia], new[ib] = pa, pb
                new[-1] = 2
                new[-2] = (candidate[int(pa), 2] + candidate[int(pb), 2]
                           + score)
                persons = np.vstack([persons, new])

    keep = [i for i in range(len(persons))
            if persons[i][-1] >= 4 and persons[i][-2] / persons[i][-1] >= 0.4]
    return candidate, persons[keep]


class OpenPose:
    """Body-pose detector with the reference's 18-keypoint output contract.
    Runs on "cuda" unless the caller passes device="cpu"; raises on a host
    without a card otherwise.

    After each `detect`, `last_stage_seconds` holds the host wall time of
    the device part (upload ... maps on the host) and of the assembly, and
    `last_device_ms` the device part's CUDA-event time (empty on the CPU).
    """

    _defaults: Dict[str, "OpenPose"] = {}

    def __init__(self, net: BodyPoseNet, device: Device = "cuda", *,
                 boxsize: int = 368, stride: int = 8, pad_value: int = 128,
                 thre1: float = 0.1, thre2: float = 0.05):
        self.device = resolve_device(device)
        self.net = net.to(self.device).eval().requires_grad_(False)
        self.boxsize = boxsize
        self.stride = stride
        self.pad_value = pad_value
        self.thre1 = thre1
        self.thre2 = thre2
        self.last_stage_seconds: Dict[str, float] = {}
        self.last_device_ms: Dict[str, float] = {}

    @classmethod
    def from_torch(cls, path: str, device: Device = "cuda") -> "OpenPose":
        """`body_pose_model.pth` (tensors only; bare or prefixed keys)."""
        sd = torch.load(path, map_location="cpu", weights_only=True)
        return cls(BodyPoseNet.from_state_dict(sd, device), device)

    @classmethod
    def get_default(cls, device: Device = "cuda") -> "OpenPose":
        """The checkpoint named by IMAGDRESSING_OPENPOSE_CKPT (default
        `ckpt/body_pose_model.pth`), loaded once per device."""
        key = str(resolve_device(device))
        if key not in cls._defaults:
            path = os.environ.get("IMAGDRESSING_OPENPOSE_CKPT",
                                  "ckpt/body_pose_model.pth")
            cls._defaults[key] = cls.from_torch(path, device)
        return cls._defaults[key]

    @torch.no_grad()
    def maps(self, image: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """uint8 RGB (H, W, 3) on the device -> (paf (H, W, 38), heatmap
        (H, W, 19)) float32 on the device."""
        h, w = image.shape[:2]
        bgr = image.flip(-1).float()
        scale = 0.5 * self.boxsize / h
        sh, sw = max(1, round(h * scale)), max(1, round(w * scale))
        small = cv2_resize_cubic(bgr, sw, sh)
        ph = (self.stride - sh % self.stride) % self.stride
        pw = (self.stride - sw % self.stride) % self.stride
        padded = F.pad(small, (0, 0, 0, pw, 0, ph), value=self.pad_value)
        paf, heat = self.net((padded / 256.0 - 0.5)[None])

        # the reference's chain: up to the PADDED scaled size, crop the
        # pad, then to the photo's size
        def up(x):
            x = jax_resize(x, sh + ph, sw + pw)[:, :sh, :sw]
            return jax_resize(x, h, w)[0]

        return up(paf), up(heat)

    def detect(self, image_rgb: np.ndarray):
        """image (H, W, 3) uint8 RGB -> (candidate (N, 4) [x, y, score, id]
        in pixels, persons (P, 20))."""
        self.last_stage_seconds, self.last_device_ms = {}, {}
        t0 = time.perf_counter()
        cuda = self.device.type == "cuda"
        if cuda:
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
        image = torch.from_numpy(np.ascontiguousarray(image_rgb)).to(
            self.device)
        paf, heat = self.maps(image)
        if cuda:
            end.record()
        paf = paf.cpu().numpy().astype(np.float64)
        heat = heat.cpu().numpy().astype(np.float64)
        if cuda:
            self.last_device_ms["body"] = start.elapsed_time(end)
        t1 = time.perf_counter()
        all_peaks = _find_peaks(heat, self.thre1)
        out = _assemble(all_peaks, paf, image_rgb.shape[0], self.thre2)
        self.last_stage_seconds = {"device": t1 - t0,
                                   "assemble": time.perf_counter() - t1}
        return out

    def __call__(self, image_rgb: np.ndarray, resolution: int = 384) -> Dict:
        """The reference's OpenPose.__call__ contract: {"pose_keypoints_2d":
        [[x, y] * 18]} in (384, 512) pixel space, missing joints [0, 0]."""
        if image_rgb.shape[0] != 512 or image_rgb.shape[1] != 384:
            raise ValueError("expected a 384x512 input (resize first), got "
                             f"{image_rgb.shape}")
        candidate, persons = self.detect(image_rgb)
        kps = np.zeros((18, 2), np.float64)
        if len(persons):
            # the reference consumes subset[0]: the FIRST assembled person,
            # not the highest-scoring one
            person = persons[0]
            for i in range(18):
                idx = int(person[i])
                if idx >= 0:
                    kps[i] = candidate[idx, :2]
        return {"pose_keypoints_2d": kps.tolist()}
