"""IGPair input pipeline, host side (port of `imagdressing_tpu/train/data.py`
without its multi-host `shard_host_batch`, which waits for multi-GPU).

Manifest format, as the reference implementation's VDDataset: a JSON list
of {"image_file", "cloth_file", "text": [captions...]}.

Per sample (the reference's IGPair.py):
  * resize the shorter side to 512 (bilinear) -> random crop (640, 512)
  * normalize to [-1, 1]
  * cloth -> the CLIP view (224x224, CLIP mean/std)
  * a random caption
  * CFG dropout: rand < .05 -> drop image; < .10 -> drop text; < .15 ->
    both (drop image = zero the CLIP pixels, drop text = tokenize "")

The draws (caption, dropout, crop offsets) come from
`np.random.SeedSequence([seed, epoch, idx])` in the JAX package's order, so
the same manifest and seed give the JAX package's arrays:
  * JPEGs decode and resize through the C++ runtime (`runtime/native.py`,
    the JAX package's source): equal arrays;
  * without it (no g++ or libjpeg), and for other files, the image is read
    by `apps.image_utils.read_image` (PNG without any library, the rest
    through PIL) and resized by `resize`, which is within 1 level of PIL's
    resize, where the JAX package uses PIL.

The iterator yields numpy batches; the trainer copies them to the device.
"""

from __future__ import annotations

import json
import os
import queue as queue_lib
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from imagdressing_tpu_torch.models.clip import CLIP_IMAGE_MEAN, CLIP_IMAGE_STD
from imagdressing_tpu_torch.runtime import native


def resize(img: np.ndarray, size: Tuple[int, int],
           mode: str = "bilinear") -> np.ndarray:
    """uint8 (H, W, C) -> uint8 (h, w, C) for size (w, h) (PIL's order),
    mode "bilinear" or "bicubic", antialiased when shrinking: PIL's
    `Image.resize` with BILINEAR / BICUBIC, whose kernels (a = -0.5 for
    bicubic) and support scaling `F.interpolate(..., antialias=True)` has;
    on a uint8 CPU tensor in channels-last memory it rounds to uint8 after
    each separable pass as PIL does, so it is within 1 level of PIL."""
    w, h = size
    if img.dtype != np.uint8 or img.ndim != 3:
        raise ValueError(f"resize: expected uint8 (H, W, C), got {img.dtype} "
                         f"{img.shape}")
    x = torch.from_numpy(np.require(img, requirements=["C", "W"]))
    x = x.permute(2, 0, 1)[None]
    x = x.contiguous(memory_format=torch.channels_last)
    y = F.interpolate(x, size=(h, w), mode=mode, align_corners=False,
                      antialias=True)
    return y[0].permute(1, 2, 0).contiguous().numpy()


def clip_preprocess_np(img: np.ndarray, size: int = 224) -> np.ndarray:
    """CLIPImageProcessor equivalent: shortest-side bicubic resize to
    `size`, center crop, rescale, normalize. img: (H,W,3) uint8 ->
    (size,size,3) f32."""
    h, w = img.shape[:2]
    if h < w:
        nh, nw = size, max(size, round(w * size / h))
    else:
        nh, nw = max(size, round(h * size / w)), size
    x = resize(img, (nw, nh), "bicubic")
    top = (x.shape[0] - size) // 2
    left = (x.shape[1] - size) // 2
    x = x[top:top + size, left:left + size].astype(np.float32) / 255.0
    return (x - np.asarray(CLIP_IMAGE_MEAN, np.float32)) / np.asarray(
        CLIP_IMAGE_STD, np.float32)


def load_manifest(json_files) -> List[Dict]:
    if isinstance(json_files, str):
        json_files = [json_files]
    data: List[Dict] = []
    for path in json_files:
        with open(path, "r", encoding="utf-8") as f:
            data.extend(json.load(f))
    return data


def _resize_shorter(img: np.ndarray, size: int) -> np.ndarray:
    """Bilinear resize so that the shorter side is `size` (the other side
    rounded, as the JAX package's PIL path). img: (H, W, 3) uint8."""
    h, w = img.shape[:2]
    if h < w:
        nh, nw = size, max(1, round(w * size / h))
    else:
        nh, nw = max(1, round(h * size / w)), size
    return resize(img, (nw, nh))


def _random_crop(img: np.ndarray, ch: int, cw: int, rng: np.random.Generator
                 ) -> np.ndarray:
    h, w = img.shape[:2]
    if h < ch or w < cw:  # reflect-pad when the resize leaves it short
        ph, pw = max(0, ch - h), max(0, cw - w)
        img = np.pad(img, ((0, ph), (0, pw), (0, 0)), mode="reflect")
        h, w = img.shape[:2]
    top = int(rng.integers(0, h - ch + 1))
    left = int(rng.integers(0, w - cw + 1))
    return img[top:top + ch, left:left + cw]


class IGPairDataset:
    """Indexable IGPair dataset producing train-step-ready numpy dicts."""

    def __init__(
        self,
        manifest,
        tokenize: Callable[[str], np.ndarray],  # text -> (77,) int ids
        *,
        size: int = 512,
        crop_h: int = 640,
        crop_w: int = 512,
        drop_image_prob: float = 0.05,
        drop_text_prob: float = 0.05,
        drop_both_prob: float = 0.05,
        clip_size: int = 224,
        image_root: str = "",
        seed: int = 0,
    ):
        self.data = manifest if isinstance(manifest, list) \
            else load_manifest(manifest)
        self.tokenize = tokenize
        self.size = size
        self.crop_h, self.crop_w = crop_h, crop_w
        self.clip_size = clip_size
        self.probs = (drop_image_prob, drop_text_prob, drop_both_prob)
        self.image_root = image_root
        self.seed = seed

    def __len__(self):
        return len(self.data)

    def _load_image(self, path: str) -> np.ndarray:
        from imagdressing_tpu_torch.apps.image_utils import read_image

        full = os.path.join(self.image_root, path)
        with open(full, "rb") as f:
            data = f.read()
        if full.lower().endswith((".jpg", ".jpeg")):
            img = native.jpeg_decode(data)
            if img is not None:
                return img
        return read_image(data)

    def _vae_view(self, img: np.ndarray, rng: np.random.Generator
                  ) -> np.ndarray:
        h, w = img.shape[:2]
        rh, rw = native.resized_dims(h, w, self.size)
        if rh >= self.crop_h and rw >= self.crop_w:
            # drawn before the native call, as in the JAX package: where
            # the library is missing the fallback crop draws again
            top = int(rng.integers(0, rh - self.crop_h + 1))
            left = int(rng.integers(0, rw - self.crop_w + 1))
            out = native.resize_crop_normalize(img, self.size, top, left,
                                               self.crop_h, self.crop_w)
            if out is not None:
                return out
        img = _resize_shorter(img, self.size)
        img = _random_crop(img, self.crop_h, self.crop_w, rng)
        return img.astype(np.float32) / 127.5 - 1.0

    def get(self, idx: int, epoch: int = 0) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch, idx]))
        item = self.data[idx]
        person = self._load_image(item["image_file"])
        cloth = self._load_image(item["cloth_file"])

        text = item["text"][int(rng.integers(0, len(item["text"])))]
        p_img, p_txt, p_both = self.probs
        r = float(rng.random())
        drop_image = False
        if r < p_img:
            drop_image = True
        elif r < p_img + p_txt:
            text = ""
        elif r < p_img + p_txt + p_both:
            text = ""
            drop_image = True

        clip_img = native.clip_preprocess(cloth) \
            if self.clip_size == 224 else None
        if clip_img is None:
            clip_img = clip_preprocess_np(cloth, self.clip_size)
        if drop_image:
            clip_img = np.zeros_like(clip_img)
        return {
            "person_image": self._vae_view(person, rng),
            "cloth_image": self._vae_view(cloth, rng),
            "cloth_clip": clip_img,
            "text_ids": np.asarray(self.tokenize(text)).astype(np.int32),
        }


def shard_epoch_indices(order: np.ndarray, process_index: int,
                        process_count: int, batch_size: int) -> np.ndarray:
    """Per-rank epoch indices, padded so that every rank yields the same
    number of batches (DistributedSampler semantics). The pad target is
    the longest rank's shard, not the local one: with N = 13, 4 ranks and
    batch 1 (shards 4/3/3/3) a short rank would otherwise slip into the next
    epoch's permutation. Short shards wrap-tile their own indices."""
    local = order[process_index::process_count]
    max_len = max(1, -(-len(order) // process_count))
    need = max(1, -(-max_len // batch_size)) * batch_size
    if len(local) == 0:
        local = order[:1] if len(order) else np.zeros((1,), np.int64)
    if need > len(local):
        local = np.tile(local, -(-need // len(local)))[:need]
    return local


def data_iterator(
    dataset: IGPairDataset,
    batch_size: int,
    *,
    shuffle: bool = True,
    num_workers: int = 4,
    prefetch: int = 2,
    seed: int = 0,
    process_index: int = 0,
    process_count: int = 1,
) -> Iterator[Dict[str, np.ndarray]]:
    """Endless batches of stacked `dataset.get` dicts, in the JAX package's
    order: epoch e shuffles with `default_rng(seed + e)` and takes this
    rank's `shard_epoch_indices`. One producer thread decodes through a
    pool of `num_workers` threads, `prefetch` batches ahead; an error in it
    is raised at the consumer's next `next()`. Closing the generator (or
    dropping it) stops the producer and the pool."""
    pool = ThreadPoolExecutor(max_workers=num_workers)
    out: "queue_lib.Queue" = queue_lib.Queue(maxsize=prefetch)
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                out.put(item, timeout=0.1)
                return True
            except queue_lib.Full:
                continue
        return False

    def producer():
        epoch = 0
        n = len(dataset)
        while True:
            order = np.arange(n)
            if shuffle:
                np.random.default_rng(seed + epoch).shuffle(order)
            local = shard_epoch_indices(order, process_index, process_count,
                                        batch_size)
            for start in range(0, len(local) - batch_size + 1, batch_size):
                idxs = local[start:start + batch_size]
                futs = [pool.submit(dataset.get, int(i), epoch)
                        for i in idxs]
                samples = [f.result() for f in futs]
                batch = {k: np.stack([s[k] for s in samples])
                         for k in samples[0]}
                if not put(batch):
                    return
            epoch += 1

    def guarded_producer():
        try:
            producer()
        except Exception as e:  # noqa: BLE001 -- raised in the consumer
            put(e)

    thread = threading.Thread(target=guarded_producer, daemon=True)
    thread.start()
    try:
        while True:
            item = out.get()
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        stop.set()
        pool.shutdown(wait=False, cancel_futures=True)
