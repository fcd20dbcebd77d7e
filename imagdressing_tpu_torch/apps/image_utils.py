"""Host-side image helpers of the apps (port of
`imagdressing_tpu/apps/image_utils.py`), on uint8 RGB numpy arrays (H, W,
3) where the JAX package passes PIL images.

resize_img: snap-to-64 dual-constraint resize of the reference scripts
image_grid: the save-side collage
prepare_garment: Resize(640, 512) + Normalize(0.5) VAE view plus the CLIP
  view, as numpy arrays ready for DressingPipeline

Files: PNG is read and written by `apps/png.py` (no imaging library);
JPEG and the other formats go through PIL where it is installed, and raise
a RuntimeError naming the format where it is not.

Spans (`core.profiling.span`, recorded while a profiler session runs):
`image.read` (bytes, pixels, decoder), `image.write` (bytes) and
`image.prepare_garment` (the parent of its read and resizes); the resizes
are `image.resize` (`train/data.py`).
"""

from __future__ import annotations

import io
import os
from typing import List, Optional, Tuple, Union

import numpy as np

from imagdressing_tpu_torch.apps.png import (SIGNATURE, decode_png, decoder,
                                             encode_png)
from imagdressing_tpu_torch.core import profiling
from imagdressing_tpu_torch.train.data import clip_preprocess_np, resize

DEFAULT_PROMPT = "A beautiful woman, best quality, high quality"
DEFAULT_NEGATIVE = (
    "bare, naked, nude, undressed, monochrome, lowres, bad anatomy, "
    "worst quality, low quality"
)


def _pil(what: str):
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(
            f"{what} needs PIL, which is not installed here; PNG needs "
            "nothing") from e
    return Image


def to_rgb(img: np.ndarray) -> np.ndarray:
    """uint8 (H, W, C), C = 1 gray, 2 gray + alpha, 3 RGB, 4 RGBA -> RGB
    (alpha dropped, as PIL's convert("RGB"))."""
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[-1] in (1, 2):
        return np.repeat(img[..., :1], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


def read_image(src: Union[str, bytes]) -> np.ndarray:
    """A file path or the file's bytes -> uint8 RGB (H, W, 3). Its
    `image.read` span records bytes, pixels and the `decoder`: "native"
    (PNG, the C++ unfilter), "numpy" (PNG, the fallback) or "pil" (every
    other format)."""
    with profiling.span("image.read") as sp:
        if isinstance(src, (str, os.PathLike)):
            with open(src, "rb") as f:
                data = f.read()
        else:
            data = bytes(src)
        if data[:8] == SIGNATURE:
            img = to_rgb(decode_png(data))
            used = decoder()
        else:
            image = _pil("reading a non-PNG image (JPEG, ...)")
            img = np.asarray(image.open(io.BytesIO(data)).convert("RGB"))
            used = "pil"
        sp.set(bytes=len(data), pixels=img.shape[0] * img.shape[1],
               decoder=used)
        return img


def write_image(path: str, img: np.ndarray,
                quality: Optional[int] = None) -> None:
    """uint8 (H, W, 3) -> `path`, in the format of its extension: .png by
    `encode_png`, any other through PIL (`quality`: the JPEG quality,
    PIL's default 75 where None)."""
    with profiling.span("image.write") as sp:
        if path.lower().endswith(".png"):
            data = encode_png(img)
            with open(path, "wb") as f:
                f.write(data)
            sp.set(bytes=len(data))
            return
        extra = {} if quality is None else {"quality": quality}
        _pil(f"writing {os.path.basename(path)}").fromarray(
            np.ascontiguousarray(img)).save(path, **extra)
        sp.set(bytes=os.path.getsize(path))


def resize_img(img: np.ndarray, max_side: int = 640, min_side: int = 512,
               mode: str = "bilinear", base_pixel_number: int = 64
               ) -> np.ndarray:
    """The reference's snap-to-64 resize: the short side to `min_side`,
    then the long side to `max_side`, then each side down to a multiple of
    `base_pixel_number`."""
    h, w = img.shape[:2]
    ratio = min_side / min(h, w)
    w, h = round(ratio * w), round(ratio * h)
    ratio = max_side / max(h, w)
    img = resize(img, (round(ratio * w), round(ratio * h)), mode)
    w_new = (round(ratio * w) // base_pixel_number) * base_pixel_number
    h_new = (round(ratio * h) // base_pixel_number) * base_pixel_number
    return resize(img, (w_new, h_new), mode)


def image_grid(imgs: List[np.ndarray], rows: int, cols: int) -> np.ndarray:
    """rows x cols images of one size -> one image, row-major."""
    if len(imgs) != rows * cols:
        raise ValueError(f"{len(imgs)} images for a {rows}x{cols} grid")
    h, w = imgs[0].shape[:2]
    grid = np.zeros((rows * h, cols * w, 3), np.uint8)
    for i, im in enumerate(imgs):
        r, c = divmod(i, cols)
        grid[r * h:(r + 1) * h, c * w:(c + 1) * w] = im
    return grid


def prepare_garment(path: Union[str, bytes], height: int = 640,
                    width: int = 512, clip_size: int = 224
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (ref_image (1,H,W,3) in [-1,1], ref_clip_image
    (1,clip_size,clip_size,3), the resized uint8 garment for collages)."""
    with profiling.span("image.prepare_garment"):
        img = resize_img(read_image(path))
        vae_view = resize(img, (width, height)).astype(np.float32) \
            / 127.5 - 1.0
        clip_view = clip_preprocess_np(img, size=clip_size)
    return vae_view[None], clip_view[None], img


def prepare_person(path: Union[str, bytes], height: int, width: int
                   ) -> np.ndarray:
    """A person photo -> (1, height, width, 3) in [-1, 1]."""
    img = resize(read_image(path), (width, height))
    return (img.astype(np.float32) / 127.5 - 1.0)[None]


def to_uint8(images: np.ndarray) -> List[np.ndarray]:
    """float [0,1] or uint8 [0,255] batch -> uint8 images (the JAX
    package's `to_pil`)."""
    if images.dtype == np.uint8:
        return list(images)
    return [(np.clip(im, 0, 1) * 255).astype(np.uint8) for im in images]
