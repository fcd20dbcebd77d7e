"""ctypes binding and build-at-first-use of the C++ image runtime (port of
`imagdressing_tpu/runtime/native.py`).

`csrc/image_ops.cpp` (libjpeg decode, PIL's triangle resize, crop and
normalize, the CLIP view) is built with g++ at first use into
`imagdressing_tpu_torch/_build/` (gitignored), named by a hash of the source
and flags so that an edited source is rebuilt; the JAX package builds its
copy beside the source instead. This is host code: the training data
pipeline decodes on the CPU whatever device trains. Without g++ or libjpeg
the build fails, `available()` is False and every function returns None:
the dataset then decodes with PIL and resizes with `train.data.resize`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "image_ops.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")
LIBS = ("-ljpeg",)
MAX_SIDE = 8192

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failed = False
_tls = threading.local()


def lib_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS + LIBS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"image_ops-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> bool:
    """g++ into a temporary name, then an atomic rename: processes that
    build at once never load a half-written library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", *FLAGS, str(SOURCE), "-o", str(tmp), *LIBS]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, out)
    return True


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _failed
    if _lib is not None or _failed:
        return _lib
    with _lock:
        if _lib is not None or _failed:
            return _lib
        out = lib_path()
        if not out.exists() and not _build(out):
            _failed = True
            return None
        try:
            lib = ctypes.CDLL(str(out))
        except OSError:
            _failed = True
            return None
        lib.igd_jpeg_decode.restype = ctypes.c_int
        lib.igd_jpeg_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        lib.igd_resize_crop_normalize.restype = ctypes.c_int
        lib.igd_resize_crop_normalize.argtypes = [
            ctypes.c_void_p] + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        lib.igd_clip_preprocess.restype = ctypes.c_int
        lib.igd_clip_preprocess.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _scratch() -> np.ndarray:
    """Per-thread decode buffer (96 MB), reused across calls; the decoded
    view is copied before it is returned."""
    buf = getattr(_tls, "scratch", None)
    if buf is None:
        buf = np.empty((MAX_SIDE, MAX_SIDE // 2, 3), np.uint8)
        _tls.scratch = buf
    return buf


def jpeg_decode(data: bytes) -> Optional[np.ndarray]:
    """JPEG bytes -> (H, W, 3) uint8 RGB, or None where the native path
    cannot decode it (no library, not a 3-channel JPEG, too large)."""
    lib = _load()
    if lib is None:
        return None
    buf = _scratch()
    h, w = ctypes.c_int(), ctypes.c_int()
    rc = lib.igd_jpeg_decode(
        data, len(data), buf.ctypes.data_as(ctypes.c_void_p),
        MAX_SIDE, MAX_SIDE // 2, ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        return None
    n = h.value * w.value * 3
    return buf.reshape(-1)[:n].reshape(h.value, w.value, 3).copy()


def _uint8_image(img: np.ndarray) -> np.ndarray:
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) image, got {img.shape}")
    return np.ascontiguousarray(img, np.uint8)


def resize_crop_normalize(img: np.ndarray, size: int, top: int, left: int,
                          crop_h: int, crop_w: int) -> Optional[np.ndarray]:
    """Shorter side to `size` (PIL BILINEAR), the (crop_h, crop_w) window at
    (top, left), to [-1, 1] float32; None without the library or for a
    window outside the resized image."""
    lib = _load()
    if lib is None:
        return None
    img = _uint8_image(img)
    out = np.empty((crop_h, crop_w, 3), np.float32)
    rc = lib.igd_resize_crop_normalize(
        img.ctypes.data_as(ctypes.c_void_p), img.shape[0], img.shape[1],
        size, top, left, crop_h, crop_w, out.ctypes.data_as(ctypes.c_void_p))
    return out if rc == 0 else None


def clip_preprocess(img: np.ndarray, size: int = 224) -> Optional[np.ndarray]:
    """The CLIP view with the triangle resize (the JAX package's native
    path); None without the library."""
    lib = _load()
    if lib is None:
        return None
    img = _uint8_image(img)
    out = np.empty((size, size, 3), np.float32)
    rc = lib.igd_clip_preprocess(
        img.ctypes.data_as(ctypes.c_void_p), img.shape[0], img.shape[1],
        size, out.ctypes.data_as(ctypes.c_void_p))
    return out if rc == 0 else None


def resized_dims(sh: int, sw: int, size: int) -> Tuple[int, int]:
    """Shorter-side resize target dims (the C++ arithmetic: floor)."""
    if sh < sw:
        return size, max(1, sw * size // sh)
    return max(1, sh * size // sw), size
