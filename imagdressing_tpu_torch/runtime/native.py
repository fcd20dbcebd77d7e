"""ctypes bindings and build-at-first-use of the C++ image runtime (port of
`imagdressing_tpu/runtime/native.py`).

Two libraries, each one source of `csrc/` built with g++ into its own
shared library in `imagdressing_tpu_torch/_build/` (gitignored), named by a
hash of the source and flags so that an edited source is rebuilt (the JAX
package builds its copy beside the source instead):

  * `IMAGE_OPS`, `csrc/image_ops.cpp`, linked with `-ljpeg`: libjpeg
    decode, PIL's triangle resize, crop and normalize, the CLIP view. The
    training data pipeline decodes on the CPU whatever device trains.
    Without g++ or libjpeg the build fails, `available()` is False and
    every function below returns None: the dataset then decodes with PIL
    and resizes with `train.data.resize`;
  * `PNG`, `csrc/png_unfilter.cpp`, linked with nothing: the PNG row
    filters for `apps/png.py`, which falls back to numpy where it cannot
    be built (no g++). A host without libjpeg keeps it.

This is host code; each library is built or loaded once per process.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Callable, Optional, Tuple

import numpy as np

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")
MAX_SIDE = 8192

_tls = threading.local()


class Library:
    """One source of `csrc/` built into its own shared library with the
    given libraries linked; `load()` builds it on the checkout's first use
    and returns the loaded library (its signatures set by `bind`), or None
    where it cannot be built or loaded."""

    def __init__(self, source: str, libs: Tuple[str, ...],
                 bind: Callable[[ctypes.CDLL], None]):
        self.source = CSRC / source
        self.libs = libs
        self._bind = bind
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None
        self._failed = False

    def path(self) -> Path:
        h = hashlib.sha256(" ".join(FLAGS + self.libs).encode())
        h.update(self.source.read_bytes())
        return BUILD_DIR / f"{self.source.stem}-{h.hexdigest()[:16]}.so"

    def _build(self, out: Path) -> bool:
        """g++ into a temporary name, then an atomic rename: processes that
        build at once never load a half-written library."""
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = ["g++", *FLAGS, str(self.source), "-o", str(tmp), *self.libs]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            tmp.unlink(missing_ok=True)
            return False
        os.replace(tmp, out)
        return True

    def load(self) -> Optional[ctypes.CDLL]:
        if self._lib is not None or self._failed:
            return self._lib
        with self._lock:
            if self._lib is not None or self._failed:
                return self._lib
            out = self.path()
            if not out.exists() and not self._build(out):
                self._failed = True
                return None
            try:
                lib = ctypes.CDLL(str(out))
            except OSError:
                self._failed = True
                return None
            self._bind(lib)
            self._lib = lib
            return lib


def _bind_image_ops(lib: ctypes.CDLL) -> None:
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


def _bind_png(lib: ctypes.CDLL) -> None:
    lib.igd_png_unfilter.restype = ctypes.c_int
    lib.igd_png_unfilter.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
        ctypes.c_void_p,
    ]


IMAGE_OPS = Library("image_ops.cpp", ("-ljpeg",), _bind_image_ops)
PNG = Library("png_unfilter.cpp", (), _bind_png)


def _load() -> Optional[ctypes.CDLL]:
    return IMAGE_OPS.load()


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
