"""PNG decoding and encoding with zlib and numpy, no imaging library.

The serving and CLI paths read garment uploads and write results as PNG
without PIL. `decode_png` reads non-interlaced 8-bit gray, gray+alpha, RGB,
RGBA and palette images (palette and gray also at 1, 2 and 4 bits per
sample), with any of the five row filters; `encode_png` writes 8-bit gray,
gray+alpha, RGB or RGBA.

Unfiltering: the Sub, Average and Paeth filters predict a byte from the
one to its left, so a row is sequential in x, and each row depends on the
row above. Two implementations give the same bytes for every file:

  * the C++ one, `runtime/csrc/png_unfilter.cpp` (`runtime.native.PNG`,
    linked with nothing, called through ctypes, which releases the GIL):
    the specification's filters row by row, Average and Paeth a pixel a
    step on SSE vectors. It runs wherever the library builds; it is built
    (on a checkout's first use) or loaded when this module is imported, so
    that no g++ run lands inside a timed decode;
  * the numpy one, `_unfilter`, where the library cannot be built (no
    g++). Pixel (y, x) depends only on (y, x-1), (y-1, x) and (y-1, x-1),
    so every pixel of an anti-diagonal y + x = t is independent of the
    others: it stores the image skewed (pixel (y, x) at column y + x),
    where an anti-diagonal is one column, and reconstructs one column per
    step, whatever the mix of filters: H + W - 1 vectorised steps instead
    of H * W scalar ones.

`decoder()` names the one that runs. The chunk parsing, CRC checks,
inflate, sub-byte and palette expansion and every error are shared.
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from typing import Optional

import numpy as np

from imagdressing_tpu_torch.runtime import native

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# color type -> samples per pixel
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _load() -> Optional[ctypes.CDLL]:
    """The C++ unfilter's library, or None where it cannot be built."""
    return native.PNG.load()


_load()  # build or load it now, not inside the first decode


def decoder() -> str:
    """The unfilter `decode_png` runs: "native" (C++) or "numpy"."""
    return "numpy" if _load() is None else "native"


def _chunks(data: bytes):
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 12 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if len(body) != n or zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r}: truncated or bad CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError("PNG ends before IEND")


def _unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """rows (H, 1 + row bytes) as stored, each led by its filter type ->
    the reconstructed bytes (H, row bytes)."""
    h = rows.shape[0]
    kinds = rows[:, 0].astype(np.int16)
    if h and kinds.max() > 4:
        raise ValueError(f"PNG row filter {int(kinds.max())}")
    n = (rows.shape[1] - 1) // bpp
    filt = rows[:, 1:].reshape(h, n, bpp)
    # skewed, with a zero row above and a zero column left of the image:
    # pixel (y, x) at [y + 1, y + x + 1], so anti-diagonal t is column t + 1
    recon = np.zeros((h + 1, h + n + 1, bpp), np.int16)
    skewed = np.zeros_like(recon)
    ys = np.arange(h)[:, None]
    cols = ys + np.arange(n)[None, :] + 1
    skewed[ys + 1, cols] = filt
    # None, Sub, Up and Average predict (ca * left + cb * above) >> sh;
    # Paeth picks one of left, above, upper left
    ca = ((kinds == 1) | (kinds == 3)).astype(np.int16)[:, None]
    cb = ((kinds == 2) | (kinds == 3)).astype(np.int16)[:, None]
    sh = (kinds == 3).astype(np.int16)[:, None]
    is_paeth = (kinds == 4)[:, None]
    paeth_rows = np.concatenate([[0], np.cumsum(kinds == 4)])
    for t in range(h + n - 1):
        lo, hi = max(0, t - n + 1), min(h, t + 1)
        c = t + 1
        a = recon[lo + 1:hi + 1, c - 1]    # left
        b = recon[lo:hi, c - 1]            # above
        pred = (ca[lo:hi] * a + cb[lo:hi] * b) >> sh[lo:hi]
        if paeth_rows[hi] > paeth_rows[lo]:
            ul = recon[lo:hi, c - 2] if c >= 2 else np.zeros_like(a)
            da, db = b - ul, a - ul  # p - a, p - b for p = a + b - ul
            pa, pb, pc = np.abs(da), np.abs(db), np.abs(da + db)
            paeth = np.where((pa <= pb) & (pa <= pc), a,
                             np.where(pb <= pc, b, ul))
            pred = np.where(is_paeth[lo:hi], paeth, pred)
        recon[lo + 1:hi + 1, c] = (skewed[lo + 1:hi + 1, c] + pred) & 255
    return recon[ys + 1, cols].astype(np.uint8).reshape(h, n * bpp)


def _unfilter_native(lib: ctypes.CDLL, rows: np.ndarray,
                     bpp: int) -> np.ndarray:
    """`_unfilter` in C++: the same bytes, the same error."""
    rows = np.ascontiguousarray(rows, np.uint8)
    h, stride = rows.shape
    out = np.empty((h, stride - 1), np.uint8)
    rc = lib.igd_png_unfilter(rows.ctypes.data, h, stride - 1, bpp,
                              out.ctypes.data)
    if rc:
        raise ValueError(f"PNG row filter {rc}" if rc > 0 else
                         f"PNG rows of {stride - 1} bytes at {bpp} a pixel")
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 (H, W, C): C = 1 gray, 2 gray + alpha, 3 RGB
    (palette images through their PLTE), 4 RGBA. Gray at 1, 2 or 4 bits is
    scaled to 0..255; 16-bit samples and interlaced files raise."""
    header = palette = None
    idat = []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = header
    if ctype not in _CHANNELS:
        raise ValueError(f"PNG color type {ctype}")
    if interlace:
        raise ValueError("interlaced PNG is not supported")
    ch = _CHANNELS[ctype]
    if depth != 8 and not (depth in (1, 2, 4) and ch == 1):
        raise ValueError(f"PNG with {depth}-bit samples, color type {ctype}, "
                         "is not supported")
    row_bytes = (w * ch * depth + 7) // 8
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != h * (row_bytes + 1):
        raise ValueError(f"PNG data: {len(raw)} bytes for {w}x{h}")
    rows = np.frombuffer(raw, np.uint8).reshape(h, row_bytes + 1)
    bpp = max(1, ch * depth // 8)
    lib = _load()
    px = (_unfilter(rows, bpp) if lib is None
          else _unfilter_native(lib, rows, bpp))
    if depth < 8:
        px = np.unpackbits(px, axis=1).reshape(h, -1, depth)[:, :w]
        px = (px * (1 << np.arange(depth - 1, -1, -1))).sum(-1).astype(
            np.uint8)
        if ctype == 0:
            px = (px.astype(np.uint16) * 255 // ((1 << depth) - 1)).astype(
                np.uint8)
    img = px.reshape(h, w, ch)
    if ctype == 3:
        if palette is None:
            raise ValueError("palette PNG without PLTE")
        img = palette[np.minimum(img[..., 0], len(palette) - 1)]
    return img


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """uint8 (H, W) or (H, W, C), C in 1..4 -> PNG bytes (8-bit, the Up
    filter on every row, zlib at `level`)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"encode_png: dtype {img.dtype}, expected uint8")
    if img.ndim == 2:
        img = img[..., None]
    h, w, ch = img.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}.get(ch)
    if ctype is None:
        raise ValueError(f"encode_png: {ch} channels")
    px = img.reshape(h, w * ch)
    up = px.copy()
    up[1:] -= px[:-1]  # uint8 wraps: the filter is modulo 256
    rows = np.concatenate([np.full((h, 1), 2, np.uint8), up], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + chunk(b"IEND", b""))

