"""Seeded synthetic inputs, numpy only (the client process imports nothing
else): garments, openpose-style pose maps, prompts, PNG files and request
plans. Every function is a pure function of its seed, so that the
reference can rebuild any input that a run sent.

Sizes are the cell's, the same for every seed; prompt lengths are the
same set for every seed, in another order: a seed changes which garment or
prompt comes when, not how much work a window holds."""

from __future__ import annotations

import math
import struct
import zlib
from typing import Dict, List

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"

WORDS = (
    "a woman man girl boy model wearing dress shirt blouse jacket coat "
    "sweater hoodie skirt trousers jeans shorts suit cardigan vest tank top "
    "knit denim silk linen cotton wool leather velvet satin floral striped "
    "plaid checked dotted printed embroidered pleated ruffled cropped "
    "oversized slim fitted loose long short sleeve sleeveless collar "
    "buttoned zipped hooded casual formal elegant sporty vintage modern "
    "summer winter autumn spring street studio beach garden city park "
    "standing walking sitting smiling posing looking front side back view "
    "full body portrait photo best quality high detailed realistic soft "
    "light natural sunlight red blue green white black grey beige pink "
    "yellow navy brown purple orange pastel bright dark young adult "
    "confident happy calm blonde brunette curly straight hair earrings "
    "necklace bag shoes boots sneakers heels hat scarf belt glasses"
).split()


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """An independent numpy generator for (seed, stream...)."""
    return np.random.default_rng(np.random.SeedSequence([int(seed),
                                                        *stream]))


def garment(seed: int, index: int, h: int, w: int) -> np.ndarray:
    """A uint8 RGB garment of h x w: a coloured silhouette with stripes and
    a soft shade on a light background, mild noise."""
    rng = rng_for(seed, 1, index)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    cy, cx = h * rng.uniform(0.45, 0.55), w * rng.uniform(0.45, 0.55)
    ry, rx = h * rng.uniform(0.35, 0.45), w * rng.uniform(0.3, 0.42)
    inside = ((y - cy) / ry) ** 2 + ((x - cx) / rx) ** 4 < 1.0
    base = rng.uniform(40, 220, 3).astype(np.float32)
    period = rng.uniform(8, 40)
    stripe = 30.0 * np.sin((x * rng.uniform(-1, 1) + y) / period)
    shade = 40.0 * (y / h - 0.5)
    cloth = base + (stripe + shade)[..., None]
    img = np.where(inside[..., None], cloth, np.float32(235.0))
    img = img + rng.normal(0.0, 3.0, img.shape).astype(np.float32)
    return np.clip(img, 0, 255).astype(np.uint8)


# openpose's 18-keypoint limbs and colours (the reference's draw_bodypose)
LIMBS = ((1, 2), (1, 5), (2, 3), (3, 4), (5, 6), (6, 7), (1, 8), (8, 9),
         (9, 10), (1, 11), (11, 12), (12, 13), (1, 0), (0, 14), (14, 16),
         (0, 15), (15, 17))
SKELETON = np.array([  # a standing person, (x, y) in [0, 1]
    (0.50, 0.12), (0.50, 0.22), (0.38, 0.22), (0.33, 0.38), (0.30, 0.52),
    (0.62, 0.22), (0.67, 0.38), (0.70, 0.52), (0.42, 0.52), (0.41, 0.72),
    (0.40, 0.92), (0.58, 0.52), (0.59, 0.72), (0.60, 0.92), (0.47, 0.10),
    (0.53, 0.10), (0.44, 0.11), (0.56, 0.11)], np.float32)


def pose_map(seed: int, index: int, h: int, w: int) -> np.ndarray:
    """A uint8 RGB openpose-style map: the skeleton jittered by the seed,
    each limb a coloured stick of width ~h/100 on black."""
    rng = rng_for(seed, 2, index)
    pts = SKELETON + rng.normal(0.0, 0.02, SKELETON.shape).astype(np.float32)
    pts = pts * np.float32([w, h])
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((h, w, 3), np.float32)
    half_width = max(2.0, h / 100.0)
    for n, (a, b) in enumerate(LIMBS):
        pa, pb = pts[a], pts[b]
        d = pb - pa
        t = np.clip(((x - pa[0]) * d[0] + (y - pa[1]) * d[1])
                    / max(float(d @ d), 1e-6), 0.0, 1.0)
        dist = np.hypot(x - pa[0] - t * d[0], y - pa[1] - t * d[1])
        hue = n / len(LIMBS)
        colour = 255.0 * np.float32([abs(math.sin(math.pi * (hue + k / 3)))
                                     for k in range(3)])
        img[dist < half_width] = 0.6 * colour
    return img.astype(np.uint8)


def prompt(seed: int, index: int, n_words: int) -> str:
    rng = rng_for(seed, 3, index)
    return " ".join(rng.choice(WORDS, size=n_words))


def spread(values: List[float], seed: int, stream: int) -> List[float]:
    """`values` in the order the seed gives."""
    order = rng_for(seed, 4, stream).permutation(len(values))
    return [values[i] for i in order]


def word_counts(n: int, lo: int, hi: int, seed: int) -> List[int]:
    """n prompt lengths cycling over lo..hi, in the seed's order."""
    return spread([lo + i % (hi - lo + 1) for i in range(n)], seed, 3)


def png_encode(img: np.ndarray, level: int = 6) -> bytes:
    """uint8 (H, W, 3) -> an RGB PNG, filter 0 on every row."""
    h, w, c = img.shape
    if img.dtype != np.uint8 or c != 3:
        raise ValueError(f"png_encode: uint8 RGB, got {img.dtype} {img.shape}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(img).reshape(h, w * 3)], 1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + chunk(b"IEND", b""))


def png_decode(data: bytes) -> np.ndarray:
    """An 8-bit RGB PNG whose rows use filter 0 (None) or 2 (Up) -> uint8
    (H, W, 3). Other files raise ValueError."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if zlib.crc32(kind + body) != struct.unpack(
                ">I", data[pos + 8 + n:pos + 12 + n])[0]:
            raise ValueError(f"PNG chunk {kind!r}: bad CRC")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, colour, _, _, interlace = header
    if (depth, colour, interlace) != (8, 2, 0):
        raise ValueError(f"PNG depth {depth} colour {colour} interlace "
                         f"{interlace}: only 8-bit RGB")
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = rows.reshape(h, 1 + 3 * w)
    kinds = set(np.unique(rows[:, 0]).tolist())
    if not kinds <= {0, 2}:
        raise ValueError(f"PNG row filters {sorted(kinds)}: only 0 and 2")
    px = rows[:, 1:].astype(np.uint8)
    out = np.empty_like(px)
    prev = np.zeros(3 * w, np.uint8)
    for y in range(h):
        out[y] = px[y] + prev if rows[y, 0] == 2 else px[y]
        prev = out[y]
    return out.reshape(h, w, 3)


def request_plan(seed: int, params: Dict) -> Dict:
    """The requests of a served cell: `n_requests` requests, each a garment
    index (the `n_garments` garments in the seed's order, over and over)
    and a prompt of its own: a subject of `subject_words` words drawn from
    the seed, then `prompt_suffix` (every prompt differs, so that a prompt
    identifies its request)."""
    n = params["n_requests"]
    counts = word_counts(n, *params["subject_words"], seed)
    # every run of n_garments requests sends each garment once
    perm = rng_for(seed, 6).permutation(params["n_garments"])
    order = [perm[i % len(perm)] for i in range(n)]
    prompts, seen = [], set()
    for i in range(n):
        k = 0
        text = prompt(seed, i, counts[i])
        while text in seen:  # unique prompts
            k += 1
            text = prompt(seed, i + 1000003 * k, counts[i])
        seen.add(text)
        prompts.append(text + params["prompt_suffix"])
    return {"garment": [int(g) for g in order], "prompt": prompts}
