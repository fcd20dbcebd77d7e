"""The port's apps against the JAX package: the tokenizer, the PNG codec,
image preparation, the whole file-to-image slice, the HTTP server and the
`dress` CLI (with person photos: OpenPose and the parser stubbed), the
`face_fusion:` post-process and `write_checkpoints --preprocess`, on the
CPU.

A tiny port stack (`DressingModels.init_random(0, small=True,
with_controlnet=True)`, fp32; the `basic` models draw first, so they do not
depend on the ControlNet) is written as the reference's files by
`tools/write_checkpoints.py` and loaded back by the port's loader. The
slice is held against `tests/goldens/torch_apps_tiny.npz`: the JAX package
loaded the same files (`apps.loader.load_dressing_models`, fp32), prepared
two seeded garments with PIL (`apps.image_utils.prepare_garment`, 64x64,
CLIP view 56), tokenized with a tiny CLIP vocabulary and ran its jitted
`DressingPipeline` (`basic`, 4 steps, batch 2, explicit latents). The port
runs its pipeline on the golden's arrays and must match the JAX images
within 2e-3 (fp16 golden, the presets' tolerance); its own preparation of
the same garments must stay within 2 uint8 levels of PIL's. No JAX pipeline
runs in these tests.

Re-record the golden (JAX on the CPU, about a minute of compile):

    JAX_PLATFORMS=cpu python tests/test_torch_apps.py
"""

import base64
import dataclasses
import functools
import io
import json
import os
import struct
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
import zlib
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch
from PIL import Image

import imagdressing_tpu_torch.apps.dress as dress
import imagdressing_tpu_torch.apps.loader as loader_mod
import imagdressing_tpu_torch.apps.tokenizer as tok_mod
from imagdressing_tpu.apps import image_utils as jiu
from imagdressing_tpu.apps.tokenizer import CLIPTokenizer as JaxCLIPTokenizer
from imagdressing_tpu.apps.tokenizer import HashTokenizer as JaxHashTokenizer
from imagdressing_tpu.train.data import clip_preprocess_np as jax_clip_prep
from imagdressing_tpu_torch.apps import image_utils as iu
from imagdressing_tpu_torch.apps import png
from imagdressing_tpu_torch.apps import serve
from imagdressing_tpu_torch.apps.loader import load_dressing_models
from imagdressing_tpu_torch.apps.png import decode_png, encode_png
from imagdressing_tpu_torch.apps.tokenizer import (
    CLIPTokenizer,
    HashTokenizer,
    load_tokenizer,
)
from imagdressing_tpu_torch.core import profiling
from imagdressing_tpu_torch.core.config import PRESETS
from imagdressing_tpu_torch.pipelines import dressing
from imagdressing_tpu_torch.pipelines.dressing import (
    DressingModels,
    DressingPipeline,
    model_configs,
)
from imagdressing_tpu_torch.tools import write_checkpoints as wc_mod
from imagdressing_tpu_torch.tools.write_checkpoints import write_checkpoints
from imagdressing_tpu_torch.train.data import clip_preprocess_np

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens",
                      "torch_apps_tiny.npz")
CONFIGS = model_configs(small=True)
SIZE, CLIP_SIZE, STEPS = 64, 56, 4
# image preparation against PIL: uint8 levels
PREP_LEVELS = 2
PROMPT, NEGATIVE = "lower low", "low"
# the tiny vocabulary of the JAX package's tokenizer test
VOCAB_TOKENS = ["l", "o", "w", "lo", "low", "e", "r", "er", "lower</w>",
                "low</w>", "er</w>", "o</w>", "w</w>", "l</w>", "e</w>",
                "r</w>"]
MERGES = "#version: 0.2\nl o\nlo w\ne r</w>\nlow er</w>\n"


# torch's thread count before `_threads` lowers it (see `fingerprint`)
DEFAULT_THREADS = torch.get_num_threads()


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def write_vocab(path) -> None:
    vocab = {"<|startoftext|>": 0, "<|endoftext|>": 1}
    vocab.update({t: i + 2 for i, t in enumerate(VOCAB_TOKENS)})
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(path, "merges.txt"), "w") as f:
        f.write(MERGES)


def garment(seed: int, h: int = 600, w: int = 460) -> np.ndarray:
    """A seeded uint8 RGB garment: smooth ramps and stripes plus noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([(x * 0.5 + y * 0.3 + 40 * seed) % 256,
                    np.sin(x / (15 + seed)) * 100 + 128,
                    (y / h) * 200], -1)
    return np.clip(img + rng.normal(0, 12, img.shape), 0, 255).astype(
        np.uint8)


def pil_png(img: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG", **kw)
    return buf.getvalue()


def fingerprint(models: DressingModels) -> np.ndarray:
    """fp64 sum and sum of squares of every `basic` model's parameters, on
    torch's default threads: the sums' order, and so their last bits,
    follow the thread count the golden was recorded with."""
    n = torch.get_num_threads()
    torch.set_num_threads(DEFAULT_THREADS)
    try:
        out = []
        for name in dressing.MODEL_NAMES:
            for p in getattr(models, name).parameters():
                p = p.detach().double()
                out += [float(p.sum()), float((p * p).sum())]
    finally:
        torch.set_num_threads(n)
    return np.asarray(out)


def tiny_stack() -> DressingModels:
    return DressingModels.init_random(0, small=True, with_controlnet=True,
                                      device="cpu")


# ---------------------------------------------------------------------------
# Tokenizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("text", ["lower", "low lower low", "  LOWER\tlow ",
                                  "low " * 100, ""])
def test_clip_tokenizer_ids_match_jax(tmp_path, text):
    """BOS / EOS framing, merges, case and whitespace cleaning, truncation
    and EOS padding: exactly the JAX tokenizer's ids."""
    write_vocab(tmp_path)
    got = CLIPTokenizer.from_dir(str(tmp_path))(text)
    want = JaxCLIPTokenizer.from_dir(str(tmp_path))(text)
    assert got.dtype == want.dtype == np.int32 and got.shape == (77,)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("vocab", [49408, 256])
def test_hash_tokenizer_matches_jax(vocab):
    for text in ("a beautiful woman", "A Beautiful  woman, best quality", "",
                 "word " * 90):
        np.testing.assert_array_equal(HashTokenizer(vocab)(text),
                                      JaxHashTokenizer(vocab)(text))


def test_load_tokenizer_picks_bpe_or_hash(tmp_path):
    assert isinstance(load_tokenizer(str(tmp_path)), HashTokenizer)
    write_vocab(tmp_path)
    assert isinstance(load_tokenizer(str(tmp_path)), CLIPTokenizer)


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------


def _pil_modes():
    img = garment(1, 90, 70)
    pal = Image.fromarray(img).convert("P", palette=Image.ADAPTIVE,
                                       colors=200)
    cases = {"RGB": Image.fromarray(img),
             "L": Image.fromarray(img[..., 0]),
             "RGBA": Image.fromarray(np.concatenate([img, img[..., 1:2]], -1)),
             "LA": Image.fromarray(img[..., :2], "LA"),
             "P": pal,
             "1": Image.fromarray(img[..., 0] > 128)}
    for bits in (1, 2, 4):
        cases[f"P{bits}"] = Image.fromarray(img).convert(
            "P", palette=Image.ADAPTIVE, colors=2 ** bits)
    return cases


@pytest.mark.parametrize("mode", ["RGB", "L", "RGBA", "LA", "P", "1", "P1",
                                  "P2", "P4"])
def test_png_decode_matches_pil(mode):
    """PIL-written files (adaptive row filters; palette at 8, 4, 2 and 1
    bits; 1-bit gray): bit-equal to PIL's decode, channels as PIL gives
    them (palette as RGB, 1-bit as L)."""
    im = _pil_modes()[mode]
    kw = {"bits": int(mode[1:])} if mode[:1] == "P" and mode[1:] else {}
    buf = io.BytesIO()
    im.save(buf, format="PNG", **kw)
    data = buf.getvalue()
    back = Image.open(io.BytesIO(data))
    want = np.asarray(back.convert({"P": "RGB", "1": "L"}.get(back.mode,
                                                              back.mode)))
    got = decode_png(data)
    assert got.shape[:2] == want.shape[:2]
    np.testing.assert_array_equal(got.reshape(want.shape), want)
    np.testing.assert_array_equal(iu.read_image(data),
                                  np.asarray(back.convert("RGB")))


def _filter_row(row, prev, kind, bpp):
    """The PNG row filters, byte by byte (the specification's formulas)."""
    out = bytearray(len(row))
    for i, x in enumerate(row):
        a = row[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        if kind == 0:
            pred = 0
        elif kind == 1:
            pred = a
        elif kind == 2:
            pred = b
        elif kind == 3:
            pred = (a + b) // 2
        else:
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (x - pred) % 256
    return bytes(out)


def png_file(w, h, depth, ctype, raw, palette=None) -> bytes:
    """A PNG of the filtered rows `raw` (each led by its filter byte)."""

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    plte = b"" if palette is None else chunk(b"PLTE", palette.tobytes())
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0,
                                         0, 0))
            + plte + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def test_png_decode_every_row_filter():
    """Rows filtered None, Sub, Up, Average, Paeth in turn: the decode is
    the image, as PIL's is."""
    img = garment(2, 23, 17)
    h, w, _ = img.shape
    raw, prev = b"", bytes(w * 3)
    for y in range(h):
        row = img[y].tobytes()
        raw += bytes([y % 5]) + _filter_row(row, prev, y % 5, 3)
        prev = row

    data = png_file(w, h, 8, 2, raw)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))),
                                  img)
    np.testing.assert_array_equal(decode_png(data), img)


@pytest.mark.parametrize("channels", [0, 1, 2, 3, 4])
def test_png_encode_round_trip(channels):
    """decode(encode(x)) == x, and PIL reads the encoding as x."""
    img = garment(3, 31, 19)
    x = img[..., 0] if channels == 0 else np.concatenate(
        [img, img], -1)[..., :channels]
    data = encode_png(x)
    np.testing.assert_array_equal(decode_png(data).reshape(x.shape), x)
    np.testing.assert_array_equal(
        np.asarray(Image.open(io.BytesIO(data))).reshape(x.shape), x)


def test_png_rejects_what_it_cannot_read():
    data = encode_png(garment(4, 8, 8))
    bad = bytearray(data)
    bad[40] ^= 0xFF  # inside the IDAT chunk
    with pytest.raises(ValueError, match="CRC"):
        decode_png(bytes(bad))
    with pytest.raises(ValueError, match="not a PNG"):
        decode_png(b"GIF89a" + data)
    sixteen = pil_png(np.arange(64, dtype=np.uint16).reshape(8, 8) * 999)
    with pytest.raises(ValueError, match="16-bit"):
        decode_png(sixteen)


def _random_rows(rng, h, row_bytes, kind=None):
    """Random filtered rows; filter `kind` on every row, or a random mix."""
    rows = rng.integers(0, 256, (h, 1 + row_bytes), dtype=np.uint8)
    rows[:, 0] = rng.integers(0, 5, h) if kind is None else kind
    return rows


@pytest.mark.parametrize("bpp", [1, 2, 3, 4])
def test_png_native_unfilter_matches_numpy(bpp):
    """The C++ unfilter gives the numpy one's bytes: every filter alone and
    a random mix per row, widths 1, even and odd, heights 1 and more."""
    lib = png._load()
    assert lib is not None and png.decoder() == "native"
    rng = np.random.default_rng(bpp)
    for w in (1, 2, 5, 33):
        for h in (1, 7):
            for kind in (0, 1, 2, 3, 4, None):
                rows = _random_rows(rng, h, w * bpp, kind)
                np.testing.assert_array_equal(
                    png._unfilter_native(lib, rows, bpp),
                    png._unfilter(rows, bpp))


@pytest.mark.parametrize("depth,ctype", [(1, 0), (2, 0), (4, 0), (4, 3),
                                         (8, 3)])
def test_png_sub_byte_and_palette_decode_alike_on_both_paths(
        depth, ctype, monkeypatch):
    """Gray at 1, 2 and 4 bits and palette files, odd width, random rows
    with a random mix of filters: the same pixels through the C++ unfilter
    and the numpy one."""
    rng = np.random.default_rng(depth + ctype)
    w, h = 13, 6
    rows = _random_rows(rng, h, (w * depth + 7) // 8)
    palette = (rng.integers(0, 256, (1 << depth, 3), dtype=np.uint8)
               if ctype == 3 else None)
    data = png_file(w, h, depth, ctype, rows.tobytes(), palette)
    native = decode_png(data)
    monkeypatch.setattr(png, "_load", lambda: None)
    assert png.decoder() == "numpy"
    np.testing.assert_array_equal(decode_png(data), native)


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_png_adaptive_filter_garment_matches_pil(path, monkeypatch):
    """A PIL-written garment (adaptive filters: Sub, Up and Paeth rows)
    decodes to PIL's pixels through the C++ unfilter, and through the
    numpy one where the library is unavailable."""
    img = garment(5, 120, 90)
    data = pil_png(img)
    raw = zlib.decompress(b"".join(body for kind, body in png._chunks(data)
                                   if kind == b"IDAT"))
    kinds = set(np.frombuffer(raw, np.uint8).reshape(120, -1)[:, 0])
    assert {1, 2, 4} <= kinds
    if path == "numpy":
        monkeypatch.setattr(png, "_load", lambda: None)
    assert png.decoder() == path
    np.testing.assert_array_equal(decode_png(data), img)
    np.testing.assert_array_equal(
        decode_png(data), np.asarray(Image.open(io.BytesIO(data))))


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_png_filter_above_four_raises_on_both_paths(path, monkeypatch):
    rows = np.zeros((3, 1 + 4 * 3), np.uint8)
    rows[1, 0] = 5
    data = png_file(4, 3, 8, 2, rows.tobytes())
    if path == "numpy":
        monkeypatch.setattr(png, "_load", lambda: None)
    with pytest.raises(ValueError, match="PNG row filter 5"):
        decode_png(data)


# ---------------------------------------------------------------------------
# Image preparation against the JAX package's (PIL)
# ---------------------------------------------------------------------------


def _levels(got, want, scale=1.0):
    """Max and mean |got - want| in uint8 levels."""
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    d = d * scale
    return float(d.max()), float(d.mean())


@pytest.fixture(scope="module")
def garment_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("garment") / "cloth.png"
    path.write_bytes(pil_png(garment(0)))
    return str(path)


def test_resize_img_matches_pil(garment_file):
    got = iu.resize_img(iu.read_image(garment_file))
    want = np.asarray(jiu.resize_img(Image.open(garment_file).convert("RGB")))
    assert got.shape == want.shape == (640, 448, 3)
    assert _levels(got, want)[0] <= PREP_LEVELS


@pytest.mark.parametrize("size", [(SIZE, SIZE, CLIP_SIZE), (640, 512, 224)])
def test_prepare_garment_matches_jax(garment_file, size):
    """The VAE view, the CLIP view and the resized garment within
    PREP_LEVELS uint8 levels of PIL's (measured on this garment: max 1,
    mean under 0.01 levels at both sizes)."""
    h, w, c = size
    got = iu.prepare_garment(garment_file, h, w, clip_size=c)
    want = jiu.prepare_garment(garment_file, h, w, clip_size=c)
    assert got[0].shape == want[0].shape == (1, h, w, 3)
    assert got[1].shape == want[1].shape == (1, c, c, 3)
    assert got[2].shape == np.asarray(want[2]).shape
    std = np.asarray((0.26862954, 0.26130258, 0.27577711)) * 255
    for view, g, wnt, scale in (("vae", got[0], want[0], 127.5),
                                ("clip", got[1], want[1], std),
                                ("resized", got[2], np.asarray(want[2]), 1.0)):
        worst, mean = _levels(g, wnt, scale)
        print(f"{view} {size}: max {worst:.3f} mean {mean:.5f} levels")
        assert worst <= PREP_LEVELS + 1e-3 and mean < 0.05, (worst, mean)


@pytest.mark.parametrize("hw", [(300, 500), (500, 300), (224, 224)])
def test_clip_preprocess_matches_jax(hw):
    img = garment(5, *hw)
    got, want = clip_preprocess_np(img), jax_clip_prep(img)
    assert got.shape == want.shape == (224, 224, 3)
    std = np.asarray((0.26862954, 0.26130258, 0.27577711)) * 255
    assert _levels(got, want, std)[0] <= PREP_LEVELS + 1e-3


def test_serve_garment_inputs_match_the_jax_handler(garment_file):
    """The server's preparation of an upload: the snap-to-64 resize, PIL's
    default (bicubic) resize to the preset's size, the CLIP view."""
    preset = PRESETS["basic"]
    ref, clip = serve.garment_inputs(iu.read_image(garment_file), preset, 224)
    cloth = jiu.resize_img(Image.open(garment_file).convert("RGB"))
    want_ref = np.asarray(cloth.resize((preset.width, preset.height)),
                          np.float32) / 127.5 - 1.0
    want_clip = jax_clip_prep(np.asarray(cloth), size=224)
    assert ref.shape == (1, 640, 512, 3) and clip.shape == (1, 224, 224, 3)
    assert _levels(ref[0], want_ref, 127.5)[0] <= PREP_LEVELS + 1e-3
    std = np.asarray((0.26862954, 0.26130258, 0.27577711)) * 255
    assert _levels(clip[0], want_clip, std)[0] <= PREP_LEVELS + 1e-3


def test_prepare_person_and_collage_match_jax(garment_file):
    got = iu.prepare_person(garment_file, 96, 80)
    want = jiu.prepare_person(garment_file, 96, 80)
    assert got.shape == want.shape
    assert _levels(got, want, 127.5)[0] <= PREP_LEVELS + 1e-3
    a, b = garment(6, 20, 10), garment(7, 20, 10)
    grid = iu.image_grid([a, b], 1, 2)
    want = jiu.image_grid([Image.fromarray(a), Image.fromarray(b)], 1, 2)
    np.testing.assert_array_equal(grid, np.asarray(want))


def test_jpeg_goes_through_pil_or_says_it_needs_it(tmp_path, monkeypatch):
    """JPEG (and every format but PNG) is read and written through PIL;
    without PIL, PNG still works and JPEG raises naming PIL."""
    img = garment(8, 40, 30)
    jpg = tmp_path / "g.jpg"
    Image.fromarray(img).save(jpg)
    np.testing.assert_array_equal(iu.read_image(str(jpg)),
                                  np.asarray(Image.open(jpg).convert("RGB")))
    iu.write_image(str(tmp_path / "out.jpg"), img)
    assert Image.open(tmp_path / "out.jpg").size == (30, 40)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError, match="PIL"):
        iu.read_image(str(jpg))
    with pytest.raises(RuntimeError, match="PIL"):
        iu.write_image(str(tmp_path / "x.jpg"), img)
    iu.write_image(str(tmp_path / "x.png"), img)
    np.testing.assert_array_equal(iu.read_image(str(tmp_path / "x.png")), img)


# ---------------------------------------------------------------------------
# The slice: files -> loader -> pipeline, against the JAX golden
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_files(tmp_path_factory):
    """(the stack, its files, a tokenizer dir with the tiny vocabulary)."""
    models = tiny_stack()
    root = tmp_path_factory.mktemp("tiny_ckpt")
    paths = write_checkpoints(models, str(root))
    write_vocab(os.path.join(paths["base_dir"], "tokenizer"))
    return models, paths


@pytest.fixture(scope="module")
def loaded(tiny_files):
    _, paths = tiny_files
    return load_dressing_models(
        **{k: v for k, v in paths.items() if k != "controlnet_path"},
        dtype=None, device="cpu", **CONFIGS)


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(GOLDEN))


def _preset(steps=STEPS):
    return dataclasses.replace(PRESETS["basic"], height=SIZE, width=SIZE,
                               num_inference_steps=steps)


def test_slice_matches_jax_golden(tiny_files, loaded, golden):
    """The port loads the files the golden's JAX run loaded and runs the
    golden's arrays at batch 2: within 2e-3 of JAX's images."""
    models, paths = tiny_files
    np.testing.assert_array_equal(
        fingerprint(models), golden["fingerprint"],
        err_msg="the seeded tiny stack changed: re-record the golden")
    tok = load_tokenizer(os.path.join(paths["base_dir"], "tokenizer"))
    np.testing.assert_array_equal(np.stack([tok(PROMPT)] * 2),
                                  golden["prompt_ids"])
    pipe = DressingPipeline(loaded, _preset(), device="cpu")
    out = pipe(prompt_ids=golden["prompt_ids"],
               negative_prompt_ids=golden["negative_prompt_ids"],
               ref_image=golden["ref_image"],
               ref_clip_image=golden["ref_clip_image"],
               latents=golden["latents"])
    assert out.shape == (2, SIZE, SIZE, 3) and out.dtype == np.float32
    np.testing.assert_allclose(out, golden["images"].astype(np.float32),
                               atol=2e-3)
    assert not np.array_equal(out[0], out[1])


def test_port_prep_of_the_golden_garments(golden, tmp_path):
    """The port's own preparation of the golden's garments within
    PREP_LEVELS of the arrays JAX (PIL) prepared."""
    std = np.asarray((0.26862954, 0.26130258, 0.27577711)) * 255
    for i in range(2):
        path = tmp_path / f"g{i}.png"
        path.write_bytes(pil_png(garment(10 + i)))
        ref, clip, _ = iu.prepare_garment(str(path), SIZE, SIZE, CLIP_SIZE)
        assert _levels(ref[0], golden["ref_image"][i], 127.5)[0] \
            <= PREP_LEVELS + 1e-3
        assert _levels(clip[0], golden["ref_clip_image"][i], std)[0] \
            <= PREP_LEVELS + 1e-3


# ---------------------------------------------------------------------------
# Apps behaviour (the JAX package's tests/test_serve.py, test_dress_cli.py)
# ---------------------------------------------------------------------------


class RecordingPipe:
    """A pipeline wrapper that records (batch, seed) of each call; the call
    numbered `hold` waits for `release` before it runs."""

    def __init__(self, pipe, hold=None):
        self.pipe, self.models = pipe, pipe.models
        self.calls, self.hold = [], hold
        self.entered, self.release = threading.Event(), threading.Event()

    def __call__(self, **kw):
        if len(self.calls) == self.hold:
            self.entered.set()
            assert self.release.wait(60)
        self.calls.append((kw["ref_image"].shape[0], kw["seed"]))
        return self.pipe(**kw)


def _payload(seed, i=0):
    return {"prompt": "x", "seed": seed,
            "ref_image": garment(i, SIZE, SIZE)[None].astype(np.float32)
            / 127.5 - 1.0,
            "ref_clip_image": clip_preprocess_np(garment(i, 70, 60),
                                                 CLIP_SIZE)[None]}


@pytest.fixture(scope="module")
def server(loaded):
    pipe = RecordingPipe(DressingPipeline(loaded, _preset(2), device="cpu"))
    worker = serve.InferenceWorker(pipe, HashTokenizer(256), max_batch=2)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                serve.make_handler(worker, _preset(2)))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield httpd.server_address[1], pipe
    httpd.shutdown()
    t.join(10)


def _post(port, path, body, ctype):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.status, resp.read()


def test_dress_endpoint_json(server):
    port, pipe = server
    body = json.dumps({"prompt": "a dress", "steps": 2, "seed": 1,
                       "cloth_image": base64.b64encode(
                           pil_png(garment(0, 96, 72))).decode()}).encode()
    status, raw = _post(port, "/dress", body, "application/json")
    out = json.loads(raw)
    assert status == 200 and out["latency_s"] > 0
    img = decode_png(base64.b64decode(out["image"]))
    assert img.shape == (SIZE, SIZE, 3) and img.dtype == np.uint8
    assert pipe.calls[-1] == (1, 1)


def test_dress_form_and_index(server):
    port, _ = server
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=30) as r:
        assert "IMAGDressing" in r.read().decode()
    boundary = "xyzBOUNDARY"
    parts = [("seed", b"3"), ("steps", b"2"), ("prompt", b"a shirt")]
    body = b"".join(
        f"--{boundary}\r\nContent-Disposition: form-data; name=\"{k}\"\r\n"
        f"\r\n".encode() + v + b"\r\n" for k, v in parts)
    body += (f"--{boundary}\r\nContent-Disposition: form-data; name=\"cloth\";"
             f" filename=\"c.png\"\r\nContent-Type: image/png\r\n\r\n"
             ).encode() + pil_png(garment(1, 80, 64)) + b"\r\n"
    body += f"--{boundary}--\r\n".encode()
    status, raw = _post(port, "/dress_form", body,
                        f"multipart/form-data; boundary={boundary}")
    assert status == 200 and b"data:image/png;base64," in raw


@pytest.mark.parametrize("path,body,code", [
    ("/dress", b"not json", 400),
    ("/dress", json.dumps({"prompt": "no cloth"}).encode(), 400),
    ("/dress", json.dumps({"cloth_image": "aGVsbG8="}).encode(), 400),
    ("/nowhere", b"{}", 404)])
def test_bad_requests_are_4xx(server, path, body, code):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server[0], path, body, "application/json")
    assert e.value.code == code


def _wait(cond, timeout=60):
    t0 = time.monotonic()
    while not cond():
        assert time.monotonic() - t0 < timeout
        time.sleep(0.005)


def test_worker_batches_one_key_and_splits_others(loaded):
    """Queued behind a running call: two requests of one key run as one
    batch-2 call, bit-equal to a direct call on the same arrays; a request
    with another seed runs in its own round."""
    direct = DressingPipeline(loaded, _preset(2), device="cpu")
    pipe = RecordingPipe(direct, hold=0)
    worker = serve.InferenceWorker(pipe, HashTokenizer(256), max_batch=2)
    results = {}

    def submit(name, payload):
        results[name] = worker.submit(payload)

    threads = []
    for n, (name, seed, i) in enumerate([("a", 1, 0), ("b", 2, 1),
                                         ("c", 2, 2), ("d", 3, 3)]):
        threads.append(threading.Thread(target=submit,
                                        args=(name, _payload(seed, i))))
        threads[-1].start()
        if n == 0:
            assert pipe.entered.wait(60)
        else:  # queue them in order behind the held call
            _wait(lambda n=n: worker.queue.qsize() == n)
    pipe.release.set()
    for t in threads:
        t.join(120)
        assert not t.is_alive()
    assert pipe.calls == [(1, 1), (2, 2), (1, 3)]
    tok = HashTokenizer(256)
    both = [_payload(2, 1), _payload(2, 2)]
    want = direct(prompt_ids=np.stack([tok("x")] * 2),
                  negative_prompt_ids=np.stack(
                      [tok(iu.DEFAULT_NEGATIVE)] * 2),
                  ref_image=np.concatenate([p["ref_image"] for p in both]),
                  ref_clip_image=np.concatenate(
                      [p["ref_clip_image"] for p in both]),
                  seed=2, output_uint8=True)
    np.testing.assert_array_equal(results["b"]["image"], want[0])
    np.testing.assert_array_equal(results["c"]["image"], want[1])


def _cpu_profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def test_image_spans_count_the_files_bytes(tmp_path):
    """Under a profiler: `image.write` and `image.read` carry the file's
    bytes (and the pixels read); `image.prepare_garment` encloses its read
    and resizes."""
    path = str(tmp_path / "g.png")
    profiling.clear()
    with _cpu_profile():
        iu.write_image(path, garment(0, 90, 70))
        iu.prepare_garment(path, SIZE, SIZE, clip_size=CLIP_SIZE)
    spans = profiling.spans()
    profiling.clear()
    size = os.path.getsize(path)
    by = {s["name"]: s for s in spans}
    assert by["image.write"]["attrs"] == {"bytes": size}
    assert by["image.read"]["attrs"] == {"bytes": size, "pixels": 90 * 70,
                                         "decoder": "native"}
    prep = by["image.prepare_garment"]
    resizes = [s for s in spans if s["name"] == "image.resize"]
    assert len(resizes) == 4  # resize_img's two, the VAE and CLIP views
    assert {s["parent"] for s in resizes + [by["image.read"]]} == {prep["id"]}
    assert ((SIZE, SIZE) in [s["attrs"]["out_size"] for s in resizes])
    assert by["image.write"]["parent"] is None


@pytest.mark.parametrize("decoder", ["native", "numpy", "pil"])
def test_read_image_records_its_decoder(decoder, monkeypatch):
    """`image.read`'s `decoder`: the C++ unfilter, the numpy fallback
    (library unavailable) or PIL (not a PNG)."""
    img = garment(6, 16, 12)
    data = encode_png(img)
    if decoder == "numpy":
        monkeypatch.setattr(png, "_load", lambda: None)
    elif decoder == "pil":
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="BMP")
        data = buf.getvalue()
    profiling.clear()
    with _cpu_profile():
        np.testing.assert_array_equal(iu.read_image(data), img)
    reads = [s for s in profiling.spans() if s["name"] == "image.read"]
    profiling.clear()
    assert [s["attrs"]["decoder"] for s in reads] == [decoder]


class _StubPipe:
    models = None

    def __call__(self, **kw):
        return np.zeros((kw["ref_image"].shape[0], 8, 8, 3), np.uint8)


def test_a_served_request_shares_its_trace_id():
    """The worker's `serve.queue` (put to the round's start) and
    `serve.round` spans of one request carry its trace_id."""
    worker = serve.InferenceWorker(_StubPipe(), HashTokenizer(256),
                                   max_batch=2)
    profiling.clear()
    with _cpu_profile():
        result = worker.submit(_payload(1), trace_id=41)
    assert result["image"].shape == (8, 8, 3)
    _wait(lambda: any(s["name"] == "serve.round"
                      for s in profiling.spans()))
    by = {s["name"]: s for s in profiling.spans()}
    profiling.clear()
    queue, round_ = by["serve.queue"], by["serve.round"]
    assert queue["trace_id"] == round_["trace_id"] == 41
    assert round_["attrs"] == {"batch": 1, "trace_ids": [41]}
    assert queue["t0"] <= queue["t1"] <= round_["t0"] <= round_["t1"]


def _invert(img01, payload):
    """Toy post-process standing in for the face-fusion hook."""
    return 1.0 - img01


def test_post_process_hook(loaded):
    pipe = DressingPipeline(loaded, _preset(2), device="cpu")
    plain = serve.InferenceWorker(pipe, HashTokenizer(256), max_batch=1)
    hooked = serve.InferenceWorker(pipe, HashTokenizer(256), max_batch=1,
                                   post_process=_invert)
    a, b = plain.submit(_payload(1)), hooked.submit(_payload(1))
    assert a["image"].dtype == b["image"].dtype == np.uint8
    np.testing.assert_array_equal(b["image"], 255 - a["image"])


def test_post_process_specs_and_gradio():
    fn = serve.load_post_process("os.path:join")
    assert fn("a", "b").endswith("b")
    with pytest.raises(ValueError, match="module:function"):
        serve.load_post_process("os.path.join")
    with pytest.raises(ValueError, match="FaceNet weight path"):
        serve.load_post_process("face_fusion:")
    try:
        import gradio  # noqa: F401
    except ImportError:
        with pytest.raises(RuntimeError, match="gradio"):
            serve.run_gradio(None, None, 7860)


def test_serve_main_needs_a_card_or_cpu_and_one_device(tiny_files):
    _, paths = tiny_files
    args = ["--base_dir", paths["base_dir"], "--vae_path", paths["vae_path"],
            "--image_encoder_path", paths["image_encoder_path"],
            "--model_ckpt", paths["model_ckpt"]]
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(SystemExit, match=f"needs {n + 2} GPUs; {n} visible"):
        serve.main(args + ["--data_parallel", str(n + 2)])
    with pytest.raises(SystemExit, match=f"needs {n + 2} GPUs; {n} visible"):
        serve.main(args + ["--tensor_parallel", str(n + 2)])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serve.main(args)


def test_write_checkpoints_cli_draws_on_the_card_unless_asked(tmp_path,
                                                             capsys):
    """The writer's CLI draws its stack on the card by default (raising on a
    host without one) and on the CPU when asked; it prints the loader's
    path flags."""
    out = tmp_path / "ckpt"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            wc_mod.main(["--out", str(out), "--small"])
    wc_mod.main(["--out", str(out), "--small", "--device", "cpu"])
    flags = dict(line.split(" ", 1)
                 for line in capsys.readouterr().out.splitlines())
    assert sorted(flags) == ["--base_dir", "--image_encoder_path",
                             "--model_ckpt", "--vae_path"]
    assert all(os.path.exists(v) for v in flags.values())


@pytest.fixture()
def cli(tiny_files, monkeypatch):
    """`dress.main` with the tiny configs and a tokenizer inside the tiny
    vocabulary of the text model (as the JAX CLI tests stub them); returns
    (run(argv), the pipeline calls' batch sizes)."""
    _, paths = tiny_files
    real = loader_mod.load_dressing_models
    monkeypatch.setattr(loader_mod, "load_dressing_models",
                        functools.partial(real, **CONFIGS))
    monkeypatch.setattr(tok_mod, "load_tokenizer",
                        lambda path, max_length=77: HashTokenizer(256))
    batches = []
    call = DressingPipeline.__call__

    def recording(self, **kw):
        batches.append(kw["ref_image"].shape[0])
        return call(self, **kw)

    monkeypatch.setattr(DressingPipeline, "__call__", recording)
    base = ["--base_dir", paths["base_dir"], "--vae_path", paths["vae_path"],
            "--image_encoder_path", paths["image_encoder_path"],
            "--model_ckpt", paths["model_ckpt"], "--height", str(SIZE),
            "--width", str(SIZE), "--num_inference_steps", "2"]
    return (lambda argv: dress.main(base + argv)), batches, paths


def test_dress_cli_basic(cli, tmp_path):
    """[garment | result] collage under the garment's name; the result is
    the pipeline's image for the prepared garment, nothing added."""
    run, batches, _ = cli
    cloth = tmp_path / "shirt.png"
    cloth.write_bytes(pil_png(garment(0)))
    out = tmp_path / "out"
    run(["--cloth_path", str(cloth), "--output_path", str(out),
         "--seed", "3", "--device", "cpu"])
    collage = iu.read_image(str(out / "shirt.png"))
    assert collage.shape == (SIZE, 2 * SIZE, 3) and batches == [1]
    ref, clip, resized = iu.prepare_garment(str(cloth), SIZE, SIZE,
                                            CLIP_SIZE)
    np.testing.assert_array_equal(
        collage[:, :SIZE], iu.resize(resized, (SIZE, SIZE), "bicubic"))
    loaded = load_dressing_models(
        **{k: v for k, v in cli[2].items() if k != "controlnet_path"},
        device="cpu", **CONFIGS)
    tok = HashTokenizer(256)
    want = DressingPipeline(loaded, _preset(2), device="cpu")(
        prompt_ids=tok(iu.DEFAULT_PROMPT)[None],
        negative_prompt_ids=tok(iu.DEFAULT_NEGATIVE)[None], ref_image=ref,
        ref_clip_image=clip, seed=3)
    np.testing.assert_array_equal(collage[:, SIZE:], iu.to_uint8(want)[0])


def test_dress_cli_folder_pads_the_ragged_chunk(cli, tmp_path):
    """3 garments at batch 2: two batch-2 calls (the last padded), three
    collages; JPEG garments go through PIL here."""
    run, batches, _ = cli
    folder = tmp_path / "garments"
    folder.mkdir()
    for i, name in enumerate(("a.jpg", "b.png", "c.jpg")):
        Image.fromarray(garment(i, 120, 90)).save(folder / name)
    out = tmp_path / "out"
    run(["--cloth_dir", str(folder), "--batch_size", "2", "--output_path",
         str(out), "--device", "cpu"])
    assert sorted(os.listdir(out)) == ["a.jpg", "b.png", "c.jpg"]
    assert batches == [2, 2]
    assert iu.read_image(str(out / "b.png")).shape == (SIZE, 2 * SIZE, 3)


def test_dress_cli_pose_cross_product(cli, tmp_path):
    """--pose_dir x --cloth_dir: factor-major grid, f"{pose}_{cloth}.png"
    names, batched through the device batch dimension."""
    run, batches, paths = cli
    cloth_dir, pose_dir = tmp_path / "garments", tmp_path / "poses"
    cloth_dir.mkdir()
    pose_dir.mkdir()
    for i, name in enumerate(("a.png", "b.png")):
        (cloth_dir / name).write_bytes(pil_png(garment(i, 100, 80)))
        (pose_dir / f"p{i + 1}.png").write_bytes(
            pil_png(garment(5 + i, 90, 90)))
    out = tmp_path / "out"
    run(["--preset", "pose", "--controlnet_path", paths["controlnet_path"],
         "--cloth_dir", str(cloth_dir), "--pose_dir", str(pose_dir),
         "--batch_size", "2", "--output_path", str(out), "--device", "cpu"])
    assert sorted(os.listdir(out)) == ["p1_a.png", "p1_b.png", "p2_a.png",
                                       "p2_b.png"]
    assert batches == [2, 2]


def test_dress_cli_refusals(cli, tmp_path):
    """Without --device cpu on a host without a card, the CLI raises; a
    --trained_ckpt directory without checkpoints raises FileNotFoundError;
    CPU ranks need --allow_cpu_mesh."""
    run, _, _ = cli
    cloth = tmp_path / "shirt.png"
    cloth.write_bytes(pil_png(garment(0, 64, 64)))
    base = ["--cloth_path", str(cloth), "--output_path", str(tmp_path / "o")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run(base)
    with pytest.raises(FileNotFoundError, match="no training checkpoint"):
        run(base + ["--trained_ckpt", str(tmp_path / "ckpt"), "--device",
                    "cpu"])
    with pytest.raises(SystemExit, match="allow_cpu_mesh"):
        run(base + ["--data_parallel", "2", "--device", "cpu"])


def test_dress_cli_inpaint_model_dir(cli, tmp_path, monkeypatch):
    """--preset inpaint --model_dir x --cloth_dir with OpenPose and the
    parser stubbed (their defaults are the full-width nets): person-major
    f"{person}_{cloth}.png" names, each person prepared once, and the
    arrays each pipeline call gets are the person photo in [-1, 1], its
    upper-body mask and the inpaint condition built from both."""
    from imagdressing_tpu_torch.preprocess import mask as pmask
    from imagdressing_tpu_torch.preprocess.openpose import OpenPose
    from imagdressing_tpu_torch.preprocess.parsing.infer import Parsing

    run, batches, paths = cli
    cloth_dir, person_dir = tmp_path / "garments", tmp_path / "people"
    cloth_dir.mkdir()
    person_dir.mkdir()
    for i, name in enumerate(("a.png", "b.png")):
        (cloth_dir / name).write_bytes(pil_png(garment(i, 100, 80)))
        (person_dir / f"m{i + 1}.png").write_bytes(
            pil_png(garment(7 + i, 120, 90)))
    kps = np.zeros((18, 2))
    kps[[2, 3, 4, 5, 6, 7]] = [[250, 130], [270, 210], [280, 290],
                               [130, 130], [110, 210], [100, 290]]
    calls = []

    def pose(img):
        calls.append(("pose", img.shape))
        return {"pose_keypoints_2d": kps.tolist()}

    def parser(img):
        calls.append(("parse", img.shape))
        parse = np.zeros(img.shape[:2], np.uint8)
        h, w = parse.shape
        parse[h // 4:3 * h // 4, w // 4:3 * w // 4] = 4
        parse[:h // 6, w // 3:2 * w // 3] = 11
        return parse, (parse == 11).astype(np.float32)

    monkeypatch.setattr(OpenPose, "get_default",
                        classmethod(lambda cls, device="cuda": pose))
    monkeypatch.setattr(Parsing, "get_default",
                        classmethod(lambda cls, device="cuda": parser))
    seen = []
    call = DressingPipeline.__call__

    def recording(self, **kw):
        seen.append({k: kw[k] for k in ("person_image", "mask_image",
                                        "pose_image")})
        return call(self, **kw)

    monkeypatch.setattr(DressingPipeline, "__call__", recording)
    out = tmp_path / "out"
    run(["--preset", "inpaint", "--controlnet_path", paths["controlnet_path"],
         "--cloth_dir", str(cloth_dir), "--model_dir", str(person_dir),
         "--batch_size", "2", "--output_path", str(out), "--device", "cpu"])
    assert sorted(os.listdir(out)) == ["m1_a.png", "m1_b.png", "m2_a.png",
                                       "m2_b.png"]
    assert calls == [("pose", (512, 384, 3)), ("parse", (120, 90, 3))] * 2
    assert [kw["person_image"].shape[0] for kw in seen] == [2, 2]
    for k, person in enumerate(("m1", "m2")):
        path = str(person_dir / f"{person}.png")
        want_person = iu.prepare_person(path, SIZE, SIZE)
        want_mask = pmask.person_upper_body_mask(path, SIZE, SIZE,
                                                 device="cpu")
        want_cond = pmask.make_inpaint_condition(
            (want_person[0] + 1) / 2, want_mask[0, ..., 0])
        assert 0 < want_mask.sum() < SIZE * SIZE
        for row in range(2):  # both garments of this person, one call
            np.testing.assert_array_equal(
                seen[k]["person_image"][row:row + 1], want_person)
            np.testing.assert_array_equal(
                seen[k]["mask_image"][row:row + 1], want_mask)
            np.testing.assert_array_equal(
                seen[k]["pose_image"][row:row + 1], want_cond)
    assert iu.read_image(str(out / "m2_b.png")).shape == (SIZE, 2 * SIZE, 3)


def test_face_fusion_post_process_from_a_written_facenet(tmp_path):
    """`load_post_process("face_fusion:<facenet.pth>")` on a FaceNet file
    written in the reference's key layout: on the CPU when asked (on a host
    without a card, raising otherwise); a request without `fusion_face`
    passes through, one with a face gets the template back where the
    random net finds fewer than 3 landmarks, as FaceFusion's rule has it."""
    from imagdressing_tpu_torch.preprocess.openpose.face import FaceNet

    path = str(tmp_path / "facenet.pth")
    torch.save({f"model.{k}": v.contiguous() for k, v in
                FaceNet.init_random(0, "cpu").state_dict().items()}, path)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serve.load_post_process(f"face_fusion:{path}")
    post = serve.load_post_process(f"face_fusion:{path}", "cpu")
    img = garment(3, 64, 48).astype(np.float32) / 255.0
    np.testing.assert_array_equal(post(img, {}), img)
    face = base64.b64encode(encode_png(garment(4, 40, 32))).decode()
    out = post(img, {"fusion_face": face})
    assert out.shape == img.shape and np.isfinite(out).all()


def test_write_checkpoints_preprocess_round_trip(tmp_path, capsys):
    """`write_checkpoints --preprocess`: the OpenPose body / hand / face
    nets and the SCHP pair written in the reference's layouts load back
    through the port's loaders bit for bit; it prints the environment
    variables the person path reads and the face-fusion flag."""
    from imagdressing_tpu_torch.preprocess.openpose import OpenPose
    from imagdressing_tpu_torch.preprocess.openpose.face import Face, FaceNet
    from imagdressing_tpu_torch.preprocess.openpose.hand import (
        Hand,
        HandPoseNet,
    )
    from imagdressing_tpu_torch.preprocess.openpose.model import BodyPoseNet
    from imagdressing_tpu_torch.preprocess.parsing import model as schp
    from imagdressing_tpu_torch.preprocess.parsing.infer import Parsing

    wc_mod.main(["--out", str(tmp_path), "--small", "--device", "cpu",
                 "--preprocess", "--seed", "3"])
    lines = capsys.readouterr().out.splitlines()
    env = dict(line.split("=", 1) for line in lines
               if line.startswith("IMAGDRESSING_"))
    assert sorted(env) == ["IMAGDRESSING_ATR_CKPT", "IMAGDRESSING_LIP_CKPT",
                           "IMAGDRESSING_OPENPOSE_CKPT"]
    facenet = [ln.split("face_fusion:", 1)[1] for ln in lines
               if ln.startswith("--post_process face_fusion:")]
    assert len(facenet) == 1
    hand_path = os.path.join(os.path.dirname(facenet[0]),
                             "hand_pose_model.pth")

    def same(module, want):
        have = module.state_dict()
        assert have.keys() == want.keys()
        for k, v in want.items():
            assert torch.equal(have[k], v), k

    same(OpenPose.from_torch(env["IMAGDRESSING_OPENPOSE_CKPT"], "cpu").net,
         BodyPoseNet.init_random(3, "cpu").state_dict())
    same(Hand.from_torch(hand_path, "cpu").net,
         HandPoseNet.init_random(4, "cpu").state_dict())
    same(Face.from_torch(facenet[0], "cpu").net,
         FaceNet.init_random(5, "cpu").state_dict())
    parsing = Parsing.from_torch(env["IMAGDRESSING_ATR_CKPT"],
                                 env["IMAGDRESSING_LIP_CKPT"], "cpu")
    same(parsing.atr, schp.init(6, schp.NUM_CLASSES_ATR, "cpu").state_dict())
    same(parsing.lip, schp.init(7, schp.NUM_CLASSES_LIP, "cpu").state_dict())


# ---------------------------------------------------------------------------
# The golden
# ---------------------------------------------------------------------------


def record_apps_golden():
    """The JAX package on the tiny stack's files: its loader, its tokenizer
    (the tiny vocabulary), PIL's preparation of two seeded garments and its
    jitted `DressingPipeline` at batch 2 with seeded latents."""
    import jax

    from imagdressing_tpu.apps import loader as jloader
    from imagdressing_tpu.core import config as jcfg
    from imagdressing_tpu.core.config import PRESETS as JAX_PRESETS
    from imagdressing_tpu.pipelines.dressing import DressingPipeline as JaxPipe

    classes = dict(unet_cfg=jcfg.UNetConfig, vae_cfg=jcfg.VAEConfig,
                   text_cfg=jcfg.CLIPTextConfig,
                   vision_cfg=jcfg.CLIPVisionConfig,
                   resampler_cfg=jcfg.ResamplerConfig,
                   projplus_cfg=jcfg.ProjPlusConfig)
    jax_cfgs = {k: classes[k](**dataclasses.asdict(v))
                for k, v in CONFIGS.items()}
    models = tiny_stack()
    with tempfile.TemporaryDirectory() as root:
        paths = write_checkpoints(models, root)
        write_vocab(os.path.join(root, "vocab"))
        jm = jloader.load_dressing_models(
            base_dir=paths["base_dir"], vae_path=paths["vae_path"],
            image_encoder_path=paths["image_encoder_path"],
            model_ckpt=paths["model_ckpt"], dtype=None, **jax_cfgs)
        tok = JaxCLIPTokenizer.from_dir(os.path.join(root, "vocab"))
        prepped = []
        for i in range(2):
            path = os.path.join(root, f"g{i}.png")
            with open(path, "wb") as f:
                f.write(pil_png(garment(10 + i)))
            prepped.append(jiu.prepare_garment(path, SIZE, SIZE,
                                               clip_size=CLIP_SIZE))
    arrays = dict(
        prompt_ids=np.stack([tok(PROMPT)] * 2),
        negative_prompt_ids=np.stack([tok(NEGATIVE)] * 2),
        ref_image=np.concatenate([p[0] for p in prepped]),
        ref_clip_image=np.concatenate([p[1] for p in prepped]),
        latents=np.random.default_rng(7).standard_normal(
            (2, SIZE // 8, SIZE // 8, 4)).astype(np.float32))
    preset = dataclasses.replace(JAX_PRESETS["basic"], height=SIZE,
                                 width=SIZE, num_inference_steps=STEPS)
    images = np.asarray(jax.device_get(JaxPipe(jm, preset)(**arrays)))
    return dict(arrays, images=images.astype(np.float16),
                fingerprint=fingerprint(models))


if __name__ == "__main__":
    import jax

    # the settings tests/conftest.py gives the suite
    os.environ.setdefault("IMAGDRESSING_DISABLE_PALLAS", "1")
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_threefry_partitionable", True)
    np.savez_compressed(GOLDEN, **record_apps_golden())
    print("wrote", GOLDEN, os.path.getsize(GOLDEN), "bytes")
