"""The port's training data pipeline, trackers and step timer against the JAX
package: `IGPairDataset.get` on the same manifest and seed (the C++ decode
and resize path exact; the path without it within 1 uint8 level),
`shard_epoch_indices`, `data_iterator`'s order and error path, the C++
runtime itself, the TensorBoard event bytes, `make_tracker`, `StepTimer`.

Images are made with numpy from a seed; no model runs here.
"""

import json
import os
import struct

import numpy as np
import pytest
from PIL import Image

from imagdressing_tpu.apps.tokenizer import HashTokenizer as JaxHashTokenizer
from imagdressing_tpu.runtime import native as jnative
from imagdressing_tpu.train import data as jdata
from imagdressing_tpu.train import trackers as jtrackers
from imagdressing_tpu_torch.apps.tokenizer import HashTokenizer
from imagdressing_tpu_torch.core import profiling
from imagdressing_tpu_torch.models.clip import CLIP_IMAGE_STD
from imagdressing_tpu_torch.runtime import native
from imagdressing_tpu_torch.train import data as tdata
from imagdressing_tpu_torch.train import trackers

# one uint8 level after each view's normalisation: the VAE views map
# [0, 255] to [-1, 1], the CLIP view divides by 255 and the channel std
VAE_LEVEL = 1.0 / 127.5
CLIP_LEVEL = 1.0 / (255.0 * min(CLIP_IMAGE_STD))
# dropout probabilities high enough that a few samples hit every branch
PROBS = dict(drop_image_prob=0.25, drop_text_prob=0.25, drop_both_prob=0.25)


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    """Five person / garment pairs of 96x80 JPEGs, one garment a PNG."""
    root = tmp_path_factory.mktemp("igpair")
    rng = np.random.default_rng(0)
    items = []
    for i in range(5):
        names = []
        for kind in ("person", "cloth"):
            img = rng.integers(0, 255, (96, 80, 3), dtype=np.uint8)
            ext = "png" if (i, kind) == (3, "cloth") else "jpg"
            name = f"{kind}{i}.{ext}"
            Image.fromarray(img).save(root / name)
            names.append(name)
        items.append({"image_file": names[0], "cloth_file": names[1],
                      "text": ["a red dress", "red summer dress", "a coat"]})
    path = root / "manifest.json"
    path.write_text(json.dumps(items))
    return str(path), str(root)


def _datasets(manifest, **kw):
    path, root = manifest
    want = jdata.IGPairDataset(path, JaxHashTokenizer(256), image_root=root,
                               seed=7, **PROBS, **kw)
    got = tdata.IGPairDataset(path, HashTokenizer(256), image_root=root,
                              seed=7, **PROBS, **kw)
    return want, got


SAMPLES = [(i, e) for e in range(3) for i in range(5)]


def _branch(sample, null_ids):
    image = not sample["cloth_clip"].any()
    text = np.array_equal(sample["text_ids"], null_ids)
    return image, text


def test_igpair_get_native_path_equals_jax(manifest):
    """The C++ decode + resize + crop (both packages build the same source):
    equal arrays for every (idx, epoch), crop offsets, caption and dropout
    drawn alike; every dropout branch is hit."""
    assert native.available() and jnative.available()
    want_ds, got_ds = _datasets(manifest, size=64, crop_h=64, crop_w=48)
    null = HashTokenizer(256)("")
    branches = set()
    for idx, epoch in SAMPLES:
        want, got = want_ds.get(idx, epoch), got_ds.get(idx, epoch)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        branches.add(_branch(got, null))
    assert branches == {(False, False), (True, False), (False, True),
                        (True, True)}
    assert got["person_image"].shape == (64, 48, 3)
    assert got["cloth_clip"].shape == (224, 224, 3)


def test_igpair_get_without_native_is_within_a_level(manifest, monkeypatch):
    """Without the C++ runtime, JAX resizes with PIL and the port with
    `train.data.resize` (F.interpolate, antialias): every VAE-view pixel
    within 1 uint8 level, the bicubic CLIP view within 1 level; the draws
    (crop offsets, including the reflect-padded crop where the resize is
    shorter than the crop, caption, dropout) equal."""
    monkeypatch.setattr(jnative, "_load", lambda: None)
    monkeypatch.setattr(native, "_load", lambda: None)
    for kw in (dict(size=64, crop_h=64, crop_w=48),
               dict(size=64, crop_h=80, crop_w=72)):  # reflect pad
        want_ds, got_ds = _datasets(manifest, **kw)
        for idx, epoch in SAMPLES[:8]:
            want, got = want_ds.get(idx, epoch), got_ds.get(idx, epoch)
            np.testing.assert_array_equal(got["text_ids"], want["text_ids"])
            for k, level in (("person_image", VAE_LEVEL),
                             ("cloth_image", VAE_LEVEL),
                             ("cloth_clip", CLIP_LEVEL)):
                assert got[k].shape == want[k].shape, k
                np.testing.assert_allclose(got[k], want[k], rtol=0,
                                           atol=level * 1.0001, err_msg=k)


def test_native_runtime_equals_jax(manifest):
    """jpeg_decode, resize_crop_normalize, clip_preprocess and resized_dims
    of the port's build against the JAX package's, on a decoded JPEG."""
    _, root = manifest
    data = open(os.path.join(root, "person1.jpg"), "rb").read()
    img = native.jpeg_decode(data)
    np.testing.assert_array_equal(img, jnative.jpeg_decode(data))
    np.testing.assert_array_equal(img, np.asarray(Image.open(
        os.path.join(root, "person1.jpg")).convert("RGB")))
    assert native.jpeg_decode(b"not a jpeg") is None
    for size, top, left, ch, cw in [(64, 5, 3, 64, 48), (80, 0, 0, 96, 80),
                                    (40, 7, 0, 40, 40)]:
        np.testing.assert_array_equal(
            native.resize_crop_normalize(img, size, top, left, ch, cw),
            jnative.resize_crop_normalize(img, size, top, left, ch, cw))
    assert native.resize_crop_normalize(img, 64, 50, 0, 64, 48) is None
    np.testing.assert_array_equal(native.clip_preprocess(img),
                                  jnative.clip_preprocess(img))
    for hw in [(96, 80), (80, 96), (7, 300)]:
        assert native.resized_dims(*hw, 64) == jnative.resized_dims(*hw, 64)


@pytest.mark.parametrize("n", [0, 1, 5, 12, 13])
def test_shard_epoch_indices_equal_jax(n):
    """Every rank of (N, process count, batch), N = 13, pc = 4, bs = 1
    among them: the JAX package's indices, and every rank the same
    number of batches."""
    order = np.random.default_rng(n).permutation(n)
    for pc in (1, 2, 4):
        for bs in (1, 2, 3):
            lens = set()
            for pi in range(pc):
                got = tdata.shard_epoch_indices(order, pi, pc, bs)
                want = jdata.shard_epoch_indices(order, pi, pc, bs)
                np.testing.assert_array_equal(got, want)
                lens.add(len(got))
            assert len(lens) == 1 and lens.pop() % bs == 0


class _Indices:
    """A dataset of n samples that are their own (index, epoch)."""

    def __init__(self, n, fail_at=None):
        self.n, self.fail_at = n, fail_at

    def __len__(self):
        return self.n

    def get(self, idx, epoch=0):
        if idx == self.fail_at:
            raise ValueError(f"bad sample {idx}")
        return {"idx": np.asarray(idx), "epoch": np.asarray(epoch)}


def _take(it, k):
    out = [next(it) for _ in range(k)]
    it.close()
    return [(b["idx"].tolist(), b["epoch"].tolist()) for b in out]


def test_data_iterator_order_equals_jax():
    """Two epochs of 5 samples in batches of 2 (3 batches an epoch, the
    last wrap-padded), shuffled per epoch from the seed, and a rank of two:
    the JAX package's batches in its order."""
    for kw in (dict(), dict(process_index=1, process_count=2)):
        got = _take(tdata.data_iterator(_Indices(5), 2, seed=3,
                                        num_workers=2, **kw), 6)
        want = _take(jdata.data_iterator(_Indices(5), 2, seed=3,
                                         num_workers=2, **kw), 6)
        assert got == want
    assert [e for _, e in got] == [[0, 0]] * 2 + [[1, 1]] * 2 + [[2, 2]] * 2


def test_data_iterator_raises_the_producers_error():
    """A sample that fails to load raises in the consumer, not a hang."""
    it = tdata.data_iterator(_Indices(4, fail_at=2), 1, shuffle=False,
                             num_workers=1)
    assert next(it)["idx"] == 0 and next(it)["idx"] == 1
    with pytest.raises(ValueError, match="bad sample 2"):
        next(it)


def test_crc32c_known_answer():
    assert trackers.crc32c(b"123456789") == 0xE3069283  # RFC 3720
    assert trackers.crc32c(b"") == 0


def test_tensorboard_events_equal_jax_bytes(tmp_path, monkeypatch):
    """The same logs at the same wall times give the JAX writer's bytes
    (TFRecord framing, masked CRC32C, Event / Summary wire format)."""
    paths = []
    for mod, sub in ((jtrackers, "jax"), (trackers, "port")):
        clock = iter([1700000000.25, 1700000001.5, 1700000002.75,
                      1700000003.0])
        monkeypatch.setattr(mod.time, "time", lambda c=clock: next(c))
        tb = mod.TensorBoardTracker(str(tmp_path / sub))
        tb.log(3, {"loss": 0.5, "grad_norm": 1.25, "note": "skipped"})
        tb.log(4, {"loss": 0.25, "step": 4, "images_per_sec": 3})
        tb.close()
        paths.append(tb.path)
    assert os.path.basename(paths[0]) == os.path.basename(paths[1])
    data = open(paths[1], "rb").read()
    assert data == open(paths[0], "rb").read()
    (length,) = struct.unpack("<Q", data[:8])
    assert struct.unpack("<I", data[8:12])[0] == \
        trackers._masked_crc(data[:8])
    assert b"brain.Event:2" in data[12:12 + length]


@pytest.mark.parametrize("report_to,tb_files", [("jsonl", 0),
                                                ("tensorboard", 1),
                                                ("all", 1)])
def test_make_tracker_sinks(tmp_path, report_to, tb_files):
    t = trackers.make_tracker(report_to, str(tmp_path))
    t.log(1, {"loss": 2.0})
    t.log(2, {"loss": 1.5})
    t.close()
    lines = [json.loads(ln) for ln in
             (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert lines == [{"loss": 2.0, "step": 1}, {"loss": 1.5, "step": 2}]
    logs = tmp_path / "logs"
    found = os.listdir(logs) if logs.exists() else []
    assert len([f for f in found if f.startswith("events.out.tfevents.")]) \
        == tb_files


def test_make_tracker_refuses_missing_packages(tmp_path):
    """Without wandb / comet_ml the refusal points at PARITY.md, as JAX's."""
    for sink in ("wandb", "comet"):
        with pytest.raises(ValueError, match="PARITY.md") as e:
            trackers.make_tracker(sink, str(tmp_path))
        with pytest.raises(ValueError) as je:
            jtrackers.make_tracker(sink, str(tmp_path / "jax"))
        assert str(e.value) == str(je.value)


def test_step_timer_splits_data_and_step_time(monkeypatch):
    clock = iter([10.0, 10.5, 12.0, 12.25, 13.0])
    monkeypatch.setattr(profiling.time, "perf_counter", lambda: next(clock))
    timer = profiling.StepTimer("cpu")
    timer.data_done()
    timer.step_done()
    assert timer.metrics() == {"data_time": 0.5, "step_time": 1.5}
    timer.data_done()
    timer.step_done()
    assert timer.metrics() == {"data_time": 0.25, "step_time": 0.75}


@pytest.fixture
def no_spans():
    profiling.clear()
    yield
    profiling.clear()


def _cpu_profile():
    import torch

    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def test_annotate_and_trace_record_a_named_region(tmp_path, no_spans):
    """A span records nothing with no profiler session; under
    `profiling.trace` it is a named region of the trace and a record of
    `profiling.spans()` with its attributes."""
    import torch

    with profiling.span("igpair_step", batch=2) as off:
        torch.ones(4).sum()
        off.set(pixels=6)
    assert profiling.spans() == []
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.span("igpair_step", batch=2) as sp:
            torch.ones(4).sum()
            sp.set(pixels=6)
    names = {e.key for e in prof.key_averages()}
    assert "igpair_step" in names
    assert (tmp_path / "trace.json").exists()
    [s] = profiling.spans()
    assert s["name"] == "igpair_step" and s["parent"] is None
    assert s["attrs"] == {"batch": 2, "pixels": 6} and s["t0"] <= s["t1"]


def test_spans_nest_per_thread_and_share_their_trace_id(no_spans):
    """Parent and trace_id come from the enclosing span of the same thread
    (an explicit trace_id wins); a thread other than the profiler's records
    too, as a root of its own."""
    import threading

    def other():
        with profiling.span("other"):
            pass

    with _cpu_profile():
        with profiling.span("outer", trace_id=7):
            with profiling.span("inner"):
                pass
            profiling.record("past", 1.0, 2.0, n=3)
            with profiling.span("own", trace_id=8):
                pass
            t = threading.Thread(target=other)
            t.start()
            t.join(30)
    assert not t.is_alive()
    assert profiling.record("past", 1.0, 2.0) is None  # no session
    got = profiling.spans()
    assert [s["name"] for s in got] == ["inner", "past", "own", "other",
                                        "outer"]
    by = {s["name"]: s for s in got}
    outer = by["outer"]
    assert outer["parent"] is None and outer["trace_id"] == 7
    for name, trace_id in (("inner", 7), ("past", 7), ("own", 8)):
        assert by[name]["parent"] == outer["id"], name
        assert by[name]["trace_id"] == trace_id, name
    assert (by["past"]["t0"], by["past"]["t1"]) == (1.0, 2.0)
    assert by["past"]["attrs"] == {"n": 3}
    assert by["other"]["parent"] is None and by["other"]["trace_id"] is None
    assert by["other"]["thread"] != outer["thread"]


def test_the_span_buffer_keeps_the_newest(monkeypatch, no_spans):
    import collections

    assert profiling._spans.maxlen == profiling.SPAN_BUFFER
    monkeypatch.setattr(profiling, "_spans", collections.deque(maxlen=3))
    with _cpu_profile():
        for i in range(5):
            with profiling.span(f"s{i}"):
                pass
    assert [s["name"] for s in profiling.spans()] == ["s2", "s3", "s4"]
