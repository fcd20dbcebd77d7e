"""The port's train -> serve loop on the CPU, with the small stack: the
checkpoint manager, a step from a restored state, the train CLI end to end
(manifest + JPEGs on disk -> steps -> metrics.jsonl, TensorBoard events,
checkpoints; resume), `dress --trained_ckpt`, and the trained weights out
to the reference's `.pt` and back through the converter.

Model loading and the tokenizer are stubbed with the small random stack and
a tokenizer inside its vocabulary, as the JAX package's CLI tests do
(`tests/test_train_cli.py`). The JAX trainer is not run here: its jitted
step is the training golden's (`tests/test_torch_pipeline.py`).
"""

import json
import os
import struct

import numpy as np
import pytest
import torch
from PIL import Image

import imagdressing_tpu_torch.apps.dress as dress
import imagdressing_tpu_torch.apps.loader as loader_mod
import imagdressing_tpu_torch.apps.tokenizer as tok_mod
import imagdressing_tpu_torch.apps.train_cli as train_cli
from imagdressing_tpu_torch.apps import image_utils as iu
from imagdressing_tpu_torch.apps.loader import (
    merge_trained_checkpoint,
    restore_trained_params,
)
from imagdressing_tpu_torch.apps.tokenizer import HashTokenizer
from imagdressing_tpu_torch.convert import params_from_jax, tree_from_module
from imagdressing_tpu_torch.convert import export_torch as ex
from imagdressing_tpu_torch.convert import torch_sd as cv
from imagdressing_tpu_torch.core.config import TrainConfig
from imagdressing_tpu_torch.models.unet import adapter_key, attn_layer_names
from imagdressing_tpu_torch.pipelines.dressing import (
    TRAINABLE_KEYS,
    DressingModels,
)
from imagdressing_tpu_torch.train import checkpoint as ck
from imagdressing_tpu_torch.train import step as tstep
from imagdressing_tpu_torch.train.trackers import _masked_crc

SIZE = 64


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def small_stack():
    return DressingModels.init_random(0, small=True, device="cpu")


def _host_equal(a, b):
    """Two `state_to_host` forms, bit for bit."""
    assert a["step"] == b["step"]
    for k in TRAINABLE_KEYS:
        assert a["params"][k].keys() == b["params"][k].keys()
        for n, t in a["params"][k].items():
            assert torch.equal(t, b["params"][k][n]), f"{k}.{n}"
    for k, v in a["opt_state"].items():
        w = b["opt_state"][k]
        if torch.is_tensor(v):
            assert v.dtype == w.dtype and torch.equal(v, w), k
        else:
            assert v == w, k


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {"person_image": torch.tensor(rng.uniform(-1, 1, (1, SIZE, SIZE,
                                                             3)),
                                         dtype=torch.float32),
            "cloth_image": torch.tensor(rng.uniform(-1, 1, (1, SIZE, SIZE,
                                                            3)),
                                        dtype=torch.float32),
            "cloth_clip": torch.tensor(rng.standard_normal((1, 56, 56, 3)),
                                       dtype=torch.float32),
            "text_ids": torch.tensor(rng.integers(0, 256, (1, 77)))}


@pytest.fixture(scope="module")
def trained():
    """The small stack after one step (lr 1e-3 from the second update, the
    moments and counters moved), with its step function."""
    models = small_stack()
    cfg = TrainConfig(train_batch_size=1, warmup_steps=1, learning_rate=1e-3)
    state, frozen, tx = tstep.init_train_state(models, cfg)
    step = tstep.make_train_step(models, cfg, tx)
    state, _ = step(state, frozen, _batch(0), 0)
    return models, state, frozen, step


def test_checkpoint_round_trip_is_bit_equal(trained, tmp_path):
    """save (async) -> restore into a fresh template: every master weight,
    moment (bf16 mu, fp32 nu) and counter bit-equal, the extra JSON back."""
    _, state, _, _ = trained
    state.opt_state.notfinite_count, state.opt_state.total_notfinite = 2, 5
    want = tstep.state_to_host(state)
    mgr = ck.CheckpointManager(str(tmp_path / "ckpts"))
    assert mgr.save(state, extra={"epoch": 7})
    mgr.wait()
    assert not mgr.save(state)  # that step is saved already
    template, _, _ = tstep.init_train_state(
        small_stack(), TrainConfig(train_batch_size=1))
    restored, extra = mgr.restore(template)
    mgr.close()
    assert extra == {"epoch": 7} and restored.step == 1
    assert restored.opt_state.mu.dtype == torch.bfloat16
    _host_equal(tstep.state_to_host(restored), want)
    state.opt_state.notfinite_count, state.opt_state.total_notfinite = 0, 0


def test_checkpoint_empty_latest_and_half_written(trained, tmp_path):
    """No checkpoint -> (None, None); the latest step wins; max_to_keep
    prunes the oldest; a temporary or incomplete step directory is never
    picked."""
    _, state, _, _ = trained
    root = tmp_path / "multi"
    mgr = ck.CheckpointManager(str(root), max_to_keep=2, async_save=False)
    assert mgr.restore(state) == (None, None)
    s0 = state.step
    try:
        for s in (1, 2, 3):
            state.step = s
            mgr.save(state)
        (root / ".9.tmp-123").mkdir()
        (root / ".9.tmp-123" / ck.STATE_FILE).write_bytes(b"partial")
        (root / "8").mkdir()  # a killed write that made only the directory
        assert ck.saved_steps(str(root)) == [2, 3]
        restored, extra = mgr.restore(state)
        assert restored.step == 3 and extra is None
    finally:
        state.step = s0


def test_step_from_a_restored_state_is_bit_equal(trained, tmp_path):
    """Checkpoint after step 1, take step 2; restore, take step 2 again:
    the same loss, grad norm, weights and optimizer state, bit for bit (the
    draws come from (seed, step, index), so the step counter must survive
    the round trip). One thread: the CPU's threaded reductions are not
    bit-reproducible from run to run."""
    _, state, frozen, step = trained
    mgr = ck.CheckpointManager(str(tmp_path / "resume"), async_save=False)
    mgr.save(state)
    batch = _batch(1)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        live, m_live = step(state, frozen, batch, 0)
        live_host = tstep.state_to_host(live)
        restored, _ = mgr.restore(live)  # the same modules, moved back
        assert restored.step == 1
        again, m_again = step(restored, frozen, batch, 0)
    finally:
        torch.set_num_threads(threads)
    assert torch.equal(m_again["loss"], m_live["loss"])
    assert torch.equal(m_again["grad_norm"], m_live["grad_norm"])
    _host_equal(tstep.state_to_host(again), live_host)


def _write_manifest(root, n=4):
    rng = np.random.default_rng(0)
    items = []
    for i in range(n):
        for kind in ("person", "cloth"):
            Image.fromarray(rng.integers(0, 255, (96, 80, 3), dtype=np.uint8)
                            ).save(root / f"{kind}{i}.jpg")
        items.append({"image_file": f"person{i}.jpg",
                      "cloth_file": f"cloth{i}.jpg",
                      "text": ["a red dress", "red summer dress"]})
    path = root / "manifest.json"
    path.write_text(json.dumps(items))
    return path


@pytest.fixture(scope="module")
def stubbed():
    """The loader returns a fresh small stack; the tokenizer stays inside
    the small text model's 256 ids."""
    mp = pytest.MonkeyPatch()
    mp.setattr(loader_mod, "load_dressing_models", lambda **kw: small_stack())
    mp.setattr(tok_mod, "load_tokenizer",
               lambda path, max_length=77: HashTokenizer(256))
    yield
    mp.undo()


@pytest.fixture(scope="module")
def run(stubbed, tmp_path_factory):
    """Two steps with a checkpoint at 2 and TensorBoard events, then
    `--resume_from_checkpoint` to step 3. Returns (output dir, the first
    run's final state as host tensors, data root)."""
    root = tmp_path_factory.mktemp("train")
    manifest = _write_manifest(root)
    out = root / "run"
    args = ["--data_json_file", str(manifest), "--data_root_path", str(root),
            "--output_dir", str(out), "--train_batch_size", "1",
            "--num_train_steps", "2", "--checkpointing_steps", "2",
            "--logging_steps", "1", "--lr_warmup_steps", "1",
            "--resize_shorter", str(SIZE), "--crop_height", str(SIZE),
            "--crop_width", str(SIZE), "--dataloader_num_workers", "1",
            "--device", "cpu"]
    first = tstep.state_to_host(
        train_cli.main(args + ["--report_to", "tensorboard"]))
    resumed = train_cli.main(
        [a if a != "2" or args[i - 1] != "--num_train_steps" else "3"
         for i, a in enumerate(args)] + ["--resume_from_checkpoint"])
    assert resumed.step == 3
    return out, first, root


def test_train_cli_end_to_end_and_resume(run):
    """One metrics line a step with the JAX CLI's fields, finite losses;
    the resumed run starts after the checkpoint at 2 (steps 1, 2, 3);
    checkpoints at 2 and 3; the checkpoint at 2 is the first run's final
    state, bit for bit."""
    out, first, _ = run
    lines = [json.loads(ln) for ln in
             (out / "metrics.jsonl").read_text().splitlines()]
    assert [ln["step"] for ln in lines] == [1, 2, 3]
    for ln in lines:
        assert set(ln) == {"step", "loss", "grad_norm", "step_time_s",
                           "data_time_s", "images_per_sec"}
        assert np.isfinite(ln["loss"]) and np.isfinite(ln["grad_norm"])
    assert ck.saved_steps(str(out / "checkpoints")) == [2, 3]
    host, extra = ck.read_checkpoint(str(out / "checkpoints"), 2)
    assert extra == {"step": 2}
    _host_equal(host, first)


def test_train_cli_tensorboard_events(run):
    """--report_to tensorboard: one event file with the version record and
    one scalar event per logged step of the first run, CRCs valid."""
    out, _, _ = run
    files = os.listdir(out / "logs")
    assert len(files) == 1 and files[0].startswith("events.out.tfevents.")
    data = (out / "logs" / files[0]).read_bytes()
    records, i = [], 0
    while i < len(data):
        (length,) = struct.unpack("<Q", data[i:i + 8])
        assert struct.unpack("<I", data[i + 8:i + 12])[0] == \
            _masked_crc(data[i:i + 8])
        payload = data[i + 12:i + 12 + length]
        assert struct.unpack("<I", data[i + 12 + length:i + 16 + length]
                             )[0] == _masked_crc(payload)
        records.append(payload)
        i += 16 + length
    assert len(records) == 3 and b"brain.Event:2" in records[0]
    assert all(b"loss" in r and b"images_per_sec" in r for r in records[1:])


def test_train_cli_refusals(stubbed, tmp_path):
    manifest = _write_manifest(tmp_path, n=1)
    base = ["--data_json_file", str(manifest), "--output_dir",
            str(tmp_path / "o")]
    with pytest.raises(SystemExit, match="allow_cpu_mesh"):
        train_cli.main(base + ["--tensor_parallel", "2", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train_cli.main(base)


def test_dress_serves_the_trained_checkpoint(run, tmp_path):
    """train -> checkpoints -> `dress --trained_ckpt` -> a collage PNG; the
    merge replaces the trainables with the latest checkpoint's (moved from
    the base) and keeps the frozen models' base weights."""
    out, _, _ = run
    ckpt_dir = str(out / "checkpoints")
    base = small_stack()
    merged = merge_trained_checkpoint(small_stack(), ckpt_dir)
    trained = restore_trained_params(ckpt_dir)
    for k in TRAINABLE_KEYS:
        sd = getattr(merged, k).state_dict()
        assert all(torch.equal(sd[n], t) for n, t in trained[k].items()), k
    assert not torch.equal(merged.ref_unet.conv_in.weight,
                           base.ref_unet.conv_in.weight)
    for k in ("unet", "vae", "text", "vision"):
        a, b = getattr(merged, k).state_dict(), getattr(base, k).state_dict()
        assert all(torch.equal(a[n], b[n]) for n in a), k

    cloth = tmp_path / "shirt.png"
    cloth.write_bytes(iu.encode_png(np.random.default_rng(0).integers(
        0, 255, (100, 80, 3), dtype=np.uint8)))
    dress.main(["--cloth_path", str(cloth), "--trained_ckpt", ckpt_dir,
                "--output_path", str(tmp_path / "served"), "--height",
                str(SIZE), "--width", str(SIZE), "--num_inference_steps", "2",
                "--device", "cpu"])
    collage = iu.read_image(str(tmp_path / "served" / "shirt.png"))
    assert collage.shape == (SIZE, 2 * SIZE, 3)
    assert collage[:, SIZE:].std() > 0


def test_trained_checkpoint_to_reference_pt_and_back(run, tmp_path):
    """checkpoint -> restore_trained_params -> the reference's monolithic
    `.pt` (`export_imagdressing_module`) -> `convert_imagdressing_
    checkpoint` -> the same tensors (the JAX package's chain,
    tests/test_train_serve_loop.py)."""
    out, _, _ = run
    trained = restore_trained_params(str(out / "checkpoints"))
    models = merge_trained_checkpoint(small_stack(), str(out / "checkpoints"))
    adapters = tree_from_module(models.ref_adapters)
    names = attn_layer_names(models.unet_cfg, "attn1")
    module = ex.export_imagdressing_module(
        {"ref_unet": tree_from_module(models.ref_unet),
         "resampler": tree_from_module(models.resampler),
         "ref_adapters": {n: adapters[adapter_key(n)] for n in names}},
        models.unet_cfg)
    path = str(tmp_path / "trained.pt")
    ex.save_checkpoint(path, module)
    back = params_from_jax(cv.convert_imagdressing_checkpoint(
        cv.load_torch_file(path)["module"], models.unet_cfg,
        models.resampler_cfg))
    for k in TRAINABLE_KEYS:
        assert back[k].keys() == trained[k].keys(), k
        for n, t in trained[k].items():
            assert torch.equal(torch.as_tensor(back[k][n]).to(t.dtype), t), \
                f"{k}.{n}"
