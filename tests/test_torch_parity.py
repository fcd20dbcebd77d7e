"""The port's weights-day runbook (`tools/parity.py`) on the CPU: its help and
guidance, the synthetic dry run over the four reference pipelines, and the
weights-mode flow on checkpoint files written from a small random stack
(`tools/write_checkpoints.py`, loaded with the small configs): manifest,
replay through the loader's models, report."""

import functools
import json
import os

import numpy as np
import pytest
import torch

from imagdressing_tpu_torch.apps import loader as loader_mod
from imagdressing_tpu_torch.apps.png import decode_png
from imagdressing_tpu_torch.pipelines.dressing import model_configs
from imagdressing_tpu_torch.tools import parity
from imagdressing_tpu_torch.tools import record_reference as rr
from imagdressing_tpu_torch.tools.write_checkpoints import write_checkpoints


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_cli_guides_and_defaults_to_the_card(tmp_path, capsys):
    """--help names the recorder's command; a missing golden prints the
    command to record it and exits 2; ipa_pose without --ipa_ckpt is left
    out with the reason; without --device the runbook and the recorder
    raise here (no card) and write nothing."""
    with pytest.raises(SystemExit) as e:
        parity.main(["--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert "record_reference record" in out and "--device" in out

    with pytest.raises(SystemExit) as e:
        parity.main(["--golden", str(tmp_path / "absent.npz")])
    assert e.value.code == 2
    out = capsys.readouterr().out
    assert "record_reference record" in out
    assert "--preset inpaint" in out and "ipa_pose left out" in out
    with pytest.raises(SystemExit) as e:
        parity.main(["--golden", str(tmp_path / "absent.npz"), "--presets",
                     "ipa_pose", "--ipa_ckpt", "f.bin"])
    assert e.value.code == 2
    assert "--ipa_ckpt f.bin" in capsys.readouterr().out

    with pytest.raises(RuntimeError, match="no CUDA device"):
        parity.main(["--dry-run", "--out_dir", str(tmp_path / "dry")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rr.main(["record-synthetic", "--out", str(tmp_path / "g.npz")])
    assert not os.listdir(tmp_path)


def test_dry_run_on_the_cpu(tmp_path):
    """`parity --dry-run --device cpu`: an ok report over the four presets
    with the full spec surface of each, and the seed-42 PNG."""
    report = parity.main(["--dry-run", "--device", "cpu", "--out_dir",
                          str(tmp_path)])
    assert report == json.loads((tmp_path / "parity_report.json").read_text())
    assert report["ok"] and report["mode"] == "dry-run"
    assert sorted(report["presets"]) == ["basic", "inpaint", "ipa_pose",
                                         "pose"]
    names = report["presets"]["basic"]["tensors_compared"]
    for key in ("text_embeds", "cloth_tokens", "ref_latents_nhwc",
                "eps_step0_nhwc", "final_latents_nhwc"):
        assert key in names
    assert any(n.startswith("sa_hidden::") for n in names)
    pose_names = report["presets"]["pose"]["tensors_compared"]
    assert any(n.startswith("cn_down_res_step0::") for n in pose_names)
    assert "cn_mid_res_step0" in pose_names
    ipa_names = report["presets"]["ipa_pose"]["tensors_compared"]
    assert "face_tokens" in ipa_names and "face_clip_penult" in ipa_names
    inp_names = report["presets"]["inpaint"]["tensors_compared"]
    for key in ("image_latents_nhwc", "mask_latent_nhwc",
                "recomposed_latents_step0_nhwc"):
        assert key in inp_names
    for name, entry in report["presets"].items():
        assert not rr.missing_surfaces(entry["tensors_compared"], name)
        assert entry["worst_max_err"] == 0.0
    img = decode_png((tmp_path / "seed42.png").read_bytes())
    assert img.shape == (64, 64, 3) and img.dtype == np.uint8


def test_weights_mode_on_written_checkpoints(tmp_path, monkeypatch):
    """Goldens recorded from a small stack, the stack written as the
    reference's files (ControlNet and FaceID bin included), then the
    weights-mode runbook on the CPU: the torch manifest names every file,
    the loader rebuilds the stack bit for bit, and every surface of the
    four presets replays (error 0)."""
    models = rr.synthetic_models(3, with_controlnet=True, with_ipa=True,
                                 device="cpu")
    paths = write_checkpoints(models, str(tmp_path / "ckpt"))
    golden = str(tmp_path / "ref_base.npz")
    for preset in parity.PRESETS:
        rr.record_golden(parity._golden_path(golden, preset), models, preset,
                         seed=5, steps=2)
    monkeypatch.setattr(loader_mod, "load_dressing_models", functools.partial(
        loader_mod.load_dressing_models, **model_configs(small=True)))
    report = parity.main([
        "--golden", golden, "--device", "cpu",
        *(f"--{k}={paths[k]}" for k in ("base_dir", "vae_path",
                                        "image_encoder_path", "model_ckpt",
                                        "controlnet_path")),
        "--ipa_ckpt", paths["ip_ckpt"]])
    assert report["ok"] and report["worst_max_err"] == 0.0
    with open(rr.manifest_path_for(golden)) as f:
        manifest = json.load(f)
    assert manifest == dict(paths, kind="torch")
    compared = report["tensors_compared"]
    for preset in parity.PRESETS:
        mine = [k.split("::", 1)[1] for k in compared
                if k.startswith(preset + "::")]
        assert not rr.missing_surfaces(mine, preset), preset
