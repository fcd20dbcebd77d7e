"""The port's golden replay (`tools/record_reference.py`) against the JAX
package's recorded goldens, its `compare` gate, and its own synthetic
goldens.

The committed `tests/goldens/ref_synthetic_{tiny,pose,ipa_pose,inpaint}.npz`
were recorded by the JAX package's `record_synthetic` on its small stack
(`init_random(PRNGKey(0), small=True, ...)`, ControlNet fresh). Their
manifests name weights drawn by jax.random, which the port refuses to
rebuild; the port's stack comes from that stack's parameters
(`tests/goldens/jax_small_stack.npz`, see `tests/test_torch_presets.py`)
through `convert.params_from_jax`, and every recorded key is compared at the
JAX replay's tolerance, atol 5e-3 + rtol 1e-3 * max|golden|. fp32 on the
CPU (each kernel's plain version).
"""

import glob
import json
import os

import numpy as np
import pytest
import torch
from test_torch_presets import small_stack

from imagdressing_tpu_torch.pipelines.dressing import DressingModels
from imagdressing_tpu_torch.tools import record_reference as rr

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_port_replays_every_jax_golden():
    """All four JAX goldens through `replay(golden, models=...)`: the keys
    compared are the golden's, each within the tolerance; the JAX
    manifests are refused with a message, not rebuilt."""
    paths = sorted(glob.glob(os.path.join(GOLDENS, "ref_synthetic_*.npz")))
    assert [os.path.basename(p) for p in paths] == [
        f"ref_synthetic_{n}.npz" for n in ("inpaint", "ipa_pose", "pose",
                                           "tiny")]
    port = DressingModels.from_jax_params(small_stack().params, small=True,
                                          device="cpu")
    for path in paths:
        golden = np.load(path)
        outputs = {k for k in golden.files
                   if k not in rr.INPUT_KEYS and k != "preset"}
        errors = rr.replay(path, models=port)
        # every numeric key (the inputs pass through unchanged)
        assert set(errors) == set(golden.files) - {"preset"}, path
        assert set(errors) - set(rr.INPUT_KEYS) == outputs, path
        with open(rr.manifest_path_for(path)) as f:
            manifest = json.load(f)
        assert manifest["kind"] == "synthetic_small"
        with pytest.raises(ValueError, match="params_from_jax"):
            rr.build_models_from_manifest(manifest, "cpu")
        with pytest.raises(ValueError, match="jax.random"):
            rr.replay(path, device="cpu")
    with pytest.raises(ValueError, match="unknown golden-manifest kind"):
        rr.build_models_from_manifest({"kind": "flax"}, "cpu")


def _full_golden(tmp_path, drop=(), preset="basic", **extra):
    g = {"text_embeds": np.ones((1, 4, 8), np.float32),
         "clip_vision_penult": np.full((1, 5, 6), 2.0, np.float32),
         "cloth_tokens": np.zeros((1, 3, 8), np.float32),
         "ref_latents_nhwc": np.ones((1, 2, 2, 4), np.float32),
         "sa_hidden::down_blocks.0": np.ones((1, 4, 8), np.float32),
         "eps_step0_nhwc": np.ones((1, 2, 2, 4), np.float32),
         "final_latents_nhwc": np.ones((1, 2, 2, 4), np.float32),
         "preset": np.str_(preset), **extra}
    for k in drop:
        del g[k]
    path = str(tmp_path / f"g{len(drop)}{preset}.npz")
    np.savez(path, **g)
    return path, {k: v for k, v in g.items() if k != "preset"}


def test_compare_passes_and_fails(tmp_path):
    """Passes on a match within atol + rtol * max|golden|; fails on a value,
    a NaN, a shape, a key not computed, and on a golden that lacks a spec
    surface (a narrow golden must not read as full parity)."""
    path, g = _full_golden(tmp_path)
    errors = rr.compare(path, {k: v + 1e-4 for k, v in g.items()})
    assert set(errors) == set(g) and max(errors.values()) <= 2e-4
    for bad, match in (({"cloth_tokens": np.ones((1, 3, 8))}, "max err"),
                       ({"ref_latents_nhwc": np.full((1, 2, 2, 4), np.nan)},
                        "max err"),
                       ({"eps_step0_nhwc": np.ones((1, 2, 4, 2))}, "shape")):
        with pytest.raises(AssertionError, match=match):
            rr.compare(path, {**g, **bad})
    with pytest.raises(AssertionError, match="final_latents_nhwc: not "):
        rr.compare(path, {k: v for k, v in g.items()
                          if k != "final_latents_nhwc"})
    for drop in (("cloth_tokens",), ("sa_hidden::down_blocks.0",)):
        narrow, g2 = _full_golden(tmp_path, drop)
        with pytest.raises(AssertionError, match="lacks RECORD_SPEC surface "
                                                 f"'{drop[0].split('::')[0]}"):
            rr.compare(narrow, g2)
    # a pose golden needs the ControlNet residuals as well
    pose, g3 = _full_golden(tmp_path, preset="pose")
    with pytest.raises(AssertionError, match="cn_down_res_step0"):
        rr.compare(pose, g3)
    pose, g3 = _full_golden(tmp_path, preset="pose", **{
        "cn_down_res_step0::00": np.ones(3, np.float32),
        "cn_mid_res_step0": np.ones(3, np.float32)})
    assert len(rr.compare(pose, g3)) == 9


def test_synthetic_golden_records_and_replays(tmp_path):
    """`record_synthetic` on the CPU: the port's own manifest kind, weights
    from the CPU generator (the same stack twice), non-zero ControlNet
    residuals (the stack's ControlNet is perturbed); the replay passes, and
    a tampered golden fails the gate."""
    out = str(tmp_path / "ref_probe.npz")
    rr.record_synthetic(out, seed=1, steps=2, preset="pose", device="cpu")
    with open(rr.manifest_path_for(out)) as f:
        assert json.load(f) == {"kind": "synthetic_small_torch", "seed": 1,
                                "with_controlnet": True, "with_ipa": False}
    g = dict(np.load(out))
    assert not rr.missing_surfaces(g, "pose")
    assert float(np.abs(g["cn_mid_res_step0"]).max()) > 0
    errors = rr.replay(out, device="cpu")
    assert max(errors.values()) == 0.0 and len(errors) == len(g) - 1
    g["final_latents_nhwc"] = g["final_latents_nhwc"] + 1.0
    bad = str(tmp_path / "ref_bad.npz")
    np.savez(bad, **g)
    with open(rr.manifest_path_for(bad), "w") as f:
        json.dump({"kind": "synthetic_small_torch", "seed": 1,
                   "with_controlnet": True}, f)
    with pytest.raises(AssertionError, match="final_latents_nhwc: max err"):
        rr.replay(bad, device="cpu")
