"""The port's `apps/parsing_cli.py` against the JAX package's, on the CPU.

`train` then `eval --flip --scales 0.75,1.0` through `main` on two tiny
image / label pairs; a `params.npz` written by JAX's `_save_params` (from
`schp.init`, no JAX training) evaluated by the port against JAX's
`run_eval`; a port-written file read by JAX's `_load_params`; the legacy
"p{i}" format. The full-width SCHP at 64x64, 18 classes (ATR's flip
pairs); files written with cv2 from numpy seeds.
"""

import cv2
import jax
import numpy as np
import pytest
import torch

from imagdressing_tpu.apps import parsing_cli as jcli
from imagdressing_tpu.preprocess.parsing import model as jschp
from imagdressing_tpu_torch.apps import parsing_cli as pcli
from imagdressing_tpu_torch.convert import state_dict_from_jax
from imagdressing_tpu_torch.preprocess.parsing import model as pschp

NUM_CLASSES = 18


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Two 80x64 JPEG photos (smooth, so that resizes matter) and their
    label PNGs with an ignored (255) band."""
    root = tmp_path_factory.mktemp("parsing")
    images, labels = root / "images", root / "labels"
    images.mkdir()
    labels.mkdir()
    rng = np.random.default_rng(0)
    for i in range(2):
        photo = cv2.GaussianBlur(rng.integers(0, 256, (80, 64, 3)).astype(
            np.uint8), (0, 0), 2)
        cv2.imwrite(str(images / f"s{i}.jpg"), photo)
        lab = rng.integers(0, NUM_CLASSES, (80, 64)).astype(np.uint8)
        lab[:6] = 255
        cv2.imwrite(str(labels / f"s{i}.png"), lab)
    return root


@pytest.fixture(scope="module")
def jax_params(tmp_path_factory):
    """`schp.init` with random running statistics (so that the folded BN
    is not the identity), written by JAX's `_save_params`: its key paths,
    stored without deflate (`np.load` reads either; deflating 67 M floats
    takes ~11 s here)."""
    tree = jschp.init(jax.random.PRNGKey(1), num_classes=NUM_CLASSES)
    rng = np.random.default_rng(1)
    for leaf in jax.tree_util.tree_leaves_with_path(tree):
        path, arr = leaf
        key = jcli._leaf_key(path)
        if key.endswith("running_mean"):
            arr[:] = 0.1 * rng.standard_normal(arr.shape)
        elif key.endswith("running_var"):
            arr[:] = rng.uniform(0.5, 2.0, arr.shape)
    path = str(tmp_path_factory.mktemp("jparams") / "params.npz")
    mp = pytest.MonkeyPatch()
    mp.setattr(np, "savez_compressed", np.savez)
    try:
        jcli._save_params(path, tree)
    finally:
        mp.undo()
    return tree, path


def _args(data, *extra):
    return ["--image_dir", str(data / "images"),
            "--label_dir", str(data / "labels"),
            "--num_classes", str(NUM_CLASSES), "--input_size", "64",
            "--device", "cpu", *extra]


def test_train_then_eval(data, tmp_path, capsys):
    """`main(["train", ...])` for 2 steps writes params.npz; `main(["eval",
    ... "--flip", "--scales", "0.75,1.0", "--save_dir", ...])` restores
    it, prints an mIoU in [0, 1] and writes one uint8 PNG per image."""
    out = tmp_path / "log"
    pcli.main(["train", *_args(data, "--out_dir", str(out), "--steps", "2",
                                "--log_every", "1")])
    assert (out / "params.npz").exists()
    text = capsys.readouterr().out
    assert "step 2 loss" in text
    preds = tmp_path / "preds"
    pcli.main(["eval", *_args(data, "--restore", str(out / "params.npz"),
                               "--flip", "--scales", "0.75,1.0",
                               "--save_dir", str(preds))])
    miou = float(capsys.readouterr().out.split(":")[-1])
    assert 0.0 <= miou <= 1.0
    assert sorted(p.name for p in preds.iterdir()) == ["s0.png", "s1.png"]
    pred = cv2.imread(str(preds / "s0.png"), cv2.IMREAD_UNCHANGED)
    assert pred.shape == (64, 64) and pred.max() < NUM_CLASSES


def test_eval_of_jax_params_matches_jax(data, jax_params, tmp_path):
    """A JAX-written params.npz, `eval --flip --scales 1.0`: the port's
    mIoU within 1e-6 of JAX's `run_eval`, its prediction PNGs equal to
    JAX's (random weights reach |logits| ~ 1e4; argmax near-ties may flip
    a pixel, allowed at < 0.1 %)."""
    _, path = jax_params
    argv = _args(data, "--restore", path, "--flip", "--scales", "1.0")
    jargs = jcli.build_argparser().parse_args(
        ["eval"] + [a for a in argv if a not in ("--device", "cpu")]
        + ["--save_dir", str(tmp_path / "jax")])
    want = jcli.run_eval(jargs)
    got = pcli.run_eval(pcli.build_argparser().parse_args(
        ["eval", *argv, "--save_dir", str(tmp_path / "port")]))
    assert abs(got - want) <= 1e-6
    for name in ("s0.png", "s1.png"):
        a, b = (cv2.imread(str(tmp_path / d / name), cv2.IMREAD_UNCHANGED)
                for d in ("port", "jax"))
        assert a.shape == b.shape and (a != b).mean() < 1e-3


def test_params_round_trip_between_packages(jax_params, tmp_path):
    """JAX-written -> port: every leaf equal to the tree's; port-written
    (`save_params`) -> JAX's `_load_params`: equal arrays; the legacy
    "p{i}" file (leaves in `jax.tree.flatten` order) -> port: equal; a
    wrong --num_classes raises."""
    tree, path = jax_params
    net = pcli.load_params(path, NUM_CLASSES, "cpu")
    # the eval net: the inference SCHP (K7 at every ABN), frozen
    assert isinstance(net, pschp.SCHP) and not net.training
    assert not any(p.requires_grad for p in net.parameters())
    want = state_dict_from_jax(tree)
    for k, v in net.state_dict().items():
        assert torch.equal(v, want[k]), k

    out = str(tmp_path / "port.npz")
    pcli.save_params(out, net)
    back = jcli._load_params(out, NUM_CLASSES)
    for (path_a, a), b in zip(jax.tree_util.tree_leaves_with_path(tree),
                              jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(b), a,
                                      err_msg=jcli._leaf_key(path_a))

    legacy = str(tmp_path / "legacy.npz")
    np.savez(legacy, **{f"p{i}": np.asarray(a)
                        for i, a in enumerate(jax.tree.leaves(tree))})
    again = pcli.load_params(legacy, NUM_CLASSES, "cpu")
    for k, v in again.state_dict().items():
        assert torch.equal(v, want[k]), k

    with pytest.raises((ValueError, KeyError)):
        pcli.load_params(path, 20, "cpu")
