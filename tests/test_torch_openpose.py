"""The port's OpenPose nets against the JAX package, on the CPU.

The body, hand and face CPM nets at full width and depth against
`cpm.apply`, `hand.apply` and `face.apply` (fp32, a 64x48 input), with one
set of random weights per net: the JAX tree drawn with numpy (HWIO,
uniform +-1/sqrt(fan_in), `nn.param_init_conv`'s distribution) and loaded
into the port through `convert.openpose_params_from_jax`. Then the
inference wrappers end to end with the same weights: `OpenPose.detect`
(maps and assembly, at boxsize 64 so the net runs at 32 rows),
`Face(inference_size=64)` and `Hand` at one scale. Inputs are made with
numpy from a seed. The host assembly on synthetic maps is in
`tests/test_torch_preprocess.py`.

The JAX side is `tests/goldens/jax_openpose_tiny.npz`: the JAX package's
nets, `OpenPose.detect`, `Face` and `Hand` (and `face_fusion.
openpose_landmark_fn`, read by `tests/test_torch_postprocess.py`) on these
weights and inputs. Re-record it (JAX on the CPU, ~20 s of compile):

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_openpose.py

`test_openpose_golden_is_current` (slow) recomputes it live.
"""

import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagdressing_tpu.postprocess import face_fusion as jff
from imagdressing_tpu.preprocess.openpose import face as jface
from imagdressing_tpu.preprocess.openpose import hand as jhand
from imagdressing_tpu.preprocess.openpose import infer as jinfer
from imagdressing_tpu.preprocess.openpose import model as jcpm
from imagdressing_tpu_torch.convert import openpose_params_from_jax
from imagdressing_tpu_torch.preprocess.openpose import face as pface
from imagdressing_tpu_torch.preprocess.openpose import hand as phand
from imagdressing_tpu_torch.preprocess.openpose import infer as pinfer
from imagdressing_tpu_torch.preprocess.openpose import model as pcpm

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens",
                      "jax_openpose_tiny.npz")
# fp32 sum-order differences through 30-40 convs, relative to max|ref|
REL_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def numpy_tree(layer_lists, seed):
    """{layer: {kernel (k, k, in, out), bias}} with the JAX init's
    distribution, drawn with numpy."""
    rng = np.random.default_rng(seed)
    tree = {}
    for layers in layer_lists:
        for name, ci, co, k in layers:
            if name == "pool":
                continue
            bound = 1.0 / np.sqrt(k * k * ci)
            tree[name] = {
                "kernel": rng.uniform(-bound, bound, (k, k, ci, co)).astype(
                    np.float32),
                "bias": rng.uniform(-bound, bound, co).astype(np.float32)}
    return tree


def body_layers():
    out = [jcpm._TRUNK]
    for b in (1, 2):
        out.append(jcpm._stage1_names(b))
        out += [jcpm._stageN_names(s, b) for s in range(2, 7)]
    return out


def hand_layers(module):
    return ([jhand._TRUNK, module._STAGE1]
            + [module._stageN(i) for i in range(2, 7)])


def trees():
    """{name: JAX tree} of the body, hand and face nets."""
    return {"body": numpy_tree(body_layers(), 0),
            "hand": numpy_tree(hand_layers(jhand), 1),
            "face": numpy_tree(hand_layers(jface), 2)}


@pytest.fixture(scope="module")
def nets():
    """{name: (JAX tree, port net)} for body, hand and face."""
    out = {}
    for (name, tree), cls in zip(trees().items(), (
            pcpm.BodyPoseNet, phand.HandPoseNet, pface.FaceNet)):
        net = cls()
        net.load_state_dict(openpose_params_from_jax(tree))
        out[name] = (tree, net.eval().requires_grad_(False))
    return out


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as f:
        return dict(f)


def assert_close(got, want, what):
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, what
    ref = np.abs(want).max()
    err = np.abs(got - want).max()
    assert ref > 0 and err <= REL_TOL * ref, f"{what}: {err} vs {ref}"


def net_input():
    return np.random.default_rng(3).uniform(-0.5, 0.5, (1, 64, 48, 3)).astype(
        np.float32)


@pytest.mark.parametrize("name", ["body", "hand", "face"])
def test_net_matches_jax(nets, golden, name):
    """Each net's forward at 64x48 against the JAX `apply` (the body net
    both of its branches); the port's state dict has the JAX tree's layer
    names and nothing else."""
    tree, net = nets[name]
    assert {k.rsplit(".", 1)[0] for k in net.state_dict()} == set(tree)
    with torch.no_grad():
        got = net(torch.from_numpy(net_input()))
    if name == "body":
        assert_close(got[0], golden["net_body_paf"], "paf")
        assert_close(got[1], golden["net_body_heat"], "heatmap")
        assert got[0].shape == (1, 8, 6, 38)
    else:
        assert_close(got, golden[f"net_{name}"], name)
        assert got.shape[-1] == (22 if name == "hand" else 71)


def test_reference_keys_load_bare_and_prefixed(nets):
    """The `.pth` loader takes the layer from `key.split(".")[-2]`: a
    reference state dict with `model0.`-style prefixes and one with bare
    keys give the same net."""
    _, net = nets["face"]
    sd = net.state_dict()
    bare = pface.FaceNet.from_state_dict(sd, "cpu")
    prefixed = pface.FaceNet.from_state_dict(
        {f"model{i % 3}.{k}": v.numpy() for i, (k, v) in enumerate(sd.items())},
        "cpu")
    for k, v in sd.items():
        assert torch.equal(bare.state_dict()[k], v)
        assert torch.equal(prefixed.state_dict()[k], v)


def photo(h, w, seed):
    """A smooth seeded uint8 RGB image: blobs on a ramp, plus noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] / np.array([h, w])[:, None, None]
    img = np.stack([yy * 200, xx * 150, (yy + xx) * 90], -1)
    for _ in range(4):
        cy, cx, r = rng.uniform(0.2, 0.8, 3)
        img += 80 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2)
                           / (0.02 + r * 0.05))[..., None]
    return np.clip(img + rng.normal(0, 6, img.shape), 0, 255).astype(
        np.uint8)


def detect_tree(body):
    """The body tree with the last stage's output convs scaled by 10, so
    that the random maps reach the NMS threshold."""
    tree = {k: dict(v) for k, v in body.items()}
    for name in ("Mconv7_stage6_L1", "Mconv7_stage6_L2"):
        tree[name] = {k: v * 10 for k, v in tree[name].items()}
    return tree


def face_crop():
    return photo(50, 40, 5)[..., ::-1].copy()


def hand_crop():
    return photo(60, 60, 6)[..., ::-1].copy()


def test_openpose_detect_matches_jax(nets, golden):
    """`OpenPose.detect` at boxsize 64 (the net at 32 rows) against JAX's,
    the last stage's output convs scaled by 10 (`detect_tree`): the
    up-sampled heatmap that JAX's peak search read within the nets'
    tolerance, the peaks' positions and ids exactly, their scores within
    the tolerance, the persons exactly."""
    net = pcpm.BodyPoseNet()
    net.load_state_dict(openpose_params_from_jax(
        detect_tree(nets["body"][0])))
    img = photo(96, 72, 4)
    pop = pinfer.OpenPose(net, "cpu", boxsize=64)
    want = golden["detect_peaks"], golden["detect_persons"]
    paf, heat = pop.maps(torch.from_numpy(img))
    assert_close(heat.numpy(), golden["detect_heat"], "heatmap at (H, W)")
    assert pop.last_stage_seconds == {}
    got = pop.detect(img)
    assert set(pop.last_stage_seconds) == {"device", "assemble"}
    assert len(want[0]) >= 10
    np.testing.assert_array_equal(got[0][:, [0, 1, 3]], want[0][:, [0, 1, 3]])
    assert np.abs(got[0][:, 2] - want[0][:, 2]).max() <= REL_TOL * np.abs(
        golden["detect_heat"]).max()
    np.testing.assert_array_equal(got[1], want[1])


def test_face_and_hand_match_jax(nets, golden):
    """`Face(inference_size=64)` and `Hand` at one scale against JAX's on
    the same crops: the heatmaps within tolerance, and the landmarks."""
    pf = pface.Face(nets["face"][1], "cpu", inference_size=64)
    crop = face_crop()
    assert_close(pf.heatmaps(crop), golden["face_heatmaps"], "face heatmaps")
    np.testing.assert_array_equal(pf(crop), golden["face_landmarks"])
    ph = phand.Hand(nets["hand"][1], "cpu", boxsize=64)
    np.testing.assert_array_equal(ph(hand_crop(), scales=(1.0,)),
                                  golden["hand_landmarks"])


def test_entry_points_need_a_card_or_cpu(nets):
    """Without device="cpu" the wrappers raise on a host without a card."""
    if torch.cuda.is_available():
        return
    for make in (lambda: pinfer.OpenPose(nets["body"][1]),
                 lambda: pface.Face(nets["face"][1]),
                 lambda: phand.Hand(nets["hand"][1])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


def record_openpose_golden():
    """The JAX package on `trees()` and this module's inputs: each net at
    64x48, `OpenPose.detect` (and the heatmap its peak search read), `Face`
    and `Hand` on their crops, and `face_fusion.openpose_landmark_fn` on
    `tests/test_torch_postprocess.py`'s photo."""
    from test_torch_postprocess import landmark_photo

    t = trees()
    x = jnp.asarray(net_input())
    out = {}
    paf, heat = jax.jit(jcpm.apply)(t["body"], x)
    out["net_body_paf"], out["net_body_heat"] = paf, heat
    out["net_hand"] = jax.jit(jhand.apply)(t["hand"], x)
    out["net_face"] = jax.jit(jface.apply)(t["face"], x)
    seen = {}
    real = jinfer._find_peaks

    def spy(heat, thre1):
        seen["heat"] = heat
        return real(heat, thre1)

    jinfer._find_peaks = spy
    try:
        peaks, persons = jinfer.OpenPose(detect_tree(t["body"]),
                                         boxsize=64).detect(photo(96, 72, 4))
    finally:
        jinfer._find_peaks = real
    out.update(detect_peaks=peaks, detect_persons=persons,
               detect_heat=seen["heat"])
    crop = face_crop()
    out["face_heatmaps"] = jface._forward(
        t["face"], jnp.asarray(cv2.resize(
            crop, (64, 64), interpolation=cv2.INTER_CUBIC).astype(
                np.float32)[None] / 256.0 - 0.5), 64, 64)[0]
    out["face_landmarks"] = jface.Face(t["face"], inference_size=64)(crop)
    out["hand_landmarks"] = jhand.Hand(t["hand"], boxsize=64)(
        hand_crop(), scales=(1.0,))
    out["landmark_fn"] = jff.openpose_landmark_fn(
        t["face"], inference_size=64, threshold=-1.0)(landmark_photo())
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.slow
def test_openpose_golden_is_current(golden):
    fresh = record_openpose_golden()
    assert sorted(fresh) == sorted(golden)
    for k, v in fresh.items():
        np.testing.assert_allclose(v, golden[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    np.savez_compressed(GOLDEN, **record_openpose_golden())
    print("wrote", GOLDEN, os.path.getsize(GOLDEN), "bytes")
