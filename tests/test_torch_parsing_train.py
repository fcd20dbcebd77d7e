"""The port's SCHP fine-tune against the JAX package, on the CPU.

`abn_train` / `abn_train_stats` (`kernels/fused_bn_act.py`) against the
JAX custom VJP: the forward, the moments and the inverse-recompute
gradients, and its synced form in two gloo processes against one process
on the whole batch; the losses of `train/parsing_losses.py` against JAX's,
with ignored pixels and tied errors; the learning-rate schedule and SGD
against optax; `ParsingDataset` against JAX's on files written by cv2
(the two full train steps are in `test_torch_parsing_steps.py`). fp32;
inputs made with numpy from a seed.
"""

import os
import subprocess
import sys
import textwrap

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

import imagdressing_tpu.kernels.fused_bn_act as jabn
import imagdressing_tpu.train.parsing_losses as jloss
import imagdressing_tpu.train.parsing_train as jtrain
from imagdressing_tpu_torch.kernels.fused_bn_act import (
    abn_train,
    abn_train_stats,
)
from imagdressing_tpu_torch.train import parsing_losses as ploss
from imagdressing_tpu_torch.train import parsing_train as ptrain

NUM_CLASSES = 6
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# abn_train
# ---------------------------------------------------------------------------


def _abn_inputs(seed, shape=(2, 8, 8, 64)):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = (2 * rng.standard_normal(shape) + 0.5).astype(np.float32)
    w = (1 + 0.3 * rng.standard_normal(c)).astype(np.float32)
    b = (0.3 * rng.standard_normal(c)).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    return x, w, b, g


@pytest.mark.parametrize("activation", ["leaky_relu", "elu", "none"])
def test_abn_train_matches_jax(activation):
    """Forward within 1e-5 * max|y|; dx, dw, db against `jax.grad` of the
    custom VJP within 1e-4 * max; the moments of `abn_train_stats` against
    JAX's (measured ~3e-7 relative for all)."""
    x, w, b, g = _abn_inputs(len(activation))
    jx, jw, jb = map(jnp.asarray, (x, w, b))
    y_want, mean_want, var_want = jax.jit(
        lambda *a: jabn.abn_train_stats(*a, 1e-5, activation, 0.01, None))(
        jx, jw, jb)
    grads_want = jax.jit(jax.grad(
        lambda *a: jnp.sum(jabn.abn_train(*a, 1e-5, activation, 0.01, None)
                           * g), argnums=(0, 1, 2)))(jx, jw, jb)
    xt, wt, bt = (torch.tensor(a, requires_grad=True) for a in (x, w, b))
    y, mean, var = abn_train_stats(xt, wt, bt, activation=activation)
    assert not mean.requires_grad and not var.requires_grad
    (y * torch.from_numpy(g)).sum().backward()
    assert _rel(y.detach(), y_want) <= 1e-5
    assert _rel(mean, mean_want) <= 1e-5 and _rel(var, var_want) <= 1e-5
    for t, want in zip((xt, wt, bt), grads_want):
        assert _rel(t.grad, want) <= 1e-4
    # abn_train is abn_train_stats' first output
    torch.testing.assert_close(abn_train(xt, wt, bt, activation=activation),
                               y, rtol=0, atol=0)


def test_abn_train_saturated_elu_has_no_nan():
    """Outputs at elu's asymptote (pre-activations below -20 round to
    exactly -1 in fp32): the inverse is clamped, the gradient finite."""
    x, w, b, g = _abn_inputs(9, (1, 4, 4, 8))
    b[:] = -40.0
    xt, wt, bt = (torch.tensor(a, requires_grad=True) for a in (x, w, b))
    y = abn_train(xt, wt, bt, activation="elu")
    assert (y == -1).any()
    (y * torch.from_numpy(g)).sum().backward()
    for t in (xt, wt, bt):
        assert torch.isfinite(t.grad).all()


_SYNC_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from imagdressing_tpu_torch.kernels.fused_bn_act import abn_train_stats

    rank, world, port, path = (int(sys.argv[1]), int(sys.argv[2]),
                               sys.argv[3], sys.argv[4])
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    torch.set_num_threads(1)
    data = np.load(path)
    half = data["x"].shape[0] // world
    part = slice(rank * half, (rank + 1) * half)
    x = torch.tensor(data["x"][part], requires_grad=True)
    w = torch.tensor(data["w"], requires_grad=True)
    b = torch.tensor(data["b"], requires_grad=True)
    y, mean, var = abn_train_stats(x, w, b, activation="leaky_relu",
                                   group=dist.group.WORLD)
    (y * torch.from_numpy(data["g"][part])).sum().backward()
    np.savez(path.replace(".npz", f"_{rank}.npz"), y=y.detach().numpy(),
             mean=mean.numpy(), var=var.numpy(), dx=x.grad.numpy(),
             dw=w.grad.numpy(), db=b.grad.numpy())
    dist.destroy_process_group()
""")


def test_abn_train_sync_matches_global_batch(tmp_path):
    """InPlaceABNSync: two gloo processes, each with half of a (4, 4, 4, 16)
    batch and `group=WORLD`, against one process on the whole batch: the
    output halves, the moments, dx halves and the all-reduced dw, db (the
    port's `test_sync_abn_matches_global_batch`)."""
    import socket

    x, w, b, g = _abn_inputs(3, (4, 4, 4, 16))
    path = str(tmp_path / "abn.npz")
    np.savez(path, x=x, w=w, b=b, g=g)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, "-c", _SYNC_WORKER, str(r),
                               "2", str(port), path], env=env)
             for r in range(2)]
    for p in procs:
        assert p.wait(timeout=120) == 0
    xt, wt, bt = (torch.tensor(a, requires_grad=True) for a in (x, w, b))
    y, mean, var = abn_train_stats(xt, wt, bt, activation="leaky_relu")
    (y * torch.from_numpy(g)).sum().backward()
    for r in range(2):
        got = np.load(path.replace(".npz", f"_{r}.npz"))
        part = slice(2 * r, 2 * r + 2)
        np.testing.assert_allclose(got["y"], y.detach()[part], atol=1e-5)
        np.testing.assert_allclose(got["dx"], xt.grad[part], atol=1e-5)
        for k, want in (("mean", mean), ("var", var), ("dw", wt.grad),
                        ("db", bt.grad)):
            np.testing.assert_allclose(got[k], want, rtol=1e-5, atol=1e-5)


def _bottleneck_tree(rng, inplanes, planes):
    """One bottleneck's JAX tree: `schp.init`'s conv kernels (0.05 * N(0,
    1)), and affine parameters off their init (1 + 0.2 N, 0.2 N) so that a
    swapped weight and bias, or a dropped one, shows."""
    def conv(kh, i, o):
        return {"kernel": (0.05 * rng.standard_normal((kh, kh, i, o))
                           ).astype(np.float32)}

    def bn(c):
        return {"weight": (1 + 0.2 * rng.standard_normal(c)).astype(
                    np.float32),
                "bias": (0.2 * rng.standard_normal(c)).astype(np.float32),
                "running_mean": np.zeros(c, np.float32),
                "running_var": np.ones(c, np.float32)}

    return {"conv1": conv(1, inplanes, planes), "bn1": bn(planes),
            "conv2": conv(3, planes, planes), "bn2": bn(planes),
            "conv3": conv(1, planes, 4 * planes), "bn3": bn(4 * planes),
            "downsample": {"conv": conv(1, inplanes, 4 * planes),
                           "bn": bn(4 * planes)}}


@pytest.mark.parametrize("layer", [(256, 128, 2, 1, 16), (1024, 512, 1, 2, 8)],
                         ids=["layer2_0", "layer4_0"])
def test_train_bottleneck_matches_jax(layer):
    """One train-mode Bottleneck with its downsample at full width (SCHP's
    layer2[0]: stride 2; layer4[0]: dilation 2), batch 2, against JAX's
    `_bottleneck` under a `BNTrainCtx`: the output and each ABN's batch
    moments within 1e-5 of their max, dx and the gradient of every
    parameter against `jax.grad` within 1e-5 of its max (measured 2.2e-6
    at most). Every branch ABN is live here, which the full-depth step
    test's conditioning cannot show leaf by leaf."""
    from imagdressing_tpu.preprocess.parsing import model as jschp
    from imagdressing_tpu_torch.convert import state_dict_from_jax
    from imagdressing_tpu_torch.preprocess.parsing import model as pschp

    inplanes, planes, stride, dilation, hw = layer
    rng = np.random.default_rng(inplanes)
    tree = _bottleneck_tree(rng, inplanes, planes)
    x = rng.standard_normal((2, hw, hw, inplanes)).astype(np.float32)
    g = rng.standard_normal((2, hw // stride, hw // stride, 4 * planes)
                            ).astype(np.float32)

    def loss(p, x):
        ctx = jschp.BNTrainCtx()
        y = jschp._bottleneck(p, x, stride=stride, dilation=dilation,
                              ctx=ctx)
        return jnp.sum(y * g), (y, [(m, v) for _, m, v in ctx.stats])

    (_, (y_want, stats_want)), (dp_want, dx_want) = jax.jit(
        jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        tree, jnp.asarray(x))
    block = pschp.Bottleneck(inplanes, planes, stride=stride,
                             dilation=dilation, downsample=True)
    block.load_state_dict(state_dict_from_jax(tree))
    xt = torch.tensor(x, requires_grad=True)
    ctx = pschp.BNTrainCtx()
    y = block(xt, ctx)
    (y * torch.from_numpy(g)).sum().backward()
    assert _rel(y.detach(), y_want) <= 1e-5
    assert len(ctx.stats) == len(stats_want) == 4
    for (_, mean, var), (mean_want, var_want) in zip(ctx.stats, stats_want):
        assert _rel(mean, mean_want) <= 1e-5 and _rel(var, var_want) <= 1e-5
    assert _rel(xt.grad, dx_want) <= 1e-5
    grads_want = state_dict_from_jax(dp_want)
    for k, v in block.named_parameters():
        assert _rel(v.grad, grads_want[k]) <= 1e-5, k


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def _loss_inputs(seed, shape=(2, 12, 10), c=NUM_CLASSES):
    """Logits on a coarse grid (many tied probabilities, so tied Lovász
    errors), labels with ~10 % ignored (255) pixels and one class absent."""
    rng = np.random.default_rng(seed)
    logits = (rng.integers(-2, 3, shape + (c,)) * 0.5).astype(np.float32)
    labels = rng.integers(0, c - 1, shape).astype(np.int32)
    labels[rng.random(shape) < 0.1] = 255
    target = rng.standard_normal(shape + (c,)).astype(np.float32)
    return logits, labels, target


def _edge_inputs(seed, shape=(2, 12, 10)):
    rng = np.random.default_rng(seed)
    edge_logits = rng.standard_normal(shape + (2,)).astype(np.float32)
    edges = (rng.random(shape) < 0.2).astype(np.int32)
    edges[rng.random(shape) < 0.05] = 255
    return edge_logits, edges


_LOSSES = {
    "cross_entropy": lambda m, lg, lb, tg: m.cross_entropy_2d(lg, lb),
    "cross_entropy_weighted": lambda m, lg, lb, tg: m.cross_entropy_2d(
        lg, lb, class_weights=_as(m, np.linspace(0.5, 2.0, NUM_CLASSES,
                                                 dtype=np.float32))),
    "lovasz_softmax": lambda m, lg, lb, tg: m.lovasz_softmax(lg, lb),
    "soft_dice": lambda m, lg, lb, tg: m.soft_dice_loss(lg, lb),
    "kl_consistency": lambda m, lg, lb, tg: m.kl_consistency(lg, tg, lb),
    "kl_consistency_unmasked": lambda m, lg, lb, tg: m.kl_consistency(
        lg, tg, temperature=2.0),
}


def _as(module, a):
    return torch.from_numpy(a) if module is ploss else jnp.asarray(a)


@pytest.mark.parametrize("name", list(_LOSSES))
def test_losses_match_jax(name):
    """Each loss against JAX's on the same logits, labels (ignored pixels,
    an absent class) and targets: within 1e-6 relative (fp32 sum order)."""
    logits, labels, target = _loss_inputs(len(name))
    fn = _LOSSES[name]
    want = float(jax.jit(lambda *a: fn(jloss, *a))(
        jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(target)))
    got = float(fn(ploss, torch.from_numpy(logits), torch.from_numpy(labels),
                   torch.from_numpy(target)))
    assert abs(got - want) <= 1e-6 * max(abs(want), 1.0)


def test_mean_iou_matches_jax():
    logits, labels, _ = _loss_inputs(4)
    pred = logits.argmax(-1).astype(np.int32)
    want = float(jax.jit(jloss.mean_iou, static_argnums=2)(
        jnp.asarray(pred), jnp.asarray(labels), NUM_CLASSES))
    got = float(ploss.mean_iou(torch.from_numpy(pred),
                               torch.from_numpy(labels), NUM_CLASSES))
    assert abs(got - want) <= 1e-7


def test_schp_criterion_and_gradient_match_jax():
    """The full criterion with the KL term, and its gradient with respect to
    both heads' logits against `jax.grad`: tied errors sort stably in both
    (JAX's argsort(-errors) keeps index order among ties), so the Lovász
    gradients agree too. Within 1e-5 * max."""
    logits, labels, target = _loss_inputs(7)
    edge_logits, edges = _edge_inputs(8)
    kw = dict(lovasz_weight=0.7, edge_weight=1.3, cycle_weight=0.5)

    def jfn(f, e):
        return jloss.schp_criterion(f, e, jnp.asarray(labels),
                                    jnp.asarray(edges),
                                    prev_fusion_logits=jnp.asarray(target),
                                    **kw)

    want, (gf_want, ge_want) = jax.jit(jax.value_and_grad(
        jfn, argnums=(0, 1)))(jnp.asarray(logits), jnp.asarray(edge_logits))
    f, e = (torch.tensor(a, requires_grad=True) for a in (logits,
                                                           edge_logits))
    got = ploss.schp_criterion(f, e, torch.from_numpy(labels),
                               torch.from_numpy(edges),
                               prev_fusion_logits=torch.from_numpy(target),
                               **kw)
    got.backward()
    assert abs(float(got.detach()) - float(want)) <= 1e-6 * abs(float(want))
    assert _rel(f.grad, gf_want) <= 1e-5
    assert _rel(e.grad, ge_want) <= 1e-5


# ---------------------------------------------------------------------------
# Optimizer, schedule, labels
# ---------------------------------------------------------------------------


def test_schedule_and_optimizer_match_optax():
    """3 steps on a toy tree (a matrix and a vector) with gradients from a
    quadratic: the poly lr at each step index and the parameters after
    optax's chain against torch.optim.SGD at the step's lr."""
    cfg = jtrain.ParsingTrainConfig(learning_rate=0.1, total_steps=4,
                                    weight_decay=0.05)
    pcfg = ptrain.ParsingTrainConfig(learning_rate=0.1, total_steps=4,
                                     weight_decay=0.05)
    rng = np.random.default_rng(0)
    tree = {"w": {"kernel": rng.standard_normal((3, 4)).astype(np.float32)},
            "b": rng.standard_normal(4).astype(np.float32)}
    target = rng.standard_normal(4).astype(np.float32)
    jsched, psched = jtrain.lr_schedule(cfg), ptrain.lr_schedule(pcfg)
    for i in range(6):
        assert psched(i) == float(jsched(jnp.int32(i)))

    def jloss_fn(p):
        return jnp.sum((jnp.ones(3) @ p["w"]["kernel"] + p["b"] - target)
                       ** 2)

    sgd = optax.chain(optax.add_decayed_weights(cfg.weight_decay),
                      optax.trace(decay=cfg.momentum), optax.scale(-1.0))
    jp = jax.tree.map(jnp.asarray, tree)
    state = sgd.init(jp)
    module = torch.nn.Module()
    module.kernel = torch.nn.Parameter(torch.from_numpy(tree["w"]["kernel"]))
    module.bias = torch.nn.Parameter(torch.from_numpy(tree["b"]))
    opt = ptrain.make_optimizer(pcfg, module)
    for i in range(3):
        g = jax.grad(jloss_fn)(jp)
        u, state = sgd.update(g, state, jp)
        lr = jsched(i)
        jp = optax.apply_updates(jp, jax.tree.map(lambda v: v * lr, u))
        opt.zero_grad()
        ((torch.ones(3) @ module.kernel + module.bias
          - torch.from_numpy(target)) ** 2).sum().backward()
        for group in opt.param_groups:
            group["lr"] = psched(i)
        opt.step()
        np.testing.assert_allclose(module.kernel.detach(), jp["w"]["kernel"],
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(module.bias.detach(), jp["b"], rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("hw", [(64, 64, 16, 16), (50, 37, 13, 10),
                                (9, 9, 4, 5)])
def test_label_downsample_matches_jax_nearest(hw):
    h, w, oh, ow = hw
    labels = np.random.default_rng(h).integers(0, 20, (2, h, w)).astype(
        np.int32)
    want = np.asarray(jtrain._downsample_labels(jnp.asarray(labels), oh, ow))
    got = ptrain._downsample_labels(torch.from_numpy(labels), oh, ow)
    np.testing.assert_array_equal(got.numpy(), want)


def test_edges_from_labels():
    lab = np.zeros((4, 4), np.int32)
    lab[2:, :] = 3
    e = ptrain.edges_from_labels(lab)
    assert e[2].sum() == 4 and e[1].sum() == 0 and e[3].sum() == 0
    lab = np.random.default_rng(0).integers(0, 3, (2, 9, 7))
    np.testing.assert_array_equal(ptrain.edges_from_labels(lab),
                                  jtrain.edges_from_labels(lab))


# ---------------------------------------------------------------------------
# Dataset
# ---------------------------------------------------------------------------


def test_dataset_matches_jax(tmp_path):
    """JPEG and PNG images, gray and palette label PNGs (the palette's
    colours go through libpng's gray weights, as cv2.IMREAD_GRAYSCALE
    reads them), resized to 64x48: labels and edges equal, the normalized
    image equal to JAX's cv2 path."""
    images, labels = tmp_path / "images", tmp_path / "labels"
    images.mkdir()
    labels.mkdir()
    rng = np.random.default_rng(0)
    palette = rng.integers(0, 256, (256, 3)).astype(np.uint8)
    for i, ext in enumerate((".jpg", ".png", ".jpg")):
        photo = cv2.GaussianBlur(rng.integers(0, 256, (100, 80, 3)).astype(
            np.uint8), (0, 0), 2)
        cv2.imwrite(str(images / f"s{i}{ext}"), photo)
        lab = rng.integers(0, NUM_CLASSES, (100, 80)).astype(np.uint8)
        if i == 1:
            im = Image.fromarray(lab, "P")
            im.putpalette(palette.flatten().tolist())
            im.save(labels / f"s{i}.png")
        else:
            cv2.imwrite(str(labels / f"s{i}.png"), lab)
    want = jtrain.ParsingDataset(str(images), str(labels), h=64, w=48)
    got = ptrain.ParsingDataset(str(images), str(labels), h=64, w=48)
    assert got.ids == want.ids and len(got) == 3
    for i in range(3):
        a, b = got.get(i), want.get(i)
        for k in ("label", "edge"):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
        np.testing.assert_array_equal(a["image"], b["image"])
    batch = got.batch([0, 2])
    assert batch["image"].shape == (2, 64, 48, 3)
