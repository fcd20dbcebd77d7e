"""The port's person detector (`imagdressing_tpu_torch/detect/`,
`ops/boxes.py`, `ops/roi_align.py`) against the JAX package on the CPU, at
the tiny config, fp32.

The cheap JAX functions (box ops, NMS, ROI align, matching, sampling, the
mask crops, optax) run live. The jitted detector (backbone, FPN, RPN, the
ROI heads, `detection_loss` with its gradient, `detect_instances`) costs
3-35 s of XLA compile per entry, so its outputs are recorded once in
`tests/goldens/jax_detect_tiny.npz`, from `maskrcnn.init(PRNGKey(0),
tiny_config())` (stored as the JAX CLI's flat "p{i}" leaves, which the
port then loads) on a fixed noisy 2-image batch; the loss's sampling draws
are the priorities JAX's key gives, recorded beside it and fed to the
port. Re-record it (JAX on the CPU, about a minute):

    JAX_PLATFORMS=cpu python tests/test_torch_detect.py

`test_detect_golden_is_current` (slow) recomputes it live.

Tolerances, fp32: losses 1e-5 relative; features, logits, gradients 1e-4
of the reference's max |value| (both sides sum in their own order); box
coordinates and ROI features 1e-4 absolute on values up to 64; discrete
outputs (indices, validity, labels, samples, proposals' order) exact.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from imagdressing_tpu.detect import infer as jinfer
from imagdressing_tpu.detect import maskrcnn as jm
from imagdressing_tpu.detect import targets as jt
from imagdressing_tpu.detect import train as jtrain
from imagdressing_tpu.ops import boxes as jb
from imagdressing_tpu.ops import roi_align as jr
from imagdressing_tpu_torch.apps import detect_cli
from imagdressing_tpu_torch.convert import (
    detector_params_from_jax,
    jax_leaf_order,
    tree_from_flat_leaves,
    tree_from_module,
    tree_paths,
)
from imagdressing_tpu_torch.detect import infer as tinfer
from imagdressing_tpu_torch.detect import maskrcnn as tm
from imagdressing_tpu_torch.detect import targets as tt
from imagdressing_tpu_torch.detect import train as ttrain
from imagdressing_tpu_torch.ops import boxes as tb
from imagdressing_tpu_torch.ops import roi_align as tr
from imagdressing_tpu_torch.tools.detect_check import (
    data_parallel_vs_one,
    synthetic_batch,
)

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens",
                      "jax_detect_tiny.npz")
SIZE = 64
KEY = 7  # the loss's PRNG key
MAX_DET = 5


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def close(got, want, tol=1e-4):
    """|got - want| <= tol * max|want| (elementwise, fp32 sum orders)."""
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    bound = tol * max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= bound, f"max err {err} > {bound}"


def t(x):
    return torch.from_numpy(np.array(x))


def jax_tree_paths(cfg):
    """The JAX detector tree's "/" paths (from its shapes, no compile)."""
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), cfg))
    return ["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(shapes)[0]]


def jax_draws(key, b, n_anchor, n_roi, stages):
    """The priorities JAX's `detection_loss` draws from `key`: per image
    rngs[i, 0] for the RPN and rngs[i, 2 + stage] for each ROI stage, each
    split into (positive, negative) uniforms."""
    rngs = jax.random.split(key, b * (2 + stages)).reshape(b, -1, 2)
    out = {}

    def pair(k, n):
        kp, kn = jax.random.split(k)
        return (np.asarray(jax.random.uniform(kp, (n,))),
                np.asarray(jax.random.uniform(kn, (n,))))

    for name, col, n in [("rpn", 0, n_anchor)] + [
            (f"roi{s}", 2 + s, n_roi) for s in range(stages)]:
        pos, neg = zip(*(pair(rngs[i, col], n) for i in range(b)))
        out[f"draw_{name}_pos"] = np.stack(pos)
        out[f"draw_{name}_neg"] = np.stack(neg)
    return out


def record_detect_golden():
    cfg = jm.tiny_config()
    params = jm.init(jax.random.PRNGKey(0), cfg)
    batch = {k: jnp.asarray(v) for k, v in synthetic_batch(cfg).items()}
    out = {f"p{i}": np.asarray(a)
           for i, a in enumerate(jax.tree.leaves(params))}
    b = batch["image"].shape[0]
    feats = jax.jit(lambda p, x: jm.apply_backbone_fpn(p, cfg, x))(
        params, batch["image"])
    for i, f in enumerate(feats):
        out[f"feat{i}"] = np.asarray(f)
    obj, dts = jax.jit(lambda p, f: jm.apply_rpn_head(p, f, cfg))(
        params, feats)
    out["objectness"], out["rpn_deltas"] = np.asarray(obj), np.asarray(dts)
    anchors = jnp.asarray(np.concatenate(jm.generate_anchors(
        cfg, (SIZE, SIZE))))
    props, pvalid = jm.rpn_proposals(cfg, anchors, obj, dts, (SIZE, SIZE))
    out["proposals"], out["pvalid"] = np.asarray(props), np.asarray(pvalid)
    # the ROI heads and the mask head fed JAX's proposals + the gt boxes
    rois = jnp.concatenate([props, batch["gt_boxes"]], axis=1)
    n_roi = rois.shape[1]
    rois5 = jnp.concatenate([
        jnp.repeat(jnp.arange(b, dtype=jnp.float32), n_roi)[:, None],
        rois.reshape(-1, 4)], axis=1)
    out["rois5"] = np.asarray(rois5)
    cls, box = jm.roi_forward(params, cfg, feats, rois5)
    out["roi_cls"], out["roi_box"] = np.asarray(cls), np.asarray(box)
    out["roi_mask"] = np.asarray(jm.mask_forward(params, cfg, feats, rois5))

    key = jax.random.PRNGKey(KEY)
    out.update(jax_draws(key, b, anchors.shape[0], n_roi,
                         len(cfg.cascade_ious)))
    (total, parts), grads = jax.jit(jax.value_and_grad(
        lambda p: jtrain.detection_loss(p, cfg, batch, key),
        has_aux=True))(params)
    for k, v in parts.items():
        out[f"loss_{k}"] = np.asarray(v)
    for i, g in enumerate(jax.tree.leaves(grads)):
        out[f"g{i}"] = np.asarray(g)
    det = jinfer.detect_instances(params, cfg, batch["image"],
                                  max_detections=MAX_DET,
                                  score_threshold=0.0, nms_threshold=0.5)
    for k, v in det.items():
        out[f"det_{k}"] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as f:
        return dict(f)


@pytest.fixture(scope="module")
def tiny(golden):
    """(cfg, the port's model with JAX's weights, the JAX tree, batch)."""
    cfg = jm.tiny_config()
    flat = leaves(golden, "p")
    tree = tree_from_flat_leaves(flat, jax_tree_paths(cfg))
    model = tm.MaskRCNN(tm.tiny_config())
    model.load_state_dict(detector_params_from_jax(tree))
    batch = synthetic_batch(cfg)
    return cfg, model, tree, batch


def leaves(golden, prefix):
    """The golden's "p{i}" (parameters) or "g{i}" (gradients) in order."""
    n = len([k for k in golden if k[0] == prefix and k[1:].isdigit()])
    return {f"{prefix}{i}": golden[f"{prefix}{i}"] for i in range(n)}


def port_draws(golden, stages=1):
    d = {"rpn": (t(golden["draw_rpn_pos"]), t(golden["draw_rpn_neg"]))}
    for s in range(stages):
        d[f"roi{s}"] = (t(golden[f"draw_roi{s}_pos"]),
                        t(golden[f"draw_roi{s}_neg"]))
    return d


# ------------------------------------------------------------- box ops ----


def random_boxes(rng, n, lo=0.0, hi=50.0):
    xy = rng.uniform(lo, hi, (n, 2))
    wh = rng.uniform(2, 25, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def test_box_ops_match_jax():
    rng = np.random.default_rng(0)
    a, c = random_boxes(rng, 17), random_boxes(rng, 9)
    a[3] = a[5]  # an exact duplicate and a degenerate box
    a[4, 2:] = a[4, :2]
    close(tb.pairwise_iou(t(a), t(c)), jb.pairwise_iou(a, c), 1e-6)
    close(tb.box_area(t(a)), jb.box_area(a), 1e-6)
    for w in [(1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)]:
        d = jb.encode_boxes(a, c[:1].repeat(17, 0), w)
        close(tb.encode_boxes(t(a), t(c[:1].repeat(17, 0)), w), d, 1e-5)
        big = np.asarray(d).copy()
        big[:, 2:] += 9.0  # past the dw / dh clamp
        close(tb.decode_boxes(t(big), t(c[:1].repeat(17, 0)), w),
              jb.decode_boxes(big, c[:1].repeat(17, 0), w), 1e-6)
    close(tb.clip_boxes(t(a), 30.0, 40.0), jb.clip_boxes(a, 30.0, 40.0), 0)


@pytest.mark.parametrize("score_threshold", [-np.inf, 0.5])
def test_nms_fixed_matches_jax(score_threshold):
    """Batched over 3 images (one with every score under the threshold):
    indices and validity exact, padding included (max_out > survivors)."""
    rng = np.random.default_rng(1)
    boxes = np.stack([random_boxes(rng, 30) for _ in range(3)])
    scores = rng.uniform(size=(3, 30)).astype(np.float32)
    scores[2] *= 0.4
    scores[0, 7] = scores[0, 3]  # an exact tie: the lower index first
    got_i, got_v = tb.nms_fixed(t(boxes), t(scores), iou_threshold=0.3,
                                max_out=32, score_threshold=score_threshold)
    nms = jax.jit(functools.partial(jb.nms_fixed, iou_threshold=0.3,
                                    max_out=32,
                                    score_threshold=score_threshold))
    for i in range(3):
        want_i, want_v = nms(jnp.asarray(boxes[i]), jnp.asarray(scores[i]))
        np.testing.assert_array_equal(got_v[i].numpy(), want_v)
        np.testing.assert_array_equal(got_i[i].numpy(), want_i)
    one_i, one_v = tb.nms_fixed(t(boxes[0]), t(scores[0]),
                                iou_threshold=0.3, max_out=32,
                                score_threshold=score_threshold)
    assert torch.equal(one_i, got_i[0]) and torch.equal(one_v, got_v[0])


def test_top_k_breaks_ties_as_jax():
    x = np.asarray([[0.5, 0.9, 0.5, 0.1, 0.9, 0.5]], np.float32)
    want_v, want_i = jax.lax.top_k(x, 4)
    got_v, got_i = tb.top_k(t(x), 4)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_array_equal(got_v.numpy(), want_v)


# ----------------------------------------------------------- roi align ----


@pytest.mark.parametrize("aligned,scale", [(True, 1.0), (True, 0.25),
                                           (False, 0.5)])
def test_roi_align_matches_jax(aligned, scale):
    """Boxes inside, across and beyond the border (the clamp and zero
    bands), on 2 images: within 1e-4 of max|ref|."""
    rng = np.random.default_rng(2)
    f = rng.standard_normal((2, 13, 17, 5)).astype(np.float32)
    n = 24
    xy = rng.uniform(-6, 18, (n, 2)) / scale
    wh = rng.uniform(0.3, 14, (n, 2)) / scale
    boxes = np.concatenate([rng.integers(0, 2, (n, 1)), xy, xy + wh],
                           1).astype(np.float32)
    want = jr.roi_align(jnp.asarray(f), jnp.asarray(boxes), output_size=7,
                        spatial_scale=scale, aligned=aligned)
    close(tr.roi_align(t(f), t(boxes), 7, scale, 2, aligned), want)


def test_roi_align_rotated_matches_jax():
    rng = np.random.default_rng(3)
    f = rng.standard_normal((2, 11, 14, 4)).astype(np.float32)
    n = 16
    rois = np.concatenate([
        rng.integers(0, 2, (n, 1)), rng.uniform(-2, 30, (n, 2)),
        rng.uniform(0.5, 16, (n, 2)), rng.uniform(-180, 180, (n, 1))],
        1).astype(np.float32)
    want = jr.roi_align_rotated(jnp.asarray(f), jnp.asarray(rois),
                                output_size=5, spatial_scale=0.5)
    close(tr.roi_align_rotated(t(f), t(rois), 5, 0.5), want)


def test_roi_align_gradient_matches_jax():
    rng = np.random.default_rng(4)
    f = rng.standard_normal((2, 9, 11, 3)).astype(np.float32)
    boxes = np.concatenate([rng.integers(0, 2, (10, 1)),
                            random_boxes(rng, 10, -2, 8) / 2], 1).astype(
        np.float32)
    g = rng.standard_normal((10, 4, 4, 3)).astype(np.float32)
    want = jax.grad(lambda x: (jr.roi_align(x, jnp.asarray(boxes), 4, 1.0)
                               * g).sum())(jnp.asarray(f))
    x = t(f).requires_grad_(True)
    (tr.roi_align(x, t(boxes), 4, 1.0) * t(g)).sum().backward()
    close(x.grad, want)


# ------------------------------------------------------------- targets ----


def test_match_boxes_matches_jax():
    """RPN-style (low-quality matches forced, two gts sharing their best
    candidate) and ROI-style, with padding gts: matched indices and labels
    exact."""
    rng = np.random.default_rng(5)
    cands = np.stack([random_boxes(rng, 60) for _ in range(2)])
    gts = np.zeros((2, 4, 4), np.float32)
    valid = np.zeros((2, 4), bool)
    gts[0, :2] = cands[0, [3, 9]] + rng.uniform(-3, 3, (2, 4))
    gts[1, :3] = random_boxes(rng, 3)
    valid[0, :2] = valid[1, :3] = True
    for pos, neg, low in [(0.7, 0.3, True), (0.5, 0.5, False)]:
        got_m, got_l = tt.match_boxes(t(cands), t(gts), t(valid),
                                      pos_iou=pos, neg_iou=neg,
                                      allow_low_quality=low)
        match = jax.jit(functools.partial(jt.match_boxes, pos_iou=pos,
                                          neg_iou=neg,
                                          allow_low_quality=low))
        for i in range(2):
            want_m, want_l = match(jnp.asarray(cands[i]), jnp.asarray(gts[i]),
                                   jnp.asarray(valid[i]))
            np.testing.assert_array_equal(got_l[i].numpy(), want_l)
            np.testing.assert_array_equal(got_m[i].numpy(), want_m)


def test_sample_balanced_on_jax_priorities():
    """JAX's draws from its key, fed to the port: the same slots."""
    rng = np.random.default_rng(6)
    labels = rng.choice([-1, 0, 1], p=[0.2, 0.7, 0.1],
                        size=(2, 300)).astype(np.int32)
    labels[1, :] = np.where(labels[1] == 1, 0, labels[1])  # no positives
    sample = jax.jit(functools.partial(jt.sample_balanced, num_samples=64,
                                       positive_fraction=0.25))
    for i, key in enumerate(jax.random.split(jax.random.PRNGKey(11), 2)):
        want_sel, want_pos = sample(jnp.asarray(labels[i]), key)
        kp, kn = jax.random.split(key)
        pri = (t(jax.random.uniform(kp, (300,)))[None],
               t(jax.random.uniform(kn, (300,)))[None])
        got_sel, got_pos = tt.sample_balanced(
            t(labels[i:i + 1]).long(), pri, num_samples=64,
            positive_fraction=0.25)
        np.testing.assert_array_equal(got_sel[0].numpy(), want_sel)
        np.testing.assert_array_equal(got_pos[0].numpy(), want_pos)
        assert got_sel.sum() <= 64 and got_pos.sum() <= 16


def test_crop_gt_masks_matches_jax():
    rng = np.random.default_rng(7)
    masks = (rng.uniform(size=(2, 3, 40, 36)) < 0.5).astype(np.float32)
    masks[:, :, 5:30, 4:20] = 1.0
    matched = rng.integers(0, 3, (2, 12))
    rois = np.stack([random_boxes(rng, 12, -2, 25) for _ in range(2)])
    got = tt.crop_gt_masks(t(masks), t(matched), t(rois), 14)
    crop = jax.jit(jt.crop_gt_masks, static_argnums=3)
    for i in range(2):
        want = crop(jnp.asarray(masks[i]), jnp.asarray(matched[i]),
                    jnp.asarray(rois[i]), 14)
        np.testing.assert_array_equal(got[i].numpy(), want)


# ------------------------------------------------------ the detector ----


def test_anchors_match_jax():
    cfg = jm.tiny_config()
    for want, got in zip(jm.generate_anchors(cfg, (64, 128)),
                         tm.generate_anchors(tm.tiny_config(), (64, 128))):
        np.testing.assert_array_equal(got, want)


def test_backbone_fpn_rpn_match_jax(tiny, golden):
    cfg, model, _, batch = tiny
    with torch.no_grad():
        feats = tm.apply_backbone_fpn(model, t(batch["image"]))
        obj, dts = tm.apply_rpn_head(model, feats)
    for i, f in enumerate(feats):
        close(f, golden[f"feat{i}"])
    close(obj, golden["objectness"])
    close(dts, golden["rpn_deltas"])


def test_rpn_proposals_match_jax(tiny, golden):
    """Fed JAX's objectness and deltas: the same proposals in the same
    order, validity exact."""
    cfg, model, _, _ = tiny
    anchors = tm.anchors_on(model.cfg, (SIZE, SIZE), "cpu")
    props, valid = tm.rpn_proposals(model.cfg, anchors,
                                    t(golden["objectness"]),
                                    t(golden["rpn_deltas"]), (SIZE, SIZE))
    np.testing.assert_array_equal(valid.numpy(), golden["pvalid"])
    np.testing.assert_allclose(props.numpy(), golden["proposals"],
                               atol=1e-4)


def test_roi_and_mask_heads_match_jax(tiny, golden):
    """Fed JAX's proposals (and the gt boxes): the level assignment, the
    multi-level ROI align and the box / mask heads."""
    cfg, model, _, batch = tiny
    rois5 = t(golden["rois5"])
    with torch.no_grad():
        feats = tm.apply_backbone_fpn(model, t(batch["image"]))
        cls, box = tm.roi_forward(model, feats, rois5)
        mask = tm.mask_forward(model, feats, rois5)
    close(cls, golden["roi_cls"])
    close(box, golden["roi_box"])
    close(mask, golden["roi_mask"])


def test_detection_loss_and_grads_match_jax(tiny, golden):
    """The loss and every gradient on JAX's draws: each loss within 1e-5
    relative, each gradient leaf within 1e-4 of its max |ref|."""
    cfg, model, _, batch = tiny
    losses, grads = ttrain.loss_and_grads(
        model, {k: t(v) for k, v in batch.items()}, port_draws(golden))
    for k, v in losses.items():
        want = float(golden[f"loss_{k}"])
        got = float(v.detach())
        assert abs(got - want) <= 1e-5 * abs(want), (k, got, want)
    by_name = dict(zip([n for n, _ in model.named_parameters()], grads))
    order = detect_cli_order(model)
    assert len(order) == len(leaves(golden, "g"))
    for i, (name, layout) in enumerate(order):
        close(layout(by_name[name]), golden[f"g{i}"])


def test_detection_loss_fed_jax_proposals(tiny, golden):
    """The ROI and mask stages fed JAX's proposals (as the card's check
    feeds the CPU's where its own top-k or NMS flips): the same losses and
    gradients as JAX's own run, to the bounds above."""
    cfg, model, _, batch = tiny
    losses, grads = ttrain.loss_and_grads(
        model, {k: t(v) for k, v in batch.items()}, port_draws(golden),
        proposals=(t(golden["proposals"]), t(golden["pvalid"])))
    for k, v in losses.items():
        want = float(golden[f"loss_{k}"])
        assert abs(float(v.detach()) - want) <= 1e-5 * abs(want), k
    by_name = dict(zip([n for n, _ in model.named_parameters()], grads))
    for i, (name, layout) in enumerate(detect_cli_order(model)):
        close(layout(by_name[name]), golden[f"g{i}"])


def detect_cli_order(model):
    """The port's parameter names in the JAX leaves' order, each with the
    map from the port's layout to JAX's."""
    def jax_path(name):
        owner, leaf = name.rsplit(".", 1)
        if leaf == "weight":
            norm = isinstance(model.get_submodule(owner), tm.Norm)
            leaf = "scale" if norm else "kernel"
        return "/".join(owner.split(".") + [leaf])

    def layout(g):
        return g.t() if g.ndim == 2 else (g.permute(2, 3, 1, 0)
                                          if g.ndim == 4 else g)

    names = {jax_path(n): n for n, _ in model.named_parameters()}
    assert set(names) == set(tree_paths(tree_from_module(model)))
    return [(names[p], layout) for p in jax_leaf_order(list(names))]


def test_clip_adam_matches_optax(tiny, golden):
    """Two updates from one shared gradient (JAX's, scaled so that the
    first is clipped and the second not) against optax.chain(
    clip_by_global_norm(1.0), adam(1e-3)): within 1e-6 of max|param|."""
    cfg, model, tree, _ = tiny
    g_jax = list(leaves(golden, "g").values())
    p_jax = list(leaves(golden, "p").values())
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(1e-3))
    params = [jnp.asarray(p) for p in p_jax]
    state = tx.init(params)

    @jax.jit
    def update(gs, state, params):
        upd, state = tx.update(gs, state, params)
        return optax.apply_updates(params, upd), state

    order = detect_cli_order(model)
    port = {n: p.detach().clone() for n, p in model.named_parameters()}
    plist = [port[name] for name, _ in order]
    opt = ttrain.ClipAdam(plist, 1e-3)

    def to_port(a, p):
        x = t(a)
        return x.t() if x.ndim == 2 else (x.permute(3, 2, 0, 1)
                                          if x.ndim == 4 else x)

    norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                       for g in g_jax))
    for scale in (5.0 / norm, 0.2 / norm):
        gs = [g * np.float32(scale) for g in g_jax]
        params, state = update(gs, state, params)
        opt.step([to_port(g, p) for g, p in zip(gs, plist)])
        for (name, layout), p_jax, p in zip(order, params, plist):
            close(layout(p), p_jax, 1e-6)


def test_detect_instances_matches_jax(tiny, golden):
    """detect_instances at score threshold 0: boxes, scores, validity and
    masks; then the mask head fed JAX's detections."""
    cfg, model, _, batch = tiny
    det = tinfer.detect_instances(model, t(batch["image"]),
                                  max_detections=MAX_DET,
                                  score_threshold=0.0, nms_threshold=0.5)
    np.testing.assert_array_equal(det["valid"].numpy(), golden["det_valid"])
    np.testing.assert_allclose(det["boxes"].numpy(), golden["det_boxes"],
                               atol=1e-4)
    close(det["scores"], golden["det_scores"])
    close(det["masks"], golden["det_masks"])
    with torch.no_grad():
        feats = tm.apply_backbone_fpn(model, t(batch["image"]))
        mask = torch.sigmoid(tm.mask_forward(
            model, feats, tm.rois_with_batch(t(golden["det_boxes"])))[..., 0])
    close(mask.reshape(golden["det_masks"].shape), golden["det_masks"])


def test_detector_params_from_jax_and_flat_npz(tiny, golden, tmp_path):
    """The JAX tree converts leaf by leaf (HWIO -> OIHW, (in, out) -> (out,
    in)); the JAX CLI's flat .npz loads through `detect_cli.load_params`;
    the port's `save_params` writes that file back bit-equal."""
    cfg, model, tree, _ = tiny
    sd = detector_params_from_jax(tree)
    k = "backbone.stages.0.0.conv1.weight"
    np.testing.assert_array_equal(
        sd[k].numpy(), np.transpose(tree["backbone"]["stages"]["0"]["0"]
                                    ["conv1"]["kernel"], (3, 2, 0, 1)))
    np.testing.assert_array_equal(
        sd["box_heads.0.fc1.weight"].numpy(),
        tree["box_heads"]["0"]["fc1"]["kernel"].T)
    path = tmp_path / "jax_cli.npz"
    flat = leaves(golden, "p")
    np.savez_compressed(path, **flat)  # as the JAX CLI's `_save_params`
    loaded = detect_cli.load_params(str(path), cfg, "cpu")
    for name, p in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[name], p), name
    out = tmp_path / "port.npz"
    detect_cli.save_params(str(out), loaded)
    with np.load(out) as back:
        assert sorted(back.files) == sorted(flat)
        for k, v in flat.items():
            np.testing.assert_array_equal(back[k], v)
    with pytest.raises(ValueError, match="leaves"):
        detect_cli.load_params(str(path), jm.MaskRCNNConfig(), "cpu")


# ------------------------------------------------------- data parallel ----


def test_data_parallel_step_matches_one_process(tiny, golden):
    """Two gloo ranks, one image each, against one process on both
    (`tools/detect_check.py`): the loss (its normalisers summed over the
    ranks) within 1e-5 relative, the summed gradients within 1e-4 of
    max|ref|; the step (lr 1e-3) of every parameter within 1e-2 of lr of
    ClipAdam replayed on the rank's gradients, and of this process's step
    wherever the gradient's sign is not rounding's (Adam's first step is
    +-lr whatever the gradient's size), which must be at least half the
    elements; both ranks' parameters bit-equal."""
    cfg, model, _, batch = tiny
    errs = data_parallel_vs_one(model, {k: t(v) for k, v in batch.items()},
                                port_draws(golden))
    n = sum(p.numel() for p in model.parameters())
    assert errs["loss_rel_err"] <= 1e-5, errs
    assert errs["step_loss_rel_err"] <= 1e-5, errs
    assert errs["grad_err"] <= 1e-4, errs
    assert errs["replay_err"] <= 1e-2, errs
    assert errs["step_err"] <= 1e-2, errs
    assert errs["steps_over_floor"] >= n // 2, (errs, n)
    assert errs["ranks_equal"], errs


def test_device_summary_of_a_host_only_window():
    """`core.profiling.device_summary` (the detector profile's summary)
    counts device rows only: a window of host ops has no device time,
    launches or busy share."""
    from imagdressing_tpu_torch.core.profiling import device_summary

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        torch.ones(8, 8) @ torch.ones(8, 8)
    out = device_summary(prof, 2.0)
    assert out == {"wall_ms": 2.0, "device_ms": 0, "busy_share": 0.0,
                   "launches": 0, "top_device_ops": []}


@pytest.mark.slow
def test_detect_golden_is_current(golden):
    fresh = record_detect_golden()
    assert sorted(fresh) == sorted(golden)
    for k, v in fresh.items():
        np.testing.assert_allclose(v, golden[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_threefry_partitionable", True)
    np.savez_compressed(GOLDEN, **record_detect_golden())
    print("wrote", GOLDEN, os.path.getsize(GOLDEN), "bytes")
