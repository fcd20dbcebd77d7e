"""The port's `ops/rotated_boxes` against the JAX package's module: equal
arrays, bit for bit, on seeded boxes (disjoint, nested, identical, and
rotated by 0, 45 and 90 degrees), from numpy arrays and from CPU tensors."""

import numpy as np
import torch

from imagdressing_tpu.ops import rotated_boxes as jrb
from imagdressing_tpu_torch.ops import rotated_boxes as rb


def _boxes(seed, n=24):
    rng = np.random.default_rng(seed)
    b = np.column_stack([rng.uniform(0, 20, (n, 2)), rng.uniform(1, 6, (n, 2)),
                         rng.uniform(-90, 90, n)])
    fixed = np.array([[5.0, 5.0, 4.0, 2.0, 0.0],    # and the same box
                      [5.0, 5.0, 4.0, 2.0, 0.0],
                      [5.0, 5.0, 1.0, 0.5, 0.0],    # nested in it
                      [5.0, 5.0, 4.0, 2.0, 45.0],   # rotated 45 / 90
                      [5.0, 5.0, 4.0, 2.0, 90.0],
                      [60.0, 60.0, 3.0, 3.0, 30.0]])  # disjoint
    return np.concatenate([fixed, b])


def test_pairwise_iou_rotated_equals_jax():
    for seed, dtype in ((0, np.float64), (1, np.float32)):
        a, b = _boxes(seed).astype(dtype), _boxes(seed + 10).astype(dtype)
        want = jrb.pairwise_iou_rotated(a, b)
        np.testing.assert_array_equal(rb.pairwise_iou_rotated(a, b), want)
        np.testing.assert_array_equal(
            rb.pairwise_iou_rotated(torch.from_numpy(a), torch.from_numpy(b)),
            want)
        np.testing.assert_array_equal(rb.box_to_corners(torch.from_numpy(a)),
                                      jrb.box_to_corners(a))
    iou = rb.pairwise_iou_rotated(_boxes(0)[:6], _boxes(0)[:6])
    assert iou[0, 1] == 1.0 and iou[0, 2] == 0.0625 and iou[0, 5] == 0.0
    assert 0 < iou[0, 3] < 1 and 0 < iou[0, 4] < 1


def test_nms_rotated_equals_jax():
    for seed in range(2):
        boxes = _boxes(seed, 40)
        scores = np.random.default_rng(seed + 5).random(len(boxes))
        for thr in (0.1, 0.5):
            want = jrb.nms_rotated(boxes, scores, thr)
            got = rb.nms_rotated(boxes, scores, thr)
            assert got.dtype == want.dtype == np.int64
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(
                rb.nms_rotated(torch.from_numpy(boxes),
                               torch.from_numpy(scores), thr), want)
