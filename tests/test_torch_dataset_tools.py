"""The port's offline dataset tools (`tools/coco_annotations.py`,
`tools/dataset_fusion.py`, `tools/make_crop.py`, `detect/data.py`,
`detect/eval.py`, `detect/infer.py`'s host side, and the OpenCV stand-ins
in `preprocess/imgproc.py`) against the JAX package's tools on the CPU,
and the toolchain's CLIs chained on `--device cpu`.

The JAX tools call OpenCV; so do these tests, as the oracle (the port
imports no cv2). Exact unless stated: RLE, areas, boxes, contours (vertex
for vertex, at tolerance 0 and at the reference's 10), polygon fills,
letterboxed images and masks, panoptic maps, crop.json and the crops'
pixels; float resizes (the patch logits, the pasted masks) within float32
rounding; JPEG crops as written by the two encoders within a stated bound.
"""

import json
import os

import cv2
import numpy as np
import pytest
import torch

from imagdressing_tpu.detect import data as jdata
from imagdressing_tpu.detect import eval as jeval
from imagdressing_tpu.detect import infer as jinfer
from imagdressing_tpu.tools import coco_annotations as jcoco
from imagdressing_tpu.tools import dataset_fusion as jfusion
from imagdressing_tpu.tools import make_crop as jcrop
from imagdressing_tpu_torch.apps import detect_cli
from imagdressing_tpu_torch.apps import image_utils as iu
from imagdressing_tpu_torch.apps.png import encode_png
from imagdressing_tpu_torch.detect import data as tdata
from imagdressing_tpu_torch.detect import eval as teval
from imagdressing_tpu_torch.detect import infer as tinfer
from imagdressing_tpu_torch.preprocess import imgproc
from imagdressing_tpu_torch.tools import coco_annotations as tcoco
from imagdressing_tpu_torch.tools import dataset_fusion as tfusion
from imagdressing_tpu_torch.tools import make_crop as tcrop


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def blob_mask(rng, h, w, k, noise=0.0):
    """Ellipses xor-ed together (rings, holes, islands inside holes,
    components touching the border), optionally with speckle."""
    m = np.zeros((h, w), np.uint8)
    yy, xx = np.ogrid[:h, :w]
    for _ in range(k):
        cy, cx = rng.integers(0, h), rng.integers(0, w)
        ry, rx = rng.integers(1, h // 3 + 2), rng.integers(1, w // 3 + 2)
        m[((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1] ^= 1
    if noise:
        m |= (rng.random((h, w)) < noise).astype(np.uint8)
    return m


def masks(n=60, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        h, w = rng.integers(6, 70, 2)
        out.append(blob_mask(rng, h, w, rng.integers(1, 6),
                             0.04 if i % 2 else 0.0))
    return out


# ------------------------------------------------- OpenCV stand-ins ----


def test_find_contours_external_matches_cv2():
    """Every contour vertex for vertex, in OpenCV's order."""
    for m in masks():
        want = cv2.findContours(m.copy(), cv2.RETR_EXTERNAL,
                                cv2.CHAIN_APPROX_SIMPLE)[0]
        got = imgproc.find_contours_external(m)
        assert len(got) == len(want)
        for g, c in zip(got, want):
            np.testing.assert_array_equal(g, c.reshape(-1, 2))


@pytest.mark.parametrize("epsilon", [1.0, 2.0, 10.0])
def test_approx_poly_dp_matches_cv2(epsilon):
    """On the contours of blob masks and on random closed polylines."""
    rng = np.random.default_rng(1)
    curves = [c.reshape(-1, 2) for m in masks(40, 2) for c in
              cv2.findContours(m, cv2.RETR_EXTERNAL,
                               cv2.CHAIN_APPROX_SIMPLE)[0]]
    curves += [rng.integers(0, 30, (rng.integers(3, 14), 2)).astype(np.int32)
               for _ in range(100)]
    for c in curves:
        want = cv2.approxPolyDP(c.reshape(-1, 1, 2), epsilon, True)
        np.testing.assert_array_equal(imgproc.approx_poly_dp(c, epsilon),
                                      want.reshape(-1, 2))


def test_fill_poly_matches_cv2():
    """Several rings at once, non-convex, self-intersecting and overlapping
    (even-odd), vertices inside the image."""
    rng = np.random.default_rng(3)
    for _ in range(300):
        h, w = rng.integers(5, 50, 2)
        polys = [rng.integers(0, min(h, w), (rng.integers(3, 10), 2))
                 .astype(np.int32) for _ in range(rng.integers(1, 4))]
        want = np.zeros((h, w), np.uint8)
        cv2.fillPoly(want, polys, 1)
        got = np.zeros((h, w), np.uint8)
        imgproc.fill_poly(got, polys, 1)
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------- coco annotations ----


def test_rle_area_bbox_match_jax():
    for m in masks(30, 4) + [np.zeros((5, 7), np.uint8),
                             np.ones((3, 4), np.uint8)]:
        assert tcoco.binary_mask_to_rle(m) == jcoco.binary_mask_to_rle(m)
        assert tcoco.mask_area(m) == jcoco.mask_area(m)
        assert tcoco.mask_bbox(m) == jcoco.mask_bbox(m)
        rle = tcoco.binary_mask_to_rle(m)
        np.testing.assert_array_equal(tdata.rle_decode(rle),
                                      jdata.rle_decode(rle))


@pytest.mark.parametrize("tolerance", [0, 2, 10])
def test_binary_mask_to_polygon_matches_jax(tolerance):
    """The JAX tool's polygons come from cv2.findContours + approxPolyDP;
    the port's from its own trace: equal, and so are the masks they fill
    back (polygons_to_mask, cv2.fillPoly in the JAX package)."""
    for m in masks(40, 5):
        got = tcoco.binary_mask_to_polygon(m, tolerance)
        assert got == jcoco.binary_mask_to_polygon(m, tolerance)
        np.testing.assert_array_equal(
            tdata.polygons_to_mask(got, *m.shape),
            jdata.polygons_to_mask(got, *m.shape))


def write_dataset(root, n=3, seed=0, shapes=((45, 60), (60, 40), (50, 50))):
    """Person-like images with instance-id PNGs (ids 1..k, one sparse)."""
    rng = np.random.default_rng(seed)
    img_dir, ann_dir = root / "imgs", root / "anns"
    img_dir.mkdir()
    ann_dir.mkdir()
    for i in range(n):
        h, w = shapes[i % len(shapes)]
        img = rng.integers(0, 60, (h, w, 3), dtype=np.uint8)
        ids = np.zeros((h, w), np.uint8)
        for k, label in enumerate((1, 2, 5)[:1 + i % 3]):
            x0, y0 = rng.integers(0, w // 2), rng.integers(0, h // 2)
            x1 = min(w, x0 + rng.integers(8, w // 2 + 8))
            y1 = min(h, y0 + rng.integers(10, h // 2 + 10))
            yy, xx = np.ogrid[:h, :w]
            body = (((yy - (y0 + y1) / 2) / max((y1 - y0) / 2, 1)) ** 2
                    + ((xx - (x0 + x1) / 2) / max((x1 - x0) / 2, 1)) ** 2
                    <= 1)
            ids[body] = label
            img[body] = np.uint8(120 + 40 * k)
        iu.write_image(str(img_dir / f"im{i}.png"), img)
        (ann_dir / f"im{i}.png").write_bytes(encode_png(ids))  # gray
    return str(img_dir), str(ann_dir)


def strip_dates(coco):
    coco = json.loads(json.dumps(coco))
    coco["info"].pop("date_created", None)
    coco["info"].pop("year", None)
    for im in coco["images"]:
        im.pop("date_captured")
    return coco


def test_coco_annotations_cli_matches_jax(tmp_path):
    """`train` (with a val split), `test` and `idlist`: the same json
    (dates aside) and id list as the JAX tool's."""
    img_dir, ann_dir = write_dataset(tmp_path)
    for mod, out in ((tcoco, "port"), (jcoco, "jax")):
        d = str(tmp_path / out)
        mod.main(["train", "--json_save_dir", d, "--train_img_dir", img_dir,
                  "--train_anno_dir", ann_dir, "--use_val", "--val_img_dir",
                  img_dir, "--val_anno_dir", ann_dir])
        mod.main(["test", "--json_save_dir", d, "--test_img_dir", img_dir])
        mod.main(["idlist", "--img_dir", img_dir, "--out_file",
                  os.path.join(d, "id.txt")])
    for name in ("CIHP_trainval.json", "CIHP_val.json", "CIHP.json"):
        got = json.load(open(tmp_path / "port" / name))
        want = json.load(open(tmp_path / "jax" / name))
        assert strip_dates(got) == strip_dates(want), name
    got = json.load(open(tmp_path / "port" / "CIHP_trainval.json"))
    assert len(got["annotations"]) == 12  # 1 + 2 + 3 instances, twice
    assert (tmp_path / "port" / "id.txt").read_text() == \
        (tmp_path / "jax" / "id.txt").read_text()


# --------------------------------------------------- detector data ----


def test_coco_detection_data_matches_jax(tmp_path):
    """Letterboxed images (wide, tall, square; PNG), boxes, masks from
    polygons and from a crowd RLE, padding, and the shuffled wrap-around
    batches: equal to the JAX package's."""
    img_dir, ann_dir = write_dataset(tmp_path)
    tcoco.main(["train", "--json_save_dir", str(tmp_path / "j"),
                "--train_img_dir", img_dir, "--train_anno_dir", ann_dir])
    path = tmp_path / "j" / "CIHP_train.json"
    coco = json.load(open(path))
    crowd = np.zeros((45, 60), np.uint8)
    crowd[3:20, 30:58] = 1
    coco["annotations"].append(tcoco.create_annotation_info(
        99, coco["images"][0]["id"], {"id": 1, "is_crowd": 1}, crowd))
    path.write_text(json.dumps(coco))
    kw = dict(max_gt=4, image_size=64)
    got = tdata.CocoDetectionData(str(path), img_dir, **kw)
    want = jdata.CocoDetectionData(str(path), img_dir, **kw)
    for i in got.ids:
        a, b = got.load_example(i), want.load_example(i)
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    ga = got.batches(2, rng=np.random.default_rng(4), epochs=2)
    wa = want.batches(2, rng=np.random.default_rng(4), epochs=2)
    for a, b in zip(ga, wa):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # a data rank's rows of each global batch
    rows = next(got.batches(2, rng=np.random.default_rng(4), rank=1,
                            ranks=2))
    first = next(want.batches(2, rng=np.random.default_rng(4)))
    np.testing.assert_array_equal(rows["image"], first["image"][1:])


def test_paste_mask_and_to_instances_match_jax():
    """The ROI mask resized as cv2's INTER_LINEAR and thresholded: equal
    but for pixels whose value lies within 1e-5 of the threshold."""
    rng = np.random.default_rng(6)
    det = {"boxes": np.concatenate([rng.uniform(-5, 40, (1, 6, 2)),
                                    rng.uniform(45, 90, (1, 6, 2))], -1),
           "scores": rng.uniform(size=(1, 6)),
           "valid": rng.uniform(size=(1, 6)) < 0.7,
           "masks": rng.uniform(size=(1, 6, 14, 14)).astype(np.float32)}
    det["boxes"][0, 5] = [70, 10, 200, 30]  # in the letterbox padding
    got = tinfer.to_instances(det, 0, 60, 80)
    want = jinfer.to_instances(det, 0, 60, 80)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["score"] == w["score"] and g["bbox"] == w["bbox"]
        diff = g["segmentation"] != w["segmentation"]
        assert diff.sum() <= 2, diff.sum()


def test_average_precision_matches_jax():
    rng = np.random.default_rng(7)
    gt = {f"im{i}": rng.uniform(0, 50, (rng.integers(0, 4), 2)).repeat(
        2, 1) + np.array([0, 0, 20, 30]) for i in range(6)}
    det = {f"im{i}": [{"score": float(rng.uniform()),
                       "bbox": list(rng.uniform(0, 50, 2)) + [20.0, 30.0]}
                      for _ in range(rng.integers(0, 5))] for i in range(7)}
    assert teval.coco_map(det, gt) == jeval.coco_map(det, gt)
    assert teval.average_precision(det, gt, iou_threshold=0.3) == \
        jeval.average_precision(det, gt, iou_threshold=0.3)


# ------------------------------------------------------- fusion / crop ----


def test_mask_nms_stitch_fuse_match_jax():
    rng = np.random.default_rng(8)
    h, w, n, c = 40, 50, 5, 4
    ms = np.stack([blob_mask(rng, h, w, 2) for _ in range(n)], -1)
    scores = sorted(rng.uniform(0.2, 1.0, n), reverse=True)
    for conf, ov in ((0.5, 0.7), (0.0, 0.3)):
        got = tfusion.mask_nms(ms, scores, confidence_threshold=conf,
                               overlap_threshold=ov)
        want = jfusion.mask_nms(ms, scores, confidence_threshold=conf,
                                overlap_threshold=ov)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    patches = [rng.standard_normal((13, 9, c)).astype(np.float32),
               rng.standard_normal((20, 30, c)).astype(np.float32),
               rng.standard_normal((6, 6)).astype(np.float32)]
    boxes = [(2, 3, 20, 14), (10, 15, 20, 30), (30, 40, 9, 7)]
    got = tfusion.stitch_patch_logits(patches[:2], boxes[:2], h, w, c)
    want = jfusion.stitch_patch_logits(patches[:2], boxes[:2], h, w, c)
    np.testing.assert_allclose(got, want, atol=1e-5)
    got1 = tfusion.stitch_patch_logits(patches[2:], boxes[2:], h, w, 1)
    want1 = jfusion.stitch_patch_logits(patches[2:], boxes[2:], h, w, 1)
    np.testing.assert_allclose(got1, want1, atol=1e-5)
    glob = rng.standard_normal((h, w, c)).astype(np.float32)
    pan = tfusion.mask_nms(ms, scores)[0]
    for a, b in zip(tfusion.fuse_global_local(glob, want, pan),
                    jfusion.fuse_global_local(glob, want, pan)):
        np.testing.assert_array_equal(a, b)


def test_make_crop_matches_jax(tmp_path):
    """`run` of both tools on the same instances: crop.json field for
    field, the panoptic `_mask.npy` exactly; the crops in memory equal
    after the channel flip (JAX crops BGR); the written JPEGs (PIL against
    cv2, quality 95) within 8 levels of each other."""
    img_dir, _ = write_dataset(tmp_path)
    rng = np.random.default_rng(9)
    preds = {}
    for name in sorted(os.listdir(img_dir)):
        h, w = iu.read_image(os.path.join(img_dir, name)).shape[:2]
        insts = []
        for s in sorted(rng.uniform(0.3, 1.0, 4), reverse=True):
            m = blob_mask(rng, h, w, 1)
            ys, xs = np.nonzero(m)
            if not len(ys):
                continue
            insts.append({"score": float(s), "bbox": [
                float(xs.min()), float(ys.min()),
                float(xs.max() - xs.min()), float(ys.max() - ys.min())],
                "segmentation": m})
        preds[name] = insts
    det = str(tmp_path / "instances.npy")
    np.save(det, preds, allow_pickle=True)
    out_t = tcrop.run(img_dir, str(tmp_path / "t"), det, conf_thres=0.4)
    out_j = jcrop.run(img_dir, str(tmp_path / "j"), det, conf_thres=0.4)
    got, want = json.load(open(out_t)), json.load(open(out_j))
    assert got == want and sum(i["person_num"] for i in got["root"]) > 0
    for item in got["root"]:
        np.testing.assert_array_equal(
            np.load(tmp_path / "t" / "crop_mask" / item["mask_name"]),
            np.load(tmp_path / "j" / "crop_mask" / item["mask_name"]))
        rgb = iu.read_image(os.path.join(img_dir, item["im_name"]))
        _, crops_t, _ = tcrop.crop_image_instances(
            rgb, preds[item["im_name"]], item["im_name"], conf_thres=0.4)
        _, crops_j, _ = jcrop.crop_image_instances(
            rgb[..., ::-1], preds[item["im_name"]], item["im_name"],
            conf_thres=0.4)
        for (na, a), (nb, b) in zip(crops_t, crops_j):
            assert na == nb
            np.testing.assert_array_equal(a, b[..., ::-1])
        for name in item["bbox_name"]:
            a = iu.read_image(str(tmp_path / "t" / "crop_pic" / name))
            b = cv2.imread(str(tmp_path / "j" / "crop_pic" / name))[..., ::-1]
            assert np.abs(a.astype(int) - b).max() <= 8


# ------------------------------------------------------------ the chain ----


def test_toolchain_cli_chain_on_cpu(tmp_path, monkeypatch):
    """coco_annotations train -> detect_cli train --tiny --steps 2 ->
    detect_cli infer -> make_crop, on --device cpu; the card is the
    default and raises here."""
    # the CLI's spawned ranks start torch with two threads, as this process
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    img_dir, ann_dir = write_dataset(tmp_path, n=3)
    out = tmp_path / "coco"
    tcoco.main(["train", "--json_save_dir", str(out), "--train_img_dir",
                img_dir, "--train_anno_dir", ann_dir])
    ann = str(out / "CIHP_train.json")
    params = str(tmp_path / "det.npz")
    common = ["--annotations", ann, "--img_dir", img_dir, "--image_size",
              "64", "--tiny"]
    with pytest.raises(RuntimeError, match="CUDA"):
        detect_cli.main(["train", *common, "--out", params, "--steps", "1"])
    res = detect_cli.main(["train", *common, "--out", params, "--steps",
                           "2", "--batch_size", "2", "--device", "cpu"])
    assert len(res["losses"]) == 2 and all(np.isfinite(res["losses"]))
    assert set(res["metrics"][0]) >= {"rpn_obj", "rpn_box", "roi0_cls",
                                      "roi0_box", "mask", "grad_norm"}
    with pytest.raises(SystemExit, match="needs 2 GPUs; 0 visible"):
        detect_cli.main(["train", *common, "--out", params,
                         "--data_parallel", "2"])  # no CPU stands in
    with pytest.raises(SystemExit, match="allow_cpu_mesh"):
        detect_cli.main(["train", *common, "--out", params, "--device",
                         "cpu", "--data_parallel", "2"])
    # two steps over 2 gloo ranks (one image each): every step's losses
    # and grad_norm, which sum over the ranks' images and draws and follow
    # the first step's update, are the one process's
    one, two = str(tmp_path / "one.npz"), str(tmp_path / "two.npz")
    step = ["--steps", "2", "--batch_size", "2", "--device", "cpu"]
    want = detect_cli.main(["train", *common, *step, "--out", one])
    got = detect_cli.main(["train", *common, *step, "--out", two,
                           "--data_parallel", "2", "--allow_cpu_mesh"])
    assert len(got["metrics"]) == 2 and os.path.exists(two)
    for a, b in zip(got["metrics"], want["metrics"]):
        assert sorted(a) == sorted(b)
        for k in b:
            assert abs(a[k] - b[k]) <= 1e-5 * abs(b[k]), (k, a, b)
    inst = str(tmp_path / "instances.npy")
    got = detect_cli.main(["infer", *common, "--params", params, "--out",
                           inst, "--score_threshold", "0", "--device",
                           "cpu"])
    preds = np.load(inst, allow_pickle=True).item()
    assert set(preds) == {f"im{i}.png" for i in range(3)} == set(got)
    for name, insts in preds.items():
        h, w = iu.read_image(os.path.join(img_dir, name)).shape[:2]
        assert insts and all(i["segmentation"].shape == (h, w)
                             for i in insts)
        scores = [i["score"] for i in insts]
        assert scores == sorted(scores, reverse=True)
    crop = json.load(open(tcrop.run(img_dir, str(tmp_path / "crops"), inst,
                                    conf_thres=0.0)))
    assert len(crop["root"]) == 3
    assert all(os.path.exists(tmp_path / "crops" / "crop_pic" / n)
               for item in crop["root"] for n in item["bbox_name"])
    assert torch.device("cpu") == torch.device(next(iter(
        detect_cli.load_params(params, detect_cli.config(True),
                               "cpu").parameters())).device)
