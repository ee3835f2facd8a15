"""The port's evaluators, dataset base and host postprocessing against the
JAX package's, module by module, on the same numpy inputs made from a seed.

Every case is exact (equal bytes, arrays, counts and floats), except where
``_same_floats`` compares metric dicts: there NaN equals NaN (an area range
with no GT gives NaN in both) and every other value must be equal.
"""

import dataclasses
import math
import pathlib

import numpy as np
import torch
import pytest

from upsnet_tpu.config import load_config as jax_load_config
from upsnet_tpu.data.synthetic import SyntheticDataset as JaxSynthetic
from upsnet_tpu.evaluation import coco_eval as jcoco
from upsnet_tpu.evaluation import inference as jinf
from upsnet_tpu.evaluation import panoptic_format as jpf
from upsnet_tpu.evaluation import pq as jpq
from upsnet_tpu.evaluation import rle as jrle
from upsnet_tpu.evaluation import rle_native as jrle_native
from upsnet_tpu.evaluation import seg_eval as jseg
from upsnet_tpu.ops.anchors import pyramid_anchors as jax_pyramid_anchors
from upsnet_tpu.utils import logging as jlog
from upsnet_torch.config import load_config
from upsnet_torch.data.synthetic import SyntheticDataset
from upsnet_torch.evaluation import coco_eval as tcoco
from upsnet_torch.evaluation import inference as tinf
from upsnet_torch.evaluation import panoptic_format as tpf
from upsnet_torch.evaluation import pq as tpq
from upsnet_torch.evaluation import rle as trle
from upsnet_torch.evaluation import rle_native as trle_native
from upsnet_torch.evaluation import seg_eval as tseg
from upsnet_torch.tools import test as test_cli
from upsnet_torch.utils import logging as tlog

TINY_YAML = "experiments/upsnet_tiny_synthetic.yaml"


def _same_floats(got, ref, path=""):
    """Nested dicts equal, NaN equal to NaN."""
    if isinstance(ref, dict):
        assert set(got) == set(ref), path
        for k in ref:
            _same_floats(got[k], ref[k], f"{path}/{k}")
    elif isinstance(ref, float) and math.isnan(ref):
        assert isinstance(got, float) and math.isnan(got), (path, got)
    else:
        assert got == ref, (path, got, ref)


@pytest.fixture(params=["native", "numpy"])
def codec(request, monkeypatch):
    """Both packages on the native codec (native/librle.so, which the test
    configuration builds) or both forced to the numpy fallback."""
    off = request.param == "numpy"
    monkeypatch.setattr(jrle_native, "FORCE_DISABLED", off)
    monkeypatch.setattr(trle_native, "FORCE_DISABLED", off)
    assert trle_native.available() == (not off) == jrle_native.available()
    assert trle_native.codec().startswith(request.param)
    return request.param


def _masks(seed):
    rng = np.random.RandomState(seed)
    out = [np.zeros((5, 7), np.uint8), np.ones((5, 7), np.uint8)]
    for shape in ((37, 53), (64, 48), (1, 9)):
        out.append((rng.rand(*shape) > rng.uniform(0.2, 0.9)).astype(np.uint8))
    blocky = np.zeros((40, 60), np.uint8)
    blocky[3:31, 11:52] = 1
    blocky[0, 0] = 1  # a mask that starts with a one-run
    out.append(blocky)
    return out


def test_rle_encode_decode_area_iou_match_jax(codec):
    masks = _masks(0)
    for m in masks:
        got, ref = trle.encode(m), jrle.encode(m)
        assert got == ref
        np.testing.assert_array_equal(trle.decode(got), jrle.decode(ref))
        np.testing.assert_array_equal(trle.decode(got), m)
        assert trle.area(got) == jrle.area(ref) == int(m.sum())
        as_str = dict(got, counts=got["counts"].decode())
        np.testing.assert_array_equal(trle.decode(as_str), m)
    rng = np.random.RandomState(1)
    pairs = [(rng.rand(30, 40) > 0.5, rng.rand(30, 40) > 0.3) for _ in range(4)]
    for a, b in pairs:
        ra, rb = trle.encode(a.astype(np.uint8)), trle.encode(b.astype(np.uint8))
        assert trle.intersection_area(ra, rb) == jrle.intersection_area(ra, rb) == int((a & b).sum())
        for crowd in (False, True):
            assert trle.iou(ra, rb, iscrowd=crowd) == jrle.iou(ra, rb, iscrowd=crowd)


def test_confusion_matrix_matches_jax():
    rng = np.random.RandomState(2)
    got, ref = tseg.ConfusionMatrix(7), jseg.ConfusionMatrix(7)
    for _ in range(3):
        gt = rng.randint(0, 7, (24, 32))
        gt[rng.rand(24, 32) < 0.2] = 255
        pred = rng.randint(0, 7, (24, 32))
        got.update(gt, pred)
        ref.update(gt, pred)
    np.testing.assert_array_equal(got.mat, ref.mat)
    np.testing.assert_array_equal(got.iou_per_class(), ref.iou_per_class())
    assert got.mean_iou() == ref.mean_iou()
    assert got.pixel_accuracy() == ref.pixel_accuracy()


def _pq_case(seed):
    """GT: stuff bands, two things (one crowd), a void strip; the prediction
    shifts the things, splits a band, and adds one segment mostly on void and
    one on the crowd region."""
    rng = np.random.RandomState(seed)
    gt = np.zeros((48, 64), np.int64)
    gt[:16], gt[16:32], gt[32:] = 1, 2, 3
    gt[:, :4] = 0  # void
    y, x = rng.randint(4, 20), rng.randint(8, 30)
    gt[y:y + 14, x:x + 18] = 4
    gt[30:44, 40:60] = 5
    gt_segs = {1: {"category_id": 0, "iscrowd": 0}, 2: {"category_id": 1, "iscrowd": 0},
               3: {"category_id": 2, "iscrowd": 0}, 4: {"category_id": 3, "iscrowd": 0},
               5: {"category_id": 4, "iscrowd": 1}}
    pred = gt.copy()
    pred[pred == 0] = 1
    dy, dx = rng.randint(-3, 4), rng.randint(-3, 4)
    pred[pred == 4] = 1
    pred[y + dy:y + dy + 14, x + dx:x + dx + 18] = 4
    pred[32:, 30:] = 6  # splits band 3
    pred[30:44, 40:60] = 7  # on the crowd region, same category
    pred[:, :3] = 8  # mostly void
    pred_segs = {1: {"category_id": 0}, 2: {"category_id": 1}, 3: {"category_id": 2},
                 4: {"category_id": 3}, 6: {"category_id": 2}, 7: {"category_id": 4},
                 8: {"category_id": 1}}
    return gt, pred, gt_segs, pred_segs


def test_pq_matches_jax_with_void_and_crowd():
    got, ref = tpq.PQStat(), jpq.PQStat()
    for seed in range(3):
        gt, pred, gt_segs, pred_segs = _pq_case(seed)
        g = tpq.pq_compute_single_image(gt, pred, gt_segs, pred_segs)
        r = jpq.pq_compute_single_image(gt, pred, gt_segs, pred_segs)
        for field in ("iou_sum", "tp", "fp", "fn"):
            assert dict(getattr(g, field)) == dict(getattr(r, field)), field
        got += g
        ref += r
    things, stuff = {3, 4}, {0, 1, 2}
    res = tpq.pq_summarize(got, things, stuff)
    _same_floats(res, jpq.pq_summarize(ref, things, stuff))
    assert 0.0 < res["All"]["pq"] < 1.0  # the case reaches matches and misses


def _coco_anns(seed, iou_type):
    """Two images, two categories, a crowd GT, a false positive per image,
    boxes of all three area ranges."""
    rng = np.random.RandomState(seed)
    gts, dets = [], []
    for img in (1, 2):
        for cat in (1, 2):
            for k in range(3):
                x, y = rng.uniform(0, 200, 2)
                w, h = rng.choice([20.0, 60.0, 140.0]), rng.uniform(20, 120)
                gts.append({"image_id": img, "category_id": cat, "bbox": [x, y, w, h],
                            "area": w * h, "iscrowd": int(k == 2 and cat == 2)})
                dets.append({"image_id": img, "category_id": cat, "score": float(rng.rand()),
                             "bbox": [x + rng.uniform(-8, 8), y + rng.uniform(-8, 8),
                                      w * rng.uniform(0.8, 1.2), h * rng.uniform(0.8, 1.2)]})
        dets.append({"image_id": img, "category_id": 1, "score": 0.99,
                     "bbox": [300.0, 300.0, 30.0, 30.0]})  # false positive
    if iou_type == "segm":
        def rle_of(b):
            m = np.zeros((480, 480), np.uint8)
            x, y, w, h = (int(round(v)) for v in b)
            m[max(y, 0):y + h, max(x, 0):x + w] = 1
            return trle.encode(m)

        for a in gts + dets:
            a["segmentation"] = rle_of(a["bbox"])
    return gts, dets


@pytest.mark.parametrize("iou_type", ["bbox", "segm"])
def test_coco_evaluator_matches_jax(iou_type):
    gts, dets = _coco_anns(3, iou_type)
    results = []
    for mod in (tcoco, jcoco):
        ev = mod.COCOEvaluator(iou_type, max_dets=3)  # truncates: 4 dets an image and class
        for g in gts:
            ev.add_gt(dict(g))
        for d in dets:
            ev.add_det(dict(d))
        results.append(ev.summarize())
    got, ref = results
    _same_floats(got, ref)
    assert 0.0 < got["AP"] < 1.0
    assert tcoco.format_table(got, 3) == jcoco.format_table(ref, 3)


def test_panoptic_output_and_artifacts_match_jax(tmp_path):
    rng = np.random.RandomState(4)
    num_stuff, d = 3, 6
    pan = rng.randint(0, num_stuff + d + 1, (40, 56))
    pan[:8] = 0  # one stuff class with a large area
    det_classes = rng.randint(1, 5, d).astype(np.int32)
    det_keep = rng.rand(d) < 0.7
    stuff_ids, thing_ids = [0, 1, 2], {i: num_stuff + i - 1 for i in range(5)}
    args = (num_stuff, det_classes, det_keep, 200, stuff_ids, thing_ids)
    got_map, got_segs = tpf.build_panoptic_output(pan, *args)
    ref_map, ref_segs = jpf.build_panoptic_output(pan, *args)
    np.testing.assert_array_equal(got_map, ref_map)
    assert got_segs == ref_segs
    assert len({s["isthing"] for s in got_segs}) == 2  # things and area-filtered stuff
    results = [{"image_id": 7, "id_map": got_map, "segments": got_segs},
               {"image_id": 9, "id_map": got_map[::-1].copy(), "segments": got_segs}]
    paths = [mod.write_panoptic_results(str(tmp_path / name), results)
             for mod, name in ((tpf, "port"), (jpf, "jax"))]
    assert open(paths[0]).read() == open(paths[1]).read()
    for name in ("000000000007.png", "000000000009.png"):
        assert ((tmp_path / "port" / "pred_pans" / name).read_bytes()
                == (tmp_path / "jax" / "pred_pans" / name).read_bytes())
    got_back, ref_back = tpf.read_panoptic_results(paths[0]), jpf.read_panoptic_results(paths[1])
    for g, r, orig in zip(got_back, ref_back, results):
        np.testing.assert_array_equal(g["id_map"], r["id_map"])
        np.testing.assert_array_equal(g["id_map"], orig["id_map"])
        assert g["segments"] == r["segments"] and g["image_id"] == r["image_id"]


@pytest.fixture(scope="module")
def cfgs():
    return load_config(TINY_YAML), jax_load_config(TINY_YAML)


def test_synthetic_load_gt_matches_jax(cfgs):
    tcfg, jcfg = cfgs
    got, ref = SyntheticDataset(tcfg, 4, seed=3), JaxSynthetic(jcfg, 4, seed=3)
    assert len(got) == len(ref) == 4
    for i in range(4):
        np.testing.assert_array_equal(got.load_image(i), ref.load_image(i))
        g, r = got.load_gt(i), ref.load_gt(i)
        assert set(g) == set(r)
        for k in r:
            assert g[k].dtype == r[k].dtype, k
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)


@pytest.mark.parametrize("image_hw,bucket", [((256, 320), (128, 160)), ((320, 256), (160, 128))])
@pytest.mark.parametrize("training", [False, True])
def test_sample_matches_jax(cfgs, image_hw, bucket, training):
    """``BaseDataset.sample`` on both tiny buckets: resize, normalise, pad,
    and for training the seeded scale / flip draw and the GT at 1/4 scale."""
    tcfg, jcfg = cfgs
    got_ds = SyntheticDataset(tcfg, 3, image_hw=image_hw, training=training)
    ref_ds = JaxSynthetic(jcfg, 3, image_hw=image_hw, training=training)
    got_rng, ref_rng = np.random.RandomState(5), np.random.RandomState(5)
    for i in range(3):
        got, ref = got_ds.sample(i, got_rng), ref_ds.sample(i, ref_rng)
        assert set(got) == set(ref)
        assert got["images"].shape[:2] == bucket
        for k in ref:
            g, r = np.asarray(got[k]), np.asarray(ref[k])
            assert g.dtype == r.dtype, k
            np.testing.assert_array_equal(g, r, err_msg=k)
        if training:
            assert got["gt_valid"].any() and (got["seg_gt"] != 255).any()
    assert np.array_equal(got_rng.get_state()[1], ref_rng.get_state()[1])


def _constructed_output(cfg, bucket, seed):
    """A predict-step output dict for one ``bucket`` canvas: 5 valid
    detections of 8, mask logits around 0, a uint8 semantic argmax and a
    panoptic channel map over the whole quarter-scale canvas."""
    rng = np.random.RandomState(seed)
    d, hq, wq = cfg.test.max_det, bucket[0] // 4, bucket[1] // 4
    x1, y1 = rng.uniform(-10, 120, d), rng.uniform(-10, 90, d)
    boxes = np.stack([x1, y1, x1 + rng.uniform(4, 60, d), y1 + rng.uniform(4, 50, d)], 1)
    valid = np.arange(d) < 5
    return {
        "boxes": boxes.astype(np.float32),
        "scores": rng.uniform(0.05, 1.0, d).astype(np.float32),
        "classes": rng.randint(1, cfg.dataset.num_classes, d).astype(np.int32),
        "det_valid": valid,
        "mask_logits": rng.normal(0, 2, (d, 28, 28)).astype(np.float32),
        "seg_pred_q": rng.randint(0, cfg.dataset.num_seg_classes, (hq, wq)).astype(np.uint8),
        "pan_map": rng.randint(0, cfg.dataset.num_stuff + d + 1, (hq, wq)).astype(np.int32),
        "pan_keep": valid & (rng.rand(d) < 0.8),
    }


@pytest.mark.parametrize("image_hw,im_hw", [((250, 320), (125, 160)), ((320, 250), (160, 125))])
def test_postprocess_image_matches_jax(cfgs, image_hw, im_hw):
    """Boxes unscaled and clipped, the float32 numpy sigmoid, the cv2 paste
    at 0.5 and RLE, the crop to the image's quarter extent before the
    nearest resize (31 of 32 rows, or 31 of 32 columns, on the two tiny
    buckets), and the panoptic segments: equal to the JAX package's."""
    tcfg, jcfg = cfgs
    got_ds = SyntheticDataset(tcfg, 2, image_hw=image_hw, training=False)
    ref_ds = JaxSynthetic(jcfg, 2, image_hw=image_hw, training=False)
    meta = got_ds.sample(1)
    assert tuple(meta["im_hw"]) == im_hw
    out = _constructed_output(tcfg, meta["images"].shape[:2], 1)
    got = tinf.postprocess_image(tcfg, got_ds, out, meta)
    ref = jinf.postprocess_image(jcfg, ref_ds, out, meta)
    assert len(got["detections"]) == len(ref["detections"]) == 5
    for g, r in zip(got["detections"], ref["detections"]):
        assert g == r
    assert any(trle.area(g["segmentation"]) for g in got["detections"])
    np.testing.assert_array_equal(got["seg"]["pred"], ref["seg"]["pred"])
    assert got["seg"]["pred"].shape == image_hw
    np.testing.assert_array_equal(got["panoptic"]["id_map"], ref["panoptic"]["id_map"])
    assert got["panoptic"]["segments"] == ref["panoptic"]["segments"]


def test_logger_and_meters(tmp_path):
    logger = tlog.create_logger(str(tmp_path), "tiny", "test")
    logger.info("hello %d", 3)
    logs = list(tmp_path.glob("tiny_test_*.log"))
    assert len(logs) == 1 and "INFO hello 3" in logs[0].read_text()
    got, ref = tlog.AverageMeter(), jlog.AverageMeter()
    for v, n in ((1.5, 2), (4.0, 1), (-0.25, 3)):
        got.update(v, n)
        ref.update(v, n)
    assert got.avg == ref.avg == (3.0 + 4.0 - 0.75) / 6
    speed = tlog.SpeedMeter(skip=2)
    for _ in range(4):
        speed.tick(2)
    assert speed.images == 4 and speed.images_per_sec > 0


def test_bucket_anchors_read_the_configured_scale_and_ratios(cfgs):
    tcfg, _ = cfgs
    cfg = tcfg.replace(network=dataclasses.replace(tcfg.network, anchor_scale=4.0,
                                                   anchor_ratios=(0.25, 1.0, 4.0)))
    got = tinf.bucket_anchors(cfg, (160, 128), "cpu")
    ref = jax_pyramid_anchors((160, 128), scale=4.0, ratios=(0.25, 1.0, 4.0))
    assert len(got) == len(ref) == 5
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), r)
    default = tinf.bucket_anchors(tcfg, (160, 128), "cpu")
    assert not np.array_equal(default[0].numpy(), ref[0])


@pytest.mark.parametrize("field,value", [("multi_scale", (128, 160)), ("flip_test", True)])
def test_run_evaluation_refuses_tta_by_name(cfgs, field, value, monkeypatch):
    """TTA is ported: each field routes an image through ``predict_image_tta``
    with its (scale, flip) variants (``tests/test_torch_tta.py`` holds it
    against JAX) instead of being refused."""
    tcfg, _ = cfgs
    cfg = tcfg.replace(test=dataclasses.replace(tcfg.test, **{field: value}))
    calls = []
    orig = tinf.predict_image_tta
    monkeypatch.setattr(tinf, "predict_image_tta",
                        lambda *a, **kw: calls.append(a[2]) or orig(*a, **kw))
    results = tinf.run_evaluation(cfg, SyntheticDataset(cfg, 1, training=False), device="cpu")
    assert calls == [0] and set(results) == {"boxes", "masks", "ssegs", "panoptic"}
    assert tinf.tta_variants(cfg) == {"multi_scale": [(128, False), (160, False)],
                                      "flip_test": [(128, False), (128, True)]}[field]


@pytest.mark.parametrize("name", ["coco", "cityscapes"])
def test_cli_refuses_unported_datasets_by_name(name, monkeypatch, tmp_path):
    """coco and cityscapes are ported, so neither is refused by name: the
    CLI reads each from the configured ``dataset.dataset_path``, and a set
    that is not there raises FileNotFoundError naming that path."""
    import yaml

    src = pathlib.Path(__file__).resolve().parents[1] / TINY_YAML
    doc = yaml.safe_load(src.read_text())
    missing = tmp_path / f"no_{name}_set"
    doc.setdefault("dataset", {})["dataset_path"] = str(missing)
    cfg_path = tmp_path / "tiny.yaml"
    cfg_path.write_text(yaml.safe_dump(doc, sort_keys=False))
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError, match=f"no_{name}_set"):
        test_cli.run(["--cfg", str(cfg_path), "--dataset-override", name, "--device", "cpu"])


def test_cli_runs_on_cuda_unless_told_otherwise(monkeypatch, tmp_path):
    """The default device is CUDA; without it the CLI raises instead of
    moving to the CPU."""
    assert test_cli.parse_args(["--cfg", TINY_YAML]).device == "cuda"
    yaml = str(pathlib.Path(__file__).resolve().parents[1] / TINY_YAML)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        test_cli.run(["--cfg", yaml, "--dataset-override", "synthetic", "--no-artifacts"])
