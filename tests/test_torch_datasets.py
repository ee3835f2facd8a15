"""The port's COCO and Cityscapes datasets, their set writer and their
evaluators against the JAX package's, on small sets written to disk.

The port's ``tools.make_synth_coco`` must write the JAX package's files for
the same seed: the JSON byte for byte, the JPEGs and PNGs decoding to equal
arrays. On those files ``COCOPanoptic`` and ``Cityscapes`` must give the JAX
classes' ``load_gt`` and ``sample`` as exact arrays (training and test,
both COCO buckets, with flips); ``rasterize_polygons`` and ``ann_to_mask``
(polygons, raw and compressed RLE) equal masks; the evaluators (COCO boxes,
masks, mIoU, PQ, and the Cityscapes instance AP) the same numbers on the
same predictions, within 1e-9 and NaN where JAX gives NaN.

The helpers here also serve ``test_torch_loader.py`` and
``test_torch_trainer.py``.
"""

import importlib.util
import math
import pathlib

import cv2
import numpy as np
import pytest
import torch

from upsnet_tpu.config import load_config as jax_load_config
from upsnet_tpu.data import cityscapes as jcity
from upsnet_tpu.data import coco as jcoco
from upsnet_tpu.evaluation import cityscapes_eval as jcity_eval
from upsnet_torch.config import load_config
from upsnet_torch.data import cityscapes as tcity
from upsnet_torch.data import coco as tcoco
from upsnet_torch.evaluation import cityscapes_eval as tcity_eval
from upsnet_torch.evaluation import rle
from upsnet_torch.evaluation.panoptic_format import rgb_to_id
from upsnet_torch.tools import make_synth_coco as port_tool

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
COCO_SET, COCO_IMAGES, COCO_SEED, COCO_HW = "tiny", 6, 2, (100, 150)  # 3 of 6 portrait
CITY_SPLIT, CITY_IMAGES, CITY_HW = "train", 2, (64, 128)
EVAL_ABS = 1e-9

# the tiny trunk of tests/test_torch_predict.py with the COCO heads of the
# synthetic sets (80 things, 53 stuff), on 128x192 / 192x128 buckets
TINY_YAML = """\
symbol: resnet_50_upsnet
output_path: {out}
dataset:
  dataset: {dataset}
  dataset_path: {root}
  image_set: {split}
  test_image_set: {split}
  num_classes: {num_classes}
  num_seg_classes: {num_seg_classes}
  num_stuff: {num_stuff}
network:
  backbone: resnet_test
  norm: gn
  dcn_impl: auto
  dcn_impl_train: pallas
  dcn_boundary_grad: damped
  dcn_saturation_action: warn
  fpn_feature_dim: 32
  rcnn_fc_dim: 64
  fcn_head_dim: 16
  compute_dtype: float32
train:
  image_wire: uint8
  scales: [{scale}]
  max_size: {max_size}
  image_buckets: {buckets}
  rpn_pre_nms_top_n: 64
  rpn_post_nms_top_n: 32
  rpn_batch_size: 32
  batch_rois: 16
  max_gt_instances: 8
  batch_size: 2
  rpn_straddle_thresh: 100000
  lr: 0.002
  warmup_iteration: 4
  max_iteration: 10
  decay_iteration: [7]
  snapshot_step: 4
  display_iter: 3
  num_workers: 0
test:
  scales: [{scale}]
  max_size: {max_size}
  image_buckets: {buckets}
  rpn_pre_nms_top_n: 64
  rpn_post_nms_top_n: 32
  max_det: 8
  panoptic_stuff_area_limit: 64
"""
COCO_FIELDS = dict(dataset="coco", split=COCO_SET, num_classes=81, num_seg_classes=133,
                   num_stuff=53, scale=128, max_size=192,
                   buckets="[[128, 192], [192, 128]]")
CITY_FIELDS = dict(dataset="cityscapes", split=CITY_SPLIT, num_classes=9, num_seg_classes=19,
                   num_stuff=11, scale=64, max_size=128, buckets="[[64, 128]]")


def root_tool():
    """The JAX package's ``tools/make_synth_coco.py``."""
    spec = importlib.util.spec_from_file_location("root_make_synth_coco",
                                                  ROOT / "tools" / "make_synth_coco.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def write_sets(base: pathlib.Path, tool=port_tool) -> dict:
    """The COCO and the Cityscapes set written by ``tool`` under ``base``."""
    coco, city = base / "coco", base / "cityscapes"
    tool.gen_coco(str(coco), COCO_SET, COCO_IMAGES, seed=COCO_SEED, hw_base=COCO_HW)
    tool.gen_cityscapes(str(city), CITY_SPLIT, CITY_IMAGES, seed=0, hw=CITY_HW)
    return {"coco": coco, "cityscapes": city}


def write_yaml(path: pathlib.Path, root, out, fields: dict) -> str:
    path.write_text(TINY_YAML.format(root=root, out=out, **fields))
    return str(path)


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    """Both sets, written by the port's tool, and a tiny YAML for each."""
    base = tmp_path_factory.mktemp("sets")
    roots = write_sets(base)
    out = base / "out"
    return {"base": base, **roots,
            "coco_yaml": write_yaml(base / "coco.yaml", roots["coco"], out, COCO_FIELDS),
            "city_yaml": write_yaml(base / "city.yaml", roots["cityscapes"], out, CITY_FIELDS)}


def _files(root: pathlib.Path) -> list:
    return sorted(p.relative_to(root) for p in root.rglob("*") if p.is_file())


@pytest.mark.parametrize("layout", ["coco", "cityscapes"])
def test_make_synth_coco_writes_the_root_tools_files(sets, tmp_path, layout):
    ref_root = write_sets(tmp_path, root_tool())[layout]
    got_root = sets[layout]
    assert _files(got_root) == _files(ref_root) and _files(ref_root)
    for rel in _files(ref_root):
        got, ref = got_root / rel, ref_root / rel
        if rel.suffix == ".json":
            assert got.read_bytes() == ref.read_bytes(), rel
        else:
            np.testing.assert_array_equal(cv2.imread(str(got), cv2.IMREAD_UNCHANGED),
                                          cv2.imread(str(ref), cv2.IMREAD_UNCHANGED),
                                          err_msg=str(rel))


def _datasets(yaml, training, port_cls, jax_cls):
    return port_cls(load_config(yaml), training=training), jax_cls(jax_load_config(yaml),
                                                                   training=training)


def _assert_arrays_equal(got: dict, ref: dict, what: str):
    assert got.keys() == ref.keys(), what
    for k in ref:
        g, r = np.asarray(got[k]), np.asarray(ref[k])
        assert g.dtype == r.dtype, f"{what} {k}: {g.dtype} != {r.dtype}"
        np.testing.assert_array_equal(g, r, err_msg=f"{what} {k}")


@pytest.mark.parametrize("name", ["coco", "cityscapes"])
def test_load_gt_matches_jax(sets, name):
    yaml = sets["coco_yaml" if name == "coco" else "city_yaml"]
    classes = (tcoco.COCOPanoptic, jcoco.COCOPanoptic) if name == "coco" else (
        tcity.Cityscapes, jcity.Cityscapes)
    port, ref = _datasets(yaml, True, *classes)
    assert len(port) == len(ref) > 0
    for i in range(len(ref)):
        _assert_arrays_equal(port.load_gt(i), ref.load_gt(i), f"{name} load_gt({i})")
        np.testing.assert_array_equal(port.load_image(i), ref.load_image(i))


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("name", ["coco", "cityscapes"])
def test_sample_matches_jax(sets, name, training):
    """Every image, three seeded draws each when training (so that flips
    occur), both COCO buckets."""
    yaml = sets["coco_yaml" if name == "coco" else "city_yaml"]
    classes = (tcoco.COCOPanoptic, jcoco.COCOPanoptic) if name == "coco" else (
        tcity.Cityscapes, jcity.Cityscapes)
    port, ref = _datasets(yaml, training, *classes)
    shapes, flips = set(), 0
    for i in range(len(ref)):
        for draw in range(3 if training else 1):
            seed = 100 * i + draw
            got = port.sample(i, np.random.RandomState(seed))
            want = ref.sample(i, np.random.RandomState(seed))
            _assert_arrays_equal(got, want, f"{name} sample({i}, seed {seed})")
            shapes.add(want["images"].shape)
            draws = np.random.RandomState(seed)
            draws.randint(1)  # the scale
            flips += training and draws.rand() < 0.5
    assert len(shapes) == (2 if name == "coco" else 1), shapes
    assert flips > 0 or not training


def test_rasterize_polygons_and_ann_to_mask_match_jax(rng):
    h, w = 37, 53
    polys = [list(rng.uniform(-3, 56, 2 * n)) for n in (3, 5, 8)] + [[1.0, 2.0, 3.0, 4.0]]
    np.testing.assert_array_equal(tcoco.rasterize_polygons(polys, h, w),
                                  jcoco.rasterize_polygons(polys, h, w))
    mask = (rng.rand(h, w) > 0.6).astype(np.uint8)
    compressed = rle.encode(mask)
    anns = [{"segmentation": polys},
            {"segmentation": {"size": [h, w], "counts": rle.mask_to_counts(mask).tolist()}},
            {"segmentation": compressed},
            {"segmentation": {"size": [h, w], "counts": compressed["counts"].decode()}},
            {}]
    for a in anns:
        got, ref = tcoco.ann_to_mask(a, h, w), jcoco.ann_to_mask(a, h, w)
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(tcoco.ann_to_mask(anns[1], h, w), mask)


def assert_close(got, ref, path="result"):
    """Nested dicts / lists of numbers equal within EVAL_ABS, NaN where ref
    is NaN."""
    if isinstance(ref, dict):
        assert got.keys() == ref.keys(), path
        for k in ref:
            assert_close(got[k], ref[k], f"{path}.{k}")
    elif isinstance(ref, (list, tuple)):
        assert len(got) == len(ref), path
        for i, (g, r) in enumerate(zip(got, ref)):
            assert_close(g, r, f"{path}[{i}]")
    elif isinstance(ref, (float, np.floating)):
        assert (math.isnan(got) and math.isnan(ref)) or abs(got - ref) <= EVAL_ABS, \
            f"{path}: {got} != {ref}"
    else:
        assert got == ref, f"{path}: {got} != {ref}"


def _perturbed_mask(mask, rng):
    m = np.roll(mask, rng.randint(-2, 3), axis=int(rng.randint(2)))
    return (m ^ (rng.rand(*m.shape) < 0.02)).astype(np.uint8)


def _coco_predictions(ds, rng):
    """Detections (jittered GT boxes and masks, a swapped class, a false
    positive), semantic maps with noise, and panoptic maps with one segment
    of each image dropped and one relabelled, in the dataset's ids."""
    dets, segs, pans = [], [], []
    for i, im in enumerate(ds.images):
        h, w = im["height"], im["width"]
        for j, a in enumerate(ds.anns_by_image[im["id"]]):
            x, y, bw, bh = a["bbox"]
            box = np.array([x, y, x + bw - 1, y + bh - 1], float) + rng.uniform(-3, 3, 4)
            label = ds.thing_cat_to_label[a["category_id"]]
            if j == 1:
                label = label % 80 + 1
            dets.append({"image_id": im["id"], "category": label, "score": float(rng.rand()),
                         "bbox": box.tolist(),
                         "segmentation": rle.encode(_perturbed_mask(jcoco.ann_to_mask(a, h, w),
                                                                    rng))})
        dets.append({"image_id": im["id"], "category": 5, "score": 0.9,
                     "bbox": [1.0, 2.0, 30.0, 20.0],
                     "segmentation": rle.encode(np.pad(np.ones((18, 29), np.uint8),
                                                       ((2, h - 20), (1, w - 30))))})
        gt = ds._semantic_from_panoptic(i, h, w)
        noise = rng.rand(h, w) < 0.05
        segs.append({"image_id": im["id"],
                     "pred": np.where(noise, rng.randint(0, 133, (h, w)), gt)})
        info = ds.pan_by_image[im["id"]]
        png = cv2.imread(str(pathlib.Path(ds.root) / "annotations" / f"panoptic_{ds.image_set}"
                             / info["file_name"]), cv2.IMREAD_COLOR)
        ids = rgb_to_id(png[:, :, ::-1])
        segments = [{"id": s["id"], "category_id": s["category_id"]}
                    for s in info["segments_info"][1:]]
        ids[ids == info["segments_info"][0]["id"]] = 0
        segments[-1]["category_id"] = info["segments_info"][1]["category_id"]
        pans.append({"image_id": im["id"], "id_map": ids, "segments": segments})
    return dets, segs, pans


def test_coco_evaluators_match_jax(sets, rng):
    port, ref = _datasets(sets["coco_yaml"], False, tcoco.COCOPanoptic, jcoco.COCOPanoptic)
    dets, segs, pans = _coco_predictions(ref, rng)
    for name, preds in (("evaluate_boxes", dets), ("evaluate_masks", dets),
                        ("evaluate_ssegs", segs), ("evaluate_panoptic", pans)):
        got, want = getattr(port, name)(preds), getattr(ref, name)(preds)
        assert_close(got, want, name)
    assert 0.0 < want["All"]["pq"] < 1.0


def test_cityscapes_evaluators_match_jax(sets, rng):
    """The instance AP of ``evaluate_masks`` (cityscapesScripts protocol) and
    the base class's box AP, mIoU and PQ, on detections made from the GT."""
    port, ref = _datasets(sets["city_yaml"], False, tcity.Cityscapes, jcity.Cityscapes)
    dets, segs, pans = [], [], []
    for i in range(len(ref)):
        gt = ref.load_gt(i)
        for j in range(len(gt["classes"])):
            dets.append({"image_id": i, "category": int(gt["classes"][j]),
                         "score": float(rng.rand()),
                         "bbox": (gt["boxes"][j] + rng.uniform(-2, 2, 4)).tolist(),
                         "segmentation": rle.encode(_perturbed_mask(gt["masks"][j], rng))})
        noise = rng.rand(*gt["seg"].shape) < 0.05
        segs.append({"image_id": i, "pred": np.where(noise, 3, gt["seg"])})
        id_map = np.zeros(gt["seg"].shape, np.int64)
        segments = []
        for s in range(11):
            if (gt["seg"] == s).any():
                segments.append({"id": len(segments) + 1, "category_id": s})
                id_map[gt["seg"] == s] = len(segments)
        for j in range(len(gt["classes"])):
            segments.append({"id": len(segments) + 1,
                             "category_id": 11 + int(gt["classes"][j]) - 1})
            id_map[gt["masks"][j] > 0] = len(segments)
        pans.append({"image_id": i, "id_map": id_map, "segments": segments[1:]})
    assert dets
    for name, preds in (("evaluate_boxes", dets), ("evaluate_masks", dets),
                        ("evaluate_ssegs", segs), ("evaluate_panoptic", pans)):
        assert_close(getattr(port, name)(preds), getattr(ref, name)(preds), name)


def test_cityscapes_instance_evaluator_matches_jax(rng):
    """``CityscapesInstanceEvaluator`` alone: undersized GT, a group region,
    void pixels, duplicate matches and unmatched predictions, two images."""
    h, w = 48, 64
    evs = [tcity_eval.CityscapesInstanceEvaluator(3), jcity_eval.CityscapesInstanceEvaluator(3)]
    for _ in range(2):
        gt = np.zeros((5, h, w), np.uint8)
        for g in range(5):
            y, x = rng.randint(0, h - 16), rng.randint(0, w - 16)
            size = 6 if g == 4 else 14  # the last one is below min_region_size
            gt[g, y:y + size, x:x + size] = 1
        gt_classes = np.array([1, 1, 2, 3, 2], np.int32)
        preds = [_perturbed_mask(gt[g], rng) for g in (0, 0, 1, 2, 3, 4)]
        preds.append((rng.rand(h, w) < 0.1).astype(np.uint8))
        pred_classes = np.array([1, 1, 2, 2, 3, 2, 1], np.int32)
        scores = rng.rand(len(preds))
        void = np.zeros((h, w), bool)
        void[:4] = True
        group = {2: np.pad(np.ones((8, 8), bool), ((0, h - 8), (w - 8, 0)))}
        for ev in evs:
            ev.add_image(gt, gt_classes, preds, pred_classes, scores, void_mask=void,
                         group_masks=group)
    names = ("a", "b", "c")
    assert_close(evs[0].summarize(class_names=names), evs[1].summarize(class_names=names))
