"""Test-time augmentation of the port (``upsnet_torch/evaluation/tta.py``)
against the JAX package's (``upsnet_tpu/evaluation/tta.py``) on the CPU.

  * ``_greedy_nms_per_class``: the same kept indices, exactly;
  * ``fuse_tta`` on the same merged evidence: the same panoptic map, keep
    flags and padded detections, exactly;
  * ``run_evaluation`` with TTA on the tiny synthetic config
    (``experiments/upsnet_tiny_synthetic.yaml`` with ``multi_scale``
    (96, 176), ``flip_test`` and ``max_size`` 224: 6 forwards an image, as
    the R101-DCN COCO file's three scales and flip), JAX-init weights
    through the bridge: each image's ``predict_image_tta`` output (the same
    detections and classes, boxes within 0.1 px and at least 99.9% of the
    semantic and panoptic pixels equal, as in ``test_torch_eval_loop.py``;
    scores within 1e-3: the single-scale loop's 4.6e-5 grows to 1.7e-4 over
    six variants of the random-init box head) and the metrics within 1e-3.

Every image of that run hits the reference's bucket crop (TTA scale 176 of a
256x320 image is 176x220, wider and taller than both 128x160 buckets): the
canvas is cropped while ``im_hw`` keeps 176x220, and both packages stretch
what the crop kept over the image. ``test_the_bucket_crop_of_the_coco_tta_file``
shows the same on the R101-DCN COCO file's own buckets.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import upsnet_tpu.evaluation.tta as jtta
import upsnet_tpu.models.upsnet  # noqa: F401 - imported before any trace of _fuse_device
from upsnet_tpu.config import load_config as jax_load_config
from upsnet_tpu.data.synthetic import SyntheticDataset as JaxSynthetic
from upsnet_tpu.evaluation.inference import run_evaluation as jax_run_evaluation
from upsnet_tpu.models.registry import get_model as jax_get_model
from upsnet_torch.config import load_config
from upsnet_torch.convert.from_jax import load_jax_params
from upsnet_torch.data import transforms
from upsnet_torch.data.synthetic import SyntheticDataset
from upsnet_torch.evaluation import inference as tinf
from upsnet_torch.evaluation import tta as ttta
from upsnet_torch.models import get_model

torch.set_num_threads(2)

TINY_YAML = "experiments/upsnet_tiny_synthetic.yaml"
COCO_TTA_YAML = "experiments/upsnet_resnet101_dcn_coco_3x_16gpu.yaml"
N_IMAGES = 2
TTA = {"multi_scale": (96, 176), "flip_test": True, "max_size": 224}
BOX_PX, SCORE_ABS, PIXEL_SHARE, METRIC_ABS = 0.1, 1e-3, 0.999, 1e-3


def _tta(cfg):
    return cfg.replace(test=dataclasses.replace(cfg.test, **TTA))


@pytest.fixture(scope="module")
def cfgs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("out"))
    return (_tta(load_config(TINY_YAML).replace(output_path=out)),
            _tta(jax_load_config(TINY_YAML)))


def _boxes(rng, n, hw=(40, 48)):
    x1 = rng.uniform(0, hw[1] * 4 - 60, n)
    y1 = rng.uniform(0, hw[0] * 4 - 60, n)
    return np.stack([x1, y1, x1 + rng.uniform(8, 60, n), y1 + rng.uniform(8, 60, n)],
                    -1).astype(np.float32)


def test_greedy_nms_per_class_matches_jax(rng):
    boxes = _boxes(rng, 60)
    boxes[30:] = boxes[:30] + rng.uniform(-3, 3, (30, 4)).astype(np.float32)
    scores = rng.uniform(0, 1, 60).astype(np.float32)
    scores[5] = scores[6]  # a tie: the stable order decides
    classes = rng.randint(1, 4, 60)
    for thresh, max_out in ((0.5, 100), (0.3, 12)):
        got = ttta._greedy_nms_per_class(boxes, scores, classes, thresh, max_out)
        ref = jtta._greedy_nms_per_class(boxes, scores, classes, thresh, max_out)
        np.testing.assert_array_equal(got, ref)
        assert 0 < len(got) <= max_out


def test_fuse_tta_matches_jax(cfgs, rng):
    tcfg, jcfg = cfgs
    oh, ow = 150, 190
    seg_avg = rng.randn(oh, ow, 7).astype(np.float32)
    n = 10
    boxes = _boxes(rng, n, (oh // 4, ow // 4))
    boxes[:, 0::2] = boxes[:, 0::2].clip(0, ow - 1)
    boxes[:, 1::2] = boxes[:, 1::2].clip(0, oh - 1)
    scores = np.sort(rng.uniform(0.05, 1, n))[::-1].astype(np.float32).copy()
    classes = rng.randint(1, 5, n).astype(np.int32)
    masks = (rng.randn(n, 28, 28) * 3).astype(np.float32)
    args = (seg_avg, boxes, scores, classes, masks, 128 / 150, (128, 160), (128, 162))
    pan, keep, padded = ttta.fuse_tta(tcfg, *args, device="cpu")
    rpan, rkeep, rpadded = jtta.fuse_tta(jcfg, *args)
    np.testing.assert_array_equal(pan, rpan)
    np.testing.assert_array_equal(keep, rkeep)
    for g, r in zip(padded, rpadded):
        np.testing.assert_array_equal(g, r)
    assert keep.any() and pan.shape == (oh, ow)


def _recording(tta_module, monkeypatch) -> list:
    """The list that each ``predict_image_tta`` output of ``tta_module``
    will be appended to."""
    seen, orig = [], tta_module.predict_image_tta

    def predict_image_tta(*a, **kw):
        seen.append(orig(*a, **kw))
        return seen[-1]

    monkeypatch.setattr(tta_module, "predict_image_tta", predict_image_tta)
    return seen


def _share_equal(got, ref) -> float:
    return float((np.asarray(got) == np.asarray(ref)).mean())


def test_tta_loop_matches_jax(cfgs, monkeypatch):
    tcfg, jcfg = cfgs
    jmodel = jax_get_model(jcfg.symbol, jcfg)
    params = jax.device_get(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.zeros((1,) + tuple(jcfg.test.image_buckets[0]) + (3,))
    )["params"])
    ref_seen = _recording(jtta, monkeypatch)
    ref = jax_run_evaluation(jcfg, JaxSynthetic(jcfg, N_IMAGES, training=False), params=params,
                             use_mesh=False)

    model = get_model(tcfg.symbol, tcfg, device="cpu")
    load_jax_params(model, params)
    got_seen = _recording(tinf, monkeypatch)
    timings = {}
    got = tinf.run_evaluation(tcfg, SyntheticDataset(tcfg, N_IMAGES, training=False),
                              model=model, timings=timings)
    assert timings["images"] == N_IMAGES and timings["merge_s"] > 0 and timings["fuse_s"] > 0

    n_dets = 0
    for g, r in zip(got_seen, ref_seen, strict=True):
        assert g["image_id"] == r["image_id"] and g["orig_hw"] == r["orig_hw"]
        np.testing.assert_array_equal(g["classes"], r["classes"])
        np.testing.assert_allclose(g["boxes"], r["boxes"], rtol=0, atol=BOX_PX)
        np.testing.assert_allclose(g["scores"], r["scores"], rtol=0, atol=SCORE_ABS)
        np.testing.assert_array_equal(g["pan_keep"], r["pan_keep"])
        assert _share_equal(g["seg_pred"], r["seg_pred"]) >= PIXEL_SHARE
        assert _share_equal(g["pan_map"], r["pan_map"]) >= PIXEL_SHARE
        n_dets += len(r["classes"])
    assert n_dets > 0

    assert set(got) == set(ref) == {"boxes", "masks", "ssegs", "panoptic"}
    pairs = [(got[k][m], ref[k][m], f"{k}.{m}") for k in ("boxes", "masks")
             for m in ("AP", "AP50", "AP75")]
    pairs += [(got["ssegs"][m], ref["ssegs"][m], m) for m in ("mIoU", "pixel_acc")]
    pairs += [(got["panoptic"][part][m], ref["panoptic"][part][m], f"{part}.{m}")
              for part in ("All", "Things", "Stuff") for m in ("pq", "sq", "rq")]
    for g, r, name in pairs:
        assert (math.isnan(g) and math.isnan(r)) or abs(g - r) <= METRIC_ABS, (name, g, r)


def test_tta_variants_and_the_bucket_crop(cfgs):
    """Three scales and flip: 6 forwards an image, scale 128 first (the
    fusion's frame). At scale 176 the 256x320 image outgrows both buckets:
    ``pick_bucket`` takes the largest, ``pad_to_bucket`` crops, ``im_hw``
    keeps the uncropped size, as the JAX sample does."""
    tcfg, jcfg = cfgs
    assert ttta.tta_variants(tcfg) == [(s, f) for s in (128, 96, 176) for f in (False, True)]
    got = SyntheticDataset(tcfg, 1, training=False).sample(0, target_scale=176, hflip=True)
    ref = JaxSynthetic(jcfg, 1, training=False).sample(0, target_scale=176, hflip=True)
    assert got["images"].shape[:2] == (128, 160) and tuple(got["im_hw"]) == (176, 220)
    for k in ("images", "im_hw", "scale", "orig_hw"):
        np.testing.assert_array_equal(got[k], ref[k])


def test_the_bucket_crop_of_the_coco_tta_file():
    """The R101-DCN COCO file leaves ``test.image_buckets`` at the defaults:
    a 640x480 image at its TTA scale 960 is 960x1280, which no bucket fits,
    so the canvas is the largest bucket, 832x1344, with its rows cropped from
    960 to 832, while ``im_hw`` says 960: the semantic crop of
    ``predict_image_tta`` takes ``seg[:240]`` of a 208-row map."""
    cfg = load_config(COCO_TTA_YAML)
    assert cfg.test.image_buckets == ((832, 1344), (1344, 832))
    assert 960 in ttta.tta_variants(cfg)[-1] and len(ttta.tta_variants(cfg)) == 6
    scale = transforms.compute_resize_scale(480, 640, 960, cfg.test.max_size)
    rh, rw = round(480 * scale), round(640 * scale)
    assert (rh, rw) == (960, 1280)
    bucket = transforms.pick_bucket(rh, rw, cfg.test.image_buckets)
    canvas = transforms.pad_to_bucket(np.ones((rh, rw, 3), np.float32), bucket)
    assert bucket == (832, 1344) and canvas.shape[:2] == (832, 1344)
    assert canvas[:, rw:].sum() == 0 and rh // 4 > bucket[0] // 4
