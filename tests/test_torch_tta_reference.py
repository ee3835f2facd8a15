"""The port's test-time augmentation against the benchmark's plain float32
reference (``portbench/reference/tta_ref.py``), and the TTA cells'
configuration files against the experiments they copy.

  * on seeded random weights (``portbench/weights.py``) at a tiny size (the
    ``resnet_test`` trunk, one 64x128 frame, the Cityscapes file's protocol
    cut to the frame: scale 64 with max size 128 and multi-scale 48 / 64 /
    80, flipped and not, six variants on the one 64x128 canvas), the port's
    ``predict_image_tta`` through ``sample_predictor`` against the
    reference's own variants, merge and fusion: the merged full-resolution
    semantic logits, the kept detections (classes, boxes, scores, mask
    logits) and the panoptic map; and the reference's judge
    (``judge_tta``) under the TTA cell's limits;
  * the same with the port's ``tta_variants`` cut to the unflipped ones (a
    TTA that drops the flipped variants): the comparison fails;
  * the same comparison on the R101-DCN COCO file's protocol cut to a tiny
    size (``coco_dcn_crop``): DCN in the trunk's C3-C5 and the FCN, 81
    classes and 133 semantic channels (53 stuff), a 48x64 frame at scales
    64, 48 and 80 over two mirrored buckets, 64x128 and 128x64; 64 and 48
    fit the first, and 80 (80x107) outgrows both and is cropped to 64x128,
    as 960 crops a 640x480 frame on the COCO TTA cell's 832x1344;
  * ``portbench/configs/r101_cityscapes.json`` and
    ``portbench/configs/r101dcn_coco.json`` equal what
    ``upsnet_torch.config.loader`` makes of the experiments they copy, key
    by key, and build the files' models.

No JAX in this file's comparisons: both sides are PyTorch on the CPU.
"""

import copy
import functools
import json
import pathlib

import numpy as np
import pytest
import torch

from portbench import weights as W
from portbench.drivers.tta import frames_dataset
from portbench.reference import tta_ref
from portbench.reference.upsnet_ref import Ref
from portbench.traffic.generator import scene
from upsnet_torch.config import default_config, load_config
from upsnet_torch.config.loader import update_config
from upsnet_torch.evaluation import tta
from upsnet_torch.evaluation.inference import sample_predictor
from upsnet_torch.models import get_model

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent
CITY_YAML = REPO / "experiments" / "upsnet_resnet101_cityscapes_w_coco_16gpu.yaml"
CITY_JSON = REPO / "portbench" / "configs" / "r101_cityscapes.json"
COCO_YAML = REPO / "experiments" / "upsnet_resnet101_dcn_coco_3x_16gpu.yaml"
COCO_JSON = REPO / "portbench" / "configs" / "r101dcn_coco.json"
TTA_MIX = REPO / "portbench" / "traffic" / "tta_city_b1.json"
COCO_MIX = REPO / "portbench" / "traffic" / "tta_coco_b1.json"
SEED = 2 ** 31 + 2207
FRAME = (64, 128)
COCO_FRAME = (48, 64)
# Float32 on both sides, but convolutions, matmuls and resizes sum in other
# orders (oneDNN against plain loops): about 1e-7 relative per layer, 1e-6
# through the tiny trunk; the merged logits and the mask logits are held
# 100 times above that and far below the 0.09 that float8 reads here.
LOGITS_REL = 1e-4
# boxes are decoded from those logits through exp: a few 1e-5 px
BOX_PX = 1e-3
SCORE_ABS = 1e-5


def tiny_model_cfg() -> dict:
    conf = json.loads((REPO / "portbench" / "configs" / "r50_coco.json").read_text())
    m = copy.deepcopy(conf["model"])
    m["symbol"] = "upsnet"
    m["dataset"].update(num_classes=5, num_seg_classes=7, num_stuff=3)
    m["network"].update(backbone="resnet_test", fpn_feature_dim=32, rcnn_fc_dim=64,
                        fcn_head_dim=16, compute_dtype="float32")
    m["test"].update(rpn_pre_nms_top_n=64, rpn_post_nms_top_n=32, max_det=8, scales=[64],
                     max_size=128, image_buckets=[list(FRAME)], multi_scale=[48, 64, 80],
                     flip_test=True)
    return {"model": m, "weights": dict(conf["weights"], cls_score_std=0.3)}


def tiny_coco_cfg() -> dict:
    """The R101-DCN COCO file's model and TTA at a tiny size: its DCN trunk
    and classes, its three scales (800, 640, 960 of a 640x480 frame) cut to
    64, 48, 80 of a 48x64 one, the largest beyond every bucket."""
    conf = json.loads(COCO_JSON.read_text())
    m = copy.deepcopy(conf["model"])
    m["symbol"] = "upsnet"
    m["network"].update(backbone="resnet_test", fpn_feature_dim=32, rcnn_fc_dim=64,
                        fcn_head_dim=16, compute_dtype="float32")
    m["test"].update(rpn_pre_nms_top_n=64, rpn_post_nms_top_n=32, max_det=8, scales=[64],
                     max_size=133, image_buckets=[[64, 128], [128, 64]],
                     multi_scale=[48, 64, 80])
    return {"model": m, "weights": dict(conf["weights"], cls_score_std=0.3)}


# protocol: (configuration, frame, its mix); three things in the frame
PROTOCOLS = {"city": (tiny_model_cfg, FRAME, TTA_MIX),
             "coco": (tiny_coco_cfg, COCO_FRAME, COCO_MIX)}


def _program(conf, frame, state, monkeypatch, drop_flips: bool):
    """The port's TTA of one frame: (variants with their outputs, the merged
    evidence handed to the fusion, the result)."""
    cfg = update_config(default_config(), conf["model"])
    model = get_model(cfg.symbol, cfg, device="cpu")
    model.load_state_dict(state)
    predict = sample_predictor(model, cfg)
    if drop_flips:
        variants = tta.tta_variants
        monkeypatch.setattr(tta, "tta_variants",
                            lambda c: [v for v in variants(c) if not v[1]])
    run, merged = [], {}
    fuse = tta.fuse_tta

    def keep_merged(*args, **kw):
        merged.update(zip(("seg_logits", "boxes", "scores", "classes", "mask_logits"),
                          args[1:6]))
        return fuse(*args, **kw)

    monkeypatch.setattr(tta, "fuse_tta", keep_merged)

    def rec(bucket, s):
        out = predict(bucket, s, False)
        run.append({"scale": float(s["scale"]), "bucket": bucket,
                    "im_hw": tuple(float(v) for v in s["im_hw"]), **out})
        return out

    result = tta.predict_image_tta(cfg, frames_dataset(cfg, [frame]), 0, rec, "cpu")
    for v, (t, f) in zip(run, tta.tta_variants(cfg)):
        v.update(target=t, flip=f)
    return run, dict(merged, pan_map=result["pan_map"], pan_keep=result["pan_keep"]), result


@functools.lru_cache(maxsize=None)
def reference_run(protocol: str):
    make_conf, hw, _ = PROTOCOLS[protocol]
    conf = make_conf()
    ds = conf["model"]["dataset"]
    rng = np.random.default_rng(SEED)
    frame = scene(rng, hw, ds["num_classes"] - 1, ds["num_stuff"], (3, 3), 20)[0]
    cfg = update_config(default_config(), conf["model"])
    shapes = W.state_shapes(get_model(cfg.symbol, cfg, device="cpu"))
    state = W.make_state(shapes, conf["weights"], SEED, "cpu")
    ref = Ref(conf["model"], state)
    ref_outs = tta_ref.run_variants(ref, torch.from_numpy(frame), conf["model"])
    return conf, frame, state, ref_outs, tta_ref.tta(ref_outs, hw, conf["model"])


def _rel(a, b) -> float:
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("protocol,drop_flips", [("city", False), ("city", True),
                                                  ("coco", False)],
                         ids=["six_variants", "flips_dropped", "coco_dcn_crop"])
def test_port_tta_matches_the_plain_reference(monkeypatch, protocol, drop_flips):
    conf, frame, state, ref_outs, want = reference_run(protocol)
    run, merged, result = _program(conf, frame, state, monkeypatch, drop_flips)
    limits = json.loads(PROTOCOLS[protocol][2].read_text())["limits"]
    if protocol == "coco":
        # the protocol's geometry: the DCN trunk, 133 channels, the crop
        net = conf["model"]["network"]
        assert net["backbone_with_dcn"] and net["fcn_with_dcn"]
        assert run[0]["seg_logits"].shape[-1] == 133
        assert [(v["bucket"], tuple(int(x) for x in v["im_hw"])) for v in run[::2]] == [
            ((64, 128), (64, 85)), ((64, 128), (48, 64)), ((64, 128), (80, 107))]
    numbers = tta_ref.judge_tta(ref_outs, run, merged, conf["model"])
    n = len(want["scores"])
    agree = {
        "variants": len(run) == len(ref_outs),
        "seg_logits": _rel(merged["seg_logits"], want["seg_logits"]) <= LOGITS_REL,
        "count": len(result["scores"]) == n,
        "judge": all(numbers[k] <= limits[k] for k in tta_ref.NUMBERS),
    }
    if agree["count"]:
        agree["classes"] = np.array_equal(result["classes"], want["classes"].numpy())
        agree["boxes"] = bool(np.abs(result["boxes"] - want["boxes"].numpy()).max(initial=0)
                              <= BOX_PX)
        agree["scores"] = bool(np.abs(result["scores"] - want["scores"].numpy()).max(initial=0)
                               <= SCORE_ABS)
        agree["masks"] = n == 0 or _rel(result["mask_logits"], want["mask_logits"]) <= LOGITS_REL
        agree["pan_keep"] = np.array_equal(result["pan_keep"], want["pan_keep"].numpy())
        agree["pan_map"] = np.array_equal(result["pan_map"], want["pan_map"].numpy())
    if drop_flips:
        assert not all(agree.values()), (agree, numbers)
        assert not agree["seg_logits"] and not agree["judge"], (agree, numbers)
    else:
        assert n > 0, "the tiny frame kept no detection: the comparison would see no boxes"
        assert all(agree.values()), (agree, numbers)
        assert numbers["tta_seg_err"] <= LOGITS_REL and numbers["tta_det_err"] <= LOGITS_REL
        assert numbers["tta_pan_gap"] == 0.0


def _config_file_is_the_experiment(path, yaml) -> dict:
    """The configuration file's model, checked key by key against what the
    loader makes of ``yaml``."""
    conf = json.loads(path.read_text())
    want = json.loads(json.dumps(load_config(str(yaml)).to_dict()))
    got = json.loads(json.dumps(update_config(default_config(), conf["model"]).to_dict()))
    for section in ("network", "test", "dataset", "train"):
        assert got[section] == want[section], section
        assert conf["model"][section] == want[section], section
    assert conf["model"]["symbol"] == want["symbol"] == "resnet_101_upsnet"
    assert conf["reduced"] == []
    return conf


def test_cityscapes_config_file_is_the_experiment_as_loaded():
    conf = _config_file_is_the_experiment(CITY_JSON, CITY_YAML)
    net, test = conf["model"]["network"], conf["model"]["test"]
    assert (net["backbone"], net["backbone_with_dcn"], net["fcn_with_dcn"]) == (
        "resnet101", False, True)
    assert test["image_buckets"] == [[1024, 2048]] and test["flip_test"]
    assert tta_ref.variants(test) == [(1024, False), (1024, True), (768, False), (768, True),
                                      (1280, False), (1280, True)]
    # every variant of a 2048x1024 frame runs on the one canvas; 1280 is
    # capped by max_size 2048
    canvases = [tta_ref.variant_canvas(1024, 2048, s, test) for s, _ in tta_ref.variants(test)]
    assert {c[2] for c in canvases} == {(1024, 2048)}
    assert [c[1] for c in canvases[::2]] == [(1024, 2048), (768, 1536), (1024, 2048)]


def test_coco_tta_config_file_is_the_experiment_as_loaded():
    conf = _config_file_is_the_experiment(COCO_JSON, COCO_YAML)
    net, test = conf["model"]["network"], conf["model"]["test"]
    assert (net["backbone"], net["backbone_with_dcn"], net["fcn_with_dcn"]) == (
        "resnet101", True, True)
    assert test["image_buckets"] == [[832, 1344], [1344, 832]] and test["flip_test"]
    assert tta_ref.variants(test) == [(800, False), (800, True), (640, False), (640, True),
                                      (960, False), (960, True)]
    # the COCO TTA cell's 640x480 frame: 800 and 640 fit 832x1344; 960 makes
    # 960x1280, which no bucket holds, and is cropped to the larger (the first)
    frame = json.loads(COCO_MIX.read_text())["frame"]
    canvases = [tta_ref.variant_canvas(*frame, s, test) for s, _ in tta_ref.variants(test)]
    assert {c[2] for c in canvases} == {(832, 1344)}
    assert [c[1] for c in canvases[::2]] == [(800, 1067), (640, 853), (960, 1280)]
