"""A tiny configuration and mix for the CPU tests, and a checkout-like copy
of the benchmark in a temporary directory."""

from __future__ import annotations

import copy
import json
import pathlib
import shutil

REPO = pathlib.Path(__file__).resolve().parents[2]
CELL = "tiny.serve"
TRAIN_CELL = "tiny.train"


def tiny_config() -> dict:
    conf = json.loads((REPO / "portbench" / "configs" / "r50_coco.json").read_text())
    conf = copy.deepcopy(conf)
    m = conf["model"]
    m["symbol"] = "upsnet"
    m["dataset"].update(num_classes=5, num_seg_classes=7, num_stuff=3)
    m["network"].update(backbone="resnet_test", fpn_feature_dim=32, rcnn_fc_dim=64,
                        fcn_head_dim=16, compute_dtype="float32")
    m["test"].update(rpn_pre_nms_top_n=64, rpn_post_nms_top_n=32, max_det=8,
                     image_buckets=[[64, 96]])
    m["train"].update(rpn_pre_nms_top_n=64, rpn_post_nms_top_n=32, rpn_batch_size=32,
                      batch_rois=16, max_gt_instances=8, image_buckets=[[64, 96], [96, 64]],
                      rpn_straddle_thresh=0.0, display_iter=2)
    conf["name"] = "tiny"
    conf["weights"]["cls_score_std"] = 0.3
    return conf


def tiny_mix(batch: int = 2) -> dict:
    mix = json.loads((REPO / "portbench" / "traffic" / "serve_b1.json").read_text())
    mix.update(batch=batch, bucket=[64, 96], short_side=60, long_side=[70, 96],
               instances=[1, 3], pool=3, warmup=1, trace_requests=2,
               check={"pool": 3, "requests": 2})
    return mix


def checkout(tmp: pathlib.Path, conf=None, mix=None, per_layer=None) -> pathlib.Path:
    """``BENCHMARK.json`` and ``portbench/`` copied under ``tmp``, with the
    tiny configuration, the tiny mixes and the cells ``tiny.serve`` and
    ``tiny.train`` added as files and manifest entries."""
    root = tmp / "checkout"
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    manifest = json.loads((REPO / "BENCHMARK.json").read_text())
    (root / "portbench" / "configs" / "tiny.json").write_text(json.dumps(conf or tiny_config()))
    (root / "portbench" / "traffic" / "tiny_mix.json").write_text(json.dumps(mix or tiny_mix()))
    manifest["configs"].append({"name": "tiny", "source": "tiny", "file": "portbench/configs/tiny.json",
                                "reduced": [], "why": "CPU tests"})
    (root / "portbench" / "traffic" / "tiny_train.json").write_text(json.dumps(tiny_train_mix()))
    manifest["workloads"].append({"name": CELL, "config": "tiny", "traffic": "tiny_mix",
                                  "chips": 1, "why": "CPU tests"})
    manifest["workloads"].append({"name": TRAIN_CELL, "config": "tiny", "traffic": "tiny_train",
                                  "chips": 1, "why": "CPU tests"})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "workloads" in m and "r50_coco.serve_b1" in m["workloads"]:
            m["workloads"].append(CELL)
        if "workloads" in m and "r50_coco.train_b8" in m["workloads"]:
            m["workloads"].append(TRAIN_CELL)
    manifest["per_layer"] += per_layer or []
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    return root


def tiny_train_mix(buckets=((64, 96),)) -> dict:
    """The training mix of ``r50_coco.train_b8``, limits included, at a
    tiny size."""
    mix = json.loads((REPO / "portbench" / "traffic" / "train_b8.json").read_text())
    mix.update(batch=2, buckets=[list(b) for b in buckets], fill=[0.8, 1.0], instances=[1, 3],
               pool=2, trace_steps=1)
    return mix
