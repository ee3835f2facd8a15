"""Inference + evaluation CLI of the port.

Reference: ``python upsnet/upsnet_end2end_test.py --cfg <yaml>``
(SURVEY.md §3.2): run the eval branch over the test split, then
evaluate_boxes / evaluate_masks / evaluate_ssegs / evaluate_panoptic. The
flags are those of the JAX package's ``tools/test.py``, plus ``--device``:

    python -m upsnet_torch.tools.test --cfg experiments/upsnet_tiny_synthetic.yaml \\
        --dataset-override synthetic [--weights <port checkpoint>] [--device cpu] \\
        [--results-json results.json]

It runs on the card unless ``--device cpu`` is given. The datasets are
``coco`` and ``cityscapes`` (files under ``dataset.dataset_path``, split
``dataset.test_image_set``) and ``synthetic``. ``test.multi_scale`` and
``test.flip_test`` run test-time augmentation (``evaluation/tta.py``).

Under ``torchrun`` each process predicts its share of the images and rank 0
evaluates them all:

    torchrun --nproc_per_node 4 -m upsnet_torch.tools.test --cfg <yaml> --weights <ckpt>
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os

import torch

from upsnet_torch.config import load_config
from upsnet_torch.data import DATASETS, make_dataset
from upsnet_torch.evaluation.coco_eval import format_table
from upsnet_torch.evaluation.inference import run_evaluation
from upsnet_torch.parallel.mesh import close_group, make_group
from upsnet_torch.utils.logging import create_logger


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cfg", required=True)
    ap.add_argument("--weights", "--weight_path", default=None,
                    help="port checkpoint path (upsnet_torch/train/checkpoints.py; "
                         "--weight_path is the reference CLI's spelling)")
    ap.add_argument("--dataset-override", default=None, choices=DATASETS)
    ap.add_argument("--max-images", type=int, default=None)
    ap.add_argument("--no-artifacts", action="store_true",
                    help="skip writing panoptic PNG/JSON artifacts")
    ap.add_argument("--results-json", default=None,
                    help="also write the evaluators' results to this file as JSON")
    ap.add_argument("--no-mesh", action="store_true",
                    help="accepted for the JAX CLI's sake: the port predicts one image a "
                         "forward, and its processes come from torchrun, so it changes "
                         "nothing")
    ap.add_argument("--dcn-impl", default=None,
                    help="override network.dcn_impl for this eval (e.g. 'pallas' to "
                         "measure the window-clipped path vs the exact 'auto' routing)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; 'cpu' runs the kernels' "
                         "plain versions)")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="process group backend (default: nccl on the card, gloo on the "
                         "CPU, and no group for a single process)")
    return ap.parse_args(argv)


def run(argv=None) -> tuple[dict, dict]:
    """Parse ``argv``, evaluate, log the results; returns (the evaluators'
    results by name, the timings of ``run_evaluation``)."""
    args = parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device; pass --device cpu to "
                           "run on the CPU")
    cfg = load_config(args.cfg)
    if args.dcn_impl:
        cfg = cfg.replace(network=dataclasses.replace(cfg.network, dcn_impl=args.dcn_impl))
    dataset = make_dataset(cfg, args.dataset_override or cfg.dataset.dataset, training=False)
    out_dir = os.path.join(cfg.output_path, cfg.symbol)
    group = make_group(cfg.num_devices, device=args.device, backend=args.backend)
    try:
        if group.is_main:
            os.makedirs(out_dir, exist_ok=True)
            logger = create_logger(out_dir, cfg.symbol, "test")
        else:
            logger = logging.getLogger(f"{__name__}.rank{group.rank}")
        timings: dict = {}
        results = run_evaluation(
            cfg, dataset, weights=args.weights, logger=logger,
            max_images=args.max_images,
            output_dir=None if args.no_artifacts else os.path.join(out_dir, "panoptic"),
            device=group.device, timings=timings, group=group,
        )
    finally:
        close_group(group)
    for k, v in results.items():
        logger.info("%s: %s", k, v)
        if k in ("boxes", "masks") and "APs" in v:
            # the reference prints the full pycocotools 12-metric table
            logger.info("%s COCOeval table:\n%s", k, format_table(v, cfg.test.max_det))
    if args.results_json and group.is_main:
        with open(args.results_json, "w") as f:  # numpy scalars and arrays as numbers, lists
            json.dump(results, f, default=lambda value: value.tolist())
    return results, timings


if __name__ == "__main__":
    run()
