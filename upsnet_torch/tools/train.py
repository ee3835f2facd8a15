"""Training CLI of the port.

Reference: ``python upsnet/upsnet_end2end_train.py --cfg <yaml>``
(SURVEY.md §1 L4). The flags are those of the JAX package's
``tools/train.py``, plus ``--device``:

    python -m upsnet_torch.tools.make_synth_coco coco --root data/synth_coco \\
        --image-set synthtrain --num-images 200
    python -m upsnet_torch.tools.train --cfg experiments/upsnet_r50_synth_rehearsal.yaml \\
        [--max-steps S] [--dataset-override coco|cityscapes|synthetic] [--device cpu]

It trains on the card unless ``--device cpu`` is given, and copies the
configuration file into ``<output_path>/<symbol>/``, where the log,
``metrics.jsonl`` and ``checkpoints/step_*`` go. ``train.resume: true``
resumes from the newest snapshot there.

Under ``torchrun`` it trains data-parallel, one process per card, each
with ``train.batch_size`` images a step (``parallel/``); rank 0 writes the
log, ``metrics.jsonl`` and the snapshots:

    torchrun --nproc_per_node 4 -m upsnet_torch.tools.train --cfg <yaml>

``--backend`` names the process group's backend (default NCCL on the card,
gloo on the CPU); naming it makes a group even for one process.
"""

from __future__ import annotations

import argparse
import os
import shutil

import torch

from upsnet_torch.config import load_config
from upsnet_torch.data import DATASETS, make_dataset
from upsnet_torch.parallel.mesh import close_group, make_group
from upsnet_torch.train.trainer import train
from upsnet_torch.utils.logging import create_logger
from upsnet_torch.utils.profiling import trace


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cfg", required=True, help="experiment yaml")
    ap.add_argument("--max-steps", type=int, default=None,
                    help="stop at this iteration (default train.max_iteration)")
    ap.add_argument("--dataset-override", default=None, choices=DATASETS)
    ap.add_argument("--profile-dir", default=None,
                    help="write a torch.profiler Chrome trace of the training loop here")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda; 'cpu' runs the kernels' "
                         "plain versions)")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="process group backend (default: nccl on the card, gloo on the "
                         "CPU, and no group for a single process)")
    return ap.parse_args(argv)


def run(argv=None, **train_kw):
    """Parse ``argv`` and train; returns ``train``'s (model, history).
    ``train_kw`` go to ``train`` (``model``, ``optimizer``, ``on_step``)."""
    args = parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device; pass --device cpu to "
                           "run on the CPU")
    cfg = load_config(args.cfg)
    group = make_group(cfg.num_devices, device=args.device, backend=args.backend)
    try:
        out_dir = os.path.join(cfg.output_path, cfg.symbol)
        logger = None
        if group.is_main:
            os.makedirs(out_dir, exist_ok=True)
            shutil.copy(args.cfg, out_dir)  # the reference copies the configuration
            logger = create_logger(out_dir, cfg.symbol, "train")
            logger.info("config: %s", cfg)
        dataset = make_dataset(cfg, args.dataset_override or cfg.dataset.dataset,
                               training=True)
        with trace(args.profile_dir if group.is_main else None):
            return train(cfg, dataset, logger=logger, max_steps=args.max_steps,
                         device=group.device, group=group, **train_kw)
    finally:
        close_group(group)


if __name__ == "__main__":
    run()
