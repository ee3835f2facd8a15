"""Write a "pretrained" snapshot of a frozen-BN model whose BN affines are
folded from data, so that the frozen-BN parity file trains from it.

The port's copy of the JAX package's ``tools/make_synth_pretrained.py``.
A released frozen-BN backbone carries affines folded from ImageNet running
statistics, ``gamma / sqrt(var + eps)``, which whiten each BN output; a
random model with identity affines lets activations grow with depth. This
tool folds statistics measured on a calibration batch instead (LSUV-style):

  1. build the model of ``--cfg`` from ``cfg.seed`` (random convs, identity
     ``FrozenBatchNorm`` affines);
  2. forward 4 caffe-convention images (uniform 0-255 BGR minus
     ``PIXEL_MEANS_BGR``, from ``np.random.RandomState(cfg.seed)``) through
     the backbone, capturing every ``FrozenBatchNorm`` output with a
     forward hook;
  3. refold each affine per channel so that its output is whitened under
     the current input: ``s' = s / sd``, ``b' = (b - mu) / sd``, with mu and
     sd taken in float32 over every axis but the channel one, and only where
     ``sd > 5e-2`` (a dead channel keeps its affine: 1 / sd would blow its
     noise up and the next pass to inf);
  4. repeat ``--passes`` times (upstream refolds change downstream inputs);
     exit non-zero unless the worst |mean| and |std - 1| are <= 0.1;
  5. write ``<out>/step_00000000`` (``train/checkpoints.py``), which
     ``network.pretrained`` loads as an exact match.

Usage (the frozen-BN parity file, unchanged):

    python -m upsnet_torch.tools.make_synth_pretrained \\
        --cfg experiments/upsnet_r50_synth_frozenbn.yaml --out model/synth_frozenbn_r50
    python -m upsnet_torch.tools.train --cfg experiments/upsnet_r50_synth_frozenbn.yaml

It runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from upsnet_torch.config import load_config
from upsnet_torch.data.transforms import PIXEL_MEANS_BGR
from upsnet_torch.models import get_model
from upsnet_torch.models.layers import FrozenBatchNorm
from upsnet_torch.train.checkpoints import write_checkpoint

LIVE_SD = 5e-2  # below it a channel is dead under the calibration batch
CONVERGED = 0.1  # the worst |mean| and |std - 1| the snapshot may keep


def calibration_images(seed: int, h: int, w: int) -> np.ndarray:
    """(4, h, w, 3) float32: uniform 0-255 BGR minus the pipeline's means."""
    rng = np.random.RandomState(seed)
    return rng.uniform(0.0, 255.0, (4, h, w, 3)).astype(np.float32) - PIXEL_MEANS_BGR


@torch.no_grad()
def fold_once(model, images: torch.Tensor) -> tuple[float, float]:
    """One calibration pass over ``images`` (B, H, W, 3) on the model's
    device: refold every ``FrozenBatchNorm`` of ``model`` in place. Returns
    (worst |mean|, worst |std - 1|) over the live channels of every BN output
    before the refold."""
    captured = {}
    hooks = [m.register_forward_hook(lambda mod, _, out: captured.__setitem__(mod, out))
             for m in model.modules() if isinstance(m, FrozenBatchNorm)]
    try:
        x = images.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        model.backbone_net(x)
    finally:
        for h in hooks:
            h.remove()
    worst_mu, worst_sd = 0.0, 0.0
    for bn, out in captured.items():
        out = out.float()
        mu = out.mean(dim=(0, 2, 3))
        sd = out.std(dim=(0, 2, 3), correction=0)
        live = sd > LIVE_SD
        sd_safe = torch.where(live, sd, torch.ones_like(sd))
        bn.scale.copy_(torch.where(live, bn.scale / sd_safe, bn.scale))
        bn.bias.copy_(torch.where(live, (bn.bias - mu) / sd_safe, bn.bias))
        worst_mu = max(worst_mu, float(torch.where(live, mu, 0.0).abs().max()))
        worst_sd = max(worst_sd, float((torch.where(live, sd, 1.0) - 1.0).abs().max()))
    return worst_mu, worst_sd


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cfg", required=True, help="experiment yaml with network.norm=frozen_bn")
    ap.add_argument("--out", required=True, help="output snapshot directory")
    ap.add_argument("--passes", type=int, default=6)
    ap.add_argument("--calib-hw", type=int, nargs=2, default=(256, 320),
                    help="calibration input size (the statistics are per channel; the "
                         "resolution matters little)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs on the CPU)")
    return ap.parse_args(argv)


def run(argv=None) -> tuple[str, list]:
    """Parse ``argv``, fold and write the snapshot. Returns (its path, the
    (worst |mean|, worst |std - 1|) of each pass). Raises ``SystemExit``
    for a ``norm`` other than ``frozen_bn`` and when the fold has not
    converged."""
    args = parse_args(argv)
    cfg = load_config(args.cfg)
    if cfg.network.norm != "frozen_bn":
        raise SystemExit(f"{args.cfg}: network.norm={cfg.network.norm!r}; folding only "
                         "applies to frozen_bn")
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device; pass --device cpu to "
                           "run on the CPU")
    model = get_model(cfg.symbol, cfg, device=args.device,
                      generator=torch.Generator().manual_seed(cfg.seed))
    h, w = args.calib_hw
    images = torch.from_numpy(calibration_images(cfg.seed, h, w)).to(args.device)
    passes = []
    for i in range(args.passes):
        passes.append(fold_once(model, images))
        print(f"pass {i + 1}: worst BN-out |mean| = {passes[-1][0]:.4f}, "
              f"worst |std-1| = {passes[-1][1]:.4f}", flush=True)
    if not passes or max(passes[-1]) > CONVERGED:
        raise SystemExit("calibration did not converge; raise --passes")
    path = write_checkpoint(os.path.abspath(args.out), 0, model.state_dict())
    print(f"saved folded frozen-BN init: {path}")
    return path, passes


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
