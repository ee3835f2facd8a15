"""Dry-run conversion report for a PyTorch UPSNet checkpoint, the port's
counterpart of the JAX package's ``tools/convert_report.py``.

The first command to run on a released checkpoint: it prints, without
writing anything, which port unit each source key feeds, what is missing,
what is left over, and every shape mismatch. A clean report (0 missing / 0
leftover / 0 shape errors) is the precondition for the strict conversion
that ``network.pretrained: <file>.pth`` runs.

    python -m upsnet_torch.tools.convert_report --pth model/released/upsnet_r50.pth \\
        --cfg experiments/upsnet_resnet50_coco_16gpu.yaml [-v]

Exit code 0 when clean, 2 when not, 1 when the file is not a full UPSNet
state dict (torchvision ResNet weights load through ``load_pretrained``).
The model is built on the CPU; nothing runs on the card.
"""

from __future__ import annotations

import argparse
import sys

from upsnet_torch.config import load_config
from upsnet_torch.convert.torch_converter import load_torch_state
from upsnet_torch.convert.upsnet_names import convert_upsnet_state, looks_like_upsnet
from upsnet_torch.models import get_model


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pth", required=True, help="torch checkpoint path")
    ap.add_argument("--cfg", required=True, help="experiment yaml (defines "
                    "the target architecture the state dict maps onto)")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="also list every loaded unit")
    args = ap.parse_args(argv)

    cfg = load_config(args.cfg)
    state = load_torch_state(args.pth)
    print(f"checkpoint: {args.pth}  ({len(state)} tensors)")
    if not looks_like_upsnet(state):
        print("naming scheme: NOT a full UPSNet state dict (torchvision "
              "ResNet backbones go through load_pretrained instead)")
        return 1

    target = get_model(cfg.symbol, cfg, device="cpu").state_dict()
    _, report = convert_upsnet_state(state, target, strict=False)

    print(f"loaded units : {len(report['loaded'])}")
    if args.verbose:
        for u in report["loaded"]:
            print(f"  LOADED   {u}")
    for u in report["defaulted"]:
        print(f"  DEFAULTED(bias=0) {u}")
    for u in report["missing"]:
        print(f"  MISSING  {u}")
    for k in report["leftover"]:
        print(f"  LEFTOVER {k}")
    for s in report["shape_errors"]:
        print(f"  SHAPE    {s}")
    ok = not (report["missing"] or report["leftover"]
              or report["shape_errors"])
    print("CLEAN - strict conversion will succeed" if ok
          else "NOT CLEAN - fix upsnet_torch/convert/upsnet_names.py's spec table "
               "(alternates exist per entry) before a parity run")
    return 0 if ok else 2


if __name__ == "__main__":
    sys.exit(main())
