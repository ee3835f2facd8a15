"""Golden-tensor parity harness: dump a model's per-stage tensors for one
image, and compare two dumps.

The port's copy of the JAX package's ``tools/goldens.py``. A dump holds the
JAX tool's keys in its layout (feature maps channel-last, batch row 0), so
a dump of either package compares against a dump of the other, or against a
dump of a released reference ``.pth``:

    python -m upsnet_torch.tools.goldens dump --cfg <yaml> \\
        [--weights <port snapshot> | --pth <reference .pth>] \\
        [--image path.jpg | --synthetic 0] --out goldens.npz [--device cpu]
    python -m upsnet_torch.tools.goldens compare a.npz b.npz [--atol 1e-3]

Keys: backbone ``C2``..``C5``, FPN ``P2``..``P6``, ``rpn_cls_P<l>`` and
``rpn_bbox_P<l>`` per level, then ``forward_predict``'s ``boxes``,
``scores``, ``classes``, ``det_valid``, ``mask_logits``, ``seg_logits``,
``pan_map`` and ``pan_keep``. Without ``--weights`` or ``--pth`` the model
is the seeded random init. A bfloat16 tensor is written as its 2-byte
pattern, the ``|V2`` dtype numpy gives the JAX package's bfloat16 arrays on
save; ``compare`` reads such arrays as bfloat16 (the JAX tool's compare
cannot cast them). The dump runs on the card unless ``--device cpu`` is
given.
"""

from __future__ import annotations

import argparse
import logging
import sys

import numpy as np
import torch

PREDICT_KEYS = ("boxes", "scores", "classes", "det_valid", "mask_logits",
                "seg_logits", "pan_map", "pan_keep")


def _np(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view("V2")
    return t.numpy()


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return _np(t[0].permute(1, 2, 0))


def expected_layout(cfg, bucket) -> dict:
    """{key: shape} of a dump of ``cfg`` on a ``bucket`` canvas (multiples
    of 32), as the JAX tool writes it: C2..C5 at strides 4..32 with 256, 512,
    1024, 2048 channels; P2..P6 at strides 4..64 with ``fpn_feature_dim``;
    the RPN's 2A and 4A channels per level; ``max_det`` detections with
    ``mask_size`` masks of their class; the semantic logits and the panoptic
    map at stride 4."""
    h, w = bucket
    net, d = cfg.network, cfg.test.max_det
    hw = {lv: (-(-h >> lv), -(-w >> lv)) for lv in range(2, 7)}  # P6 keeps P5's odd edge
    out = {f"C{lv}": (*hw[lv], 64 << lv) for lv in range(2, 6)}
    for lv in range(2, 7):
        out[f"P{lv}"] = (*hw[lv], net.fpn_feature_dim)
        out[f"rpn_cls_P{lv}"] = (*hw[lv], 2 * net.num_anchors)
        out[f"rpn_bbox_P{lv}"] = (*hw[lv], 4 * net.num_anchors)
    out.update(boxes=(d, 4), scores=(d,), classes=(d,), det_valid=(d,),
               mask_logits=(d, net.mask_size, net.mask_size),
               seg_logits=(h // 4, w // 4, cfg.dataset.num_seg_classes),
               pan_map=(h // 4, w // 4), pan_keep=(d,))
    return out


def _input(cfg, args) -> tuple[np.ndarray, tuple[float, float]]:
    """The padded canvas (H, W, 3) and its image's (h, w), as the JAX tool
    makes them: ``--image`` resized at the first test scale and padded to
    the first test bucket, else synthetic image ``--synthetic``."""
    if args.image:
        import cv2

        from upsnet_torch.data import transforms as T

        img = cv2.imread(args.image, cv2.IMREAD_COLOR).astype(np.float32)
        scale = T.compute_resize_scale(img.shape[0], img.shape[1], cfg.test.scales[0],
                                       cfg.test.max_size)
        img = T.normalize_bgr(T.resize_image(img, scale))
        rh, rw = img.shape[:2]
        return T.pad_to_bucket(img, tuple(cfg.test.image_buckets[0])), (rh, rw)
    from upsnet_torch.data.synthetic import SyntheticDataset

    s = SyntheticDataset(cfg, num_images=8, training=False).sample(int(args.synthetic))
    rh, rw = s["im_hw"]
    return s["images"], (rh, rw)


@torch.no_grad()
def dump_tensors(model, cfg, canvas: np.ndarray, im_hw, device) -> dict:
    """The dump's arrays for one canvas (H, W, 3) with image size ``im_hw``
    through ``model`` on ``device``."""
    from upsnet_torch.evaluation.inference import bucket_anchors
    from upsnet_torch.models.upsnet import forward_predict

    images = torch.from_numpy(np.ascontiguousarray(canvas, np.float32))[None].to(device)
    hw = torch.tensor([[float(im_hw[0]), float(im_hw[1])]], device=device)
    anchors = bucket_anchors(cfg, tuple(canvas.shape[:2]), device)
    out = {}
    x = images.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    cs = model.backbone_net(x)
    for i, c in enumerate(cs, start=2):
        out[f"C{i}"] = _nhwc(c)
    pyr = model.fpn(cs)
    for i, p in enumerate(pyr, start=2):
        out[f"P{i}"] = _nhwc(p)
    rpn_cls, rpn_bbox = model.rpn(pyr)  # per level (B, H, W, A*k) already
    for i, (c, b) in enumerate(zip(rpn_cls, rpn_bbox), start=2):
        out[f"rpn_cls_P{i}"] = _np(c[0])
        out[f"rpn_bbox_P{i}"] = _np(b[0])
    pred = forward_predict(model, cfg, anchors, {"images": images, "im_hw": hw})
    for k in PREDICT_KEYS:
        out[k] = _np(pred[k][0])
    return out


def dump(args) -> None:
    from upsnet_torch.config import load_config
    from upsnet_torch.models import get_model

    cfg = load_config(args.cfg)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device; pass --device cpu to "
                           "run on the CPU")
    model = get_model(cfg.symbol, cfg, device=args.device,
                      generator=torch.Generator().manual_seed(cfg.seed))
    log = logging.getLogger("goldens")
    if args.weights:
        from upsnet_torch.train.trainer import load_pretrained_any

        load_pretrained_any(args.weights, model, log)
    elif args.pth:
        # parity against a released UPSNet .pth: strict conversion, then dump
        from upsnet_torch.convert.torch_converter import load_pretrained

        load_pretrained(args.pth, model, log)
    canvas, im_hw = _input(cfg, args)
    out = dump_tensors(model, cfg, canvas, im_hw, args.device)
    np.savez_compressed(args.out, **out)
    print(f"wrote {len(out)} tensors to {args.out}")


def _float64(a: np.ndarray) -> np.ndarray:
    if a.dtype == np.dtype("V2"):  # bfloat16 bits
        return (a.view(np.uint16).astype(np.uint32) << 16).view(np.float32).astype(np.float64)
    return a.astype(np.float64)


def compare(args) -> int:
    a = np.load(args.a)
    b = np.load(args.b)
    keys = sorted(set(a.files) & set(b.files))
    missing = sorted(set(a.files) ^ set(b.files))
    worst = 0.0
    for k in keys:
        x, y = _float64(a[k]), _float64(b[k])
        if x.shape != y.shape:
            print(f"{k}: SHAPE MISMATCH {x.shape} vs {y.shape}")
            worst = np.inf
            continue
        d = np.abs(x - y).max() if x.size else 0.0
        rel = d / max(np.abs(y).max(), 1e-12)
        status = "OK" if d <= args.atol else "DIFF"
        print(f"{k}: max_abs={d:.3e} max_rel={rel:.3e} {status}")
        worst = max(worst, d)
    if missing:
        print("only in one file:", missing)
    print("worst:", worst)
    return 0 if worst <= args.atol and not missing else 1


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("dump")
    d.add_argument("--cfg", required=True)
    d.add_argument("--weights", default=None,
                   help="port snapshot (<dir>/step_XXXXXXXX), loaded as network.pretrained is")
    d.add_argument("--pth", default=None,
                   help="released UPSNet .pth (strict conversion, then dump)")
    d.add_argument("--image", default=None)
    d.add_argument("--synthetic", default=0)
    d.add_argument("--out", required=True)
    d.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs the kernels' plain versions)")
    c = sub.add_parser("compare")
    c.add_argument("a")
    c.add_argument("b")
    c.add_argument("--atol", type=float, default=1e-3)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.cmd == "dump":
        dump(args)
        return 0
    return compare(args)


if __name__ == "__main__":
    sys.exit(main())
