"""Write synthetic datasets in the exact on-disk layouts of COCO panoptic
and Cityscapes gtFine.

The port's copy of the JAX package's ``tools/make_synth_coco.py``, on the
port's RLE codec and panoptic format: with the same seed it writes the same
files. The datasets parse them as they would real data: the
``instances_*.json`` with RLE segmentations, the panoptic PNG id codec, the
gtFine label and instance PNG pairs.

  * COCO panoptic (``data/coco.py``):
      {root}/annotations/instances_{set}.json
      {root}/annotations/panoptic_{set}.json
      {root}/annotations/panoptic_{set}/*.png   (id_to_rgb encoded)
      {root}/{set}/*.jpg
  * Cityscapes gtFine (``data/cityscapes.py``):
      {root}/leftImg8bit/{split}/{city}/*_leftImg8bit.png
      {root}/gtFine/{split}/{city}/*_gtFine_{labelIds,instanceIds}.png

Scenes are occluding ellipses, rectangles and triangles ("things", their
class given by a colour and shape per category) over banded, textured
"stuff"; the GT is exact by construction. The full 80-thing / 53-stuff COCO
category lists are written (synthetic names), so the heads have the COCO
shapes; only a small palette appears in the scenes.

Usage:
  python -m upsnet_torch.tools.make_synth_coco coco --root data/synth_coco \
      --num-images 200 --image-set synthtrain
  python -m upsnet_torch.tools.make_synth_coco cityscapes \
      --root data/synth_cityscapes --num-images 12 --split train
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from upsnet_torch.evaluation import rle as rle_mod
from upsnet_torch.evaluation.panoptic_format import id_to_rgb

# active palette: category -> (shape, BGR color). Thing category ids are
# spread over 1..80 (not 1..8) so label-index mapping is exercised.
SHAPES = ("rect", "ellipse", "triangle")


def _thing_color(cat_idx: int) -> np.ndarray:
    rng = np.random.RandomState(1234 + cat_idx)
    c = rng.randint(70, 256, 3)
    c[cat_idx % 3] = 255  # keep categories well separated in color space
    return c.astype(np.uint8)


def _stuff_color(cat_idx: int) -> np.ndarray:
    rng = np.random.RandomState(777 + cat_idx)
    return rng.randint(15, 90, 3).astype(np.uint8)  # dark, distinct from things


def _draw_shape(mask: np.ndarray, shape: str, rng) -> None:
    """Draw one random instance of `shape` into the uint8 mask (in place)."""
    import cv2

    h, w = mask.shape
    bw = rng.randint(w // 8, w // 3)
    bh = rng.randint(h // 8, h // 3)
    x0 = rng.randint(0, max(w - bw, 1))
    y0 = rng.randint(0, max(h - bh, 1))
    if shape == "rect":
        cv2.rectangle(mask, (x0, y0), (x0 + bw, y0 + bh), 1, -1)
    elif shape == "ellipse":
        cv2.ellipse(mask, (x0 + bw // 2, y0 + bh // 2), (bw // 2, bh // 2),
                    int(rng.randint(0, 180)), 0, 360, 1, -1)
    else:  # triangle
        pts = np.array([[x0 + bw // 2, y0], [x0, y0 + bh], [x0 + bw, y0 + bh]])
        cv2.fillPoly(mask, [pts], 1)


def make_scene(rng, hw, thing_cats, stuff_cats, max_inst=8):
    """One scene. Returns (img BGR, seg_pan (H,W) segment ids starting at 1,
    segments: list of dicts {category_id, is_thing, mask (visible)})."""
    h, w = hw
    img = np.zeros((h, w, 3), np.uint8)
    pan_id = np.zeros((h, w), np.int32)
    segments = []

    # stuff: 3-5 horizontal bands with per-band texture noise
    n_bands = rng.randint(3, 6)
    edges = np.unique(np.concatenate(
        [[0, h], rng.randint(1, h, n_bands - 1)]))
    band_cats = rng.choice(stuff_cats, size=len(edges) - 1, replace=True)
    for bi in range(len(edges) - 1):
        y0, y1 = int(edges[bi]), int(edges[bi + 1])
        cat = int(band_cats[bi])
        base = _stuff_color(cat)
        noise = rng.randint(-12, 13, (y1 - y0, w, 3))
        img[y0:y1] = np.clip(base[None, None] + noise, 0, 255)
        sid = len(segments) + 1
        pan_id[y0:y1] = sid
        segments.append({"category_id": cat, "is_thing": False, "sid": sid})

    # things: painter's algorithm, later instances occlude earlier ones
    n_inst = rng.randint(2, max_inst + 1)
    thing_masks = []
    for _ in range(n_inst):
        cat = int(rng.choice(thing_cats))
        shape = SHAPES[cat % len(SHAPES)]
        m = np.zeros((h, w), np.uint8)
        _draw_shape(m, shape, rng)
        thing_masks.append((cat, m))

    for cat, m in thing_masks:
        color = _thing_color(cat)
        noise = rng.randint(-10, 11, (h, w, 3))
        paint = np.clip(color[None, None] + noise, 0, 255).astype(np.uint8)
        img[m > 0] = paint[m > 0]
        sid = len(segments) + 1
        pan_id[m > 0] = sid
        segments.append({"category_id": cat, "is_thing": True, "sid": sid})

    # visible masks after occlusion; drop fully-hidden instances
    kept = []
    for s in segments:
        vis = pan_id == s["sid"]
        if s["is_thing"] and vis.sum() < 64:
            pan_id[vis] = 0  # becomes VOID
            continue
        s["mask"] = vis
        kept.append(s)
    return img, pan_id, kept


# ---------------------------------------------------------------------------
# COCO layout
# ---------------------------------------------------------------------------

def gen_coco(root, image_set, num_images, seed=0, hw_base=(800, 1333),
             portrait_frac=0.25, active_things=8, active_stuff=6):
    import cv2

    img_dir = os.path.join(root, image_set)
    ann_dir = os.path.join(root, "annotations")
    pan_dir = os.path.join(ann_dir, f"panoptic_{image_set}")
    for d in (img_dir, ann_dir, pan_dir):
        os.makedirs(d, exist_ok=True)

    # full flagship category lists: things 1..80, stuff 92..144 (synthetic
    # names; ids deliberately non-contiguous across the two lists, like COCO)
    thing_categories = [
        {"id": i, "name": f"thing_{i:02d}", "supercategory": "thing",
         "isthing": 1} for i in range(1, 81)
    ]
    stuff_categories = [
        {"id": 91 + i, "name": f"stuff_{i:02d}", "supercategory": "stuff",
         "isthing": 0} for i in range(1, 54)
    ]
    # active palette spread over the id ranges
    thing_cats = [1 + 10 * k for k in range(active_things)]       # 1,11,..,71
    stuff_cats = [92 + 9 * k for k in range(active_stuff)]        # 92,101,...

    images, inst_anns, pan_anns = [], [], []
    ann_id = 1
    rng_master = np.random.RandomState(seed)
    for i in range(num_images):
        rng = np.random.RandomState(seed * 100003 + i)
        h = int(rng_master.randint(int(hw_base[0] * 0.8), hw_base[0] + 1))
        w = int(rng_master.randint(int(hw_base[1] * 0.8), hw_base[1] + 1))
        if rng_master.rand() < portrait_frac:
            h, w = w, h
        img, pan_id, segments = make_scene(rng, (h, w), thing_cats, stuff_cats)
        image_id = 1000 + i
        file_name = f"synth_{image_id:012d}.jpg"
        cv2.imwrite(os.path.join(img_dir, file_name), img)
        images.append({"id": image_id, "file_name": file_name,
                       "height": h, "width": w})

        segments_info = []
        for s in segments:
            m = s["mask"].astype(np.uint8)
            ys, xs = np.nonzero(m)
            x0, y0 = int(xs.min()), int(ys.min())
            bw_, bh_ = int(xs.max() - x0 + 1), int(ys.max() - y0 + 1)
            area = int(m.sum())
            segments_info.append({
                "id": s["sid"], "category_id": s["category_id"],
                "bbox": [x0, y0, bw_, bh_], "area": area, "iscrowd": 0,
            })
            if s["is_thing"]:
                r = rle_mod.encode(m)
                counts = r["counts"]
                if isinstance(counts, bytes):
                    counts = counts.decode("ascii")
                inst_anns.append({
                    "id": ann_id, "image_id": image_id,
                    "category_id": s["category_id"],
                    "bbox": [x0, y0, bw_, bh_], "area": area, "iscrowd": 0,
                    "segmentation": {"size": [h, w], "counts": counts},
                })
                ann_id += 1
        # occasional crowd region (exercises crowd-ignore target path)
        if rng.rand() < 0.15:
            cm = np.zeros((h, w), np.uint8)
            y0 = int(rng.randint(0, h // 2))
            cm[y0:y0 + h // 4, : w // 3] = 1
            r = rle_mod.encode(cm)
            counts = r["counts"]
            if isinstance(counts, bytes):
                counts = counts.decode("ascii")
            inst_anns.append({
                "id": ann_id, "image_id": image_id,
                "category_id": int(rng.choice(thing_cats)),
                "bbox": [0, y0, w // 3, h // 4], "area": int(cm.sum()),
                "iscrowd": 1,
                "segmentation": {"size": [h, w], "counts": counts},
            })
            ann_id += 1

        pan_png = f"synth_{image_id:012d}.png"
        cv2.imwrite(os.path.join(pan_dir, pan_png),
                    id_to_rgb(pan_id)[:, :, ::-1])  # write as BGR for cv2
        pan_anns.append({"image_id": image_id, "file_name": pan_png,
                         "segments_info": segments_info})

    with open(os.path.join(ann_dir, f"instances_{image_set}.json"), "w") as f:
        json.dump({"images": images, "annotations": inst_anns,
                   "categories": thing_categories}, f)
    with open(os.path.join(ann_dir, f"panoptic_{image_set}.json"), "w") as f:
        json.dump({"images": images, "annotations": pan_anns,
                   "categories": thing_categories + stuff_categories}, f)
    print(f"wrote {num_images} images to {root} ({image_set}); "
          f"{len(inst_anns)} instance anns")


# ---------------------------------------------------------------------------
# Cityscapes gtFine layout
# ---------------------------------------------------------------------------

# stuff labelIds used for bands (road, sidewalk, building, vegetation, sky)
CS_STUFF_LABELS = (7, 8, 11, 21, 23)
# thing labelIds (person, rider, car, truck, bus, train, motorcycle, bicycle)
CS_THING_LABELS = (24, 25, 26, 27, 28, 31, 32, 33)


def gen_cityscapes(root, split, num_images, seed=0, hw=(1024, 2048),
                   active_things=4):
    import cv2

    city = "synthcity"
    img_dir = os.path.join(root, "leftImg8bit", split, city)
    gt_dir = os.path.join(root, "gtFine", split, city)
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(gt_dir, exist_ok=True)

    thing_cats = list(CS_THING_LABELS[:active_things])
    h, w = hw
    for i in range(num_images):
        rng = np.random.RandomState(seed * 100003 + i)
        img, pan_id, segments = make_scene(
            rng, (h, w), thing_cats, list(CS_STUFF_LABELS), max_inst=6)
        label = np.zeros((h, w), np.uint8)
        inst = np.zeros((h, w), np.uint16)
        per_label_count: dict[int, int] = {}
        for s in segments:
            lid = s["category_id"]
            label[s["mask"]] = lid
            if s["is_thing"]:
                k = per_label_count.get(lid, 0)
                per_label_count[lid] = k + 1
                inst[s["mask"]] = lid * 1000 + k
            else:
                inst[s["mask"]] = lid
        stem = f"{city}_{i:06d}_000019"
        cv2.imwrite(os.path.join(img_dir, f"{stem}_leftImg8bit.png"), img)
        cv2.imwrite(os.path.join(gt_dir, f"{stem}_gtFine_labelIds.png"), label)
        cv2.imwrite(os.path.join(gt_dir, f"{stem}_gtFine_instanceIds.png"),
                    inst)
    print(f"wrote {num_images} images to {root} ({split}/{city}) at {h}x{w}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="layout", required=True)
    pc = sub.add_parser("coco")
    pc.add_argument("--root", default="data/synth_coco")
    pc.add_argument("--image-set", default="synthtrain")
    pc.add_argument("--num-images", type=int, default=200)
    pc.add_argument("--seed", type=int, default=0)
    ps = sub.add_parser("cityscapes")
    ps.add_argument("--root", default="data/synth_cityscapes")
    ps.add_argument("--split", default="train")
    ps.add_argument("--num-images", type=int, default=12)
    ps.add_argument("--height", type=int, default=1024)
    ps.add_argument("--width", type=int, default=2048)
    ps.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.layout == "coco":
        gen_coco(args.root, args.image_set, args.num_images, args.seed)
    else:
        gen_cityscapes(args.root, args.split, args.num_images, args.seed,
                       hw=(args.height, args.width))


if __name__ == "__main__":
    main()
