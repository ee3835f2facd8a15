"""The one generator of the benchmark's traffic: synthetic scenes from a mix's
parameters and a seed.

A scene is the rectangles-over-stripes picture of the program's
``data/synthetic.py:scene`` (copied here, so that a change to the program
cannot move the yardstick): horizontal stuff bands, then axis-aligned
rectangles ("things") painted over them by class, so that boxes, masks and
the semantic map are exact. The copy draws from ``numpy.random.Generator``
(any seed up to 2**64) and takes the instance count's range from the mix.

A mix file (``traffic/<mix>.json``) says how requests look:

- ``batch``: images a request; ``bucket``: the canvas (H, W) they are
  padded to;
- ``short_side`` and ``long_side`` ([lo, hi]): each image's size inside the
  canvas, landscape, the long side drawn uniformly;
- ``instances`` ([lo, hi]): things a scene; ``texture``: the grain's
  amplitude in pixel values;
- ``pool``: distinct requests made in set-up, which the window cycles
  through in an order drawn from the seed.

A training mix gives ``buckets`` (canvases, one a batch in turn), ``fill``
([lo, hi], each side of an image as a share of its canvas), ``instances``
and ``pool`` (batches a canvas). Every seed gets the same multiset of image
sizes and instance counts, in another order: the fills are the pool's
evenly spaced quantiles of ``fill`` and the counts evenly spread over
``instances``, so the seed changes what the scenes show and which batch
holds which size, not how much work the pool holds.
"""

from __future__ import annotations

import numpy as np

PIXEL_MEANS_BGR = np.array([102.9801, 115.9465, 122.7717], np.float32)


def scene(rng: np.random.Generator, image_hw, num_things: int, num_stuff: int,
          instances=(1, 4), texture: int = 0):
    """One scene: uint8 image (H, W, 3) BGR, boxes (n, 4) float32 in the
    legacy +1 convention, classes (n,) in 1..num_things, masks (n, H, W)
    uint8 and the semantic map (H, W) int32, stuff channels first. With
    ``texture``, every pixel value moves by a uniform draw in +-texture, as a
    photograph's grain does: flat regions would give whole areas of equal
    scores, whose order any rounding decides."""
    h, w = image_hw
    img = np.zeros((h, w, 3), np.uint8)
    seg = np.zeros((h, w), np.int32)
    n_bands = min(num_stuff, 4)
    for b in range(n_bands):
        y0, y1 = h * b // n_bands, h * (b + 1) // n_bands
        img[y0:y1] = (40 * (b + 1)) % 200 + 20
        seg[y0:y1] = b % num_stuff
    n_inst = int(rng.integers(instances[0], instances[1] + 1))
    boxes, classes, masks = [], [], []
    for _ in range(n_inst):
        bw = int(rng.integers(max(w // 12, 2), max(w // 3, 3)))
        bh = int(rng.integers(max(h // 12, 2), max(h // 3, 3)))
        x1 = int(rng.integers(0, w - bw - 1))
        y1 = int(rng.integers(0, h - bh - 1))
        cls = int(rng.integers(1, num_things + 1))
        img[y1:y1 + bh, x1:x1 + bw] = np.array(
            [50 + 60 * (cls % 3), 80 + 50 * (cls % 4), 120 + 40 * (cls % 2)], np.uint8)
        m = np.zeros((h, w), np.uint8)
        m[y1:y1 + bh, x1:x1 + bw] = 1
        seg[y1:y1 + bh, x1:x1 + bw] = num_stuff + cls - 1
        boxes.append([x1, y1, x1 + bw - 1, y1 + bh - 1])
        classes.append(cls)
        masks.append(m)
    if texture:
        grain = rng.integers(-texture, texture + 1, size=img.shape, dtype=np.int16)
        img = np.clip(img.astype(np.int16) + grain, 0, 255).astype(np.uint8)
    return (img, np.array(boxes, np.float32).reshape(-1, 4), np.array(classes, np.int32),
            np.array(masks, np.uint8).reshape(-1, h, w), seg)


def image_size(rng: np.random.Generator, mix: dict) -> tuple[int, int]:
    """(h, w) inside the mix's canvas: the short side as given, the long
    side drawn from its range, landscape where the canvas is."""
    bh, bw = mix["bucket"]
    lo, hi = mix["long_side"]
    short, long = int(mix["short_side"]), int(rng.integers(lo, hi + 1))
    h, w = (short, long) if bw >= bh else (long, short)
    return min(h, bh), min(w, bw)


def make_requests(mix: dict, num_things: int, num_stuff: int, seed: int):
    """The mix's ``pool`` distinct requests of ``batch`` images each:
    (images (N, B, H, W, 3) float32 mean-subtracted BGR, zero beyond each
    image; im_hw (N, B, 2) float32), from ``seed``."""
    rng = np.random.default_rng([int(seed), 0x7072])
    bh, bw = mix["bucket"]
    n, b = int(mix["pool"]), int(mix["batch"])
    images = np.zeros((n, b, bh, bw, 3), np.float32)
    im_hw = np.zeros((n, b, 2), np.float32)
    for i in range(n):
        for j in range(b):
            h, w = image_size(rng, mix)
            img = scene(rng, (h, w), num_things, num_stuff, tuple(mix["instances"]),
                        int(mix.get("texture", 0)))[0]
            images[i, j, :h, :w] = img.astype(np.float32) - PIXEL_MEANS_BGR
            im_hw[i, j] = (h, w)
    return images, im_hw


def request_order(mix: dict, seed: int, n_requests: int) -> np.ndarray:
    """(n_requests,) indices into the pool: the pool in an order drawn from
    the seed, cycled, so every request of the pool is sent equally often."""
    rng = np.random.default_rng([int(seed), 0x6f72])
    n = int(mix["pool"])
    return np.concatenate([rng.permutation(n) for _ in range(-(-n_requests // n))])[:n_requests]


def make_train_batches(mix: dict, num_things: int, num_stuff: int, max_gt: int, seed: int):
    """The mix's ``pool`` distinct batches for each of its ``buckets``, in
    the layout of the program's ``forward_train`` batch: images (B, H, W, 3)
    float32 mean-subtracted BGR, zero beyond each image; im_hw (B, 2);
    gt_boxes (B, G, 4), gt_classes (B, G), gt_valid (B, G); gt_masks
    (B, G, H/4, W/4) uint8 and seg_gt (B, H/4, W/4) int32 (255 beyond the
    image), both sampled at every fourth pixel from the second; G =
    ``max_gt``. Each image fills a share of its canvas on each side, from
    the pool's quantiles of ``fill``. Returns {bucket: [batch, ...]} of
    numpy arrays."""
    rng = np.random.default_rng([int(seed), 0x7472])
    b, g = int(mix["batch"]), int(max_gt)
    lo, hi = mix["fill"]
    n_img = int(mix["pool"]) * b
    out = {}
    for bucket in mix["buckets"]:
        bh, bw = bucket
        qh, qw = bh // 4, bw // 4
        q = lo + (hi - lo) * (np.arange(n_img) + 0.5) / n_img
        pairs = np.stack([q, np.random.default_rng(0).permutation(q)], 1)[rng.permutation(n_img)]
        counts = rng.permutation(np.rint(np.linspace(*mix["instances"], n_img)).astype(int))
        batches = []
        for r in range(int(mix["pool"])):
            batch = {"images": np.zeros((b, bh, bw, 3), np.float32),
                     "im_hw": np.zeros((b, 2), np.float32),
                     "gt_boxes": np.zeros((b, g, 4), np.float32),
                     "gt_classes": np.zeros((b, g), np.int32),
                     "gt_valid": np.zeros((b, g), bool),
                     "gt_masks": np.zeros((b, g, qh, qw), np.uint8),
                     "seg_gt": np.full((b, qh, qw), 255, np.int32)}
            for i in range(b):
                fh, fw = pairs[r * b + i]
                h = int(bh * fh) // 4 * 4
                w = int(bw * fw) // 4 * 4
                n = int(counts[r * b + i])
                img, boxes, classes, masks, seg = scene(
                    rng, (h, w), num_things, num_stuff, (n, n), int(mix.get("texture", 0)))
                n = min(len(boxes), g)
                batch["images"][i, :h, :w] = img.astype(np.float32) - PIXEL_MEANS_BGR
                batch["im_hw"][i] = (h, w)
                batch["gt_boxes"][i, :n] = boxes[:n]
                batch["gt_classes"][i, :n] = classes[:n]
                batch["gt_valid"][i, :n] = True
                mq = masks[:n, 2::4, 2::4]
                batch["gt_masks"][i, :n, :mq.shape[1], :mq.shape[2]] = mq
                sq = seg[2::4, 2::4]
                batch["seg_gt"][i, :sq.shape[0], :sq.shape[1]] = sq
            batches.append(batch)
        out[tuple(bucket)] = batches
    return out
