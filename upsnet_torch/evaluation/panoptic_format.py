"""COCO panoptic format: id <-> RGB PNG, segment JSON, stuff-area filter.

Reference behavior (SURVEY.md §3.4 steps 4-5): panoptic prediction encoded
as a PNG with id = R + G*256 + B*256^2 plus a segments_info JSON; stuff
segments smaller than ``panoptic_stuff_area_limit`` are relabeled VOID.
The port's copy of ``upsnet_tpu/evaluation/panoptic_format.py``.
"""

from __future__ import annotations

import numpy as np


def id_to_rgb(id_map: np.ndarray) -> np.ndarray:
    """(H, W) int32 -> (H, W, 3) uint8 with id = R + G*256 + B*256^2."""
    out = np.zeros(id_map.shape + (3,), np.uint8)
    out[..., 0] = id_map % 256
    out[..., 1] = (id_map // 256) % 256
    out[..., 2] = (id_map // (256 * 256)) % 256
    return out


def rgb_to_id(rgb: np.ndarray) -> np.ndarray:
    rgb = rgb.astype(np.int64)
    return rgb[..., 0] + 256 * rgb[..., 1] + 256 * 256 * rgb[..., 2]


def build_panoptic_output(
    pan_channel_map: np.ndarray,  # (H, W) channel indices from the device
    num_stuff: int,
    det_classes: np.ndarray,  # (D,) thing class ids (1-based detection labels)
    det_keep: np.ndarray,  # (D,) bool — instances present in the fusion
    stuff_area_limit: int,
    stuff_cat_ids,  # contiguous stuff channel -> dataset category id
    thing_cat_ids,  # 1-based det label -> dataset category id
) -> tuple[np.ndarray, list[dict]]:
    """Convert the device argmax channel map to (id_map, segments_info).

    Channels: [0, num_stuff) stuff classes, [num_stuff, num_stuff + D)
    instance slots, last = unknown -> VOID (id 0). Stuff segments below the
    area limit are relabeled VOID (reference behavior). Segment ids are
    assigned densely starting at 1.
    """
    h, w = pan_channel_map.shape
    d = det_classes.shape[0]
    unknown_ch = num_stuff + d
    id_map = np.zeros((h, w), np.int32)
    segments: list[dict] = []
    next_id = 1

    # instance segments (descending score order = channel order)
    for i in range(d):
        if not det_keep[i]:
            continue
        m = pan_channel_map == num_stuff + i
        area = int(m.sum())
        if area == 0:
            continue
        id_map[m] = next_id
        segments.append(
            {
                "id": next_id,
                "category_id": int(thing_cat_ids[int(det_classes[i])]),
                "area": area,
                "isthing": 1,
            }
        )
        next_id += 1

    # stuff segments (one per class), area-filtered
    for s in range(num_stuff):
        m = pan_channel_map == s
        area = int(m.sum())
        if area == 0:
            continue
        if area < stuff_area_limit:
            continue  # relabel VOID
        id_map[m] = next_id
        segments.append(
            {
                "id": next_id,
                "category_id": int(stuff_cat_ids[s]),
                "area": area,
                "isthing": 0,
            }
        )
        next_id += 1

    _ = unknown_ch  # unknown pixels stay VOID (id 0)
    return id_map, segments


# ---------------------------------------------------------------------------
# file artifacts (reference `evaluate_panoptic` output dir, SURVEY.md §3.2)
# ---------------------------------------------------------------------------


def write_panoptic_results(out_dir: str, pan_results: list) -> str:
    """Write COCO-panoptic-format artifacts: one id-encoded RGB PNG per
    image under ``out_dir/pred_pans/`` plus ``out_dir/pred.json`` with the
    annotations list — the directory layout the reference's
    ``evaluate_panoptic`` produces and panopticapi's pq_compute consumes.
    Returns the JSON path."""
    import json
    import os

    import cv2

    png_dir = os.path.join(out_dir, "pred_pans")
    os.makedirs(png_dir, exist_ok=True)
    annotations = []
    for p in pan_results:
        image_id = int(p["image_id"])
        file_name = f"{image_id:012d}.png"
        rgb = id_to_rgb(np.ascontiguousarray(p["id_map"]))
        cv2.imwrite(os.path.join(png_dir, file_name), rgb[:, :, ::-1])
        annotations.append(
            {
                "image_id": image_id,
                "file_name": file_name,
                "segments_info": [
                    {
                        "id": int(s["id"]),
                        "category_id": int(s["category_id"]),
                        "area": int(s.get("area", 0)),
                        "isthing": int(s.get("isthing", 0)),
                        "iscrowd": 0,
                    }
                    for s in p["segments"]
                ],
            }
        )
    json_path = os.path.join(out_dir, "pred.json")
    with open(json_path, "w") as f:
        json.dump({"annotations": annotations}, f)
    return json_path


def read_panoptic_results(json_path: str) -> list:
    """Inverse of write_panoptic_results: load the artifacts back into the
    in-memory pan_results structure — lets ``evaluate_panoptic`` consume a
    results *directory* (artifact-level diffability vs the reference)."""
    import json
    import os

    import cv2

    png_dir = os.path.join(os.path.dirname(json_path), "pred_pans")
    with open(json_path) as f:
        annotations = json.load(f)["annotations"]
    out = []
    for a in annotations:
        bgr = cv2.imread(os.path.join(png_dir, a["file_name"]),
                         cv2.IMREAD_COLOR)
        id_map = rgb_to_id(bgr[:, :, ::-1])
        out.append(
            {
                "image_id": a["image_id"],
                "id_map": id_map.astype(np.int32),
                "segments": a["segments_info"],
            }
        )
    return out
