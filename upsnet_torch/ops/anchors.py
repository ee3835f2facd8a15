"""FPN anchor generation (numpy; the port's copy of ``upsnet_tpu/ops/anchors.py``).

One anchor scale per pyramid level (size = 8 * stride) x 3 aspect ratios,
Detectron ``generate_anchors`` with the legacy +1 width convention, laid out
row-major over (y, x, a) — the order the RPN outputs are flattened in.
"""

from __future__ import annotations

import numpy as np

FPN_STRIDES = (4, 8, 16, 32, 64)  # P2..P6


def generate_cell_anchors(
    stride: int,
    ratios=(0.5, 1.0, 2.0),
    scale: float = 8.0,
    offset: float = 1.0,
) -> np.ndarray:
    """Base anchors (A, 4) centered on the first cell, Detectron-style."""
    base = np.array([0, 0, stride - offset, stride - offset], dtype=np.float64)
    w = base[2] - base[0] + offset
    h = base[3] - base[1] + offset
    cx = base[0] + 0.5 * (w - offset)
    cy = base[1] + 0.5 * (h - offset)
    size = w * h
    anchors = []
    for r in ratios:
        ws = np.round(np.sqrt(size / r))
        hs = np.round(ws * r)
        ws, hs = ws * scale, hs * scale
        anchors.append(
            [
                cx - 0.5 * (ws - offset),
                cy - 0.5 * (hs - offset),
                cx + 0.5 * (ws - offset),
                cy + 0.5 * (hs - offset),
            ]
        )
    return np.array(anchors, dtype=np.float32)


def anchors_for_level(
    feat_h: int,
    feat_w: int,
    stride: int,
    ratios=(0.5, 1.0, 2.0),
    scale: float = 8.0,
    offset: float = 1.0,
) -> np.ndarray:
    """All anchors for one level, shape (H*W*A, 4), row-major over (y, x, a)."""
    cell = generate_cell_anchors(stride, ratios, scale, offset)
    shift_x = np.arange(feat_w, dtype=np.float32) * stride
    shift_y = np.arange(feat_h, dtype=np.float32) * stride
    sx, sy = np.meshgrid(shift_x, shift_y)
    shifts = np.stack([sx, sy, sx, sy], axis=-1).reshape(-1, 1, 4)
    return (shifts + cell[None, :, :]).reshape(-1, 4).astype(np.float32)


def pyramid_anchors(
    image_hw: tuple[int, int],
    strides=FPN_STRIDES,
    ratios=(0.5, 1.0, 2.0),
    scale: float = 8.0,
    offset: float = 1.0,
) -> list[np.ndarray]:
    """Anchors per level for an image padded to image_hw (each (N_l, 4))."""
    h, w = image_hw
    out = []
    for s in strides:
        fh, fw = -(-h // s), -(-w // s)  # ceil-div, matches conv output
        out.append(anchors_for_level(fh, fw, s, ratios, scale, offset))
    return out
