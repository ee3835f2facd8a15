"""Paste per-RoI masks into full canvases as two hat-matrix matmuls.

Port of ``upsnet_tpu/ops/mask_paste.py``: each canvas pixel center maps
into the M x M mask grid with ``align_corners=False`` semantics and samples
bilinearly, zero outside the box; separable, so ``out = Ry @ mask @ Rx^T``.
The matmuls run in full float32 (the JAX code asks for HIGHEST precision),
so TF32 must be off on the card (``models.upsnet.build_model`` turns it
off).
"""

from __future__ import annotations

import torch


def _hat_matrix(lo, hi, span, size: int, m: int, start: int = 0) -> torch.Tensor:
    """(N, size, m) 1-D bilinear weights for one axis of N boxes, at pixels
    ``start .. start + size - 1``.

    lo, hi, span: (N,). Pixel p maps to ``(p - lo + 0.5) / span * m - 0.5``
    clipped to [0, m-1]; weight against node j is ``max(0, 1 - |c - j|)``,
    zero outside the box's pixel window [floor(lo), ceil(hi)].
    """
    dt, dev = lo.dtype, lo.device
    ps = torch.arange(start, start + size, dtype=dt, device=dev)[None, :]
    c = ((ps - lo[:, None] + 0.5) / span[:, None] * m - 0.5).clamp(0.0, m - 1.0)
    j = torch.arange(m, dtype=dt, device=dev)
    wgt = (1.0 - (c[..., None] - j).abs()).clamp(min=0.0)
    inside = (ps >= torch.floor(lo)[:, None]) & (ps <= torch.ceil(hi)[:, None])
    return wgt * inside[..., None]


def paste_masks(masks: torch.Tensor, boxes: torch.Tensor, out_hw,
                offset: float = 1.0, row0: int = 0) -> torch.Tensor:
    """(N, M, M) masks + (N, 4) canvas-coordinate boxes -> (N, H, W): the
    canvas rows ``row0 .. row0 + H - 1`` (a row slab of a taller canvas,
    each row computed as the whole canvas computes it)."""
    m = masks.shape[-1]
    h, w = out_hw
    bw = (boxes[:, 2] - boxes[:, 0] + offset).clamp(min=1.0)
    bh = (boxes[:, 3] - boxes[:, 1] + offset).clamp(min=1.0)
    ry = _hat_matrix(boxes[:, 1], boxes[:, 3], bh, h, m, row0)  # (N, H, M)
    rx = _hat_matrix(boxes[:, 0], boxes[:, 2], bw, w, m)  # (N, W, M)
    return torch.matmul(torch.matmul(ry, masks), rx.transpose(1, 2))
