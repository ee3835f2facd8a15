"""ROIAlign sampling semantics shared by the FPN ROIAlign kernel and its
plain version (``ops/roi_align_fpn.py``).

Port of the coordinate helpers of ``upsnet_tpu/ops/roi_align.py``. The
Detectron-lineage convention of the reference (pre ``aligned=True``): no
half-pixel shift; ``roi_w = max(x2 - x1, 1)`` after scaling; each of the
P x P bins averages ``sampling_ratio**2`` bilinear samples at uniform
sub-bin centers; samples outside [-1, H] x [-1, W] contribute zero;
coordinates clamp below at 0 and snap to the last row/column at
``size - 1``. The JAX entry ``fpn_roi_align_batched`` has its counterpart
in ``roi_align_fpn.fpn_roi_align``.
"""

from __future__ import annotations

import torch

from upsnet_torch.utils.profiling import host_sync


def _bilinear_corners(y, x, height, width):
    """Corner indices + weights with Detectron clamping.

    y, x: f32 sample coords; height/width: scalars or tensors broadcasting
    against them. Returns (y_low, x_low, y_high, x_high, w_ll, w_lh, w_hl,
    w_hh) with int64 indices and f32 weights (zero for outside samples).
    """
    inside = (y >= -1.0) & (y <= height) & (x >= -1.0) & (x <= width)
    y = y.clamp(min=0.0)
    x = x.clamp(min=0.0)
    y_low = torch.floor(y)
    x_low = torch.floor(x)
    hm1 = torch.as_tensor(height, dtype=y.dtype, device=y.device) - 1
    wm1 = torch.as_tensor(width, dtype=x.dtype, device=x.device) - 1
    y_snap = y_low >= hm1
    x_snap = x_low >= wm1
    y_low = torch.where(y_snap, hm1, y_low)
    x_low = torch.where(x_snap, wm1, x_low)
    y = torch.where(y_snap, y_low, y)
    x = torch.where(x_snap, x_low, x)
    y_high = torch.where(y_snap, y_low, y_low + 1)
    x_high = torch.where(x_snap, x_low, x_low + 1)
    ly = y - y_low
    lx = x - x_low
    hy = 1.0 - ly
    hx = 1.0 - lx
    zero = torch.zeros_like(ly)
    return (
        y_low.to(torch.int64), x_low.to(torch.int64),
        y_high.to(torch.int64), x_high.to(torch.int64),
        torch.where(inside, hy * hx, zero),
        torch.where(inside, hy * lx, zero),
        torch.where(inside, ly * hx, zero),
        torch.where(inside, ly * lx, zero),
    )


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c with one rounding to float32 (the float64 product of two
    float32 values is exact)."""
    return (a.double() * b.double() + c.double()).float()


def _sample_coords(rois: torch.Tensor, spatial_scale: float, pooled: int,
                   sampling_ratio: int):
    """Sample-point coordinates (N, P, P, S, S) in feature-map space for
    rois (N, 4) in image coordinates.

    ``y1 + (p + (i + 0.5) / S) * (roi_h / P)`` rounded the way XLA compiles
    the JAX expression: the bin size as the extent times the float32
    reciprocal of P, then one fused multiply-add. The CUDA kernel does the
    same, so its samples sit where the JAX package's do, to the bit.
    """
    s = sampling_ratio
    roi_x1 = rois[:, 0] * spatial_scale
    roi_y1 = rois[:, 1] * spatial_scale
    roi_x2 = rois[:, 2] * spatial_scale
    roi_y2 = rois[:, 3] * spatial_scale
    roi_w = (roi_x2 - roi_x1).clamp(min=1.0)
    roi_h = (roi_y2 - roi_y1).clamp(min=1.0)
    with host_sync("const_h2d"):
        inv_p = torch.tensor(1.0 / pooled, dtype=rois.dtype, device=rois.device)
    bin_w = roi_w * inv_p
    bin_h = roi_h * inv_p
    ph = torch.arange(pooled, dtype=rois.dtype, device=rois.device)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar multiplies
    # by its reciprocal, which rounds otherwise at s = 3
    iy = torch.arange(s, dtype=rois.dtype, device=rois.device) + 0.5
    with host_sync("const_h2d"):
        s_t = torch.tensor(float(s), dtype=rois.dtype, device=rois.device)
    iy = iy / s_t
    frac = ph[None, :, None] + iy[None, None, :]  # (1, P, S)
    ys = _fma(frac, bin_h[:, None, None], roi_y1[:, None, None])  # (N, P, S)
    xs = _fma(frac, bin_w[:, None, None], roi_x1[:, None, None])
    n = rois.shape[0]
    y = ys[:, :, None, :, None].expand(n, pooled, pooled, s, s)
    x = xs[:, None, :, None, :].expand(n, pooled, pooled, s, s)
    return y, x
