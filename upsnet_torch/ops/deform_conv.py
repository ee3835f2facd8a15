"""Deformable convolution (DCNv1), project-then-sample.

Port of the inference forward of ``upsnet_tpu/ops/deform_conv.py`` and of
``deform_conv_pallas.py:_fused_untiled``:

    y(p) = sum_k W_k . x(p + p_k * dilation + dp_k(p))
         = sum_k (x @ W_k)(p + p_k * dilation + dp_k(p))

Bilinear interpolation is linear, so each tap's weight is applied first (one
plain matmul per tap into a tap-major stack) and the K1 kernel
(``ops/deform_sample.py``) samples and sums the projections.

Offsets are ``(..., 2K)`` ordered ``(dy_0, dx_0, dy_1, dx_1, ...)`` over the
row-major taps, as in the reference. Routing on the card has no window:

  * ``auto`` / ``gather``: exact sampling at the offsets as given;
  * ``pallas`` / ``mxu``: dy clamped to +-max_dy first (the JAX windowed
    routes' forward), dx unrestricted, then the same kernel.

Any odd kernel size works; stride is 1 (the caffe ResNet keeps every 3x3
at stride 1).
"""

from __future__ import annotations

import torch

from upsnet_torch.ops.deform_sample import deform_sample9

CLIPPED_IMPLS = ("pallas", "mxu")
EXACT_IMPLS = ("auto", "gather")


def clip_offsets(v: torch.Tensor, bound: float) -> torch.Tensor:
    """The inference forward of every ``boundary_grad`` mode of the JAX
    ``clip_offsets`` with ``'clip'``: a clamp to [-bound, bound]."""
    return v.clamp(-bound, bound)


def sample_coords(offsets: torch.Tensor, kernel_size: int, dilation: int,
                  max_dy: int | None = None):
    """Per-tap absolute f32 sample coordinates.

    offsets (B, H, W, 2K) -> sy9, sx9 (K, B, H, W); dy clamped to +-max_dy
    when max_dy is given.
    """
    b, h, w, _ = offsets.shape
    k = kernel_size * kernel_size
    half = (kernel_size - 1) // 2
    off = offsets.float()
    off_y = off[..., 0::2].permute(3, 0, 1, 2)
    off_x = off[..., 1::2].permute(3, 0, 1, 2)
    if max_dy is not None:
        off_y = clip_offsets(off_y, float(max_dy))
    dev = offsets.device
    iy = torch.arange(h, dtype=torch.float32, device=dev)[None, None, :, None]
    ix = torch.arange(w, dtype=torch.float32, device=dev)[None, None, None, :]
    taps = torch.arange(k, device=dev)
    ky = ((taps // kernel_size - half) * dilation).float()[:, None, None, None]
    kx = ((taps % kernel_size - half) * dilation).float()[:, None, None, None]
    sy9 = (iy + ky + off_y).contiguous()
    sx9 = (ix + kx + off_x).contiguous()
    return sy9, sx9


def tap_projections(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, Cin) @ each tap's weight (K, Cin, Cout) -> the tap-major
    stack (K, B, H, W, Cout) in x.dtype: one batched matmul whose batch is
    the tap, so no transpose follows it."""
    b, h, w, cin = x.shape
    k, _, cout = weight.shape
    x2 = x.reshape(1, b * h * w, cin)
    return torch.matmul(x2, weight.to(x.dtype)).view(k, b, h, w, cout)


def deform_conv2d(x: torch.Tensor, offsets: torch.Tensor, weight: torch.Tensor,
                  bias: torch.Tensor | None = None, kernel_size: int = 3,
                  dilation: int = 1, impl: str = "auto",
                  max_dy: int = 6) -> torch.Tensor:
    """Deformable 2-D convolution, stride 1, SAME padding.

    x (B, H, W, Cin); offsets (B, H, W, 2K); weight (K, Cin, Cout) tap-major;
    bias (Cout,). Returns (B, H, W, Cout) in x.dtype.
    """
    if impl in CLIPPED_IMPLS:
        clip = max_dy
    elif impl in EXACT_IMPLS:
        clip = None
    else:
        raise NotImplementedError(f"dcn_impl {impl!r} is not ported")
    if kernel_size % 2 != 1:
        raise ValueError(f"kernel_size must be odd, got {kernel_size}")
    y9 = tap_projections(x, weight)
    sy9, sx9 = sample_coords(offsets, kernel_size, dilation, clip)
    out = deform_sample9(y9, sy9, sx9)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out
