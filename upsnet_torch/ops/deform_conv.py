"""Deformable convolution (DCNv1), project-then-sample.

Port of ``upsnet_tpu/ops/deform_conv.py`` and of the two untiled forms of
``deform_conv_pallas.py``: ``_fused_untiled`` (inference) and
``_pertap_untiled`` (training), chosen as ``_untiled_dispatch`` chooses:

    y(p) = sum_k W_k . x(p + p_k * dilation + dp_k(p))
         = sum_k (x @ W_k)(p + p_k * dilation + dp_k(p))

Bilinear interpolation is linear, so each tap's weight is applied first (one
plain matmul per tap into a tap-major stack). Without gradients the K1
kernel (``ops/deform_sample.py``) samples and sums the projections in one
launch. When gradients are recorded, each tap goes through ``DeformSample``
(forward K2, backward K3) and the taps are added in ``x.dtype`` in tap
order, which in bf16 is what the JAX package's training does.

``deform_conv2d_shift`` is the port of ``deform_shift_pallas.py:
deform_conv2d_pallas_shift``: one matmul gives all taps side by side, and
``DeformSampleShift`` samples them in one launch (K8a) also when gradients
are recorded (backward K8b + K8c), with the taps added in f32.

Offsets are ``(..., 2K)`` ordered ``(dy_0, dx_0, dy_1, dx_1, ...)`` over the
row-major taps, as in the reference. Routing on the card has no window:

  * ``auto`` / ``gather``: exact sampling at the offsets as given;
  * ``pallas`` / ``mxu``: dy clipped to +-max_dy first by ``clip_offsets``
    (the JAX windowed routes), dx unrestricted, then the same kernels;
  * ``shift``: where ``shift_route_ok`` says the JAX package on a TPU takes
    its shift kernel, ``deform_conv2d_shift`` (dy and dx both clipped to
    +-max_dy); elsewhere the ``pallas`` route, as ``DeformConv`` falls back
    in JAX. Each layer so computes what the JAX package computes for it.

Any odd kernel size works; stride is 1 (the caffe ResNet keeps every 3x3
at stride 1).
"""

from __future__ import annotations

import torch

from upsnet_torch.ops.deform_sample import DeformSample, deform_sample9
from upsnet_torch.ops.deform_shift import DeformSampleShift, shift_route_ok

CLIPPED_IMPLS = ("pallas", "mxu")
EXACT_IMPLS = ("auto", "gather")


BOUNDARY_GRADS = ("clip", "damped", "straight_through")


class _DampedClip(torch.autograd.Function):
    """Clip to +-(bound - 1e-3) with a one-sided backward: inside the window
    the gradient passes; outside it passes only where a descent step would
    move the value back toward the window (g has the sign of v)."""

    @staticmethod
    def forward(ctx, v, bound: float):
        ctx.save_for_backward(v)
        ctx.bound = bound
        return v.clamp(-(bound - 1e-3), bound - 1e-3)

    @staticmethod
    def backward(ctx, g):
        (v,) = ctx.saved_tensors
        keep = (v.abs() < ctx.bound - 1e-3) | (g * torch.sign(v) > 0)
        return torch.where(keep, g, torch.zeros_like(g)), None


def clip_offsets(v: torch.Tensor, bound: float,
                 boundary_grad: str = "clip") -> torch.Tensor:
    """Clip offsets into the reachable window (the JAX ``clip_offsets``).

    ``clip``: a clamp to [-bound, bound] with its true gradient, zero beyond
    the window. ``damped``: clamp to +-(bound - 1e-3); beyond the window the
    gradient passes only when it points back inside. ``straight_through``:
    the same clamp with the full gradient passed through. The two latter
    stop 1e-3 short of the bound because a sample exactly on a grid row has
    a zero coordinate derivative.
    """
    if boundary_grad == "clip":
        return v.clamp(-bound, bound)
    if boundary_grad == "damped":
        return _DampedClip.apply(v, float(bound))
    if boundary_grad == "straight_through":
        c = v.clamp(-(bound - 1e-3), bound - 1e-3)
        return v + (c - v).detach()
    raise ValueError(f"boundary_grad {boundary_grad!r} not in {BOUNDARY_GRADS}")


def sample_coords(offsets: torch.Tensor, kernel_size: int, dilation: int,
                  max_dy: int | None = None, boundary_grad: str = "clip",
                  max_dx: int | None = None):
    """Per-tap absolute f32 sample coordinates.

    offsets (B, H, W, 2K) -> sy9, sx9 (K, B, H, W); dy clipped to +-max_dy
    and dx to +-max_dx by ``clip_offsets`` where the bound is given.
    """
    b, h, w, _ = offsets.shape
    k = kernel_size * kernel_size
    half = (kernel_size - 1) // 2
    off = offsets.float()
    off_y = off[..., 0::2].permute(3, 0, 1, 2)
    off_x = off[..., 1::2].permute(3, 0, 1, 2)
    if max_dy is not None:
        off_y = clip_offsets(off_y, float(max_dy), boundary_grad)
    if max_dx is not None:
        off_x = clip_offsets(off_x, float(max_dx), boundary_grad)
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


def deform_conv2d_shift(x: torch.Tensor, offsets: torch.Tensor, weight: torch.Tensor,
                        bias: torch.Tensor | None = None, kernel_size: int = 3,
                        dilation: int = 1, max_dy: int = 6, max_dx: int = 6,
                        boundary_grad: str = "clip") -> torch.Tensor:
    """Deformable conv through one projection matmul and the fused K-tap
    sampler (``ops/deform_shift.py``), the JAX ``deform_conv2d_pallas_shift``.

    Arguments as ``deform_conv2d``. Exact for |dy| <= max_dy and
    |dx| <= max_dx; offsets beyond are clipped to the window edge by
    ``clip_offsets`` with ``boundary_grad`` on both axes. Differentiable in
    x, offsets, weight and bias, with the fused forward also under autograd.
    """
    if kernel_size % 2 != 1:
        raise ValueError(f"kernel_size must be odd, got {kernel_size}")
    b, h, w, cin = x.shape
    k, _, cout = weight.shape
    # one matmul -> (B, H, W, K*Cout), tap t in channels t*Cout..(t+1)*Cout
    wk = weight.permute(1, 0, 2).reshape(cin, k * cout).to(x.dtype)
    y = torch.matmul(x.reshape(-1, cin), wk).view(b, h, w, k * cout)
    sy, sx = sample_coords(offsets, kernel_size, dilation, max_dy, boundary_grad, max_dx)
    half = (kernel_size - 1) // 2
    out = DeformSampleShift.apply(y, sy, sx, max_dy + half * dilation,
                                  max_dx + half * dilation)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def deform_conv2d(x: torch.Tensor, offsets: torch.Tensor, weight: torch.Tensor,
                  bias: torch.Tensor | None = None, kernel_size: int = 3,
                  dilation: int = 1, impl: str = "auto", max_dy: int = 6,
                  boundary_grad: str = "clip") -> torch.Tensor:
    """Deformable 2-D convolution, stride 1, SAME padding.

    x (B, H, W, Cin); offsets (B, H, W, 2K); weight (K, Cin, Cout) tap-major;
    bias (Cout,). Returns (B, H, W, Cout) in x.dtype. Differentiable in x,
    offsets, weight and bias; ``boundary_grad`` is the gradient of the
    offset clip of the windowed impls.
    """
    if impl == "shift" and shift_route_ok(x.shape, weight.shape[-1], max_dy, max_dy,
                                          dilation, weight.shape[0]):
        return deform_conv2d_shift(x, offsets, weight, bias, kernel_size, dilation,
                                   max_dy, max_dy, boundary_grad)
    if impl in CLIPPED_IMPLS or impl == "shift":  # a layer shift does not take runs as pallas
        clip = max_dy
    elif impl in EXACT_IMPLS:
        clip = None
    else:
        raise NotImplementedError(f"dcn_impl {impl!r} is not ported")
    if kernel_size % 2 != 1:
        raise ValueError(f"kernel_size must be odd, got {kernel_size}")
    y9 = tap_projections(x, weight)
    sy9, sx9 = sample_coords(offsets, kernel_size, dilation, clip, boundary_grad)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, offsets, weight)):
        out = None
        for y, sy, sx in zip(y9.unbind(0), sy9.unbind(0), sx9.unbind(0)):
            tap = DeformSample.apply(y, sy, sx)
            out = tap if out is None else out + tap
    else:
        out = deform_sample9(y9, sy9, sx9)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out
