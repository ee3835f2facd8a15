"""Deformable convolution (DCNv1), project-then-sample and sample-first.

Port of ``upsnet_tpu/ops/deform_conv.py`` and of the forms of
``deform_conv_pallas.py`` and ``deform_shift_pallas.py``:

    y(p) = sum_k W_k . x(p + p_k * dilation + dp_k(p))
         = sum_k (x @ W_k)(p + p_k * dilation + dp_k(p))

Bilinear interpolation is linear, so the project-first forms apply each
tap's weight first and sample the projections:

  * untiled (``_fused_untiled`` / ``_pertap_untiled``, chosen as
    ``_untiled_dispatch`` chooses): one matmul per tap into a tap-major
    stack. Without gradients K1 (``ops/deform_sample.py``) samples and sums
    the projections in one launch, in f32. When gradients are recorded one
    ``DeformSampleTaps`` samples all taps in one launch of the all-tap K2,
    which rounds each tap and adds it in ``x.dtype`` in tap order, as the
    JAX package's training does; its backward is the all-tap K3 (two
    launches per layer): the row-band
    form where dy is clipped, the unclipped form where it is not (``auto``,
    ``gather``).
  * tiled (``_deform_conv2d_tiled``, after ``_deform_conv2d_pallas_tiled``):
    one matmul gives all taps side by side, dy **and dx** are clipped, and
    ``DeformSampleTiled`` samples all taps in one launch (the all-tap K6,
    backward the all-tap K3) and adds them in ``x.dtype`` in tap order, with
    or without gradients: the JAX package has no fused tiled forward.
  * shift (``deform_conv2d_shift``, after ``deform_conv2d_pallas_shift``):
    the same one matmul and clips, and ``DeformSampleShift`` samples all taps
    in one launch (K8a) also when gradients are recorded (backward K8b +
    K8c), with the taps added in f32.

``deform_conv2d_mt`` (after ``deform_conv2d_pallas_mt``) samples first:
``DeformSampleMT`` (K7a, backward K7b) gathers the input at all taps and one
GEMM applies the weights. No configuration value reaches it, as in the JAX
package; ``tools/bench_deform_impls.py`` drives it.

Offsets are ``(..., 2K)`` ordered ``(dy_0, dx_0, dy_1, dx_1, ...)`` over the
row-major taps, as in the reference. The card's kernels read any address,
but each layer computes what the JAX package computes for it on a TPU, so
``deform_conv2d`` routes by the TPU's rules as arithmetic:

  * ``auto`` / ``gather``: exact sampling at the offsets as given (untiled
    kernels, no clip);
  * ``pallas`` / ``mxu``: where ``pallas_route`` answers ``untiled`` or
    ``mxu``, dy clipped to +-max_dy by ``clip_offsets``, dx unrestricted,
    untiled kernels; where ``pallas`` gets ``tiled`` (a map too wide for the
    TPU's untiled kernel, such as 208 x 800 at 128 channels), the tiled form
    with dx clipped to +-max_dy as well;
  * ``shift``: where ``shift_route_ok`` says the JAX package takes its shift
    kernel, ``deform_conv2d_shift``; elsewhere the ``pallas`` route, as
    ``DeformConv`` falls back in JAX.

Any odd kernel size works; stride is 1 (the caffe ResNet keeps every 3x3
at stride 1).
"""

from __future__ import annotations

import torch

from upsnet_torch.ops.deform_sample import (
    DeformSampleTaps, DeformSampleTiled, deform_sample9, pallas_route)
from upsnet_torch.ops.deform_sample_mt import DeformSampleMT
from upsnet_torch.ops.deform_shift import DeformSampleShift, shift_route_ok

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


def side_by_side_projections(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, Cin) @ all taps' weights (K, Cin, Cout) in one matmul ->
    (B, H, W, K, Cout) in x.dtype, tap t in ``[..., t, :]``."""
    b, h, w, cin = x.shape
    k, _, cout = weight.shape
    wk = weight.permute(1, 0, 2).reshape(cin, k * cout).to(x.dtype)
    return torch.matmul(x.reshape(-1, cin), wk).view(b, h, w, k, cout)


def _deform_conv2d_tiled(x: torch.Tensor, offsets: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor | None, kernel_size: int, dilation: int,
                         max_dy: int, max_dx: int, boundary_grad: str = "clip") -> torch.Tensor:
    """The column-tiled form of the ``pallas`` route (the JAX
    ``_deform_conv2d_pallas_tiled``): one projection matmul, dy clipped to
    +-max_dy and dx to +-max_dx by ``clip_offsets`` with ``boundary_grad``,
    the K taps sampled and added in ``x.dtype`` in tap order (also
    without gradients), bias last. Arguments as ``deform_conv2d``."""
    y = side_by_side_projections(x, weight)
    sy, sx = sample_coords(offsets, kernel_size, dilation, max_dy, boundary_grad, max_dx)
    half = (kernel_size - 1) // 2
    out = DeformSampleTiled.apply(y, sy, sx, max_dy + half * dilation,
                                  max_dx + half * dilation)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def deform_conv2d_mt(x: torch.Tensor, offsets: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor | None = None, kernel_size: int = 3,
                     dilation: int = 1, max_dy: int = 6) -> torch.Tensor:
    """Deformable conv, sample-first (the JAX ``deform_conv2d_pallas_mt``):
    one multi-tap sampling of the input itself (``DeformSampleMT``), then one
    (B*H*W, K*Cin) x (K*Cin, Cout) matmul rounded to ``x.dtype``, then bias.

    Arguments as ``deform_conv2d``. dy is clamped to +-max_dy (a plain clamp
    with its true gradient: this form has no ``boundary_grad``), dx is
    unrestricted; any H and W. Differentiable in x, offsets, weight and bias.
    """
    if kernel_size % 2 != 1:
        raise ValueError(f"kernel_size must be odd, got {kernel_size}")
    b, h, w, cin = x.shape
    k, _, cout = weight.shape
    sy, sx = sample_coords(offsets, kernel_size, dilation, max_dy, "clip")
    cols = DeformSampleMT.apply(x.contiguous(), sy, sx)  # (B, H, W, K, Cin)
    out = torch.matmul(cols.reshape(b * h * w, k * cin),
                       weight.reshape(k * cin, cout).to(x.dtype)).view(b, h, w, cout)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


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
    y = side_by_side_projections(x, weight).flatten(3)  # (B, H, W, K*Cout)
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
    if kernel_size % 2 != 1:
        raise ValueError(f"kernel_size must be odd, got {kernel_size}")
    if impl in ("pallas", "shift"):  # a layer shift does not take runs as pallas
        route, max_dx = pallas_route(x.shape, weight.shape[-1], max_dy, dilation)
        if route == "tiled":
            return _deform_conv2d_tiled(x, offsets, weight, bias, kernel_size, dilation,
                                        max_dy, max_dx, boundary_grad)
        clip = max_dy
    elif impl == "mxu":
        clip = max_dy
    elif impl in EXACT_IMPLS:
        clip = None
    else:
        raise NotImplementedError(f"dcn_impl {impl!r} is not ported")
    y9 = tap_projections(x, weight)
    sy9, sx9 = sample_coords(offsets, kernel_size, dilation, clip, boundary_grad)
    if not (torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, offsets, weight))):
        out = deform_sample9(y9, sy9, sx9)
    else:
        reach = None if clip is None else clip + (kernel_size - 1) // 2 * dilation
        out = DeformSampleTaps.apply(y9, sy9, sx9, reach)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out
