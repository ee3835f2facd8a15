"""Semantic segmentation (FCN) head with deformable convolutions.

Port of ``upsnet_tpu/models/fcn.py``: P2..P5 each pass through one shared
subnet of stacked 3x3 deformable convs; every level is bilinearly upsampled
to P2's resolution, concatenated, and a 1x1 conv gives the semantic logits
(stuff channels first). NCHW.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from upsnet_torch.models.layers import Conv2d, DeformConv

_WEIGHT_MATS: dict = {}


def _weight_mat_np(n_in: int, n_out: int) -> np.ndarray:
    """The (n_in, n_out) float32 interpolation matrix of
    ``jax.image.resize(method='bilinear')`` along one axis, as
    ``jax/_src/image/scale.py:compute_weight_mat`` builds it: the triangle
    kernel at half-pixel sample points, widened by the scale when
    downsampling (antialias), each column divided by its sum, columns whose
    sample lies outside the input zeroed."""
    f32 = np.float32
    inv_scale = f32(1.0) / f32(n_out / n_in)
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > f32(1000.0 * np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= f32(n_in) - f32(0.5))
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def _weight_mat(n_in: int, n_out: int, device) -> torch.Tensor:
    """``_weight_mat_np`` as a float32 tensor on ``device``, built once per
    (n_in, n_out, device)."""
    key = (n_in, n_out, torch.device(device))
    mat = _WEIGHT_MATS.get(key)
    if mat is None:
        mat = torch.from_numpy(_weight_mat_np(n_in, n_out)).to(device)
        _WEIGHT_MATS[key] = mat
    return mat


class _SeparableResize(torch.autograd.Function):
    """y = Wh^T x Ww over the last two axes in float32; the gradient to x is
    Wh g Ww^T. Both passes run with TF32 off, whatever the caller's setting;
    a None matrix is the identity (that axis keeps its size)."""

    @staticmethod
    def forward(ctx, x, wh, ww):
        ctx.save_for_backward(wh, ww)
        ctx.dtype = x.dtype
        return _contract(x, _t(wh), ww)

    @staticmethod
    def backward(ctx, g):
        wh, ww = ctx.saved_tensors
        return _contract(g, wh, _t(ww)).to(ctx.dtype), None, None


def _t(mat):
    return None if mat is None else mat.t()


def _contract(x, left, right):
    """``left @ x @ right`` in float32 (H first, then W), TF32 off; a None
    side is the identity."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        y = x.float()
        if left is not None:
            y = torch.matmul(left, y)
        if right is not None:
            y = torch.matmul(y, right)
        return y
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def resize_bilinear(x: torch.Tensor, out_hw) -> torch.Tensor:
    """(B, C, H, W) bilinear resize with half-pixel centers, computed as
    ``jax.image.resize(method='bilinear')`` computes it: float32
    contractions against per-axis weight matrices (``_weight_mat``), H
    first, then W, with TF32 off (JAX contracts at ``Precision.HIGHEST``).
    The result has x's dtype. Its backward is two matmuls, which sum in a
    fixed order, so the gradient has the same bits on every run
    (``F.interpolate``'s CUDA backward adds with float atomics)."""
    (h, w), (oh, ow) = x.shape[2:], tuple(out_hw)
    wh = _weight_mat(h, oh, x.device) if oh != h else None
    ww = _weight_mat(w, ow, x.device) if ow != w else None
    if wh is None and ww is None:
        return x
    return _SeparableResize.apply(x, wh, ww).to(x.dtype)


class FCNSubNet(nn.Module):
    def __init__(self, in_channels: int, channels: int = 128,
                 num_layers: int = 2, with_dcn: bool = True,
                 dcn_impl: str = "auto", dcn_max_dy: int = 6,
                 dtype=torch.float32, dcn_boundary_grad: str = "clip",
                 dcn_impl_train: str = ""):
        super().__init__()
        self.layer_names = []
        cin = in_channels
        for i in range(num_layers):
            if with_dcn:
                name = f"dcn{i + 1}"
                layer = DeformConv(cin, channels, 3, dtype=dtype, impl=dcn_impl,
                                   max_dy=dcn_max_dy,
                                   boundary_grad=dcn_boundary_grad,
                                   impl_train=dcn_impl_train)
            else:
                name = f"conv{i + 1}"
                layer = Conv2d(cin, channels, 3, bias=True, dtype=dtype)
            self.add_module(name, layer)
            self.layer_names.append(name)
            cin = channels

    def forward(self, x):
        for name in self.layer_names:
            x = torch.relu(getattr(self, name)(x))
        return x


class FCNHead(nn.Module):
    def __init__(self, num_classes: int, in_channels: int = 256,
                 channels: int = 128, num_layers: int = 2,
                 with_dcn: bool = True, shared_subnet: bool = True,
                 dcn_impl: str = "auto", dcn_max_dy: int = 6,
                 dtype=torch.float32, dcn_boundary_grad: str = "clip",
                 dcn_impl_train: str = ""):
        super().__init__()

        def subnet():
            return FCNSubNet(in_channels, channels, num_layers, with_dcn,
                             dcn_impl, dcn_max_dy, dtype, dcn_boundary_grad,
                             dcn_impl_train)

        self.shared_subnet = shared_subnet
        if shared_subnet:
            self.subnet = subnet()
        else:
            for i in range(2, 6):
                self.add_module(f"subnet{i}", subnet())
        self.score = Conv2d(4 * channels, num_classes, 1, bias=True, dtype=dtype)

    def forward(self, pyramid):  # (P2, P3, P4, P5)
        out_hw = pyramid[0].shape[2:]
        feats = []
        for i, p in enumerate(pyramid, start=2):
            net = self.subnet if self.shared_subnet else getattr(self, f"subnet{i}")
            f = net(p)
            if f.shape[2:] != out_hw:
                f = resize_bilinear(f, out_hw)
            feats.append(f)
        x = torch.cat(feats, dim=1)
        # (B, num_seg_classes, H/4, W/4) and the fused 1/4-scale feature
        return self.score(x), x
