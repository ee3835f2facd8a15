"""Shared building blocks: frozen BN, GroupNorm, caffe-padded conv, dense,
deconv and deformable conv.

Port of ``upsnet_tpu/models/layers.py``. Parameters are float32 (the JAX
``param_dtype``); each module computes in its ``dtype`` by casting its
input and weights at the call, as flax does with ``dtype=``. Tensors are
NCHW. ``reset_parameters(generator)`` draws each module's random init from
an explicit ``torch.Generator``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from upsnet_torch.ops.deform_conv import deform_conv2d


def _he_normal(weight, generator=None):
    nn.init.kaiming_normal_(weight, mode="fan_in", nonlinearity="relu",
                            generator=generator)


class FrozenBatchNorm(nn.Module):
    """BatchNorm folded into constant affines: ``x * scale + bias``.

    The converter stores scale = gamma / sqrt(var + eps) and bias = beta -
    mean * scale; both are buffers, never trained."""

    def __init__(self, channels: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.register_buffer("scale", torch.ones(channels))
        self.register_buffer("bias", torch.zeros(channels))

    def forward(self, x):
        scale = self.scale.to(self.dtype)[None, :, None, None]
        bias = self.bias.to(self.dtype)[None, :, None, None]
        return x.to(self.dtype) * scale + bias


class GroupNorm(nn.Module):
    """GroupNorm over channel groups of NCHW maps, as flax 0.12's
    ``nn.GroupNorm(num_groups=32, epsilon=1e-5)`` computes it: statistics in
    float32 with the fast variance ``max(0, E[x^2] - E[x]^2)``, then
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in float32, cast to
    ``dtype`` at the end. ``F.group_norm`` takes another path (a two-pass
    variance, the input's dtype), which is why this is written out.
    ``scale`` and ``bias`` are float32 parameters and train."""

    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-5,
                 dtype=torch.float32):
        super().__init__()
        if channels % num_groups:
            raise ValueError(f"{num_groups} groups do not divide {channels} channels")
        self.num_groups, self.eps, self.dtype = num_groups, eps, dtype
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        b, c = x.shape[:2]
        xf = x.float()
        grouped = xf.reshape(b, self.num_groups, -1)
        mean = grouped.mean(-1)
        var = ((grouped * grouped).mean(-1) - mean * mean).clamp(min=0.0)
        per_channel = c // self.num_groups
        mean = mean.repeat_interleave(per_channel, 1)[:, :, None, None]
        var = var.repeat_interleave(per_channel, 1)[:, :, None, None]
        mul = torch.rsqrt(var + self.eps) * self.scale[None, :, None, None]
        y = (xf - mean) * mul + self.bias[None, :, None, None]
        return y.to(self.dtype)


NORMS = ("frozen_bn", "gn")


def make_norm(kind: str, channels: int, dtype=torch.float32) -> nn.Module:
    """The backbone's norm: 'frozen_bn' (affine constants from pretrained
    statistics, the reference's) or 'gn' (GroupNorm 32, trainable, for
    training from scratch). Both name their affines ``scale`` and ``bias``,
    so the bridge and checkpoints see one layout."""
    if kind == "gn":
        return GroupNorm(channels, dtype=dtype)
    if kind == "frozen_bn":
        return FrozenBatchNorm(channels, dtype)
    raise ValueError(f"unknown norm {kind!r}; expected one of {NORMS}")


class Conv2d(nn.Conv2d):
    """Conv with caffe-compatible symmetric ``k // 2`` padding, computing in
    ``dtype`` from float32 parameters; He-normal init like the JAX helper."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 bias: bool = False, dtype=torch.float32):
        super().__init__(cin, cout, kernel, stride=stride, padding=kernel // 2,
                         bias=bias)
        self.dtype = dtype

    def reset_parameters(self, generator=None):
        _he_normal(self.weight, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        b = self.bias.to(self.dtype) if self.bias is not None else None
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype), b,
                        self.stride, self.padding)


class Linear(nn.Linear):
    """Dense layer computing in ``dtype`` from float32 parameters."""

    def __init__(self, cin: int, cout: int, dtype=torch.float32,
                 init_std: float | None = None):
        self.init_std = init_std
        super().__init__(cin, cout)
        self.dtype = dtype

    def reset_parameters(self, generator=None):
        std = self.init_std or self.in_features ** -0.5  # lecun_normal default
        nn.init.normal_(self.weight, std=std, generator=generator)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype))


class ConvTranspose2d(nn.ConvTranspose2d):
    """Stride-k, kernel-k transposed conv computing in ``dtype``. The weight
    is torch's (in, out, kh, kw); the flax kernel is its spatial reverse
    (see ``convert/from_jax.py``)."""

    def __init__(self, cin: int, cout: int, kernel: int, dtype=torch.float32):
        super().__init__(cin, cout, kernel, stride=kernel)
        self.dtype = dtype

    def reset_parameters(self, generator=None):
        _he_normal(self.weight, generator)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        return F.conv_transpose2d(x.to(self.dtype), self.weight.to(self.dtype),
                                  self.bias.to(self.dtype), stride=self.stride)


class DeformConv(nn.Module):
    """Deformable conv (DCNv1, stride 1): a zero-initialised float32 conv
    predicts the offsets, ``ops.deform_conv.deform_conv2d`` consumes them.

    ``weight`` is (out, in, k, k) like a torch conv; ``impl`` is the JAX
    ``dcn_impl`` ('auto'/'gather' exact, 'pallas'/'mxu' dy clipped to
    +-max_dy, 'shift' dy and dx clipped where the JAX package takes its
    shift kernel and 'pallas' elsewhere). ``impl_train`` (default: ``impl``)
    takes its place whenever autograd records, as the JAX train step swaps in
    ``dcn_impl_train``; ``boundary_grad`` is the gradient of that clip.
    The offset probe (``utils/dcn_probe.py``) reads the raw offsets through
    a forward hook on ``offset_conv``.
    """

    def __init__(self, cin: int, features: int, kernel_size: int = 3,
                 dilation: int = 1, use_bias: bool = True,
                 dtype=torch.float32, impl: str = "auto", max_dy: int = 6,
                 boundary_grad: str = "clip", impl_train: str = ""):
        super().__init__()
        k = kernel_size
        self.kernel_size, self.dilation = k, dilation
        self.dtype, self.impl, self.max_dy = dtype, impl, max_dy
        self.boundary_grad, self.impl_train = boundary_grad, impl_train or impl
        self.offset_conv = nn.Conv2d(cin, 2 * k * k, k, dilation=dilation,
                                     padding=dilation * (k // 2))
        self.weight = nn.Parameter(torch.empty(features, cin, k, k))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        nn.init.zeros_(self.offset_conv.weight)
        nn.init.zeros_(self.offset_conv.bias)
        _he_normal(self.weight, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):  # (B, Cin, H, W)
        # offsets stay float32: sub-pixel positions must not lose bits
        offsets = self.offset_conv(x.float())
        o, i, k, _ = self.weight.shape
        w_taps = self.weight.reshape(o, i, k * k).permute(2, 1, 0)
        y = deform_conv2d(
            x.to(self.dtype).permute(0, 2, 3, 1), offsets.permute(0, 2, 3, 1),
            w_taps, self.bias, kernel_size=k, dilation=self.dilation,
            impl=self.impl_train if torch.is_grad_enabled() else self.impl,
            max_dy=self.max_dy, boundary_grad=self.boundary_grad,
        )
        return y.permute(0, 3, 1, 2)
