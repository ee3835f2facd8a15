"""K1: summed deformable bilinear sampling of tap-major projections.

Replaces the TPU kernel ``upsnet_tpu/ops/deform_conv_pallas.py:
_sample_pallas9`` (kernel body ``_sample9_kernel``), the inference DCN
sampler: given the per-tap projections ``y9[t] = x @ W_t`` and per-tap f32
sample coordinates, it returns ``sum_t bilinear(y9[t]; sy9[t], sx9[t])`` with
DCNv1 zero padding — a sample counts iff it lies in (-1, H) x (-1, W), and
corners outside the map read zero.

On the TPU the kernel DMAs a halo window of padded rows per row block and
turns the sampling into hat-matrix matmuls, because VMEM is large and
gathers are slow there; it therefore needs a +-max_dy window, 128-column
padding and 9 tap steps with bf16 adds. On the H100 none of that applies:
a thread reads any coordinate directly. ``csrc/deform_sample.cu`` runs one
thread per (output pixel, 8-channel group), makes one 16-byte load per
corner along contiguous channels, loops over the taps and the 4 corners
with an f32 accumulator and rounds once at the end.

What bounds it: the bytes of ``y9`` (T·B·H·W·C elements, read once in the
ideal; neighbouring pixels share corners through L1/L2), plus the f32
coordinates and the output. At P2 of the 832x1344 bucket with batch 2,
``y9`` alone is 9·2·208·336·128·2 B = 322 MB, so the bound is about 0.1 ms at
3.35 TB/s; the arithmetic (8 flops per element and tap) is far below the
card's rate.

Precision: the TPU kernel adds the taps in bf16 in tap order; this kernel
and its plain version add in f32 and round once, so they differ from the
TPU result by bf16 rounding of the partial sums, and from each other only
by f32 summation order before that one rounding.

``launches`` counts kernel launches (CPU calls do not count).
"""

from __future__ import annotations

import ctypes

import torch

from upsnet_torch.ops import cuda_build

launches = 0


def _bilinear_zero_pad(flat, y, x, h: int, w: int, base=None):
    """DCNv1 bilinear sample with zero padding, f32 result.

    flat: (N, C) feature rows; y, x: f32 coords of any shape S; base: int64
    row offset broadcast against S (the image's first row), or None.
    Returns (*S, C) float32.
    """
    inside = (y > -1.0) & (y < h) & (x > -1.0) & (x < w)
    y_low = torch.floor(y)
    x_low = torch.floor(x)
    ly = y - y_low
    lx = x - x_low
    yl = y_low.to(torch.int64)
    xl = x_low.to(torch.int64)
    out = torch.zeros((*y.shape, flat.shape[-1]), dtype=torch.float32,
                      device=flat.device)
    for yy, xx, wgt in ((yl, xl, (1 - ly) * (1 - lx)),
                        (yl, xl + 1, (1 - ly) * lx),
                        (yl + 1, xl, ly * (1 - lx)),
                        (yl + 1, xl + 1, ly * lx)):
        ok = inside & (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        idx = yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)
        if base is not None:
            idx = idx + base
        vals = flat[idx.reshape(-1)].reshape(out.shape).float()
        out += vals * (wgt * ok)[..., None]
    return out


def deform_sample9_plain(y9: torch.Tensor, sy9: torch.Tensor,
                         sx9: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: same math, f32 accumulation
    over taps and corners, one rounding to ``y9.dtype`` at the end."""
    t_n, b, h, w, c = y9.shape
    base = (torch.arange(b, device=y9.device) * (h * w))[:, None, None]
    acc = torch.zeros((b, h, w, c), dtype=torch.float32, device=y9.device)
    for t in range(t_n):
        acc += _bilinear_zero_pad(y9[t].reshape(b * h * w, c), sy9[t], sx9[t],
                                  h, w, base)
    return acc.to(y9.dtype)


def _check(y9, sy9, sx9):
    if y9.dim() != 5:
        raise ValueError(f"y9 must be (T, B, H, W, C), got {tuple(y9.shape)}")
    if y9.dtype not in cuda_build.DTYPE_CODES:
        raise TypeError(f"y9 dtype {y9.dtype} not in {list(cuda_build.DTYPE_CODES)}")
    t_n, b, h, w, c = y9.shape
    for name, s in (("sy9", sy9), ("sx9", sx9)):
        if s.shape != (t_n, b, h, w):
            raise ValueError(f"{name} must be {(t_n, b, h, w)}, got {tuple(s.shape)}")
        if s.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {s.dtype}")
        if s.device != y9.device:
            raise ValueError(f"{name} on {s.device}, y9 on {y9.device}")


def deform_sample9(y9: torch.Tensor, sy9: torch.Tensor,
                   sx9: torch.Tensor) -> torch.Tensor:
    """Σ_t bilinear(y9[t]; sy9[t], sx9[t]) with DCNv1 zero padding.

    y9 (T, B, H, W, C) bf16/f32 unpadded tap projections; sy9, sx9
    (T, B, H, W) f32 absolute sample coordinates. Returns (B, H, W, C) in
    ``y9.dtype``. CPU tensors take the plain version; CUDA tensors launch
    the kernel (C % 8 == 0, contiguous, 16-byte aligned).
    """
    global launches
    _check(y9, sy9, sx9)
    if y9.device.type == "cpu":
        return deform_sample9_plain(y9, sy9, sx9)
    if y9.device.type != "cuda":
        raise ValueError(f"unsupported device {y9.device}")
    t_n, b, h, w, c = y9.shape
    if c % 8:
        raise ValueError(f"C={c} must be a multiple of 8")
    for name, s in (("y9", y9), ("sy9", sy9), ("sx9", sx9)):
        if not s.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if y9.data_ptr() % 16:
        raise ValueError("y9 must be 16-byte aligned")
    out = torch.empty((b, h, w, c), dtype=y9.dtype, device=y9.device)
    lib = cuda_build.load("deform_sample")
    fn = lib.deform_sample9
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    stream = torch.cuda.current_stream(y9.device).cuda_stream
    with torch.cuda.device(y9.device):
        status = fn(y9.data_ptr(), sy9.data_ptr(), sx9.data_ptr(),
                    out.data_ptr(), t_n, b, h, w, c,
                    cuda_build.DTYPE_CODES[y9.dtype], stream)
    cuda_build.check(lib, status, "deform_sample9")
    launches += 1
    return out
