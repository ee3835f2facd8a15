"""K4: FPN ROIAlign forward over the P2..P5 pyramid.

Replaces the TPU kernel ``upsnet_tpu/ops/roi_align_pallas.py:
fpn_roi_align_window`` (kernel body ``_window_kernel``), and is the port's
counterpart of ``roi_align.fpn_roi_align_batched``: each RoI is pooled from
its assigned level into P x P bins of ``sampling_ratio**2`` bilinear samples
with the Detectron clamp (``ops/roi_align.py``), averaged.

On the TPU the kernel DMAs a (32, 64)-cell window per RoI into VMEM,
computes all samples as one joint-hat matmul, and walks a strip loop for
RoIs larger than the window; small levels are zero-padded up to the window.
On the H100, ``csrc/roi_align_fpn.cu`` needs none of it: one block per RoI
reads the RoI's own level directly, its threads stride over
(bin, 8-channel group) work items, and each sample corner is a 16-byte load
along contiguous channels with an f32 accumulator.

What bounds it: the feature bytes the samples touch (at most the whole
pyramid, 95 MB in bf16 at 832x1344, batch 2, C=256) plus the output
(B·R·P·P·C), so bytes; the arithmetic (about 33 flops per output element
at sampling_ratio 2) is small.

``launches`` counts kernel launches (CPU calls do not count).
"""

from __future__ import annotations

import ctypes

import torch

from upsnet_torch.ops import cuda_build
from upsnet_torch.ops.anchors import FPN_STRIDES
from upsnet_torch.ops.roi_align import _bilinear_corners, _sample_coords

launches = 0


def fpn_roi_align_plain(features, rois, levels, pooled: int = 7,
                        sampling_ratio: int = 2,
                        strides=FPN_STRIDES[:4]) -> torch.Tensor:
    """Plain PyTorch version of the kernel: every RoI samples its level of
    one flattened pyramid buffer; f32 accumulation, one rounding at the end.
    Levels outside [0, 3] are clamped, as the kernel does."""
    b, r = rois.shape[:2]
    c = features[0].shape[-1]
    s = sampling_ratio
    dev = rois.device
    n = b * r
    flat = torch.cat([f.reshape(b, -1, c) for f in features], dim=1)
    per_img = flat.shape[1]
    flat = flat.reshape(b * per_img, c)
    hs = torch.tensor([f.shape[1] for f in features], dtype=torch.float32, device=dev)
    ws = torch.tensor([f.shape[2] for f in features], dtype=torch.float32, device=dev)
    sizes = [f.shape[1] * f.shape[2] for f in features]
    offs = torch.tensor([sum(sizes[:i]) for i in range(len(sizes))], device=dev)
    scales = torch.tensor([1.0 / st for st in strides], dtype=torch.float32,
                          device=dev)

    lev = levels.reshape(n).long().clamp(0, len(features) - 1)
    img = torch.arange(b, device=dev).repeat_interleave(r)
    y, x = _sample_coords(rois.reshape(n, 4).float() * scales[lev][:, None],
                          1.0, pooled, s)
    ext = (slice(None),) + (None,) * 4
    lh, lw = hs[lev][ext], ws[lev][ext]
    yl, xl, yh, xh, wll, wlh, whl, whh = _bilinear_corners(y, x, lh, lw)
    base = (img * per_img + offs[lev])[ext]
    lwi = lw.long()
    acc = torch.zeros((n, pooled, pooled, c), dtype=torch.float32, device=dev)
    for yy, xx, wgt in ((yl, xl, wll), (yl, xh, wlh), (yh, xl, whl),
                        (yh, xh, whh)):
        idx = (base + yy * lwi + xx).reshape(-1)
        vals = flat[idx].reshape(n, pooled, pooled, s, s, c).float()
        acc += (vals * wgt[..., None]).sum(dim=(3, 4))
    out = acc / float(s * s)
    return out.reshape(b, r, pooled, pooled, c).to(features[0].dtype)


def _check(features, rois, levels):
    if len(features) != 4:
        raise ValueError(f"expected 4 pyramid levels, got {len(features)}")
    f0 = features[0]
    if f0.dtype not in cuda_build.DTYPE_CODES:
        raise TypeError(f"feature dtype {f0.dtype} not in {list(cuda_build.DTYPE_CODES)}")
    b, c = f0.shape[0], f0.shape[-1]
    for i, f in enumerate(features):
        if f.dim() != 4 or f.shape[0] != b or f.shape[-1] != c:
            raise ValueError(f"level {i} must be (B={b}, H, W, C={c}), got {tuple(f.shape)}")
        if f.dtype != f0.dtype or f.device != f0.device:
            raise ValueError(f"level {i} dtype/device differ from level 0")
    if rois.dim() != 3 or rois.shape[0] != b or rois.shape[2] != 4:
        raise ValueError(f"rois must be (B={b}, R, 4), got {tuple(rois.shape)}")
    if rois.dtype != torch.float32:
        raise TypeError(f"rois must be float32, got {rois.dtype}")
    if levels.shape != rois.shape[:2]:
        raise ValueError(f"levels must be {tuple(rois.shape[:2])}, got {tuple(levels.shape)}")
    if levels.dtype != torch.int32:
        raise TypeError(f"levels must be int32, got {levels.dtype}")
    if rois.device != f0.device or levels.device != f0.device:
        raise ValueError("rois, levels and features must share a device")


def fpn_roi_align(features, rois: torch.Tensor, levels: torch.Tensor,
                  pooled: int = 7, sampling_ratio: int = 2,
                  strides=FPN_STRIDES[:4]) -> torch.Tensor:
    """Multi-level FPN ROIAlign forward.

    features: 4 levels (B, H_l, W_l, C) bf16/f32, channel-last; rois
    (B, R, 4) f32 image coordinates; levels (B, R) int32 in 0..3. Returns
    (B, R, pooled, pooled, C) in the features' dtype. CPU tensors take the
    plain version; CUDA tensors launch the kernel (C % 8 == 0, contiguous,
    16-byte aligned levels).
    """
    global launches
    _check(features, rois, levels)
    f0 = features[0]
    if f0.device.type == "cpu":
        return fpn_roi_align_plain(features, rois, levels, pooled,
                                   sampling_ratio, strides)
    if f0.device.type != "cuda":
        raise ValueError(f"unsupported device {f0.device}")
    b, r = rois.shape[:2]
    c = f0.shape[-1]
    if c % 8:
        raise ValueError(f"C={c} must be a multiple of 8")
    for name, t in (("rois", rois), ("levels", levels), *(
            (f"level {i}", f) for i, f in enumerate(features))):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if any(f.data_ptr() % 16 for f in features):
        raise ValueError("pyramid levels must be 16-byte aligned")
    out = torch.empty((b, r, pooled, pooled, c), dtype=f0.dtype, device=f0.device)
    lib = cuda_build.load("roi_align_fpn")
    fn = lib.fpn_roi_align
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 13
                   + [ctypes.c_float] * 4 + [ctypes.c_int, ctypes.c_void_p])
    dims = [d for f in features for d in (f.shape[1], f.shape[2])]
    scales = [1.0 / st for st in strides]
    stream = torch.cuda.current_stream(f0.device).cuda_stream
    with torch.cuda.device(f0.device):
        status = fn(*(f.data_ptr() for f in features), rois.data_ptr(),
                    levels.data_ptr(), out.data_ptr(), b, r, c, pooled,
                    sampling_ratio, *dims, *scales,
                    cuda_build.DTYPE_CODES[f0.dtype], stream)
    cuda_build.check(lib, status, "fpn_roi_align")
    launches += 1
    return out
