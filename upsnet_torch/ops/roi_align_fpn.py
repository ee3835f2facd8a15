"""K4 and K5: FPN ROIAlign over the P2..P5 pyramid, forward and backward;
``FPNRoIAlign`` ties them into autograd. K5 is described above its wrapper
below.

K4 replaces the TPU kernel ``upsnet_tpu/ops/roi_align_pallas.py:
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

``launches`` counts K4's kernel launches and ``launches_bwd`` K5's (CPU
calls do not count).
"""

from __future__ import annotations

import ctypes

import torch

from upsnet_torch.ops import cuda_build
from upsnet_torch.ops.anchors import FPN_STRIDES
from upsnet_torch.ops.roi_align import _bilinear_corners, _sample_coords

launches = 0
launches_bwd = 0


def _corner_table(hw, b: int, rois, levels, pooled: int, s: int, strides):
    """Where every sample of every RoI reads in one flattened pyramid buffer
    of ``b`` images whose levels have the sizes ``hw`` ((H_l, W_l), ...).

    Returns (per_img, ((idx, wgt) x 4 corners)): idx (N, P, P, S, S) int64
    rows of the (b * per_img, C) buffer, wgt the f32 bilinear weights (zero
    for samples that do not count). Levels outside [0, 3] are clamped, as
    the kernels do."""
    n = b * rois.shape[1]
    dev = rois.device
    hs = torch.tensor([h for h, _ in hw], dtype=torch.float32, device=dev)
    ws = torch.tensor([w for _, w in hw], dtype=torch.float32, device=dev)
    sizes = [h * w for h, w in hw]
    offs = torch.tensor([sum(sizes[:i]) for i in range(len(sizes))], device=dev)
    scales = torch.tensor([1.0 / st for st in strides], dtype=torch.float32,
                          device=dev)
    per_img = sum(sizes)
    lev = levels.reshape(n).long().clamp(0, len(hw) - 1)
    img = torch.arange(b, device=dev).repeat_interleave(rois.shape[1])
    y, x = _sample_coords(rois.reshape(n, 4).float() * scales[lev][:, None],
                          1.0, pooled, s)
    ext = (slice(None),) + (None,) * 4
    lh, lw = hs[lev][ext], ws[lev][ext]
    yl, xl, yh, xh, wll, wlh, whl, whh = _bilinear_corners(y, x, lh, lw)
    base = (img * per_img + offs[lev])[ext]
    lwi = lw.long()
    return per_img, tuple((base + yy * lwi + xx, wgt) for yy, xx, wgt in (
        (yl, xl, wll), (yl, xh, wlh), (yh, xl, whl), (yh, xh, whh)))


def fpn_roi_align_plain(features, rois, levels, pooled: int = 7,
                        sampling_ratio: int = 2,
                        strides=FPN_STRIDES[:4]) -> torch.Tensor:
    """Plain PyTorch version of K4: every RoI samples its level of one
    flattened pyramid buffer; f32 accumulation, one rounding at the end."""
    b, r = rois.shape[:2]
    c = features[0].shape[-1]
    s = sampling_ratio
    n = b * r
    flat = torch.cat([f.reshape(b, -1, c) for f in features], dim=1)
    per_img, corners = _corner_table([f.shape[1:3] for f in features], b, rois,
                                     levels, pooled, s, strides)
    flat = flat.reshape(b * per_img, c)
    acc = torch.zeros((n, pooled, pooled, c), dtype=torch.float32, device=rois.device)
    for idx, wgt in corners:
        vals = flat[idx.reshape(-1)].reshape(n, pooled, pooled, s, s, c).float()
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


# ---------------------------------------------------------------------------
# K5: the backward, and the autograd Function
# ---------------------------------------------------------------------------
#
# K5 replaces the TPU kernel ``roi_align_pallas.py:fpn_roi_align_window_bwd``
# (``_window_bwd_kernel``). There a per-RoI window of an f32 canvas is
# read-modify-written per strip by sequential grid steps; on the card one
# block per RoI scatters each bin's gradient (divided by S*S) to its samples'
# corners with atomics into four zeroed f32 canvases
# (``csrc/roi_align_fpn_bwd.cu``), and the wrapper casts each canvas to its
# level's dtype, as the JAX backward casts its f32 accumulator. What bounds
# it: bytes, the gradient read once and the canvases (the whole pyramid in
# f32, 190 MB at 832x1344, batch 2, C=256) written.


def fpn_roi_align_bwd_plain(g, rois, levels, shapes, dtypes,
                            sampling_ratio: int = 2,
                            strides=FPN_STRIDES[:4]):
    """Plain PyTorch version of K5. g (B, R, P, P, C); shapes the four
    (B, H_l, W_l, C) level shapes and dtypes their dtypes. Returns the four
    level gradients, summed in f32 and cast once."""
    b, r, pooled = g.shape[:3]
    c = g.shape[-1]
    s = sampling_ratio
    hw = [tuple(sh[1:3]) for sh in shapes]
    per_img, corners = _corner_table(hw, b, rois, levels, pooled, s, strides)
    canvas = torch.zeros((b * per_img, c), dtype=torch.float32, device=g.device)
    gs = (g.float() / float(s * s)).reshape(b * r, pooled, pooled, 1, 1, c)
    for idx, wgt in corners:
        canvas.index_add_(0, idx.reshape(-1), (gs * wgt[..., None]).reshape(-1, c))
    parts = canvas.reshape(b, per_img, c).split([h * w for h, w in hw], dim=1)
    return tuple(p.reshape(b, h, w, c).to(dt)
                 for p, (h, w), dt in zip(parts, hw, dtypes))


def fpn_roi_align_bwd(g: torch.Tensor, rois: torch.Tensor, levels: torch.Tensor,
                      shapes, dtypes, sampling_ratio: int = 2,
                      strides=FPN_STRIDES[:4]):
    """K5: gradient of ``fpn_roi_align`` to the four level maps.

    g (B, R, P, P, C) bf16/f32 upstream gradient; rois (B, R, 4) f32; levels
    (B, R) int32; shapes / dtypes of the four levels. Returns four
    (B, H_l, W_l, C) tensors in the levels' dtypes, summed in f32 canvases.
    On the card the canvases are filled with atomics, so the sums differ
    between runs by f32 rounding. CPU tensors take the plain version; CUDA
    tensors launch the kernel (C % 8 == 0, contiguous, 16-byte aligned g).
    """
    global launches_bwd
    if g.dim() != 5 or g.shape[2] != g.shape[3]:
        raise ValueError(f"g must be (B, R, P, P, C), got {tuple(g.shape)}")
    if g.dtype not in cuda_build.DTYPE_CODES:
        raise TypeError(f"g dtype {g.dtype} not in {list(cuda_build.DTYPE_CODES)}")
    b, r, pooled, _, c = g.shape
    if len(shapes) != 4 or len(dtypes) != 4:
        raise ValueError(f"expected 4 pyramid levels, got {len(shapes)}")
    for i, sh in enumerate(shapes):
        if len(sh) != 4 or sh[0] != b or sh[-1] != c:
            raise ValueError(f"level {i} must be (B={b}, H, W, C={c}), got {tuple(sh)}")
    if rois.shape != (b, r, 4) or rois.dtype != torch.float32:
        raise ValueError(f"rois must be float32 {(b, r, 4)}, got {rois.dtype} "
                         f"{tuple(rois.shape)}")
    if levels.shape != (b, r) or levels.dtype != torch.int32:
        raise ValueError(f"levels must be int32 {(b, r)}, got {levels.dtype} "
                         f"{tuple(levels.shape)}")
    if rois.device != g.device or levels.device != g.device:
        raise ValueError("g, rois and levels must share a device")
    if g.device.type == "cpu":
        return fpn_roi_align_bwd_plain(g, rois, levels, shapes, dtypes,
                                       sampling_ratio, strides)
    if g.device.type != "cuda":
        raise ValueError(f"unsupported device {g.device}")
    if c % 8:
        raise ValueError(f"C={c} must be a multiple of 8")
    for name, t in (("g", g), ("rois", rois), ("levels", levels)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if g.data_ptr() % 16:
        raise ValueError("g must be 16-byte aligned")
    canvases = [torch.zeros(tuple(sh), dtype=torch.float32, device=g.device)
                for sh in shapes]
    lib = cuda_build.load("roi_align_fpn_bwd")
    fn = lib.fpn_roi_align_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 13
                   + [ctypes.c_float] * 4 + [ctypes.c_int, ctypes.c_void_p])
    dims = [d for sh in shapes for d in (sh[1], sh[2])]
    scales = [1.0 / st for st in strides]
    stream = torch.cuda.current_stream(g.device).cuda_stream
    with torch.cuda.device(g.device):
        status = fn(*(cv.data_ptr() for cv in canvases), rois.data_ptr(),
                    levels.data_ptr(), g.data_ptr(), b, r, c, pooled,
                    sampling_ratio, *dims, *scales,
                    cuda_build.DTYPE_CODES[g.dtype], stream)
    cuda_build.check(lib, status, "fpn_roi_align_bwd")
    launches_bwd += 1
    return tuple(cv.to(dt) for cv, dt in zip(canvases, dtypes))


class FPNRoIAlign(torch.autograd.Function):
    """``fpn_roi_align`` with gradients to the four level maps only:
    forward K4, backward K5 (their plain versions on CPU tensors). Call as
    ``FPNRoIAlign.apply(rois, levels, pooled, sampling_ratio, strides,
    *features)``."""

    @staticmethod
    def forward(ctx, rois, levels, pooled, sampling_ratio, strides, *features):
        ctx.save_for_backward(rois, levels)
        ctx.meta = (sampling_ratio, strides, [tuple(f.shape) for f in features],
                    [f.dtype for f in features])
        return fpn_roi_align(features, rois, levels, pooled, sampling_ratio, strides)

    @staticmethod
    def backward(ctx, g):
        rois, levels = ctx.saved_tensors
        sampling_ratio, strides, shapes, dtypes = ctx.meta
        grads = fpn_roi_align_bwd(g.contiguous(), rois, levels, shapes, dtypes,
                                  sampling_ratio, strides)
        return (None,) * 5 + grads
