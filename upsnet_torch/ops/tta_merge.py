"""The semantic half of the TTA merge on the card, the fusion's resample of
its result, and each variant's input canvas (``csrc/tta_merge.cu``).

``merge(maps, crops, flips, size)``: each variant's quarter-scale semantic
logits (H, W, C) float32 cropped to its content (numpy's slice: a crop beyond
the map takes the whole map, which the resize then stretches), de-flipped
where the variant was flipped, resized to the frame ``size`` by cv2's
``INTER_LINEAR``, summed in variant order and divided by their count; with
the first-maximum argmax of the average (uint8), taken in the same pass. One
launch an image.

``resample(avg, content, canvas)``: the average resized the same way to the
first variant's quarter-scale content, on a zeroed (qh, qw, C) canvas: the
frame ``panoptic_fuse`` runs in. One launch an image.

``sample_canvas(frame, scale_hw, bucket, flip, dtype)``: one TTA variant's
input canvas from the (H, W, 3) uint8 BGR frame on the device: the frame
resized to ``scale_hw`` by the same rule, the pixel means subtracted,
mirrored where ``flip``, laid at the top-left of a zeroed ``bucket`` canvas
(cropped to it where it outgrows it) and rounded to ``dtype``: the canvas of
``BaseDataset.sample(i, target_scale=, hflip=)`` as ``sample_predictor``
casts it, built from one upload of the frame. One launch a variant.

None replaces a TPU kernel: the JAX package merges and builds its samples on
the host with cv2, as the port did before them. The resize is cv2's,
operation for operation (the source's header lists the rule), including
cv2's switch to ``INTER_AREA`` where the source is exactly twice the
destination on both axes, so the plain versions here give cv2's bits for
float32 maps of any channel count but 1, 3 and 4 (where cv2 takes a
vectorised path of its own that rounds otherwise; semantic logits have more
channels). The canvas has three: at unit scale and at exact 2x it has the
host's bits (the taps are (1, 0) there, and cv2 copies or averages), at
other scales it lies within about 0.011 of cv2's (float32, 0-255 values).

What bounds them on the card: bytes (the source's header gives the counts;
about 0.063 ms for the merge at the Cityscapes TTA cell, 0.015 ms for the
resample, 0.0056 ms for a bf16 sample of its 1024x2048 frame). The wrappers
send CPU tensors to the plain versions, launch on CUDA tensors with no
fallback, and count launches: ``launches`` (merge), ``launches_resample``
and ``launches_sample``.
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch

from upsnet_torch.data.transforms import PIXEL_MEANS_BGR
from upsnet_torch.ops import cuda_build

launches = 0
launches_resample = 0
launches_sample = 0

MAX_MAPS = 8
MAX_CHANNELS = 256  # the argmax is uint8
_LIB = "tta_merge"
_entries: dict = {}


def _entry(fn_name: str, argtypes: list):
    if fn_name not in _entries:
        fn = getattr(cuda_build.load(_LIB), fn_name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        _entries[fn_name] = fn
    return _entries[fn_name]


def _scale(dst: int, src: int) -> float:
    """cv2's source step per destination pixel, 1 / (dst / src) in double."""
    return 1.0 / (dst / src)


def _is_area(size, src_hw) -> bool:
    """cv2 resizes by ``INTER_AREA`` where ``INTER_LINEAR`` asks for exactly
    half the size on both axes."""
    def twice(s):
        return abs(s - round(s)) < sys.float_info.epsilon and round(s) == 2
    return twice(_scale(size[0], src_hw[0])) and twice(_scale(size[1], src_hw[1]))


def _axis(dst: int, src: int, hold_weights: bool):
    """cv2 ``INTER_LINEAR``'s taps of one axis: (i0, i1, w0, w1), indices
    int64 and weights float32. Columns (``hold_weights``) clamp the
    position, weights included; rows clamp the index and keep the weights."""
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * _scale(dst, src) - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(np.float32)
    if hold_weights:
        f[s < 0] = 0
        s = np.maximum(s, 0)
        f[s >= src - 1] = 0
        s = np.minimum(s, src - 1)
    i0, i1 = np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1)
    return i0, i1, np.float32(1) - f, f


def resize_plain(x: torch.Tensor, size) -> torch.Tensor:
    """(H, W, C) float32 -> (size[0], size[1], C) as cv2.resize with
    ``INTER_LINEAR`` computes it: the horizontal pass, then the vertical,
    each value a rounded product plus a rounded product."""
    h, w = x.shape[:2]
    if _is_area(size, (h, w)):
        return (((x[0::2, 0::2] + x[0::2, 1::2]) + x[1::2, 0::2]) + x[1::2, 1::2]) * 0.25

    def table(a):
        return torch.from_numpy(a).to(x.device)

    q0, q1, a0, a1 = (table(a) for a in _axis(int(size[1]), w, True))
    r0, r1, b0, b1 = (table(a) for a in _axis(int(size[0]), h, False))
    rows = x[:, q0] * a0[:, None] + x[:, q1] * a1[:, None]
    return rows[r0] * b0[:, None, None] + rows[r1] * b1[:, None, None]


def _crop(m: torch.Tensor, crop) -> tuple:
    """The content (rows, cols) of map ``m`` as numpy's slice takes it."""
    return min(int(crop[0]), m.shape[0]), min(int(crop[1]), m.shape[1])


def merge_plain(maps, crops, flips, size) -> tuple:
    """Plain PyTorch version of the merge: (avg (oh, ow, C) float32, argmax
    (oh, ow) uint8)."""
    total = None
    for m, crop, flip in zip(maps, crops, flips, strict=True):
        rows, cols = _crop(m, crop)
        seg = m[:rows, :cols]
        if flip:
            seg = seg.flip(1)
        seg = resize_plain(seg, size)
        total = seg if total is None else total + seg
    # divided by a tensor on the maps' device: PyTorch's CUDA division by a
    # Python number multiplies by its reciprocal, which rounds otherwise
    avg = total / torch.tensor(float(len(maps)), device=total.device)
    return avg, avg.argmax(-1).to(torch.uint8)


def _check_maps(maps, crops, flips, size) -> None:
    if not 1 <= len(maps) <= MAX_MAPS or not len(maps) == len(crops) == len(flips):
        raise ValueError(f"1 to {MAX_MAPS} maps, each with a crop and a flip flag; got "
                         f"{len(maps)}, {len(crops)}, {len(flips)}")
    m0 = maps[0]
    for m in maps:
        if m.dim() != 3 or m.shape[-1] != m0.shape[-1]:
            raise ValueError(f"maps must be (H, W, C={m0.shape[-1]}), got {tuple(m.shape)}")
        if m.dtype != torch.float32:
            raise TypeError(f"maps must be float32, got {m.dtype}")
        if m.device != m0.device:
            raise ValueError("maps must share a device")
        if m.numel() >= 1 << 31 or m.numel() == 0:
            raise ValueError(f"a map of {m.numel()} elements is outside (0, 2^31)")
    if not 1 <= m0.shape[-1] <= MAX_CHANNELS:
        raise ValueError(f"C={m0.shape[-1]} must be 1 to {MAX_CHANNELS} (a uint8 argmax)")
    if min(size) < 1 or size[0] * size[1] >= 1 << 31:
        raise ValueError(f"frame {tuple(size)} must be non-empty, under 2^31 pixels")
    if any(min(int(c[0]), int(c[1])) < 1 for c in crops):
        raise ValueError(f"crops {crops} must be at least 1x1")


def merge(maps, crops, flips, size) -> tuple:
    """Merge the variants' logits: (avg (oh, ow, C) float32, argmax (oh, ow)
    uint8) on the maps' device. ``crops``: each map's content (rows, cols)
    at quarter scale, clamped to the map; ``flips``: whether its variant was
    flipped; ``size``: the frame (oh, ow)."""
    global launches
    _check_maps(maps, crops, flips, size)
    m0 = maps[0]
    if m0.device.type == "cpu":
        return merge_plain(maps, crops, flips, size)
    if m0.device.type != "cuda":
        raise ValueError(f"unsupported device {m0.device}")
    maps = [m.contiguous() for m in maps]
    oh, ow = (int(v) for v in size)
    c = m0.shape[-1]
    n = len(maps)
    dims, scales = [], []
    for m, crop, flip in zip(maps, crops, flips):
        rows, cols = _crop(m, crop)
        dims += [rows, cols, m.shape[1], int(bool(flip)), int(_is_area((oh, ow), (rows, cols)))]
        scales += [_scale(oh, rows), _scale(ow, cols)]
    avg = torch.empty((oh, ow, c), dtype=torch.float32, device=m0.device)
    arg = torch.empty((oh, ow), dtype=torch.uint8, device=m0.device)
    fn = _entry("tta_merge", [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 4
                + [ctypes.c_void_p])
    ptrs = (ctypes.c_void_p * n)(*(m.data_ptr() for m in maps))
    stream = torch.cuda.current_stream(m0.device).cuda_stream
    with torch.cuda.device(m0.device):
        status = fn(ptrs, (ctypes.c_int * len(dims))(*dims),
                    (ctypes.c_double * len(scales))(*scales), n, avg.data_ptr(),
                    arg.data_ptr(), oh, ow, c, cuda_build.DTYPE_CODES[torch.float32], stream)
    cuda_build.check(cuda_build.load(_LIB), status, "tta_merge")
    launches += 1
    return avg, arg


def resample_plain(avg: torch.Tensor, content, canvas) -> torch.Tensor:
    """Plain PyTorch version of the resample: (qh, qw, C), ``avg`` resized
    to ``content`` at the top left, zero elsewhere."""
    out = torch.zeros(tuple(canvas) + avg.shape[2:], dtype=avg.dtype, device=avg.device)
    out[:content[0], :content[1]] = resize_plain(avg, content)
    return out


def resample(avg: torch.Tensor, content, canvas) -> torch.Tensor:
    """``avg`` (oh, ow, C) float32 resized to ``content`` (ch, cw) on a
    zeroed ``canvas`` (qh, qw), on ``avg``'s device."""
    global launches_resample
    (ch, cw), (qh, qw) = (int(v) for v in content), (int(v) for v in canvas)
    if avg.dim() != 3 or avg.dtype != torch.float32 or avg.numel() == 0:
        raise ValueError(f"avg must be a non-empty (H, W, C) float32, got {avg.dtype} "
                         f"{tuple(avg.shape)}")
    if not (1 <= ch <= qh and 1 <= cw <= qw) or qh * qw >= 1 << 31:
        raise ValueError(f"content {(ch, cw)} must lie in the canvas {(qh, qw)}")
    if avg.device.type == "cpu":
        return resample_plain(avg, (ch, cw), (qh, qw))
    if avg.device.type != "cuda":
        raise ValueError(f"unsupported device {avg.device}")
    if avg.numel() >= 1 << 31:
        raise ValueError(f"avg of {avg.numel()} elements must be under 2^31")
    avg = avg.contiguous()
    sh, sw, c = avg.shape
    out = torch.empty((qh, qw, c), dtype=torch.float32, device=avg.device)
    fn = _entry("tta_resample", [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7
                + [ctypes.c_double] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    stream = torch.cuda.current_stream(avg.device).cuda_stream
    with torch.cuda.device(avg.device):
        status = fn(avg.data_ptr(), out.data_ptr(), sh, sw, qh, qw, ch, cw, c,
                    _scale(ch, sh), _scale(cw, sw), int(_is_area((ch, cw), (sh, sw))),
                    cuda_build.DTYPE_CODES[torch.float32], stream)
    cuda_build.check(cuda_build.load(_LIB), status, "tta_resample")
    launches_resample += 1
    return out


def sample_canvas_plain(frame: torch.Tensor, scale_hw, bucket, flip: bool,
                        dtype: torch.dtype) -> torch.Tensor:
    """Plain PyTorch version of the sample: (bh, bw, 3) in ``dtype``."""
    (rh, rw), (bh, bw) = scale_hw, bucket
    img = resize_plain(frame.float(), (rh, rw))
    if flip:
        img = img.flip(1)
    img = img - torch.from_numpy(PIXEL_MEANS_BGR).to(img.device)
    out = torch.zeros((bh, bw, 3), dtype=dtype, device=frame.device)
    out[:min(rh, bh), :min(rw, bw)] = img[:bh, :bw].to(dtype)
    return out


def sample_canvas(frame: torch.Tensor, scale_hw, bucket, flip: bool,
                  dtype: torch.dtype) -> torch.Tensor:
    """The canvas (bh, bw, 3) in ``dtype`` (bfloat16 or float32) of the
    (H, W, 3) uint8 BGR ``frame`` resized to ``scale_hw`` (rh, rw), mirrored
    where ``flip``, in ``bucket`` (bh, bw), on the frame's device."""
    global launches_sample
    (rh, rw), (bh, bw) = (int(v) for v in scale_hw), (int(v) for v in bucket)
    if not torch.is_tensor(frame) or frame.dtype != torch.uint8:
        raise TypeError(f"frame must be a uint8 tensor, got {getattr(frame, 'dtype', frame)}")
    if frame.dim() != 3 or frame.shape[-1] != 3 or frame.numel() == 0:
        raise ValueError(f"frame must be a non-empty (H, W, 3), got {tuple(frame.shape)}")
    if not frame.is_contiguous():
        raise ValueError("frame must be contiguous")
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the canvas must be bfloat16 or float32, got {dtype}")
    if min(rh, rw, bh, bw) < 1 or frame.numel() >= 1 << 31 or bh * bw * 3 >= 1 << 31:
        raise ValueError(f"content {(rh, rw)} and bucket {(bh, bw)} must be non-empty; "
                         f"frame and canvas under 2^31 values")
    if frame.device.type == "cpu":
        return sample_canvas_plain(frame, (rh, rw), (bh, bw), flip, dtype)
    if frame.device.type != "cuda":
        raise ValueError(f"unsupported device {frame.device}")
    h, w = frame.shape[:2]
    out = torch.empty((bh, bw, 3), dtype=dtype, device=frame.device)
    fn = _entry("tta_sample", [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6
                + [ctypes.c_double] * 2 + [ctypes.c_int] * 2 + [ctypes.c_float] * 3
                + [ctypes.c_int, ctypes.c_void_p])
    stream = torch.cuda.current_stream(frame.device).cuda_stream
    with torch.cuda.device(frame.device):
        status = fn(frame.data_ptr(), out.data_ptr(), h, w, rh, rw, bh, bw, _scale(rh, h),
                    _scale(rw, w), int(_is_area((rh, rw), (h, w))), int(bool(flip)),
                    *(float(m) for m in PIXEL_MEANS_BGR), cuda_build.DTYPE_CODES[dtype], stream)
    cuda_build.check(cuda_build.load(_LIB), status, "tta_sample")
    launches_sample += 1
    return out
