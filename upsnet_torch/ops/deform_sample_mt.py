"""K7a, K7b: sample-first multi-tap deformable sampling and its backward.

Counterpart of the ``mt`` kernels of ``upsnet_tpu/ops/deform_conv_pallas.py``.
``deform_sample_mt`` (K7a) replaces ``_sample_pallas_mt`` and
``deform_sample_mt_bwd`` (K7b) ``_sample_pallas_mt_bwd``; ``DeformSampleMT``
ties them into autograd as ``deform_sample_mt``'s custom VJP does there.

What they compute. The reference CUDA lineage of deformable convolution
samples the *input* and applies the weights afterwards (deformable im2col):
``x (B, H, W, C)`` is sampled at all K taps, ``sy, sx (K, B, H, W)`` being
absolute f32 sample coordinates, into columns

    cols[b, i, j, t, :] = bilinear(x[b]; sy[t, b, i, j], sx[t, b, i, j])

with hat weights ``v(d) = max(0, 1 - |d|)`` and DCNv1 zero padding (a sample
counts iff it lies in (-1, H) x (-1, W); rows and columns outside the map
read zero). One GEMM of ``(B*H*W, K*C)`` by ``(K*C, Cout)`` follows outside
the kernel (``ops.deform_conv.deform_conv2d_mt``). K7b returns the gradient
to ``x`` and the coordinate gradients ``gsy, gsx (K, B, H, W)`` f32 with
``dv/dd = -sign(d)`` on ``|d| < 1`` and 0 elsewhere, so both are exactly 0 at
an integer coordinate, as in K3 and K8c.

On the TPU both kernels hold a halo window of zero-padded rows in VMEM
(hence a dy bound), pad columns to 128 with -1e9 sentinel coordinates, write
``(B, H, K, Wpd, C)`` and, in backward, run per group of 3 taps with
per-block windows accumulated in ``x.dtype`` before an f32 overlap-add. On
the card a thread reads any address, so none of that is carried over: any H
and W, coordinates of any value, the columns in the GEMM's layout. K7a walks
the K taps of a pixel in one thread, as K1 does. K7b is the unclipped
all-tap K3 with the taps' roles turned round (one x for all taps, a g row
per (pixel, tap)): a counting sort of all samples by low corner, the K taps
of an image in one plane of bins ranked by (pixel, tap), and a gather that
sums each grad_x element in f32 in a fixed order and writes it once in
``x.dtype`` (no f32 canvas, no atomics, the same bits on every run), then
the coordinate pass with g read per tap. dx is unrestricted here, so the
sort and not a row-band or box gather.

What bounds them: bytes. The columns are K times the input's size (644 MB
in bf16 at 2 x 208 x 336, C 256, K 9), written once by K7a and read, as
``g``, by both passes of K7b.

``launches`` (K7a) and ``launches_bwd`` (K7b) count the wrappers' calls that
launch (CPU calls do not count).
"""

from __future__ import annotations

import torch

from upsnet_torch.ops import cuda_build
from upsnet_torch.ops.deform_sample import _accum_dtype, _bilinear_zero_pad, sort_work_len
from upsnet_torch.ops.deform_shift import _image_base, _tap_nodes

launches = 0
launches_bwd = 0


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def deform_sample_mt_plain(x: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K7a: every tap's four corners summed in f32
    (f64 for f64 input), rounded once to ``x.dtype``. Returns
    (B, H, W, K, C)."""
    b, h, w, c = x.shape
    base = _image_base(b, h, w, x.device)
    flat = x.reshape(b * h * w, c)
    acc_t = _accum_dtype(x.dtype)
    taps = [_bilinear_zero_pad(flat, sy[t], sx[t], h, w, base, acc_t).to(x.dtype)
            for t in range(sy.shape[0])]
    return torch.stack(taps, dim=3)


def deform_sample_mt_bwd_plain(x: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor,
                               g: torch.Tensor):
    """Plain PyTorch version of K7b, written out over the 2 x 2 support with
    the hat weights and their derivative (autograd through the forward would
    give a one-sided derivative at integer coordinates). Returns (grad_x in
    ``x.dtype``, gsy, gsx (K, B, H, W) in ``sy.dtype``)."""
    b, h, w, c = x.shape
    k = sy.shape[0]
    acc_t = _accum_dtype(x.dtype)
    n = b * h * w
    x_flat = x.reshape(n, c)
    g_flat = g.reshape(n, k, c).to(acc_t)
    canvas = torch.zeros((n, c), dtype=acc_t, device=x.device)
    gsy = torch.zeros((k, n), dtype=acc_t, device=x.device)
    gsx = torch.zeros((k, n), dtype=acc_t, device=x.device)
    for t in range(k):
        g_t = g_flat[:, t]
        for idx, ok, vy, dvy, vx, dvx in _tap_nodes(sy[t], sx[t], b, h, w, acc_t):
            dot = (x_flat[idx].to(acc_t) * g_t).sum(-1) * ok
            gsy[t] += dvy * vx * dot
            gsx[t] += vy * dvx * dot
            canvas.index_add_(0, idx, (vy * vx * ok)[:, None] * g_t)
    return (canvas.reshape(b, h, w, c).to(x.dtype),
            gsy.reshape(k, b, h, w).to(sy.dtype), gsx.reshape(k, b, h, w).to(sx.dtype))


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _check(x, sy, sx, g=None):
    """Shapes, dtypes, devices and contiguity of one call's tensors. float64
    passes on the CPU only. Returns (K, B, H, W, C)."""
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, C), got {tuple(x.shape)}")
    if sy.dim() != 4:
        raise ValueError(f"sy must be (K, B, H, W), got {tuple(sy.shape)}")
    b, h, w, c = x.shape
    k = sy.shape[0]
    cpu = x.device.type == "cpu"
    # the plain versions also take float64, for finite-difference checks
    allowed = tuple(cuda_build.DTYPE_CODES) + ((torch.float64,) if cpu else ())
    if x.dtype not in allowed:
        raise TypeError(f"x dtype {x.dtype} not in {list(allowed)}")
    coord_dtype = torch.float64 if x.dtype == torch.float64 else torch.float32
    named = [("x", x), ("sy", sy), ("sx", sx)]
    for name, s in named[1:]:
        if s.shape != (k, b, h, w):
            raise ValueError(f"{name} must be {(k, b, h, w)}, got {tuple(s.shape)}")
        if s.dtype != coord_dtype:
            raise TypeError(f"{name} must be {coord_dtype}, got {s.dtype}")
    if g is not None:
        if g.shape != (b, h, w, k, c):
            raise ValueError(f"g must be {(b, h, w, k, c)}, got {tuple(g.shape)}")
        if g.dtype != x.dtype:
            raise TypeError(f"g must be {x.dtype}, got {g.dtype}")
        named.append(("g", g))
    for name, s in named:
        if s.device != x.device:
            raise ValueError(f"{name} on {s.device}, x on {x.device}")
        if not s.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return k, b, h, w, c


def _check_kernel(x, g, limits) -> None:
    """Off the CPU, a kernel's needs, checked before the device so that meta
    tensors reach them: C a multiple of 8 and each ``(what, n)`` of
    ``limits`` below 2^31 (the kernels' 32-bit indices and scratch); then a
    CUDA device and 16-byte aligned x and g."""
    c = x.shape[-1]
    if c % 8:
        raise ValueError(f"C={c} must be a multiple of 8")
    for what, n in limits:
        if n >= 2 ** 31:
            raise ValueError(f"{what} = {n} must be below 2^31")
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.data_ptr() % 16 or (g is not None and g.data_ptr() % 16):
        raise ValueError("x and g must be 16-byte aligned")


def deform_sample_mt(x: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor) -> torch.Tensor:
    """K7a: the bilinear samples of ``x`` at all K taps, DCNv1 zero padding.

    x (B, H, W, C) bf16/f32, unpadded; sy, sx (K, B, H, W) f32 absolute
    sample coordinates, any values. Returns the columns (B, H, W, K, C) in
    ``x.dtype``. CPU tensors take the plain version; CUDA tensors launch the
    kernel (C % 8 == 0, B*H*W*C/8 threads below 2^31, 16-byte aligned; these
    checked before the device); all three contiguous. Not differentiable by
    itself: ``DeformSampleMT`` is.
    """
    global launches
    k, b, h, w, c = _check(x, sy, sx)
    if x.device.type == "cpu":
        return deform_sample_mt_plain(x, sy, sx)
    _check_kernel(x, None, [("B*H*W*C/8 threads", b * h * w * (c // 8))])
    cols = torch.empty((b, h, w, k, c), dtype=x.dtype, device=x.device)
    cuda_build.call("deform_sample_mt", "deform_sample_mt", x, (x, sy, sx, cols),
                    (k, b, h, w, c))
    launches += 1
    return cols


def deform_sample_mt_bwd(x: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor,
                         g: torch.Tensor):
    """K7b: the backward of ``deform_sample_mt`` for upstream gradient g
    (B, H, W, K, C) in ``x.dtype``, all K taps in one call.

    Returns (grad_x (B, H, W, C) in ``x.dtype``, gsy, gsx (K, B, H, W) f32,
    exactly 0 where the coordinate is an integer). Each grad_x element is an
    f32 sum in a fixed order, rounded once: two runs give the same bits. CPU
    tensors take the plain version; CUDA tensors launch the counting-sort
    gather and the coordinate pass (C % 8 == 0, 16-byte aligned, the int32
    scratch of about 4 bytes a bin and 24 a sample below 2^31 elements;
    these checked before the device).
    """
    global launches_bwd
    k, b, h, w, c = _check(x, sy, sx, g)
    if x.device.type == "cpu":
        return deform_sample_mt_bwd_plain(x, sy, sx, g)
    n_work = sort_work_len(b, h, w, k * b * h * w)
    _check_kernel(x, g, [("the int32 scratch", n_work)])
    gx = torch.empty_like(x) if k else torch.zeros_like(x)
    gsy = torch.empty((k, b, h, w), dtype=torch.float32, device=x.device)
    gsx = torch.empty_like(gsy)
    work = torch.empty(n_work, dtype=torch.int32, device=x.device)
    cuda_build.call("deform_sample_mt_bwd", "deform_sample_mt_bwd", x,
                    (x, sy, sx, g, gx, gsy, gsx, work), (k, b, h, w, c, n_work))
    launches_bwd += 1
    return gx, gsy, gsx


class DeformSampleMT(torch.autograd.Function):
    """``deform_sample_mt`` with gradients to x, sy and sx: forward K7a,
    backward K7b (their plain versions on CPU tensors)."""

    @staticmethod
    def forward(ctx, x, sy, sx):
        ctx.save_for_backward(x, sy, sx)
        return deform_sample_mt(x, sy, sx)

    @staticmethod
    def backward(ctx, g):
        x, sy, sx = ctx.saved_tensors
        return deform_sample_mt_bwd(x, sy, sx, g.contiguous())
