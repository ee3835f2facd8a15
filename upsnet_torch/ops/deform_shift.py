"""K8a, K8b, K8c: the fused K-tap deformable sampler of the shift route, its
gradient to the projections and its gradients to the coordinates.

Counterpart of ``upsnet_tpu/ops/deform_shift_pallas.py``. ``shift_fwd`` (K8a)
replaces ``_shift_fwd``, ``shift_adjoint`` (K8b) ``_shift_adjoint`` and
``shift_offset_grads`` (K8c) ``_shift_offset_grads``; ``DeformSampleShift``
ties them into autograd as ``deform_sample_shift``'s custom VJP does, and
``shift_route_ok`` is the port's copy of the TPU route's eligibility test.

What they compute. ``y (B, H, W, K*C)`` is one matmul's output, the K tap
projections side by side along the last axis (tap t in channels
``t*C .. (t+1)*C``); ``sy, sx (K, B, H, W)`` are absolute f32 sample
coordinates. With hat weights ``v(d) = max(0, 1 - |d|)`` and DCNv1 zero
padding (a sample counts iff it lies in (-1, H) x (-1, W); rows and columns
outside the map read zero):

  * K8a: ``out[b,i,j,:] = sum_t bilinear(y[b,:,:,t*C:(t+1)*C]; sy[t,b,i,j],
    sx[t,b,i,j])``, all taps and corners in one f32 accumulator, rounded once
    to ``y.dtype``. (On the card K8a runs K1's kernel body on this layout,
    so the two give the same bits; the TPU's K1 adds the taps in bf16, so in
    bf16 the shift route and the ``pallas`` route differ by rounding on the
    TPU, by design.)
  * K8b: the gradient to ``y`` as a gather. Each source element sums, in f32
    and in a fixed order, over the output pixels whose hats reach it, and is
    written once in ``g.dtype``: no float atomics, no f32 canvas, the same
    bits on every run. ``y``'s layout is the all-tap K3's side-by-side one,
    and the shift route clips dy, so on the card K8b is the all-tap K3's
    row-band gather (``deform_sample.band_gather``).
  * K8c: ``gsy, gsx (K, B, H, W)`` f32 with ``dv/dd = -sign(d)`` on
    ``|d| < 1`` and 0 elsewhere, so both are exactly 0 at an integer
    coordinate, as in K3.

On the TPU all three hold a halo window of zero-padded rows and 128-padded
columns in VMEM and loop over static (row candidate, column shift) pairs;
on the card a thread reads any address, so the port takes the unpadded
``y``, and K8b returns the gradient to the unpadded ``y``. What is left of
the window is K8b's reach: the row-band gather looks for contributing
output pixels within ``reach_y`` rows of a source element, so its callers
must pass coordinates with ``|sy - i| <= reach_y`` and ``|sx - j| <=
reach_x`` at every counted sample (the TPU kernels give zero beyond their
window instead). ``ops.deform_conv.deform_conv2d_shift`` clips the offsets
first, so on the model's path the two agree.

What bounds them: bytes. ``y`` is K*C values per pixel (2304 B in bf16 at
K 9, C 128), read once by K8a and K8c and written once by K8b.

``launches`` (K8a), ``launches_adjoint`` and ``launches_offset_grads`` count
the kernel launches (CPU calls do not count).
"""

from __future__ import annotations

import torch

from upsnet_torch.ops import cuda_build
from upsnet_torch.ops.recompute import sampled
from upsnet_torch.ops.deform_sample import (
    _accum_dtype, _bilinear_zero_pad, _hat_nodes, _round_up, band_gather, check_band,
    check_reach)

launches = 0
launches_adjoint = 0
launches_offset_grads = 0


# ---------------------------------------------------------------------------
# eligibility of the TPU route
# ---------------------------------------------------------------------------


def _pick_rb(h: int) -> int | None:
    for cand in (16, 8):
        if h % cand == 0:
            return cand
    return None


def shift_route_ok(shape, cout: int, max_dy: int, max_dx: int, dilation: int,
                   k: int = 9) -> bool:
    """Whether the JAX package on a TPU takes its shift kernel for an input
    of ``shape`` (B, H, W, Cin): the arithmetic of its ``shift_route_ok``
    without the backend test. The card's kernels have no such limits;
    ``deform_conv2d(impl="shift")`` asks so that each layer computes what the
    JAX package computes for it (both axes clipped where this is true, the
    ``pallas`` route's dy clip where it is not)."""
    _, h, w, _ = shape
    if cout % 128 != 0 or _pick_rb(h) is None:
        return False
    r = max_dy + dilation
    pad_l = max_dx + dilation + 2
    hpad = _round_up(h + 2 * (r + 2), _pick_rb(h))
    if _pick_rb(hpad) is None:
        return False
    rb = 16 if h % 16 == 0 else 8
    wp = _round_up(w + 2 * pad_l, 128)
    win_rows = rb + 2 * r + 2
    # the TPU forward's VMEM: the window of all k taps, the f32 accumulator
    # and the output block, in bf16
    vmem = win_rows * wp * k * cout * 2 + rb * w * cout * 4 + rb * w * cout * 2
    return vmem < 56 * 1024 * 1024


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _taps(y: torch.Tensor, k: int):
    """y (B, H, W, K*C) -> K views (B*H*W, C), one per tap."""
    b, h, w, kc = y.shape
    return y.reshape(b * h * w, k, kc // k).unbind(1)


def _image_base(b: int, h: int, w: int, device) -> torch.Tensor:
    return (torch.arange(b, device=device) * (h * w))[:, None, None]


def shift_fwd_plain(y: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K8a: f32 (f64 for f64 input) accumulation
    over taps and corners, one rounding to ``y.dtype``."""
    b, h, w, kc = y.shape
    k = sy.shape[0]
    base = _image_base(b, h, w, y.device)
    acc_t = _accum_dtype(y.dtype)
    acc = torch.zeros((b, h, w, kc // k), dtype=acc_t, device=y.device)
    for t, y_t in enumerate(_taps(y, k)):
        acc += _bilinear_zero_pad(y_t, sy[t], sx[t], h, w, base, acc_t)
    return acc.to(y.dtype)


def _tap_nodes(sy_t, sx_t, b: int, h: int, w: int, acc_t):
    """The 2 x 2 support of one tap's samples, flattened over (B, H, W):
    yields (flat source index, ok, vy, dvy, vx, dvx) per node pair, with
    ``ok`` the inside mask times the node lying in the map."""
    n = b * h * w
    inside = ((sy_t > -1.0) & (sy_t < h) & (sx_t > -1.0) & (sx_t < w)).reshape(n)
    base = _image_base(b, h, w, sy_t.device).expand(b, h, w).reshape(n)
    sy_f, sx_f = sy_t.reshape(n).to(acc_t), sx_t.reshape(n).to(acc_t)
    for yy, vy, dvy in _hat_nodes(sy_f, "pallas"):
        for xx, vx, dvx in _hat_nodes(sx_f, "pallas"):
            ok = (inside & (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)).to(acc_t)
            idx = base + yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)
            yield idx, ok, vy, dvy, vx, dvx


def shift_adjoint_plain(g: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K8b, written as the scatter it is the
    adjoint of: per tap and node, ``index_add_`` of weight * g into an f32
    (f64) canvas, cast once to ``g.dtype``. Returns (B, H, W, K*C)."""
    b, h, w, c = g.shape
    k = sy.shape[0]
    acc_t = _accum_dtype(g.dtype)
    n = b * h * w
    g_flat = g.reshape(n, c).to(acc_t)
    canvas = torch.zeros((k, n, c), dtype=acc_t, device=g.device)
    for t in range(k):
        for idx, ok, vy, _, vx, _ in _tap_nodes(sy[t], sx[t], b, h, w, acc_t):
            canvas[t].index_add_(0, idx, (vy * vx * ok)[:, None] * g_flat)
    return canvas.permute(1, 0, 2).reshape(b, h, w, k * c).to(g.dtype)


def shift_offset_grads_plain(y: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor,
                             g: torch.Tensor):
    """Plain PyTorch version of K8c, written out over the 2 x 2 support with
    the hat weights and their derivative (autograd through the forward would
    give a one-sided derivative at integer coordinates). Returns
    (gsy, gsx), each (K, B, H, W) in ``sy.dtype``."""
    b, h, w, c = g.shape
    k = sy.shape[0]
    acc_t = _accum_dtype(y.dtype)
    n = b * h * w
    g_flat = g.reshape(n, c).to(acc_t)
    gsy = torch.zeros((k, n), dtype=acc_t, device=y.device)
    gsx = torch.zeros((k, n), dtype=acc_t, device=y.device)
    for t, y_t in enumerate(_taps(y, k)):
        for idx, ok, vy, dvy, vx, dvx in _tap_nodes(sy[t], sx[t], b, h, w, acc_t):
            dot = (y_t[idx].to(acc_t) * g_flat).sum(-1) * ok
            gsy[t] += dvy * vx * dot
            gsx[t] += vy * dvx * dot
    return (gsy.reshape(k, b, h, w).to(sy.dtype), gsx.reshape(k, b, h, w).to(sx.dtype))


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _check(sy, sx, y=None, g=None):
    """Shapes, dtypes and devices of one call's tensors (``y`` and ``g``
    where the call has them); on CUDA also the kernels' layout needs.
    float64 passes on the CPU only. Returns (K, B, H, W, C)."""
    if sy.dim() != 4:
        raise ValueError(f"sy must be (K, B, H, W), got {tuple(sy.shape)}")
    k, b, h, w = sy.shape
    lead = y if y is not None else g
    cpu = lead.device.type == "cpu"
    # the plain versions also take float64, for finite-difference checks
    allowed = tuple(cuda_build.DTYPE_CODES) + ((torch.float64,) if cpu else ())
    if lead.dtype not in allowed:
        raise TypeError(f"dtype {lead.dtype} not in {list(allowed)}")
    coord_dtype = torch.float64 if lead.dtype == torch.float64 else torch.float32
    named = [("sy", sy), ("sx", sx)]
    for name, s in named:
        if s.shape != (k, b, h, w):
            raise ValueError(f"{name} must be {(k, b, h, w)}, got {tuple(s.shape)}")
        if s.dtype != coord_dtype:
            raise TypeError(f"{name} must be {coord_dtype}, got {s.dtype}")
    if y is not None:
        if y.dim() != 4 or y.shape[:3] != (b, h, w) or y.shape[3] % k:
            raise ValueError(f"y must be ({b}, {h}, {w}, {k}*C), got {tuple(y.shape)}")
        named.append(("y", y))
    c = y.shape[3] // k if y is not None else g.shape[-1]
    if g is not None:
        if g.shape != (b, h, w, c):
            raise ValueError(f"g must be {(b, h, w, c)}, got {tuple(g.shape)}")
        if g.dtype != lead.dtype:
            raise TypeError(f"g must be {lead.dtype}, got {g.dtype}")
        named.append(("g", g))
    for name, s in named:
        if s.device != lead.device:
            raise ValueError(f"{name} on {s.device}, expected {lead.device}")
    if cpu:
        return k, b, h, w, c
    if lead.device.type != "cuda":
        raise ValueError(f"unsupported device {lead.device}")
    if c % 8:
        raise ValueError(f"C={c} must be a multiple of 8")
    for name, s in named:
        if not s.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name in ("y", "g") and s.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    return k, b, h, w, c


def shift_fwd(y: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor) -> torch.Tensor:
    """K8a: sum over the K taps of the bilinear samples of each tap's block
    of ``y``, DCNv1 zero padding.

    y (B, H, W, K*C) bf16/f32, unpadded, tap-major along the last axis; sy,
    sx (K, B, H, W) f32 absolute sample coordinates, any values. Returns
    (B, H, W, C) in ``y.dtype``. CPU tensors take the plain version; CUDA
    tensors launch the kernel (C % 8 == 0, contiguous, 16-byte aligned),
    which runs K1's body (``sample_taps_pixel``) on this side-by-side layout
    and so gives ``deform_sample9(y.view(B, H, W, K, C), sy, sx)``'s bits.
    Not differentiable by itself: ``DeformSampleShift`` is.
    """
    global launches
    k, b, h, w, c = _check(sy, sx, y=y)
    if y.device.type == "cpu":
        return shift_fwd_plain(y, sy, sx)
    out = torch.empty((b, h, w, c), dtype=y.dtype, device=y.device)
    cuda_build.call("deform_shift", "shift_fwd", y, (y, sy, sx, out), (k, b, h, w, c))
    launches += 1
    return out


def shift_adjoint(g: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor,
                  reach_y: int, reach_x: int) -> torch.Tensor:
    """K8b: the gradient of ``shift_fwd`` to ``y`` for upstream gradient g.

    g (B, H, W, C) bf16/f32; sy, sx (K, B, H, W) f32. Returns (B, H, W, K*C)
    in ``g.dtype``, every element an f32 sum in a fixed order, written once:
    two calls give the same bits. Callers must pass coordinates with
    ``|sy - i| <= reach_y`` and ``|sx - j| <= reach_x`` at every counted
    sample of pixel (i, j) (``max_dy + dilation`` / ``max_dx + dilation``
    after ``deform_conv2d_shift``'s clip). CPU tensors take the plain
    version, which checks that bound; CUDA tensors launch the all-tap K3's
    row-band gather on the side-by-side layout, which looks no further than
    ``reach_y`` rows (a contribution from beyond would be dropped without
    notice) and refuses (ValueError) B * K above 65535 or a band that does
    not fit shared memory (W > 3058 at reach 7).
    """
    global launches_adjoint
    k, b, h, w, c = _check(sy, sx, g=g)
    if reach_y < 0 or reach_x < 0:
        raise ValueError(f"reach must be >= 0, got ({reach_y}, {reach_x})")
    if g.device.type == "cpu":
        check_reach(sy, sx, reach_y, reach_x)
        return shift_adjoint_plain(g, sy, sx)
    check_band(b * k, w, reach_y)
    gy = torch.empty((b, h, w, k * c), dtype=g.dtype, device=g.device)
    band_gather(g, sy, sx, gy, k, reach_y)
    launches_adjoint += 1
    return gy


def shift_offset_grads(y: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor,
                       g: torch.Tensor):
    """K8c: the gradients of ``shift_fwd`` to ``sy`` and ``sx`` for upstream
    gradient g (B, H, W, C) in ``y.dtype``. Returns (gsy, gsx), each
    (K, B, H, W) f32, exactly 0 where the coordinate is an integer. CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    global launches_offset_grads
    k, b, h, w, c = _check(sy, sx, y=y, g=g)
    if y.device.type == "cpu":
        return shift_offset_grads_plain(y, sy, sx, g)
    gsy = torch.empty((k, b, h, w), dtype=torch.float32, device=y.device)
    gsx = torch.empty_like(gsy)
    cuda_build.call("deform_shift", "shift_offset_grads", y, (y, sy, sx, g, gsy, gsx),
                    (k, b, h, w, c))
    launches_offset_grads += 1
    return gsy, gsx


class DeformSampleShift(torch.autograd.Function):
    """``shift_fwd`` with gradients to y, sy and sx: forward K8a, backward
    K8b + K8c (their plain versions on CPU tensors). ``reach_y``, ``reach_x``
    bound the coordinates as ``shift_adjoint`` requires."""

    @staticmethod
    def forward(ctx, y, sy, sx, reach_y: int, reach_x: int):
        ctx.save_for_backward(y, sy, sx)
        ctx.reach = (reach_y, reach_x)
        return sampled(lambda: shift_fwd(y, sy, sx))

    @staticmethod
    def backward(ctx, g):
        y, sy, sx = ctx.saved_tensors
        g = g.contiguous()
        gy = shift_adjoint(g, sy, sx, *ctx.reach)
        gsy, gsx = shift_offset_grads(y, sy, sx, g)
        return gy, gsy, gsx, None, None
