"""K1, K2, K3, K6: deformable bilinear sampling of a layer's tap
projections and its backward, and the routing rule of the ``pallas`` route.

Every form takes the K tap projections side by side, (B, H, W, K, C), the
output of the one (N, Cin) x (Cin, K·C) matmul of
``side_by_side_projections``, which every route builds, and reads it in
place, and the coordinates as (K, B, H, W) f32.

K1 (``deform_sample9``), the inference sampler, sums all taps in one launch
in f32. K2 (``deform_sample_taps``), the training forward, samples all taps
in one launch and rounds each tap and adds it in the projection's dtype in
tap order, as the JAX training form does. K3 is its backward in two forms:
``deform_sample_bwd_taps`` where dy is clipped and
``deform_sample_bwd_unclipped`` where nothing is (``DeformSampleTaps``:
forward K2, backward the one or the other). K6 (``deform_sample_tiled_taps``)
is the sampler of the column-tiled form that the JAX package takes on wide
maps, where ``pallas_route`` answers ``tiled`` (``DeformSampleTiled``, with
the clipped K3 as backward). K2, K3 and K6 are described above their
wrappers below.

K1 replaces the TPU kernel ``upsnet_tpu/ops/deform_conv_pallas.py:
_sample_pallas9`` (kernel body ``_sample9_kernel``), the inference DCN
sampler: given the per-tap projections ``y9[..., t, :] = x @ W_t`` and
per-tap f32 sample coordinates, it returns ``sum_t bilinear(y_t; sy9[t],
sx9[t])`` with DCNv1 zero padding — a sample counts iff it lies in (-1, H) x
(-1, W), and corners outside the map read zero.

On the TPU the kernel DMAs a halo window of padded rows per row block and
turns the sampling into hat-matrix matmuls, because VMEM is large and
gathers are slow there; it therefore needs a +-max_dy window, 128-column
padding and 9 tap steps with bf16 adds. On the H100 none of that applies:
a thread reads any coordinate directly. ``csrc/deform_sample.cu`` runs one
thread per (output pixel, 8-channel group), makes one 16-byte load per
corner along contiguous channels, issues a tap's four corner loads before
it adds any and loads the next tap's coordinates meanwhile, loops over the
taps and the 4 corners with an f32 accumulator and rounds once at the end.

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

The one-tap plain versions ``deform_sample_plain``,
``deform_sample_bwd_plain`` and ``deform_sample_tiled_plain`` stand for the
JAX kernels sampled one tap at a time (``_sample_pallas``,
``_sample_pallas_bwd``, ``_sample_pallas_tiled``); the all-tap plain
versions chain them.

``launches`` counts K1's kernel launches, ``launches_taps`` K2's,
``launches_bwd_taps`` and ``launches_bwd_unclipped`` K3's, clipped and not
(two per call: one per pass), and ``launches_tiled_taps`` K6's (CPU calls
do not count).
"""

from __future__ import annotations

import torch

from upsnet_torch.ops import cuda_build
from upsnet_torch.ops.recompute import sampled

launches = 0
launches_taps = 0
launches_bwd_taps = 0
launches_bwd_unclipped = 0
launches_tiled_taps = 0

SHARED_BYTES = 232448  # shared memory a block can use on the H100


def _bilinear_zero_pad(flat, y, x, h: int, w: int, base=None, acc=torch.float32):
    """DCNv1 bilinear sample with zero padding, result in ``acc`` (f32).

    flat: (N, C) feature rows; y, x: f32 coords of any shape S; base: int64
    row offset broadcast against S (the image's first row), or None.
    Returns (*S, C) in ``acc``.
    """
    inside = (y > -1.0) & (y < h) & (x > -1.0) & (x < w)
    y_low = torch.floor(y)
    x_low = torch.floor(x)
    ly = y - y_low
    lx = x - x_low
    yl = y_low.to(torch.int64)
    xl = x_low.to(torch.int64)
    out = torch.zeros((*y.shape, flat.shape[-1]), dtype=acc, device=flat.device)
    for yy, xx, wgt in ((yl, xl, (1 - ly) * (1 - lx)),
                        (yl, xl + 1, (1 - ly) * lx),
                        (yl + 1, xl, ly * (1 - lx)),
                        (yl + 1, xl + 1, ly * lx)):
        ok = inside & (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        idx = yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)
        if base is not None:
            idx = idx + base
        vals = flat[idx.reshape(-1)].reshape(out.shape).to(acc)
        out += vals * (wgt * ok)[..., None]
    return out


def deform_sample9_plain(y9: torch.Tensor, sy9: torch.Tensor, sx9: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K1: same math, f32 accumulation over taps
    and corners in tap and corner order, one rounding to ``y9.dtype`` at the
    end; y9 (B, H, W, T, C)."""
    b, h, w, t_n, c = y9.shape
    base = (torch.arange(b, device=y9.device) * (h * w))[:, None, None]
    acc = torch.zeros((b, h, w, c), dtype=torch.float32, device=y9.device)
    for t in range(t_n):
        acc += _bilinear_zero_pad(y9[:, :, :, t].reshape(b * h * w, c), sy9[t], sx9[t], h, w,
                                  base)
    return acc.to(y9.dtype)


def _check(y9, sy9, sx9):
    if y9.dim() != 5:
        raise ValueError(f"y9 must be (B, H, W, T, C), got {tuple(y9.shape)}")
    if y9.dtype not in cuda_build.DTYPE_CODES:
        raise TypeError(f"y9 dtype {y9.dtype} not in {list(cuda_build.DTYPE_CODES)}")
    b, h, w, t_n = y9.shape[:4]
    for name, s in (("sy9", sy9), ("sx9", sx9)):
        if s.shape != (t_n, b, h, w):
            raise ValueError(f"{name} must be {(t_n, b, h, w)}, got {tuple(s.shape)}")
        if s.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {s.dtype}")
        if s.device != y9.device:
            raise ValueError(f"{name} on {s.device}, y9 on {y9.device}")


def deform_sample9(y9: torch.Tensor, sy9: torch.Tensor, sx9: torch.Tensor) -> torch.Tensor:
    """Σ_t bilinear(y_t; sy9[t], sx9[t]) with DCNv1 zero padding.

    y9 (B, H, W, T, C) bf16/f32 unpadded tap projections side by side
    (``side_by_side_projections``); sy9, sx9 (T, B, H, W) f32 absolute
    sample coordinates. Returns (B, H, W, C) in ``y9.dtype``. CPU tensors
    take the plain version; CUDA tensors launch the kernel (C % 8 == 0,
    contiguous, 16-byte aligned).
    """
    global launches
    _check(y9, sy9, sx9)
    if y9.device.type == "cpu":
        return deform_sample9_plain(y9, sy9, sx9)
    if y9.device.type != "cuda":
        raise ValueError(f"unsupported device {y9.device}")
    t_n, b, h, w = sy9.shape
    c = y9.shape[-1]
    if c % 8:
        raise ValueError(f"C={c} must be a multiple of 8")
    for name, s in (("y9", y9), ("sy9", sy9), ("sx9", sx9)):
        if not s.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if y9.data_ptr() % 16:
        raise ValueError("y9 must be 16-byte aligned")
    out = torch.empty((b, h, w, c), dtype=y9.dtype, device=y9.device)
    cuda_build.call("deform_sample", "deform_sample9", y9, (y9, sy9, sx9, out),
                    (t_n, b, h, w, c))
    launches += 1
    return out


# ---------------------------------------------------------------------------
# K2 and K3: the training pair
# ---------------------------------------------------------------------------
#
# K2 replaces the TPU kernel ``deform_conv_pallas.py:_sample_pallas``
# (``_sample_kernel``) and K3 ``_sample_pallas_bwd`` (``_sample_bwd_kernel``).
# The JAX training form samples tap by tap and adds each tap's output in
# ``y.dtype`` in tap order. On the TPU both kernels work on zero-padded rows
# inside a +-max_dy window and K3 read-modify-writes a window of an f32
# canvas per sequential grid step. On the card a thread reads any coordinate
# of the unpadded map, and the kernels read and write the side-by-side tap
# projections (B, H, W, K, C) in place through their strides. K2
# (``csrc/deform_sample.cu``) runs the whole chain in one launch: a thread
# owns (pixel, 8 channels), rounds each tap's f32 sum to ``y.dtype`` and
# adds it to the running value in f32 with one more rounding, which is what
# a bf16 add on the card computes, so its output equals the nine per-tap
# samples and eight adds that it replaces. K3 takes two forms
# (``csrc/deform_sample_bwd.cu``). Both gather: each grad_y element is an
# f32 sum over its samples in a fixed order, written once in ``y.dtype``,
# so two runs give the same bits, as the TPU kernel's sequential
# read-modify-write does; no canvas, no zero fill, no cast, no float
# atomics, no copy of the taps. A second launch computes the coordinate
# gradients of all taps (K8c's kernel at the side-by-side strides).
#
#   * dy clipped (``deform_sample_bwd_taps``: ``pallas``, ``mxu``, the tiled
#     form, ``shift``'s fallback levels, and K8b): every counted sample lies
#     within ``reach_y`` rows of its pixel, so a block owns a band of grad_y
#     rows, buckets the samples of the output rows that can reach it by
#     column and gathers each column's buckets. A sample beyond the reach
#     gets no gradient to y there; the plain version raises on one, as K6's
#     does.
#   * nothing clipped (``deform_sample_bwd_unclipped``: ``auto``,
#     ``gather``): samples may lie anywhere, so a counting sort of all
#     samples by their low corner pixel, per tap and image, in device memory
#     (integer histogram, scan, placement, a rank pass that orders each bin),
#     then a thread per (source pixel, 16 channels) gathers its 2 x 2 bins.
#
# What bounds them: bytes. K2 reads the touched rows of y and the
# coordinates and writes the output once a layer; K3 reads y, g
# and the coordinates and writes grad_y and the two coordinate gradients.
# About 9 flops per element and corner.
#
# The coordinate derivative is that of the JAX function the caller's route
# stands for, one of three rules (``RULES``) that differ only where a
# coordinate is an integer. With the hat weight v(d) = max(0, 1 - |d|) of a
# node at distance d:
#
#   * ``pallas``, the Pallas backward kernels (the untiled and tiled
#     ``pallas`` routes, ``shift``, ``mt``): dv/dd = -sign(d) where |d| < 1,
#     else 0, so gsy = gsx = 0 at an integer coordinate (the peak has d = 0,
#     its neighbours |d| = 1);
#   * ``hat``, autodiff of max(0, 1 - |d|) as ``deform_conv2d_mxu`` writes it
#     (``mxu``, and ``pallas`` where ``pallas_route`` answers ``mxu``): at an
#     integer r, abs' is +1 at 0 and each maximum's tie takes half, so per
#     axis 0.5 v[r + 1] - v[r] - 0.5 v[r - 1];
#   * ``floor``, autodiff of the floor-based corner weights of
#     ``deform_conv2d_batched`` (``gather``; ``auto`` where an offset lies
#     beyond the window): per axis v[r + 1] - v[r], one-sided.
#
# ``auto`` under training passes a device flag (``fast``), the JAX cond's
# predicate: where it is False the coordinate pass takes ``floor`` instead of
# its rule, read on the device, with no host sync. The forward and grad_y are
# the same under every rule.

RULES = {"pallas": 0, "hat": 1, "floor": 2}  # the kernels' codes


def _accum_dtype(dtype):
    return torch.float64 if dtype == torch.float64 else torch.float32


def deform_sample_plain(y: torch.Tensor, sy: torch.Tensor,
                        sx: torch.Tensor) -> torch.Tensor:
    """One tap of K2's plain version, the JAX package's ``_sample_pallas``:
    y (B, H, W, C), accumulated in f32 (f64 for f64 input), rounded once to
    ``y.dtype``."""
    b, h, w, c = y.shape
    base = (torch.arange(b, device=y.device) * (h * w))[:, None, None]
    return _bilinear_zero_pad(y.reshape(b * h * w, c), sy, sx, h, w, base,
                              _accum_dtype(y.dtype)).to(y.dtype)


def _hat_nodes(s: torch.Tensor, rule: str):
    """The nodes a coordinate's hat weighs on under ``rule``: ((index, v,
    dv), ...) with v = max(0, 1 - |d|) and dv as ``rule`` says: the low
    node, the high one, and under ``hat`` the node below the low one, which
    has v = 0 and dv = -0.5 at an integer coordinate, else 0."""
    low = torch.floor(s)
    frac = s - low
    idx = low.to(torch.int64)
    if rule == "floor":
        one = torch.ones_like(s)
        return ((idx, 1 - frac, -one), (idx + 1, frac, one))
    moved = (frac > 0).to(s.dtype)  # 0 at an integer coordinate
    if rule == "pallas":
        return ((idx, 1 - frac, -moved), (idx + 1, frac, moved))
    if rule == "hat":
        return ((idx, 1 - frac, -torch.ones_like(s)), (idx + 1, frac, 1 - 0.5 * (1 - moved)),
                (idx - 1, torch.zeros_like(s), -0.5 * (1 - moved)))
    raise ValueError(f"rule {rule!r} not in {list(RULES)}")


def resolve_rule(rule: str, fast: torch.Tensor | None) -> str:
    """The rule a plain version takes: ``rule``, or ``floor`` where the flag
    ``fast`` (a one-element bool tensor, None: no flag) is False. Reads the
    flag on the host, which syncs a CUDA flag: the kernels read it on the
    device instead."""
    if rule not in RULES:
        raise ValueError(f"rule {rule!r} not in {list(RULES)}")
    return rule if fast is None or bool(fast) else "floor"


def deform_sample_bwd_plain(y: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor,
                            g: torch.Tensor, rule: str = "pallas"):
    """One tap of K3's plain version, the JAX package's
    ``_sample_pallas_bwd`` under the ``pallas`` rule: y, g (B, H, W, C),
    written out over the nodes of each coordinate with the hat weights and
    their derivative under ``rule`` (``RULES``). Returns (grad_y in
    ``y.dtype``, gsy, gsx in ``sy.dtype``); grad_y is the same under every
    rule."""
    b, h, w, c = y.shape
    acc = _accum_dtype(y.dtype)
    n = b * h * w
    inside = ((sy > -1.0) & (sy < h) & (sx > -1.0) & (sx < w)).reshape(n)
    base = (torch.arange(b, device=y.device) * (h * w))[:, None, None].expand(b, h, w)
    base = base.reshape(n)
    y_flat = y.reshape(n, c)
    g_flat = g.reshape(n, c).to(acc)
    canvas = torch.zeros((n, c), dtype=acc, device=y.device)
    gsy = torch.zeros(n, dtype=acc, device=y.device)
    gsx = torch.zeros(n, dtype=acc, device=y.device)
    sy_f, sx_f = sy.reshape(n).to(acc), sx.reshape(n).to(acc)
    nodes_x = _hat_nodes(sx_f, rule)
    for i, (yy, vy, dvy) in enumerate(_hat_nodes(sy_f, rule)):
        for j, (xx, vx, dvx) in enumerate(nodes_x):
            if i == 2 and j == 2:  # v = 0 at both: no weight of any kind
                continue
            ok = (inside & (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)).to(acc)
            idx = base + yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)
            dot = (y_flat[idx].to(acc) * g_flat).sum(-1) * ok
            gsy += dvy * vx * dot
            gsx += vy * dvx * dot
            if i < 2 and j < 2:  # the node below the low one has v = 0
                canvas.index_add_(0, idx, (vy * vx * ok)[:, None] * g_flat)
    return (canvas.reshape(b, h, w, c).to(y.dtype),
            gsy.reshape(b, h, w).to(sy.dtype), gsx.reshape(b, h, w).to(sx.dtype))


def _check_tap(y, sy, sx, g=None):
    """Shapes, dtypes and devices of one tap's tensors (y a tap's view of a
    whole projection, whose contiguity the caller checks); off the CPU also
    the kernel's layout needs, then the device, which must be CUDA. float64
    passes on the CPU only."""
    if y.dim() != 4:
        raise ValueError(f"y must be (B, H, W, C), got {tuple(y.shape)}")
    cpu = y.device.type == "cpu"
    # the plain versions also take float64, for finite-difference checks
    allowed = tuple(cuda_build.DTYPE_CODES) + ((torch.float64,) if cpu else ())
    if y.dtype not in allowed:
        raise TypeError(f"y dtype {y.dtype} not in {list(allowed)}")
    coord_dtype = torch.float64 if y.dtype == torch.float64 else torch.float32
    b, h, w, c = y.shape
    named = [("y", y), ("sy", sy), ("sx", sx)]
    for name, s in named[1:]:
        if s.shape != (b, h, w):
            raise ValueError(f"{name} must be {(b, h, w)}, got {tuple(s.shape)}")
        if s.dtype != coord_dtype:
            raise TypeError(f"{name} must be {coord_dtype}, got {s.dtype}")
    if g is not None:
        if g.shape != y.shape:
            raise ValueError(f"g must be {tuple(y.shape)}, got {tuple(g.shape)}")
        if g.dtype != y.dtype:
            raise TypeError(f"g must be {y.dtype}, got {g.dtype}")
        named.append(("g", g))
    for name, s in named:
        if s.device != y.device:
            raise ValueError(f"{name} on {s.device}, y on {y.device}")
    if cpu:
        return
    if c % 8:
        raise ValueError(f"C={c} must be a multiple of 8")
    if y.data_ptr() % 16 or (g is not None and g.data_ptr() % 16):
        raise ValueError("y and g must be 16-byte aligned")
    if y.device.type != "cuda":
        raise ValueError(f"unsupported device {y.device}")


def deform_sample_taps_plain(y: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K2: ``deform_sample_plain`` on each tap of y
    (B, H, W, K, C), the results added in ``y.dtype`` in tap order."""
    out = None
    for t in range(y.shape[3]):
        tap = deform_sample_plain(y[:, :, :, t], sy[t], sx[t])
        out = tap if out is None else out + tap
    return out


def deform_sample_taps(y: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor) -> torch.Tensor:
    """K2: ``sum_t bilinear(y_t; sy[t], sx[t])`` for all K taps of a layer,
    with each tap rounded to ``y.dtype`` and added in it in tap order, as
    the JAX package's training form adds them.

    y (B, H, W, K, C) bf16/f32 tap projections side by side
    (``side_by_side_projections``); sy, sx (K, B, H, W) f32 absolute sample
    coordinates, any values; all three contiguous. Returns (B, H, W, C) in
    ``y.dtype``, the values of ``deform_sample_taps_plain``'s chain up to
    the f32 summation order inside a tap. CPU tensors take the plain
    version; CUDA tensors launch the kernel (C % 8 == 0, y 16-byte aligned).
    Not differentiable by itself: ``DeformSampleTaps`` is.
    """
    global launches_taps
    k = _check_taps(y, sy, sx, None, contiguous_on_cpu=True)
    if y.device.type == "cpu":
        return deform_sample_taps_plain(y, sy, sx)
    b, h, w, _, c = y.shape
    out = torch.empty((b, h, w, c), dtype=y.dtype, device=y.device)
    cuda_build.call("deform_sample", "deform_sample_taps", y, (y, sy, sx, out),
                    (k, b, h, w, c))
    launches_taps += 1
    return out


def deform_sample_bwd_taps_plain(y: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor,
                                 g: torch.Tensor, reach_y: int | None, rule: str = "pallas",
                                 fast: torch.Tensor | None = None):
    """Plain PyTorch version of both K3 forms: the reach check (none for
    ``reach_y`` None, the unclipped form), then ``deform_sample_bwd_plain``
    on each tap of y (B, H, W, K, C) under ``resolve_rule(rule, fast)``.
    Returns (grad_y in y's layout and dtype, gsy, gsx (K, B, H, W))."""
    if reach_y is not None:
        check_reach(sy, sx, reach_y, None)
    rule = resolve_rule(rule, fast)
    gy = torch.empty_like(y)
    gsy, gsx = torch.empty_like(sy), torch.empty_like(sx)
    for t in range(y.shape[3]):
        gy[:, :, :, t], gsy[t], gsx[t] = deform_sample_bwd_plain(
            y[:, :, :, t], sy[t], sx[t], g, rule)
    return gy, gsy, gsx


def deform_sample_bwd_taps(y: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor,
                           g: torch.Tensor, reach_y: int, rule: str = "pallas"):
    """K3 where dy is clipped: the backward of ``deform_sample_taps`` (up to
    its per-tap rounding) for upstream gradient g.

    y (B, H, W, K, C) the tap projections side by side; sy, sx (K, B, H, W)
    f32 with ``|sy - i| <= reach_y`` at every counted sample of pixel
    (i, j); g (B, H, W, C) in y's dtype; ``rule`` the coordinate derivative
    (``RULES``). Returns (grad_y (B, H, W, K, C) in y's dtype, gsy, gsx
    (K, B, H, W) f32). Each grad_y element is an f32 sum in a fixed order,
    rounded once: two runs give the same bits. CPU tensors take the plain
    version, which raises on a sample beyond the reach; CUDA tensors launch
    the two kernels (C % 8 == 0, all contiguous, 16-byte aligned,
    B * K <= 65535, a band's scanned rows within shared memory: W <= 3058
    at reach 7), which give such a sample no gradient to y.
    """
    global launches_bwd_taps
    if reach_y < 0:
        raise ValueError(f"reach_y must be >= 0, got {reach_y}")
    k = _check_taps(y, sy, sx, g)
    _check_rule(rule, None, y.device)
    if y.device.type == "cpu":
        return deform_sample_bwd_taps_plain(y, sy, sx, g, reach_y, rule)
    b, h, w, c = g.shape
    check_band(b * k, w, reach_y)
    gy = torch.empty_like(y)
    gsy, gsx = torch.empty_like(sy), torch.empty_like(sx)
    band_gather(g, sy, sx, gy, k, reach_y)
    coord_pass(y, sy, sx, g, gsy, gsx, k, rule)
    launches_bwd_taps += 2
    return gy, gsy, gsx


def _check_rule(rule: str, fast: torch.Tensor | None, device: torch.device) -> None:
    """A rule of ``RULES`` and a flag that is None or one bool on ``device``."""
    if rule not in RULES:
        raise ValueError(f"rule {rule!r} not in {list(RULES)}")
    if fast is not None and (fast.dtype != torch.bool or fast.numel() != 1
                             or fast.device != device):
        raise ValueError(f"fast must be one bool on {device}, got {fast.dtype} "
                         f"{tuple(fast.shape)} on {fast.device}")


def _check_taps(y, sy, sx, g, contiguous_on_cpu: bool = False) -> int:
    """Shapes, dtypes and devices of an all-tap call: y (B, H, W, K, C) with
    K >= 1, sy and sx (K, B, H, W), g (B, H, W, C) or None (a forward); on
    CUDA, and with ``contiguous_on_cpu`` on every device, all contiguous.
    Returns K."""
    if y.dim() != 5:
        raise ValueError(f"y must be (B, H, W, K, C), got {tuple(y.shape)}")
    k = y.shape[3]
    if k < 1:
        raise ValueError(f"y has no taps: {tuple(y.shape)}")
    if sy.dim() != 4 or sy.shape[0] != k:
        raise ValueError(f"sy must be (K={k}, B, H, W), got {tuple(sy.shape)}")
    # the shape, dtype and device rules of one tap; y itself must be whole
    _check_tap(y[:, :, :, 0], sy[0], sx[0], g)
    if sx.shape != sy.shape:
        raise ValueError(f"sx must be {tuple(sy.shape)}, got {tuple(sx.shape)}")
    if contiguous_on_cpu or y.device.type != "cpu":
        for name, s in (("y", y), ("sy", sy), ("sx", sx), ("g", g)):
            if s is not None and not s.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
    return k


def check_band(planes: int, w: int, reach_y: int) -> None:
    """Raise unless the row-band gather takes ``planes`` (B * K) tap maps
    ``w`` wide at ``reach_y``: a grid dimension of at most 65535, and a
    band's bucket bounds and scanned rows within a block's shared memory."""
    if planes > 65535:
        raise ValueError(f"B*K={planes} exceeds the grid's 65535")
    if (2 * w + 3) * 4 + (2 * reach_y + 3) * w * 4 > SHARED_BYTES:
        raise ValueError(f"a band of W={w} at reach {reach_y} does not fit shared memory")


def band_gather(g, sy, sx, gy, k: int, reach_y: int) -> None:
    """Launch the row-band gather: grad_y of all K taps into ``gy``
    (B, H, W, K, C) from CUDA tensors that ``_check_taps`` and
    ``check_band`` passed."""
    b, h, w, c = g.shape
    cuda_build.call("deform_sample_bwd", "deform_sample_bwd_taps_grad_y", g, (g, sy, sx, gy),
                    (k, b, h, w, c, reach_y))


def coord_pass(y, sy, sx, g, gsy, gsx, k: int, rule: str = "pallas",
               fast: torch.Tensor | None = None) -> None:
    """Launch the coordinate pass of both K3 forms (``offset_grads.cuh``,
    also K8c's kernel): gsy, gsx (K, B, H, W) f32, every element written,
    from y (B, H, W, K, C) and CUDA tensors that ``_check_taps`` passed,
    under ``rule``, or ``floor`` where the device flag ``fast`` (not None)
    reads False. The K3 form that calls it counts the launch."""
    b, h, w, c = g.shape
    cuda_build.call("deform_sample_bwd", "deform_sample_bwd_taps_coords", y,
                    (y, sy, sx, g, gsy, gsx, fast), (k, b, h, w, c, RULES[rule]))


SCAN_TILE = 2048  # bins a block of the counting sort's scan owns (kScanTile)


def sort_work_len(planes: int, h: int, w: int, n_samples: int) -> int:
    """Length of the int32 scratch of the counting sort and gather of
    ``csrc/sorted_gather.cuh`` (``work_len``), which the unclipped all-tap K3
    (``planes`` K * B) and K7b (``planes`` B) run: bin offsets and their
    total, tile starts, a slot and a place per sample, then from a multiple
    of 4 a 4-int record per sample."""
    n_bins = planes * (h + 1) * (w + 1) + 1
    return _round_up(n_bins + -(-n_bins // SCAN_TILE) + 2 * n_samples, 4) + 4 * n_samples


def deform_sample_bwd_unclipped(y: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor,
                                g: torch.Tensor, rule: str = "pallas",
                                fast: torch.Tensor | None = None):
    """K3 where the offsets are not clipped (``auto``, ``gather``): the
    backward of ``deform_sample_taps`` (up to its per-tap rounding) for
    upstream gradient g, samples anywhere.

    y (B, H, W, K, C) the tap projections side by side; sy, sx (K, B, H, W)
    f32, any values; g (B, H, W, C) in y's dtype; ``rule`` the coordinate
    derivative (``RULES``) and ``fast`` None or a one-element bool flag on
    y's device (False: ``floor`` instead, as ``auto`` chooses). Returns
    (grad_y (B, H, W, K, C) in y's dtype, gsy, gsx (K, B, H, W) f32). Each
    grad_y element is an f32 sum in a fixed order, rounded once: two runs
    give the same bits. CPU tensors take the plain version; CUDA tensors
    launch the counting-sort gather and the coordinate pass (C % 8 == 0, all
    contiguous, 16-byte aligned, K * B * (H + 1) * (W + 1) < 2^31) with
    int32 scratch of about 4 bytes a bin and 24 a sample.
    """
    global launches_bwd_unclipped
    k = _check_taps(y, sy, sx, g)
    _check_rule(rule, fast, y.device)
    if y.device.type == "cpu":
        return deform_sample_bwd_taps_plain(y, sy, sx, g, None, rule, fast)
    b, h, w, c = g.shape
    n_work = sort_work_len(k * b, h, w, k * b * h * w)
    if n_work >= 2 ** 31:
        raise ValueError(f"{k} taps of a {b}x{h}x{w} map exceed the int32 scratch")
    work = torch.empty(n_work, dtype=torch.int32, device=y.device)
    gy = torch.empty_like(y)
    gsy, gsx = torch.empty_like(sy), torch.empty_like(sx)
    cuda_build.call("deform_sample_bwd", "deform_sample_bwd_unclipped_grad_y", y,
                    (g, sy, sx, gy, work), (k, b, h, w, c, n_work))
    coord_pass(y, sy, sx, g, gsy, gsx, k, rule, fast)
    launches_bwd_unclipped += 2
    return gy, gsy, gsx


class DeformSampleTaps(torch.autograd.Function):
    """The K taps of the untiled form: forward K2, which adds the taps in
    ``y.dtype`` in tap order, as the JAX package's training form adds them;
    gradients to y, sy and sx by K3 (their plain versions on CPU tensors),
    the row-band form where dy is clipped (``pallas``, ``mxu``) and the
    unclipped form for ``reach_y`` None (``auto``, ``gather``), with the
    coordinate derivative ``rule`` and, on the unclipped form only, the flag
    ``fast`` that ``deform_conv2d`` chose for the route. All three kernels
    read and write the side-by-side layout in place.

    y (B, H, W, K, C) the tap projections side by side, as ``deform_conv2d``
    builds them; sy, sx (K, B, H, W) f32 within ``reach_y`` rows of their
    pixels, or anywhere for None. Returns (B, H, W, C) in ``y.dtype``. Every
    tap's upstream gradient is the output's, as in a chain of additions.
    """

    @staticmethod
    def forward(ctx, y, sy, sx, reach_y: int | None, rule: str = "pallas",
                fast: torch.Tensor | None = None):
        _check_rule(rule, fast, y.device)
        if fast is not None and reach_y is not None:
            raise ValueError("a flag takes the unclipped form: reach_y must be None")
        ctx.save_for_backward(y, sy, sx)
        ctx.reach_y, ctx.rule, ctx.fast = reach_y, rule, fast
        return sampled(lambda: deform_sample_taps(y, sy, sx))

    @staticmethod
    def backward(ctx, g):
        y, sy, sx = ctx.saved_tensors
        if ctx.reach_y is None:
            gy, gsy, gsx = deform_sample_bwd_unclipped(y, sy, sx, g.contiguous(), ctx.rule,
                                                       ctx.fast)
        else:
            gy, gsy, gsx = deform_sample_bwd_taps(y, sy, sx, g.contiguous(), ctx.reach_y,
                                                  ctx.rule)
        # one gradient per input given: reach_y, and rule and fast where given
        return (gy, gsy, gsx) + (None,) * (len(ctx.needs_input_grad) - 3)


# ---------------------------------------------------------------------------
# the routing rule of the ``pallas`` route
# ---------------------------------------------------------------------------

RB = 8  # output rows per program of the TPU kernels
VMEM_LIMIT = 13 * 1024 * 1024  # above it the TPU's untiled kernel does not fit


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _col_tile(w: int, max_dx: int, dilation: int) -> tuple[int, int] | None:
    """(ct, ctw) of the TPU's column-tiled kernel for a map ``w`` wide, or
    None: ct is the largest multiple of 8 in [128, 256] that divides w (and
    is smaller than w), ctw its source-column window."""
    halo = 2 * (max_dx + dilation + 2)
    best = None
    for ct in range(128, min(w, 257), 8):
        if w % ct == 0:
            best = ct
    if best is None:
        return None
    return best, _round_up(best + halo, 8)


def pallas_route(shape, cout: int, max_dy: int, dilation: int,
                 vmem_limit: int = VMEM_LIMIT):
    """Which form the JAX package on a TPU takes for ``dcn_impl: pallas`` on
    an input of ``shape`` (B, H, W, Cin): the arithmetic of its
    ``pallas_route`` without the backend test. Returns (route, max_dx):

      * ``("untiled", None)`` and ``("mxu", None)``: dy clipped to +-max_dy,
        dx unrestricted (the two compute the same function);
      * ``("tiled", max_dx)``: the untiled kernel's VMEM estimate exceeds
        ``vmem_limit`` and a column tile exists; dx is clipped to +-max_dx as
        well and the taps are sampled one by one also at inference.

    The card's kernels have no such limits; ``deform_conv2d(impl="pallas")``
    asks so that each layer computes what the JAX package computes for it.
    """
    _, _, w, _ = shape
    if cout % 128 != 0:
        return "mxu", None
    wp = _round_up(w + 2, 128)
    max_dx = max_dy  # the same clip on both axes
    tile = _col_tile(w, max_dx, dilation)
    # the untiled TPU kernel's VMEM: halo window, per-row hat matrix (f32 and
    # a bf16 operand), f32 accumulator, output block
    vmem_est = ((RB + 2 * (max_dy + dilation) + 2) * wp * cout * 2 + wp * w * 6
                + w * cout * 4 + RB * w * cout * 4)
    if vmem_est > vmem_limit:
        return ("tiled", max_dx) if tile is not None else ("mxu", None)
    return "untiled", None


# ---------------------------------------------------------------------------
# K6: the sampler of the column-tiled form
# ---------------------------------------------------------------------------
#
# K6 replaces the TPU kernel ``deform_conv_pallas.py:_sample_pallas_tiled``
# (``_sample_kernel_tiled``), which ``_deform_conv2d_pallas_tiled`` calls once
# per tap and adds in bf16. There each program holds a window of
# ``8 + 2 r + 2`` rows and ``ct + 2 (max_dx + 2)`` columns of one tap's padded
# projection in VMEM, which is why the tiled form clips dx as well as dy. On
# the card the kernel reads the taps' blocks of the one-matmul projection
# ``(B, H, W, K*C)`` in place (pixel stride K*C); what stays of the window is
# its contract: a counted sample of pixel (i, j) lies within ``reach_y`` rows
# and ``reach_x`` columns of it. The kernel gives zero to a sample beyond (it
# cannot raise); the CPU paths raise instead. ``inside`` is tested on the
# true H and W. The kernel stages a block's coordinates of all taps in
# shared memory once and runs K2's chain, so its output equals the per-tap
# samples added in ``y.dtype``. Its backward is the clipped K3.


def check_reach(sy: torch.Tensor, sx: torch.Tensor, reach_y: int,
                reach_x: int | None) -> None:
    """Raise unless every counted sample of coordinates (..., H, W) lies
    within ``reach_y`` rows and ``reach_x`` columns (any column for None) of
    its output pixel: the kernels with a window or a row band (K6, K8b, the
    clipped K3) look no further. One pass over the coordinates; the CPU
    paths run it."""
    h, w = sy.shape[-2:]
    inside = (sy > -1.0) & (sy < h) & (sx > -1.0) & (sx < w)
    iy = torch.arange(h, dtype=sy.dtype, device=sy.device)[:, None]
    far = (sy - iy).abs() > reach_y
    if reach_x is not None:
        ix = torch.arange(w, dtype=sx.dtype, device=sx.device)[None, :]
        far = far | ((sx - ix).abs() > reach_x)
    far = inside & far
    if bool(far.any()):
        raise ValueError(
            f"{int(far.sum())} counted samples lie beyond reach ({reach_y}, {reach_x}) "
            "of their pixel: clip the offsets first")


def deform_sample_tiled_plain(y: torch.Tensor, t: int, sy: torch.Tensor, sx: torch.Tensor,
                              reach_y: int, reach_x: int) -> torch.Tensor:
    """Plain PyTorch version of one tap of K6, the JAX package's
    ``_sample_pallas_tiled``: the reach check, then ``deform_sample_plain``
    on tap t's block of y (B, H, W, K, C)."""
    check_reach(sy, sx, reach_y, reach_x)
    return deform_sample_plain(y[:, :, :, t], sy, sx)


def deform_sample_tiled_taps_plain(y: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor,
                                   reach_y: int, reach_x: int) -> torch.Tensor:
    """Plain PyTorch version of K6: the reach check, then K2's plain version
    (``deform_sample_plain`` on each tap's block of y (B, H, W, K, C), the
    results added in ``y.dtype`` in tap order)."""
    check_reach(sy, sx, reach_y, reach_x)
    return deform_sample_taps_plain(y, sy, sx)


def deform_sample_tiled_taps(y: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor,
                             reach_y: int, reach_x: int) -> torch.Tensor:
    """K6: ``sum_t bilinear(y[:, :, :, t]; sy[t], sx[t])`` for all K taps of
    a layer, with each tap rounded to ``y.dtype`` and added in it in tap
    order, as the JAX package's tiled form adds them.

    y (B, H, W, K, C) bf16/f32, the one-matmul projection with the K taps
    side by side; sy, sx (K, B, H, W) f32 absolute sample coordinates with
    ``|sy - i| <= reach_y`` and ``|sx - j| <= reach_x`` at every counted
    sample of pixel (i, j); all three contiguous. Returns (B, H, W, C) in
    ``y.dtype``. CPU tensors take the plain version, which raises on a
    sample beyond the reach; CUDA tensors launch the kernel (C % 8 == 0,
    y 16-byte aligned, B and H <= 65535, K <= 192: a block's coordinates
    within 48 KB of shared memory), which gives zero there. Not
    differentiable by itself: ``DeformSampleTiled`` is.
    """
    global launches_tiled_taps
    if reach_y < 0 or reach_x < 0:
        raise ValueError(f"reach must be >= 0, got ({reach_y}, {reach_x})")
    k = _check_taps(y, sy, sx, None, contiguous_on_cpu=True)
    if y.device.type == "cpu":
        return deform_sample_tiled_taps_plain(y, sy, sx, reach_y, reach_x)
    b, h, w, _, c = y.shape
    if b > 65535 or h > 65535:
        raise ValueError(f"B={b} or H={h} exceeds the grid's 65535")
    out = torch.empty((b, h, w, c), dtype=y.dtype, device=y.device)
    cuda_build.call("deform_sample_tiled", "deform_sample_tiled_taps", y, (y, sy, sx, out),
                    (b, h, w, c, k, reach_y, reach_x))
    launches_tiled_taps += 1
    return out


class DeformSampleTiled(torch.autograd.Function):
    """The K taps of the column-tiled form: K6, which adds the taps in
    ``y.dtype`` in tap order (the JAX package has no fused tiled forward, so
    this is also the inference form), with gradients to y, sy and sx by the
    clipped K3, which reads and writes the side-by-side layout in place.

    y (B, H, W, K, C); sy, sx (K, B, H, W) f32 within ``reach_y``,
    ``reach_x`` of their pixels. Returns (B, H, W, C) in ``y.dtype``. Every
    tap's upstream gradient is the output's, as in a chain of additions.
    """

    @staticmethod
    def forward(ctx, y, sy, sx, reach_y: int, reach_x: int):
        ctx.save_for_backward(y, sy, sx)
        ctx.reach_y = reach_y
        return sampled(lambda: deform_sample_tiled_taps(y, sy, sx, reach_y, reach_x))

    @staticmethod
    def backward(ctx, g):
        y, sy, sx = ctx.saved_tensors
        gy, gsy, gsx = deform_sample_bwd_taps(y, sy, sx, g.contiguous(), ctx.reach_y, "pallas")
        return gy, gsy, gsx, None, None
