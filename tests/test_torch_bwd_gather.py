"""The gather forms of the two training backward kernels against the JAX
package on the CPU.

K3, all taps (``deform_sample_bwd_taps``): its plain version against nine
calls of ``deform_conv_pallas._sample_pallas_bwd`` in interpret mode, on the
side-by-side layout every route builds, in f32 and bf16, on fractional,
integer and beyond-the-edge coordinates; the reach contract; and
``deform_conv2d(impl="pallas")`` with its gradients through
``DeformSampleTaps`` (untiled) and ``DeformSampleTiled`` (tiled) against
``jax.vjp`` of the JAX layer with both routing rules fixed.

K5 (``fpn_roi_align_bwd``): its plain version, in the kernel's separable
form, against ``roi_align_pallas.fpn_roi_align_window_bwd`` in interpret mode
and against the scatter formula of the earlier port on RoIs across the map
edge, under one cell, with samples in [-1, 0), snapped to the last row and
column, all on one level, and padded slots that share one box.

Inputs come from numpy seeds. Every tolerance is stated where it is used.
"""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from test_torch_kernels import _pyramid
from upsnet_tpu.ops import deform_conv_pallas as dcp
from upsnet_tpu.ops.roi_align_pallas import fpn_roi_align_window_bwd
from upsnet_torch.ops import deform_conv as tdc
from upsnet_torch.ops import deform_sample as tsample
from upsnet_torch.ops import roi_align_fpn

torch.set_num_threads(2)

F32_TOL = dict(rtol=1e-5, atol=1e-5)  # f32 sums in another order
ROI_ATOL = 2e-5  # f32 sums of up to hundreds of overlapping samples


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    """Run pallas_call in interpreter mode (no TPU in the test env)."""
    real = pl.pallas_call

    def patched(*args, **kw):
        kw["interpret"] = True
        return real(*args, **kw)

    monkeypatch.setattr(pl, "pallas_call", patched)


def _t(a):
    return torch.from_numpy(np.array(a))  # an owned, writable, contiguous copy


# ------------------------------------------------------------ K3, all taps

K, B, H, W, C = 9, 2, 16, 20, 16
MAX_DY = 3  # the clip of the layer
REACH = MAX_DY + 1  # max_dy + half * dilation: the JAX kernels' window radius
PAD = REACH + 2
WP = 128


def _tap_coords(rng, kind):
    """Coordinates (K, B, H, W) of a clipped 3x3 layer: tap rows -1, 0, 1
    plus dy in [-MAX_DY, MAX_DY], so every sample lies within REACH rows of
    its pixel. ``fractional``: multiples of 1/8 off the grid (exact hat
    weights); ``integer``: on the grid; ``outside``: fractional with dx up
    to +-30 columns, so that many samples leave (-1, H) x (-1, W)."""
    ky = (np.arange(K) // 3 - 1)[:, None, None, None]
    kx = (np.arange(K) % 3 - 1)[:, None, None, None]
    spread_x = 30 if kind == "outside" else 4
    dy = rng.randint(-MAX_DY * 8, MAX_DY * 8 + 1, (K, B, H, W)) / 8.0
    dx = rng.randint(-spread_x * 8, spread_x * 8, (K, B, H, W)) / 8.0
    if kind == "integer":
        dy, dx = np.round(dy), np.round(dx)
    else:  # move every integer coordinate off the grid, inside the clip
        dy = np.where(dy == np.round(dy), dy + np.where(dy > 0, -0.375, 0.375), dy)
        dx = np.where(dx == np.round(dx), dx - 0.375, dx)
    sy = np.arange(H)[None, None, :, None] + ky + dy
    sx = np.arange(W)[None, None, None, :] + kx + dx
    return sy.astype(np.float32), sx.astype(np.float32)


def _jax_taps(y9, sy, sx, g):
    """Nine calls of the TPU kernel, each on its tap padded the way
    ``_pertap_untiled`` pads it; the map's part of each gradient canvas."""
    gys, gsys, gsxs = [], [], []
    for t in range(K):
        y_pad = np.pad(y9[t], ((0, 0), (PAD, PAD), (1, WP - W - 1), (0, 0)))
        gy, gsy, gsx = dcp._sample_pallas_bwd(jnp.asarray(y_pad), jnp.asarray(sy[t]),
                                              jnp.asarray(sx[t]), jnp.asarray(g), REACH)
        gys.append(np.asarray(gy)[:, PAD:PAD + H, 1:1 + W])
        gsys.append(np.asarray(gsy))
        gsxs.append(np.asarray(gsx))
    return np.stack(gys), np.stack(gsys), np.stack(gsxs)


# bf16: grad_y is an f32 sum rounded once to bf16 on both sides, so one bf16
# ulp apart at most (2^-7 relative, 2^-8 at rounding to nearest) plus f32
# slack near zero
BF16_GY_TOL = dict(rtol=2.0 ** -7, atol=1e-4)


@pytest.mark.parametrize("kind", ["fractional", "integer", "outside"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_bwd_taps_plain_matches_nine_pallas_calls(rng, kind, dtype):
    """The all-tap K3's plain version on the side-by-side layout == nine
    ``_sample_pallas_bwd`` calls in interpret mode on the same values, f32
    and bf16 (grad_y comes back in y's layout and dtype; the JAX kernel's
    f32 canvas is rounded to the dtype as its wrapper rounds it). grad_y:
    f32 sums in another order (1e-5; bf16 ``BF16_GY_TOL``). gsy, gsx: f32
    sums of C x 4 products of O(1) values (rtol 1e-5, atol 1e-4). At integer
    coordinates both give gsy = gsx = 0 exactly."""
    y9 = rng.randn(K, B, H, W, C).astype(np.float32)
    g = rng.randn(B, H, W, C).astype(np.float32)
    if dtype == torch.bfloat16:  # both sides get the same bf16 values
        y9, g = (_t(a).bfloat16().float().numpy() for a in (y9, g))
    sy, sx = _tap_coords(rng, kind)
    r_gy, r_gsy, r_gsx = _jax_taps(y9, sy, sx, g)
    r_gy = _t(r_gy).to(dtype).float().numpy()
    y = np.ascontiguousarray(np.moveaxis(y9, 0, 3))
    gy, gsy, gsx = tsample.deform_sample_bwd_taps(_t(y).to(dtype), _t(sy), _t(sx),
                                                  _t(g).to(dtype), REACH)
    assert gy.shape == y.shape and gy.dtype == dtype and gsy.shape == (K, B, H, W)
    assert gsy.dtype == torch.float32
    got_gy = np.moveaxis(gy.float().numpy(), 3, 0)
    np.testing.assert_allclose(got_gy, r_gy, **(F32_TOL if dtype == torch.float32
                                                else BF16_GY_TOL))
    np.testing.assert_allclose(gsy.numpy(), r_gsy, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(gsx.numpy(), r_gsx, rtol=1e-5, atol=1e-4)
    if kind == "integer":
        assert not gsy.numpy().any() and not gsx.numpy().any()
        assert not r_gsy.any() and not r_gsx.any()
        assert np.abs(got_gy).max() > 0
    else:
        assert np.abs(gsy.numpy()).max() > 1 and np.abs(gsx.numpy()).max() > 1
    if kind == "outside":
        outside = ~((sy > -1) & (sy < H) & (sx > -1) & (sx < W))
        assert outside.mean() > 0.2
        assert not gsy.numpy()[outside].any() and not gsx.numpy()[outside].any()


def test_bwd_taps_plain_raises_beyond_the_row_reach(rng):
    """The reach contract: one counted sample more than ``reach_y`` rows
    from its pixel raises (the kernel would give it no gradient to y); the
    same sample outside the map does not count and passes; dx is free."""
    y = _t(rng.randn(1, 8, 12, 3, 8).astype(np.float32))
    g = _t(rng.randn(1, 8, 12, 8).astype(np.float32))
    sy = torch.arange(8, dtype=torch.float32)[None, None, :, None].expand(3, 1, 8, 12).clone()
    sx = torch.arange(12, dtype=torch.float32).expand(3, 1, 8, 12).clone()
    sx[2, 0, 3] += 9.5  # dx is unrestricted
    tsample.deform_sample_bwd_taps(y, sy, sx, g, 2)
    sy[1, 0, 4, 5] += 2.5  # row 6.5 from pixel row 4: beyond a reach of 2
    with pytest.raises(ValueError, match="beyond reach"):
        tsample.deform_sample_bwd_taps(y, sy, sx, g, 2)
    tsample.deform_sample_bwd_taps(y, sy, sx, g, 3)
    sy[1, 0, 4, 5] = -3.0  # beyond the reach and outside the map: not counted
    tsample.deform_sample_bwd_taps(y, sy, sx, g, 2)


def test_bwd_taps_is_the_one_tap_backward_per_tap(rng):
    """In float64 the all-tap plain version equals the one-tap plain K3
    (``deform_sample_bwd_plain``) on each tap exactly: the same arithmetic,
    tap by tap."""
    y = _t(rng.randn(1, 6, 7, K, 8))
    g = _t(rng.randn(1, 6, 7, 8))
    sy = _t(np.arange(6)[None, None, :, None] + rng.uniform(-2.5, 2.5, (K, 1, 6, 7)))
    sx = _t(np.arange(7)[None, None, None, :] + rng.uniform(-9, 9, (K, 1, 6, 7)))
    gy, gsy, gsx = tsample.deform_sample_bwd_taps(y, sy, sx, g, 3)
    for t in range(K):
        ref = tsample.deform_sample_bwd_plain(y[:, :, :, t].contiguous(), sy[t], sx[t], g)
        assert torch.equal(gy[:, :, :, t], ref[0])
        assert torch.equal(gsy[t], ref[1]) and torch.equal(gsx[t], ref[2])


def _gradcheck_coords(rng, k, b, h, w, dy, dx):
    """(K, B, H, W) float64 coordinates within +-dy rows and +-dx columns of
    each pixel, kept 0.05 away from every grid line (the sampler is smooth
    there)."""
    sy = np.arange(h)[None, None, :, None] + rng.uniform(-dy, dy, (k, b, h, w))
    sx = np.arange(w)[None, None, None, :] + rng.uniform(-dx, dx, (k, b, h, w))
    for s in (sy, sx):
        frac = s - np.floor(s)
        s += np.where(frac < 0.05, 0.1, 0) - np.where(frac > 0.95, 0.1, 0)
    return (_t(s).requires_grad_(True) for s in (sy, sx))


def test_deform_sample_taps_function_gradcheck_float64(rng):
    """Finite differences of ``DeformSampleTaps`` (clipped K3) in float64 at
    non-integer coordinates within the reach (the function is smooth
    there)."""
    k, b, h, w, c = 3, 1, 5, 6, 3
    y = _t(rng.randn(b, h, w, k, c)).requires_grad_(True)
    sy, sx = _gradcheck_coords(rng, k, b, h, w, 1.8, 4.5)
    assert torch.autograd.gradcheck(
        lambda *a: tsample.DeformSampleTaps.apply(*a, 2, "pallas"),
        (y, sy, sx), eps=1e-6, atol=1e-6, rtol=1e-5)


def test_deform_sample_taps_unclipped_function_gradcheck_float64(rng):
    """The same for the unclipped K3 (``reach_y`` None): samples up to 7 rows
    away and outside the map, as ``auto`` and ``gather`` take them."""
    k, b, h, w, c = 3, 1, 5, 6, 3
    y = _t(rng.randn(b, h, w, k, c)).requires_grad_(True)
    sy, sx = _gradcheck_coords(rng, k, b, h, w, 7.0, 7.0)
    assert torch.autograd.gradcheck(
        lambda *a: tsample.DeformSampleTaps.apply(*a, None, "pallas"),
        (y, sy, sx), eps=1e-6, atol=1e-6, rtol=1e-5)


def test_deform_sample_tiled_function_gradcheck_float64(rng):
    """The same for ``DeformSampleTiled`` (K6, backward the clipped K3), with
    every sample within the row and the column reach."""
    k, b, h, w, c = 3, 1, 5, 6, 3
    y = _t(rng.randn(b, h, w, k, c)).requires_grad_(True)
    sy, sx = _gradcheck_coords(rng, k, b, h, w, 1.8, 1.8)
    assert torch.autograd.gradcheck(
        lambda *a: tsample.DeformSampleTiled.apply(*a, 2, 2),
        (y, sy, sx), eps=1e-6, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("what", ["rank", "coords", "sx_shape", "reach", "rule", "g_dtype",
                                  "g_shape"])
def test_bwd_taps_wrapper_checks_and_cpu_counts_nothing(rng, what):
    y = torch.zeros((1, 4, 5, 3, 8))
    s = torch.arange(4.0)[:, None].expand(3, 1, 4, 5).contiguous()  # on each pixel's row
    g = torch.zeros((1, 4, 5, 8))
    before = tsample.launches_bwd_taps
    tsample.deform_sample_bwd_taps(y, s, s, g, 1)
    assert tsample.launches_bwd_taps == before
    bad = {"rank": lambda: tsample.deform_sample_bwd_taps(y[0], s, s, g, 1),
           "coords": lambda: tsample.deform_sample_bwd_taps(y, s[:2], s[:2], g, 1),
           "sx_shape": lambda: tsample.deform_sample_bwd_taps(y, s, s[..., :4], g, 1),
           "reach": lambda: tsample.deform_sample_bwd_taps(y, s, s, g, -1),
           "rule": lambda: tsample.deform_sample_bwd_taps(y, s, s, g, 1, "central"),
           "g_dtype": lambda: tsample.deform_sample_bwd_taps(y, s, s, g.bfloat16(), 1),
           "g_shape": lambda: tsample.deform_sample_bwd_taps(y, s, s, g[..., :4], 1)}[what]
    with pytest.raises(TypeError if what == "g_dtype" else ValueError):
        bad()


def _conv_inputs(seed, b=1, h=8, w=20, cin=8, cout=16):
    """Offsets in +-9 px (odd sixteenths, never on the grid) against a +-6
    window, so that the dy clip binds."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, h, w, cin).astype(np.float32)
    offsets = ((2 * rng.randint(-72, 72, (b, h, w, 18)) + 1) / 16.0).astype(np.float32)
    weight = (rng.randn(9, cin, cout) * 0.1).astype(np.float32)
    bias = rng.randn(cout).astype(np.float32)
    return x, offsets, weight, bias


@pytest.mark.parametrize("route", ["untiled", "tiled"])
@pytest.mark.parametrize("boundary_grad", ["clip", "straight_through"])
def test_deform_conv2d_pallas_gradients_match_the_jax_layer(monkeypatch, route,
                                                            boundary_grad):
    """``deform_conv2d(impl="pallas")`` and its four gradients against
    ``jax.vjp`` of ``deform_conv2d_pallas`` with both routing rules fixed to
    ``route`` (the JAX rule answers ``mxu`` on a CPU): untiled through
    ``DeformSampleTaps``, tiled through
    ``DeformSampleTiled``, both with the all-tap K3 as backward. f32; atol
    2e-3 forward, 5e-3 + 1e-3 relative for the gradients: the tolerances
    the JAX package holds its windowed forms to (sums over 9 taps and 4
    corners in another order)."""
    w = 20 if route == "untiled" else 256  # the tiled form needs a column tile
    x, offsets, weight, bias = _conv_inputs(3, w=w)
    fixed = lambda *a: ("tiled", 6) if route == "tiled" else ("untiled", None)  # noqa: E731
    monkeypatch.setattr(dcp, "pallas_route", fixed)
    monkeypatch.setattr(tdc, "pallas_route", fixed)
    cot = np.random.RandomState(4).randn(1, 8, w, 16).astype(np.float32)
    layer = functools.partial(dcp.deform_conv2d_pallas.__wrapped__, kernel_size=3,
                              dilation=1, max_dy=6, boundary_grad=boundary_grad)
    ref, vjp = jax.vjp(layer, *(jnp.asarray(a) for a in (x, offsets, weight, bias)))
    ref_grads = vjp(jnp.asarray(cot))
    targs = [_t(a).requires_grad_(True) for a in (x, offsets, weight, bias)]
    taps = mock.Mock(side_effect=tsample.DeformSampleTaps.apply)
    with mock.patch.object(tdc.DeformSampleTaps, "apply", taps):
        got = tdc.deform_conv2d(*targs, impl="pallas", max_dy=6, boundary_grad=boundary_grad)
    assert taps.call_count == (route == "untiled")
    got.backward(_t(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=2e-3)
    assert (np.abs(offsets[..., 0::2]) > 6).mean() > 0.2
    for name, t, r in zip(("x", "offsets", "weight", "bias"), targs, ref_grads):
        r = np.asarray(r)
        assert np.abs(r).max() > 0, name
        np.testing.assert_allclose(t.grad.numpy(), r, atol=5e-3, rtol=1e-3, err_msg=name)


# --------------------------------------------------------------------- K5

R_SLOTS = 12  # RoI slots per image in every case, so the JAX kernel compiles once per P


def _edge_rois(case):
    """(rois (2, 12, 4) in image coordinates, levels (2, 12) int32) on the
    128x320 canvas of ``_pyramid`` (levels 32x80 .. 4x10 at strides 4-32)."""
    rng = np.random.RandomState({"edges": 0, "tiny": 1, "one_level": 2, "padded": 3}[case])
    rois = rng.uniform(0, 250, (2, R_SLOTS, 4)).astype(np.float32)
    rois[..., 2:] = rois[..., :2] + rng.uniform(8, 90, (2, R_SLOTS, 2))
    levels = rng.randint(0, 4, (2, R_SLOTS)).astype(np.int32)
    if case == "edges":
        rois[0, :6] = [[-30, -20, 60, 40],    # across the top-left edge
                       [-3, -2, 40, 30],      # first samples in [-1, 0) at P2
                       [280, 100, 330, 131],  # across the right and bottom edges
                       [250, 110, 400, 300],  # snapped to the last row and column
                       [-90, 10, 400, 60],    # across both side edges
                       [315, 125, 319.5, 127.5]]  # in the last cells
        levels[0, :6] = [0, 0, 0, 1, 2, 0]
        rois[1, :2] = [[-200, -200, -150, -150], [500, 300, 600, 400]]  # outside the map
    elif case == "tiny":
        centre = rng.uniform(0, 300, (2, R_SLOTS, 2)).astype(np.float32)
        half = rng.uniform(0.05, 1.5, (2, R_SLOTS, 2)).astype(np.float32)  # under one cell
        rois = np.concatenate([centre - half, centre + half], -1)
    elif case == "one_level":
        levels[:] = 1
    else:  # padded: slots 4.. of each image share one box, as the GT call pads
        rois[:, 4:] = [0.0, 0.0, 16.0, 16.0]
        levels[:, 4:] = 0
    return rois, levels


def _scatter_bwd(g, rois, levels, shapes, s=2, strides=(4, 8, 16, 32)):
    """The earlier port's formula: every sample's four corners scattered
    into one f32 canvas with ``index_add_``."""
    b, r, pooled = g.shape[:3]
    c = g.shape[-1]
    hw = [tuple(sh[1:3]) for sh in shapes]
    per_img, corners = roi_align_fpn._corner_table(hw, b, rois, levels, pooled, s, strides)
    canvas = torch.zeros((b * per_img, c))
    gs = (g.float() / float(s * s)).reshape(b * r, pooled, pooled, 1, 1, c)
    for idx, wgt in corners:
        canvas.index_add_(0, idx.reshape(-1), (gs * wgt[..., None]).reshape(-1, c))
    parts = canvas.reshape(b, per_img, c).split([h * w for h, w in hw], dim=1)
    return [p.reshape(b, h, w, c) for p, (h, w) in zip(parts, hw)]


@pytest.mark.parametrize("pooled", [7, 14])
@pytest.mark.parametrize("case", ["edges", "tiny", "one_level", "padded"])
def test_fpn_roi_align_bwd_separable_plain_matches_jax_and_the_scatter(case, pooled):
    """K5's plain version (separable bin weights, one product per RoI)
    == the Pallas ``fpn_roi_align_window_bwd`` in interpret mode and the
    scatter formula, f32, atol 2e-5 and rtol 1e-5 (f32 sums of overlapping
    samples in another order). In the padded case the shared slots carry
    zero gradient, as in the loss."""
    rois, levels = _edge_rois(case)
    feats, strides = _pyramid(np.random.RandomState(5), 2)
    shapes = tuple(f.shape for f in feats)
    g = np.random.RandomState(6).randn(2, R_SLOTS, pooled, pooled, 16).astype(np.float32)
    if case == "padded":
        g[:, 4:] = 0.0
    window = fpn_roi_align_window_bwd(shapes, ("float32",) * 4, jnp.asarray(rois),
                                      jnp.asarray(levels), jnp.asarray(g), pooled, 2, strides)
    got = roi_align_fpn.fpn_roi_align_bwd(_t(g), _t(rois), _t(levels), shapes,
                                          [torch.float32] * 4, strides=strides)
    scatter = _scatter_bwd(_t(g), _t(rois), _t(levels), shapes)
    touched = [li for li in range(4) if np.abs(got[li].numpy()).max() > 0.05]
    assert touched == [1] if case == "one_level" else touched
    for o, w_, s_, sh in zip(got, window, scatter, shapes):
        assert tuple(o.shape) == sh and o.dtype == torch.float32
        np.testing.assert_allclose(o.numpy(), np.asarray(w_), atol=ROI_ATOL, rtol=1e-5)
        np.testing.assert_allclose(o.numpy(), s_.numpy(), atol=ROI_ATOL, rtol=1e-5)
    if case == "edges":  # the snap puts weight on the last row and column of P2
        assert np.abs(got[0].numpy()[0, -1]).max() > 0 and np.abs(got[0].numpy()[0, :, -1]).max() > 0


def test_fpn_roi_align_bwd_plain_casts_once_to_each_level_dtype(rng):
    """bf16 levels: each element is the f32 sum rounded once, so the result
    equals the f32 result rounded to bf16 exactly."""
    rois, levels = _edge_rois("edges")
    feats, strides = _pyramid(np.random.RandomState(5), 2)
    shapes = tuple(f.shape for f in feats)
    g = _t(rng.randn(2, R_SLOTS, 7, 7, 16).astype(np.float32))
    f32 = roi_align_fpn.fpn_roi_align_bwd(g, _t(rois), _t(levels), shapes,
                                          [torch.float32] * 4, strides=strides)
    mixed = roi_align_fpn.fpn_roi_align_bwd(g, _t(rois), _t(levels), shapes,
                                            [torch.bfloat16, torch.float32] * 2,
                                            strides=strides)
    for a, m, dt in zip(f32, mixed, [torch.bfloat16, torch.float32] * 2):
        assert m.dtype == dt and torch.equal(m, a.to(dt))
