"""The port's kernel wrappers (plain versions on the CPU) against the JAX
package's Pallas kernels in interpret mode and its XLA references.

K1: ``upsnet_torch.ops.deform_sample.deform_sample9`` vs
``deform_conv_pallas._sample_pallas9`` and the DCN entry points.
K4: ``upsnet_torch.ops.roi_align_fpn.fpn_roi_align`` vs
``roi_align_pallas.fpn_roi_align_window`` and ``fpn_roi_align_batched``.
Inputs come from numpy seeds; float32 throughout.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from upsnet_tpu.ops import deform_conv_pallas as dcp
from upsnet_tpu.ops.deform_conv import deform_conv2d_auto
from upsnet_tpu.ops.roi_align import fpn_roi_align_batched
from upsnet_tpu.ops.roi_align_pallas import fpn_roi_align_window
from upsnet_torch.ops import deform_sample, roi_align_fpn
from upsnet_torch.ops.deform_conv import deform_conv2d

torch.set_num_threads(2)

DCN_ATOL = 1e-5
ROI_ATOL = 2e-5


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    """Run pallas_call in interpreter mode (no TPU in the test env)."""
    real = pl.pallas_call

    def patched(*args, **kw):
        kw["interpret"] = True
        return real(*args, **kw)

    monkeypatch.setattr(pl, "pallas_call", patched)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --------------------------------------------------------------------- K1


def _coords(rng, t_n, b, h, w, spread, integer):
    ky = np.array([t // 3 - 1 for t in range(t_n)], np.float32)[:, None, None, None]
    kx = np.array([t % 3 - 1 for t in range(t_n)], np.float32)[:, None, None, None]
    dy = rng.uniform(-spread, spread, (t_n, b, h, w))
    dx = rng.uniform(-spread, spread, (t_n, b, h, w))
    if integer:
        dy, dx = np.round(dy), np.round(dx)
    sy = np.arange(h, dtype=np.float32)[None, None, :, None] + ky + dy
    sx = np.arange(w, dtype=np.float32)[None, None, None, :] + kx + dx
    return sy.astype(np.float32), sx.astype(np.float32)


@pytest.mark.parametrize("integer", [True, False], ids=["integer", "fractional"])
def test_sample9_plain_matches_pallas_kernel(rng, integer):
    """The plain version of K1 == ``_sample_pallas9`` in interpret mode, on
    inputs padded the way ``_fused_untiled`` pads them, dy inside its
    window; dx runs past both edges."""
    t_n, b, h, w, c = 9, 2, 16, 20, 32
    max_dy, dilation = 3, 1
    r = max_dy + dilation
    y9 = rng.randn(t_n, b, h, w, c).astype(np.float32)
    sy, sx = _coords(rng, t_n, b, h, w, max_dy, integer)
    wp = 128
    y_pad9 = np.pad(y9, ((0, 0), (0, 0), (r + 2, r + 2), (1, wp - w - 1), (0, 0)))
    ref = dcp._sample_pallas9(jnp.asarray(y_pad9), jnp.asarray(sy), jnp.asarray(sx), r)
    got = deform_sample.deform_sample9(_t(y9).permute(1, 2, 3, 0, 4).contiguous(), _t(sy),
                                       _t(sx))
    assert got.shape == (b, h, w, c) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=DCN_ATOL, rtol=0)


def _dcn_inputs(rng, b=2, h=16, w=20, cin=8, cout=16, spread=4.0):
    x = rng.randn(b, h, w, cin).astype(np.float32)
    offsets = (rng.randn(b, h, w, 18) * spread).astype(np.float32)
    weight = (rng.randn(9, cin, cout) * 0.1).astype(np.float32)
    bias = rng.randn(cout).astype(np.float32)
    return x, offsets, weight, bias


@pytest.mark.parametrize("impl", ["auto", "gather"])
def test_deform_conv_exact_matches_jax_auto(rng, impl):
    """Exact routes: unclipped offsets (some beyond +-max_dy, where the JAX
    ``auto`` route falls back to its exact gather) through K1."""
    x, offsets, weight, bias = _dcn_inputs(rng)
    assert np.abs(offsets[..., 0::2]).max() > 6
    ref = deform_conv2d_auto(jnp.asarray(x), jnp.asarray(offsets),
                             jnp.asarray(weight), jnp.asarray(bias), max_dy=6)
    got = deform_conv2d(_t(x), _t(offsets), _t(weight), _t(bias), impl=impl,
                        max_dy=6)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=DCN_ATOL, rtol=0)


@pytest.mark.parametrize("impl", ["pallas", "mxu"])
def test_deform_conv_clipped_matches_fused_untiled(rng, impl):
    """Windowed routes: dy clamped to +-max_dy, then K1 == the JAX fused
    all-taps forward ``_fused_untiled`` (``_sample_pallas9`` interpreted)."""
    x, offsets, weight, bias = _dcn_inputs(rng)
    assert np.abs(offsets[..., 0::2]).max() > 6
    args = (jnp.asarray(x), jnp.asarray(offsets), jnp.asarray(weight),
            jnp.asarray(bias))
    ref = dcp._fused_untiled(*args, 3, 1, 6, "clip")
    got = deform_conv2d(_t(x), _t(offsets), _t(weight), _t(bias), impl=impl,
                        max_dy=6)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=DCN_ATOL, rtol=0)


def test_deform_conv_any_odd_kernel_size(rng):
    """A 5x5 deformable conv (25 taps) with dilation 2 matches the JAX exact
    gather route; the port does not assume 9 taps."""
    from upsnet_tpu.ops.deform_conv import deform_conv2d_batched

    x = rng.randn(1, 12, 14, 8).astype(np.float32)
    offsets = (rng.randn(1, 12, 14, 50) * 2).astype(np.float32)
    weight = (rng.randn(25, 8, 8) * 0.1).astype(np.float32)
    ref = deform_conv2d_batched(jnp.asarray(x), jnp.asarray(offsets),
                                jnp.asarray(weight), kernel_size=5, dilation=2)
    got = deform_conv2d(_t(x), _t(offsets), _t(weight), kernel_size=5,
                        dilation=2, impl="gather")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=DCN_ATOL, rtol=0)


def test_sample9_wrapper_checks_and_cpu_counts_nothing(rng):
    y9 = torch.zeros((1, 4, 4, 9, 8))
    sy = torch.zeros((9, 1, 4, 4))
    before = deform_sample.launches
    deform_sample.deform_sample9(y9, sy, sy)
    assert deform_sample.launches == before
    with pytest.raises(TypeError):
        deform_sample.deform_sample9(y9.double(), sy, sy)
    with pytest.raises(TypeError):
        deform_sample.deform_sample9(y9, sy.double(), sy)
    with pytest.raises(ValueError):
        deform_sample.deform_sample9(y9, sy[:, :, :3], sy)
    args = (torch.zeros(1, 4, 4, 8), torch.zeros(1, 4, 4, 18), torch.zeros(9, 8, 8))
    with pytest.raises(NotImplementedError):
        deform_conv2d(*args, impl="no_such_impl")
    # 'shift' is ported: this shape is not eligible for it and runs as 'pallas'
    assert deform_conv2d(*args, impl="shift").shape == (1, 4, 4, 8)


# --------------------------------------------------------------------- K4


def _pyramid(rng, b, c=16):
    shapes = [(32, 80), (16, 40), (8, 20), (4, 10)]
    return [rng.randn(b, h, w, c).astype(np.float32) for h, w in shapes], (4, 8, 16, 32)


def _roi_cases(rng):
    """Random RoIs on random levels, plus RoIs that need several window
    strips on the TPU (wider or taller than 32x64 cells at P2) and RoIs
    partly outside the canvas."""
    rand = rng.uniform(0, 250, (2, 10, 4)).astype(np.float32)
    rand[..., 2:] = rand[..., :2] + rng.uniform(4, 60, (2, 10, 2))
    lev_rand = rng.randint(0, 4, (2, 10)).astype(np.int32)
    strip = np.array([[[2.0, 40.0, 310.0, 58.0], [8.0, 1.0, 20.0, 126.0],
                       [0.0, 0.0, 318.0, 126.0], [300.0, 120.0, 316.0, 126.0],
                       [-30.0, -20.0, 50.0, 40.0], [250.0, 90.0, 400.0, 200.0]]],
                     np.float32)
    lev_strip = np.array([[0, 0, 0, 0, 1, 2]], np.int32)
    return [(rand, lev_rand), (strip, lev_strip)]


@pytest.mark.parametrize("pooled", [7, 14])
@pytest.mark.parametrize("case", [0, 1], ids=["random", "multistrip_outside"])
def test_fpn_roi_align_plain_matches_window_kernel_and_gather(rng, pooled, case):
    rois, levels = _roi_cases(rng)[case]
    feats, strides = _pyramid(rng, rois.shape[0])
    jf = tuple(jnp.asarray(f) for f in feats)
    win = fpn_roi_align_window(jf, jnp.asarray(rois), jnp.asarray(levels),
                               pooled=pooled, strides=strides)
    gat = fpn_roi_align_batched(jf, jnp.asarray(rois), jnp.asarray(levels),
                                pooled=pooled, strides=strides, impl="gather")
    got = roi_align_fpn.fpn_roi_align(tuple(_t(f) for f in feats), _t(rois),
                                      _t(levels), pooled=pooled, strides=strides)
    assert got.shape == (*rois.shape[:2], pooled, pooled, feats[0].shape[-1])
    np.testing.assert_allclose(got.numpy(), np.asarray(win), atol=ROI_ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(gat), atol=ROI_ATOL, rtol=0)


def test_fpn_roi_align_wrapper_checks_and_cpu_counts_nothing(rng):
    feats, _ = _pyramid(rng, 1, c=8)
    tf = tuple(_t(f) for f in feats)
    rois = torch.tensor([[[0.0, 0.0, 30.0, 30.0]]])
    lev = torch.zeros((1, 1), dtype=torch.int32)
    before = roi_align_fpn.launches
    roi_align_fpn.fpn_roi_align(tf, rois, lev)
    assert roi_align_fpn.launches == before
    with pytest.raises(TypeError):
        roi_align_fpn.fpn_roi_align(tf, rois, lev.long())
    with pytest.raises(TypeError):
        roi_align_fpn.fpn_roi_align(tf, rois.double(), lev)
    with pytest.raises(ValueError):
        roi_align_fpn.fpn_roi_align(tf[:3], rois, lev)
    with pytest.raises(ValueError):
        roi_align_fpn.fpn_roi_align(tf, rois[:, :, :3], lev)
