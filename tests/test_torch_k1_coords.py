"""K1 on the side-by-side projection and the coordinate pass's layouts, on
the CPU (the kernels' plain versions) against the JAX package.

K1 (``deform_sample9``) takes its taps on ``tap_axis`` 0 (tap-major, as
``tap_projections`` stacks them) or 3 (side by side, the output of the one
matmul of ``side_by_side_projections``), and the no-grad untiled routes of
``deform_conv2d`` use the second. The coordinate gradients that K8c and
both all-tap K3 forms share are written three ways in the plain versions
(``shift_offset_grads_plain`` on the one-matmul layout, the coordinate half
of ``deform_sample_bwd_taps_plain`` in either layout); they must agree, so
that the one kernel's layout strides are held by one function. Inputs come
from numpy seeds; ``pl.pallas_call`` runs in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from upsnet_tpu.ops import deform_conv_pallas as dcp
from upsnet_tpu.ops.deform_conv import deform_conv2d_auto
from upsnet_torch.ops import deform_conv as tdc
from upsnet_torch.ops import deform_sample, deform_shift

torch.set_num_threads(2)

DCN_ATOL = 1e-5  # float32 sums of the same terms in another order
BF16_RTOL = 2.0 ** -8  # one round-to-nearest to bfloat16 (8 significant bits)


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


def _coords(rng, k, b, h, w, spread, integer_share=0.1, outside_share=0.05):
    """Per-tap absolute coordinates of a 3 x 3 layer's taps with offsets in
    +-spread; a share of them on integer rows or columns, and a share moved
    beyond the map's edge (samples that do not count)."""
    ky = np.array([t // 3 - 1 for t in range(k)], np.float32)[:, None, None, None]
    kx = np.array([t % 3 - 1 for t in range(k)], np.float32)[:, None, None, None]
    sy = np.arange(h, dtype=np.float32)[None, None, :, None] + ky + rng.uniform(
        -spread, spread, (k, b, h, w))
    sx = np.arange(w, dtype=np.float32)[None, None, None, :] + kx + rng.uniform(
        -spread, spread, (k, b, h, w))
    sy = np.where(rng.rand(k, b, h, w) < integer_share, np.round(sy), sy)
    sx = np.where(rng.rand(k, b, h, w) < integer_share, np.round(sx), sx)
    sy = np.where(rng.rand(k, b, h, w) < outside_share, sy + np.where(sy < h / 2, -h, h), sy)
    return sy.astype(np.float32), sx.astype(np.float32)


def _side_by_side(y9):
    """(K, B, H, W, C) -> (B, H, W, K, C), contiguous."""
    return y9.permute(1, 2, 3, 0, 4).contiguous()


# ------------------------------------------------------------ K1 layouts


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("spread", [2.0, 12.0], ids=["near", "far"])
def test_sample9_side_by_side_equals_tap_major(dtype, spread):
    """The same projections in both layouts give the same bits, with
    samples on integer coordinates and beyond every edge of the map."""
    rng = np.random.RandomState(1)
    k, b, h, w, c = 9, 2, 7, 9, 16
    y9 = _t(rng.randn(k, b, h, w, c).astype(np.float32)).to(dtype)
    sy, sx = (_t(a) for a in _coords(rng, k, b, h, w, spread))
    assert bool(((sy < -1) | (sy > h) | (sx < -1) | (sx > w)).any())
    assert bool((sy == sy.round()).any()) and bool((sx == sx.round()).any())
    tap_major = deform_sample.deform_sample9(y9, sy, sx)
    side = deform_sample.deform_sample9(_side_by_side(y9), sy, sx, tap_axis=3)
    assert side.dtype == dtype and side.shape == (b, h, w, c)
    assert torch.equal(side, tap_major)
    assert torch.equal(side, deform_sample.deform_sample9_plain(_side_by_side(y9), sy, sx, 3))
    # and K8a on the one-matmul layout, whose plain version adds in the same order
    assert torch.equal(side, deform_shift.shift_fwd(_side_by_side(y9).flatten(3), sy, sx))


def test_sample9_wrapper_checks_the_layout_and_counts_no_cpu_call():
    y = torch.zeros((1, 4, 5, 9, 8))
    s = torch.zeros((9, 1, 4, 5))
    before = deform_sample.launches
    assert deform_sample.deform_sample9(y, s, s, tap_axis=3).shape == (1, 4, 5, 8)
    assert deform_sample.launches == before
    with pytest.raises(ValueError, match="tap_axis"):
        deform_sample.deform_sample9(y, s, s, tap_axis=1)
    with pytest.raises(ValueError):  # coordinates of the tap-major reading
        deform_sample.deform_sample9(y, s, s, tap_axis=0)
    with pytest.raises(ValueError):
        deform_sample.deform_sample9(y, s[:8], s[:8], tap_axis=3)
    with pytest.raises(ValueError):
        deform_sample.deform_sample9(y[..., 0], s, s, tap_axis=3)
    with pytest.raises(TypeError):
        deform_sample.deform_sample9(y.double(), s, s, tap_axis=3)
    with pytest.raises(TypeError):
        deform_sample.deform_sample9(y, s.double(), s, tap_axis=3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_side_by_side_sample9_matches_the_pallas_kernel(rng, dtype):
    """The side-by-side plain K1 against ``_sample_pallas9`` interpreted, on
    inputs padded as ``_fused_untiled`` pads them (dy inside the window, dx
    past both edges). float32: atol 1e-5 (sums in another order). bfloat16
    (the same bf16-exact values, the JAX kernel in float32): within one
    rounding to bf16 of the float32 result, 2^-8 relative, plus 1e-5."""
    k, b, h, w, c = 9, 2, 16, 20, 32
    max_dy, dilation = 3, 1
    r = max_dy + dilation
    y9 = rng.randn(k, b, h, w, c).astype(np.float32)
    y9 = _t(y9).to(dtype).float().numpy()  # values the working dtype holds
    sy, sx = _coords(rng, k, b, h, w, max_dy, outside_share=0.0)
    sy = np.clip(sy, np.arange(h)[:, None] - r, np.arange(h)[:, None] + r).astype(np.float32)
    wp = 128
    y_pad9 = np.pad(y9, ((0, 0), (0, 0), (r + 2, r + 2), (1, wp - w - 1), (0, 0)))
    ref = np.asarray(dcp._sample_pallas9(jnp.asarray(y_pad9), jnp.asarray(sy),
                                         jnp.asarray(sx), r))
    got = deform_sample.deform_sample9(_side_by_side(_t(y9).to(dtype)), _t(sy), _t(sx),
                                       tap_axis=3)
    assert got.dtype == dtype
    rtol = 0.0 if dtype == torch.float32 else BF16_RTOL
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=rtol, atol=DCN_ATOL)


# ---------------------------------------------------- the no-grad route


def _dcn_inputs(rng, b=2, h=16, w=20, cin=8, cout=16, spread=4.0):
    x = rng.randn(b, h, w, cin).astype(np.float32)
    offsets = (rng.randn(b, h, w, 18) * spread).astype(np.float32)
    weight = (rng.randn(9, cin, cout) * 0.1).astype(np.float32)
    bias = rng.randn(cout).astype(np.float32)
    return x, offsets, weight, bias


@pytest.fixture
def spies(monkeypatch):
    """Counts of the two projection forms and K1's layouts in
    ``deform_conv2d``."""
    calls = {"tap_projections": 0, "side_by_side_projections": 0, "k1_tap_axis": []}

    def count(name):
        real = getattr(tdc, name)

        def spy(*args, **kw):
            calls[name] += 1
            return real(*args, **kw)

        monkeypatch.setattr(tdc, name, spy)

    count("tap_projections")
    count("side_by_side_projections")
    real_k1 = tdc.deform_sample9

    def k1(*args, tap_axis=0):
        calls["k1_tap_axis"].append(tap_axis)
        return real_k1(*args, tap_axis=tap_axis)

    monkeypatch.setattr(tdc, "deform_sample9", k1)
    return calls


@pytest.mark.parametrize("impl", ["auto", "pallas", "mxu", "shift"])
def test_no_grad_deform_conv_reads_the_one_matmul_projection(rng, spies, impl):
    """Without gradients each route's untiled layer builds the side-by-side
    projection and K1 reads it (``shift`` at 16 output channels is one of
    its fallback levels: the ``pallas`` route), and equals the JAX layer of
    that route: ``deform_conv2d_auto`` for ``auto``, ``_fused_untiled``
    (``_sample_pallas9`` interpreted) for the clipped ones; atol 1e-5. With
    gradients the tap-major stack and ``DeformSampleTaps`` stay."""
    x, offsets, weight, bias = _dcn_inputs(rng)
    assert np.abs(offsets[..., 0::2]).max() > 6
    args = [jnp.asarray(a) for a in (x, offsets, weight, bias)]
    if impl == "auto":
        ref = deform_conv2d_auto(*args, max_dy=6)
    else:
        ref = dcp._fused_untiled(*args, 3, 1, 6, "clip")
    targs = [_t(a) for a in (x, offsets, weight, bias)]
    with torch.no_grad():
        got = tdc.deform_conv2d(*targs, impl=impl, max_dy=6)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=DCN_ATOL, rtol=0)
    assert spies == {"tap_projections": 0, "side_by_side_projections": 1, "k1_tap_axis": [3]}

    targs[0].requires_grad_()
    out = tdc.deform_conv2d(*targs, impl=impl, max_dy=6)
    assert out.grad_fn is not None
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=DCN_ATOL, rtol=0)
    assert spies == {"tap_projections": 1, "side_by_side_projections": 1, "k1_tap_axis": [3]}


# ------------------------------------------- the coordinate pass's layouts


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("spread", [2.0, 12.0], ids=["near", "far"])
def test_coordinate_pass_plain_versions_agree_in_both_layouts(dtype, spread):
    """gsy, gsx of the same projections and coordinates through K8c's plain
    version (one-matmul layout) and the coordinate half of the all-tap K3's
    plain version, tap-major and side by side: the same bits, exact zeros
    at integer coordinates and at samples that do not count."""
    rng = np.random.RandomState(2)
    k, b, h, w, c = 9, 2, 6, 8, 16
    y9 = _t(rng.randn(k, b, h, w, c).astype(np.float32)).to(dtype)
    g = _t(rng.randn(b, h, w, c).astype(np.float32)).to(dtype)
    sy, sx = (_t(a) for a in _coords(rng, k, b, h, w, spread, integer_share=0.2))
    side = _side_by_side(y9)
    _, gsy_tm, gsx_tm = deform_sample.deform_sample_bwd_taps_plain(y9, sy, sx, g, None, 0)
    _, gsy_sbs, gsx_sbs = deform_sample.deform_sample_bwd_taps_plain(side, sy, sx, g, None, 3)
    gsy_k8c, gsx_k8c = deform_shift.shift_offset_grads_plain(side.flatten(3), sy, sx, g)
    for got_y, got_x in ((gsy_sbs, gsx_sbs), (gsy_k8c, gsx_k8c)):
        assert got_y.dtype == got_x.dtype == torch.float32
        assert torch.equal(got_y, gsy_tm) and torch.equal(got_x, gsx_tm)
    outside = (sy <= -1) | (sy >= h) | (sx <= -1) | (sx >= w)
    assert bool(outside.any())
    assert not gsy_tm[(sy == sy.round()) | outside].any()
    assert not gsx_tm[(sx == sx.round()) | outside].any()
    assert bool(gsy_tm.abs().max() > 0) and bool(gsx_tm.abs().max() > 0)
