"""K1 on the side-by-side projection and the coordinate pass, on the CPU
(the kernels' plain versions) against the JAX package.

K1 (``deform_sample9``) reads the taps side by side, (B, H, W, K, C), the
output of the one matmul of ``side_by_side_projections`` that the untiled
routes of ``deform_conv2d`` build, with or without gradients. The
coordinate gradients that K8c, both K3 forms and K7b share are written
three ways in the plain versions (``shift_offset_grads_plain`` on the
one-matmul layout, the coordinate half of ``deform_sample_bwd_taps_plain``,
and ``deform_sample_mt_bwd_plain`` with one map for every tap); they must
agree, so that the one kernel's strides are held by one function. Inputs
come from numpy seeds; ``pl.pallas_call`` runs in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from upsnet_tpu.ops import deform_conv_pallas as dcp
from upsnet_tpu.ops.deform_conv import deform_conv2d_auto
from upsnet_torch.ops import deform_conv as tdc
from upsnet_torch.ops import deform_sample, deform_sample_mt, deform_shift

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


# ------------------------------------------------------------ K1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("spread", [2.0, 12.0], ids=["near", "far"])
def test_sample9_is_its_taps_in_f32_and_k8a(dtype, spread):
    """K1 on the side-by-side projections is the f32 sum of its taps' one-tap
    plain samples (``deform_sample_plain`` of the f32 values) in tap order,
    rounded once to the dtype, and gives K8a's bits on the one-matmul
    layout: the same bits, with samples on integer coordinates and beyond
    every edge of the map."""
    rng = np.random.RandomState(1)
    k, b, h, w, c = 9, 2, 7, 9, 16
    y9 = _side_by_side(_t(rng.randn(k, b, h, w, c).astype(np.float32)).to(dtype))
    sy, sx = (_t(a) for a in _coords(rng, k, b, h, w, spread))
    assert bool(((sy < -1) | (sy > h) | (sx < -1) | (sx > w)).any())
    assert bool((sy == sy.round()).any()) and bool((sx == sx.round()).any())
    got = deform_sample.deform_sample9(y9, sy, sx)
    assert got.dtype == dtype and got.shape == (b, h, w, c)
    acc = torch.zeros((b, h, w, c))
    for t in range(k):
        acc += deform_sample.deform_sample_plain(y9[:, :, :, t].float(), sy[t], sx[t])
    assert torch.equal(got, acc.to(dtype))
    # and K8a on the one-matmul layout, whose plain version adds in the same order
    assert torch.equal(got, deform_shift.shift_fwd(y9.flatten(3), sy, sx))


def test_sample9_wrapper_checks_the_layout_and_counts_no_cpu_call():
    y = torch.zeros((1, 4, 5, 9, 8))
    s = torch.zeros((9, 1, 4, 5))
    before = deform_sample.launches
    assert deform_sample.deform_sample9(y, s, s).shape == (1, 4, 5, 8)
    assert deform_sample.launches == before
    with pytest.raises(ValueError):  # a tap-major stack: the coordinates do not fit it
        deform_sample.deform_sample9(y.permute(3, 0, 1, 2, 4).contiguous(), s, s)
    with pytest.raises(ValueError):
        deform_sample.deform_sample9(y, s[:8], s[:8])
    with pytest.raises(ValueError):
        deform_sample.deform_sample9(y[..., 0], s, s)
    with pytest.raises(TypeError):
        deform_sample.deform_sample9(y.double(), s, s)
    with pytest.raises(TypeError):
        deform_sample.deform_sample9(y, s.double(), s)


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
    got = deform_sample.deform_sample9(_side_by_side(_t(y9).to(dtype)), _t(sy), _t(sx))
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
    """Counts of the side-by-side projection, and the shapes of the stacks
    that K1 and ``DeformSampleTaps`` get, in ``deform_conv2d``."""
    calls = {"side_by_side_projections": 0, "k1_layout": [], "taps_layout": []}
    real_projections = tdc.side_by_side_projections

    def projections(*args, **kw):
        calls["side_by_side_projections"] += 1
        return real_projections(*args, **kw)

    monkeypatch.setattr(tdc, "side_by_side_projections", projections)
    real_k1 = tdc.deform_sample9

    def k1(y, *args):
        calls["k1_layout"].append(tuple(y.shape))
        return real_k1(y, *args)

    monkeypatch.setattr(tdc, "deform_sample9", k1)
    real_taps = tdc.DeformSampleTaps.apply

    def taps(y, *args):
        calls["taps_layout"].append(tuple(y.shape))
        return real_taps(y, *args)

    monkeypatch.setattr(tdc.DeformSampleTaps, "apply", taps)
    return calls


@pytest.mark.parametrize("impl", ["auto", "pallas", "mxu", "shift"])
def test_no_grad_deform_conv_reads_the_one_matmul_projection(rng, spies, impl):
    """Without gradients each route's untiled layer builds the side-by-side
    projection and K1 reads it (``shift`` at 16 output channels is one of
    its fallback levels: the ``pallas`` route), and equals the JAX layer of
    that route: ``deform_conv2d_auto`` for ``auto``, ``_fused_untiled``
    (``_sample_pallas9`` interpreted) for the clipped ones; atol 1e-5. With
    gradients each route builds the same side-by-side projection and
    ``DeformSampleTaps`` samples it in place (the 9 taps on axis 3): no
    tap-major stack, and no function builds one."""
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
    side = (2, 16, 20, 9, 16)  # (B, H, W, K, Cout)
    assert spies == {"side_by_side_projections": 1, "k1_layout": [side], "taps_layout": []}

    targs[0].requires_grad_()
    out = tdc.deform_conv2d(*targs, impl=impl, max_dy=6)
    assert out.grad_fn is not None
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=DCN_ATOL, rtol=0)
    assert spies == {"side_by_side_projections": 2, "k1_layout": [side],
                     "taps_layout": [side]}
    assert not hasattr(tdc, "tap_projections")


# ------------------------------------------------- the coordinate pass


# (spread, dtype, g per tap): the one-g cases keep their ids
COORD_CASES = [(spread, dtype, per_tap) for per_tap in (False, True)
               for spread in (2.0, 12.0) for dtype in (torch.float32, torch.bfloat16)]


def _coord_case_id(case):
    spread, dtype, per_tap = case
    dtype_id = "-f32" if dtype == torch.float32 else "-bf16"
    return ("near" if spread == 2.0 else "far") + dtype_id + ("-g_per_tap" if per_tap else "")


@pytest.mark.parametrize("spread, dtype, g_per_tap", COORD_CASES,
                         ids=[_coord_case_id(c) for c in COORD_CASES])
def test_coordinate_pass_plain_versions_agree(dtype, spread, g_per_tap):
    """gsy, gsx of the same projections and coordinates through the
    coordinate half of the all-tap K3's plain version (side by side) and
    K8c's plain version (one-matmul layout): the same bits, exact zeros at
    integer coordinates and at samples that do not count. With
    ``g_per_tap`` (K7b's case: one input x as every tap's map, a g row per
    (pixel, tap)) each tap of those two with its own g, and K7b's plain
    version on x: the same bits."""
    rng = np.random.RandomState(2)
    k, b, h, w, c = 9, 2, 6, 8, 16
    y9 = _t(rng.randn(k, b, h, w, c).astype(np.float32)).to(dtype)
    g = _t(rng.randn(b, h, w, c).astype(np.float32)).to(dtype)
    sy, sx = (_t(a) for a in _coords(rng, k, b, h, w, spread, integer_share=0.2))
    taps_plain = deform_sample.deform_sample_bwd_taps_plain
    if not g_per_tap:
        side = _side_by_side(y9)
        _, gsy_ref, gsx_ref = taps_plain(side, sy, sx, g, None)
        others = [deform_shift.shift_offset_grads_plain(side.flatten(3), sy, sx, g)]
    else:
        x = y9[0]
        side = _side_by_side(x.expand(k, *x.shape).contiguous())
        g9 = _t(rng.randn(b, h, w, k, c).astype(np.float32)).to(dtype)

        def tapwise(fn):
            """(gsy, gsx) (K, B, H, W) of fn(t, g_t) -> (gsy_t, gsx_t) (1, B, H, W)."""
            parts = [fn(t, g9[:, :, :, t].contiguous()) for t in range(k)]
            return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])

        gsy_ref, gsx_ref = tapwise(lambda t, g_t: taps_plain(
            side[:, :, :, t:t + 1], sy[t:t + 1], sx[t:t + 1], g_t, None)[1:])
        others = [
            tapwise(lambda t, g_t: deform_shift.shift_offset_grads_plain(
                side[:, :, :, t:t + 1].flatten(3), sy[t:t + 1], sx[t:t + 1], g_t)),
            deform_sample_mt.deform_sample_mt_bwd_plain(x, sy, sx, g9)[1:],
        ]
    assert gsy_ref.dtype == gsx_ref.dtype == torch.float32
    for got_y, got_x in others:
        assert got_y.dtype == got_x.dtype == torch.float32
        assert torch.equal(got_y, gsy_ref) and torch.equal(got_x, gsx_ref)
    outside = (sy <= -1) | (sy >= h) | (sx <= -1) | (sx >= w)
    assert bool(outside.any())
    assert not gsy_ref[(sy == sy.round()) | outside].any()
    assert not gsx_ref[(sx == sx.round()) | outside].any()
    assert bool(gsy_ref.abs().max() > 0) and bool(gsx_ref.abs().max() > 0)
