"""The training kernels' plain versions (what the wrappers run on the CPU)
against the JAX package's Pallas kernels in interpret mode and its XLA
references.

K2, one tap: ``deform_sample_plain`` vs ``deform_conv_pallas._sample_pallas``.
K3, one tap: ``deform_sample_bwd_plain`` vs ``_sample_pallas_bwd``, on
fractional, integer and out-of-range coordinates; under each rule of the
coordinate derivative against ``jax.vjp`` of its JAX form at integer
coordinates.
K5: ``fpn_roi_align_bwd`` vs ``roi_align._fpn_roi_align_bwd`` and
``roi_align_pallas.fpn_roi_align_window_bwd``.
Then ``FPNRoIAlign``, the training form of ``deform_conv2d`` and
``clip_offsets`` against ``jax.vjp``.
Inputs come from numpy seeds. Every tolerance is stated where it is used.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from test_torch_kernels import _pyramid, _roi_cases
from upsnet_tpu.ops import deform_conv as jdc
from upsnet_tpu.ops import deform_conv_pallas as dcp
from upsnet_tpu.ops import roi_align as jra
from upsnet_tpu.ops.roi_align_pallas import fpn_roi_align_window_bwd
from upsnet_torch.ops import deform_conv, deform_sample, roi_align_fpn

torch.set_num_threads(2)

F32_TOL = dict(rtol=1e-5, atol=1e-5)  # f32 sums in another order
ROI_ATOL = 2e-5  # f32 sums of up to hundreds of overlapping samples
BF16_ULP = 2.0 ** -7  # one bf16 ulp, relative, at the top of a binade


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


# ----------------------------------------------------------------- K2, K3

B, H, W, C = 2, 16, 20, 32
MAX_DY = 4  # the Pallas kernels' window radius; |dy| stays inside it
PAD = MAX_DY + 2
WP = 128


def _pad(y):
    """Rows and columns padded the way ``_pertap_untiled`` pads them."""
    return np.pad(y, ((0, 0), (PAD, PAD), (1, WP - W - 1), (0, 0)))


def _unpad(g_pad):
    """The map's part of a padded canvas (what lands in the padding is the
    share of corners outside the map, which the pad's own VJP drops)."""
    return np.asarray(g_pad)[:, PAD:PAD + H, 1:1 + W]


def _coords(rng, kind):
    """Sample coordinates (B, H, W): ``fractional`` multiples of 1/8 that
    are never integers (exact hat weights in bf16 too), ``integer``, or
    ``outside``: fractional with dx up to +-30 columns and the full dy
    range, so that many samples leave (-1, H) x (-1, W)."""
    spread_x = 30 if kind == "outside" else 4
    dy = rng.randint(-MAX_DY * 8 + 1, MAX_DY * 8, (B, H, W)) / 8.0
    dx = rng.randint(-spread_x * 8, spread_x * 8, (B, H, W)) / 8.0
    if kind == "integer":
        dy, dx = np.round(dy), np.round(dx)
    else:  # move every integer coordinate off the grid
        dy = np.where(dy == np.round(dy), dy + 0.375, dy)
        dx = np.where(dx == np.round(dx), dx - 0.375, dx)
        dy = np.clip(dy, -MAX_DY + 0.125, MAX_DY - 0.125)
    sy = np.arange(H, dtype=np.float32)[None, :, None] + dy
    sx = np.arange(W, dtype=np.float32)[None, None, :] + dx
    return sy.astype(np.float32), sx.astype(np.float32)


KINDS = ["fractional", "integer", "outside"]


@pytest.mark.parametrize("kind", KINDS)
def test_sample_plain_matches_pallas_kernel(rng, kind):
    """K2's plain version == ``_sample_pallas`` in interpret mode, f32."""
    y = rng.randn(B, H, W, C).astype(np.float32)
    sy, sx = _coords(rng, kind)
    ref = dcp._sample_pallas(jnp.asarray(_pad(y)), jnp.asarray(sy), jnp.asarray(sx), MAX_DY)
    got = deform_sample.deform_sample_plain(_t(y), _t(sy), _t(sx))
    assert got.shape == (B, H, W, C) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32_TOL)
    if kind == "outside":
        outside = ~((sy > -1) & (sy < H) & (sx > -1) & (sx < W))
        assert outside.mean() > 0.2 and not got.numpy()[outside].any()


@pytest.mark.parametrize("kind", KINDS)
def test_sample_bwd_plain_matches_pallas_kernel_f32(rng, kind):
    """K3's plain version == ``_sample_pallas_bwd`` in interpret mode, f32.
    At integer coordinates both give gsy = gsx = 0 exactly: the derivative
    of the hat is -sign(d) on |d| < 1, zero at the peak and at |d| = 1."""
    y = rng.randn(B, H, W, C).astype(np.float32)
    g = rng.randn(B, H, W, C).astype(np.float32)
    sy, sx = _coords(rng, kind)
    r_gy, r_gsy, r_gsx = dcp._sample_pallas_bwd(
        jnp.asarray(_pad(y)), jnp.asarray(sy), jnp.asarray(sx), jnp.asarray(g), MAX_DY)
    gy, gsy, gsx = deform_sample.deform_sample_bwd_plain(_t(y), _t(sy), _t(sx), _t(g))
    assert gy.dtype == torch.float32 and gsy.shape == (B, H, W)
    np.testing.assert_allclose(gy.numpy(), _unpad(r_gy), **F32_TOL)
    # coordinate gradients sum 4 x C products of O(1) values
    np.testing.assert_allclose(gsy.numpy(), np.asarray(r_gsy), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(gsx.numpy(), np.asarray(r_gsx), rtol=1e-5, atol=1e-4)
    if kind == "integer":
        assert not gsy.numpy().any() and not gsx.numpy().any()
        assert not np.asarray(r_gsy).any() and not np.asarray(r_gsx).any()
        assert np.abs(gy.numpy()).max() > 0
    else:
        assert np.abs(gsy.numpy()).max() > 1 and np.abs(gsx.numpy()).max() > 1


def _jax_form_vjp(rule, y, sy, sx, g):
    """(grad_y, gsy, gsx) of one tap by ``jax.vjp`` of the JAX form whose
    derivative ``rule`` is: the Pallas ``deform_sample`` (its backward
    kernel, interpreted), or ``deform_conv2d_mxu`` (``hat``) or
    ``deform_conv2d_batched`` (``floor``) as a 1x1 layer with the identity
    weight, whose offsets are the coordinates less the pixel's own."""
    if rule == "pallas":
        _, vjp = jax.vjp(lambda a, b, c: dcp.deform_sample(a, b, c, MAX_DY),
                         jnp.asarray(_pad(y)), jnp.asarray(sy), jnp.asarray(sx))
        gy, gsy, gsx = vjp(jnp.asarray(g))
        return _unpad(gy), np.asarray(gsy), np.asarray(gsx)
    iy = np.arange(H, dtype=np.float32)[None, :, None]
    ix = np.arange(W, dtype=np.float32)[None, None, :]
    offsets = np.stack([sy - iy, sx - ix], axis=-1)
    eye = jnp.eye(C, dtype=jnp.float32)[None]
    if rule == "hat":  # the window one row beyond the farthest |dy|: no clip tie
        layer = lambda a, o: jdc.deform_conv2d_mxu(a, o, eye, None, 1, 1, MAX_DY + 1)  # noqa: E731
    else:
        layer = lambda a, o: jdc.deform_conv2d_batched(a, o, eye, None, 1, 1)  # noqa: E731
    _, vjp = jax.vjp(layer, jnp.asarray(y), jnp.asarray(offsets))
    gy, goff = vjp(jnp.asarray(g))
    return np.asarray(gy), np.asarray(goff[..., 0]), np.asarray(goff[..., 1])


@pytest.mark.parametrize("rule", ["pallas", "hat", "floor"])
def test_sample_bwd_integer_coordinates_zero_not_one_sided(rng, rule):
    """The rules of the coordinate derivative (``deform_sample.RULES``) at
    integer coordinates, among them samples on the first and last row and
    column and samples outside the map: K3's plain version under each rule
    against ``jax.vjp`` of the JAX form it stands for (``_jax_form_vjp``),
    f32 (grad_y rtol 1e-5, atol 1e-5; gsy, gsx sums of 4 x C products of O(1)
    values, rtol 1e-5, atol 1e-4). ``pallas`` is 0 there, and
    ``DeformSampleTaps`` under it, on a one-tap layer, gives 0 too; ``floor``
    is the one-sided derivative that autograd through the floor-based
    forward gives; ``hat`` is neither."""
    y = rng.randn(B, H, W, C).astype(np.float32)
    g = rng.randn(B, H, W, C).astype(np.float32)
    sy, sx = _coords(rng, "integer")
    counted = (sy > -1) & (sy < H) & (sx > -1) & (sx < W)
    for edge in (sy == 0, sy == H - 1, sx == 0, sx == W - 1, ~counted):
        assert edge.sum() >= 10
    r_gy, r_gsy, r_gsx = _jax_form_vjp(rule, y, sy, sx, g)
    gy, gsy, gsx = deform_sample.deform_sample_bwd_plain(_t(y), _t(sy), _t(sx), _t(g), rule)
    np.testing.assert_allclose(gy.numpy(), r_gy, **F32_TOL)
    np.testing.assert_allclose(gsy.numpy(), r_gsy, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(gsx.numpy(), r_gsx, rtol=1e-5, atol=1e-4)
    assert not gsy.numpy()[~counted].any() and not gsx.numpy()[~counted].any()

    # one-sided: autograd through the floor-based forward
    sy2, sx2 = (_t(a).requires_grad_(True) for a in (sy, sx))
    base = (torch.arange(B) * (H * W))[:, None, None]
    deform_sample._bilinear_zero_pad(_t(y).reshape(-1, C), sy2, sx2, H, W,
                                     base).mul(_t(g)).sum().backward()
    floor_like = (np.allclose(sy2.grad.numpy(), gsy.numpy(), rtol=1e-5, atol=1e-4)
                  and np.allclose(sx2.grad.numpy(), gsx.numpy(), rtol=1e-5, atol=1e-4))
    assert floor_like == (rule == "floor")
    if rule == "pallas":
        assert not gsy.numpy().any() and not gsx.numpy().any()
        ty = _t(y)[:, :, :, None].requires_grad_(True)
        tsy, tsx = (_t(a)[None].requires_grad_(True) for a in (sy, sx))
        deform_sample.DeformSampleTaps.apply(ty, tsy, tsx, None, "pallas").backward(_t(g))
        assert not tsy.grad.any() and not tsx.grad.any() and ty.grad.abs().max() > 0
    else:
        assert np.abs(gsy.numpy()).max() > 1 and np.abs(gsx.numpy()).max() > 1


@pytest.mark.parametrize("kind", KINDS)
def test_sample_bwd_plain_matches_pallas_kernel_bf16(rng, kind):
    """bf16 maps. The TPU kernel rounds vy * g to bf16 before its matmul
    (the hat weights here are multiples of 1/8, exact in bf16) and sums in
    f32; the port multiplies in f32. Both round the canvas once to bf16. So
    grad_y may differ by one bf16 ulp of the result plus half an ulp of each
    O(1) term: rtol 2^-7, atol 2^-7. gsy, gsx are f32 sums of exact products
    of bf16 values in another order: rtol 1e-4, atol 1e-3."""
    y = jnp.asarray(rng.randn(B, H, W, C).astype(np.float32)).astype(jnp.bfloat16)
    g = jnp.asarray(rng.randn(B, H, W, C).astype(np.float32)).astype(jnp.bfloat16)
    sy, sx = _coords(rng, kind)
    y_pad = jnp.pad(y, ((0, 0), (PAD, PAD), (1, WP - W - 1), (0, 0)))
    r_gy, r_gsy, r_gsx = dcp._sample_pallas_bwd(y_pad, jnp.asarray(sy), jnp.asarray(sx), g,
                                                MAX_DY)
    ty = _t(np.asarray(y.astype(jnp.float32))).to(torch.bfloat16)
    tg = _t(np.asarray(g.astype(jnp.float32))).to(torch.bfloat16)
    gy, gsy, gsx = deform_sample.deform_sample_bwd_plain(ty, _t(sy), _t(sx), tg)
    assert gy.dtype == torch.bfloat16 and gsy.dtype == torch.float32
    np.testing.assert_allclose(gy.float().numpy(), _unpad(r_gy.astype(jnp.float32)),
                               rtol=BF16_ULP, atol=BF16_ULP)
    np.testing.assert_allclose(gsy.numpy(), np.asarray(r_gsy), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(gsx.numpy(), np.asarray(r_gsx), rtol=1e-4, atol=1e-3)
    # the forward in bf16: one rounding of the same f32 sum
    ref = dcp._sample_pallas(y_pad, jnp.asarray(sy), jnp.asarray(sx), MAX_DY)
    got = deform_sample.deform_sample_plain(ty, _t(sy), _t(sx))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               rtol=BF16_ULP, atol=1e-6)


def test_train_wrappers_check_and_cpu_counts_nothing():
    g = torch.zeros((1, 1, 7, 7, 8))
    rois = torch.tensor([[[0.0, 0.0, 30.0, 30.0]]])
    lev = torch.zeros((1, 1), dtype=torch.int32)
    shapes = [(1, 32 >> i, 80 >> i, 8) for i in range(4)]
    before = roi_align_fpn.launches_bwd
    out = roi_align_fpn.fpn_roi_align_bwd(g, rois, lev, shapes, [torch.float32] * 4)
    assert roi_align_fpn.launches_bwd == before
    assert [tuple(o.shape) for o in out] == shapes
    with pytest.raises(TypeError):
        roi_align_fpn.fpn_roi_align_bwd(g.double(), rois, lev, shapes, [torch.float32] * 4)
    with pytest.raises(ValueError):
        roi_align_fpn.fpn_roi_align_bwd(g, rois, lev.long(), shapes, [torch.float32] * 4)
    with pytest.raises(ValueError):
        roi_align_fpn.fpn_roi_align_bwd(g, rois, lev, shapes[:3], [torch.float32] * 3)
    with pytest.raises(ValueError):
        roi_align_fpn.fpn_roi_align_bwd(g[:, :, :, :6], rois, lev, shapes,
                                        [torch.float32] * 4)


# --------------------------------------------------- deform_conv2d, training


def _dcn_inputs(rng, b=2, h=16, w=20, cin=8, cout=16):
    x = rng.randn(b, h, w, cin).astype(np.float32)
    # fractional offsets, some dy beyond the +-3 window of the test
    offsets = (rng.randn(b, h, w, 18) * 2.0).astype(np.float32)
    weight = (rng.randn(9, cin, cout) * 0.1).astype(np.float32)
    bias = rng.randn(cout).astype(np.float32)
    return x, offsets, weight, bias


@pytest.mark.parametrize("boundary_grad", ["clip", "damped", "straight_through"])
def test_deform_conv_training_form_matches_pertap_untiled(rng, boundary_grad):
    """Forward and all four gradients of the training form (``DeformSampleTaps``,
    taps added in order) against ``jax.vjp`` of
    ``_pertap_untiled``, whose sampler and backward are the Pallas kernels
    in interpret mode; f32, rtol 1e-4 and atol 1e-4 (sums over 9 taps x 4
    corners x up to 320 pixels in another order)."""
    x, offsets, weight, bias = _dcn_inputs(rng)
    max_dy = 3
    assert (np.abs(offsets[..., 0::2]) > max_dy).mean() > 0.05
    cot = rng.randn(2, 16, 20, 16).astype(np.float32)
    ref, vjp = jax.vjp(
        lambda *a: dcp._pertap_untiled(*a, 3, 1, max_dy, boundary_grad),
        *(jnp.asarray(a) for a in (x, offsets, weight, bias)))
    ref_grads = vjp(jnp.asarray(cot))
    targs = [_t(a).requires_grad_(True) for a in (x, offsets, weight, bias)]
    before = deform_sample.launches
    got = deform_conv.deform_conv2d(*targs, impl="pallas", max_dy=max_dy,
                                    boundary_grad=boundary_grad)
    got.backward(_t(cot))
    assert deform_sample.launches == before
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)
    for name, t, r in zip(("x", "offsets", "weight", "bias"), targs, ref_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), rtol=1e-4, atol=1e-4,
                                   err_msg=name)
    assert np.abs(np.asarray(ref_grads[1])).max() > 1e-2


def test_deform_conv_without_grad_takes_the_fused_sampler(rng):
    """No gradient requested: the fused 9-tap path, the same numbers as the
    training form to f32 rounding (1e-5)."""
    x, offsets, weight, bias = (_t(a) for a in _dcn_inputs(rng))
    fused = deform_conv.deform_conv2d(x, offsets, weight, bias, impl="pallas")
    with torch.no_grad():
        x.requires_grad_(True)
        still_fused = deform_conv.deform_conv2d(x, offsets, weight, bias, impl="pallas")
    pertap = deform_conv.deform_conv2d(x, offsets, weight, bias, impl="pallas")
    assert fused.grad_fn is None and still_fused.grad_fn is None
    assert pertap.grad_fn is not None
    np.testing.assert_allclose(pertap.detach().numpy(), fused.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("boundary_grad", ["clip", "damped", "straight_through"])
def test_clip_offsets_matches_jax_vjp(rng, boundary_grad):
    """Values and gradients of the three modes, with offsets inside, beyond
    +bound and beyond -bound, each under both cotangent signs. Exact: the
    functions are clamps and selects."""
    bound = 6.0
    v = np.concatenate([rng.uniform(-5.9, 5.9, 64), rng.uniform(6.1, 40, 64),
                        rng.uniform(-40, -6.1, 64)]).astype(np.float32)
    cot = (rng.uniform(0.5, 2.0, v.shape) * rng.choice([-1.0, 1.0], v.shape)).astype(np.float32)
    ref, vjp = jax.vjp(lambda a: jdc.clip_offsets(a, bound, boundary_grad), jnp.asarray(v))
    (ref_g,) = vjp(jnp.asarray(cot))
    tv = _t(v).requires_grad_(True)
    got = deform_conv.clip_offsets(tv, bound, boundary_grad)
    got.backward(_t(cot))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(ref))
    np.testing.assert_array_equal(tv.grad.numpy(), np.asarray(ref_g))
    beyond = np.abs(v) > bound
    if boundary_grad == "clip":
        assert not tv.grad.numpy()[beyond].any()
    elif boundary_grad == "damped":  # only the inward-pointing half passes
        passed = tv.grad.numpy()[beyond] != 0
        np.testing.assert_array_equal(passed, (cot * np.sign(v))[beyond] > 0)
        assert passed.any() and not passed.all()
    else:
        np.testing.assert_array_equal(tv.grad.numpy(), cot)
    with pytest.raises(ValueError):
        deform_conv.clip_offsets(tv, bound, "none")


# --------------------------------------------------------------------- K5


@pytest.mark.parametrize("pooled", [7, 14])
@pytest.mark.parametrize("case", [0, 1], ids=["random", "multistrip_outside"])
def test_fpn_roi_align_bwd_plain_matches_jax_backwards(rng, pooled, case):
    """K5's plain version == the dense XLA backward ``_fpn_roi_align_bwd``
    and the Pallas ``fpn_roi_align_window_bwd`` in interpret mode: random
    RoIs, RoIs wider than one TPU window strip, RoIs partly outside."""
    rois, levels = _roi_cases(rng)[case]
    feats, strides = _pyramid(rng, rois.shape[0])
    shapes = tuple(f.shape for f in feats)
    g = rng.randn(*rois.shape[:2], pooled, pooled, feats[0].shape[-1]).astype(np.float32)
    jargs = (jnp.asarray(rois), jnp.asarray(levels))
    dense = jra._fpn_roi_align_bwd(*jargs, shapes, (jnp.float32,) * 4, jnp.asarray(g),
                                   pooled, 2, strides)
    window = fpn_roi_align_window_bwd(shapes, ("float32",) * 4, *jargs, jnp.asarray(g),
                                      pooled, 2, strides)
    got = roi_align_fpn.fpn_roi_align_bwd(_t(g), _t(rois), _t(levels), shapes,
                                          [torch.float32] * 4, strides=strides)
    assert any(np.abs(o.numpy()).max() > 0.1 for o in got)
    for o, d, w_, sh in zip(got, dense, window, shapes):
        assert tuple(o.shape) == sh
        np.testing.assert_allclose(o.numpy(), np.asarray(d), atol=ROI_ATOL, rtol=1e-5)
        np.testing.assert_allclose(o.numpy(), np.asarray(w_), atol=ROI_ATOL, rtol=1e-5)


def test_fpn_roi_align_function_matches_jax_grad(rng):
    """``FPNRoIAlign`` under autograd == ``jax.grad`` of
    ``fpn_roi_align_batched`` with respect to the pyramid; the RoIs get no
    gradient. atol 2e-5 as above."""
    rois, levels = _roi_cases(rng)[0]
    feats, strides = _pyramid(rng, rois.shape[0])
    cot = rng.randn(*rois.shape[:2], 7, 7, feats[0].shape[-1]).astype(np.float32)

    def loss(fs):
        out = jra.fpn_roi_align_batched(fs, jnp.asarray(rois), jnp.asarray(levels),
                                        pooled=7, strides=strides)
        return jnp.sum(out * jnp.asarray(cot))

    ref = jax.grad(loss)(tuple(jnp.asarray(f) for f in feats))
    tf = [_t(f).requires_grad_(True) for f in feats]
    trois = _t(rois).requires_grad_(True)
    out = roi_align_fpn.FPNRoIAlign.apply(trois, _t(levels), 7, 2, strides, *tf)
    (out * _t(cot)).sum().backward()
    assert trois.grad is None
    for t, r in zip(tf, ref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), atol=ROI_ATOL, rtol=1e-5)
