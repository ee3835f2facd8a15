"""The wide-map and sample-first slice of the port against the JAX package on
the CPU: the port's ``pallas_route`` and ``_col_tile``, K6
(``deform_sample_tiled_taps``) and the tiled form of ``deform_conv2d``, K7a / K7b
(``deform_sample_mt``, ``deform_sample_mt_bwd``) and ``deform_conv2d_mt``,
the tiny model on a canvas whose P2 map is routed to the tiled form, and the
``bench_deform_impls`` tool.

The JAX side runs its Pallas kernels with ``pl.pallas_call`` in interpret
mode. On a CPU the JAX ``pallas_route`` answers ``mxu`` for every shape, so
the routing tests answer its backend test with 'tpu', and the model tests
replace it by a rule that tiles maps at least 256 columns wide (the
narrowest map ``_col_tile`` finds a tile for); the port's ``pallas_route``
takes its VMEM threshold as a keyword and is lowered to the same answers.
Inputs come from numpy seeds. Every tolerance is stated where it is used.
"""

import dataclasses
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from test_torch_predict import CONTINUOUS, DISCRETE, perturbed_params
from test_torch_train import BSZ, LOSS_KEYS, _jax_noise, _t, tiny_train
from upsnet_tpu.config import default_config as jax_default_config
from upsnet_tpu.models import upsnet as jup
from upsnet_tpu.ops import deform_conv_pallas as dcp
from upsnet_tpu.ops.anchors import pyramid_anchors
from upsnet_tpu.ops.deform_conv import deform_conv2d_batched
from upsnet_torch.config import default_config
from upsnet_torch.convert.from_jax import load_jax_params
from upsnet_torch.data.synthetic import synthetic_batch
from upsnet_torch.models import upsnet as tup
from upsnet_torch.ops import deform_conv as tdc
from upsnet_torch.ops import deform_sample as tsample
from upsnet_torch.ops import deform_sample_mt as tmt
from upsnet_torch.tools import bench_deform_impls

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    """Run pallas_call in interpreter mode (no TPU in the test env)."""
    real = pl.pallas_call

    def patched(*args, **kw):
        kw["interpret"] = True
        return real(*args, **kw)

    monkeypatch.setattr(pl, "pallas_call", patched)


# ------------------------------------------------------------ (a) routing

ROUTE_SHAPES = [(208, 336), (256, 512), (320, 640), (208, 800), (208, 832), (26, 42),
                (8, 256), (8, 128), (104, 416), (512, 1024)]


@pytest.mark.parametrize("hw", ROUTE_SHAPES, ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_pallas_route_and_col_tile_equal_the_jax_rule_on_a_tpu(hw):
    """The port's copy is the JAX arithmetic with the backend test answered
    'tpu': equal answers over widths, ``cout`` 128 / 16, windows and
    dilations."""
    h, w = hw
    with mock.patch.object(jax, "default_backend", lambda: "tpu"):
        for cout in (128, 16):
            for max_dy in (6, 3):
                for dilation in (1, 2):
                    assert (tsample._col_tile(w, max_dy, dilation)
                            == dcp._col_tile(w, max_dy, dilation))
                    for cin in (256, 128):
                        shape = (2, h, w, cin)
                        assert (tsample.pallas_route(shape, cout, max_dy, dilation)
                                == dcp.pallas_route(shape, cout, max_dy, dilation)), (
                                    shape, cout, max_dy, dilation)


def test_pallas_route_tiles_the_wide_p2_map_only():
    """At 128 channels and the +-6 window a P2 map 832 columns wide exceeds
    the 13 MiB of the TPU's untiled kernel and has a tile (208), one 800
    wide stays just below it, and the COCO and Cityscapes maps stay
    untiled; a narrower head takes the dense form; the threshold is a
    keyword."""
    assert tsample.pallas_route((1, 208, 832, 256), 128, 6, 1) == ("tiled", 6)
    assert tsample._col_tile(832, 6, 1) == (208, 232)
    assert tsample.pallas_route((1, 208, 800, 256), 128, 6, 1) == ("untiled", None)
    for hw in ((208, 336), (256, 512), (320, 640), (104, 416)):
        assert tsample.pallas_route((2, *hw, 128), 128, 6, 1) == ("untiled", None)
    assert tsample.pallas_route((1, 208, 832, 256), 16, 6, 1) == ("mxu", None)
    assert tsample.pallas_route((1, 8, 256, 32), 128, 3, 1, vmem_limit=2 ** 21) == ("tiled", 3)
    # no column tile (128 is not smaller than the width): the dense form
    assert tsample.pallas_route((1, 8, 128, 32), 128, 3, 1, vmem_limit=2 ** 20) == ("mxu", None)


# ------------------------------------------------------------------ (b) K6


def test_sample_tiled_plain_matches_pallas_kernel(rng):
    """K6's plain version == ``_sample_pallas_tiled`` in interpret mode on a
    map two column tiles wide (w 512, c 128, r 3, dx 3), f32, atol 2e-4 (the
    tolerance the JAX package holds its kernel to). The port reads tap 1 of
    a three-tap projection in place; the JAX kernel gets that tap padded."""
    b, h, w, c, r, dx = 1, 8, 512, 128, 3, 3
    y = rng.randn(b, h, w, 3, c).astype(np.float32)
    sy = (rng.uniform(-2.9, 2.9, (b, h, w)) + np.arange(h)[None, :, None]).astype(np.float32)
    sx = (rng.uniform(-2.9, 2.9, (b, h, w)) + np.arange(w)[None, None, :]).astype(np.float32)
    left = dx + 2
    y_pad = np.pad(y[:, :, :, 1], ((0, 0), (r + 2, r + 2), (left, dcp.CTW - dcp.CT - left),
                                   (0, 0)))
    ref = dcp._sample_pallas_tiled(jnp.asarray(y_pad), jnp.asarray(sy), jnp.asarray(sx), r, dx)
    got = tsample.deform_sample_tiled_plain(_t(y), 1, _t(sy), _t(sx), r, dx)
    assert got.shape == (b, h, w, c) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4)
    outside = ~((sy > -1) & (sy < h) & (sx > -1) & (sx < w))
    assert outside.any() and not got.numpy()[outside].any()
    assert not np.allclose(got.numpy(), tsample.deform_sample_tiled_plain(
        _t(y), 0, _t(sy), _t(sx), r, dx).numpy(), atol=1e-2)


# ------------------------------------------- (c) the tiled form of the conv


def _conv_inputs(seed, b=1, h=8, w=336, cin=16, cout=128, off_scale=9.0):
    """Offsets are odd multiples of 1/16 (never an integer coordinate)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, h, w, cin).astype(np.float32)
    n = int(off_scale * 8)
    offsets = ((2 * rng.randint(-n, n, (b, h, w, 18)) + 1) / 16.0).astype(np.float32)
    weight = (rng.randn(9, cin, cout) * 0.1).astype(np.float32)
    bias = rng.randn(cout).astype(np.float32)
    return x, offsets, weight, bias


@pytest.mark.parametrize("boundary_grad", ["clip", "damped", "straight_through"])
def test_deform_conv2d_tiled_matches_jax_forward_and_gradients(boundary_grad):
    """``_deform_conv2d_tiled`` vs ``_deform_conv2d_pallas_tiled`` at w 336
    (column tiles of 168), offsets uniform in +-9 px against a +-6 window on
    both axes, so that both clips bind. Forward atol 2e-3, gradients 5e-3 +
    1e-3 relative: the tolerances the JAX package holds this form to against
    its exact reference (float32 sums in another order)."""
    x, offsets, weight, bias = _conv_inputs(0)
    assert dcp._col_tile(336, 6, 1) == (168, 192)

    def jloss(x_, o_, w_, b_):
        out = dcp._deform_conv2d_pallas_tiled(x_, o_, w_, b_, 3, 1, 6, 6, boundary_grad)
        return jnp.sum(out ** 2), out

    (_, ref_out), ref_grads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(a) for a in (x, offsets, weight, bias)))
    targs = [_t(a).requires_grad_() for a in (x, offsets, weight)]
    out = tdc._deform_conv2d_tiled(*targs, _t(bias), 3, 1, 6, 6, boundary_grad)
    out.square().sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out), atol=2e-3)
    beyond = np.abs(offsets) > 6
    assert beyond[..., 0::2].mean() > 0.2 and beyond[..., 1::2].mean() > 0.2
    for name, t, ref in zip(("x", "offsets", "weight"), targs, ref_grads):
        ref = np.asarray(ref)
        assert np.abs(ref).max() > 0, name
        np.testing.assert_allclose(t.grad.numpy(), ref, atol=5e-3, rtol=1e-3, err_msg=name)
    got_off = targs[1].grad.numpy()
    if boundary_grad == "clip":
        assert not got_off[beyond].any()  # a saturated offset is stuck, on either axis
    else:
        assert got_off[beyond][0::2].any() and got_off[beyond][1::2].any()


def test_impl_pallas_on_a_map_the_tpu_would_tile_is_the_tiled_form():
    """A map 832 columns wide at ``cout`` 128: ``deform_conv2d(impl="pallas")``
    computes what ``_deform_conv2d_pallas_tiled`` computes, dx clipped to +-6
    as well as dy, with or without gradients, and so does the fallback of
    ``shift`` where its own rule refuses the shape (16 rows of this width);
    ``mxu`` and ``auto`` do not clip dx. Forward atol 2e-3 as above."""
    x, offsets, weight, bias = _conv_inputs(1, w=832)
    ref = np.asarray(dcp._deform_conv2d_pallas_tiled(
        *(jnp.asarray(a) for a in (x, offsets, weight, bias)), 3, 1, 6, 6))
    targs = [_t(a) for a in (x, offsets, weight, bias)]
    assert tsample.pallas_route(targs[0].shape, 128, 6, 1) == ("tiled", 6)
    tall = [_t(a) for a in _conv_inputs(4, h=16, w=832)]
    assert not tdc.shift_route_ok(tall[0].shape, 128, 6, 6, 1)
    with mock.patch.object(tdc.DeformSampleTaps, "apply", side_effect=AssertionError("untiled")), \
            mock.patch.object(tdc, "deform_sample9", side_effect=AssertionError("untiled")):
        got = tdc.deform_conv2d(*targs, impl="pallas")
        np.testing.assert_allclose(got.numpy(), ref, atol=2e-3)
        assert torch.equal(tdc.deform_conv2d(*tall, impl="shift"),
                           tdc._deform_conv2d_tiled(*tall, 3, 1, 6, 6))
        with_grad = tdc.deform_conv2d(targs[0].requires_grad_(), *targs[1:], impl="pallas")
    assert with_grad.requires_grad and torch.equal(with_grad.detach(), got)
    for impl in ("mxu", "auto"):
        free_dx = tdc.deform_conv2d(targs[0].detach(), *targs[1:], impl=impl)
        assert float((free_dx - got).abs().max()) > 0.1, impl
    narrow = [a[:, :, :336] for a in targs[:2]] + targs[2:]
    assert torch.equal(tdc.deform_conv2d(*narrow, impl="pallas"),
                       tdc.deform_conv2d(*narrow, impl="mxu"))


def test_tiled_form_adds_the_taps_in_the_input_dtype():
    """bf16: the tiled form rounds after every tap, as the JAX package does
    (also without gradients), where the shift form adds in float32 and
    rounds once. Against JAX: one bf16 ulp of the output plus 2^-6 absolute
    for the differently rounded projections and partial sums."""
    x, offsets, weight, bias = _conv_inputs(2, w=256, off_scale=3.0)
    ref = dcp._deform_conv2d_pallas_tiled(
        jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(offsets),
        jnp.asarray(weight).astype(jnp.bfloat16), jnp.asarray(bias).astype(jnp.bfloat16),
        3, 1, 6, 6)
    args = (_t(x).bfloat16(), _t(offsets), _t(weight).bfloat16(), _t(bias).bfloat16())
    got = tdc._deform_conv2d_tiled(*args, 3, 1, 6, 6)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               rtol=2.0 ** -7, atol=2.0 ** -6)
    fused = tdc.deform_conv2d_shift(*args)
    assert not torch.equal(fused, got)  # f32 tap sums round elsewhere
    np.testing.assert_allclose(got.float().numpy(), fused.float().numpy(),
                               rtol=2.0 ** -5, atol=2.0 ** -5)


# ------------------------------------------------------------ (d) K7a, K7b

MB, MH, MW, MC, MK = 1, 8, 12, 16, 9
MR = 3  # the Pallas kernels' window radius; |sy - i| stays inside it


def _mt_coords(rng, kind):
    """Sample coordinates (K, B, H, W): ``fractional`` multiples of 1/8 that
    are never integers, ``integer``, or ``outside``: fractional with dx up to
    +-20 columns, so that many samples leave (-1, W)."""
    shape = (MK, MB, MH, MW)
    spread_x = 20 if kind == "outside" else 3
    dy = rng.randint(-MR * 8 + 1, MR * 8, shape) / 8.0
    dx = rng.randint(-spread_x * 8, spread_x * 8, shape) / 8.0
    if kind == "integer":
        dy, dx = np.round(dy), np.round(dx)
    else:
        dy = np.where(dy == np.round(dy), dy + 0.375, dy)
        dx = np.where(dx == np.round(dx), dx - 0.375, dx)
        dy = np.clip(dy, -MR + 0.125, MR - 0.125)
    sy = np.arange(MH, dtype=np.float32)[None, None, :, None] + dy
    sx = np.arange(MW, dtype=np.float32)[None, None, None, :] + dx
    return sy.astype(np.float32), sx.astype(np.float32)


def _mt_jax_layout(x, sy, sx):
    """The padded input and the (B, H, K, Wpd) coordinates with -1e9
    sentinels that ``deform_conv2d_pallas_mt`` hands its kernels."""
    wp = wpd = 128
    x_pad = np.pad(x, ((0, 0), (MR + 2, MR + 2), (1, wp - MW - 1), (0, 0)))
    pad = ((0, 0), (0, 0), (0, 0), (0, wpd - MW))
    sy_j = np.pad(sy.transpose(1, 2, 0, 3), pad, constant_values=-1e9)
    sx_j = np.pad(sx.transpose(1, 2, 0, 3), pad, constant_values=-1e9)
    return jnp.asarray(x_pad), jnp.asarray(sy_j), jnp.asarray(sx_j)


MT_KINDS = ["fractional", "integer", "outside"]


@pytest.mark.parametrize("kind", MT_KINDS)
def test_sample_mt_plain_matches_pallas_kernel(rng, kind):
    """K7a's plain version == ``_sample_pallas_mt`` in interpret mode, f32:
    rtol 1e-5, atol 1e-5 (sums in another order)."""
    x = rng.randn(MB, MH, MW, MC).astype(np.float32)
    sy, sx = _mt_coords(rng, kind)
    x_pad, sy_j, sx_j = _mt_jax_layout(x, sy, sx)
    ref = dcp._sample_pallas_mt(x_pad, sy_j, sx_j, dcp._mt_syt(sy_j), MR)
    ref = np.moveaxis(np.asarray(ref)[:, :, :, :MW], 2, 3)  # (B, H, W, K, C)
    before = tmt.launches
    got = tmt.deform_sample_mt(_t(x), _t(sy), _t(sx))
    assert got.shape == (MB, MH, MW, MK, MC) and got.dtype == torch.float32
    assert tmt.launches == before
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    if kind == "outside":
        outside = ~((sy > -1) & (sy < MH) & (sx > -1) & (sx < MW))
        assert outside.mean() > 0.2
        assert not got.numpy().transpose(3, 0, 1, 2, 4)[outside].any()


@pytest.mark.parametrize("kind", MT_KINDS)
def test_sample_mt_bwd_plain_matches_pallas_kernel(rng, kind):
    """K7b's plain version == the JAX backward (``_mt_bwd``: three launches
    of ``_sample_pallas_mt_bwd``, one per group of three taps, and the f32
    overlap-add) in interpret mode, f32. At integer coordinates both give
    gsy = gsx = 0 exactly."""
    x = rng.randn(MB, MH, MW, MC).astype(np.float32)
    g = rng.randn(MB, MH, MW, MK, MC).astype(np.float32)
    sy, sx = _mt_coords(rng, kind)
    x_pad, sy_j, sx_j = _mt_jax_layout(x, sy, sx)
    g_j = np.pad(np.moveaxis(g, 3, 2), ((0, 0), (0, 0), (0, 0), (0, 128 - MW), (0, 0)))
    r_gx, r_gsy, r_gsx = dcp._mt_bwd(MR, (x_pad, sy_j, sx_j), jnp.asarray(g_j))
    r_gx = np.asarray(r_gx)[:, MR + 2:MR + 2 + MH, 1:1 + MW]
    r_gsy = np.asarray(r_gsy)[..., :MW].transpose(2, 0, 1, 3)  # (K, B, H, W)
    r_gsx = np.asarray(r_gsx)[..., :MW].transpose(2, 0, 1, 3)
    before = tmt.launches_bwd
    gx, gsy, gsx = tmt.deform_sample_mt_bwd(_t(x), _t(sy), _t(sx), _t(g))
    assert tmt.launches_bwd == before
    assert gx.shape == x.shape and gsy.shape == gsx.shape == (MK, MB, MH, MW)
    # up to 9 x 4 x W terms per element of grad_x; 4 x C products per
    # coordinate gradient
    np.testing.assert_allclose(gx.numpy(), r_gx, rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(gsy.numpy(), r_gsy, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(gsx.numpy(), r_gsx, rtol=1e-5, atol=1e-4)
    if kind == "integer":
        assert not gsy.numpy().any() and not gsx.numpy().any()
        assert not r_gsy.any() and not r_gsx.any()
        assert np.abs(gx.numpy()).max() > 0
    else:
        assert np.abs(gsy.numpy()).max() > 1 and np.abs(gsx.numpy()).max() > 1


def test_deform_sample_mt_function_is_its_taps_one_by_one(rng):
    """``DeformSampleMT`` == the one-tap plain K2 and K3 on each tap of the
    same input (``deform_sample_plain``, ``deform_sample_bwd_plain``):
    equal columns, and gradients to x (the taps' sum), sy, sx within f32
    summation order."""
    x = rng.randn(MB, MH, MW, MC).astype(np.float32)
    g = _t(rng.randn(MB, MH, MW, MK, MC).astype(np.float32))
    sy, sx = (_t(a) for a in _mt_coords(rng, "outside"))
    a = [_t(x).requires_grad_(), sy.clone().requires_grad_(), sx.clone().requires_grad_()]
    cols = tmt.DeformSampleMT.apply(*a)
    taps = torch.stack([tsample.deform_sample_plain(_t(x), sy[t], sx[t]) for t in range(MK)],
                       dim=3)
    assert torch.equal(cols, taps)
    cols.backward(g)
    grads = [tsample.deform_sample_bwd_plain(_t(x), sy[t], sx[t], g[:, :, :, t].contiguous())
             for t in range(MK)]
    gx = torch.stack([gr[0] for gr in grads]).sum(0)
    gsy, gsx = (torch.stack([gr[i] for gr in grads]) for i in (1, 2))
    for u, v in zip(a, (gx, gsy, gsx)):
        np.testing.assert_allclose(u.grad.numpy(), v.numpy(), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------ (e) deform_conv2d_mt


@pytest.mark.parametrize("dilation, dx_px", [(1, 5), (2, 5), (1, 20)], ids=["1", "2", "1-dx20"])
def test_deform_conv2d_mt_matches_jax_forward_and_gradients(dilation, dx_px):
    """``deform_conv2d_mt`` vs ``deform_conv2d_pallas_mt`` with bias: offsets
    uniform in +-5 px against a +-3 window (dy clamped, dx free), dx also in
    +-20 px (as ``_mt_coords``'s ``outside`` kind: many samples leave the
    map). Forward atol 2e-4; each gradient within 1e-4 of its largest
    reference entry (float32 on both sides; JAX rounds nothing in
    float32)."""
    x, offsets, weight, bias = _conv_inputs(3, b=2, h=8, w=12, cin=8, cout=8, off_scale=5.0)
    offsets[..., 1::2] *= dx_px / 5  # odd multiples of 1/16 or 1/4: never integers
    kw = dict(kernel_size=3, dilation=dilation, max_dy=MR)

    def jloss(x_, o_, w_, b_):
        out = dcp.deform_conv2d_pallas_mt(x_, o_, w_, b_, **kw)
        return jnp.sum(out ** 2), out

    (_, ref_out), ref_grads = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3), has_aux=True)(
        *(jnp.asarray(a) for a in (x, offsets, weight, bias)))
    targs = [_t(a).requires_grad_() for a in (x, offsets, weight, bias)]
    out = tdc.deform_conv2d_mt(*targs, **kw)
    out.square().sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out), atol=2e-4)
    beyond_dy = np.abs(offsets[..., 0::2]) > MR
    assert beyond_dy.mean() > 0.2
    for name, t, ref in zip(("x", "offsets", "weight", "bias"), targs, ref_grads):
        ref = np.asarray(ref)
        scale = np.abs(ref).max()
        assert scale > 0, name
        np.testing.assert_allclose(t.grad.numpy(), ref, rtol=0, atol=1e-4 * scale,
                                   err_msg=name)
    got_off = targs[1].grad.numpy()
    assert not got_off[..., 0::2][beyond_dy].any()  # a clamped dy is stuck
    assert got_off[..., 1::2][np.abs(offsets[..., 1::2]) > MR].any()  # dx is free


def test_deform_conv2d_mt_takes_any_height_and_kernel_size(rng):
    """The JAX wrapper wants an even H; the port has no such limit. Odd H
    and W against the exact gather form (offsets inside the window, so no
    clamp acts), atol 2e-4; a 5x5 kernel against the port's own exact form;
    an even kernel size is refused."""
    x = rng.randn(1, 7, 9, 8).astype(np.float32)
    offsets = np.clip(rng.randn(1, 7, 9, 18) * 1.5, -5.5, 5.5).astype(np.float32)
    weight = (rng.randn(9, 8, 8) * 0.1).astype(np.float32)
    bias = rng.randn(8).astype(np.float32)
    ref = deform_conv2d_batched(*(jnp.asarray(a) for a in (x, offsets, weight, bias)))
    got = tdc.deform_conv2d_mt(_t(x), _t(offsets), _t(weight), _t(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4)
    off5 = np.clip(rng.randn(1, 7, 9, 50) * 1.5, -5.5, 5.5).astype(np.float32)
    w5 = (rng.randn(25, 8, 8) * 0.1).astype(np.float32)
    got5 = tdc.deform_conv2d_mt(_t(x), _t(off5), _t(w5), kernel_size=5)
    want5 = tdc.deform_conv2d(_t(x), _t(off5), _t(w5), kernel_size=5, impl="auto")
    np.testing.assert_allclose(got5.numpy(), want5.numpy(), atol=2e-4)
    with pytest.raises(ValueError):
        tdc.deform_conv2d_mt(_t(x), _t(offsets[..., :8]), _t(weight[:4]), kernel_size=2)


# ------------------------------------------------------------ (f) wrappers


@pytest.mark.parametrize("what", ["sy_shape", "reach_y", "reach_x"])
def test_sample_tiled_wrapper_rejects_malformed_input(rng, what):
    """K6's wrapper (``deform_sample_tiled_taps``) on the checks that
    ``test_all_tap_wrappers_reject_malformed_input`` leaves out: a wrong
    spatial shape of sy, and a counted sample beyond the row or the column
    reach, which the CPU path checks because the kernel cannot."""
    y = _t(rng.randn(1, 6, 10, 3, 8).astype(np.float32))
    sy = _t((np.arange(6)[None, None, :, None] + rng.uniform(-1.5, 1.5, (3, 1, 6, 10))).astype(
        np.float32))
    sx = _t((np.arange(10)[None, None, None, :] + rng.uniform(-1.5, 1.5, (3, 1, 6, 10))).astype(
        np.float32))
    call = tsample.deform_sample_tiled_taps
    call(y, sy, sx, 2, 2)
    bad = {
        "sy_shape": lambda: call(y, sy[:, :, :5].contiguous(), sx, 2, 2),
        "reach_y": lambda: call(y, sy, sx, 1, 2),
        "reach_x": lambda: call(y, sy, sx, 2, 1),
    }[what]
    with pytest.raises(ValueError):
        bad()


@pytest.mark.parametrize("what", ["x_dims", "sy_dims", "sx_shape", "sy_dtype", "x_dtype",
                                  "x_strides", "g_shape", "g_dtype", "device"])
def test_sample_mt_wrappers_reject_malformed_input(rng, what):
    x = _t(rng.randn(MB, MH, MW, MC).astype(np.float32))
    g = _t(rng.randn(MB, MH, MW, MK, MC).astype(np.float32))
    sy, sx = (_t(a) for a in _mt_coords(rng, "fractional"))
    fwd, bwd = tmt.deform_sample_mt, tmt.deform_sample_mt_bwd
    bad = {
        "x_dims": (ValueError, lambda: fwd(x[0], sy, sx)),
        "sy_dims": (ValueError, lambda: fwd(x, sy[0], sx)),
        "sx_shape": (ValueError, lambda: fwd(x, sy, sx[:, :, :, :5])),
        "sy_dtype": (TypeError, lambda: fwd(x, sy.double(), sx)),
        "x_dtype": (TypeError, lambda: fwd(x.to(torch.float16), sy, sx)),
        "x_strides": (ValueError, lambda: fwd(x.transpose(1, 2).contiguous().transpose(1, 2),
                                              sy, sx)),
        "g_shape": (ValueError, lambda: bwd(x, sy, sx, g[:, :, :, :3])),
        "g_dtype": (TypeError, lambda: bwd(x, sy, sx, g.bfloat16())),
        "device": (ValueError, lambda: fwd(x.to("meta"), sy.to("meta"), sx.to("meta"))),
    }
    error, fn = bad[what]
    with pytest.raises(error):
        fn()


# -------------------------------------------------- (g) the slice as a whole

WH, WW = 64, 1024  # P2 16x256 (tiled), P3 8x128, P4 4x64, P5 2x32 (untiled)
TILE_FROM = 256
PORT_VMEM_LIMIT = 5 * 2 ** 19  # 2.5 MiB: between the estimates at w 128 and w 256


def tiny_wide(cfg):
    """``tiny_train`` with an FCN head 128 wide (the TPU kernels want a
    multiple of 128) and a +-3 px window (small unrolled candidate loops in
    the interpreted kernels)."""
    cfg = tiny_train(cfg)
    return cfg.replace(network=dataclasses.replace(
        cfg.network, dcn_impl="pallas", fcn_head_dim=128, dcn_max_dy=MR))


def _jax_route(shape, cout, max_dy, dilation):
    return ("tiled", max_dy) if shape[2] >= TILE_FROM else ("untiled", None)


@pytest.fixture
def routed(monkeypatch):
    """Both packages tile maps at least 256 wide, and the port records the
    shapes that reach its tiled form."""
    monkeypatch.setattr(dcp, "pallas_route", _jax_route)
    monkeypatch.setattr(tdc, "pallas_route", functools.partial(
        tsample.pallas_route, vmem_limit=PORT_VMEM_LIMIT))
    for w in (32, 64, 128, 256):
        for cin in (32, 128):
            assert (tdc.pallas_route((BSZ, 8, w, cin), 128, MR, 1)
                    == _jax_route((BSZ, 8, w, cin), 128, MR, 1))
    tiled = []
    real = tdc._deform_conv2d_tiled
    monkeypatch.setattr(tdc, "_deform_conv2d_tiled",
                        lambda x, *a, **kw: (tiled.append(tuple(x.shape)), real(x, *a, **kw))[1])
    return tiled


@pytest.fixture(scope="module")
def model_setup():
    jcfg, tcfg = tiny_wide(jax_default_config()), tiny_wide(default_config())
    jm = jup.build_model(jcfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 96, 3)))["params"]
    params = perturbed_params(params)
    tm = tup.build_model(tcfg, device="cpu")
    load_jax_params(tm, params)
    anchors = pyramid_anchors((WH, WW))
    return dict(jcfg=jcfg, tcfg=tcfg, jm=jm, params=params, tm=tm, anchors=anchors,
                janchors=tuple(jnp.asarray(a) for a in anchors),
                tanchors=tuple(torch.from_numpy(a) for a in anchors))


def test_forward_predict_wide_matches_jax(model_setup, routed):
    """Predict outputs of the tiny ``dcn_impl: pallas`` model on a 64x1024
    canvas: discrete ones equal, continuous ones within rtol 1e-4 and atol
    1e-4 * max |ref|, as ``test_torch_predict.py`` holds the default route
    (``seg_logits``, the output the DCN route reaches, agrees to 2e-6 of its
    maximum). ``mask_logits`` get 3e-4 * max |ref|: box coordinates up to
    1023 px carry ten times the float32 rounding of the 96 px canvas (boxes
    differ by 2.5e-3 px), and ROIAlign and the mask head carry that on. The
    tiled form ran for the two layers of P2 and for nothing else."""
    s = model_setup
    rng = np.random.RandomState(0)
    images = rng.uniform(-10, 10, (BSZ, WH, WW, 3)).astype(np.float32)
    im_hw = np.array([[WH, WW], [WH - 8, WW - 16]], np.float32)
    jpredict = jax.jit(lambda p, b: jup.forward_predict(s["jm"], p, s["jcfg"],
                                                        s["janchors"], b))
    ref = jax.device_get(jpredict(s["params"], {"images": jnp.asarray(images),
                                                "im_hw": jnp.asarray(im_hw)}))
    got = tup.forward_predict(s["tm"], s["tcfg"], s["tanchors"],
                              {"images": _t(images), "im_hw": _t(im_hw)})
    assert routed == [(BSZ, WH // 4, WW // 4, 32), (BSZ, WH // 4, WW // 4, 128)]
    assert np.asarray(ref["det_valid"]).any()
    for k in DISCRETE:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
    for k in CONTINUOUS:
        g, r = got[k].numpy(), np.asarray(ref[k])
        fin = np.isfinite(r)
        np.testing.assert_array_equal(np.isfinite(g), fin, err_msg=k)
        atol = (3e-4 if k == "mask_logits" else 1e-4) * np.abs(r[fin]).max()
        np.testing.assert_allclose(np.where(fin, g, 0), np.where(fin, r, 0), rtol=1e-4,
                                   atol=atol, err_msg=k)
    assert np.abs(got["seg_logits"].numpy() - np.asarray(ref["seg_logits"])).max() < 2e-5


def test_forward_train_wide_loss_dict_matches_jax(model_setup, routed):
    """The 7 loss terms with shared weights and shared noise: rtol 1e-4, as
    ``test_torch_train.py`` holds the untiled route; the backward reaches the
    offset convs through K3's plain version on P2's tap blocks."""
    s = model_setup
    tcfg = s["tcfg"]
    batch = synthetic_batch(tcfg, (WH, WW), BSZ, 1, image_hw=(WH - 4, WW - 8))
    key = jax.random.PRNGKey(5)
    n_anchors = sum(a.shape[0] for a in s["anchors"])
    n_cand = tcfg.train.rpn_post_nms_top_n + tcfg.train.max_gt_instances
    _, noise = _jax_noise(key, n_anchors, n_cand, tcfg.train.max_gt_instances)
    _, ref = jax.jit(lambda p, b: jup.forward_train(
        s["jm"], p, s["jcfg"], s["janchors"], b, key))(
            s["params"], {k: jnp.asarray(v) for k, v in batch.items()})
    ref = jax.device_get(ref)
    total, losses = tup.forward_train(s["tm"], tcfg, s["tanchors"],
                                      {k: _t(v) for k, v in batch.items()},
                                      {k: _t(v) for k, v in noise.items()})
    assert routed == [(BSZ, WH // 4, WW // 4, 32), (BSZ, WH // 4, WW // 4, 128)]
    assert tuple(losses) == LOSS_KEYS
    for k in LOSS_KEYS:
        assert np.isfinite(float(ref[k])), k
        np.testing.assert_allclose(float(losses[k].detach()), float(ref[k]), rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    assert float(ref["seg"]) > 0 and float(ref["pano"]) > 0
    total.backward()
    off = s["tm"].fcn_head.subnet.dcn1.offset_conv
    assert off.weight.grad.abs().max() > 0 and off.bias.grad.abs().max() > 0
    s["tm"].zero_grad(set_to_none=True)


def test_converted_weights_serve_the_tiled_and_the_mt_form(model_setup, rng):
    """The tiled and the sample-first form use the same (K, Cin, Cout)
    tap-major weight as every other route, so the bridge needs no new name:
    the JAX kernel of ``dcn2`` through both JAX forms against the converted
    weight through the port's, atol 2e-3 as above (128 input channels)."""
    s = model_setup
    kernel = s["params"]["fcn_head"]["subnet"]["dcn2"]["kernel"]  # (9, Cin, Cout)
    dcn = s["tm"].fcn_head.subnet.dcn2
    o, i, k, _ = dcn.weight.shape
    w_taps = dcn.weight.detach().reshape(o, i, k * k).permute(2, 1, 0)
    np.testing.assert_array_equal(w_taps.numpy(), kernel)
    x = rng.randn(1, 8, 256, i).astype(np.float32)
    offsets = rng.uniform(-5, 5, (1, 8, 256, 18)).astype(np.float32)
    jargs = (jnp.asarray(x), jnp.asarray(offsets), jnp.asarray(kernel), None)
    ref_tiled = dcp._deform_conv2d_pallas_tiled(*jargs, 3, 1, MR, MR)
    ref_mt = dcp.deform_conv2d_pallas_mt(*jargs, max_dy=MR)
    with mock.patch.object(tdc, "pallas_route", functools.partial(
            tsample.pallas_route, vmem_limit=PORT_VMEM_LIMIT)):
        got_tiled = tdc.deform_conv2d(_t(x), _t(offsets), w_taps, impl="pallas", max_dy=MR)
    got_mt = tdc.deform_conv2d_mt(_t(x), _t(offsets), w_taps, max_dy=MR)
    np.testing.assert_allclose(got_tiled.numpy(), np.asarray(ref_tiled), atol=2e-3)
    np.testing.assert_allclose(got_mt.numpy(), np.asarray(ref_mt), atol=2e-3)
    assert float((got_tiled - got_mt).abs().max()) > 0.1  # dx clipped against dx free


# ---------------------------------------------------------------- (h) tool


def test_bench_deform_impls_runs_on_the_cpu(capsys):
    """The tool at one tiny float32 shape on the CPU: one row per form with
    four finite times, ``mt`` equal to ``pertap`` within 1e-4 (|dy| <= 2, no
    clamp acts), one printed line per row."""
    rows = bench_deform_impls.main(device="cpu", batch=1, shapes=(((8, 12), 16),), reps=1,
                                   dtype=torch.float32)
    assert [r["impl"] for r in rows] == ["pertap", "mt"]
    for r in rows:
        assert (r["h"], r["w"], r["cin"]) == (8, 12, 16)
        times = [v for k, v in r.items() if k.endswith("_ms")]
        assert len(times) == 4 and all(np.isfinite(t) and t > 0 for t in times)
    assert rows[1]["const2_max_abs_diff"] < 1e-4 and rows[1]["rand2_max_abs_diff"] < 1e-4
    printed = capsys.readouterr().out.splitlines()
    assert sum(line.startswith("8x12 cin=16") for line in printed) == 2


def test_bench_deform_impls_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_deform_impls.main()
