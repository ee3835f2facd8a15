"""The unclipped DCN routes (``dcn_impl`` ``auto`` and ``gather``) of the port
against the JAX package on the CPU.

Under autograd these routes sample the K taps one by one (K2) in one
``DeformSampleTaps`` node whose backward is the unclipped all-tap K3
(``deform_sample_bwd_unclipped``; on the CPU its plain version). Held here:
the gradients of ``deform_conv2d`` against ``jax.grad`` of the exact gather
form ``deform_conv2d_batched``, offsets near and far beyond any window; the
plain backward against nine one-tap plain backwards; that one node is built
per layer; and ``deform_conv2d(impl="auto")`` against the JAX
``deform_conv2d_auto`` on a map that the JAX routing rule, lowered as
``test_torch_tiled_mt.py`` lowers it, sends to the column-tiled Pallas
kernel, run in interpret mode. Then the derivative at integer sample
coordinates route by route (``gather``, ``mxu``, ``pallas`` routed to
``mxu`` and untiled, ``auto`` inside and beyond its window), at zero offsets
and on an integer-heavy field, against ``jax.grad`` of the JAX function each
route stands for on a TPU.

Inputs come from numpy seeds. Every tolerance is stated where it is used.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from upsnet_tpu.ops import deform_conv as jdc
from upsnet_tpu.ops import deform_conv_pallas as dcp
from upsnet_torch.ops import deform_conv as tdc
from upsnet_torch.ops import deform_sample as tsample

torch.set_num_threads(2)


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


def _conv_inputs(seed, off_scale, b=2, h=10, w=14, cin=8, cout=16):
    """Offsets are odd multiples of 1/16 in +-off_scale px: never an integer
    coordinate, where the JAX gather form differentiates one-sidedly."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, h, w, cin).astype(np.float32)
    n = int(off_scale * 8)
    offsets = ((2 * rng.randint(-n, n, (b, h, w, 18)) + 1) / 16.0).astype(np.float32)
    weight = (rng.randn(9, cin, cout) * 0.1).astype(np.float32)
    bias = rng.randn(cout).astype(np.float32)
    return x, offsets, weight, bias


# ------------------------------------------------- gradients against jax.grad

FIELDS = {"near": 3.0, "far": 20.0}


@pytest.mark.parametrize("field", list(FIELDS))
@pytest.mark.parametrize("impl", ["gather", "auto"])
def test_exact_route_gradients_match_jax_grad(impl, field):
    """Forward and the gradients to x, offsets, weight and bias of
    ``deform_conv2d(impl)`` against ``jax.value_and_grad`` of
    ``deform_conv2d_batched`` (MXNet ``deformable_im2col`` semantics at any
    offset) on a 10x14 map: offsets in +-3 px, and in +-20 px, where most
    samples of the map lie beyond it and many outside it. Forward atol 1e-4;
    per gradient |got - ref| <= 1e-3 |ref| + 1e-4 max|ref| (f32, sums over 9
    taps and 4 corners in another order), as the port's other gradient
    parity tests hold."""
    x, offsets, weight, bias = _conv_inputs(1, FIELDS[field])
    cot = np.random.RandomState(2).randn(2, 10, 14, 16).astype(np.float32)

    def jloss(*a):
        out = jdc.deform_conv2d_batched(*a)
        return jnp.sum(out * cot), out

    (_, ref_out), ref_grads = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3), has_aux=True)(
        *(jnp.asarray(a) for a in (x, offsets, weight, bias)))
    targs = [_t(a).requires_grad_() for a in (x, offsets, weight, bias)]
    out = tdc.deform_conv2d(*targs, impl=impl)
    (out * _t(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out), atol=1e-4)
    iy = np.arange(10)[None, :, None, None]
    ix = np.arange(14)[None, None, :, None]
    outside = ((iy + offsets[..., 0::2] <= -2) | (iy + offsets[..., 0::2] >= 11)
               | (ix + offsets[..., 1::2] <= -2) | (ix + offsets[..., 1::2] >= 15))
    if field == "far":
        assert outside.mean() > 0.5 and (np.abs(offsets) > 6).mean() > 0.6
    for name, t, ref in zip(("x", "offsets", "weight", "bias"), targs, ref_grads):
        ref = np.asarray(ref)
        scale = np.abs(ref).max()
        assert scale > 0, name
        np.testing.assert_allclose(t.grad.numpy(), ref, rtol=1e-3, atol=1e-4 * scale,
                                   err_msg=name)


def _jax_untiled(*a):
    """The JAX layer as the TPU runs ``dcn_impl: pallas`` where its routing
    rule answers ``untiled``: the per-tap Pallas kernels (interpreted) and
    their backward kernel."""
    return dcp.deform_conv2d_pallas.__wrapped__(*a, 3, 1, 6)


# case: (port impl, Cout, the JAX function the route stands for on a TPU,
# its rule at an integer coordinate)
RULE_CASES = {
    "gather": ("gather", 16, lambda *a: jdc.deform_conv2d_batched(*a), "floor"),
    "mxu": ("mxu", 16, lambda *a: jdc.deform_conv2d_mxu(*a, 3, 1, 6), "hat"),
    # Cout % 128 != 0: pallas_route answers mxu, on a TPU as here
    "pallas_to_mxu": ("pallas", 16, lambda *a: jdc.deform_conv2d_mxu(*a, 3, 1, 6), "hat"),
    "pallas_untiled": ("pallas", 128, _jax_untiled, "pallas"),
    # the JAX cond itself; at Cout 16 its fast branch is the mxu form on a
    # TPU as on this CPU, and its exact branch the gather form
    "auto_in_window": ("auto", 16, lambda *a: jdc.deform_conv2d_auto(*a, 3, 1, 6), "hat"),
    "auto_beyond": ("auto", 16, lambda *a: jdc.deform_conv2d_auto(*a, 3, 1, 6), "floor"),
}


def _rule_offsets(case, field):
    """``zero`` offsets (every sample on an integer coordinate, as every
    offset conv starts) or ``integer_heavy`` ones: uniform in +-3 px with a
    quarter of the components rounded to integers, as ``_taps`` draws them;
    for ``auto_beyond`` one dy set to 7.0, beyond the +-6 window."""
    if field == "zero":
        offsets = np.zeros((2, 10, 14, 18), np.float32)
    else:
        rng = np.random.RandomState(7)
        offsets = rng.uniform(-3, 3, (2, 10, 14, 18))
        offsets = np.where(rng.rand(*offsets.shape) < 0.25, np.round(offsets), offsets)
        offsets = offsets.astype(np.float32)
    if case == "auto_beyond":
        offsets[1, 4, 5, 8] = 7.0
    return offsets


@pytest.mark.parametrize("field", ["zero", "integer_heavy"])
@pytest.mark.parametrize("case", list(RULE_CASES))
def test_zero_offsets_get_no_gradient_here_and_a_one_sided_one_in_jax(monkeypatch, case,
                                                                     field):
    """The derivative at integer sample coordinates, route by route: the
    forward and the gradients to x, offsets, weight and bias of
    ``deform_conv2d(impl)`` against ``jax.value_and_grad`` of the JAX
    function that the route stands for on a TPU (``RULE_CASES``), at zero
    offsets and on an integer-heavy field. ``gather`` and ``auto`` beyond the
    window take the gather form's one-sided derivative, ``mxu`` and
    ``pallas`` routed to ``mxu`` (and ``auto`` inside the window at that
    width) the mxu form's, where abs' is +1 at 0 and a maximum's tie takes
    half; ``pallas`` untiled keeps the Pallas kernels' 0 at integers (JAX's
    routing rule, which answers ``mxu`` on a CPU, given the port's, which is
    the TPU's arithmetic). So an offset conv that starts at zero gets a
    gradient wherever its reference route gives one. Tolerances as above:
    atol 1e-4 on the forward; 1e-3 |ref| + 1e-4 max|ref| per gradient."""
    impl, cout, jax_fn, rule = RULE_CASES[case]
    x, _, weight, bias = _conv_inputs(3, 1.0, cout=cout)
    offsets = _rule_offsets(case, field)
    port_route = tsample.pallas_route(x.shape, cout, 6, 1)[0]
    assert port_route == ("untiled" if cout == 128 else "mxu")
    monkeypatch.setattr(dcp, "pallas_route", tsample.pallas_route)
    cot = np.random.RandomState(4).randn(2, 10, 14, cout).astype(np.float32)

    def jloss(*a):
        out = jax_fn(*a)
        return jnp.sum(out * cot), out

    (_, ref_out), ref_grads = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3), has_aux=True)(
        *(jnp.asarray(a) for a in (x, offsets, weight, bias)))
    targs = [_t(a).requires_grad_() for a in (x, offsets, weight, bias)]
    out = tdc.deform_conv2d(*targs, impl=impl)
    (out * _t(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out), atol=1e-4)
    for name, t, ref in zip(("x", "offsets", "weight", "bias"), targs, ref_grads):
        ref = np.asarray(ref)
        np.testing.assert_allclose(t.grad.numpy(), ref, rtol=1e-3,
                                   atol=1e-4 * np.abs(ref).max(), err_msg=name)
    got = targs[1].grad.numpy()
    if rule == "pallas" and field == "zero":
        assert not got.any()
    else:
        assert (got != 0).mean() > 0.5 and np.abs(got).max() > 0.1
    if field == "zero" and rule != "pallas":
        # the gather and mxu forms' derivatives differ at integers
        other = (jdc.deform_conv2d_mxu if rule == "floor" else
                 lambda *a: jdc.deform_conv2d_batched(*a))
        _, other_grads = jax.value_and_grad(
            lambda *a: jnp.sum(other(*a) * cot), argnums=(0, 1, 2, 3))(
                *(jnp.asarray(a) for a in (x, offsets, weight, bias)))
        assert np.abs(np.asarray(other_grads[1]) - got).max() > 0.1


@pytest.mark.parametrize("route", ["tiled", "shift", "mt"])
def test_the_pallas_kernels_routes_keep_zero_at_integers(monkeypatch, route):
    """The routes that stand for a Pallas backward kernel keep its rule: at
    zero offsets the offsets get exactly no gradient (the tiled form with
    the routing rule answering ``tiled``, ``shift`` with every layer sent to
    the shift kernels, ``deform_conv2d_mt``), while x and the weight do."""
    x, _, weight, bias = _conv_inputs(3, 1.0)
    targs = [_t(a).requires_grad_() for a in (x, np.zeros((2, 10, 14, 18), np.float32),
                                              weight, bias)]
    if route == "tiled":
        monkeypatch.setattr(tdc, "pallas_route", lambda *a, **kw: ("tiled", 6))
        out = tdc.deform_conv2d(*targs, impl="pallas")
    elif route == "shift":
        monkeypatch.setattr(tdc, "shift_route_ok", lambda *a, **kw: True)
        out = tdc.deform_conv2d(*targs, impl="shift")
    else:
        out = tdc.deform_conv2d_mt(*targs)
    out.square().sum().backward()
    assert not targs[1].grad.any()
    assert all(float(t.grad.abs().max()) > 0 for t in targs[::2])


# ----------------------------------------------- the node and its plain backward


def _taps(rng, k=9, b=2, h=6, w=7, c=8, reach=12.0):
    """y (B, H, W, K, C), g, and coordinates anywhere within +-reach px of
    each pixel, a quarter of them on integer rows or columns."""
    y = _t(rng.randn(b, h, w, k, c))
    g = _t(rng.randn(b, h, w, c))
    sy = np.arange(h)[None, None, :, None] + rng.uniform(-reach, reach, (k, b, h, w))
    sx = np.arange(w)[None, None, None, :] + rng.uniform(-reach, reach, (k, b, h, w))
    sy = np.where(rng.rand(k, b, h, w) < 0.25, np.round(sy), sy)
    sx = np.where(rng.rand(k, b, h, w) < 0.25, np.round(sx), sx)
    return y, g, _t(sy), _t(sx)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_unclipped_backward_is_nine_deform_sample_backwards(dtype):
    """``DeformSampleTaps`` with no reach against the chain of nine one-tap
    plain versions it stands for (``deform_sample_plain`` added in tap
    order, ``deform_sample_bwd_plain`` per tap): forward, and gradients to
    y, sy and sx for one upstream gradient, exactly equal (the same plain
    arithmetic, tap by tap, with the same tap adds);
    ``deform_sample_bwd_unclipped`` counts no launch on the CPU and takes
    coordinates far beyond any window and outside the map."""
    y, g, sy, sx = (a.to(dtype) for a in _taps(np.random.RandomState(3)))
    a = [v.clone().requires_grad_() for v in (y, sy, sx)]
    out = tsample.DeformSampleTaps.apply(*a, None, "pallas", None)
    chain = None
    for t in range(y.shape[3]):
        tap = tsample.deform_sample_plain(y[:, :, :, t], sy[t], sx[t])
        chain = tap if chain is None else chain + tap
    assert torch.equal(out, chain)
    out.backward(g)
    before = tsample.launches_bwd_unclipped
    gy, gsy, gsx = tsample.deform_sample_bwd_unclipped(y, sy, sx, g)
    assert tsample.launches_bwd_unclipped == before
    for t in range(y.shape[3]):
        ref = tsample.deform_sample_bwd_plain(y[:, :, :, t], sy[t], sx[t], g)
        assert torch.equal(a[0].grad[:, :, :, t], ref[0]) and torch.equal(gy[:, :, :, t], ref[0])
        assert torch.equal(a[1].grad[t], ref[1]) and torch.equal(gsy[t], ref[1])
        assert torch.equal(a[2].grad[t], ref[2]) and torch.equal(gsx[t], ref[2])
    assert float(gy.abs().max()) > 0 and float(gsy.abs().max()) > 0


@pytest.mark.parametrize("what", ["rank", "taps", "g_dtype", "g_shape", "sx_shape", "rule",
                                  "fast_dtype", "fast_size"])
def test_unclipped_wrapper_checks(what):
    y = torch.zeros((1, 4, 5, 3, 8))  # side by side, the default layout
    s = torch.full((3, 1, 4, 5), 40.0)  # far beyond the map: no reach check here
    g = torch.zeros((1, 4, 5, 8))
    tsample.deform_sample_bwd_unclipped(y, s, s, g)
    tsample.deform_sample_bwd_unclipped(y, s, s, g, "hat", torch.tensor(False))
    bad = {"rank": lambda: tsample.deform_sample_bwd_unclipped(y[0], s, s, g),
           "taps": lambda: tsample.deform_sample_bwd_unclipped(y, s[:2], s[:2], g),
           "g_dtype": lambda: tsample.deform_sample_bwd_unclipped(y, s, s, g.bfloat16()),
           "g_shape": lambda: tsample.deform_sample_bwd_unclipped(y, s, s, g[..., :4]),
           "sx_shape": lambda: tsample.deform_sample_bwd_unclipped(y, s, s[..., :4], g),
           "rule": lambda: tsample.deform_sample_bwd_unclipped(y, s, s, g, "central"),
           "fast_dtype": lambda: tsample.deform_sample_bwd_unclipped(
               y, s, s, g, "hat", torch.tensor(1.0)),
           "fast_size": lambda: tsample.deform_sample_bwd_unclipped(
               y, s, s, g, "hat", torch.ones(2, dtype=torch.bool))}[what]
    with pytest.raises(TypeError if what == "g_dtype" else ValueError):
        bad()


def test_a_flag_takes_the_unclipped_form():
    """``auto``'s device flag goes with the unclipped K3 alone: a node with a
    reach and a flag is refused."""
    y = torch.zeros((1, 4, 5, 3, 8))
    s = torch.full((3, 1, 4, 5), 1.0)
    tsample.DeformSampleTaps.apply(y, s, s, None, "pallas", torch.tensor(True))
    with pytest.raises(ValueError, match="unclipped"):
        tsample.DeformSampleTaps.apply(y, s, s, 2, "pallas", torch.tensor(True))


@pytest.mark.parametrize("impl", ["gather", "auto"])
def test_exact_routes_build_one_all_tap_node(impl):
    """Under autograd ``auto`` and ``gather`` build one ``DeformSampleTaps``
    with no reach per layer; the backward runs through it. Without autograd
    they take the fused sampler and build no node."""
    targs = [_t(a).requires_grad_() for a in _conv_inputs(4, 9.0)]
    taps = mock.Mock(side_effect=tsample.DeformSampleTaps.apply)
    with mock.patch.object(tsample.DeformSampleTaps, "apply", taps):
        out = tdc.deform_conv2d(*targs, impl=impl)
        out.square().sum().backward()
        with torch.no_grad():
            fused = tdc.deform_conv2d(*targs, impl=impl)
    assert taps.call_count == 1 and taps.call_args.args[3] is None
    assert fused.grad_fn is None
    np.testing.assert_allclose(fused.numpy(), out.detach().numpy(), rtol=0, atol=1e-5)
    assert all(float(t.grad.abs().max()) > 0 for t in targs)


# ----------------------------------------- auto against the JAX auto, tiling map

TILE_FROM = 256  # the rule of test_torch_tiled_mt.py: maps this wide are tiled
PORT_VMEM_LIMIT = 5 * 2 ** 19


def _jax_route(shape, cout, max_dy, dilation):
    return ("tiled", max_dy) if shape[2] >= TILE_FROM else ("untiled", None)


# field, dtype: max |dy|, |dx| of the offsets, and the tolerance as a
# fraction of max |ref|
AUTO_CASES = {
    # both sample exactly; the JAX tiled kernel adds its nine taps in f32
    # (x.dtype), K1's plain version sums in f32 and rounds once: f32
    # rounding only (measured 1.0e-7)
    "in_window-float32": (5.5, torch.float32, 2e-6),
    # the JAX cond takes the exact gather form, as the port does: f32
    # rounding only (measured 1.2e-7)
    "beyond-float32": (9.0, torch.float32, 2e-6),
    # bf16: the JAX tiled kernel rounds each tap's sample and each of eight
    # partial sums to bf16, K1 sums in f32 and rounds once; up to 2^-6 of a
    # layer's output at worst (measured 6.8e-3)
    "in_window-bfloat16": (5.5, torch.bfloat16, 2.0 ** -6),
}


@pytest.mark.parametrize("case", list(AUTO_CASES))
def test_auto_matches_jax_auto_on_a_tiling_map(monkeypatch, case):
    """``deform_conv2d(impl="auto")`` against ``deform_conv2d_auto`` on a
    2x8x256 map (128 channels out) with the routing limits of both packages lowered so that
    they tile it. With every offset inside the +-6 window the JAX cond takes
    the column-tiled Pallas kernel (its output equals
    ``_deform_conv2d_pallas_tiled`` bit for bit); with offsets beyond it,
    the gather form. The port's ``auto`` samples exactly in both cases and
    asks no routing rule; the two differ by rounding only, within the
    tolerance of each case."""
    field, dtype, rtol = AUTO_CASES[case]
    x, offsets, weight, bias = _conv_inputs(5, field, h=8, w=256, cout=128)
    monkeypatch.setattr(dcp, "pallas_route", _jax_route)
    port_route = tsample.pallas_route(x.shape, 128, 6, 1, vmem_limit=PORT_VMEM_LIMIT)
    assert port_route == _jax_route(x.shape, 128, 6, 1) == ("tiled", 6)
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jx = jnp.asarray(x).astype(jdtype)
    jargs = (jx, *(jnp.asarray(a) for a in (offsets, weight, bias)))
    ref = jdc.deform_conv2d_auto.__wrapped__(*jargs, 3, 1, 6)
    in_window = bool(np.abs(offsets).max() <= 6)
    assert in_window == case.startswith("in_window")
    form = (dcp._deform_conv2d_pallas_tiled(*jargs, 3, 1, 6, 6) if in_window
            else jdc.deform_conv2d_batched(*jargs))
    assert np.array_equal(np.asarray(ref.astype(jnp.float32)),
                          np.asarray(form.astype(jnp.float32)))
    got = tdc.deform_conv2d(_t(x).to(dtype), *(_t(a) for a in (offsets, weight, bias)),
                            impl="auto")
    ref = np.asarray(ref.astype(jnp.float32))
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=rtol * scale)
