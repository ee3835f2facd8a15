"""The training forwards of the port, K2 (``deform_sample_taps``) and K6
(``deform_sample_tiled_taps``), against the JAX package on the CPU.

The JAX training forms sample a layer's taps one by one and add each tap's
output in the projection's dtype in tap order: ``_pertap_untiled`` with
``_sample_pallas`` and ``_deform_conv2d_pallas_tiled`` with
``_sample_pallas_tiled``. The port does that whole chain in one launch; on
the CPU its wrappers run the plain versions, which are the chain of one-tap
plain versions. Held here: that chain exactly, in f32 and bf16; the chain of
interpreted Pallas kernels within the bf16 chain's tolerance; the tiled
plain version's reach check; one all-tap call per ``DeformSampleTaps`` and
``DeformSampleTiled`` forward; and the wrappers' checks, with no launch
counted for a CPU call.

Inputs come from numpy seeds. Every tolerance is stated where it is used.
"""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from upsnet_tpu.ops import deform_conv_pallas as dcp
from upsnet_torch.ops import deform_conv as tdc
from upsnet_torch.ops import deform_sample as tsample

torch.set_num_threads(2)

TAPS = 9
REACH = 4  # |sy - i| stays below it: the JAX kernels' window radius


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


def _coords(rng, b, h, w, spread_x):
    """(K, B, H, W) f32 coordinates of a 3x3 layer: each tap's own row and
    column shift plus offsets that are multiples of 1/8 and never integers
    (hat weights exact in bf16), |dy| < REACH - 1 and |dx| < spread_x; some
    samples leave the map."""
    kk = np.arange(TAPS)
    ky = (kk // 3 - 1)[:, None, None, None]
    kx = (kk % 3 - 1)[:, None, None, None]
    shape = (TAPS, b, h, w)
    dy = rng.randint(-(REACH - 1) * 8 + 1, (REACH - 1) * 8, shape) / 8.0
    dx = rng.randint(-spread_x * 8, spread_x * 8 + 1, shape) / 8.0
    dy = np.clip(np.where(dy == np.round(dy), dy + 0.375, dy), 1.125 - REACH, REACH - 1.125)
    dx = np.clip(np.where(dx == np.round(dx), dx - 0.375, dx), 0.125 - spread_x,
                 spread_x - 0.125)
    sy = np.arange(h)[None, None, :, None] + ky + dy
    sx = np.arange(w)[None, None, None, :] + kx + dx
    return sy.astype(np.float32), sx.astype(np.float32)


def _chain(tap, taps=TAPS):
    """``tap(0) + tap(1) + ...`` in the taps' dtype, in tap order."""
    out = tap(0)
    for t in range(1, taps):
        out = out + tap(t)
    return out


def _chain_tolerance(taps):
    """One bf16 ulp (2^-7 relative) per rounding of a chain of bf16 taps
    (f32 numpy arrays of bf16 values): 2^-7 * (sum_t |tap_t| + sum_{t>0}
    |partial_t|). Two chains that sum each tap in another f32 order round at
    the same 2K - 1 places and may land one ulp apart at each."""
    part = taps[0]
    scale = np.abs(taps[0]).copy()
    for tap in taps[1:]:
        part = torch.from_numpy(part + tap).bfloat16().float().numpy()
        scale += np.abs(tap) + np.abs(part)
    return 2.0 ** -7 * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_taps_plain_is_the_chain_of_one_tap_plains(dtype):
    """Both all-tap wrappers on the CPU equal the one-tap plain versions
    added in ``y.dtype`` in tap order, exactly (``torch.equal``)."""
    rng = np.random.RandomState(0)
    b, h, w, c = 2, 6, 11, 16
    sy, sx = (_t(s) for s in _coords(rng, b, h, w, 3))
    y = _t(rng.randn(b, h, w, TAPS, c).astype(np.float32)).to(dtype)
    got = tsample.deform_sample_taps(y, sy, sx)
    assert got.dtype == dtype and got.shape == (b, h, w, c)
    assert torch.equal(got, _chain(lambda t: tsample.deform_sample_plain(
        y[:, :, :, t], sy[t], sx[t])))
    assert torch.equal(got, tsample.deform_sample_taps_plain(y, sy, sx))
    reach_x = 5  # the column shift of 1 and |dx| <= 3, beyond no sample
    tiled = tsample.deform_sample_tiled_taps(y, sy, sx, REACH, reach_x)
    assert tiled.dtype == dtype
    assert torch.equal(tiled, _chain(lambda t: tsample.deform_sample_tiled_plain(
        y, t, sy[t], sx[t], REACH, reach_x)))
    assert torch.equal(tiled, got)  # the same samples, read in place


def test_taps_plain_matches_a_chain_of_interpreted_sample_pallas():
    """The all-tap K2's plain version in bf16 against ``_pertap_untiled``'s
    loop: nine interpreted ``_sample_pallas`` calls on the padded taps, each
    added to a bf16 running sum that starts at zero. Each JAX tap is one
    rounding of an f32 sum of the same exact products in another order, so
    the chains agree within ``_chain_tolerance`` plus 1e-6 near zero."""
    rng = np.random.RandomState(1)
    b, h, w, c = 1, 8, 20, 16
    sy, sx = _coords(rng, b, h, w, 4)
    y32 = rng.randn(TAPS, b, h, w, c).astype(np.float32)
    y = jnp.asarray(y32).astype(jnp.bfloat16)
    pad = REACH + 2
    out = jnp.zeros((b, h, w, c), jnp.bfloat16)
    for t in range(TAPS):
        y_pad = jnp.pad(y[t], ((0, 0), (pad, pad), (1, 128 - w - 1), (0, 0)))
        out = out + dcp._sample_pallas(y_pad, jnp.asarray(sy[t]), jnp.asarray(sx[t]), REACH)
    ty = _t(np.asarray(y.astype(jnp.float32))).to(torch.bfloat16)
    got = tsample.deform_sample_taps(ty.permute(1, 2, 3, 0, 4).contiguous(), _t(sy), _t(sx))
    taps = [tsample.deform_sample_plain(ty[t], _t(sy[t]), _t(sx[t])).float().numpy()
            for t in range(TAPS)]
    err = np.abs(got.float().numpy() - np.asarray(out.astype(jnp.float32)))
    assert (err <= _chain_tolerance(taps) + 1e-6).all(), float(err.max())
    outside = ~((sy > -1) & (sy < h) & (sx > -1) & (sx < w))
    assert outside.any() and got.float().abs().max() > 1.0


def test_tiled_taps_plain_matches_a_chain_of_interpreted_sample_pallas_tiled():
    """The all-tap K6's plain version in bf16 against
    ``_deform_conv2d_pallas_tiled``'s loop: nine interpreted
    ``_sample_pallas_tiled`` calls on a map two column tiles wide (ct 128),
    each tap padded as that function pads it, added to a bf16 running sum
    from zero; tolerance as in the untiled test. Then a sample beyond the
    column reach: the plain version raises."""
    rng = np.random.RandomState(2)
    b, h, w, c, dx = 1, 8, 256, 16, 3
    reach_x = dx + 1  # |dx| <= 3 plus the taps' column shift
    sy, sx = _coords(rng, b, h, w, dx)
    y = jnp.asarray(rng.randn(b, h, w, TAPS, c).astype(np.float32)).astype(jnp.bfloat16)
    ct = 128
    ctw = -(-(ct + 2 * (reach_x + 2)) // 8) * 8
    left = reach_x + 2
    out = jnp.zeros((b, h, w, c), jnp.bfloat16)
    for t in range(TAPS):
        y_pad = jnp.pad(y[:, :, :, t], ((0, 0), (REACH + 2, REACH + 2),
                                        (left, ctw - ct - left), (0, 0)))
        out = out + dcp._sample_pallas_tiled(y_pad, jnp.asarray(sy[t]), jnp.asarray(sx[t]),
                                             REACH, reach_x, ct, ctw)
    ty = _t(np.asarray(y.astype(jnp.float32))).to(torch.bfloat16)
    tsy, tsx = _t(sy), _t(sx)
    got = tsample.deform_sample_tiled_taps(ty, tsy, tsx, REACH, reach_x)
    taps = [tsample.deform_sample_plain(ty[:, :, :, t], tsy[t], tsx[t]).float().numpy()
            for t in range(TAPS)]
    err = np.abs(got.float().numpy() - np.asarray(out.astype(jnp.float32)))
    assert (err <= _chain_tolerance(taps) + 1e-6).all(), float(err.max())
    far = tsx.clone()
    far[4, 0, 3, 100] = 100 + reach_x + 0.5  # counted, half a column beyond the reach
    with pytest.raises(ValueError, match="beyond reach"):
        tsample.deform_sample_tiled_taps(ty, tsy, far, REACH, reach_x)


def _conv_inputs(seed, w):
    rng = np.random.RandomState(seed)
    x = rng.randn(1, 8, w, 8).astype(np.float32)
    offsets = ((2 * rng.randint(-24, 24, (1, 8, w, 18)) + 1) / 16.0).astype(np.float32)
    weight = (rng.randn(9, 8, 16) * 0.1).astype(np.float32)
    return x, offsets, weight


@pytest.mark.parametrize("route", ["untiled", "tiled"])
@pytest.mark.parametrize("grad", [True, False])
def test_layers_call_the_all_tap_wrapper_once(monkeypatch, route, grad):
    """``deform_conv2d(impl="pallas")`` under autograd (untiled: one
    ``DeformSampleTaps``) and on a map the routing rule tiles, with and
    without autograd (one ``DeformSampleTiled``), call the all-tap forward
    once a layer; the backward runs."""
    fixed = (lambda *a, **k: ("tiled", 2)) if route == "tiled" else (
        lambda *a, **k: ("untiled", None))
    monkeypatch.setattr(tdc, "pallas_route", fixed)
    name = "deform_sample_tiled_taps" if route == "tiled" else "deform_sample_taps"
    spy = mock.Mock(side_effect=getattr(tsample, name))
    leaves = [_t(a).requires_grad_(grad) for a in _conv_inputs(3, 24)]
    with mock.patch.object(tsample, name, spy):
        out = tdc.deform_conv2d(*leaves, impl="pallas", max_dy=2)
        if grad:
            out.square().sum().backward()
    if route == "untiled" and not grad:  # the fused inference sampler, K1
        assert spy.call_count == 0
        return
    assert spy.call_count == 1
    if grad:
        assert all(float(t.grad.abs().max()) > 0 for t in leaves)


WRAPPERS = {
    "taps": tsample.deform_sample_taps,
    "tiled_taps": lambda y, sy, sx: tsample.deform_sample_tiled_taps(y, sy, sx, 5, 5),
}
MALFORMED = {
    "y_dtype": (TypeError, lambda y, s: (y.to(torch.float16), s, s)),
    "s_dtype": (TypeError, lambda y, s: (y, s.double(), s)),
    "y_rank": (ValueError, lambda y, s: (y[..., 0, :], s, s)),
    "taps": (ValueError, lambda y, s: (y, s[:2], s[:2])),
    "sx_shape": (ValueError, lambda y, s: (y, s, s[..., :4])),
    # off the CPU the kernel's layout is checked before the device, so a
    # meta tensor shows the card's rule
    "c_mod_8": (ValueError, lambda y, s: (y[..., :12].contiguous().to("meta"), s.to("meta"),
                                          s.to("meta"))),
    "cuda_only": (ValueError, lambda y, s: (y.to("meta"), s.to("meta"), s.to("meta"))),
    "strides": (ValueError, lambda y, s: (y, s.transpose(2, 3).contiguous().transpose(2, 3),
                                          s)),
    # a permuted view of a tap-major stack: the kernels read y in place
    "y_strides": (ValueError, lambda y, s: (y.permute(3, 0, 1, 2, 4).contiguous()
                                            .permute(1, 2, 3, 0, 4), s, s)),
    "device": (ValueError, lambda y, s: (y, s.to("meta"), s)),
}


@pytest.mark.parametrize("what", list(MALFORMED))
@pytest.mark.parametrize("wrapper", list(WRAPPERS))
def test_all_tap_wrappers_reject_malformed_input(wrapper, what):
    """Both wrappers take a well-formed CPU call without counting a launch
    and raise on a wrong dtype, rank, tap count, shape, C % 8, layout
    (strided coordinates) or device, the tiled one with a reach that every
    sample here keeps."""
    y = torch.zeros((1, 4, 5, 3, 16))
    s = torch.full((3, 1, 4, 5), 0.5)
    call = WRAPPERS[wrapper]
    before = (tsample.launches_taps, tsample.launches_tiled_taps)
    assert call(y, s, s).shape == (1, 4, 5, 16)
    assert (tsample.launches_taps, tsample.launches_tiled_taps) == before
    error, bad = MALFORMED[what]
    match = {"c_mod_8": "multiple of 8", "cuda_only": "unsupported device"}.get(what)
    with pytest.raises(error, match=match):
        call(*bad(y, s))


@pytest.mark.parametrize("what", ["y_strides", "reach_sign"])
def test_tiled_taps_wrapper_rejects_strided_y_and_negative_reach(what):
    """The tiled wrapper reads y in place: a non-contiguous y (a permuted
    view of a tap-major stack) is refused, as is a negative reach."""
    y = torch.zeros((3, 1, 4, 5, 16))
    s = torch.zeros((3, 1, 4, 5))
    side = y.permute(1, 2, 3, 0, 4)
    with pytest.raises(ValueError):
        if what == "y_strides":
            tsample.deform_sample_tiled_taps(side, s, s, 3, 3)
        else:
            tsample.deform_sample_tiled_taps(side.contiguous(), s, s, -1, 3)
