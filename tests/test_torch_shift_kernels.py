"""K8a, K8b, K8c of the port against the TPU kernels they replace, on the CPU.

The port's wrappers take their plain versions on CPU tensors; the JAX side
runs ``_shift_fwd``, ``_shift_adjoint`` and ``_shift_offset_grads`` of
``upsnet_tpu/ops/deform_shift_pallas.py`` with ``pl.pallas_call`` in
interpret mode, on the zero-padded map the TPU wrapper builds. Inputs come
from numpy seeds; offsets stay inside the +-3 px window of both (the TPU
kernels give zero beyond it, the port's have no window), with samples
outside the image near every edge and a share of exactly integer
coordinates. Tolerances: float32 atol 2e-4, as ``tests/test_deform_shift.py``
uses; bfloat16 one ulp (2^-7 relative) plus 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upsnet_tpu.ops import deform_shift_pallas as dsp
from upsnet_torch.ops import deform_sample as tsample
from upsnet_torch.ops import deform_shift as tshift

torch.set_num_threads(2)

K, MAX_D, DIL = 9, 3, 1
R = MAX_D + DIL  # the TPU kernels' row reach
PAD_L = MAX_D + DIL + 2


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    import jax.experimental.pallas as pl

    real_call = pl.pallas_call

    def fake_call(*args, **kw):
        kw["interpret"] = True
        return real_call(*args, **kw)

    monkeypatch.setattr(pl, "pallas_call", fake_call)
    yield


def _inputs(seed, b=2, h=16, w=24, c=128, integer_share=0.1):
    """y (B, H, W, K*C), g (B, H, W, C), sy, sx (K, B, H, W): 3x3 taps at
    dilation 1 with offsets uniform in +-3 px, a share of them rounded so
    that the coordinate is an integer."""
    rng = np.random.RandomState(seed)
    y = rng.randn(b, h, w, K * c).astype(np.float32)
    g = rng.randn(b, h, w, c).astype(np.float32)
    taps = np.arange(K)
    ky = (taps // 3 - 1).astype(np.float32)[:, None, None, None] * DIL
    kx = (taps % 3 - 1).astype(np.float32)[:, None, None, None] * DIL
    iy = np.arange(h, dtype=np.float32)[None, None, :, None]
    ix = np.arange(w, dtype=np.float32)[None, None, None, :]
    off_y = rng.uniform(-MAX_D, MAX_D, (K, b, h, w)).astype(np.float32)
    off_x = rng.uniform(-MAX_D, MAX_D, (K, b, h, w)).astype(np.float32)
    off_y = np.where(rng.rand(K, b, h, w) < integer_share, np.round(off_y), off_y)
    off_x = np.where(rng.rand(K, b, h, w) < integer_share, np.round(off_x), off_x)
    sy = (iy + ky + off_y).astype(np.float32)
    sx = (ix + kx + off_x).astype(np.float32)
    return y, g, sy, sx


def _pad(y):
    """The TPU wrapper's zero padding of y (``deform_conv2d_pallas_shift``)."""
    _, h, w, _ = y.shape
    pad_rows = R + 2
    hpad = dsp._round_up(h + 2 * pad_rows, dsp._pick_rb(h))
    wp = dsp._round_up(w + 2 * PAD_L, 128)
    y_pad = jnp.pad(y, ((0, 0), (pad_rows, hpad - h - pad_rows),
                        (PAD_L, wp - w - PAD_L), (0, 0)))
    return y_pad, pad_rows


def _tol(dtype):
    return dict(rtol=0, atol=2e-4) if dtype == "float32" else dict(rtol=2.0 ** -7, atol=1e-3)


CASES = [(128, "float32"), (128, "bfloat16"), (8, "float32")]


@pytest.mark.parametrize("c,dtype", CASES)
def test_shift_fwd_matches_the_interpreted_tpu_kernel(c, dtype):
    y, _, sy, sx = _inputs(0, c=c)
    inside = (sy > -1) & (sy < y.shape[1]) & (sx > -1) & (sx < y.shape[2])
    assert (~inside).any() and (sy == np.round(sy)).any()
    jy = jnp.asarray(y).astype(dtype)
    y_pad, _ = _pad(jy)
    ref = dsp._shift_fwd(y_pad, jnp.asarray(sy), jnp.asarray(sx), R, PAD_L)
    ty = torch.from_numpy(y).to(getattr(torch, dtype))
    got = tshift.shift_fwd(ty, torch.from_numpy(sy), torch.from_numpy(sx))
    assert got.dtype == ty.dtype and got.shape == (*y.shape[:3], c)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               **_tol(dtype))


@pytest.mark.parametrize("c,dtype", CASES)
def test_shift_adjoint_matches_the_interpreted_tpu_kernel(c, dtype):
    """The interior of the TPU kernel's gradient to the padded map is the
    port's gradient to the unpadded one."""
    y, g, sy, sx = _inputs(1, c=c)
    b, h, w, _ = y.shape
    y_pad, pad_rows = _pad(jnp.asarray(y))
    _, hpad, wp, _ = y_pad.shape
    ref = dsp._shift_adjoint(jnp.asarray(g).astype(dtype), jnp.asarray(sy), jnp.asarray(sx),
                             R, PAD_L, hpad, wp)
    ref = np.asarray(ref.astype(jnp.float32))[:, pad_rows:pad_rows + h, PAD_L:PAD_L + w]
    tg = torch.from_numpy(g).to(getattr(torch, dtype))
    got = tshift.shift_adjoint(tg, torch.from_numpy(sy), torch.from_numpy(sx), R, R)
    assert got.dtype == tg.dtype and got.shape == (b, h, w, K * c)
    assert np.abs(ref).max() > 0
    np.testing.assert_allclose(got.float().numpy(), ref, **_tol(dtype))
    # a gather in a fixed order: the same bits on every run
    again = tshift.shift_adjoint(tg, torch.from_numpy(sy), torch.from_numpy(sx), R, R)
    assert torch.equal(got, again)


@pytest.mark.parametrize("c,dtype", CASES)
def test_shift_offset_grads_match_the_interpreted_tpu_kernel(c, dtype):
    """gsy and gsx are float32 sums over C of products of O(1) values:
    atol 2e-4 * sqrt(C) in float32; from bfloat16 inputs both sides widen
    the same values to float32, so the same bound holds."""
    y, g, sy, sx = _inputs(2, c=c)
    jy, jg = jnp.asarray(y).astype(dtype), jnp.asarray(g).astype(dtype)
    y_pad, _ = _pad(jy)
    ref_y, ref_x = dsp._shift_offset_grads(y_pad, jnp.asarray(sy), jnp.asarray(sx), jg,
                                           R, PAD_L)
    ty = torch.from_numpy(y).to(getattr(torch, dtype))
    tg = torch.from_numpy(g).to(getattr(torch, dtype))
    tsy, tsx = torch.from_numpy(sy), torch.from_numpy(sx)
    got_y, got_x = tshift.shift_offset_grads(ty, tsy, tsx, tg)
    assert got_y.dtype == got_x.dtype == torch.float32 and got_y.shape == sy.shape
    atol = 2e-4 * np.sqrt(c)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(ref_y), rtol=1e-5, atol=atol)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(ref_x), rtol=1e-5, atol=atol)
    # exactly zero at integer coordinates, on both sides
    at_y, at_x = sy == np.round(sy), sx == np.round(sx)
    assert at_y.sum() > 100 and at_x.sum() > 100
    assert not got_y.numpy()[at_y].any() and not got_x.numpy()[at_x].any()
    assert not np.asarray(ref_y)[at_y].any() and not np.asarray(ref_x)[at_x].any()
    assert got_y.numpy()[~at_y].any() and got_x.numpy()[~at_x].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_shift_fwd_equals_k1(dtype):
    """K8a and K1 compute the same function, K1 on the side-by-side view
    (B, H, W, K, C) of K8a's projection, which is K8a's own layout; their
    plain versions add in the same order, so the bits agree in float32 and
    bfloat16."""
    y, _, sy, sx = _inputs(3, c=8)
    b, h, w, kc = y.shape
    ty = torch.from_numpy(y).to(dtype)
    tsy, tsx = torch.from_numpy(sy), torch.from_numpy(sx)
    got = tshift.shift_fwd(ty, tsy, tsx)
    assert got.dtype == dtype and float(got.float().abs().max()) > 0.0
    assert torch.equal(got, tsample.deform_sample9(ty.view(b, h, w, K, kc // K), tsy, tsx))


def test_autograd_function_matches_finite_differences():
    """``DeformSampleShift`` in float64 against central differences at
    fractional coordinates (the hat derivative is one-sided at integers)."""
    y, _, sy, sx = _inputs(4, b=1, h=6, w=7, c=8, integer_share=0.0)
    args = [torch.from_numpy(a).double().requires_grad_() for a in (y, sy, sx)]
    assert torch.autograd.gradcheck(
        lambda a, b, c: tshift.DeformSampleShift.apply(a, b, c, R, R), args,
        eps=1e-6, atol=1e-6, rtol=1e-5, nondet_tol=0.0)


def test_gradient_to_y_is_the_adjoint_of_the_forward():
    """<shift_fwd(y), g> == <y, shift_adjoint(g)> in float64: K8b is K8a's
    transpose in y."""
    y, g, sy, sx = _inputs(5, c=8)
    ty, tg = torch.from_numpy(y).double(), torch.from_numpy(g).double()
    tsy, tsx = torch.from_numpy(sy).double(), torch.from_numpy(sx).double()
    lhs = (tshift.shift_fwd(ty, tsy, tsx) * tg).sum()
    rhs = (ty * tshift.shift_adjoint(tg, tsy, tsx, R, R)).sum()
    np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-12)


def test_adjoint_checks_its_reach_on_the_cpu():
    """Counted samples beyond the reach raise; samples outside the image
    are not counted and may lie anywhere."""
    _, g, sy, sx = _inputs(6, c=8)
    tg, tsy, tsx = torch.from_numpy(g), torch.from_numpy(sy), torch.from_numpy(sx)
    with pytest.raises(ValueError, match="beyond reach"):
        tshift.shift_adjoint(tg, tsy, tsx, R - 2, R)
    with pytest.raises(ValueError, match="beyond reach"):
        tshift.shift_adjoint(tg, tsy, tsx, R, R - 2)
    far = tsy.clone()
    far[:, :, 0] -= 100.0  # the top row's samples leave the image
    tshift.shift_adjoint(tg, far, tsx, R, R)
    with pytest.raises(ValueError, match="reach must be"):
        tshift.shift_adjoint(tg, tsy, tsx, -1, R)


@pytest.mark.parametrize("what", ["sy_shape", "sx_dtype", "y_channels", "g_shape", "g_dtype",
                                  "y_dtype"])
def test_wrappers_reject_malformed_input(what):
    y, g, sy, sx = (torch.from_numpy(a) for a in _inputs(7, c=8))
    if what == "sy_shape":
        with pytest.raises(ValueError):
            tshift.shift_fwd(y, sy[0], sx)
    elif what == "sx_dtype":
        with pytest.raises(TypeError):
            tshift.shift_fwd(y, sy, sx.double())
    elif what == "y_channels":
        with pytest.raises(ValueError):
            tshift.shift_fwd(y[..., :-1], sy, sx)
    elif what == "g_shape":
        with pytest.raises(ValueError):
            tshift.shift_offset_grads(y, sy, sx, g[..., :4])
    elif what == "g_dtype":
        with pytest.raises(TypeError):
            tshift.shift_offset_grads(y, sy, sx, g.to(torch.bfloat16))
    else:
        with pytest.raises(TypeError):
            tshift.shift_fwd(y.to(torch.float16), sy, sx)


LEVELS = [(208, 336), (104, 168), (52, 84), (26, 42)]  # P2..P5 of the 832x1344 bucket


@pytest.mark.parametrize("hw", LEVELS + [(16, 24), (8, 12), (4, 6), (1664, 2688)])
@pytest.mark.parametrize("cout,max_d,dil", [(128, 6, 1), (128, 6, 2), (96, 6, 1), (256, 3, 1)])
def test_shift_route_ok_equals_the_tpu_rule(monkeypatch, hw, cout, max_d, dil):
    """The port's eligibility is the JAX function's with its backend test
    answered 'tpu'."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    shape = (2, *hw, 256)
    assert (tshift.shift_route_ok(shape, cout, max_d, max_d, dil)
            == dsp.shift_route_ok(shape, cout, max_d, max_d, dil))


def test_shift_route_ok_on_the_fpn_levels():
    """At 832x1344 and fcn 128, P2 and P3 take the shift route; P4 and P5
    (heights 52 and 26, no multiple of 8) do not."""
    got = [tshift.shift_route_ok((2, h, w, 256), 128, 6, 6, 1) for h, w in LEVELS]
    assert got == [True, True, False, False]
    assert not tshift.shift_route_ok((2, 208, 336, 256), 96, 6, 6, 1)
