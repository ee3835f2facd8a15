"""K7b's counting-sort gather on the CPU: the identity it rests on, and the
wrappers' limits.

K7b (``deform_sample_mt_bwd``) is the unclipped all-tap K3 with the roles of
the taps turned round: one input x read by every tap, a g row per
(pixel, tap). Its gradient to x is the sum over the taps of the one-tap K3's
gradient to its map, and its coordinate gradients are the one-tap K3's tap
by tap, which is why the card runs K3's sort (with the taps' bins merged per
image) and K3's coordinate pass (with g read per tap). Here the plain
versions are held to that identity, in f32 and bf16, on offsets that spread
the taps and on offsets that put all nine taps of a pixel at one point (one
bin, the worst case for the sort's rank key). The wrappers' new limits are
reached through meta tensors, which pass every check the card's kernels
need before the device is asked for. Inputs come from numpy seeds; every
tolerance is stated where it is used.
"""

import numpy as np
import pytest
import torch

from upsnet_torch.ops import deform_sample as tsample
from upsnet_torch.ops import deform_sample_mt as tmt

torch.set_num_threads(2)

K, B, H, W, C = 9, 2, 7, 10, 16


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _coords(rng, field):
    """Sample coordinates (K, B, H, W) f32: ``spread``, offsets uniform in
    +-3 px around each tap of a 3 x 3 kernel; ``shared_corner``, every tap
    of a pixel at one point within +-1.5 px of it (offsets -kernel_offset +
    a constant a pixel). 15% of the samples on integer rows, 15% on integer
    columns, and 10% pushed beyond the image edge (for ``shared_corner`` a
    pixel's taps together, so that they stay at one point)."""
    shape = (K, B, H, W)
    ky = (np.arange(K) // 3 - 1)[:, None, None, None]
    kx = (np.arange(K) % 3 - 1)[:, None, None, None]
    iy = np.arange(H)[None, None, :, None]
    ix = np.arange(W)[None, None, None, :]
    if field == "spread":
        sy = iy + ky + rng.uniform(-3, 3, shape)
        sx = ix + kx + rng.uniform(-3, 3, shape)
    else:
        sy = np.broadcast_to(iy + rng.uniform(-1.5, 1.5, (1, B, H, W)), shape)
        sx = np.broadcast_to(ix + rng.uniform(-1.5, 1.5, (1, B, H, W)), shape)
    mask = shape if field == "spread" else (1, B, H, W)
    sy = np.where(rng.rand(*mask) < 0.15, np.round(sy), sy)
    sx = np.where(rng.rand(*mask) < 0.15, np.round(sx), sx)
    sy = np.where(rng.rand(*mask) < 0.1, sy + np.where(sy < H / 2, -H, H), sy)
    return _t(sy.astype(np.float32)), _t(sx.astype(np.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("field", ["spread", "shared_corner"])
def test_k7b_plain_is_the_per_tap_one_tap_k3(dtype, field):
    """K7b's plain version against the one-tap K3's plain version
    ``deform_sample_bwd_plain(x, sy[t], sx[t], g[..., t, :])`` over the nine
    taps, on f32 copies of the inputs (bf16 widens exactly): gsy and gsx
    equal bit for bit, tap by tap; grad_x equal to the f32 sum of the nine
    gradients within f32 rounding (the same terms in another order:
    2e-6 of max|sum|), and in bf16 within one bf16 ulp more (K7b rounds its
    f32 sum once). Both are exactly 0 at integer coordinates and at
    samples that do not count."""
    rng = np.random.RandomState(10)
    x = _t(rng.randn(B, H, W, C).astype(np.float32)).to(dtype)
    g = _t(rng.randn(B, H, W, K, C).astype(np.float32)).to(dtype)
    sy, sx = _coords(rng, field)
    if field == "shared_corner":  # a pixel's nine samples in one bin
        assert torch.equal(sy, sy[:1].expand_as(sy)) and torch.equal(sx, sx[:1].expand_as(sx))
    gx, gsy, gsx = tmt.deform_sample_mt_bwd_plain(x, sy, sx, g)
    assert gx.dtype == dtype and gsy.dtype == gsx.dtype == torch.float32
    total = torch.zeros((B, H, W, C), dtype=torch.float32)
    for t in range(K):
        gy_t, gsy_t, gsx_t = tsample.deform_sample_bwd_plain(
            x.float(), sy[t], sx[t], g[:, :, :, t].float())
        assert torch.equal(gsy[t], gsy_t) and torch.equal(gsx[t], gsx_t), t
        total += gy_t
    scale = float(total.abs().max())
    assert scale > 0
    rtol = 2e-6 if dtype == torch.float32 else 2.0 ** -7
    np.testing.assert_allclose(gx.float().numpy(), total.numpy(), rtol=rtol,
                               atol=2e-6 * scale)
    outside = (sy <= -1) | (sy >= H) | (sx <= -1) | (sx >= W)
    assert bool(outside.any()) and bool((sy == sy.round()).any())
    assert not gsy[(sy == sy.round()) | outside].any()
    assert not gsx[(sx == sx.round()) | outside].any()
    assert bool(gsy.abs().max() > 0) and bool(gsx.abs().max() > 0)


# off the CPU the kernels' needs are checked before the device, so meta
# tensors show the card's rules: (kernel, x shape, taps, match)
MALFORMED = {
    "k7a_c_mod_8": ("fwd", (1, 4, 4, 12), 9, "multiple of 8"),
    "k7a_index_2_31": ("fwd", (1, 4096, 4096, 1024), 1, "threads = 2147483648 must be below"),
    "k7a_cuda_only": ("fwd", (1, 4, 4, 16), 9, "unsupported device"),
    "k7b_c_mod_8": ("bwd", (1, 4, 4, 12), 9, "multiple of 8"),
    "k7b_scratch_2_31": ("bwd", (1, 8192, 8192, 8), 9, "int32 scratch = .* must be below"),
    "k7b_cuda_only": ("bwd", (1, 4, 4, 16), 9, "unsupported device"),
}


@pytest.mark.parametrize("what", list(MALFORMED))
def test_k7_wrappers_check_the_kernels_needs_before_the_device(what):
    """C % 8, K7a's 32-bit thread index (B*H*W*C/8 below 2^31) and K7b's
    int32 scratch (its sort's bins and records, below 2^31 elements) are
    refused off the CPU without a launch; a call that meets them reaches
    the device check."""
    kernel, (b, h, w, c), k, match = MALFORMED[what]
    x = torch.empty((b, h, w, c), dtype=torch.bfloat16, device="meta")
    sy = torch.empty((k, b, h, w), device="meta")
    sx = torch.empty((k, b, h, w), device="meta")
    before = tmt.launches, tmt.launches_bwd
    with pytest.raises(ValueError, match=match):
        if kernel == "fwd":
            tmt.deform_sample_mt(x, sy, sx)
        else:
            g = torch.empty((b, h, w, k, c), dtype=torch.bfloat16, device="meta")
            tmt.deform_sample_mt_bwd(x, sy, sx, g)
    assert (tmt.launches, tmt.launches_bwd) == before
