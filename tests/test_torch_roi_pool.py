"""K4's plain version on the RoIs its thread-per-(RoI, bin, 8 channels)
indexing must meet, the box and mask pooling on a pyramid made channel-last
once per forward, and the K4 wrapper's checks, on the CPU against the JAX
package.

- ``fpn_roi_align`` on CPU tensors (``fpn_roi_align_plain``) against
  ``roi_align_pallas.fpn_roi_align_window`` (``pl.pallas_call`` in interpret
  mode) and ``roi_align.fpn_roi_align_batched``: RoIs on all four levels,
  different levels per image of a batch of 2, RoIs partly and wholly beyond
  the map, RoIs whose samples snap to the last row and column, all-zero
  padded boxes; P 7 and 14, sampling ratios 1, 2 and 4, C 8 and 24 (1 and 3
  groups of 8 channels). float32; tolerance 1e-5 of max|ref| (the same f32
  sums in another order).
- ``_pool_boxes`` on the levels of ``_channel_last``, made once for a
  forward's three calls, against a channel-last copy made per call: equal
  outputs, and float32 gradients to the NCHW pyramid within f32 rounding
  (autograd adds the three calls' gradients in another order).
- ``fpn_roi_align`` at sampling ratio 3 against ``fpn_roi_align_batched``
  under ``gather`` and ``dense`` (the TPU window kernel refuses it), P 7
  and 14.
- ``fpn_roi_align`` on meta tensors: the kernel's needs (C % 8, a sampling
  ratio of at least 1, a 32-bit flat index) are refused before the device.
Inputs come from numpy seeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from upsnet_tpu.ops.roi_align import fpn_roi_align_batched
from upsnet_tpu.ops.roi_align_pallas import fpn_roi_align_window
from upsnet_torch.models.upsnet import _channel_last, _pool_boxes
from upsnet_torch.ops import roi_align_fpn
from upsnet_torch.ops.anchors import FPN_STRIDES
from upsnet_torch.ops.boxes import fpn_level_assignment

torch.set_num_threads(2)

STRIDES = (4, 8, 16, 32)
CANVAS = (64, 128)  # P2 16x32 .. P5 2x4
ROI_RTOL = 1e-5  # of max|ref|: float32 sums of the same terms in another order


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


def _pyramid(rng, b, c):
    return [rng.randn(b, CANVAS[0] // s, CANVAS[1] // s, c).astype(np.float32)
            for s in STRIDES]


def _boxes(rng, n, lo, hi, side_lo, side_hi):
    """n boxes with top-left corners uniform in [lo, hi) (x, y) and sides in
    [side_lo, side_hi)."""
    xy = rng.uniform(lo, hi, (n, 2))
    wh = rng.uniform(side_lo, side_hi, (n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def _case(rng, name):
    """(rois (2, 8, 4), levels (2, 8), C) for one of the indexing cases; one
    RoI count for all, so that the JAX references compile once per (C, P)."""
    h, w = CANVAS
    if name == "levels_b2":  # every level, and another level order per image
        rois = np.stack([_boxes(rng, 8, 0, 60, 4, 60), _boxes(rng, 8, 0, 60, 4, 60)])
        levels = np.array([[0, 1, 2, 3, 0, 1, 2, 3], [3, 2, 1, 0, 3, 3, 2, 0]], np.int32)
        return rois, levels, 24
    if name == "beyond":  # partly beyond each edge, and wholly beyond the map
        part = np.array([[-20, -12, 30, 20], [w - 24, h - 10, w + 40, h + 30],
                         [-50, 10, 10, 40], [40, -40, 90, 6]], np.float32)
        whole = np.array([[w + 40, 8, w + 90, 30], [-90, -70, -45, -8],
                          [10, h + 36, 60, h + 90], [-40, h + 50, w + 40, h + 99]], np.float32)
        rois = np.stack([np.concatenate([part, whole]), np.concatenate([whole, part])])
        return rois, rng.randint(0, 4, (2, 8)).astype(np.int32), 8
    if name == "snap":  # samples in the last row / column cell, and beyond it by < 1 cell
        edge = np.array([[w - 40, h - 30, w - 1, h - 1], [w - 9, 2, w + 3, 30],
                         [3, h - 7, 50, h + 2], [w - 3, h - 3, w, h],
                         [0, 0, w, h], [w - 64, h - 32, w + 6, h + 14],
                         [w - 2, 0, w - 1, h], [0, h - 2, w, h - 1]], np.float32)
        rois = np.stack([edge, edge[::-1]])
        levels = np.array([[0, 0, 1, 2, 3, 2, 0, 1], [1, 3, 0, 2, 1, 0, 3, 0]], np.int32)
        return rois, levels, 24
    if name == "padded":  # 3 boxes and all-zero padding slots, as the GT call has
        rois = np.zeros((2, 8, 4), np.float32)
        rois[:, :3] = _boxes(rng, 6, 0, 50, 6, 70).reshape(2, 3, 4)
        levels = (fpn_level_assignment(_t(rois)) - 2).to(torch.int32).numpy()
        return rois, levels, 8
    raise KeyError(name)


def _jax_refs(feats, rois, levels, pooled, s, gather: bool):
    jf = tuple(jnp.asarray(f) for f in feats)
    args = (jf, jnp.asarray(rois), jnp.asarray(levels))
    refs = [fpn_roi_align_window(*args, pooled=pooled, sampling_ratio=s, strides=STRIDES)]
    if gather:
        refs.append(fpn_roi_align_batched(*args, pooled=pooled, sampling_ratio=s,
                                          strides=STRIDES, impl="gather"))
    return [np.asarray(r) for r in refs]


def _check_k4(rng, name, pooled, s, gather=True):
    rois, levels, c = _case(rng, name)
    feats = _pyramid(rng, rois.shape[0], c)
    got = roi_align_fpn.fpn_roi_align(tuple(_t(f) for f in feats), _t(rois), _t(levels),
                                      pooled=pooled, sampling_ratio=s, strides=STRIDES)
    assert got.shape == (*rois.shape[:2], pooled, pooled, c)
    for ref in _jax_refs(feats, rois, levels, pooled, s, gather):
        atol = ROI_RTOL * float(np.abs(ref).max())
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=atol)
    return got, rois


@pytest.mark.parametrize("pooled", [7, 14])
@pytest.mark.parametrize("name", ["levels_b2", "beyond", "snap", "padded"])
def test_k4_plain_matches_window_kernel_and_gather(rng, name, pooled):
    got, rois = _check_k4(rng, name, pooled, 2)
    if name == "beyond":  # the wholly outside RoIs pool nothing
        assert float(got[0, 4:].abs().max()) == 0.0 and float(got[1, :4].abs().max()) == 0.0
    if name == "padded":  # a zero box pools the corner cells of P2, not zeros
        assert float(got[:, 3:].abs().max()) > 0.0


@pytest.mark.parametrize("s", [1, 4])
def test_k4_plain_matches_window_kernel_at_other_sampling_ratios(rng, s):
    """The other sampling ratios the TPU kernel takes, against it alone."""
    _check_k4(rng, "levels_b2", 7, s, gather=False)


@pytest.mark.parametrize("pooled", [7, 14])
def test_k4_plain_matches_gather_and_dense_at_sampling_ratio_3(rng, pooled):
    """S 3: refused by the TPU kernel, computed by the reference's gather
    and dense forms (``roi_align_impl`` other than the window on the TPU),
    and by K4 since its runtime-S path; its average is a division by 9."""
    rois, levels, c = _case(rng, "levels_b2")
    feats = _pyramid(rng, rois.shape[0], c)
    got = roi_align_fpn.fpn_roi_align(tuple(_t(f) for f in feats), _t(rois), _t(levels),
                                      pooled=pooled, sampling_ratio=3, strides=STRIDES)
    args = (tuple(jnp.asarray(f) for f in feats), jnp.asarray(rois), jnp.asarray(levels))
    for impl in ("gather", "dense"):
        ref = np.asarray(fpn_roi_align_batched(*args, pooled=pooled, sampling_ratio=3,
                                               strides=STRIDES, impl=impl))
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=ROI_RTOL * float(np.abs(ref).max()), err_msg=impl)


def _per_call_pool(pyramid, rois, pooled):
    """The pooling with a channel-last copy of the pyramid per call."""
    levels = (fpn_level_assignment(rois) - 2).to(torch.int32).contiguous()
    feats = tuple(p.permute(0, 2, 3, 1).contiguous() for p in pyramid[:4])
    return roi_align_fpn.FPNRoIAlign.apply(rois.contiguous(), levels, pooled, 2,
                                           FPN_STRIDES[:4], *feats)


@pytest.mark.parametrize("memory_format", [torch.contiguous_format, torch.channels_last],
                         ids=["nchw", "channels_last"])
def test_pool_boxes_on_levels_made_once_equal_per_call_copies(memory_format):
    """A train step's three calls (box at 7, mask at 14, padded GT slots at
    14) on one channel-last tuple against a copy per call: the same outputs,
    and the same gradients to the pyramid up to the order of the f32 adds."""
    rng = np.random.RandomState(3)
    b, c = 2, 16
    box = _t(np.stack([_boxes(rng, 12, -10, 100, 6, 90) for _ in range(b)]))
    gt = torch.zeros((b, 6, 4))
    gt[:, :2] = _t(_boxes(rng, 4, 0, 60, 10, 60).reshape(b, 2, 4))
    calls = ((box, 7), (box[:, :4], 14), (gt, 14))
    weights = [_t(rng.randn(b, r.shape[1], p, p, c).astype(np.float32)) for r, p in calls]
    base = [_t(rng.randn(b, c, CANVAS[0] // s, CANVAS[1] // s).astype(np.float32))
            for s in STRIDES]

    def run(once: bool):
        pyramid = [p.contiguous(memory_format=memory_format).requires_grad_() for p in base]
        levels4 = _channel_last(pyramid) if once else None
        outs = [_pool_boxes(levels4, r, p) if once else _per_call_pool(pyramid, r, p)
                for r, p in calls]
        # the pyramid's other consumers (RPN, semantic head) add to its gradient too
        loss = sum((o * wt).sum() for o, wt in zip(outs, weights))
        loss = loss + sum((p * p).sum() for p in pyramid)
        loss.backward()
        return outs, [p.grad for p in pyramid]

    outs_once, grads_once = run(True)
    outs_call, grads_call = run(False)
    for a, b_ in zip(outs_once, outs_call):
        assert torch.equal(a, b_)
    for a, b_ in zip(grads_once, grads_call):
        np.testing.assert_allclose(a.numpy(), b_.numpy(), rtol=1e-6,
                                   atol=1e-6 * float(b_.abs().max()))


# off the CPU the kernel's needs are checked before the device, so a meta
# tensor shows the card's rules: (C, sampling ratio, RoIs an image, match)
MALFORMED = {
    "c_mod_8": (12, 2, 4, "multiple of 8"),
    "sampling_ratio": (8, 0, 4, "sampling_ratio=0"),
    "index_2_31": (8, 2, 2 ** 31 // 49 + 1, "below 2\\^31"),
    "cuda_only": (8, 2, 4, "unsupported device"),
    "ratio_3_reaches_the_device": (8, 3, 4, "unsupported device"),
}


@pytest.mark.parametrize("what", list(MALFORMED))
def test_k4_wrapper_checks_the_kernels_needs_before_the_device(what):
    """C % 8, a sampling ratio of at least 1 (any such ratio has a kernel)
    and a flat index below 2^31 (at P 7, C 8: B * R * 49 threads, whatever
    the ratio) are refused off the CPU without a launch; a call that meets
    them reaches the device check."""
    c, s, r, match = MALFORMED[what]
    feats = tuple(torch.empty((1, 4, 4, c), device="meta") for _ in STRIDES)
    rois = torch.empty((1, r, 4), device="meta")
    levels = torch.empty((1, r), dtype=torch.int32, device="meta")
    before = roi_align_fpn.launches
    with pytest.raises(ValueError, match=match):
        roi_align_fpn.fpn_roi_align(feats, rois, levels, pooled=7, sampling_ratio=s,
                                    strides=STRIDES)
    assert roi_align_fpn.launches == before
