"""Each module of the port's predict path against its JAX counterpart.

Every stage gets the JAX package's own intermediates as input, so each
discrete decision (top-k, NMS, argmax) sees the same numbers in both.
Float32 on the CPU; continuous outputs within rtol 1e-4 and atol
1e-4 * max|ref|; discrete outputs equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upsnet_tpu.config import default_config as jax_default_config
from upsnet_tpu.models import upsnet as jup
from upsnet_tpu.models.fcn import resize_bilinear as jax_resize
from upsnet_tpu.ops import anchors as jan
from upsnet_tpu.ops import boxes as jbx
from upsnet_tpu.ops import nms as jnms
from upsnet_tpu.ops import panoptic as jpan
from upsnet_tpu.ops.mask_paste import paste_masks as jax_paste
from upsnet_tpu.ops.proposals import pyramid_proposals as jax_proposals
from upsnet_torch.config import default_config
from upsnet_torch.convert.from_jax import load_jax_params
from upsnet_torch.models import upsnet as tup
from upsnet_torch.models.fcn import resize_bilinear
from upsnet_torch.ops import anchors as tan
from upsnet_torch.ops import boxes as tbx
from upsnet_torch.ops import nms as tnms
from upsnet_torch.ops import panoptic as tpan
from upsnet_torch.ops.mask_paste import paste_masks
from upsnet_torch.ops.proposals import pyramid_proposals
from test_torch_predict import H, W, perturbed_params, tiny

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a))


def assert_close(got, ref, rtol=1e-4, scale_atol=1e-4, name=""):
    ref = np.asarray(ref)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(got), fin, err_msg=name)
    atol = scale_atol * (np.abs(ref[fin]).max() if fin.any() else 1.0)
    np.testing.assert_allclose(np.where(fin, got, 0), np.where(fin, ref, 0),
                               rtol=rtol, atol=atol, err_msg=name)


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = tiny(jax_default_config()), tiny(default_config())
    jm = jup.build_model(jcfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)))["params"]
    params = perturbed_params(params)
    tm = tup.build_model(tcfg, device="cpu")
    load_jax_params(tm, params)
    return jm, params, tm, jcfg, tcfg


@pytest.fixture(scope="module")
def trunk(models):
    """The JAX trunk's intermediates on one seeded batch."""
    jm, params, _, _, _ = models

    def run(m, x):
        cs = m.backbone_net(x)
        ps = m.fpn(cs)
        rc, rb = m.rpn(ps)
        lg, _ = m.fcn_head(ps[:4])
        return cs, ps, rc, rb, lg

    images = np.random.RandomState(0).uniform(-10, 10, (2, H, W, 3)).astype(np.float32)
    out = jax.jit(lambda p, x: jm.apply({"params": p}, x, method=run))(params, images)
    return images, jax.device_get(out)


def nchw(a):
    return _t(np.moveaxis(np.asarray(a), -1, 1))


@pytest.mark.parametrize("stage", ["backbone", "fpn", "rpn", "fcn"])
def test_trunk_stage_matches_jax(models, trunk, stage):
    _, _, tm, _, _ = models
    images, (cs, ps, rc, rb, lg) = trunk
    with torch.no_grad():
        if stage == "backbone":
            got = tm.backbone_net(nchw(images))
            refs = cs
            got = [g.permute(0, 2, 3, 1) for g in got]
        elif stage == "fpn":
            got = [g.permute(0, 2, 3, 1) for g in tm.fpn([nchw(c) for c in cs])]
            refs = ps
        elif stage == "rpn":
            gc, gb = tm.rpn([nchw(p) for p in ps])
            got, refs = list(gc) + list(gb), list(rc) + list(rb)
        else:
            got = [tm.fcn_head([nchw(p) for p in ps[:4]])[0].permute(0, 2, 3, 1)]
            refs = [lg]
    assert len(got) == len(refs)
    for i, (g, r) in enumerate(zip(got, refs)):
        assert_close(g, r, name=f"{stage}[{i}]")


def test_anchors_match_jax():
    for a, b in zip(tan.pyramid_anchors((H, W)), jan.pyramid_anchors((H, W))):
        np.testing.assert_array_equal(a, b)


def test_proposals_match_jax_on_jax_rpn(models, trunk):
    """pyramid_proposals on the JAX RPN outputs: rois, scores and validity
    (the top-k and NMS decisions) equal."""
    _, _, _, jcfg, _ = models
    _, (_, _, rc, rb, _) = trunk
    anchors = jan.pyramid_anchors((H, W))
    im_hw = np.array([[H, W], [H - 8, W - 16]], np.float32)
    tc = jcfg.test
    kw = dict(pre_nms_top_n=tc.rpn_pre_nms_top_n, post_nms_top_n=tc.rpn_post_nms_top_n,
              nms_thresh=tc.rpn_nms_thresh)
    ref = jax.vmap(lambda c, b, hw: jax_proposals(
        c, b, tuple(jnp.asarray(a) for a in anchors), hw, **kw))(
            tuple(rc), tuple(rb), jnp.asarray(im_hw))
    got = pyramid_proposals([_t(c) for c in rc], [_t(b) for b in rb],
                            [_t(a) for a in anchors], _t(im_hw), **kw)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    assert_close(got[0], ref[0], name="rois")
    assert_close(got[1], ref[1], name="scores")


def test_proposals_joint_cap_and_ties_match_jax(rng):
    """Random logits over a 5-level pyramid with the joint cap engaged and
    duplicated scores (stable tie order)."""
    shapes = [(32, 48), (16, 24), (8, 12), (4, 6), (2, 3)]
    anchors = jan.pyramid_anchors((128, 192))
    cls = [np.round(rng.randn(2, h, w, 6), 1).astype(np.float32) for h, w in shapes]
    box = [(rng.randn(2, h, w, 12) * 0.3).astype(np.float32) for h, w in shapes]
    im_hw = np.array([[128, 192], [100, 150]], np.float32)
    kw = dict(pre_nms_top_n=500, post_nms_top_n=200, nms_thresh=0.7,
              joint_nms_cap=1024)
    ref = jax.vmap(lambda c, b, hw: jax_proposals(
        c, b, tuple(jnp.asarray(a) for a in anchors), hw, **kw))(
            tuple(cls), tuple(box), jnp.asarray(im_hw))
    got = pyramid_proposals([_t(c) for c in cls], [_t(b) for b in box],
                            [_t(a) for a in anchors], _t(im_hw), **kw)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    assert_close(got[0], ref[0], name="rois")
    assert_close(got[1], ref[1], name="scores")


def _random_boxes(rng, n, span=100.0):
    xy = rng.uniform(0, span, (n, 2))
    wh = rng.uniform(2, 40, (n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def test_nms_padded_matches_jax(rng):
    boxes = _random_boxes(rng, 300)
    scores = np.round(rng.uniform(0, 1, 300), 2).astype(np.float32)  # many ties
    valid = rng.uniform(size=300) > 0.1
    for thresh, max_out in ((0.5, 50), (0.7, 400)):
        ref = jnms.nms_padded(jnp.asarray(boxes), jnp.asarray(scores), thresh,
                              max_out, jnp.asarray(valid))
        got = tnms.nms_padded(_t(boxes), _t(scores), thresh, max_out, _t(valid))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))


def test_batched_class_nms_matches_jax(rng):
    boxes = np.stack([_random_boxes(rng, 200) for _ in range(2)])
    scores = rng.uniform(0, 1, (2, 200)).astype(np.float32)
    classes = rng.randint(1, 6, (2, 200)).astype(np.int32)
    got = tnms.batched_class_nms(_t(boxes), _t(scores), _t(classes), 0.5, 30)
    for i in range(2):
        ref = jnms.batched_class_nms(jnp.asarray(boxes[i]), jnp.asarray(scores[i]),
                                     jnp.asarray(classes[i]), 0.5, 30)
        np.testing.assert_array_equal(got[0][i].numpy(), np.asarray(ref[0]))


def test_box_ops_match_jax(rng):
    boxes = _random_boxes(rng, 64, 600.0)
    deltas = (rng.randn(64, 4) * 2).astype(np.float32)
    hw = np.array([480.0, 640.0], np.float32)
    w = (10.0, 10.0, 5.0, 5.0)
    assert_close(tbx.decode_boxes(_t(boxes), _t(deltas), w),
                 jbx.decode_boxes(jnp.asarray(boxes), jnp.asarray(deltas), w))
    dec = np.asarray(jbx.decode_boxes(jnp.asarray(boxes), jnp.asarray(deltas), w))
    assert_close(tbx.clip_boxes(_t(dec), _t(hw)), jbx.clip_boxes(jnp.asarray(dec), hw))
    assert_close(tbx.pairwise_iou(_t(boxes[:20]), _t(boxes)),
                 jbx.pairwise_iou(jnp.asarray(boxes[:20]), jnp.asarray(boxes)))
    np.testing.assert_array_equal(
        tbx.fpn_level_assignment(_t(boxes)).numpy(),
        np.asarray(jbx.fpn_level_assignment(jnp.asarray(boxes))))


def test_detection_nms_matches_jax(rng, models):
    """Joint class-offset NMS with the candidate pool smaller than R*C."""
    _, _, _, jcfg, _ = models
    r, c = 40, 5
    base = _random_boxes(rng, 2 * r, 90.0).reshape(2, r, 1, 4)
    boxes_pc = (base + rng.randn(2, r, c, 4) * 2).astype(np.float32)
    logits = rng.randn(2, r, c).astype(np.float32) * 2
    scores = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    tc = dataclasses.replace(jcfg.test, detection_nms_pool=64, max_det=12)
    ref = jax.vmap(lambda b, s: jup._detection_nms(b, s, tc, c))(
        jnp.asarray(boxes_pc), jnp.asarray(scores))
    got = tup._detection_nms(_t(boxes_pc), _t(scores), tc, c)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref[3]))
    np.testing.assert_array_equal(got.classes.numpy(), np.asarray(ref[2]))
    assert_close(got.boxes, ref[0], name="boxes")
    assert_close(got.scores, ref[1], name="scores")


@pytest.mark.parametrize("factor", [2, 4, 8])
def test_resize_bilinear_matches_jax_image_resize(rng, factor):
    x = rng.randn(2, 5, 7, 3).astype(np.float32)
    ref = jax_resize(jnp.asarray(x), (5 * factor, 7 * factor))
    got = resize_bilinear(nchw(x), (5 * factor, 7 * factor)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def _dets(rng, n=6, hw=(16, 24)):
    boxes = _random_boxes(rng, n, 60.0)
    boxes[:, 2] = np.minimum(boxes[:, 2], hw[1] * 4 - 1)
    boxes[:, 3] = np.minimum(boxes[:, 3], hw[0] * 4 - 1)
    return boxes


def test_mask_paste_matches_jax(rng):
    masks = rng.randn(6, 28, 28).astype(np.float32)
    boxes = _dets(rng) * 0.25
    ref = jax_paste(jnp.asarray(masks), jnp.asarray(boxes), (16, 24))
    got = paste_masks(_t(masks), _t(boxes), (16, 24))
    assert_close(got, ref, name="paste")


def test_panoptic_fusion_ops_match_jax(rng):
    """seg_term, mask_removal and the streaming argmax with its first-wins
    tie order (stuff, instances, unknown), on inputs with exact ties."""
    n, s = 6, 3
    seg = np.round(rng.randn(16, 24, 7), 1).astype(np.float32)
    boxes_q = _dets(rng, n) * 0.25
    classes = rng.randint(0, 4, n).astype(np.int32)
    ms = np.round(rng.randn(n, 28, 28) * 3, 1).astype(np.float32)
    valid = np.array([1, 1, 0, 1, 1, 1], bool)
    assert_close(tpan.seg_term(_t(seg), _t(boxes_q), _t(classes), s),
                 jpan.seg_term(jnp.asarray(seg), jnp.asarray(boxes_q),
                               jnp.asarray(classes), s))
    probs = 1 / (1 + np.exp(-ms))
    pasted = np.asarray(jax_paste(jnp.asarray(probs), jnp.asarray(boxes_q), (16, 24)))
    np.testing.assert_array_equal(
        tpan.mask_removal(_t(pasted), _t(valid), 0.5).numpy(),
        np.asarray(jpan.mask_removal(jnp.asarray(pasted), jnp.asarray(valid), 0.5)))
    ref = jpan.panoptic_argmax_stream(jnp.asarray(seg), jnp.asarray(boxes_q),
                                      jnp.asarray(classes), jnp.asarray(ms),
                                      jnp.asarray(valid), s)
    got = tpan.panoptic_argmax_stream(_t(seg), _t(boxes_q), _t(classes), _t(ms),
                                      _t(valid), s)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_panoptic_fuse_matches_jax(rng, models):
    _, _, _, jcfg, _ = models
    b, d = 2, 6
    seg = rng.randn(b, 16, 24, 7).astype(np.float32)
    boxes = np.stack([_dets(rng, d) for _ in range(b)])
    classes = rng.randint(1, 5, (b, d)).astype(np.int32)
    ms = (rng.randn(b, d, 28, 28) * 3).astype(np.float32)
    scores = rng.uniform(0.4, 1.0, (b, d)).astype(np.float32)
    valid = rng.uniform(size=(b, d)) > 0.2
    kw = dict(score_thresh=0.6, overlap_thresh=0.5, num_stuff=3)
    ref = jax.vmap(lambda *a: jup.panoptic_fuse(*a, **kw))(
        *(jnp.asarray(a) for a in (seg, boxes, classes, ms, scores, valid)))
    got = tup.panoptic_fuse(*(_t(a) for a in (seg, boxes, classes, ms, scores, valid)),
                            **kw)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
