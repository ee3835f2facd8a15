"""The training slice of the port against the JAX package on the CPU:
targets, losses, the ``forward_train`` loss dict, gradients, the optimizer
update and a few train steps.

Tiny config (``resnet_test`` trunk, float32, 64x96, batch 2, 16 RoIs, 32
anchors, 4 GT slots), weights shared through the bridge, DCN offset biases
at +-2 px (fractional, so the sampler is smooth there) and frozen-BN scales
below 1. JAX's random draws cannot be reproduced by torch, so the tests
draw them with ``jax.random`` exactly as ``forward_train`` derives them from
its key and hand the numbers to the port as ``noise``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_predict import H, W, perturbed_params, tiny
from upsnet_tpu.config import default_config as jax_default_config
from upsnet_tpu.models import upsnet as jup
from upsnet_tpu.ops import targets as jtargets
from upsnet_tpu.ops.anchors import pyramid_anchors
from upsnet_tpu.train import losses as jlosses
from upsnet_tpu.train import optimizer as joptim
from upsnet_torch.config import default_config
from upsnet_torch.convert.from_jax import load_jax_params, to_jax
from upsnet_torch.data.synthetic import synthetic_batch
from upsnet_torch.models import upsnet as tup
from upsnet_torch.ops import targets as ttargets
from upsnet_torch.train import losses as tlosses
from upsnet_torch.train import optimizer as toptim
from upsnet_torch.train.trainer import train_steps

torch.set_num_threads(2)

BSZ = 2
LOSS_KEYS = ("rpn_cls", "rpn_bbox", "cls", "bbox", "mask", "seg", "pano")


def tiny_train(cfg):
    """``tiny`` plus a small train set-up; ``dcn_impl: pallas`` (on the CPU
    the JAX package routes it to its dense ``mxu`` form, the port to the
    plain versions of K2/K3), no remat. Anchors may straddle the small
    image by 12 px, so that some are inside and some are not."""
    cfg = tiny(cfg)
    return cfg.replace(
        network=dataclasses.replace(cfg.network, dcn_impl="pallas",
                                    dcn_boundary_grad="clip"),
        train=dataclasses.replace(
            cfg.train, rpn_pre_nms_top_n=64, rpn_post_nms_top_n=32, batch_rois=16,
            rpn_batch_size=32, rpn_straddle_thresh=12.0, max_gt_instances=4,
            remat=False),
    )


def _t(a):
    return torch.from_numpy(np.array(a))  # an owned, writable, contiguous copy


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, np.asarray(tree)


def _batch(tcfg, seed=1):
    """A synthetic batch with one crowd region on the first image."""
    batch = synthetic_batch(tcfg, (H, W), BSZ, seed, image_hw=(H - 4, W - 8))
    gc = tcfg.train.max_crowd_instances
    batch["crowd_boxes"] = np.zeros((BSZ, gc, 4), np.float32)
    batch["crowd_boxes"][0, 0] = (60.0, 5.0, 90.0, 30.0)
    batch["crowd_valid"] = np.zeros((BSZ, gc), bool)
    batch["crowd_valid"][0, 0] = True
    return batch


def _jax_noise(key, n_anchors, n_cand, g):
    """The uniform draws of the JAX ``forward_train`` for ``key``, as the
    port's ``noise``: per image, ``_sample_k`` ranks ``uniform(k, (n,))``
    with k one half of that image's split key."""
    keys = jax.random.split(key, (3, BSZ))

    def pris(row, n):
        halves = [jax.random.split(k) for k in keys[row]]
        return (np.stack([np.asarray(jax.random.uniform(kf, (n,))) for kf, _ in halves]),
                np.stack([np.asarray(jax.random.uniform(kb, (n,))) for _, kb in halves]))

    rpn_fg, rpn_bg = pris(0, n_anchors)
    roi_fg, roi_bg = pris(1, n_cand)
    unknown = np.asarray(jax.random.uniform(jax.random.fold_in(key, 7), (BSZ, g)))
    return keys, {"rpn_fg": rpn_fg, "rpn_bg": rpn_bg, "roi_fg": roi_fg, "roi_bg": roi_bg,
                  "unknown": unknown}


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = tiny_train(jax_default_config()), tiny_train(default_config())
    jm = jup.build_model(jcfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)))["params"]
    params = perturbed_params(params)
    tm = tup.build_model(tcfg, device="cpu")
    load_jax_params(tm, params)
    anchors = pyramid_anchors((H, W))
    janchors = tuple(jnp.asarray(a) for a in anchors)
    tanchors = tuple(torch.from_numpy(a) for a in anchors)
    batch = _batch(tcfg)
    key = jax.random.PRNGKey(5)
    n_anchors = sum(a.shape[0] for a in anchors)
    n_cand = tcfg.train.rpn_post_nms_top_n + tcfg.train.max_gt_instances
    keys, noise = _jax_noise(key, n_anchors, n_cand, tcfg.train.max_gt_instances)

    def loss_fn(p, b):
        return jup.forward_train(jm, p, jcfg, janchors, b, key)

    (_, jlosses_out), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    return dict(jcfg=jcfg, tcfg=tcfg, params=params, tm=tm, anchors=anchors,
                tanchors=tanchors, batch=batch, keys=keys, noise=noise,
                jlosses=jax.device_get(jlosses_out), jgrads=jax.device_get(jgrads))


# ----------------------------------------------------------------- targets


def test_rpn_targets_match_jax_given_the_same_priorities(setup):
    """Labels bit-equal; bbox targets within 1e-6 (the same f32 formulas)."""
    tc, batch, noise = setup["tcfg"].train, setup["batch"], setup["noise"]
    anchors = np.concatenate(setup["anchors"], 0)
    kw = dict(batch_size=tc.rpn_batch_size, fg_fraction=tc.rpn_fg_fraction,
              positive_overlap=tc.rpn_positive_overlap,
              negative_overlap=tc.rpn_negative_overlap,
              straddle_thresh=tc.rpn_straddle_thresh, crowd_thresh=tc.crowd_filter_thresh)
    got = ttargets.rpn_targets(
        _t(anchors), _t(batch["gt_boxes"]), _t(batch["gt_valid"]), _t(batch["im_hw"]),
        crowd_boxes=_t(batch["crowd_boxes"]), crowd_valid=_t(batch["crowd_valid"]),
        pri_fg=_t(noise["rpn_fg"]), pri_bg=_t(noise["rpn_bg"]), **kw)
    for i in range(BSZ):
        ref = jtargets.rpn_targets(
            setup["keys"][0][i], jnp.asarray(anchors), jnp.asarray(batch["gt_boxes"][i]),
            jnp.asarray(batch["gt_valid"][i]), jnp.asarray(batch["im_hw"][i]),
            crowd_boxes=jnp.asarray(batch["crowd_boxes"][i]),
            crowd_valid=jnp.asarray(batch["crowd_valid"][i]), **kw)
        labels = np.asarray(ref.labels)
        assert (labels == 1).any() and (labels == 0).any() and (labels == -1).any()
        assert got.labels.dtype == torch.int32
        np.testing.assert_array_equal(got.labels[i].numpy(), labels)
        np.testing.assert_array_equal(got.bbox_inside[i].numpy(), np.asarray(ref.bbox_inside))
        np.testing.assert_allclose(got.bbox_targets[i].numpy(), np.asarray(ref.bbox_targets),
                                   rtol=1e-6, atol=1e-6)
        assert float(got.norm[i]) == float(ref.norm)


def test_proposal_mask_targets_match_jax_given_the_same_priorities(setup, rng):
    """Sampled RoIs, validity, labels, fg, levels, matched GT and mask
    targets bit-equal; bbox targets within 1e-6."""
    tcfg, batch, noise = setup["tcfg"], setup["batch"], setup["noise"]
    tc = tcfg.train
    p = tc.rpn_post_nms_top_n
    # proposals: jittered copies of the GT boxes (fg), random boxes (bg),
    # some inside the crowd region, some invalid
    props = rng.uniform(0, 60, (BSZ, p, 4)).astype(np.float32)
    props[..., 2:] = props[..., :2] + rng.uniform(4, 40, (BSZ, p, 2))
    for i in range(BSZ):
        n_gt = int(batch["gt_valid"][i].sum())
        for j in range(12):
            props[i, j] = batch["gt_boxes"][i, j % n_gt] + rng.uniform(-3, 3, 4)
    props[0, 12:16] = np.array([62.0, 7.0, 88.0, 28.0], np.float32) + rng.uniform(
        -1, 1, (4, 4))
    valid = np.ones((BSZ, p), bool)
    valid[:, -5:] = False
    kw = dict(batch_rois=tc.batch_rois, fg_fraction=tc.fg_fraction, fg_thresh=tc.fg_thresh,
              bg_thresh_hi=tc.bg_thresh_hi, bg_thresh_lo=tc.bg_thresh_lo,
              bbox_weights=tuple(tcfg.network.bbox_reg_weights),
              mask_size=tcfg.network.mask_size, mask_scale=0.25,
              crowd_thresh=tc.crowd_filter_thresh)
    got = ttargets.proposal_mask_targets(
        _t(props), _t(valid), _t(batch["gt_boxes"]), _t(batch["gt_classes"]),
        _t(batch["gt_valid"]), _t(batch["gt_masks"]),
        crowd_boxes=_t(batch["crowd_boxes"]), crowd_valid=_t(batch["crowd_valid"]),
        pri_fg=_t(noise["roi_fg"]), pri_bg=_t(noise["roi_bg"]), **kw)
    for i in range(BSZ):
        ref = jtargets.proposal_mask_targets(
            setup["keys"][1][i], jnp.asarray(props[i]), jnp.asarray(valid[i]),
            jnp.asarray(batch["gt_boxes"][i]), jnp.asarray(batch["gt_classes"][i]),
            jnp.asarray(batch["gt_valid"][i]), jnp.asarray(batch["gt_masks"][i]),
            crowd_boxes=jnp.asarray(batch["crowd_boxes"][i]),
            crowd_valid=jnp.asarray(batch["crowd_valid"][i]), **kw)
        assert np.asarray(ref.fg).sum() >= 2 and (np.asarray(ref.valid) & ~np.asarray(ref.fg)).any()
        assert np.asarray(ref.mask_targets).any()
        for name in ("rois", "valid", "labels", "fg", "levels", "mask_targets",
                     "matched_gt"):
            g, r = getattr(got, name)[i].numpy(), np.asarray(getattr(ref, name))
            assert g.dtype == r.dtype, (name, g.dtype, r.dtype)
            np.testing.assert_array_equal(g, r, err_msg=name)
        np.testing.assert_allclose(got.bbox_targets[i].numpy(), np.asarray(ref.bbox_targets),
                                   rtol=1e-6, atol=1e-6)


def test_targets_draw_from_the_generator_when_no_priorities_are_given(setup):
    """Absent priorities come from the explicit generator: the same seed
    gives the same sample, another seed another."""
    batch = setup["batch"]
    anchors = _t(np.concatenate(setup["anchors"], 0))
    args = (anchors, _t(batch["gt_boxes"]), _t(batch["gt_valid"]), _t(batch["im_hw"]))
    a, b, c = (ttargets.rpn_targets(*args, batch_size=32,
                                    generator=torch.Generator().manual_seed(s)).labels
               for s in (1, 1, 2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert int((a >= 0).sum()) == 2 * 32


# ------------------------------------------------------------------ losses


def test_each_loss_term_matches_jax(rng):
    """The loss functions on shared random inputs, f32: rtol 1e-5 (log-
    softmax and sums in another order)."""
    tol = dict(rtol=1e-5, atol=1e-6)
    n, c = 40, 5
    logits2 = rng.randn(n, 2).astype(np.float32)
    labels3 = rng.randint(-1, 2, n).astype(np.int32)
    np.testing.assert_allclose(
        float(tlosses.rpn_cls_loss(_t(logits2), _t(labels3))),
        float(jlosses.rpn_cls_loss(jnp.asarray(logits2), jnp.asarray(labels3))), **tol)
    pred4, tgt4 = rng.randn(n, 4).astype(np.float32), rng.randn(n, 4).astype(np.float32) * 0.2
    fgm = (rng.rand(n) < 0.4).astype(np.float32)
    np.testing.assert_allclose(
        float(tlosses.rpn_bbox_loss(_t(pred4), _t(tgt4), _t(fgm), torch.tensor(17.0))),
        float(jlosses.rpn_bbox_loss(jnp.asarray(pred4), jnp.asarray(tgt4), jnp.asarray(fgm),
                                    jnp.asarray(17.0))), **tol)
    cls = rng.randn(n, c).astype(np.float32)
    labels = rng.randint(0, c, n).astype(np.int32)
    valid, fg = rng.rand(n) < 0.8, rng.rand(n) < 0.3
    np.testing.assert_allclose(
        float(tlosses.rcnn_cls_loss(_t(cls), _t(labels), _t(valid))),
        float(jlosses.rcnn_cls_loss(jnp.asarray(cls), jnp.asarray(labels),
                                    jnp.asarray(valid))), **tol)
    bpred = rng.randn(n, 4 * c).astype(np.float32) * 2
    np.testing.assert_allclose(
        float(tlosses.rcnn_bbox_loss(_t(bpred), _t(labels), _t(tgt4), _t(fg), _t(valid))),
        float(jlosses.rcnn_bbox_loss(jnp.asarray(bpred), jnp.asarray(labels),
                                     jnp.asarray(tgt4), jnp.asarray(fg),
                                     jnp.asarray(valid))), **tol)
    mlog = rng.randn(n, 6, 6, c).astype(np.float32) * 3  # JAX layout, channel-last
    mtgt = (rng.rand(n, 6, 6) < 0.5).astype(np.float32)
    np.testing.assert_allclose(
        float(tlosses.mask_loss(_t(np.moveaxis(mlog, -1, 1)), _t(labels), _t(mtgt), _t(fg))),
        float(jlosses.mask_loss(jnp.asarray(mlog), jnp.asarray(labels), jnp.asarray(mtgt),
                                jnp.asarray(fg))), **tol)
    seg = rng.randn(2, 16, 24, 7).astype(np.float32)
    gt = rng.randint(0, 7, (2, 16, 24)).astype(np.int32)
    gt[rng.rand(2, 16, 24) < 0.1] = 255
    np.testing.assert_allclose(
        float(tlosses.seg_loss(_t(seg), _t(gt).long())),
        float(jlosses.seg_loss(jnp.asarray(seg), jnp.asarray(gt))), **tol)
    boxes = np.array([[[2.0, 1.0, 9.5, 7.2], [0.0, 0.0, 23.0, 15.0], [20.0, 12.0, 30.0, 18.0]],
                      [[5.5, 3.5, 6.0, 4.0], [1.0, 2.0, 3.0, 4.0], [0.0, 0.0, 0.0, 0.0]]],
                     np.float32)
    bvalid = np.array([[True, True, True], [True, True, False]])
    got = tlosses.seg_roi_loss(_t(seg), _t(gt).long(), _t(boxes), _t(bvalid))
    for i in range(2):
        ref = jlosses.seg_roi_loss(jnp.asarray(seg[i]), jnp.asarray(gt[i]),
                                   jnp.asarray(boxes[i]), jnp.asarray(bvalid[i]))
        np.testing.assert_allclose(float(got[i]), float(ref), **tol)
    pan = rng.randn(9, 16, 24).astype(np.float32)
    pgt = rng.randint(0, 9, (16, 24)).astype(np.int32)
    pgt[rng.rand(16, 24) < 0.2] = 255
    np.testing.assert_allclose(
        float(tlosses.panoptic_loss(_t(pan), _t(pgt).long())),
        float(jlosses.panoptic_loss(jnp.asarray(pan), jnp.asarray(pgt))), **tol)


def test_panoptic_training_ops_match_jax(rng):
    """``panoptic_argmax`` (the logit stack of the panoptic loss) within
    1e-5 and ``mask_matching`` bit-equal, with overlapping instances, an
    invalid one and one routed to the unknown channel."""
    from upsnet_tpu.ops import panoptic as jpan
    from upsnet_torch.ops import panoptic as tpan

    h, w, s, n = 16, 24, 3, 4
    seg = rng.randn(h, w, 7).astype(np.float32)
    boxes = np.array([[1.2, 0.5, 9.5, 7.7], [6.0, 4.0, 20.0, 14.0], [0.0, 0.0, 23.0, 15.0],
                      [3.0, 3.0, 5.0, 5.0]], np.float32)
    classes = np.array([0, 3, 1, 2], np.int32)
    mlog = rng.randn(n, 28, 28).astype(np.float32) * 2
    valid = np.array([True, True, False, True])
    ref_id, ref_lg = jpan.panoptic_argmax(*(jnp.asarray(a) for a in (
        seg, boxes, classes, mlog, valid)), s)
    got_id, got_lg = tpan.panoptic_argmax(_t(seg), _t(boxes), _t(classes), _t(mlog),
                                          _t(valid), s)
    np.testing.assert_allclose(got_lg.numpy(), np.asarray(ref_lg), rtol=1e-5, atol=1e-5)
    assert got_id.dtype == torch.int32
    np.testing.assert_array_equal(got_id.numpy(), np.asarray(ref_id))

    seg_gt = rng.randint(0, 7, (h, w)).astype(np.int32)
    seg_gt[rng.rand(h, w) < 0.1] = 255
    masks = np.zeros((n, h, w), np.uint8)
    masks[0, 1:9, 2:10] = 1
    masks[1, 5:14, 6:20] = 1  # overlaps instance 0: the later one wins
    masks[2, 0:4, 0:4] = 1  # invalid
    masks[3, 6:12, 8:18] = 1  # to unknown, over instance 1
    unknown = np.array([False, False, False, True])
    ref = jpan.mask_matching(jnp.asarray(seg_gt), jnp.asarray(masks), jnp.asarray(valid),
                             jnp.asarray(unknown), s)
    got = tpan.mask_matching(_t(seg_gt), _t(masks), _t(valid), _t(unknown), s)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert {s + 0, s + 1, s + n, 255} <= set(np.unique(got.numpy()).tolist())


# ---------------------------------------------- forward_train and gradients


def _torch_forward(setup):
    tm = setup["tm"]
    batch = {k: _t(v) for k, v in setup["batch"].items()}
    noise = {k: _t(v) for k, v in setup["noise"].items()}
    tm.zero_grad(set_to_none=True)
    return tup.forward_train(tm, setup["tcfg"], setup["tanchors"], batch, noise)


def test_forward_train_loss_dict_matches_jax(setup):
    """The 7 terms with shared weights and shared noise: rtol 1e-4."""
    total, losses = _torch_forward(setup)
    ref = setup["jlosses"]
    assert tuple(losses) == LOSS_KEYS and set(ref) == set(LOSS_KEYS)
    for k in LOSS_KEYS:
        assert np.isfinite(float(ref[k])) and float(ref[k]) > 0, k
        np.testing.assert_allclose(float(losses[k].detach()), float(ref[k]), rtol=1e-4,
                                   err_msg=k)
    np.testing.assert_allclose(float(total.detach()),
                               sum(float(ref[k]) for k in LOSS_KEYS), rtol=1e-4)
    with pytest.raises(KeyError):
        tup.forward_train(setup["tm"], setup["tcfg"], setup["tanchors"],
                          {k: _t(v) for k, v in setup["batch"].items()}, {"rpn": None})


def test_gradients_match_jax_grad(setup):
    """Every trainable leaf against ``jax.grad`` of ``forward_train``,
    through ``to_jax``. The JAX package differentiates its dense ``mxu``
    DCN form on the CPU, the port runs K3's plain version: they agree away
    from integer sample coordinates, which the +-2 px fractional offset
    biases ensure. Per leaf: |got - ref| <= 1e-3 |ref| + 1e-4 max|ref leaf|
    (f32 through the whole network, sums in another order). Frozen leaves
    carry no gradient in the port."""
    total, _ = _torch_forward(setup)
    total.backward()
    tm, params = setup["tm"], setup["params"]
    named = dict(tm.named_parameters())
    frozen = {n for n, p in named.items() if not p.requires_grad}
    assert frozen and all(n.startswith(("backbone_net.conv1.", "backbone_net.res2_"))
                          for n in frozen)
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in named.items()}
    grads.update({n: torch.zeros_like(b) for n, b in tm.named_buffers()})
    got_tree = to_jax(grads, params)
    trainable = _trainable_paths(tm, params)
    checked = 0
    ref_leaves = dict(_leaves(setup["jgrads"]))
    for path, got in _leaves(got_tree):
        ref = ref_leaves[path]
        name = ".".join(path)
        if path not in trainable:
            assert not got.any(), name
            continue
        scale = np.abs(ref).max()
        assert np.isfinite(got).all() and scale > 0, name
        np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4 * scale, err_msg=name)
        checked += 1
    assert checked == len(named) - len(frozen)
    off = got_tree["fcn_head"]["subnet"]["dcn1"]["offset_conv"]
    assert np.abs(off["kernel"]).max() > 0 and np.abs(off["bias"]).max() > 0


def _trainable_paths(tm, params):
    """The JAX tree paths of the port's trainable parameters. (The JAX
    label tree does not say: it calls the FrozenBN biases ``bias``, not
    ``frozen``; they never move because the module stops their gradient.)"""
    named = dict(tm.named_parameters())
    out = set()
    for path, _ in _leaves(params):
        name = ".".join(path[:-1] + ("weight" if path[-1] == "kernel" else path[-1],))
        if name in named and named[name].requires_grad:
            out.add(path)
    return out


def _leaves_str(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_str(v, path + (k,))
    else:
        yield path, tree


def test_to_jax_inverts_the_bridge(setup):
    """state_dict -> ``to_jax`` gives back the JAX tree bit for bit."""
    back = to_jax(setup["tm"].state_dict(), setup["params"])
    ref = dict(_leaves(setup["params"]))
    got = dict(_leaves(back))
    assert set(got) == set(ref)
    for path, leaf in ref.items():
        np.testing.assert_array_equal(got[path], leaf, err_msg=".".join(path))


# --------------------------------------------------------------- optimizer


def test_param_groups_follow_the_jax_labels(setup):
    tm, jcfg, tcfg = setup["tm"], setup["jcfg"], setup["tcfg"]
    labels = dict(_leaves_str(joptim._param_labels(setup["params"],
                                                   jcfg.network.frozen_stages)))
    opt = toptim.make_optimizer(tcfg, tm)
    in_group = {id(p): g["name"] for g in opt.param_groups for p in g["params"]}
    named = dict(tm.named_parameters())
    for path, label in labels.items():
        name = ".".join(path[:-1] + ("weight" if path[-1] == "kernel" else path[-1],))
        if name in named:
            assert in_group.get(id(named[name]), "frozen") == label, name
    rules = {g["name"]: (g["lr_mult"], g["weight_decay"]) for g in opt.param_groups}
    tc = tcfg.train
    assert rules == {"weight": (1.0, tc.wd), "bias": (2.0, 0.0),
                     "offset": (tc.dcn_offset_lr_mult, tc.wd),
                     "offset_bias": (tc.dcn_offset_lr_mult, 0.0)}
    assert all(g["momentum"] == 0.9 and not g["nesterov"] and g["dampening"] == 0
               for g in opt.param_groups)


@pytest.mark.parametrize("grad_scale", [1.0, 50.0], ids=["unclipped", "clipped"])
def test_optimizer_steps_match_optax(setup, rng, grad_scale):
    """Eight updates from shared random gradients against optax's: inside
    the warmup (4 steps), across a decay boundary (step 6), with momentum
    carried, weight decay, the bias / offset groups and, at scale 50, the
    global-norm clip active. Updated parameters within 1e-6 (rtol and atol:
    the schedule is float64 in the port, float32 in optax). Leaves that the
    port does not train (frozen stages, FrozenBN affines) get zero
    gradients on both sides, as the JAX modules stop the affines'
    gradients; optax's clip would otherwise count gradients of the frozen
    stages, which the port never computes."""
    sched = dict(lr=0.05, warmup_iteration=4, warmup_factor=1.0 / 3.0, decay_iteration=(6,),
                 decay_factor=0.1, grad_clip=35.0, wd=1e-2, dcn_offset_lr_mult=0.5)
    jcfg = setup["jcfg"].replace(train=dataclasses.replace(setup["jcfg"].train, **sched))
    tcfg = setup["tcfg"].replace(train=dataclasses.replace(setup["tcfg"].train, **sched))
    params = setup["params"]
    tm = tup.build_model(tcfg, device="cpu")
    load_jax_params(tm, params)
    named = dict(tm.named_parameters())
    opt = toptim.make_optimizer(tcfg, tm)
    tx = joptim.make_optimizer(jcfg, params)
    jparams = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(jparams)

    @jax.jit
    def optax_step(grads, state, p):
        updates, state = tx.update(grads, state, p)
        return optax.apply_updates(p, updates), state

    trainable = _trainable_paths(tm, params)
    lrs = []
    for step in range(8):
        grads = {}
        for path, leaf in _leaves(params):
            g = (rng.randn(*leaf.shape) * grad_scale * 0.05).astype(np.float32)
            grads[path] = g if path in trainable else np.zeros_like(g)
        jg = _unflatten(grads)
        sd_grads = _as_state_dict(jg)
        for n, p in named.items():
            p.grad = sd_grads[n].clone() if p.requires_grad else None
        jparams, opt_state = optax_step(jax.tree.map(jnp.asarray, jg), opt_state, jparams)
        toptim.sgd_update(opt, tcfg, step)
        lrs.append(opt.param_groups[0]["lr"])
        got = dict(_leaves(to_jax(tm.state_dict(), params)))
        for path, ref in _leaves(jax.device_get(jparams)):
            np.testing.assert_allclose(got[path], ref, rtol=1e-6, atol=1e-6,
                                       err_msg=f"step {step} {'.'.join(path)}")
    assert lrs[0] == pytest.approx(0.05 / 3) and lrs[4] == pytest.approx(0.05)
    assert lrs[6] == pytest.approx(0.005) and lrs[1] > lrs[0]
    moved = dict(_leaves(to_jax(tm.state_dict(), params)))
    for path, leaf in _leaves(params):
        assert (path not in trainable) == np.array_equal(moved[path], leaf), path


def _unflatten(flat):
    tree = {}
    for path, leaf in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return tree


def _as_state_dict(tree):
    from upsnet_torch.convert.from_jax import jax_params_to_state_dict

    return jax_params_to_state_dict(tree)


# ------------------------------------------------------------------- steps


def test_train_steps_reduce_the_loss(setup):
    """Four steps on one fixed synthetic batch (fresh model, generator-
    drawn noise): every term finite at every step, and the total lower at
    step 3 than at step 0. Frozen parameters do not move."""
    tcfg = setup["tcfg"].replace(train=dataclasses.replace(setup["tcfg"].train, lr=0.01))
    tm = tup.build_model(tcfg, device="cpu")
    load_jax_params(tm, setup["params"])
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    batch = {k: _t(v) for k, v in setup["batch"].items()}
    seen = []
    history = train_steps(tm, tcfg, setup["tanchors"], [batch] * 4,
                          generator=torch.Generator().manual_seed(3),
                          on_step=lambda i, m: seen.append(i))
    assert seen == [0, 1, 2, 3] and len(history) == 4
    for metrics in history:
        assert set(metrics) == {*LOSS_KEYS, "total"}
        assert all(np.isfinite(v) for v in metrics.values()), metrics
        assert metrics["total"] == pytest.approx(sum(metrics[k] for k in LOSS_KEYS), rel=1e-5)
    assert history[3]["total"] < history[0]["total"], [m["total"] for m in history]
    for n, p in tm.named_parameters():
        assert p.requires_grad != torch.equal(p, before[n]), n


def test_synthetic_batch_layout():
    cfg = tiny_train(default_config())
    b = synthetic_batch(cfg, (H, W), 3, seed=2, image_hw=(H - 4, W - 8))
    g = cfg.train.max_gt_instances
    assert b["images"].shape == (3, H, W, 3) and b["images"].dtype == np.float32
    assert b["gt_masks"].shape == (3, g, H // 4, W // 4) and b["gt_masks"].dtype == np.uint8
    assert b["seg_gt"].shape == (3, H // 4, W // 4) and b["seg_gt"].dtype == np.int32
    assert (b["seg_gt"][:, (H - 4) // 4:] == 255).all() and not b["images"][:, H - 4:].any()
    for i in range(3):
        n = int(b["gt_valid"][i].sum())
        assert 1 <= n <= 3 and not b["gt_masks"][i, n:].any()
        for j in range(n):
            x1, y1, x2, y2 = b["gt_boxes"][i, j]
            cls = b["gt_classes"][i, j]
            assert 1 <= cls < cfg.dataset.num_classes and x2 > x1 and y2 > y1
            ys, xs = np.nonzero(b["gt_masks"][i, j])
            assert ys.min() * 4 + 2 >= y1 and ys.max() * 4 + 2 <= y2
            assert xs.min() * 4 + 2 >= x1 and xs.max() * 4 + 2 <= x2
    again = synthetic_batch(cfg, (H, W), 3, seed=2, image_hw=(H - 4, W - 8))
    assert all(np.array_equal(b[k], again[k]) for k in b)
    with pytest.raises(ValueError):
        synthetic_batch(cfg, (H, W), 1, seed=0, image_hw=(H + 4, W))
