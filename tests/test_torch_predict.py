"""The whole predict slice: the port's ``forward_predict`` against the JAX
package's on the same weights (through the bridge) and the same inputs.

Tiny config (``resnet_test`` trunk, float32, 64x96, batch 2), DCN offset
biases at +-2 px and frozen-BN scales below 1 so activations stay O(1).
Discrete outputs (classes, det_valid, pan_map, pan_keep) must be equal;
continuous ones within rtol 1e-4 and atol 1e-4 * max|ref|.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upsnet_tpu.config import default_config as jax_default_config
from upsnet_tpu.models import upsnet as jup
from upsnet_tpu.ops.anchors import pyramid_anchors
from upsnet_torch.config import default_config
from upsnet_torch.convert.from_jax import load_jax_params
from upsnet_torch.models import upsnet as tup

torch.set_num_threads(2)

H, W = 64, 96
DISCRETE = ("classes", "det_valid", "pan_map", "pan_keep")
CONTINUOUS = ("boxes", "scores", "mask_logits", "seg_logits")


def tiny(cfg):
    """resnet_test trunk, narrow widths, float32; every detection may enter
    panoptic fusion (score threshold 0) so MaskRemoval and the instance
    channels are exercised at random init."""
    return cfg.replace(
        network=dataclasses.replace(
            cfg.network, backbone="resnet_test", fpn_feature_dim=32,
            rcnn_fc_dim=64, fcn_head_dim=16, compute_dtype="float32"),
        dataset=dataclasses.replace(
            cfg.dataset, num_classes=5, num_seg_classes=7, num_stuff=3),
        test=dataclasses.replace(
            cfg.test, rpn_pre_nms_top_n=64, rpn_post_nms_top_n=32, max_det=8,
            panoptic_score_thresh=0.0),
    )


def perturbed_params(params, seed=42):
    """O(1) activations through the random trunk (frozen-BN scales below
    1, as pretrained statistics give) and +-2 px DCN offset biases."""
    rng = np.random.RandomState(seed)

    def visit(node, path):
        if isinstance(node, dict):
            return {k: visit(v, path + (k,)) for k, v in node.items()}
        if path[-2:] == ("offset_conv", "bias"):
            return rng.uniform(-2, 2, node.shape).astype(np.float32)
        if path[-1] == "scale":
            return rng.uniform(0.3, 0.6, node.shape).astype(np.float32)
        return np.asarray(node)

    return visit(jax.device_get(params), ())


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = tiny(jax_default_config()), tiny(default_config())
    jm = jup.build_model(jcfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)))["params"]
    params = perturbed_params(params)
    tm = tup.build_model(tcfg, device="cpu")
    load_jax_params(tm, params)
    anchors = pyramid_anchors((H, W))
    janchors = tuple(jnp.asarray(a) for a in anchors)
    jpredict = jax.jit(lambda p, b: jup.forward_predict(jm, p, jcfg, janchors, b))
    tanchors = tuple(torch.from_numpy(a) for a in anchors)
    return params, jpredict, tm, tcfg, tanchors


def _batch(seed):
    rng = np.random.RandomState(seed)
    images = rng.uniform(-10, 10, (2, H, W, 3)).astype(np.float32)
    im_hw = np.array([[H, W], [H - 8, W - 16]], np.float32)
    return images, im_hw


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_predict_matches_jax(setup, seed):
    params, jpredict, tm, tcfg, tanchors = setup
    images, im_hw = _batch(seed)
    ref = jax.device_get(jpredict(params, {"images": jnp.asarray(images),
                                           "im_hw": jnp.asarray(im_hw)}))
    got = tup.forward_predict(tm, tcfg, tanchors, {"images": torch.from_numpy(images),
                                                   "im_hw": torch.from_numpy(im_hw)})
    assert set(got) == set(ref)
    # the slice must reach the interesting branches on this input
    assert np.asarray(ref["det_valid"]).any() and np.asarray(ref["pan_keep"]).any()
    for k in DISCRETE:
        g, r = got[k].numpy(), np.asarray(ref[k])
        assert g.dtype == r.dtype, (k, g.dtype, r.dtype)
        np.testing.assert_array_equal(g, r, err_msg=k)
    for k in CONTINUOUS:
        g, r = got[k].numpy(), np.asarray(ref[k])
        assert g.shape == r.shape and g.dtype == r.dtype, k
        fin = np.isfinite(r)
        np.testing.assert_array_equal(np.isfinite(g), fin, err_msg=k)
        np.testing.assert_allclose(np.where(fin, g, 0), np.where(fin, r, 0), rtol=1e-4,
                                   atol=1e-4 * np.abs(r[fin]).max(), err_msg=k)
