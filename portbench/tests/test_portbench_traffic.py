"""The benchmark's inputs come from the seed: the same seed gives the same
requests, order and weights; another seed gives other ones."""

import numpy as np
import torch

from portbench import weights as W
from portbench.tests.tiny import tiny_mix, tiny_train_mix
from portbench.traffic.generator import make_requests, make_train_batches, request_order

BIG = 2 ** 31 + 977  # the driver's seeds are larger than 32 signed bits hold


def test_requests_repeat_with_the_seed():
    mix = tiny_mix()
    a, ha = make_requests(mix, 4, 3, BIG)
    b, hb = make_requests(mix, 4, 3, BIG)
    c, hc = make_requests(mix, 4, 3, BIG + 1)
    assert np.array_equal(a, b) and np.array_equal(ha, hb)
    assert not np.array_equal(a, c)
    assert a.shape == (mix["pool"], mix["batch"], *mix["bucket"], 3)
    lo, hi = mix["long_side"]
    assert ((ha[..., 1] >= lo) & (ha[..., 1] <= hi) & (ha[..., 0] == mix["short_side"])).all()
    # nothing beyond the image
    for r in range(len(a)):
        for j in range(mix["batch"]):
            h, w = ha[r, j].astype(int)
            assert not a[r, j, h:].any() and not a[r, j, :, w:].any()


def test_request_order_cycles_the_pool():
    mix = tiny_mix()
    o = request_order(mix, BIG, 10 * mix["pool"])
    assert np.array_equal(o, request_order(mix, BIG, 10 * mix["pool"]))
    assert not np.array_equal(o, request_order(mix, BIG + 5, 10 * mix["pool"]))
    assert (np.bincount(o, minlength=mix["pool"]) == 10).all()


def test_weights_repeat_with_the_seed():
    shapes = {"a.conv.weight": (8, 4, 3, 3), "a.offset_conv.weight": (18, 4, 3, 3),
              "a.offset_conv.bias": (18,), "bn.scale": (8,), "bn.bias": (8,),
              "box_head.cls_score.weight": (5, 16), "fc.weight": (16, 32)}
    wcfg = {"offset_bias_px": 2.0, "bn_scale": [0.3, 0.6], "cls_score_std": 0.3,
            "bbox_pred_std": 0.001}
    a = W.make_state(shapes, wcfg, BIG, "cpu")
    b = W.make_state(shapes, wcfg, BIG, "cpu")
    c = W.make_state(shapes, wcfg, BIG + 1, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in shapes)
    assert not torch.equal(a["a.conv.weight"], c["a.conv.weight"])
    assert not a["a.offset_conv.weight"].any() and not a["bn.bias"].any()
    assert a["a.offset_conv.bias"].abs().max() <= 2.0 and a["a.offset_conv.bias"].abs().max() > 1.0
    assert ((a["bn.scale"] >= 0.3) & (a["bn.scale"] <= 0.6)).all()
    assert abs(float(a["box_head.cls_score.weight"].std()) - 0.3) < 0.15


def test_same_sizes_gives_every_seed_the_same_work():
    """Two seeds give other training scenes but the same multiset of image
    sizes and instance counts."""
    mix = dict(tiny_train_mix(), pool=4)
    a = make_train_batches(mix, 4, 3, 8, BIG)[(64, 96)]
    b = make_train_batches(mix, 4, 3, 8, BIG + 1)[(64, 96)]

    def sizes(batches):
        hw = np.concatenate([x["im_hw"] for x in batches])
        counts = np.concatenate([x["gt_valid"].sum(1) for x in batches])
        return sorted(map(tuple, hw.tolist())), sorted(counts.tolist())

    assert sizes(a) == sizes(b)
    assert not all(np.array_equal(x["images"], y["images"]) for x, y in zip(a, b))
    hw, counts = sizes(a)
    lo, hi = mix["instances"]
    assert counts[0] == lo and counts[-1] == hi and len(set(hw)) > 1
