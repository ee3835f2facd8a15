"""Blocking reads on the port's predict and train paths as program spans
(``upsnet_torch/utils/profiling.py:host_sync``).

  * ``host_sync`` counts each entry per site with no profiler and then
    opens no ``record_function``; while a CPU profiler records, it opens one
    ``sync.<site>`` range per count, and none in the profiler's warm-up;
  * on a chain of k boxes, each suppressing the next, the ``nms_fixpoint``
    count equals the fixpoint iterations of a plain loop over the same
    suppression matrix;
  * one tiny ``predict_step`` and one tiny train step on the CPU: the
    ``read_syncs()`` delta equals the number of ``sync.*`` ranges in the
    trace, the same delta with the profiler off, and the outputs, losses and
    updated parameters are bit-identical with the profiler on and off;
  * on the card (marked ``card``, skipped here), the synchronising
    operations that ``torch.cuda.set_sync_debug_mode("warn")`` reports in
    one tiny request and one train step equal the ``read_syncs()`` delta.
    Run it there with
    ``python -m pytest tests/test_torch_sync_sites.py -q -m card --noconftest``
    (the tests' ``conftest.py`` imports JAX, which the port's CUDA machines
    need not have).

No JAX in this file.
"""

import copy
import dataclasses
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, schedule

from upsnet_torch.config import default_config
from upsnet_torch.data.synthetic import synthetic_batch
from upsnet_torch.evaluation.inference import bucket_anchors, predict_step
from upsnet_torch.models.upsnet import build_model
from upsnet_torch.ops.nms import nms_padded
from upsnet_torch.train.optimizer import make_optimizer
from upsnet_torch.train.step import make_train_step
from upsnet_torch.utils import profiling
from upsnet_torch.utils.profiling import host_sync, read_syncs, reset_syncs

torch.set_num_threads(2)

H, W = 64, 96
BSZ = 2
LOSS_KEYS = ("rpn_cls", "rpn_bbox", "cls", "bbox", "mask", "seg", "pano", "total")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here; this test runs on the card")
    return torch.device("cuda")


def _tiny():
    """The tiny widths of the predict and train tests, float32; every
    detection may enter panoptic fusion, so the mask removal and the
    instance channels run at random init."""
    cfg = default_config()
    return cfg.replace(
        network=dataclasses.replace(
            cfg.network, backbone="resnet_test", fpn_feature_dim=32, rcnn_fc_dim=64,
            fcn_head_dim=16, compute_dtype="float32", dcn_impl="auto",
            dcn_impl_train="pallas"),
        dataset=dataclasses.replace(cfg.dataset, num_classes=5, num_seg_classes=7, num_stuff=3),
        test=dataclasses.replace(cfg.test, rpn_pre_nms_top_n=64, rpn_post_nms_top_n=32,
                                 max_det=8, panoptic_score_thresh=0.0),
        train=dataclasses.replace(cfg.train, rpn_pre_nms_top_n=64, rpn_post_nms_top_n=32,
                                  batch_rois=16, rpn_batch_size=32, rpn_straddle_thresh=12.0,
                                  max_gt_instances=4),
    )


def _model(cfg, dev):
    """A seeded tiny model with +-2 px offset biases and frozen-BN scales
    below 1, so that activations stay O(1)."""
    model = build_model(cfg, device=dev, generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith("offset_conv.bias"):
                t.copy_(torch.rand(t.shape, generator=g) * 4 - 2)
            elif name.endswith(".scale") and t.dtype == torch.float32:
                t.copy_(torch.rand(t.shape, generator=g) * 0.3 + 0.3)
    return model


def _predict_batch(dev):
    g = torch.Generator().manual_seed(2)
    return {"images": (torch.rand((BSZ, H, W, 3), generator=g) * 20 - 10).to(dev),
            "im_hw": torch.tensor([[H, W], [H - 8, W - 16]], dtype=torch.float32).to(dev)}


def _train_batch(cfg, dev):
    batch = synthetic_batch(cfg, (H, W), BSZ, seed=3, image_hw=(H - 4, W - 8))
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def _recorded(fn):
    """``fn()`` under a CPU profiler: (its result, the host ``sync.*``
    ranges by name)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    names = [e.name for e in prof.events()
             if e.is_user_annotation and e.name.startswith(profiling.SYNC_PREFIX)]
    return out, names


def _delta(fn):
    """``fn()`` and the syncs it counted, per site."""
    reset_syncs()
    out = fn()
    return out, read_syncs()


def test_host_sync_counts_and_opens_no_range_without_a_profiler(monkeypatch):
    opened = []
    monkeypatch.setattr(profiling, "record_function", lambda name: opened.append(name))
    reset_syncs()
    for site in ("a", "b", "a"):
        with host_sync(site):
            torch.ones(4).sum()
    counts = read_syncs()
    assert counts == {"a": 2, "b": 1} and opened == []
    counts["a"] = 99  # a copy
    assert read_syncs() == {"a": 2, "b": 1}
    reset_syncs()
    assert read_syncs() == {}


def test_host_sync_opens_one_range_per_count_while_recording():
    reset_syncs()
    with profile(activities=[ProfilerActivity.CPU],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        with host_sync("warm"):  # the warm-up records nothing: counted, no range
            torch.ones(4).sum()
        prof.step()
        for site in ("x", "y", "x"):
            with host_sync(site):
                torch.ones(4).sum()
        prof.step()
    names = sorted(e.name for e in prof.events() if e.name.startswith(profiling.SYNC_PREFIX))
    assert names == ["sync.x", "sync.x", "sync.y"]
    assert read_syncs() == {"warm": 1, "x": 2, "y": 1}
    # each range encloses the read it marks
    inner = [e for e in prof.events() if e.name == "aten::sum"]
    assert len(inner) == 3 and all(e.cpu_parent.name.startswith("sync.") for e in inner)


def _plain_iterations(boxes: np.ndarray, thresh: float) -> int:
    """The fixpoint iterations of ``keep[j] = not any_i(keep[i] & sup[i, j])``
    from all-valid, counted as ``nms_padded`` checks them: one check per
    new iterate, the last one unchanged. Boxes in score order."""
    n = len(boxes)
    x1, y1, x2, y2 = boxes.T
    area = (x2 - x1 + 1) * (y2 - y1 + 1)
    iw = np.clip(np.minimum(x2[:, None], x2) - np.maximum(x1[:, None], x1) + 1, 0, None)
    ih = np.clip(np.minimum(y2[:, None], y2) - np.maximum(y1[:, None], y1) + 1, 0, None)
    inter = iw * ih
    iou = inter / (area[:, None] + area - inter)
    sup = (iou > thresh) & np.triu(np.ones((n, n), bool), 1)
    keep = ~np.any(np.ones(n, bool)[:, None] & sup, axis=0)
    checks = 0
    while True:
        nxt = ~np.any(keep[:, None] & sup, axis=0)
        checks += 1
        if np.array_equal(nxt, keep):
            return checks
        keep = nxt


@pytest.mark.parametrize("k", [1, 2, 3, 6, 11])
def test_nms_fixpoint_count_is_the_iteration_count(k):
    """Box i+1 overlaps box i by IoU 0.63 and box i+2 by 0.375: greedy NMS
    at 0.5 keeps every other box, and the fixpoint takes about k/2
    iterations to settle the chain."""
    boxes = np.array([[2.5 * i, 0.0, 2.5 * i + 10.0, 10.0] for i in range(k)], np.float32)
    scores = torch.linspace(1.0, 0.5, k)
    reset_syncs()
    idx, keep = nms_padded(torch.from_numpy(boxes), scores, 0.5, k)
    counts = read_syncs()
    assert counts["nms_fixpoint"] == _plain_iterations(boxes, 0.5)
    assert counts["const_h2d"] == 1
    assert idx[keep].tolist() == list(range(0, k, 2))


@pytest.fixture(scope="module")
def tiny():
    cfg = _tiny()
    dev = torch.device("cpu")
    model = _model(cfg, dev)
    return cfg, model, bucket_anchors(cfg, (H, W), dev), dev


def test_predict_syncs_match_ranges_and_outputs_do_not_move(tiny):
    cfg, model, anchors, dev = tiny
    batch = _predict_batch(dev)
    run = lambda: predict_step(model, cfg, anchors, batch)  # noqa: E731
    plain, counted = _delta(run)
    reset_syncs()
    traced, ranges = _recorded(run)
    assert read_syncs() == counted
    assert sum(counted.values()) == len(ranges)
    assert {n: ranges.count(n) for n in set(ranges)} == {
        profiling.SYNC_PREFIX + s: c for s, c in counted.items()}
    # the RPN and the detection NMS: one constant and >= 1 iteration each;
    # one constant per image in the argmax, and on the CPU two in each of
    # the ROIAlign plain version's two calls; one copy per output
    assert counted["const_h2d"] == 2 + BSZ + 2 * 2 and counted["nms_fixpoint"] >= 2
    assert counted["to_host"] == len(plain)
    assert plain.keys() == traced.keys()
    for k in plain:
        assert plain[k].dtype == traced[k].dtype and np.array_equal(plain[k], traced[k]), k


def test_train_step_syncs_match_ranges_and_the_step_does_not_move(tiny):
    cfg, model0, _, dev = tiny
    anchors = bucket_anchors(cfg, (H, W), dev)
    batch = _train_batch(cfg, dev)
    results = []
    for traced in (False, True):
        model = copy.deepcopy(model0)
        optimizer = make_optimizer(cfg, model)
        step = make_train_step(model, cfg, anchors, optimizer,
                               generator=torch.Generator().manual_seed(4))
        run = lambda: step(batch)  # noqa: E731
        reset_syncs()
        if traced:
            metrics, ranges = _recorded(run)
        else:
            metrics, ranges = run(), None
        params = {n: p.detach().clone() for n, p in model.named_parameters()}
        results.append((metrics, read_syncs(), ranges, params))
    (m0, c0, _, p0), (m1, c1, ranges, p1) = results
    assert c0 == c1 and sum(c1.values()) == len(ranges)
    # the proposals' NMS (a constant and >= 1 iteration), one constant per
    # image in the panoptic logits, the image count in the loss counts, the
    # mask targets' two sample-grid constants (and, on the CPU, the ROIAlign
    # plain versions')
    assert c1["const_h2d"] >= 1 + BSZ + 1 + 2 and c1["nms_fixpoint"] >= 1
    for k in LOSS_KEYS:
        assert torch.equal(m0[k], m1[k]), k
    for n in p0:
        assert torch.equal(p0[n], p1[n]), n


@pytest.mark.card
def test_sync_debug_warnings_equal_the_count(card):
    """Every synchronising operation of one tiny request and one train step
    on the card is inside a ``host_sync``: the warnings equal the count."""
    cfg = _tiny()
    model = _model(cfg, card)
    anchors = bucket_anchors(cfg, (H, W), card)
    predict_batch, train_batch = _predict_batch(card), _train_batch(cfg, card)
    step = make_train_step(model, cfg, anchors, make_optimizer(cfg, model),
                           generator=torch.Generator(device=card).manual_seed(4))
    for name, run in (("predict", lambda: predict_step(model, cfg, anchors, predict_batch)),
                      ("train", lambda: step(train_batch))):
        run()  # warm-up: the kernels' first calls and the allocator's first blocks
        torch.cuda.synchronize()
        reset_syncs()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                run()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        # the mode's own warning on its first use (a prototype) is no sync
        syncs = [w for w in caught if "called a synchronizing CUDA operation" in str(w.message)]
        where = sorted({f"{w.filename}:{w.lineno}" for w in syncs})
        assert len(syncs) == sum(read_syncs().values()), (name, read_syncs(), where)
