"""Blocking reads and bytes read back on the port's TTA path
(``upsnet_torch/utils/profiling.py:host_sync``, ``read_bytes``).

  * ``host_sync(site, nbytes)`` adds ``nbytes`` to the site's total in
    ``read_bytes()``, counts the read as before, and ``reset_syncs`` clears
    both tables;
  * ``evaluation/tta.py:_fuse_device`` copies its six host arrays to the
    device and reads the panoptic map and the keep flags back, each a
    counted host sync (``const_h2d``, ``to_host``) beside ``panoptic_fuse``'s
    own, with the two reads' bytes counted; the outputs are those of
    ``panoptic_fuse`` called directly;
  * ``sample_predictor`` copies a sample's numpy image and its size to the
    device as two ``image_h2d`` syncs and reads every output back as
    ``to_host``, whose bytes are the outputs' bytes; given the same canvas
    as a tensor on the model's device in the compute dtype it copies only
    the size, with the same outputs;
  * ``predict_image_tta`` copies the frame once an image (one
    ``image_h2d``) and each variant's size (one more a variant), no canvas;
  * one tiny ``predict_image_tta`` runs its ``tta.sample``, ``tta.predict``,
    ``tta.merge`` and ``tta.fuse`` ranges under a CPU profiler, six
    ``tta.predict`` ranges for six variants, and every ``sync.<site>`` range
    of the trace is counted by ``read_syncs()``.
"""

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from portbench.drivers.tta import frames_dataset
from upsnet_torch.config import default_config
from upsnet_torch.config.loader import update_config
from upsnet_torch.evaluation import tta
from upsnet_torch.evaluation.inference import sample_predictor
from upsnet_torch.models import get_model
from upsnet_torch.models.upsnet import panoptic_fuse
from upsnet_torch.utils.profiling import host_sync, read_bytes, read_syncs, reset_syncs
from tests.test_torch_tta_reference import FRAME, tiny_model_cfg

torch.set_num_threads(2)


def test_host_sync_counts_bytes():
    reset_syncs()
    with host_sync("a", 12):
        pass
    with host_sync("a", 4):
        pass
    with host_sync("b"):
        pass
    assert read_syncs() == {"a": 2, "b": 1}
    assert read_bytes() == {"a": 16}
    reset_syncs()
    assert read_syncs() == {} and read_bytes() == {}


def _fusion_inputs(rng, d=6, hw=(16, 24), c=7, m=28):
    boxes = np.sort(rng.uniform(0, 90, (d, 2, 2)), axis=1).reshape(d, 4)[:, [0, 2, 1, 3]]
    return (rng.standard_normal(hw + (c,)).astype(np.float32), boxes.astype(np.float32),
            rng.integers(1, 5, d).astype(np.int32),
            rng.standard_normal((d, m, m)).astype(np.float32),
            rng.uniform(0.3, 1, d).astype(np.float32), np.arange(d) < 4)


def test_fuse_device_reads_are_counted():
    seg, boxes, classes, masks, scores, valid = _fusion_inputs(np.random.default_rng(5))
    kw = dict(score_thresh=0.6, overlap_thresh=0.5, num_stuff=3)
    reset_syncs()
    pan, keep = panoptic_fuse(*(torch.from_numpy(np.ascontiguousarray(a))[None] for a in (
        seg, boxes, classes.astype(np.int64), masks, scores, valid)), **kw)
    own = read_syncs()
    reset_syncs()
    got_pan, got_keep = tta._fuse_device(seg, boxes, classes, masks, scores, valid,
                                         device="cpu", **kw)
    counts, nbytes = read_syncs(), read_bytes()
    assert counts.pop("const_h2d") == own.pop("const_h2d", 0) + 6
    assert counts.pop("to_host") == 2
    assert counts == own
    assert nbytes == {"to_host": pan[0].nbytes + keep[0].nbytes}
    assert np.array_equal(got_pan, pan[0].numpy()) and np.array_equal(got_keep, keep[0].numpy())


def _tiny():
    conf = tiny_model_cfg()
    cfg = update_config(default_config(), conf["model"])
    torch.manual_seed(0)
    model = get_model(cfg.symbol, cfg, device="cpu")
    rng = np.random.default_rng(11)
    frame = rng.integers(0, 256, FRAME + (3,), dtype=np.uint8)
    return cfg, model, frames_dataset(cfg, [frame])


def test_sample_predictor_counts_its_copies_and_bytes():
    cfg, model, ds = _tiny()
    predict = sample_predictor(model, cfg)
    s = ds.sample(0)
    reset_syncs()
    out = predict(tuple(s["images"].shape[:2]), s, False)
    counts, nbytes = read_syncs(), read_bytes()
    assert counts["image_h2d"] == 2
    assert counts["to_host"] == len(out)
    assert nbytes == {"to_host": sum(v.nbytes for v in out.values())}
    assert out["seg_logits"].dtype == np.float32 and out["seg_logits"].ndim == 3


def test_sample_predictor_copies_no_canvas_already_on_the_device():
    cfg, model, ds = _tiny()
    predict = sample_predictor(model, cfg)
    s = ds.sample(0)
    want = predict(tuple(s["images"].shape[:2]), s, False)
    on_device = dict(s, images=torch.from_numpy(s["images"]).to(tta.image_dtype(cfg)))
    reset_syncs()
    out = predict(tuple(s["images"].shape[:2]), on_device, False)
    assert read_syncs()["image_h2d"] == 1  # im_hw alone
    assert set(out) == set(want)
    for k in out:
        np.testing.assert_array_equal(out[k], want[k], err_msg=k)


def test_predict_image_tta_copies_the_frame_once_and_no_canvas():
    cfg, model, ds = _tiny()
    predict = sample_predictor(model, cfg)
    reset_syncs()
    tta.predict_image_tta(cfg, ds, 0, lambda b, s: predict(b, s, False), "cpu")
    n = len(tta.tta_variants(cfg))
    assert n == 6 and read_syncs()["image_h2d"] == 1 + n
    assert read_syncs()["logits_h2d"] == n


def test_tta_ranges_and_sync_ranges_in_a_trace():
    cfg, model, ds = _tiny()
    predict = sample_predictor(model, cfg)
    reset_syncs()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tta.predict_image_tta(cfg, ds, 0, lambda b, s: predict(b, s, False), "cpu")
    names = [e.name for e in prof.events()]
    for stage, n in (("tta.sample", 6), ("tta.predict", 6), ("tta.merge", 7), ("tta.fuse", 1)):
        assert names.count(stage) == n, (stage, names.count(stage))
    syncs = [n for n in names if n.startswith("sync.")]
    assert len(syncs) == sum(read_syncs().values())
    assert {n[len("sync."):] for n in syncs} == set(read_syncs())
    assert read_bytes()["to_host"] > 6 * 4 * 7 * (FRAME[0] // 4) * (FRAME[1] // 4)
