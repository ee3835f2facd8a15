"""The TTA merge on the device (``upsnet_torch/ops/tta_merge.py``,
``csrc/tta_merge.cu``) against the host merge it replaced.

On the CPU (the plain versions):
  * ``merge_plain`` against the numpy and cv2 host merge (kept here as the
    oracle: crop, de-flip, ``cv2.resize`` ``INTER_LINEAR``, ``seg_sum +
    seg``, ``/ n``, ``argmax``), exactly: flipped and unflipped variants, the
    768 variant's smaller content, the bucket-crop stretch (a crop larger
    than the map), odd frame sizes, a downscale, and an exact 2x downscale
    (where cv2 switches to ``INTER_AREA``; matched);
  * ``resample_plain`` against cv2 and a zeroed canvas, exactly, at 4x, odd
    sizes, an upscale, the same size and the exact 2x;
  * the argmax takes the first maximum on constructed ties;
  * the wrappers send CPU tensors to the plain versions (no launch counted)
    and refuse what the kernels do not take;
  * ``fuse_tta`` gives the same result from numpy and from a CPU tensor;
  * ``predict_image_tta`` on a one-frame dataset and a stub predictor (six variants:
    the smaller content, the stretch, flips) calls ``merge`` once and
    ``resample`` once, hands the fusion the oracle's average and returns
    its argmax as ``seg_pred`` (int32), counting six ``logits_h2d`` copies
    and the argmax's read;
  * the same run tallies each variant's canvas, the content inside it and
    the resized content (``count_canvas``, ``read_canvas``), the crop
    included.

Tests marked ``card`` run the kernels on a CUDA card and skip here; this file
imports no JAX, so on the card they run with
``python -m pytest tests/test_torch_tta_merge.py -q -m card --noconftest``:
the merge against its plain version at the Cityscapes TTA cell's shapes (six
19-channel maps, contents 256x512 and 192x384, into 1024x2048, flipped and
not), the resample at the cell's 4x and at an exact 2x, and one launch of
each per ``predict_image_tta`` image; and both at the COCO TTA cell's shapes
(six 208x336 maps of 133 channels, the 68,096 bytes of staged outputs a
block that take the shared-memory opt-in, crops 200x266, 160x213 and
240x320, the last clamped to the map's 208 rows, into 480x640; then the
fusion's resample to 200x266 on 208x336).
"""

import dataclasses

import cv2
import numpy as np
import pytest
import torch

from upsnet_torch.config import default_config
from upsnet_torch.data import transforms as T
from upsnet_torch.data.base import BaseDataset
from upsnet_torch.evaluation import tta
from upsnet_torch.ops import tta_merge
from upsnet_torch.utils import profiling
from upsnet_torch.utils.profiling import read_bytes, read_canvas, read_syncs, reset_syncs

torch.set_num_threads(2)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here; this test runs on the card")
    return torch.device("cuda")


def host_merge(maps, crops, flips, size):
    """The host merge that ``ops/tta_merge.py`` replaced (numpy and cv2)."""
    oh, ow = size
    seg_sum = None
    for m, (ch, cw), fl in zip(maps, crops, flips):
        seg = m[:ch, :cw]
        if fl:
            seg = seg[:, ::-1]
        seg = cv2.resize(seg, (ow, oh), interpolation=cv2.INTER_LINEAR)
        seg_sum = seg if seg_sum is None else seg_sum + seg
    avg = seg_sum / len(maps)
    return avg, avg.argmax(-1)


def host_resample(avg, content, canvas):
    """``fuse_tta``'s host resample to the quarter-scale canvas (cv2)."""
    ch, cw = content
    out = np.zeros(tuple(canvas) + avg.shape[2:], np.float32)
    out[:ch, :cw] = cv2.resize(avg, (cw, ch), interpolation=cv2.INTER_LINEAR)
    return out


def _maps(rng, shapes, c):
    return [(rng.standard_normal(tuple(s) + (c,)) * 4).astype(np.float32) for s in shapes]


# (map shapes, crops, flips, frame, channels)
MERGE_CASES = {
    # the cell's six variants at a quarter of their size: 1024 (content = map),
    # 768 (smaller content), 1280 capped to the canvas; each unflipped, flipped
    "cell_quarter": ([(64, 128)] * 6, [(64, 128), (64, 128), (48, 96), (48, 96), (64, 128),
                                       (64, 128)], [False, True] * 3, (256, 512), 19),
    # the bucket crop: im_hw beyond the canvas, the crop takes the whole map
    "stretch": ([(16, 32), (16, 32), (16, 32)], [(20, 40), (16, 32), (25, 33)],
                [False, True, True], (64, 128), 7),
    "odd": ([(13, 17), (11, 19)], [(13, 17), (9, 14)], [True, False], (37, 53), 19),
    "downscale": ([(40, 60)] * 2, [(40, 60), (33, 47)], [False, True], (17, 23), 5),
    # exactly twice the frame on both axes: cv2 resizes by INTER_AREA
    "exact_2x": ([(40, 50), (40, 50)], [(40, 50), (40, 50)], [False, True], (20, 25), 19),
    "one_variant": ([(8, 8)], [(8, 8)], [True], (31, 30), 2),
}


@pytest.mark.parametrize("case", sorted(MERGE_CASES))
def test_merge_plain_equals_the_host_merge(case):
    shapes, crops, flips, size, c = MERGE_CASES[case]
    maps = _maps(np.random.default_rng(3), shapes, c)
    want_avg, want_arg = host_merge(maps, crops, flips, size)
    avg, arg = tta_merge.merge([torch.from_numpy(m) for m in maps], crops, flips, size)
    assert avg.dtype == torch.float32 and arg.dtype == torch.uint8
    np.testing.assert_array_equal(avg.numpy(), want_avg)
    np.testing.assert_array_equal(arg.numpy(), want_arg)


# (source, content, canvas, channels)
RESAMPLE_CASES = {
    "cell_quarter_4x": ((256, 512), (64, 128), (64, 128), 19),
    "odd": ((37, 53), (11, 16), (13, 20), 19),
    "upscale": ((9, 11), (20, 27), (24, 28), 7),
    "same_size": ((16, 24), (16, 24), (16, 24), 5),
    "exact_2x": ((40, 60), (20, 30), (24, 32), 19),
}


@pytest.mark.parametrize("case", sorted(RESAMPLE_CASES))
def test_resample_plain_equals_cv2_on_a_zeroed_canvas(case):
    src, content, canvas, c = RESAMPLE_CASES[case]
    avg = _maps(np.random.default_rng(4), [src], c)[0]
    got = tta_merge.resample(torch.from_numpy(avg), content, canvas)
    np.testing.assert_array_equal(got.numpy(), host_resample(avg, content, canvas))


def test_argmax_takes_the_first_maximum_on_ties():
    rng = np.random.default_rng(5)
    maps = _maps(rng, [(12, 20), (12, 20)], 9)
    for m in maps:  # channels 3 and 6 equal and above every other channel
        m[..., 3] = m[..., 6] = 50 + rng.standard_normal(m.shape[:2]).astype(np.float32)
        m[:4, :, 1] = m[:4, :, 3]  # and in the first rows channel 1 too
    avg, arg = tta_merge.merge([torch.from_numpy(m) for m in maps], [(12, 20)] * 2,
                               [False, True], (25, 41))
    avg, arg = avg.numpy(), arg.numpy()
    assert np.array_equal(avg[..., 3], avg[..., 6])
    three_way = avg[..., 1] == avg[..., 3]
    assert three_way[0].all() and not three_way[-1].any()
    np.testing.assert_array_equal(arg, np.where(three_way, 1, 3))
    np.testing.assert_array_equal(arg, host_merge(maps, [(12, 20)] * 2, [False, True],
                                                  (25, 41))[1])


def test_wrappers_take_cpu_tensors_to_the_plain_versions_and_refuse_the_rest():
    m = torch.zeros((4, 6, 3))
    before = (tta_merge.launches, tta_merge.launches_resample)
    tta_merge.merge([m], [(4, 6)], [False], (8, 12))
    tta_merge.resample(m, (2, 3), (4, 4))
    assert (tta_merge.launches, tta_merge.launches_resample) == before
    with pytest.raises(ValueError, match="C="):
        tta_merge.merge([torch.zeros((2, 2, 257))], [(2, 2)], [False], (4, 4))
    with pytest.raises(ValueError, match="maps must be"):
        tta_merge.merge([m, torch.zeros((4, 6, 5))], [(4, 6)] * 2, [False] * 2, (4, 4))
    with pytest.raises(ValueError, match="1 to 8 maps"):
        tta_merge.merge([m] * 9, [(4, 6)] * 9, [False] * 9, (4, 4))
    with pytest.raises(TypeError, match="float32"):
        tta_merge.merge([m.double()], [(4, 6)], [False], (4, 4))
    with pytest.raises(ValueError, match="in the canvas"):
        tta_merge.resample(m, (5, 3), (4, 4))
    with pytest.raises(ValueError, match="unsupported device"):
        tta_merge.merge([m.to("meta")], [(4, 6)], [False], (4, 4))


def _cfg(max_det: int = 8):
    cfg = default_config()
    return cfg.replace(
        dataset=dataclasses.replace(cfg.dataset, num_stuff=3, num_classes=5, num_seg_classes=7),
        test=dataclasses.replace(cfg.test, scales=(64,), multi_scale=(48, 64, 80),
                                 flip_test=True, max_det=max_det, image_buckets=((64, 128),)))


def _detections(rng, n: int, hw, max_det: int, m: int = 28):
    x1 = rng.uniform(0, hw[1] - 20, max_det)
    y1 = rng.uniform(0, hw[0] - 20, max_det)
    boxes = np.stack([x1, y1, x1 + rng.uniform(4, 20, max_det), y1 + rng.uniform(4, 20, max_det)],
                     -1).astype(np.float32)
    return {"boxes": boxes, "scores": np.sort(rng.uniform(0.3, 1, max_det))[::-1].copy()
            .astype(np.float32), "classes": rng.integers(1, 5, max_det).astype(np.int32),
            "mask_logits": (rng.standard_normal((max_det, m, m)) * 3).astype(np.float32),
            "det_valid": np.arange(max_det) < n}


def test_fuse_tta_takes_numpy_and_a_cpu_tensor_alike():
    rng = np.random.default_rng(6)
    cfg = _cfg()
    seg_avg = rng.standard_normal((150, 190, 7)).astype(np.float32)
    d = _detections(rng, 6, (150, 190), 6)
    args = (d["boxes"], d["scores"], d["classes"], d["mask_logits"], 64 / 150, (64, 128),
            (64, 81))
    got_np = tta.fuse_tta(cfg, seg_avg, *args, device="cpu")
    got_t = tta.fuse_tta(cfg, torch.from_numpy(seg_avg), *args, device="cpu")
    np.testing.assert_array_equal(got_np[0], got_t[0])
    np.testing.assert_array_equal(got_np[1], got_t[1])
    for a, b in zip(got_np[2], got_t[2]):
        np.testing.assert_array_equal(a, b)
    assert got_np[1].any()


class _Frames(BaseDataset):
    """A dataset of one 64x128 frame held in memory: each variant's canvas is
    the one 64x128 bucket; the 1.25 variant's content (80x160) outgrows it
    (the bucket crop)."""
    orig_hw = (64, 128)

    def __init__(self, cfg):
        super().__init__(cfg, training=False)
        self.frame = np.random.default_rng(12).integers(0, 256, self.orig_hw + (3,), np.uint8)

    def __len__(self):
        return 1

    def load_image(self, i):
        return self.frame

    def image_id(self, i):
        return 100 + i


def _run_tta(device, monkeypatch):
    """``predict_image_tta`` of one stub image: (result, the variants'
    logits, the merged average handed to the fusion, calls of each entry)."""
    cfg = _cfg()
    rng = np.random.default_rng(7)
    logits, merged, calls = [], {}, {"merge": 0, "resample": 0}

    def predict(bucket, s):
        out = _detections(rng, 5, bucket, cfg.test.max_det)
        out["seg_logits"] = (rng.standard_normal((16, 32, 7)) * 4).astype(np.float32)
        logits.append(out["seg_logits"])
        return out

    def spy(name):
        orig = getattr(tta_merge, name)

        def wrapped(*a, **kw):
            calls[name] += 1
            return orig(*a, **kw)
        monkeypatch.setattr(tta_merge, name, wrapped)

    spy("merge")
    spy("resample")
    fuse = tta.fuse_tta

    def keep(cfg_, seg_avg, *a, **kw):
        merged["seg_avg"] = seg_avg
        return fuse(cfg_, seg_avg, *a, **kw)
    monkeypatch.setattr(tta, "fuse_tta", keep)
    reset_syncs()
    result = tta.predict_image_tta(cfg, _Frames(cfg), 0, predict, device)
    return result, logits, merged["seg_avg"], calls


def test_predict_image_tta_merges_once_on_the_device(monkeypatch):
    result, logits, seg_avg, calls = _run_tta("cpu", monkeypatch)
    assert calls == {"merge": 1, "resample": 1}
    assert len(logits) == 6
    # contents: 16x32 (64), 12x24 (48), 20x40 (80: beyond the 16x32 map)
    crops = [(16, 32)] * 2 + [(12, 24)] * 2 + [(20, 40)] * 2
    want_avg, want_arg = host_merge(logits, crops, [False, True] * 3, _Frames.orig_hw)
    assert torch.is_tensor(seg_avg)
    np.testing.assert_array_equal(seg_avg.numpy(), want_avg)
    assert result["seg_pred"].dtype == np.int32
    np.testing.assert_array_equal(result["seg_pred"], want_arg)
    syncs = read_syncs()
    assert syncs["logits_h2d"] == 6
    assert read_bytes()["to_host"] >= result["seg_pred"].size  # the uint8 argmax, and more
    for k in ("pan_map", "boxes", "scores", "classes", "mask_logits", "pan_keep"):
        assert isinstance(result[k], np.ndarray), k


def test_predict_image_tta_tallies_each_variants_canvas(monkeypatch):
    tallied = []

    def spy(bucket, content):
        tallied.append((tuple(bucket), tuple(content)))
        profiling.count_canvas(bucket, content)
    monkeypatch.setattr(tta, "count_canvas", spy)
    _run_tta("cpu", monkeypatch)  # resets the tallies first
    cfg = _cfg()
    want = [T.variant_geometry(*_Frames.orig_hw, t, cfg.test.max_size, cfg.test.image_buckets)
            for t, _ in tta.tta_variants(cfg)]
    assert tallied == [(b, c) for _, c, b in want]
    # 64x128, 48x96 and 80x160 (cropped to 64x128), each twice, on 64x128
    assert [c for _, c in tallied[::2]] == [(64, 128), (48, 96), (80, 160)]
    assert read_canvas() == {"canvas": 6 * 64 * 128,
                             "inside": 2 * (64 * 128 + 48 * 96 + 64 * 128),
                             "resized": 2 * (64 * 128 + 48 * 96 + 80 * 160)}
    reset_syncs()
    assert read_canvas() == {"canvas": 0, "inside": 0, "resized": 0}


@pytest.mark.card
def test_merge_kernel_equals_its_plain_version_at_the_cell_shapes(card):
    g = torch.Generator().manual_seed(8)
    crops = [(256, 512), (256, 512), (192, 384), (192, 384), (256, 512), (256, 512)]
    maps = [torch.randn((256, 512, 19), generator=g) * 4 for _ in crops]
    flips = [False, True] * 3
    want_avg, want_arg = tta_merge.merge_plain(maps, crops, flips, (1024, 2048))
    before = tta_merge.launches
    avg, arg = tta_merge.merge([m.to(card) for m in maps], crops, flips, (1024, 2048))
    torch.cuda.synchronize()
    assert tta_merge.launches == before + 1
    assert torch.equal(avg.cpu(), want_avg) and torch.equal(arg.cpu(), want_arg)
    # the 768 variant on a map of its own content's size, and a stretch
    maps[2], maps[3] = maps[2][:192, :384].contiguous(), maps[3][:160, :300].contiguous()
    want = tta_merge.merge_plain(maps, crops, flips, (1024, 2048))
    got = tta_merge.merge([m.to(card) for m in maps], crops, flips, (1024, 2048))
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])


@pytest.mark.card
@pytest.mark.parametrize("src,content,canvas", [((1024, 2048), (256, 512), (256, 512)),
                                                ((400, 600), (200, 300), (256, 320))])
def test_resample_kernel_equals_its_plain_version(card, src, content, canvas):
    avg = torch.randn(src + (19,), generator=torch.Generator().manual_seed(9))
    want = tta_merge.resample_plain(avg, content, canvas)
    before = tta_merge.launches_resample
    got = tta_merge.resample(avg.to(card), content, canvas)
    torch.cuda.synchronize()
    assert tta_merge.launches_resample == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.card
def test_predict_image_tta_launches_each_kernel_once_an_image(card, monkeypatch):
    before = (tta_merge.launches, tta_merge.launches_resample)
    result, logits, seg_avg, _ = _run_tta(card, monkeypatch)
    assert (tta_merge.launches, tta_merge.launches_resample) == (before[0] + 1, before[1] + 1)
    crops = [(16, 32)] * 2 + [(12, 24)] * 2 + [(20, 40)] * 2
    want_avg, want_arg = host_merge(logits, crops, [False, True] * 3, _Frames.orig_hw)
    assert seg_avg.device.type == "cuda"
    np.testing.assert_array_equal(seg_avg.cpu().numpy(), want_avg)
    np.testing.assert_array_equal(result["seg_pred"], want_arg)


@pytest.mark.card
def test_merge_and_resample_kernels_at_the_coco_cell_shapes(card):
    g = torch.Generator().manual_seed(10)
    # 800, 640 and 960 of a 640x480 frame; 960's 240 rows beyond the map
    crops = [(200, 266), (200, 266), (160, 213), (160, 213), (240, 320), (240, 320)]
    maps = [torch.randn((208, 336, 133), generator=g) * 4 for _ in crops]
    flips = [False, True] * 3
    want_avg, want_arg = tta_merge.merge_plain(maps, crops, flips, (480, 640))
    before = (tta_merge.launches, tta_merge.launches_resample)
    avg, arg = tta_merge.merge([m.to(card) for m in maps], crops, flips, (480, 640))
    canvas = tta_merge.resample(avg, (200, 266), (208, 336))
    torch.cuda.synchronize()
    assert (tta_merge.launches, tta_merge.launches_resample) == (before[0] + 1, before[1] + 1)
    assert torch.equal(avg.cpu(), want_avg) and torch.equal(arg.cpu(), want_arg)
    assert torch.equal(canvas.cpu(), tta_merge.resample_plain(want_avg, (200, 266), (208, 336)))
