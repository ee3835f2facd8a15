"""TTA's input canvases on the device (``upsnet_torch/ops/tta_merge.py:
sample_canvas``, ``csrc/tta_merge.cu:tta_sample_kernel``) against the host
sample they replace (``BaseDataset.sample(i, target_scale=, hflip=)``, cast
to the compute dtype as ``sample_predictor`` casts a numpy canvas).

On the CPU (the plain version):
  * at unit scale and at an exact 2x downscale (where cv2 switches to
    ``INTER_AREA``), flipped and not, and where the content outgrows the
    bucket (the canvas holds its top-left), ``sample_canvas_plain`` gives
    the host canvas bit for bit, in bfloat16 and in float32;
  * at 0.75 and at an uneven scale it lies within 0.02 of cv2's float32
    canvas (cv2 takes a vectorised path of its own for 3 channels);
  * the wrapper sends CPU tensors to the plain version, counting no launch,
    and refuses a frame of another dtype, shape, layout or device and a
    canvas dtype other than bfloat16 and float32;
  * ``transforms.variant_geometry`` gives ``_build_sample``'s scale,
    content and bucket at the Cityscapes TTA cell's three scales and where
    the content outgrows every bucket.

Tests marked ``card`` run the kernel on a CUDA card and skip here; this file
imports no JAX, so on the card they run with
``python -m pytest tests/test_torch_tta_sample.py -q -m card --noconftest``:
the kernel against its plain version at the cell's shapes (a 1024x2048
frame at scales 1.0 and 0.75, flipped and not, bfloat16 and float32) and at
the COCO TTA cell's crop (a 480x640 frame at 960x1280, cropped to 832x1344),
and ``predict_image_tta`` launching it once a variant, its unit-scale
canvases the host's.
"""

import dataclasses

import numpy as np
import pytest
import torch

from upsnet_torch.config import default_config
from upsnet_torch.data import transforms as T
from upsnet_torch.data.base import BaseDataset
from upsnet_torch.evaluation import tta
from upsnet_torch.ops import tta_merge

torch.set_num_threads(2)

CELL_FRAME = (1024, 2048)
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here; this test runs on the card")
    return torch.device("cuda")


class _Frame(BaseDataset):
    """A test-time dataset of one random uint8 BGR frame held in memory."""

    def __init__(self, cfg, hw, seed=0):
        super().__init__(cfg, training=False)
        self.frame = np.random.default_rng(seed).integers(0, 256, tuple(hw) + (3,), np.uint8)

    def __len__(self):
        return 1

    def load_image(self, i):
        return self.frame


def _dataset(hw, buckets, max_size, dtype="bf16", seed=0):
    cfg = default_config()
    cfg = cfg.replace(
        network=dataclasses.replace(cfg.network, compute_dtype=
                                    "bfloat16" if dtype == "bf16" else "float32"),
        test=dataclasses.replace(cfg.test, scales=(hw[0],), max_size=max_size,
                                 image_buckets=tuple(buckets)))
    return _Frame(cfg, hw, seed)


def _host_and_plain(ds, target, flip, dtype):
    """(the host sample, its canvas cast to ``dtype``, the plain version's
    canvas from the same frame and geometry)."""
    s = ds.sample(0, target_scale=target, hflip=flip)
    rh, rw = (int(v) for v in s["im_hw"])
    got = tta_merge.sample_canvas(torch.from_numpy(ds.frame), (rh, rw), s["images"].shape[:2],
                                  flip, dtype)
    return s, torch.from_numpy(s["images"]).to(dtype), got


# (frame, buckets, max_size, target): each gives its content by the host's rule
EXACT_CASES = {
    "unit": ((64, 128), ((64, 128),), 256, 64),
    # cv2 averages 2x2 blocks where the source is exactly twice the content
    "exact_2x": ((64, 128), ((64, 128),), 256, 32),
    # unit scale, the content 64x128 beyond the one 48x96 bucket: cropped
    "bucket_crop": ((64, 128), ((48, 96),), 256, 64),
    # odd sizes at exact 2x, the content beyond the bucket on one axis
    "exact_2x_crop": ((54, 90), ((24, 64),), 256, 27),
}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("flip", [False, True], ids=["unflipped", "flipped"])
@pytest.mark.parametrize("case", sorted(EXACT_CASES))
def test_sample_canvas_plain_is_the_host_canvas(case, flip, dtype):
    hw, buckets, max_size, target = EXACT_CASES[case]
    ds = _dataset(hw, buckets, max_size, dtype)
    s, want, got = _host_and_plain(ds, target, flip, DTYPES[dtype])
    assert got.dtype == DTYPES[dtype] and got.shape == want.shape
    assert torch.equal(got, want), int((got != want).sum())
    if case.endswith("crop"):
        rh, rw = (int(v) for v in s["im_hw"])
        assert rh > got.shape[0] or rw > got.shape[1]
    else:
        assert got[int(s["im_hw"][0]):].abs().sum() == 0  # zeros below the content


# (frame, target): 0.75 as in the cell, and an uneven 45/64
NEAR_CASES = {"three_quarters": ((96, 192), 72), "uneven": ((64, 128), 45)}
NEAR_ABS = 0.02  # cv2's vectorised 3-channel path against the rule: 0.0106 measured


@pytest.mark.parametrize("flip", [False, True], ids=["unflipped", "flipped"])
@pytest.mark.parametrize("case", sorted(NEAR_CASES))
def test_sample_canvas_plain_is_near_cv2_at_other_scales(case, flip):
    hw, target = NEAR_CASES[case]
    ds = _dataset(hw, (tuple(hw),), 4 * hw[1], "f32", seed=1)
    s, want, got = _host_and_plain(ds, target, flip, torch.float32)
    assert float(s["scale"]) not in (1.0, 0.5)
    err = float((got - want).abs().max())
    bf16_share = float((got.to(torch.bfloat16) != want.to(torch.bfloat16)).float().mean())
    assert 0 < err <= NEAR_ABS, f"max abs {err}; {100 * bf16_share:.2f}% of bf16 values differ"


REFUSED = {
    "frame_dtype": (lambda f: f.float(), torch.bfloat16, TypeError, "uint8"),
    "frame_rank": (lambda f: f[..., 0], torch.bfloat16, ValueError, r"\(H, W, 3\)"),
    "frame_channels": (lambda f: torch.cat([f, f[..., :1]], -1), torch.bfloat16, ValueError,
                       r"\(H, W, 3\)"),
    "frame_layout": (lambda f: f.transpose(0, 1), torch.bfloat16, ValueError, "contiguous"),
    "canvas_dtype": (lambda f: f, torch.float16, TypeError, "bfloat16 or float32"),
    "frame_device": (lambda f: f.to("meta"), torch.bfloat16, ValueError, "unsupported device"),
}


@pytest.mark.parametrize("case", ["cpu_route"] + sorted(REFUSED))
def test_sample_canvas_wrapper_routes_and_refuses(case):
    frame = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (8, 12, 3), np.uint8))
    before = tta_merge.launches_sample
    if case == "cpu_route":
        got = tta_merge.sample_canvas(frame, (6, 9), (8, 16), True, torch.bfloat16)
        want = tta_merge.sample_canvas_plain(frame, (6, 9), (8, 16), True, torch.bfloat16)
        assert torch.equal(got, want) and got.shape == (8, 16, 3)
    else:
        make, dtype, err, match = REFUSED[case]
        with pytest.raises(err, match=match):
            tta_merge.sample_canvas(make(frame), (6, 9), (8, 16), False, dtype)
    assert tta_merge.launches_sample == before


COCO_BUCKETS = ((832, 1344), (1344, 832))
# (frame, buckets, max_size, target): the cell's three scales (1280 capped by
# max_size to unit scale), and a 480x640 image at 960 beyond both COCO buckets
GEOMETRY_CASES = {
    "cell_1024": (CELL_FRAME, (CELL_FRAME,), 2048, 1024),
    "cell_768": (CELL_FRAME, (CELL_FRAME,), 2048, 768),
    "cell_1280": (CELL_FRAME, (CELL_FRAME,), 2048, 1280),
    "coco_crop": ((480, 640), COCO_BUCKETS, 1333, 960),
}


@pytest.mark.parametrize("case", sorted(GEOMETRY_CASES))
def test_variant_geometry_is_build_samples(case):
    hw, buckets, max_size, target = GEOMETRY_CASES[case]
    ds = _dataset(hw, buckets, max_size)
    s = ds.sample(0, target_scale=target)
    scale, content, bucket = T.variant_geometry(*hw, target, max_size, buckets)
    assert np.float32(scale) == s["scale"]
    assert content == tuple(int(v) for v in s["im_hw"])
    assert bucket == s["images"].shape[:2]
    if case == "coco_crop":
        assert content == (960, 1280) and bucket == (832, 1344)


@pytest.mark.card
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("flip", [False, True], ids=["unflipped", "flipped"])
@pytest.mark.parametrize("target", [1024, 768])
def test_sample_kernel_equals_its_plain_version_at_the_cell_shapes(card, target, flip, dtype):
    frame = torch.from_numpy(np.random.default_rng(target).integers(0, 256, CELL_FRAME + (3,),
                                                                    np.uint8))
    _, content, bucket = T.variant_geometry(*CELL_FRAME, target, 2048, (CELL_FRAME,))
    want = tta_merge.sample_canvas_plain(frame, content, bucket, flip, DTYPES[dtype])
    before = tta_merge.launches_sample
    got = tta_merge.sample_canvas(frame.to(card), content, bucket, flip, DTYPES[dtype])
    torch.cuda.synchronize()
    assert tta_merge.launches_sample == before + 1
    assert torch.equal(got.cpu(), want), int((got.cpu() != want).sum())


@pytest.mark.card
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("flip", [False, True], ids=["unflipped", "flipped"])
def test_sample_kernel_equals_its_plain_version_at_the_coco_crop(card, flip, dtype):
    """The COCO TTA cell's 960 variant: a 480x640 frame at 960x1280, its rows
    cropped to the 832x1344 canvas."""
    hw, buckets, max_size, target = GEOMETRY_CASES["coco_crop"]
    frame = torch.from_numpy(np.random.default_rng(960).integers(0, 256, hw + (3,), np.uint8))
    _, content, bucket = T.variant_geometry(*hw, target, max_size, buckets)
    assert (content, bucket) == ((960, 1280), (832, 1344))
    want = tta_merge.sample_canvas_plain(frame, content, bucket, flip, DTYPES[dtype])
    before = tta_merge.launches_sample
    got = tta_merge.sample_canvas(frame.to(card), content, bucket, flip, DTYPES[dtype])
    torch.cuda.synchronize()
    assert tta_merge.launches_sample == before + 1
    assert torch.equal(got.cpu(), want), int((got.cpu() != want).sum())


@pytest.mark.card
def test_predict_image_tta_launches_the_sample_once_a_variant(card):
    cfg = default_config()
    cfg = cfg.replace(
        dataset=dataclasses.replace(cfg.dataset, num_stuff=3, num_classes=5, num_seg_classes=7),
        test=dataclasses.replace(cfg.test, scales=(64,), multi_scale=(48, 64, 80),
                                 flip_test=True, max_det=4, image_buckets=((64, 128),)))
    ds = _Frame(cfg, (64, 128), seed=3)
    rng = np.random.default_rng(7)
    seen = []

    def predict(bucket, s):
        """Four detections and 7-channel logits at quarter scale."""
        seen.append((s["images"], float(s["scale"]), s["im_hw"].copy()))
        x1 = rng.uniform(0, 100, 4)
        y1 = rng.uniform(0, 40, 4)
        boxes = np.stack([x1, y1, x1 + 20, y1 + 16], -1).astype(np.float32)
        return {"boxes": boxes, "scores": np.float32([0.9, 0.8, 0.7, 0.6]),
                "classes": np.int32([1, 2, 3, 4]), "det_valid": np.ones(4, bool),
                "mask_logits": rng.standard_normal((4, 28, 28)).astype(np.float32),
                "seg_logits": rng.standard_normal((16, 32, 7)).astype(np.float32)}

    before = tta_merge.launches_sample
    tta.predict_image_tta(cfg, ds, 0, predict, card)
    assert tta_merge.launches_sample == before + len(tta.tta_variants(cfg)) == before + 6
    unit = 0
    for (canvas, scale, im_hw), (target, flip) in zip(seen, tta.tta_variants(cfg), strict=True):
        host = ds.sample(0, target_scale=target, hflip=flip)
        assert canvas.device.type == "cuda" and canvas.dtype == tta.image_dtype(cfg)
        assert scale == host["scale"] and np.array_equal(im_hw, host["im_hw"])
        if scale == 1.0:
            unit += 1
            want = torch.from_numpy(host["images"]).to(canvas.dtype)
            assert torch.equal(canvas.cpu(), want)
    assert unit == 2
