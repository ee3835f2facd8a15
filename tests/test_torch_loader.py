"""The port's loader (``data/pipeline.py``) and wire format
(``data/wire.py``) against the JAX package's.

``make_loader`` must yield the JAX ``make_loader``'s batches, the same arrays
in the same order, with 0 and with 2 workers over two epochs of the COCO set
of ``test_torch_datasets.py`` (both buckets); the batches must not depend on
the worker count; closing the iterator, or the prefetcher over it, must stop
its worker processes, and no worker may outlive the loader, also one slower
to exit than torch's join timeout. ``decode_batch(encode_batch(b))`` must give JAX
``decode_batch(encode_batch(b))`` bit for bit for the uint8 and bf16 image
wires and for float32 compute, masks and labels included; an unknown
``image_wire`` is refused; the prefetcher raises its thread's exception at
the consumer's ``next``.
"""

import multiprocessing as mp
import time

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from test_torch_datasets import sets  # noqa: F401  (the module fixture)
from upsnet_tpu.config import load_config as jax_load_config
from upsnet_tpu.data import wire as jwire
from upsnet_tpu.data.coco import COCOPanoptic as JaxCOCO
from upsnet_tpu.data.pipeline import make_loader as jax_make_loader
from upsnet_torch.config import load_config
from upsnet_torch.data import wire
from upsnet_torch.data.coco import COCOPanoptic
from upsnet_torch.data.pipeline import make_loader

torch.set_num_threads(2)


def _assert_batches_equal(got: list, ref: list):
    assert len(got) == len(ref) > 0
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.keys() == r.keys(), i
        for k in r:
            assert g[k].dtype == r[k].dtype, f"batch {i} {k}"
            np.testing.assert_array_equal(g[k], r[k], err_msg=f"batch {i} {k}")


@pytest.mark.parametrize("workers", [0, 2])
def test_make_loader_matches_jax(sets, workers):  # noqa: F811
    kw = dict(num_workers=workers, seed=5, epochs=2)
    got = list(make_loader(COCOPanoptic(load_config(sets["coco_yaml"])), 2, **kw))
    ref = list(jax_make_loader(JaxCOCO(jax_load_config(sets["coco_yaml"])), 2, **kw))
    _assert_batches_equal(got, ref)
    assert {b["images"].shape for b in got} == {(2, 128, 192, 3), (2, 192, 128, 3)}


@pytest.mark.parametrize("drop_last", [True, False])
def test_batches_do_not_depend_on_the_worker_count(sets, drop_last):  # noqa: F811
    ds = COCOPanoptic(load_config(sets["coco_yaml"]))
    kw = dict(seed=1, epochs=1, shuffle=False, drop_last=drop_last)
    ref = list(make_loader(ds, 2, num_workers=0, **kw))
    _assert_batches_equal(list(make_loader(ds, 2, num_workers=3, **kw)), ref)
    jref = list(jax_make_loader(JaxCOCO(jax_load_config(sets["coco_yaml"])), 2, **kw))
    _assert_batches_equal(ref, jref)


def _wait_for_no_children(timeout: float = 20.0) -> list:
    deadline = time.time() + timeout
    while mp.active_children() and time.time() < deadline:
        time.sleep(0.1)
    return mp.active_children()


@pytest.mark.parametrize("through", ["iterator", "prefetcher"])
def test_early_close_stops_the_workers(sets, through):  # noqa: F811
    ds = COCOPanoptic(load_config(sets["coco_yaml"]))
    assert not mp.active_children()
    it = iter(make_loader(ds, 2, num_workers=2, seed=1))  # an endless stream
    if through == "iterator":
        next(it)
        assert len(mp.active_children()) == 2
        it.close()
    else:
        pre = wire.DevicePrefetcher(it, "cpu", "float32", "uint8")
        next(pre)
        assert len(mp.active_children()) == 2
        pre.close()
        assert not pre._thread.is_alive()
    assert not _wait_for_no_children()


@pytest.mark.parametrize("how", ["end", "close"])
def test_workers_slow_to_exit_are_reaped(sets, monkeypatch, how):  # noqa: F811
    """torch joins each worker for ``MP_STATUS_CHECK_INTERVAL`` seconds and
    then terminates it without a join; with that interval at 0 every worker
    is slower to exit than it (as on a loaded host), and none may outlive the
    loader: not after the stream's end, not after an early close."""
    monkeypatch.setattr(torch.utils.data._utils, "MP_STATUS_CHECK_INTERVAL", 0.0)
    ds = COCOPanoptic(load_config(sets["coco_yaml"]))
    assert not _wait_for_no_children()
    if how == "end":
        got = list(make_loader(ds, 2, num_workers=3, seed=1, epochs=1, shuffle=False))
        assert got
    else:
        it = iter(make_loader(ds, 2, num_workers=3, seed=1))
        next(it)
        assert len(mp.active_children()) == 3
        it.close()
    assert not mp.active_children()


def _batch(rng) -> dict:
    """A batch of the keys a step reads, plus one it does not; images with
    values at bf16 rounding ties (even and odd) and beyond 0..255."""
    images = rng.uniform(-130.0, 150.0, (2, 8, 24, 3)).astype(np.float32)
    ties = np.array([0x3F808000, 0x3F818000, 0xC2F6C000, 0x43000080], np.uint32).view(np.float32)
    images.reshape(-1)[:4] = ties
    seg = rng.randint(0, 133, (2, 2, 6)).astype(np.int32)
    seg[0, 0] = 255
    return {"images": images,
            "im_hw": np.array([[8, 20], [6, 24]], np.float32),
            "gt_boxes": rng.uniform(0, 20, (2, 3, 4)).astype(np.float32),
            "gt_classes": rng.randint(1, 81, (2, 3)).astype(np.int32),
            "gt_valid": rng.rand(2, 3) > 0.3,
            "gt_masks": (rng.rand(2, 3, 2, 16) > 0.5).astype(np.uint8),
            "seg_gt": seg,
            "crowd_boxes": np.zeros((2, 8, 4), np.float32),
            "crowd_valid": np.zeros((2, 8), bool)}


def _as_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.view(torch.int16).numpy().view(ml_dtypes.bfloat16) \
            if v.dtype == torch.bfloat16 else v.numpy()
    return np.asarray(v)


@pytest.mark.parametrize("compute_dtype,image_wire", [
    ("bfloat16", "uint8"), ("bfloat16", "bf16"), ("float32", "bf16")])
def test_wire_round_trip_matches_jax(rng, compute_dtype, image_wire):
    batch = _batch(rng)
    enc = wire.encode_batch(batch, compute_dtype, image_wire)
    jenc = jwire.encode_batch(batch, compute_dtype, image_wire=image_wire)
    assert enc.keys() == jenc.keys() and "gt_masks_bits" in enc
    for k in jenc:  # the wire itself: the same bits
        got, ref = _as_numpy(enc[k]), np.asarray(jenc[k])
        assert got.dtype == ref.dtype, k
        np.testing.assert_array_equal(got.view(np.uint8), ref.view(np.uint8), err_msg=k)
    dec = wire.decode_batch(enc)
    jdec = jwire.decode_batch({k: jnp.asarray(v) for k, v in jenc.items()})
    assert dec.keys() == jdec.keys()
    for k in jdec:
        got, ref = _as_numpy(dec[k]), np.asarray(jdec[k])
        assert got.dtype == ref.dtype, k
        np.testing.assert_array_equal(got.view(np.uint8), ref.view(np.uint8), err_msg=k)
    np.testing.assert_array_equal(dec["gt_masks"].numpy(), batch["gt_masks"])
    np.testing.assert_array_equal(dec["seg_gt"].numpy(), batch["seg_gt"])


def test_odd_mask_width_goes_raw(rng):
    masks = (rng.rand(2, 3, 4, 13) > 0.5).astype(np.uint8)
    enc = wire.encode_batch({"gt_masks": masks})
    assert "gt_masks_bits" not in enc
    np.testing.assert_array_equal(wire.decode_batch(enc)["gt_masks"].numpy(), masks)


def test_unknown_image_wire_is_refused(rng):
    with pytest.raises(ValueError, match="image_wire='fp8'"):
        wire.encode_batch(_batch(rng), image_wire="fp8")
    with pytest.raises(ValueError, match="image_wire='float16'"):
        wire.DevicePrefetcher(iter([]), "cpu", image_wire="float16")


def test_prefetcher_hands_over_encoded_batches_and_raises_the_threads_error(rng):
    batches = [_batch(rng), _batch(rng)]

    def source():
        yield from batches
        raise OSError("disk gone")

    pre = wire.DevicePrefetcher(source(), "cpu", "bfloat16", "uint8")
    for b in batches:
        got = next(pre)
        ref = wire.encode_batch(b, "bfloat16", "uint8")
        assert got.keys() == ref.keys()
        for k in ref:
            assert torch.equal(got[k], ref[k]), k
    with pytest.raises(OSError, match="disk gone"):
        next(pre)
    pre.close()


def test_prefetcher_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        wire.DevicePrefetcher(iter([]), "cuda")
