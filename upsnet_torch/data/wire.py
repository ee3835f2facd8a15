"""Compact host-to-device wire format for batches, and the device prefetch.

The port of ``upsnet_tpu/data/wire.py``. ``encode_batch`` turns a numpy batch
into CPU tensors that carry information, not padding; ``decode_batch``
undoes it with torch ops on the device, inside the train loop:

  images    f32 -> uint8   (``image_wire: uint8``) ``clip(rint(img +
                           PIXEL_MEANS_BGR))``, the resized image as 8-bit
                           pixels; decode is the f32 image minus the mean.
                           Lossy by design, exactly as the JAX package is:
                           the bilinear resize's fractions round, and the
                           bucket padding decodes about 0.02 off zero.
  images    f32 -> bf16    (``image_wire: bf16`` with bf16 compute) torch's
                           round-to-nearest-even cast, the bits of
                           ``ml_dtypes``; the model's stem casts to bf16 first
                           anyway. Float32-compute configs send float32.
  gt_masks  {0,1} -> bits  ``np.packbits`` along W (most significant bit
                           first), 8x smaller, exact; a width that is not a
                           multiple of 8 goes raw.
  seg_gt    int32 -> uint8 exact: labels below 254, ignore 255.

``DevicePrefetcher`` runs the loader, the encoding and the copy to the card
on a background thread, ``depth`` batches ahead: pinned host memory, copies
on a side stream, and an event per batch that the consumer's stream waits
for before it reads the batch.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from upsnet_torch.data.transforms import PIXEL_MEANS_BGR

# keys a training step consumes; everything else (image_id, orig_hw, ...)
# is host-side bookkeeping and never crosses the wire
STEP_KEYS = (
    "images", "im_hw", "gt_boxes", "gt_classes", "gt_valid", "gt_masks",
    "gt_masks_bits", "seg_gt", "crowd_boxes", "crowd_valid",
)
IMAGE_WIRES = ("bf16", "uint8")


def encode_batch(batch: dict, compute_dtype: str = "bfloat16",
                 image_wire: str = "bf16") -> dict:
    """Numpy batch -> wire batch of CPU tensors (see the module docstring).
    An ``image_wire`` other than 'bf16' or 'uint8' is refused."""
    if image_wire not in IMAGE_WIRES:
        raise ValueError(f"train.image_wire={image_wire!r}: expected one of {IMAGE_WIRES}")
    out = {k: np.asarray(v) for k, v in batch.items()}
    imgs = out.get("images")
    if imgs is not None and imgs.dtype == np.float32:
        if image_wire == "uint8":
            out["images"] = np.clip(np.rint(imgs + PIXEL_MEANS_BGR), 0, 255).astype(np.uint8)
        elif compute_dtype == "bfloat16":
            out["images"] = torch.from_numpy(imgs).to(torch.bfloat16)
    masks = out.pop("gt_masks", None)
    if masks is not None:
        if masks.shape[-1] % 8:
            out["gt_masks"] = masks
        else:
            out["gt_masks_bits"] = np.packbits(masks.astype(bool), axis=-1)
    seg = out.get("seg_gt")
    if seg is not None and seg.dtype != np.uint8:
        out["seg_gt"] = seg.astype(np.uint8)
    return {k: v if isinstance(v, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(v))
            for k, v in out.items()}


def decode_batch(batch: dict) -> dict:
    """Wire batch -> model batch, with torch ops on the batch's device; raw
    batches pass through unchanged."""
    out = dict(batch)
    imgs = out.get("images")
    if imgs is not None and imgs.dtype == torch.uint8:
        mean = torch.as_tensor(PIXEL_MEANS_BGR, device=imgs.device)
        out["images"] = imgs.float() - mean
    bits = out.pop("gt_masks_bits", None)
    if bits is not None:
        # the inverse of np.packbits(axis=-1): most significant bit first
        shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=bits.device)
        m = (bits.unsqueeze(-1) >> shifts) & 1
        out["gt_masks"] = m.reshape(*bits.shape[:-1], bits.shape[-1] * 8)
    seg = out.get("seg_gt")
    if seg is not None and seg.dtype == torch.uint8:
        out["seg_gt"] = seg.int()
    return out


class DevicePrefetcher:
    """Iterates ``it`` (numpy batches) on a background thread, encodes each
    batch's ``STEP_KEYS`` with ``encode_batch(batch, compute_dtype,
    image_wire)`` and copies it to ``device``, ``depth`` batches ahead of the
    consumer. On a CUDA device the copy runs from pinned memory on a side
    stream; ``next`` makes the consumer's current stream wait for that batch's
    copy and records the stream on each tensor it hands over, so that the
    caching allocator does not reuse its memory while the step reads it.
    A CUDA device without a card is refused. An exception of the thread is
    raised at the consumer's ``next``."""

    _DONE = object()

    def __init__(self, it, device, compute_dtype: str = "bfloat16",
                 image_wire: str = "bf16", depth: int = 2):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        if self.cuda and not torch.cuda.is_available():
            raise RuntimeError(f"DevicePrefetcher: device {device} but no CUDA device")
        if image_wire not in IMAGE_WIRES:
            raise ValueError(f"train.image_wire={image_wire!r}: expected one of {IMAGE_WIRES}")
        self.compute_dtype, self.image_wire = compute_dtype, image_wire
        self._stream = torch.cuda.Stream(self.device) if self.cuda else None
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, args=(it,), daemon=True)
        self._thread.start()

    def _put(self, batch: dict):
        wire = encode_batch({k: v for k, v in batch.items() if k in STEP_KEYS},
                            self.compute_dtype, self.image_wire)
        if not self.cuda:
            return wire, None
        with torch.cuda.stream(self._stream):
            out = {k: v.pin_memory().to(self.device, non_blocking=True)
                   for k, v in wire.items()}
            done = torch.cuda.Event()
            done.record(self._stream)
        return out, done

    def _put_or_stop(self, item) -> bool:
        """Enqueue, but give up once ``close`` is called while the queue is
        full (the consumer left early and will not drain it)."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _run(self, it):
        try:
            for batch in it:
                if self._stop.is_set() or not self._put_or_stop(self._put(batch)):
                    return
        except BaseException as e:  # noqa: BLE001 - raised again at the consumer's next()
            self._put_or_stop(e)
            return
        finally:
            close = getattr(it, "close", None)
            if close is not None and self._stop.is_set():
                close()  # a loader generator: its workers stop here
        self._put_or_stop(self._DONE)

    def close(self):
        """Stop the thread, drop the staged batches and, through the
        iterator's own ``close``, stop the loader's workers."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=30.0)

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        item = self._q.get()
        if item is self._DONE:
            raise StopIteration
        if isinstance(item, BaseException):
            raise item
        batch, done = item
        if done is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(done)
            for t in batch.values():
                t.record_stream(stream)
        return batch
