"""COCO run-length-encoding (RLE) mask codec, numpy implementation.

The reference leans on pycocotools' C maskUtils for mask encode/IoU at eval
time (SURVEY.md §2.4); that package is not vendored here, so the framework
ships its own codec implementing the identical format:

  * counts are run lengths of a column-major (Fortran-order) flattened
    binary mask, starting with the number of 0s;
  * the compressed string form packs each count in little-endian 5-bit
    groups (char = 48 + group, bit 0x20 = continuation), with counts[i]
    delta-encoded against counts[i-2] for i >= 2 — byte-compatible with
    pycocotools.mask.encode/decode.

A C++ fast path (native/rle.cc) is used when built; this numpy path is the
always-available fallback and the correctness reference. The port's copy of
``upsnet_tpu/evaluation/rle.py``.
"""

from __future__ import annotations

import numpy as np

from upsnet_torch.evaluation import rle_native as _native


def mask_to_counts(mask: np.ndarray) -> np.ndarray:
    """Binary (H, W) mask -> run-length counts (column-major, 0s first).

    Always the numpy path: the vectorized flatnonzero run-split measured
    FASTER than the serial C scan on a 832x1344 mask (the JAX package's
    ``tools/bench_rle.py``) — the native codec pays off on decode and IoU,
    not here.
    """
    flat = np.asfortranarray(mask).reshape(-1, order="F").astype(np.uint8)
    if flat.size == 0:
        return np.array([0], dtype=np.int64)
    change = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    idx = np.concatenate([[0], change, [flat.size]])
    counts = np.diff(idx).astype(np.int64)
    if flat[0] == 1:  # must start with a zero-run
        counts = np.concatenate([[0], counts])
    return counts


def counts_to_mask(counts, shape) -> np.ndarray:
    if _native.available():
        return _native.counts_to_mask(np.asarray(counts, np.int64), shape)
    h, w = shape
    total = h * w
    flat = np.zeros(total, np.uint8)
    pos = 0
    val = 0
    for c in counts:
        c = int(c)
        if val:
            flat[pos : pos + c] = 1
        pos += c
        val ^= 1
    assert pos == total, (pos, total)
    return flat.reshape((h, w), order="F")


def encode_counts(counts) -> bytes:
    """LEB128-style signed 5-bit packing with delta, pycocotools-compatible."""
    if _native.available():
        return _native.encode_counts(np.asarray(counts, np.int64))
    out = bytearray()
    counts = [int(c) for c in counts]
    for i, x in enumerate(counts):
        if i > 2:  # pycocotools delta-encodes from the 4th count on
            x -= counts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = not ((x == 0 and not (c & 0x10)) or (x == -1 and (c & 0x10)))
            if more:
                c |= 0x20
            out.append(c + 48)
    return bytes(out)


def decode_counts(data: bytes) -> list[int]:
    if _native.available():
        return _native.decode_counts(data).tolist()
    counts: list[int] = []
    pos = 0
    n = len(data)
    while pos < n:
        x = 0
        k = 0
        more = True
        while more:
            c = data[pos] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            pos += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def encode(mask: np.ndarray) -> dict:
    """Binary (H, W) mask -> COCO RLE dict {'size': [h, w], 'counts': bytes}."""
    h, w = mask.shape
    return {"size": [int(h), int(w)], "counts": encode_counts(mask_to_counts(mask))}


def decode(rle: dict) -> np.ndarray:
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        if isinstance(counts, str):
            counts = counts.encode()
        counts = decode_counts(counts)
    return counts_to_mask(counts, rle["size"])


def area(rle: dict) -> int:
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        if isinstance(counts, str):
            counts = counts.encode()
        counts = decode_counts(counts)
    return int(sum(counts[1::2]))


def _runs(counts):
    """counts -> (starts, ends) arrays of 1-runs in flat Fortran order."""
    c = np.asarray(counts, dtype=np.int64)
    ends_all = np.cumsum(c)
    starts_all = ends_all - c
    return starts_all[1::2], ends_all[1::2]


def intersection_area(rle_a: dict, rle_b: dict) -> int:
    """Intersection of two RLE masks without decoding to dense (merge runs)."""
    ca = rle_a["counts"]
    cb = rle_b["counts"]
    if isinstance(ca, (bytes, str)):
        ca = decode_counts(ca if isinstance(ca, bytes) else ca.encode())
    if isinstance(cb, (bytes, str)):
        cb = decode_counts(cb if isinstance(cb, bytes) else cb.encode())
    if _native.available():
        return _native.intersection(
            np.asarray(ca, np.int64), np.asarray(cb, np.int64)
        )
    sa, ea = _runs(ca)
    sb, eb = _runs(cb)
    inter = 0
    i = j = 0
    while i < len(sa) and j < len(sb):
        lo = max(sa[i], sb[j])
        hi = min(ea[i], eb[j])
        if hi > lo:
            inter += hi - lo
        if ea[i] < eb[j]:
            i += 1
        else:
            j += 1
    return int(inter)


def iou(rle_a: dict, rle_b: dict, iscrowd: bool = False) -> float:
    """IoU of two RLE masks; if iscrowd (b is crowd), denom = area(a)."""
    inter = intersection_area(rle_a, rle_b)
    aa = area(rle_a)
    ab = area(rle_b)
    denom = aa if iscrowd else aa + ab - inter
    return inter / denom if denom > 0 else 0.0
