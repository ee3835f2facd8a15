"""ctypes bindings for the native RLE codec (native/rle.cc).

The port's copy of ``upsnet_tpu/evaluation/rle_native.py``: it loads the
same ``native/librle.so`` by path. Loaded lazily; ``available()`` is False
when the shared library has not been built (``make -C native``), in which
case evaluation/rle.py uses its numpy implementation. The numpy path is
also the correctness reference — tests assert both produce identical bytes.
This is a host codec; the choice has nothing to do with the device.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None
_TRIED = False
# testing escape hatch: force the numpy fallback even when the shared
# library is built
FORCE_DISABLED = False


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        "native",
        "librle.so",
    )
    if not os.path.exists(path):
        return None
    lib = ctypes.CDLL(path)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.rle_encode_counts.restype = ctypes.c_int64
    lib.rle_encode_counts.argtypes = [u8p, ctypes.c_int64, i64p]
    lib.rle_decode_counts.restype = None
    lib.rle_decode_counts.argtypes = [i64p, ctypes.c_int64, u8p, ctypes.c_int64]
    lib.rle_counts_to_string.restype = ctypes.c_int64
    lib.rle_counts_to_string.argtypes = [i64p, ctypes.c_int64, ctypes.c_char_p]
    lib.rle_string_to_counts.restype = ctypes.c_int64
    lib.rle_string_to_counts.argtypes = [ctypes.c_char_p, ctypes.c_int64, i64p]
    lib.rle_area.restype = ctypes.c_int64
    lib.rle_area.argtypes = [i64p, ctypes.c_int64]
    lib.rle_intersection.restype = ctypes.c_int64
    lib.rle_intersection.argtypes = [i64p, ctypes.c_int64, i64p, ctypes.c_int64]
    _LIB = lib
    return lib


def available() -> bool:
    return not FORCE_DISABLED and _load() is not None


def codec() -> str:
    """Which RLE codec evaluation/rle.py runs: 'native (<path>)' or 'numpy'."""
    return f"native ({_LIB._name})" if available() else "numpy"


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def mask_to_counts(mask: np.ndarray) -> np.ndarray:
    lib = _load()
    flat = np.asfortranarray(mask).reshape(-1, order="F").astype(np.uint8)
    out = np.empty(flat.size + 1, np.int64)
    m = lib.rle_encode_counts(
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), flat.size, _i64p(out)
    )
    return out[:m]


def counts_to_mask(counts: np.ndarray, shape) -> np.ndarray:
    lib = _load()
    h, w = shape
    counts = np.ascontiguousarray(counts, np.int64)
    out = np.zeros(h * w, np.uint8)
    lib.rle_decode_counts(
        _i64p(counts), counts.size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), out.size,
    )
    return out.reshape((h, w), order="F")


def encode_counts(counts: np.ndarray) -> bytes:
    lib = _load()
    counts = np.ascontiguousarray(counts, np.int64)
    buf = ctypes.create_string_buffer(int(counts.size) * 7 + 1)
    n = lib.rle_counts_to_string(_i64p(counts), counts.size, buf)
    return buf.raw[:n]


def decode_counts(data: bytes) -> np.ndarray:
    lib = _load()
    out = np.empty(max(len(data), 1), np.int64)
    m = lib.rle_string_to_counts(data, len(data), _i64p(out))
    return out[:m]


def area(counts: np.ndarray) -> int:
    lib = _load()
    counts = np.ascontiguousarray(counts, np.int64)
    return int(lib.rle_area(_i64p(counts), counts.size))


def intersection(ca: np.ndarray, cb: np.ndarray) -> int:
    lib = _load()
    ca = np.ascontiguousarray(ca, np.int64)
    cb = np.ascontiguousarray(cb, np.int64)
    return int(lib.rle_intersection(_i64p(ca), ca.size, _i64p(cb), cb.size))
