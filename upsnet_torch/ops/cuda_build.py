"""Build the CUDA kernels of ``upsnet_torch/csrc`` with nvcc and load them.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
(with the shared ``csrc/*.cuh`` headers) into
``build/upsnet_torch_kernels/lib<name>-<hash>.so`` at the repository root;
the hash covers the source and the headers, so an edit is rebuilt, and nvcc's
output (ptxas's registers and spills per kernel) is kept beside it. The first
request for any library compiles every missing one, one ``nvcc`` process per
source, all started together. Nothing here runs at import time, so the
package imports on hosts without ``nvcc`` or a GPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import torch

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "upsnet_torch_kernels"
SOURCES = ("deform_sample", "deform_sample_bwd", "roi_align_fpn",
           "roi_align_fpn_bwd", "deform_shift", "deform_sample_tiled",
           "deform_sample_mt", "deform_sample_mt_bwd", "tta_merge")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# element type codes of the C entry points
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_loaded: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        p = pathlib.Path(cand) / "bin" / "nvcc"
        if cand and p.exists():
            return str(p)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path(name: str) -> pathlib.Path:
    """Where ``name`` is built: named by a hash of its source and of every
    shared header, so an edit to either builds it anew."""
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names=SOURCES) -> None:
    """Compile every library in ``names`` that is not built yet, in parallel.
    Raises with nvcc's output if any compile fails."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = []
    for n in todo:
        out = library_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs.append((n, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failures = []
    for n, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{n}: nvcc exited {proc.returncode}\n{log}")
        else:
            os.replace(tmp, out)
            out.with_suffix(".log").write_text(log)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))


def build_log(name: str) -> str:
    """nvcc's output from building library ``name``: ptxas's registers,
    stack and spills of every kernel (``-Xptxas -v``)."""
    return library_path(name).with_suffix(".log").read_text()


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, building all missing libraries first."""
    with _lock:
        if name not in _loaded:
            build()
            _loaded[name] = ctypes.CDLL(str(library_path(name)))
        return _loaded[name]


def check(lib: ctypes.CDLL, status: int, what: str) -> None:
    """Raise if a C entry point of ``lib`` returned a CUDA error code."""
    if status != 0:
        lib.error_string.restype = ctypes.c_char_p
        lib.error_string.argtypes = [ctypes.c_int]
        msg = lib.error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({msg})")


def call(lib_name: str, fn_name: str, tensor, pointers, ints) -> None:
    """Launch C entry point ``fn_name(pointers..., ints..., dtype, stream)``
    of library ``lib_name`` on ``tensor``'s device and current stream, with
    ``tensor``'s element type code (a pointer None passes null); raise on a
    CUDA error."""
    lib = load(lib_name)
    fn = getattr(lib, fn_name)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * len(pointers) + [ctypes.c_int] * (len(ints) + 1)
                   + [ctypes.c_void_p])
    stream = torch.cuda.current_stream(tensor.device).cuda_stream
    with torch.cuda.device(tensor.device):
        status = fn(*(None if p is None else p.data_ptr() for p in pointers), *ints,
                    DTYPE_CODES[tensor.dtype], stream)
    check(lib, status, fn_name)
