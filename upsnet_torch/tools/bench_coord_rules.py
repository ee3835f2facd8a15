"""Time the coordinate pass of the all-tap K3 under each derivative rule.

The coordinate pass (``deform_sample.coord_pass``, ``csrc/offset_grads.cuh``)
is the second launch of both all-tap K3 forms. It computes the gradients to
the sample coordinates under one of three rules (``deform_sample.RULES``):
``pallas`` (0 at an integer coordinate), ``hat`` (two more loads there) and
``floor``; with a device flag (``auto`` under training) it reads the flag and
takes ``floor`` where it is False. This tool times it on the nine-tap P2
layer of the 832x1344 bucket at batch 2 (9 x 2 x 208 x 336 x 128, bf16,
tap-major) at three offset fields:

  * ``+-2 px``: uniform in +-2 px, no coordinate an integer;
  * ``integer-heavy``: the same with half of the dy and half of the dx
    rounded to integers;
  * ``zero``: every offset 0, so every sample on an integer coordinate (an
    offset conv's start).

Each configuration is timed as the median of CUDA-event-timed single calls
and as the median per call of 20 calls queued back to back. One line per
field and configuration, then one JSON object with every row and the card's
name and power limit.

    python3 -m upsnet_torch.tools.bench_coord_rules

A package whose ``coord_pass`` takes no rule (before the rules) is timed
under its one rule, ``pallas``, so that two trees compare in one call. Needs
a CUDA device.
"""

from __future__ import annotations

import inspect
import json
import statistics
import subprocess

import torch

from upsnet_torch.ops import deform_sample

TAPS, BATCH, H, W, C = 9, 2, 208, 336, 128
FIELDS = ("+-2 px", "integer-heavy", "zero")
# (rule, flag): flag None launches without one; True / False the flagged
# kernel with the device flag at that value (``auto``: False takes floor)
CONFIGS = (("pallas", None), ("hat", None), ("floor", None), ("pallas", True),
           ("pallas", False), ("hat", True), ("hat", False))


def _median_ms(fn, reps: int = 30) -> float:
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _queued_ms(fn, n: int = 20, reps: int = 10) -> float:
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def layer(field: str, dev: torch.device, seed: int = 0) -> tuple:
    """y, g, sy, sx of the P2 layer at ``field``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    y = torch.randn((TAPS, BATCH, H, W, C), generator=g, device=dev).to(torch.bfloat16)
    grad = torch.randn((BATCH, H, W, C), generator=g, device=dev).to(torch.bfloat16)
    shape = (TAPS, BATCH, H, W)
    kk = torch.arange(TAPS, device=dev)
    ky = (kk // 3 - 1).float()[:, None, None, None]
    kx = (kk % 3 - 1).float()[:, None, None, None]
    if field == "zero":
        off_y = off_x = torch.zeros(shape, device=dev)
    else:
        off_y = torch.rand(shape, generator=g, device=dev) * 4 - 2
        off_x = torch.rand(shape, generator=g, device=dev) * 4 - 2
        if field == "integer-heavy":
            off_y = torch.where(torch.rand(shape, generator=g, device=dev) < 0.5,
                                off_y.round(), off_y)
            off_x = torch.where(torch.rand(shape, generator=g, device=dev) < 0.5,
                                off_x.round(), off_x)
    iy = torch.arange(H, device=dev, dtype=torch.float32)[None, None, :, None]
    ix = torch.arange(W, device=dev, dtype=torch.float32)[None, None, None, :]
    return y, grad, (iy + ky + off_y).contiguous(), (ix + kx + off_x).contiguous()


def card() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def main() -> list:
    if not torch.cuda.is_available():
        raise SystemExit("bench_coord_rules needs a CUDA device")
    dev = torch.device("cuda", 0)
    ruled = "rule" in inspect.signature(deform_sample.coord_pass).parameters
    configs = CONFIGS if ruled else (("pallas", None),)
    rows = []
    for field in FIELDS:
        y, grad, sy, sx = layer(field, dev)
        gsy, gsx = torch.empty_like(sy), torch.empty_like(sx)
        for rule, flag in configs:
            fast = None if flag is None else torch.tensor(flag, device=dev)
            extra = (rule, fast) if ruled else ()

            def run():
                deform_sample.coord_pass(y, sy, sx, grad, gsy, gsx, TAPS, 1, *extra)

            ms, queued = _median_ms(run), _queued_ms(run)
            rows.append({"field": field, "rule": rule, "flag": flag, "ms": ms,
                         "queued_ms": queued})
            print(f"[coord rules] {field}, rule {rule}, flag {flag}: {ms:.4f} ms "
                  f"(queued {queued:.4f} ms)", flush=True)
        del y, grad, sy, sx, gsy, gsx
        torch.cuda.empty_cache()
    print(json.dumps({"card": card(), "layer": [TAPS, BATCH, H, W, C], "rows": rows}))
    return rows


if __name__ == "__main__":
    main()
