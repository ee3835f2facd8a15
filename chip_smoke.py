#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``upsnet_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; there is no CPU path):

1. build: compile every CUDA kernel of ``upsnet_torch/csrc`` with nvcc, one
   process per source, all at once;
2. kernels: each of the twelve kernels (K2 and K6 in their all-tap forms,
   K3 in its all-tap forms, clipped and unclipped) against its plain
   PyTorch version on the card, on the shapes the paths below give it
   (batch 2 at 832x1344; K6 and the clipped K3's side-by-side layout at P2
   of the wide canvas, batch 1), with errors, kernel / plain / library-call
   times (CUDA events, median of 30 single calls; the all-tap K2 and K6
   also per call of 20 queued back to back) and the least time the card
   could take for the same work; the all-tap K2 and K6 must also equal
   (values) the one-tap kernel launched per tap with the adds in y's dtype,
   in the same run, in bf16 and, at P3, in float32;
   the gathers (both all-tap K3 forms, K5, K8b, K7b) must give the same bits
   on two runs, K5 also on RoIs clustered as training samples them, the
   all-tap K2 and the unclipped K3 also at offsets of +-40 px, and every K3
   form, K7b and K8c exact zeros at integer coordinates. K7a and K7b (a
   counting-sort gather, no atomics) are checked at C 256 and 128 on three
   offset fields (+-2 px; dx +-40 px with dy within +-(max_dy + 1); all
   nine taps of a pixel at one point, one bin), two runs bit-identical,
   with queued and profiled device ms (K7b's seven kernels summed, the
   sort's share) and ptxas's registers. K7a, K7b, the unclipped K3, the
   coordinate pass and K8c print a digest of their outputs, so that two
   commits' logs compare bit for bit. K4 is checked at
   the five calls of a predict forward and a train step (the GT call with 97
   all-zero padded boxes an image), in bf16 and float32, two runs
   bit-identical, with its registers from ptxas and its device time under
   the profiler. K1 is checked and
   timed in both layouts it takes, side by side (the no-grad routes') and
   tap-major, which must give the same bits as each other and as K8a, which
   runs its body (K8a is timed beside K1 on the same data); the
   coordinate pass that both all-tap K3 forms share with K8c is checked and
   timed alone on the P2 layers at +-2, +-40 and clipped +-6 px (and on its
   25-tap, C 384 path). The one-tap K2, K3
   and K6, which no route takes any more, are checked and timed as the
   yardsticks of the layers they used to serve, and are not in the kernels
   line;
3. predict: ``resnet_50_upsnet`` at full width (COCO: 81 classes, 133 seg
   classes) in bf16 at the 832x1344 bucket, random weights from a seed, DCN
   offset biases set to +-2 px, serving two batch-2 requests through
   ``forward_predict``; the kernel launch counters must move by exactly 8
   (K1) and 2 (K4) per request; peak memory allocated; with ``--profile``,
   one more request under torch.profiler (device time per stage and kernel,
   idle share, and whether any ``aten::copy_`` of a ``[9, N, C]`` tensor,
   the nine-fold copy of x that a tap-major projection makes, remains);
4. train: the same model in its train configuration (``dcn_impl: pallas``,
   ``dcn_boundary_grad: clip``) takes four SGD steps through
   ``train_steps`` on a synthetic batch of 2 (512 RoIs, 256 anchors, 100 GT
   slots) with a display interval of one step; every interval must launch
   exactly 8 all-tap K2 and 16 all-tap K3 (one K2 and the K3's two passes
   for each of the 8 DCN layers), 3 K4, 3 K5 for its step and 8 K1 for the
   saturation watch's probe of the trunk, and no one-tap K2 or K6; give 7
   finite loss terms, finite gradients
   everywhere, non-zero offset-conv gradients, leave the frozen parameters
   untouched and append one line to ``metrics.jsonl``; with ``--profile``,
   one more step under torch.profiler (also each kernel's summed device time
   in the step, and for the largest device ops that are not the port's the
   stage and the aten op, with its input shapes, that launched them);
5. predict_shift, train_shift: phases 3 and 4 again with
   ``dcn_impl: shift`` (three train steps). The launch counts follow from
   the port's ``shift_route_ok``: the levels it accepts (P2, P3) run K8a,
   and K8b + K8c in backward, the others K1, or the all-tap K2 + the clipped
   all-tap K3 under autograd; the JAX loop does not watch ``shift``, so there
   is no probe.
   ``seg_logits``
   and the step-0 losses are held against the ``pallas`` route's on the
   same weights: with offsets within +-2 px neither clip acts, so the two
   differ by rounding only;
6. predict_wide, train_wide: phases 3 and 4 with ``dcn_impl: pallas`` at
   batch 1 on an 832x3328 canvas (two requests, two steps). Its P2 map,
   208x832 at 128 channels, is wider than the TPU's untiled kernel holds,
   so the port's ``pallas_route`` answers ``tiled`` for it and ``untiled``
   for P3-P5, and the expected launches follow from that rule: per forward
   2 all-tap K6 (the 2 layers at P2), 6 K1, 2 K4; per step 2 all-tap K6 for
   P2, 6 all-tap K2 for P3-P5, 16 all-tap K3 (8 layers), 3 K4, 3 K5, plus
   the watch's probe. ``seg_logits`` are held against ``auto`` on the same weights: equal
   within the bf16 tap-sum tolerance at +-2 px, different once dx goes
   beyond the +-6 window (the tiled form clips dx, ``auto`` does not);
7. train_auto: phase 4 with ``dcn_impl: auto`` (two steps), the unclipped
   route: 8 all-tap K2, 16 unclipped all-tap K3 (its two passes for each of
   the 8 DCN layers), no one-tap K2 or K3, 3 K4, 3 K5 per step, no probe
   (the loop watches only ``pallas`` and ``mxu``);
8. mt_tool: the sample-first form (K7a, one GEMM, K7b) through its caller,
   ``upsnet_torch.tools.bench_deform_impls``, at batch 2 over the tool's
   five shapes, forward and forward + backward, against the per-tap form;
   launch counts equal the tool's call counts;
9. reference: a tiny float32 model on the card against the same model on
   the CPU (plain versions, no kernels).

The line before the last two is a JSON object with the numbers of every
kernel on a path (``launches`` sums the predict, train and tool phases, each
counted from 0);
then the card's name and power limit; the last line is the device record.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: CUDA is not available")

import torch.nn.functional as F  # noqa: E402

from upsnet_torch.config import default_config  # noqa: E402
from upsnet_torch.data.synthetic import synthetic_batch  # noqa: E402
from upsnet_torch.models import layers  # noqa: E402
from upsnet_torch.models.upsnet import build_model, forward_predict  # noqa: E402
from upsnet_torch.ops import (  # noqa: E402
    cuda_build, deform_conv, deform_sample, deform_sample_mt, deform_shift, nms, roi_align_fpn)
from upsnet_torch.ops.deform_conv import clip_offsets, deform_conv2d_mt  # noqa: E402
from upsnet_torch.tools import bench_deform_impls  # noqa: E402
from upsnet_torch.train.optimizer import make_optimizer  # noqa: E402
from upsnet_torch.train.step import make_train_step  # noqa: E402
from upsnet_torch.train.trainer import WATCHED_IMPLS, train_steps  # noqa: E402
from upsnet_torch.ops.anchors import pyramid_anchors  # noqa: E402
from upsnet_torch.ops.boxes import fpn_level_assignment  # noqa: E402
from upsnet_torch.ops.roi_align import _bilinear_corners, _sample_coords  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12  # float32 outside the tensor cores
BUCKET = (832, 1344)
IM_HW = (800.0, 1333.0)
BATCH = 2
# a canvas whose P2 map (208 x 832 at 128 channels) is too wide for the TPU's
# untiled DCN kernel, so that the routing rule itself picks the tiled form
WIDE_BUCKET = (832, 3328)
WIDE_IM_HW = (800.0, 3328.0)
WIDE_BATCH = 1
REPS = 30


def time_ms(fn, reps: int = REPS) -> float:
    """Median of ``reps`` CUDA-event-timed calls after two warm-up calls."""
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


def time_queued_ms(fn, n: int = 20, reps: int = 10) -> float:
    """Median over ``reps`` of ``n`` calls queued back to back, per call:
    the host's share of each call hides behind the device's, so this reads
    close to one call's device time (``time_ms`` includes the host's)."""
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


def device_ms_by_kernel(fn, symbols, n: int = 20) -> dict:
    """For each of ``symbols``, the median device time of the kernels whose
    name holds it over ``n`` calls of ``fn`` under torch.profiler: the
    kernels alone, where ``time_queued_ms`` reads the wrapper's host time
    instead once a call's host time exceeds its device time. The profiler
    may drop a kernel record now and then; each median is of those it
    kept."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    out = {}
    for symbol in symbols:
        times = [e.time_range.elapsed_us() / 1e3 for e in kernels if symbol in e.name]
        if not times:
            raise AssertionError(f"no kernel named {symbol} in {n} profiled calls")
        out[symbol] = statistics.median(times)
    return out


def device_ms(fn, symbol: str, n: int = 20) -> float:
    """``device_ms_by_kernel`` of the one kernel named by ``symbol``."""
    return device_ms_by_kernel(fn, (symbol,), n)[symbol]


def digest(*tensors) -> str:
    """A short sha1 of the tensors' bytes, so that two runs (a parent's and a
    change's) can be compared bit for bit from their logs."""
    h = hashlib.sha1()
    for t in tensors:
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def bound(n_bytes: float, n_flops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(got: torch.Tensor, ref: torch.Tensor, rtol: float, atol: float):
    """Max abs/rel error; raises unless |got - ref| <= rtol*|ref| + atol."""
    got, ref = got.float(), ref.float()
    if not torch.isfinite(got).all():
        raise AssertionError("kernel output has non-finite values")
    err = (got - ref).abs()
    max_abs = float(err.max())
    max_rel = float((err / ref.abs().clamp(min=1e-3)).max())
    bad = err > rtol * ref.abs() + atol
    if bad.any():
        raise AssertionError(
            f"{int(bad.sum())} elements outside tolerance; max abs {max_abs}")
    return max_abs, max_rel


def phase_build() -> None:
    t0 = time.perf_counter()
    cuda_build.build()
    for name in cuda_build.SOURCES:
        cuda_build.load(name)
    print(f"[build] {len(cuda_build.SOURCES)} kernels built and loaded in "
          f"{time.perf_counter() - t0:.2f} s (nvcc {cuda_build.nvcc_path()})")


def touched_rows(sy, sx, h: int, w: int) -> tuple[int, int]:
    """For sample coordinates (..., H, W) over a stack of (H, W) maps, one
    per leading index: how many distinct map rows (pixels) the counted
    samples read, and how many samples count."""
    inside = (sy > -1) & (sy < h) & (sx > -1) & (sx < w)
    y0, x0 = sy.floor().long(), sx.floor().long()
    lead = sy.shape[:-2]
    plane_id = torch.arange(math.prod(lead), device=sy.device).reshape(*lead, 1, 1)
    cells = []
    for dy in (0, 1):
        for dx in (0, 1):
            yy, xx = y0 + dy, x0 + dx
            ok = inside & (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            cells.append(((plane_id * h + yy) * w + xx)[ok])
    return int(torch.unique(torch.cat(cells)).numel()), int(inside.sum())


def dcn_offsets(g, dev, shape) -> torch.Tensor:
    """+-2 px offsets with 3% of them moved 6-12 px."""
    off = torch.rand(shape, generator=g, device=dev) * 4 - 2
    far = torch.rand(shape, generator=g, device=dev) < 0.03
    mag = 6 + 6 * torch.rand(shape, generator=g, device=dev)
    sign = torch.where(torch.rand(shape, generator=g, device=dev) < 0.5, -1.0, 1.0)
    return torch.where(far, sign * mag, off)


def check_k1(dev) -> dict:
    """K1 at the four FCN levels of the path (P2 208x336 .. P5 26x42), C=128
    bf16, 9 taps: +-2 px offsets with 3% of the samples moved 6-12 px and 1%
    pushed beyond the image edge, in both layouts: side by side
    (B, H, W, 9, C), the output of the one matmul that the no-grad routes
    build (its numbers are the returned ones), and tap-major (9, B, H, W, C).
    At every level the two layouts and K8a (``shift_fwd``) on the same
    side-by-side data must give the same bits, and lie within one bf16 ulp
    of the plain version. Times, the bound and the library yardstick are for
    P2; the tap-major time is printed beside the side-by-side one."""
    g = torch.Generator(device=dev).manual_seed(1)
    taps, b, c = 9, BATCH, 128
    kk = torch.arange(taps, device=dev)
    ky = (kk // 3 - 1).float()[:, None, None, None]
    kx = (kk % 3 - 1).float()[:, None, None, None]

    def inputs(h, w):
        shape = (taps, b, h, w)
        y9 = torch.randn((taps, b, h, w, c), generator=g, device=dev).to(torch.bfloat16)
        iy = torch.arange(h, device=dev, dtype=torch.float32)[None, None, :, None]
        ix = torch.arange(w, device=dev, dtype=torch.float32)[None, None, None, :]

        sy9 = iy + ky + dcn_offsets(g, dev, shape)
        sx9 = (ix + kx + dcn_offsets(g, dev, shape)).contiguous()
        edge = torch.rand(shape, generator=g, device=dev) < 0.01
        sy9 = torch.where(edge, sy9 + torch.where(sy9 < h / 2, -float(h), float(h)), sy9)
        return y9, sy9.contiguous(), sx9

    # f32 sums in a different order, each rounded once to bf16: at most one
    # bf16 ulp (<= 2^-7 relative) apart, plus f32 slack near zero
    rtol, atol = 2.0 ** -7, 1e-4
    max_abs = 0.0
    for stride in (32, 16, 8, 4):  # P2 last: its tensors are timed below
        h, w = BUCKET[0] // stride, BUCKET[1] // stride
        y9, sy9, sx9 = inputs(h, w)
        y_sbs = y9.permute(1, 2, 3, 0, 4).contiguous()
        got = deform_sample.deform_sample9(y_sbs, sy9, sx9, tap_axis=3)
        got_tm = deform_sample.deform_sample9(y9, sy9, sx9)
        got_k8a = deform_shift.shift_fwd(y_sbs.flatten(3), sy9, sx9)
        ref = deform_sample.deform_sample9_plain(y9, sy9, sx9)
        torch.cuda.synchronize()
        if not (torch.equal(got, got_tm) and torch.equal(got, got_k8a)):
            raise AssertionError(f"K1 at {h}x{w}: the side-by-side, tap-major and K8a "
                                 f"results differ")
        err, rel = compare(got, ref, rtol, atol)
        max_abs = max(max_abs, err)
        print(f"[K1 deform_sample9] y {tuple(y_sbs.shape)} side by side bf16: max abs err "
              f"{err:.3e}, max rel err {rel:.3e} (tolerance {rtol:.4g}*|ref| + {atol:g}); "
              f"equal to tap-major K1 and to K8a")

    # the library yardstick: 9 grid_sample calls (zeros padding, corner-
    # aligned grid = DCN's zero-padded bilinear sampling) and a sum.
    # grid_sample wants the grid in the input's dtype, and a bf16 grid
    # cannot hold the coordinates, so it samples float32 copies of y9
    # (made outside the timed call)
    grids = torch.stack([2 * sx9 / (w - 1) - 1, 2 * sy9 / (h - 1) - 1], dim=-1)
    planes = [y9[t].float().permute(0, 3, 1, 2) for t in range(taps)]

    def library():
        acc = F.grid_sample(planes[0], grids[0], mode="bilinear",
                            padding_mode="zeros", align_corners=True)
        for t in range(1, taps):
            acc += F.grid_sample(planes[t], grids[t], mode="bilinear",
                                 padding_mode="zeros", align_corners=True)
        return acc

    lib_err = float((library().permute(0, 2, 3, 1) - ref.float()).abs().max())
    side = lambda: deform_sample.deform_sample9(y_sbs, sy9, sx9, tap_axis=3)  # noqa: E731
    major = lambda: deform_sample.deform_sample9(y9, sy9, sx9)  # noqa: E731
    ms, ms_tm = time_ms(side), time_ms(major)
    queued, queued_tm = time_queued_ms(side), time_queued_ms(major)
    plain_ms = time_ms(lambda: deform_sample.deform_sample9_plain(y_sbs, sy9, sx9, 3), 10)
    library_ms = time_ms(library)

    # bytes this run needs: every projection row a counted sample touches
    # (once), the coordinates, the output; flops: 4 corners x 2 per channel
    n_rows, n_inside = touched_rows(sy9, sx9, h, w)
    n_bytes = n_rows * c * 2 + 2 * sy9.numel() * 4 + got.numel() * 2
    n_flops = n_inside * 4 * 2 * c
    bound_ms, bound_by = bound(n_bytes, n_flops)
    print(f"[K1 deform_sample9] P2: kernel side by side {ms:.4f} ms ({100 * bound_ms / ms:.1f}% "
          f"of the bound; per call of 20 queued {queued:.4f}), tap-major {ms_tm:.4f} ms "
          f"(queued {queued_tm:.4f}), plain {plain_ms:.4f} ms, 9x grid_sample "
          f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: {n_bytes / 1e6:.1f} MB, "
          f"{n_flops / 1e9:.3f} GFLOP); grid_sample yardstick max abs diff {lib_err:.3e}")
    return {
        "name": "deform_sample9", "route": "cuda",
        "source": "upsnet_torch/csrc/deform_sample.cu",
        "replaces": "upsnet_tpu/ops/deform_conv_pallas.py:282",
        "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
    }


def check_coords(dev) -> None:
    """The coordinate pass of both all-tap K3 forms alone (``coord_pass``:
    ``offset_grads.cuh``, K8c's kernel) on the nine-tap P2 layer of the
    832x1344 bucket, tap-major (9 x 2 x 208 x 336 x 128), and on the wide
    P2 layer, side by side (1 x 208 x 832 x 9 x 128), bf16, at three offset
    fields: +-2 px (``dcn_offsets``), uniform +-40 px, and +-2 px clipped to
    +-6 (as ``check_k8`` draws K8c's); each with 5% of the samples on
    integer rows, 5% on integer columns and 1% beyond the image edge. Each
    against the coordinate half of the all-tap K3's plain version (f32 sums
    of 4 x 128 products of O(1) values in another order: 1e-4 relative plus
    1e-3 absolute), two runs bit-identical, exactly 0 at integer
    coordinates; timed as single calls and queued. Its time is part of the
    K3 and K8c rows, so it has no row of its own."""
    g = torch.Generator(device=dev).manual_seed(13)
    taps, c, max_d = 9, 128, 6
    c_rtol, c_atol = 1e-4, 1e-3
    kk = torch.arange(taps, device=dev)
    ky = (kk // 3 - 1).float()[:, None, None, None]
    kx = (kk % 3 - 1).float()[:, None, None, None]
    for tag, b, (h, w), tap_axis in (
            ("P2 tap-major", BATCH, (BUCKET[0] // 4, BUCKET[1] // 4), 0),
            ("wide P2 side by side", WIDE_BATCH, (WIDE_BUCKET[0] // 4, WIDE_BUCKET[1] // 4), 3)):
        shape = (taps, b, h, w)
        y = torch.randn((taps, b, h, w, c), generator=g, device=dev).to(torch.bfloat16)
        if tap_axis == 3:
            y = y.permute(1, 2, 3, 0, 4).contiguous()
        grad = torch.randn((b, h, w, c), generator=g, device=dev).to(torch.bfloat16)
        iy = torch.arange(h, device=dev, dtype=torch.float32)[None, None, :, None]
        ix = torch.arange(w, device=dev, dtype=torch.float32)[None, None, None, :]
        for field in ("+-2 px", "+-40 px", "clipped +-6 px"):
            if field == "+-40 px":
                off_y = torch.rand(shape, generator=g, device=dev) * 80 - 40
                off_x = torch.rand(shape, generator=g, device=dev) * 80 - 40
            else:
                off_y, off_x = dcn_offsets(g, dev, shape), dcn_offsets(g, dev, shape)
                if field.startswith("clipped"):
                    off_y = clip_offsets(off_y, float(max_d))
                    off_x = clip_offsets(off_x, float(max_d))
            sy, sx = _mark_integers(g, dev, iy + ky + off_y, ix + kx + off_x, h)

            def run():
                gsy, gsx = torch.empty_like(sy), torch.empty_like(sx)
                deform_sample.coord_pass(y, sy, sx, grad, gsy, gsx, taps, int(tap_axis == 0))
                return gsy, gsx

            got, again = run(), run()
            ref = deform_sample.deform_sample_bwd_taps_plain(y, sy, sx, grad, None, tap_axis)
            torch.cuda.synchronize()
            gsy_err, _ = compare(got[0], ref[1], c_rtol, c_atol)
            gsx_err, _ = compare(got[1], ref[2], c_rtol, c_atol)
            del ref
            if not (torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])):
                raise AssertionError(f"coordinate pass, {tag}, {field}: two runs differ")
            at_int_y, at_int_x = sy == sy.round(), sx == sx.round()
            if (float(got[0][at_int_y].abs().max()) != 0.0
                    or float(got[1][at_int_x].abs().max()) != 0.0):
                raise AssertionError(f"coordinate pass, {tag}, {field}: non-zero gradient at "
                                     f"an integer coordinate")
            if float(got[0].abs().max()) == 0.0 or float(got[1].abs().max()) == 0.0:
                raise AssertionError(f"coordinate pass, {tag}, {field}: all zero")
            ms, queued = time_ms(run), time_queued_ms(run)
            n_rows, n_inside = touched_rows(sy, sx, h, w)
            n_bytes = n_rows * c * 2 + grad.numel() * 2 + 4 * sy.numel() * 4
            bound_ms, bound_by = bound(n_bytes, n_inside * 4 * 2 * c)
            print(f"[coord pass] {tag} y {tuple(y.shape)} bf16, {field}: gsy / gsx max abs err "
                  f"{gsy_err:.3e} / {gsx_err:.3e} (tolerance {c_rtol:g}*|ref| + {c_atol:g}); "
                  f"two runs bit-identical; exactly 0 at the {int(at_int_y.sum())} integer rows "
                  f"and {int(at_int_x.sum())} integer columns; kernel {ms:.4f} ms (queued "
                  f"{queued:.4f}), bound {bound_ms:.4f} ms ({bound_by}: {n_bytes / 1e6:.1f} MB), "
                  f"{100 * bound_ms / ms:.1f}% of it; digest {digest(*got)}")
            del got, again, sy, sx
        del y, grad
        torch.cuda.empty_cache()

    # the kernel's other paths, on no route of the model: 25 taps (a 5 x 5
    # layer: a chunk of 9 taps, then 9, then 7) and C 384 (a lane takes two
    # groups), in float32 at +-3 px, side by side
    taps, b, h, w, c = 25, 2, 24, 40, 384
    y = torch.randn((b, h, w, taps, c), generator=g, device=dev)
    grad = torch.randn((b, h, w, c), generator=g, device=dev)
    sy = (torch.arange(h, device=dev, dtype=torch.float32)[None, None, :, None]
          + torch.rand((taps, b, h, w), generator=g, device=dev) * 6 - 3)
    sx = (torch.arange(w, device=dev, dtype=torch.float32)[None, None, None, :]
          + torch.rand((taps, b, h, w), generator=g, device=dev) * 6 - 3)
    sy, sx = _mark_integers(g, dev, sy, sx, h)
    gsy, gsx = torch.empty_like(sy), torch.empty_like(sx)
    deform_sample.coord_pass(y, sy, sx, grad, gsy, gsx, taps, 0)
    ref = deform_sample.deform_sample_bwd_taps_plain(y, sy, sx, grad, None, 3)
    torch.cuda.synchronize()
    # f32 sums of 4 x 384 products: 1e-4 relative plus 2e-3 absolute
    gsy_err, _ = compare(gsy, ref[1], c_rtol, 2e-3)
    gsx_err, _ = compare(gsx, ref[2], c_rtol, 2e-3)
    if (float(gsy[sy == sy.round()].abs().max()) != 0.0
            or float(gsx[sx == sx.round()].abs().max()) != 0.0):
        raise AssertionError("coordinate pass, 25 taps: non-zero gradient at an integer "
                             "coordinate")
    print(f"[coord pass] y {tuple(y.shape)} f32 (25 taps, C 384): gsy / gsx max abs err "
          f"{gsy_err:.3e} / {gsx_err:.3e} (tolerance {c_rtol:g}*|ref| + 2e-3); exactly 0 at "
          f"integer coordinates; digest {digest(gsy, gsx)}")


def _random_rois(g, dev, n: int) -> torch.Tensor:
    """n RoIs per image over the 832x1344 canvas: log-uniform 8-800 px
    sides, centers up to 60 px outside the image, and every tenth RoI
    wider than 256 px."""
    hh, ww = BUCKET
    side = torch.exp(torch.empty((BATCH, n, 2), device=dev).uniform_(
        math.log(8.0), math.log(800.0), generator=g))
    side[:, ::10, 0] = torch.empty((BATCH, side[:, ::10].shape[1]), device=dev).uniform_(
        260.0, 1100.0, generator=g)
    cx = torch.empty((BATCH, n), device=dev).uniform_(-60.0, ww + 60.0, generator=g)
    cy = torch.empty((BATCH, n), device=dev).uniform_(-60.0, hh + 60.0, generator=g)
    return torch.stack([cx - side[..., 0] / 2, cy - side[..., 1] / 2,
                        cx + side[..., 0] / 2, cy + side[..., 1] / 2], -1).contiguous()


def ptxas_registers(lib: str, symbol: str) -> str:
    """The registers, spill stores and stack frame that ptxas reported for
    each instance of kernel ``symbol`` when library ``lib`` was built
    (``cuda_build.build_log``), as one printable string."""
    try:
        log = cuda_build.build_log(lib)
    except FileNotFoundError:
        return "no build log"
    found, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties for )(\w+)", line)
        if m:
            name = m.group(1) if symbol in m.group(1) else None
            continue
        if name is None:
            continue
        info = found.setdefault(name, {})
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", line)
        if m:
            info["stack"], info["spill"] = m.groups()
        m = re.search(r"Used (\d+) registers", line)
        if m:
            info["regs"] = m.group(1)
    parts = []
    for name, info in found.items():
        s_arg = re.search(r"Li(\d+)E", name)
        label = ("bf16 " if "bfloat16" in name else "f32 " if re.search(r"If[EL]", name)
                 else "") + (f"S={s_arg.group(1)} " if s_arg else "")
        parts.append(f"{label}{info.get('regs', '?')} registers, {info.get('spill', '?')} B "
                     f"spill stores, {info.get('stack', '?')} B stack")
    return "; ".join(sorted(parts)) or "not in the build log"


def _k4_bound(feats, rois, levels, pooled: int, c: int) -> tuple[float, str, float]:
    """The bound of one bf16 K4 call: bytes of the distinct feature rows its
    counted samples touch, the RoIs, levels and output; flops 4 samples x 4
    corners x 2 + 1 per output element. Returns (ms, what bounds it, bytes)."""
    n_rois = rois.shape[1]
    n = BATCH * n_rois
    dev = rois.device
    lev = levels.reshape(n).long()
    strides = torch.tensor([4.0, 8.0, 16.0, 32.0], device=dev)
    y, x = _sample_coords(rois.reshape(n, 4) / strides[lev][:, None], 1.0, pooled, 2)
    hs = torch.tensor([f.shape[1] for f in feats], device=dev, dtype=torch.float32)
    ws = torch.tensor([f.shape[2] for f in feats], device=dev, dtype=torch.float32)
    ext = (slice(None),) + (None,) * 4
    yl, xl, yh, xh, *wts = _bilinear_corners(y, x, hs[lev][ext], ws[lev][ext])
    inside = sum(wts) > 0
    img = torch.arange(BATCH, device=dev).repeat_interleave(n_rois)
    base = ((lev * BATCH + img) * 4096)[ext]
    cells = torch.cat([((base + yy) * 4096 + xx)[inside]
                       for yy in (yl, yh) for xx in (xl, xh)])
    n_rows = int(torch.unique(cells).numel())
    n_out = n * pooled * pooled * c
    n_bytes = n_rows * c * 2 + rois.numel() * 4 + levels.numel() * 4 + n_out * 2
    ms, by = bound(n_bytes, n_out * (4 * 4 * 2 + 1))
    return ms, by, n_bytes


def check_k4(dev) -> dict:
    """K4 over an 832x1344 pyramid (C=256), batch 2, at the calls of a
    predict forward (1000 RoIs an image at 7x7, the box call; 100 at 14x14,
    the mask call) and of a train step (512 at 7x7; 128 at 14x14; the 100 GT
    slots at 14x14: 3 boxes and 97 all-zero padded ones), in bf16 and in
    float32. At each: within tolerance of the plain version, two runs
    bit-identical, card ms and per call of 20 queued; in bf16 also the
    kernel's device time under the profiler (the small calls' queued time is
    the wrapper's host time), the plain time and the bound. The returned
    times and bounds are the sums over the two calls of a forward; the error
    is the largest bf16 one."""
    g = torch.Generator(device=dev).manual_seed(2)
    c = 256
    feats = tuple(
        torch.randn((BATCH, -(-BUCKET[0] // s), -(-BUCKET[1] // s), c), generator=g,
                    device=dev).to(torch.bfloat16)
        for s in (4, 8, 16, 32))
    feats32 = tuple(f.float() for f in feats)
    # the predict RoIs come first from the generator, so their inputs and bound
    # do not depend on the train shapes
    calls = [("predict box", _random_rois(g, dev, 1000), 7),
             ("predict mask", _random_rois(g, dev, 100), 14),
             ("train box", _random_rois(g, dev, 512), 7),
             ("train mask", _random_rois(g, dev, 128), 14)]
    gt = torch.cat([_random_rois(g, dev, 3), torch.zeros((BATCH, 97, 4), device=dev)], 1)
    calls.append(("train GT", gt.contiguous(), 14))
    regs = ptxas_registers("roi_align_fpn", "fpn_roi_align_kernel")
    print(f"[K4 fpn_roi_align] ptxas: {regs}")
    # bf16: f32 sums in another order than the plain version's, each rounded
    # once to bf16: at most one bf16 ulp apart, plus f32 slack near zero.
    # f32: the same sums in another order, 1e-5 of max|ref|
    rtol, atol = 2.0 ** -7, 1e-4
    out = {"name": "fpn_roi_align", "route": "cuda",
           "source": "upsnet_torch/csrc/roi_align_fpn.cu",
           "replaces": "upsnet_tpu/ops/roi_align_pallas.py:265",
           "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
           "bound_by": "bytes", "library_ms": None}
    sums = {"predict": [0.0] * 4, "train": [0.0] * 4}  # card, queued, device, bound
    for what, rois, pooled in calls:
        levels = (fpn_level_assignment(rois) - 2).to(torch.int32).contiguous()
        for dtype, fs in (("bf16", feats), ("f32", feats32)):
            run = lambda: roi_align_fpn.fpn_roi_align(fs, rois, levels, pooled)  # noqa: E731
            got, again = run(), run()
            ref = roi_align_fpn.fpn_roi_align_plain(fs, rois, levels, pooled)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"K4 {what} {dtype}: two runs on the same inputs differ")
            if dtype == "f32":
                tol = 1e-5 * float(ref.abs().max())
                max_abs, _ = compare(got, ref, 0.0, tol)
                print(f"[K4 fpn_roi_align] {what}, {rois.shape[1]} RoIs x2 at {pooled}x{pooled} "
                      f"f32: max abs err {max_abs:.3e} (tolerance {tol:.3e} = 1e-5 max|ref|); "
                      f"two runs bit-identical; kernel {time_ms(run):.4f} ms (queued "
                      f"{time_queued_ms(run):.4f})")
                continue
            max_abs, max_rel = compare(got, ref, rtol, atol)
            ms, queued = time_ms(run), time_queued_ms(run)
            dev_ms = device_ms(run, "fpn_roi_align_kernel")
            plain_ms = time_ms(
                lambda: roi_align_fpn.fpn_roi_align_plain(fs, rois, levels, pooled), 10)
            bound_ms, bound_by, n_bytes = _k4_bound(fs, rois, levels, pooled, c)
            print(f"[K4 fpn_roi_align] {what}, {rois.shape[1]} RoIs x2 at {pooled}x{pooled} "
                  f"bf16: max abs err {max_abs:.3e}, max rel err {max_rel:.3e} (tolerance "
                  f"{rtol:.4g}*|ref| + {atol:g}); two runs bit-identical; kernel {ms:.4f} ms "
                  f"(queued {queued:.4f}, device {dev_ms:.4f}), plain {plain_ms:.4f} ms, bound "
                  f"{bound_ms:.4f} ms ({bound_by}: {n_bytes / 1e6:.1f} MB)")
            out["max_abs_err"] = max(out["max_abs_err"], max_abs)
            phase = sums[what.split()[0]]
            for i, v in enumerate((ms, queued, dev_ms, bound_ms)):
                phase[i] += v
            if what.startswith("predict"):
                out["ms"] += ms
                out["plain_ms"] += plain_ms
                out["bound_ms"] += bound_ms
    for phase, (ms, queued, dev_ms, bound_ms) in sums.items():
        unit = "forward" if phase == "predict" else "step"
        print(f"[K4 fpn_roi_align] the calls of a {phase} {unit}, bf16: kernel {ms:.4f} ms ({100 * bound_ms / ms:.1f}% of the bound), queued "
              f"{queued:.4f} ms ({100 * bound_ms / queued:.1f}%), device {dev_ms:.4f} ms "
              f"({100 * bound_ms / dev_ms:.1f}%), bound {bound_ms:.4f} ms")
    return out


def _check_forward_taps(what: str, got, chain, ref, plain_tap, taps: int):
    """An all-tap forward kernel's output ``got`` on one input against
    ``chain``, the one-tap kernel launched per tap with the results added in
    y's dtype in tap order in the same run, and ``ref``, its plain version.

    ``got`` must equal ``chain`` (``torch.equal``, which compares values: a
    first tap of -0.0 may come out as +0.0). Against the plain version: the
    two chains round at the same 2K - 1 places (K taps, K - 1 adds), and
    their tap sums differ only in f32 order (one FMA per corner against a
    product and an add), so a rounding may land one bf16 ulp (2^-7
    relative) apart and carry on: |got - ref| <= 2^-7 * (sum_t |tap_t| +
    sum_{t>0} |partial_t|) + 1e-4, taps and partial sums from the plain
    chain (``plain_tap(t)``), the 1e-4 for f32 order near zero. In float32
    the tap sums' order moves a rounding by a few f32 ulps: 2^-20 * the same
    sum + 1e-5. Returns the max abs and rel error against ``ref``."""
    torch.cuda.synchronize()
    if not torch.isfinite(got.float()).all() or float(got.float().abs().max()) == 0.0:
        raise AssertionError(f"{what}: output not finite or all zero")
    if not torch.equal(got, chain):
        raise AssertionError(f"{what}: {int((got != chain).sum())} elements differ from the "
                             "one-tap chain")
    part, scale = None, torch.zeros(got.shape, dtype=torch.float32, device=got.device)
    for t in range(taps):
        tap = plain_tap(t)
        part = tap if part is None else part + tap
        scale += tap.float().abs() + (part.float().abs() if t else 0.0)
    if not torch.equal(part, ref):
        raise AssertionError(f"{what}: the plain version is not its own chain")
    err = (got.float() - ref.float()).abs()
    ulp, atol = (2.0 ** -7, 1e-4) if got.dtype == torch.bfloat16 else (2.0 ** -20, 1e-5)
    bad = err > ulp * scale + atol
    if bad.any():
        raise AssertionError(f"{what}: {int(bad.sum())} elements outside tolerance; max abs "
                             f"{float(err.max())}")
    return float(err.max()), float((err / ref.float().abs().clamp(min=1e-3)).max())


def check_k2_taps(dev) -> dict:
    """The all-tap K2 on a nine-tap layer at P2 of the 832x1344 bucket
    (9 x 2 x 208 x 336 x 128, bf16, tap-major), at two offset fields: +-2 px
    as in ``check_k1`` (3% at 6-12 px; its numbers are the returned ones) and
    uniform in +-40 px (the unclipped route's offsets after one update),
    each with 5% of the samples on integer rows, 5% on integer columns and
    1% beyond the image edge. Held against the one-tap K2 launched per tap
    with the adds (equal), and against the plain version; timed beside the
    one-tap chain, the plain version, and nine ``grid_sample`` calls and the
    adds. Then the float32 form of the kernel on the P3 layer (9 x 2 x 104 x
    168 x 128) at +-2 px, held the same way (the equality and the plain
    version's tolerance; not timed)."""
    g = torch.Generator(device=dev).manual_seed(13)
    taps, b, c = 9, BATCH, 128
    kk = torch.arange(taps, device=dev)
    ky = (kk // 3 - 1).float()[:, None, None, None]
    kx = (kk % 3 - 1).float()[:, None, None, None]

    def layer(h, w, dtype, field):
        """y, sy, sx of a nine-tap layer on an h x w map."""
        shape = (taps, b, h, w)
        iy = torch.arange(h, device=dev, dtype=torch.float32)[None, None, :, None]
        ix = torch.arange(w, device=dev, dtype=torch.float32)[None, None, None, :]
        y = torch.randn((taps, b, h, w, c), generator=g, device=dev).to(dtype)
        if field == "+-40 px":
            off_y = torch.rand(shape, generator=g, device=dev) * 80 - 40
            off_x = torch.rand(shape, generator=g, device=dev) * 80 - 40
        else:
            off_y, off_x = dcn_offsets(g, dev, shape), dcn_offsets(g, dev, shape)
        return (y, *_mark_integers(g, dev, iy + ky + off_y, ix + kx + off_x, h))

    def chain(y, sy, sx):  # the layer as the one-tap K2 did it: 9 launches, 8 adds
        out = deform_sample.deform_sample(y[0], sy[0], sx[0])
        for t in range(1, taps):
            out = out + deform_sample.deform_sample(y[t], sy[t], sx[t])
        return out

    def check(what, y, sy, sx):
        return _check_forward_taps(
            what, deform_sample.deform_sample_taps(y, sy, sx), chain(y, sy, sx),
            deform_sample.deform_sample_taps_plain(y, sy, sx),
            lambda t: deform_sample.deform_sample_plain(y[t], sy[t], sx[t]), taps)

    h, w = BUCKET[0] // 4, BUCKET[1] // 4
    row = {}
    for field in ("+-2 px", "+-40 px"):
        y, sy, sx = layer(h, w, torch.bfloat16, field)
        planes = [y[t].float().permute(0, 3, 1, 2).contiguous() for t in range(taps)]
        err, rel = check("K2 taps", y, sy, sx)
        grids = torch.stack([2 * sx / (w - 1) - 1, 2 * sy / (h - 1) - 1], dim=-1)

        def run():
            return deform_sample.deform_sample_taps(y, sy, sx)

        def library():  # on float32 copies (a bf16 grid cannot hold the coordinates)
            acc = F.grid_sample(planes[0], grids[0], mode="bilinear", padding_mode="zeros",
                                align_corners=True)
            for t in range(1, taps):
                acc = acc + F.grid_sample(planes[t], grids[t], mode="bilinear",
                                          padding_mode="zeros", align_corners=True)
            return acc

        ms = time_ms(run)
        queued = [time_queued_ms(f) for f in (run, lambda: chain(y, sy, sx))]
        chain_ms = time_ms(lambda: chain(y, sy, sx))
        plain_ms = time_ms(lambda: deform_sample.deform_sample_taps_plain(y, sy, sx), 3)
        library_ms = time_ms(library, 10)
        del grids, planes
        # bytes this run needs: the rows of each tap's projection its counted
        # samples touch, the coordinates, one output; 4 corners x 2 flops per
        # channel and sample, and the K - 1 adds
        n_rows, n_inside = touched_rows(sy, sx, h, w)
        n_out = b * h * w * c
        n_bytes = n_rows * c * 2 + 2 * sy.numel() * 4 + n_out * 2
        bound_ms, bound_by = bound(n_bytes, n_inside * 4 * 2 * c + (taps - 1) * n_out)
        print(f"[K2 deform_sample_taps] {field}, y {tuple(y.shape)} bf16: equal to 9 one-tap K2 "
              f"and 8 adds; against the plain version max abs err {err:.3e}, max rel err "
              f"{rel:.3e} (tolerance 2^-7 * (sum |tap| + sum |partial|) + 1e-4); kernel {ms:.4f} "
              f"ms, the one-tap chain {chain_ms:.4f} ms, plain {plain_ms:.4f} ms, 9x grid_sample "
              f"and adds {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
              f"{n_bytes / 1e6:.1f} MB), {100 * bound_ms / ms:.1f}% of it; {n_inside} counted "
              f"samples; 20 calls queued, per call: kernel {queued[0]:.4f} ms "
              f"({100 * bound_ms / queued[0]:.1f}% of the bound), the one-tap chain "
              f"{queued[1]:.4f} ms")
        if field == "+-2 px":
            row = {"name": "deform_sample_taps", "route": "cuda",
                   "source": "upsnet_torch/csrc/deform_sample.cu",
                   "replaces": "upsnet_tpu/ops/deform_conv_pallas.py:132",
                   "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by, "library_ms": library_ms}
        else:
            row["max_abs_err"] = max(row["max_abs_err"], err)
        del y, sy, sx
    y, sy, sx = layer(h // 2, w // 2, torch.float32, "+-2 px")
    err, rel = check("K2 taps float32", y, sy, sx)
    print(f"[K2 deform_sample_taps] +-2 px, y {tuple(y.shape)} float32: equal to 9 one-tap K2 "
          f"and 8 adds; against the plain version max abs err {err:.3e}, max rel err "
          f"{rel:.3e} (tolerance 2^-20 * (sum |tap| + sum |partial|) + 1e-5)")
    del y, sy, sx
    torch.cuda.empty_cache()
    return row


def check_k2_k3(dev) -> None:
    """K2 and K3 on one tap at P2 of the 832x1344 bucket (2x208x336, C=128,
    bf16), which is the largest of the four shapes a train step gives them:
    offsets as in ``check_k1`` (+-2 px, 3% far, 1% beyond the edge) with 5%
    of the samples on exactly integer rows and another 5% on integer
    columns, where the coordinate derivative must be zero. No route takes
    either one-tap form any more: they are checked and timed as the
    yardsticks of the all-tap forms."""
    g = torch.Generator(device=dev).manual_seed(4)
    b, c = BATCH, 128
    h, w = BUCKET[0] // 4, BUCKET[1] // 4
    shape = (b, h, w)
    y = torch.randn((b, h, w, c), generator=g, device=dev).to(torch.bfloat16)
    grad = torch.randn((b, h, w, c), generator=g, device=dev).to(torch.bfloat16)
    iy = torch.arange(h, device=dev, dtype=torch.float32)[None, :, None]
    ix = torch.arange(w, device=dev, dtype=torch.float32)[None, None, :]
    sy = iy + dcn_offsets(g, dev, shape)
    sx = ix + dcn_offsets(g, dev, shape)
    int_y = torch.rand(shape, generator=g, device=dev) < 0.05
    int_x = torch.rand(shape, generator=g, device=dev) < 0.05
    sy = torch.where(int_y, sy.round(), sy)
    sx = torch.where(int_x, sx.round(), sx).contiguous()
    edge = torch.rand(shape, generator=g, device=dev) < 0.01
    sy = torch.where(edge, sy + torch.where(sy < h / 2, -float(h), float(h)), sy).contiguous()

    # K2: the same four f32 products summed in another order, rounded once
    # to bf16: at most one bf16 ulp (2^-7 relative) apart, plus slack near 0
    rtol, atol = 2.0 ** -7, 1e-4
    got = deform_sample.deform_sample(y, sy, sx)
    ref = deform_sample.deform_sample_plain(y, sy, sx)
    torch.cuda.synchronize()
    k2_err, k2_rel = compare(got, ref, rtol, atol)
    print(f"[K2 deform_sample] y {tuple(y.shape)} bf16: max abs err {k2_err:.3e}, max rel "
          f"err {k2_rel:.3e} (tolerance {rtol:.4g}*|ref| + {atol:g})")

    # K3. grad_y: f32 canvas sums (atomics on the card, so their order
    # changes from run to run) rounded once to bf16: one bf16 ulp plus slack.
    # gsy, gsx: f32 sums of 4 x 128 products of O(1) values in another
    # order: 1e-4 relative plus 1e-3 absolute.
    got3 = deform_sample.deform_sample_bwd(y, sy, sx, grad)
    ref3 = deform_sample.deform_sample_bwd_plain(y, sy, sx, grad)
    torch.cuda.synchronize()
    k3_err, k3_rel = compare(got3[0], ref3[0], rtol, atol)
    c_rtol, c_atol = 1e-4, 1e-3
    gsy_err, _ = compare(got3[1], ref3[1], c_rtol, c_atol)
    gsx_err, _ = compare(got3[2], ref3[2], c_rtol, c_atol)
    at_int_y, at_int_x = sy == sy.round(), sx == sx.round()
    if float(got3[1][at_int_y].abs().max()) != 0.0 or float(got3[2][at_int_x].abs().max()) != 0.0:
        raise AssertionError("K3: non-zero coordinate gradient at an integer coordinate")
    if float(got3[1].abs().max()) == 0.0 or float(got3[2].abs().max()) == 0.0:
        raise AssertionError("K3: coordinate gradients are all zero")
    print(f"[K3 deform_sample_bwd] grad_y max abs err {k3_err:.3e}, max rel err "
          f"{k3_rel:.3e} (tolerance {rtol:.4g}*|ref| + {atol:g}); gsy / gsx max abs err "
          f"{gsy_err:.3e} / {gsx_err:.3e} (tolerance {c_rtol:g}*|ref| + {c_atol:g}); exactly 0 "
          f"at the {int(at_int_y.sum())} integer rows and {int(at_int_x.sum())} integer columns")

    # library yardsticks, on float32 copies made outside the timed calls (a
    # bf16 grid cannot hold the coordinates): one grid_sample call for K2,
    # and its backward op for K3. The latter differentiates one-sidedly at
    # integer coordinates and in normalised coordinates, so it is a
    # yardstick of speed only.
    grid = torch.stack([2 * sx / (w - 1) - 1, 2 * sy / (h - 1) - 1], dim=-1)
    y32 = y.float().permute(0, 3, 1, 2).contiguous()
    g32 = grad.float().permute(0, 3, 1, 2).contiguous()

    def lib_fwd():
        return F.grid_sample(y32, grid, mode="bilinear", padding_mode="zeros",
                             align_corners=True)

    def lib_bwd():
        return torch.ops.aten.grid_sampler_2d_backward(
            g32, y32, grid, 0, 0, True, [True, True])

    lib_err = float((lib_fwd().permute(0, 2, 3, 1) - ref.float()).abs().max())
    k2_ms = time_ms(lambda: deform_sample.deform_sample(y, sy, sx))
    k2_plain = time_ms(lambda: deform_sample.deform_sample_plain(y, sy, sx), 10)
    k2_lib = time_ms(lib_fwd)
    k3_ms = time_ms(lambda: deform_sample.deform_sample_bwd(y, sy, sx, grad))
    k3_plain = time_ms(lambda: deform_sample.deform_sample_bwd_plain(y, sy, sx, grad), 10)
    k3_lib = time_ms(lib_bwd)

    # bytes this run needs. K2: the rows of y its counted samples touch, the
    # coordinates, the output; 4 corners x 2 flops per channel. K3: those
    # rows, g, the coordinates, grad_y (bf16, every element written) and the
    # two coordinate gradients; 4 corners x 6 flops per channel.
    n_rows, n_inside = touched_rows(sy, sx, h, w)
    coords = 2 * sy.numel() * 4
    k2_bytes = n_rows * c * 2 + coords + got.numel() * 2
    k2_bound, k2_by = bound(k2_bytes, n_inside * 4 * 2 * c)
    k3_bytes = n_rows * c * 2 + grad.numel() * 2 + 2 * coords + y.numel() * 2
    k3_flops = n_inside * 4 * 6 * c
    k3_bound, k3_by = bound(k3_bytes, k3_flops)
    print(f"[K2 deform_sample] kernel {k2_ms:.4f} ms, plain {k2_plain:.4f} ms, grid_sample "
          f"{k2_lib:.4f} ms (max abs diff {lib_err:.3e}), bound {k2_bound:.4f} ms ({k2_by}: "
          f"{k2_bytes / 1e6:.1f} MB)")
    print(f"[K3 deform_sample_bwd] kernel {k3_ms:.4f} ms (zeroed canvas, kernel, cast), "
          f"plain {k3_plain:.4f} ms, grid_sampler_2d_backward {k3_lib:.4f} ms, bound "
          f"{k3_bound:.4f} ms ({k3_by}: {k3_bytes / 1e6:.1f} MB, {k3_flops / 1e9:.3f} GFLOP)")


def _clustered_rois(g, dev, n: int) -> torch.Tensor:
    """n RoIs per image the way training samples them: jittered copies of
    three ground-truth boxes of 60-400 px (centres moved by up to 15% of
    the side, sides scaled by 0.8-1.25), so that most of them overlap."""
    hh, ww = BUCKET
    side = torch.empty((BATCH, 3, 2), device=dev).uniform_(60.0, 400.0, generator=g)
    centre = torch.stack([torch.empty((BATCH, 3), device=dev).uniform_(0.0, ww, generator=g),
                          torch.empty((BATCH, 3), device=dev).uniform_(0.0, hh, generator=g)],
                         -1)
    pick = torch.randint(0, 3, (BATCH, n), generator=g, device=dev)
    side = torch.gather(side, 1, pick[..., None].expand(BATCH, n, 2))
    centre = torch.gather(centre, 1, pick[..., None].expand(BATCH, n, 2))
    centre = centre + side * torch.empty((BATCH, n, 2), device=dev).uniform_(
        -0.15, 0.15, generator=g)
    side = side * torch.empty((BATCH, n, 2), device=dev).uniform_(0.8, 1.25, generator=g)
    return torch.cat([centre - side / 2, centre + side / 2], -1).contiguous()


def check_k5(dev) -> dict:
    """K5 into a bf16 832x1344 pyramid (C=256), batch 2, for the three calls
    of one train step: 512 RoIs at 7x7 (box head), 128 at 14x14 (fg masks)
    and the 100 GT slots at 14x14 of the panoptic loss, of which 3 hold a
    box and the other 97 are padding as the loader pads them (the zero box,
    zero gradient), then once more for 512 RoIs at 7x7 clustered the way
    training samples them. Each call must give the same bits on two runs.
    The returned times and bounds are the sums over the three calls of a
    step; the error is the largest of all four."""
    g = torch.Generator(device=dev).manual_seed(5)
    c = 256
    shapes = [(BATCH, -(-BUCKET[0] // s), -(-BUCKET[1] // s), c) for s in (4, 8, 16, 32)]
    dtypes = [torch.bfloat16] * 4
    # overlapping RoIs add up to thousands of f32 terms per element, in
    # another order than the plain version's, then round once to bf16: one
    # bf16 ulp, plus 1e-3 where the terms cancel
    rtol, atol = 2.0 ** -7, 1e-3
    out = {"name": "fpn_roi_align_bwd", "route": "cuda",
           "source": "upsnet_torch/csrc/roi_align_fpn_bwd.cu",
           "replaces": "upsnet_tpu/ops/roi_align_pallas.py:465",
           "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
           "bound_by": "bytes", "library_ms": None}
    for n_rois, pooled, kind in ((512, 7, "step"), (128, 14, "step"), (100, 14, "GT slot"),
                                 (512, 7, "clustered")):
        rois = (_clustered_rois if kind == "clustered" else _random_rois)(g, dev, n_rois)
        grad = torch.randn((BATCH, n_rois, pooled, pooled, c), generator=g,
                           device=dev).to(torch.bfloat16)
        if kind == "GT slot":
            rois[:, 3:] = 0.0
            grad[:, 3:] = 0.0
        levels = (fpn_level_assignment(rois) - 2).to(torch.int32).contiguous()
        got = roi_align_fpn.fpn_roi_align_bwd(grad, rois, levels, shapes, dtypes)
        again = roi_align_fpn.fpn_roi_align_bwd(grad, rois, levels, shapes, dtypes)
        ref = roi_align_fpn.fpn_roi_align_bwd_plain(grad, rois, levels, shapes, dtypes)
        torch.cuda.synchronize()
        errs = [compare(a, r, rtol, atol) for a, r in zip(got, ref)]
        max_abs = max(e[0] for e in errs)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError("K5: two runs on the same inputs differ")
        if not any(float(a.abs().max()) > 0 for a in got):
            raise AssertionError("K5: all level gradients are zero")
        del again, ref
        ms = time_ms(lambda: roi_align_fpn.fpn_roi_align_bwd(grad, rois, levels, shapes,
                                                             dtypes))
        plain_ms = time_ms(lambda: roi_align_fpn.fpn_roi_align_bwd_plain(
            grad, rois, levels, shapes, dtypes), 10)
        # bytes: the gradient, RoIs and levels read, the four level gradients
        # (bf16) written in full; flops: 4 samples x 4 corners x 2 per element
        # of the RoIs with a gradient
        n_bytes = (grad.numel() * 2 + rois.numel() * 4 + levels.numel() * 4
                   + sum(math.prod(sh) for sh in shapes) * 2)
        live = int((grad.flatten(2).abs().amax(-1) > 0).sum())
        n_flops = live * pooled * pooled * c * (4 * 4 * 2 + 1)
        bound_ms, bound_by = bound(n_bytes, n_flops)
        print(f"[K5 fpn_roi_align_bwd] {n_rois} {kind} RoIs x2 at {pooled}x{pooled}: max abs "
              f"err {max_abs:.3e}, max rel err {max(e[1] for e in errs):.3e} (tolerance "
              f"{rtol:.4g}*|ref| + {atol:g}); two runs bit-identical; kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
              f"{n_bytes / 1e6:.1f} MB, {n_flops / 1e9:.3f} GFLOP)")
        out["max_abs_err"] = max(out["max_abs_err"], max_abs)
        if kind != "clustered":
            out["ms"] += ms
            out["plain_ms"] += plain_ms
            out["bound_ms"] += bound_ms
    print(f"[K5 fpn_roi_align_bwd] the three calls of a step: kernel {out['ms']:.4f} ms, bound "
          f"{out['bound_ms']:.4f} ms, {100 * out['bound_ms'] / out['ms']:.1f}% of it")
    return out


def check_k8(dev) -> tuple[dict, dict, dict]:
    """K8a, K8b, K8c at P2 of the 832x1344 bucket (2x208x336, 9 taps, C=128,
    bf16), the largest shape the shift route gives them: offsets as in
    ``check_k1`` (+-2 px, 3% at 6-12 px) clipped to +-6 on both axes as
    ``deform_conv2d_shift`` clips them, 5% of the samples on exactly integer
    rows and another 5% on integer columns (zero coordinate derivative
    there), and 1% pushed beyond the image edge (not counted, so they may
    lie beyond K8b's reach of 7)."""
    g = torch.Generator(device=dev).manual_seed(8)
    taps, b, c, max_d = 9, BATCH, 128, 6
    reach = max_d + 1  # max_dy + dilation
    h, w = BUCKET[0] // 4, BUCKET[1] // 4
    shape = (taps, b, h, w)
    y = torch.randn((b, h, w, taps * c), generator=g, device=dev).to(torch.bfloat16)
    grad = torch.randn((b, h, w, c), generator=g, device=dev).to(torch.bfloat16)
    kk = torch.arange(taps, device=dev)
    ky = (kk // 3 - 1).float()[:, None, None, None]
    kx = (kk % 3 - 1).float()[:, None, None, None]
    iy = torch.arange(h, device=dev, dtype=torch.float32)[None, None, :, None]
    ix = torch.arange(w, device=dev, dtype=torch.float32)[None, None, None, :]
    sy = iy + ky + clip_offsets(dcn_offsets(g, dev, shape), float(max_d))
    sx = ix + kx + clip_offsets(dcn_offsets(g, dev, shape), float(max_d))
    int_y = torch.rand(shape, generator=g, device=dev) < 0.05
    int_x = torch.rand(shape, generator=g, device=dev) < 0.05
    sy = torch.where(int_y, sy.round(), sy)
    sx = torch.where(int_x, sx.round(), sx).contiguous()
    edge = torch.rand(shape, generator=g, device=dev) < 0.01
    sy = torch.where(edge, sy + torch.where(sy < h / 2, -float(h), float(h)), sy).contiguous()
    deform_shift.check_reach(sy, sx, reach, reach)

    # K8a and K8b: f32 sums in another order than the plain version's, each
    # rounded once to bf16: at most one bf16 ulp (2^-7 relative) apart, plus
    # f32 slack near zero
    rtol, atol = 2.0 ** -7, 1e-4
    got_a = deform_shift.shift_fwd(y, sy, sx)
    ref_a = deform_shift.shift_fwd_plain(y, sy, sx)
    torch.cuda.synchronize()
    a_err, a_rel = compare(got_a, ref_a, rtol, atol)
    print(f"[K8a shift_fwd] y {tuple(y.shape)} bf16, {taps} taps: max abs err {a_err:.3e}, "
          f"max rel err {a_rel:.3e} (tolerance {rtol:.4g}*|ref| + {atol:g})")

    got_b = deform_shift.shift_adjoint(grad, sy, sx, reach, reach)
    again = deform_shift.shift_adjoint(grad, sy, sx, reach, reach)
    ref_b = deform_shift.shift_adjoint_plain(grad, sy, sx)
    torch.cuda.synchronize()
    b_err, b_rel = compare(got_b, ref_b, rtol, atol)
    if not torch.equal(got_b, again):
        raise AssertionError("K8b: two runs on the same inputs differ")
    if float(got_b.float().abs().max()) == 0.0:
        raise AssertionError("K8b: gradient to y is all zero")
    del again, ref_b
    print(f"[K8b shift_adjoint] gy {tuple(got_b.shape)} bf16: max abs err {b_err:.3e}, max "
          f"rel err {b_rel:.3e} (tolerance {rtol:.4g}*|ref| + {atol:g}); two runs "
          f"bit-identical")

    # K8c: f32 sums of 4 x 128 products of O(1) values in another order:
    # 1e-4 relative plus 1e-3 absolute
    c_rtol, c_atol = 1e-4, 1e-3
    got_c = deform_shift.shift_offset_grads(y, sy, sx, grad)
    ref_c = deform_shift.shift_offset_grads_plain(y, sy, sx, grad)
    torch.cuda.synchronize()
    gsy_err, _ = compare(got_c[0], ref_c[0], c_rtol, c_atol)
    gsx_err, _ = compare(got_c[1], ref_c[1], c_rtol, c_atol)
    at_int_y, at_int_x = sy == sy.round(), sx == sx.round()
    if float(got_c[0][at_int_y].abs().max()) != 0.0 or float(got_c[1][at_int_x].abs().max()) != 0.0:
        raise AssertionError("K8c: non-zero coordinate gradient at an integer coordinate")
    if float(got_c[0].abs().max()) == 0.0 or float(got_c[1].abs().max()) == 0.0:
        raise AssertionError("K8c: coordinate gradients are all zero")
    print(f"[K8c shift_offset_grads] gsy / gsx max abs err {gsy_err:.3e} / {gsx_err:.3e} "
          f"(tolerance {c_rtol:g}*|ref| + {c_atol:g}); exactly 0 at the "
          f"{int(at_int_y.sum())} integer rows and {int(at_int_x.sum())} integer columns; "
          f"digest {digest(*got_c)}")

    # library yardsticks on float32 copies made outside the timed calls (a
    # bf16 grid cannot hold the coordinates): 9 grid_sample calls and a sum
    # for K8a; 9 calls of its backward op for K8b (gradient to the input)
    # and 9 for K8c (gradient to the grid; one-sided at integer coordinates
    # and in normalised coordinates, so a yardstick of speed only)
    grids = torch.stack([2 * sx / (w - 1) - 1, 2 * sy / (h - 1) - 1], dim=-1)
    y_taps = y.view(b, h, w, taps, c)
    planes = [y_taps[:, :, :, t].float().permute(0, 3, 1, 2).contiguous() for t in range(taps)]
    g32 = grad.float().permute(0, 3, 1, 2).contiguous()

    def lib_fwd():
        acc = F.grid_sample(planes[0], grids[0], mode="bilinear", padding_mode="zeros",
                            align_corners=True)
        for t in range(1, taps):
            acc += F.grid_sample(planes[t], grids[t], mode="bilinear", padding_mode="zeros",
                                 align_corners=True)
        return acc

    def lib_bwd(mask):
        return [torch.ops.aten.grid_sampler_2d_backward(g32, planes[t], grids[t], 0, 0, True,
                                                        mask) for t in range(taps)]

    lib_err = float((lib_fwd().permute(0, 2, 3, 1) - ref_a.float()).abs().max())
    # K8a runs K1's body: K1 on the same side-by-side data, for its bits and
    # its time beside K8a's
    k1 = lambda: deform_sample.deform_sample9(y_taps, sy, sx, tap_axis=3)  # noqa: E731
    if not torch.equal(k1(), got_a):
        raise AssertionError("K8a and K1 differ on the same side-by-side data")
    a_ms = time_ms(lambda: deform_shift.shift_fwd(y, sy, sx))
    a_queued = time_queued_ms(lambda: deform_shift.shift_fwd(y, sy, sx))
    a_dev = device_ms(lambda: deform_shift.shift_fwd(y, sy, sx), "shift_fwd_kernel")
    k1_ms, k1_queued = time_ms(k1), time_queued_ms(k1)
    k1_dev = device_ms(k1, "deform_sample9_kernel")
    a_plain = time_ms(lambda: deform_shift.shift_fwd_plain(y, sy, sx), 10)
    a_lib = time_ms(lib_fwd)
    b_ms = time_ms(lambda: deform_shift.shift_adjoint(grad, sy, sx, reach, reach))
    b_plain = time_ms(lambda: deform_shift.shift_adjoint_plain(grad, sy, sx), 10)
    b_lib = time_ms(lambda: lib_bwd([True, False]), 10)
    c_ms = time_ms(lambda: deform_shift.shift_offset_grads(y, sy, sx, grad))
    c_plain = time_ms(lambda: deform_shift.shift_offset_grads_plain(y, sy, sx, grad), 10)
    c_lib = time_ms(lambda: lib_bwd([False, True]), 10)

    # bytes this run needs. K8a: the tap blocks of y its counted samples
    # touch, the coordinates, the output; 4 corners x 2 flops per channel.
    # K8b: g and the coordinates read, gy written in full (bf16); 2 flops per
    # channel and hit. K8c: the touched blocks, g, the coordinates, the two
    # gradient fields; 4 corners x 2 flops per channel.
    n_rows, n_inside = touched_rows(sy, sx, h, w)
    coords = 2 * sy.numel() * 4
    a_bytes = n_rows * c * 2 + coords + got_a.numel() * 2
    a_bound, a_by = bound(a_bytes, n_inside * 4 * 2 * c)
    b_bytes = grad.numel() * 2 + coords + got_b.numel() * 2
    b_bound, b_by = bound(b_bytes, n_inside * 4 * 2 * c)
    c_bytes = n_rows * c * 2 + grad.numel() * 2 + 2 * coords
    c_bound, c_by = bound(c_bytes, n_inside * 4 * 2 * c)
    print(f"[K8a shift_fwd] kernel {a_ms:.4f} ms ({100 * a_bound / a_ms:.1f}% of the bound; "
          f"queued {a_queued:.4f}, device {a_dev:.4f}), K1 side by side on the same data "
          f"{k1_ms:.4f} ms (queued {k1_queued:.4f}, device {k1_dev:.4f}), the same bits; plain "
          f"{a_plain:.4f} ms, 9x grid_sample "
          f"{a_lib:.4f} ms (max abs diff {lib_err:.3e}), bound {a_bound:.4f} ms ({a_by}: "
          f"{a_bytes / 1e6:.1f} MB)")
    print(f"[K8a shift_fwd] ptxas: {ptxas_registers('deform_shift', 'shift_fwd_kernel')}; K1: "
          f"{ptxas_registers('deform_sample', 'deform_sample9_kernel')}")
    print(f"[K8b shift_adjoint] kernel {b_ms:.4f} ms (the row-band gather), plain "
          f"{b_plain:.4f} ms, 9x grid_sampler_2d_backward (input) {b_lib:.4f} ms, bound "
          f"{b_bound:.4f} ms ({b_by}: {b_bytes / 1e6:.1f} MB), {100 * b_bound / b_ms:.1f}% of it")
    print(f"[K8c shift_offset_grads] kernel {c_ms:.4f} ms, plain {c_plain:.4f} ms, 9x "
          f"grid_sampler_2d_backward (grid) {c_lib:.4f} ms, bound {c_bound:.4f} ms ({c_by}: "
          f"{c_bytes / 1e6:.1f} MB)")
    line = "upsnet_tpu/ops/deform_shift_pallas.py"
    k8a = {"name": "shift_fwd", "route": "cuda",
           "source": "upsnet_torch/csrc/deform_shift.cu", "replaces": f"{line}:167",
           "max_abs_err": a_err, "ms": a_ms, "plain_ms": a_plain, "bound_ms": a_bound,
           "bound_by": a_by, "library_ms": a_lib}
    k8b = {"name": "shift_adjoint", "route": "cuda",
           "source": "upsnet_torch/csrc/deform_sample_bwd.cu", "replaces": f"{line}:308",
           "max_abs_err": b_err, "ms": b_ms, "plain_ms": b_plain, "bound_ms": b_bound,
           "bound_by": b_by, "library_ms": b_lib}
    k8c = {"name": "shift_offset_grads", "route": "cuda",
           "source": "upsnet_torch/csrc/deform_shift.cu", "replaces": f"{line}:460",
           "max_abs_err": max(gsy_err, gsx_err), "ms": c_ms, "plain_ms": c_plain,
           "bound_ms": c_bound, "bound_by": c_by, "library_ms": c_lib}
    return k8a, k8b, k8c


def _mark_integers(g, dev, sy, sx, h: int):
    """5% of the samples onto exactly integer rows, another 5% onto integer
    columns, and 1% pushed beyond the image edge (not counted)."""
    shape = sy.shape
    int_y = torch.rand(shape, generator=g, device=dev) < 0.05
    int_x = torch.rand(shape, generator=g, device=dev) < 0.05
    sy = torch.where(int_y, sy.round(), sy)
    sx = torch.where(int_x, sx.round(), sx).contiguous()
    edge = torch.rand(shape, generator=g, device=dev) < 0.01
    sy = torch.where(edge, sy + torch.where(sy < h / 2, -float(h), float(h)), sy)
    return sy.contiguous(), sx


def _check_taps_backward(what: str, run, ref, sy, sx, tag: str):
    """An all-tap K3 form against its plain version ``ref`` on one input:
    ``run()`` twice, the same bits both times, exact zeros at integer
    coordinates. grad_y: f32 sums in another order than the plain
    version's, rounded once to bf16: one bf16 ulp plus slack near zero.
    gsy, gsx: f32 sums of 4 x 128 products of O(1) values in another order:
    1e-4 relative plus 1e-3 absolute. Returns the grad_y max abs and rel
    errors and the gsy, gsx max abs errors."""
    rtol, atol, c_rtol, c_atol = 2.0 ** -7, 1e-4, 1e-4, 1e-3
    got, again = run(), run()
    torch.cuda.synchronize()
    gy_err, gy_rel = compare(got[0], ref[0], rtol, atol)
    gsy_err, _ = compare(got[1], ref[1], c_rtol, c_atol)
    gsx_err, _ = compare(got[2], ref[2], c_rtol, c_atol)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{what}: two runs on the same inputs differ")
    at_int_y, at_int_x = sy == sy.round(), sx == sx.round()
    if (float(got[1][at_int_y].abs().max()) != 0.0
            or float(got[2][at_int_x].abs().max()) != 0.0):
        raise AssertionError(f"{what}: non-zero coordinate gradient at an integer coordinate")
    if float(got[1].abs().max()) == 0.0 or float(got[0].float().abs().max()) == 0.0:
        raise AssertionError(f"{what}: gradients are all zero")
    print(f"{tag}: grad_y max abs err {gy_err:.3e}, max rel err {gy_rel:.3e} (tolerance "
          f"{rtol:.4g}*|ref| + {atol:g}); gsy / gsx max abs err {gsy_err:.3e} / "
          f"{gsx_err:.3e} (tolerance {c_rtol:g}*|ref| + {c_atol:g}); two runs bit-identical, "
          f"digest {digest(*got)}; exactly 0 at the {int(at_int_y.sum())} integer rows and "
          f"{int(at_int_x.sum())} integer columns")
    return gy_err, gy_rel, gsy_err, gsx_err


def check_k3_taps(dev) -> dict:
    """The all-tap K3 on a nine-tap layer with dy and dx clipped to +-6
    (reach 7), C 128, bf16: tap-major at P2 of the 832x1344 bucket
    (9 x 2 x 208 x 336, the untiled ``pallas`` route; its numbers are the
    returned ones) and side by side at P2 of the wide canvas
    (1 x 208 x 832 x 9, the tiled form). Offsets as in ``check_k1`` (+-2 px,
    3% at 6-12 px) before the clip, 5% of the samples on integer rows, 5% on
    integer columns (zero coordinate derivative there), 1% beyond the image
    edge; two runs must give the same bits. Timed beside it in the same run:
    the one-tap K3 nine times on the same tap-major layer plus the stack
    that autograd made of its results, which is what the layer cost in the
    one-tap form."""
    g = torch.Generator(device=dev).manual_seed(9)
    taps, c, max_d = 9, 128, 6
    reach = max_d + 1  # max_dy + half * dilation
    kk = torch.arange(taps, device=dev)
    ky = (kk // 3 - 1).float()[:, None, None, None]
    kx = (kk % 3 - 1).float()[:, None, None, None]
    row = {}
    for tag, b, (h, w) in (("P2 tap-major", BATCH, (BUCKET[0] // 4, BUCKET[1] // 4)),
                           ("wide P2 side by side", WIDE_BATCH,
                            (WIDE_BUCKET[0] // 4, WIDE_BUCKET[1] // 4))):
        tap_axis = 0 if tag.endswith("tap-major") else 3
        shape = (taps, b, h, w)
        y = torch.randn((taps, b, h, w, c), generator=g, device=dev).to(torch.bfloat16)
        if tap_axis == 3:
            y = y.permute(1, 2, 3, 0, 4).contiguous()
        grad = torch.randn((b, h, w, c), generator=g, device=dev).to(torch.bfloat16)
        iy = torch.arange(h, device=dev, dtype=torch.float32)[None, None, :, None]
        ix = torch.arange(w, device=dev, dtype=torch.float32)[None, None, None, :]
        sy = iy + ky + clip_offsets(dcn_offsets(g, dev, shape), float(max_d))
        sx = ix + kx + clip_offsets(dcn_offsets(g, dev, shape), float(max_d))
        sy, sx = _mark_integers(g, dev, sy, sx, h)
        deform_sample.check_reach(sy, sx, reach, None)

        gy_err, gy_rel, gsy_err, gsx_err = _check_taps_backward(
            "K3 taps", lambda: deform_sample.deform_sample_bwd_taps(y, sy, sx, grad, reach,
                                                                    tap_axis),
            deform_sample.deform_sample_bwd_taps_plain(y, sy, sx, grad, reach, tap_axis), sy, sx,
            f"[K3 deform_sample_bwd_taps] {tag}, y {tuple(y.shape)} bf16")
        ms = time_ms(lambda: deform_sample.deform_sample_bwd_taps(y, sy, sx, grad, reach,
                                                                  tap_axis))
        plain_ms = time_ms(lambda: deform_sample.deform_sample_bwd_taps_plain(
            y, sy, sx, grad, reach, tap_axis), 3)

        # library yardstick: 9 calls of grid_sample's backward op on float32
        # copies made outside the timed call (one-sided at integer
        # coordinates and in normalised coordinates: speed only)
        grids = torch.stack([2 * sx / (w - 1) - 1, 2 * sy / (h - 1) - 1], dim=-1)
        planes = [y.select(tap_axis, t).float().permute(0, 3, 1, 2).contiguous()
                  for t in range(taps)]
        g32 = grad.float().permute(0, 3, 1, 2).contiguous()
        library_ms = time_ms(lambda: [torch.ops.aten.grid_sampler_2d_backward(
            g32, planes[t], grids[t], 0, 0, True, [True, True]) for t in range(taps)], 10)
        del planes, g32, grids

        # bytes this run needs: the rows of each tap's projection its counted
        # samples touch, g once for all taps, the coordinates, grad_y (bf16,
        # every element written once) and the coordinate gradients; 4 corners
        # x 6 flops per channel
        n_rows, n_inside = touched_rows(sy, sx, h, w)
        coords = 2 * sy.numel() * 4
        n_bytes = n_rows * c * 2 + grad.numel() * 2 + 2 * coords + y.numel() * 2
        bound_ms, bound_by = bound(n_bytes, n_inside * 4 * 6 * c)
        line = (f"[K3 deform_sample_bwd_taps] {tag}: kernel {ms:.4f} ms (2 launches), plain "
                f"{plain_ms:.4f} ms, 9x grid_sampler_2d_backward {library_ms:.4f} ms, bound "
                f"{bound_ms:.4f} ms ({bound_by}: {n_bytes / 1e6:.1f} MB), "
                f"{100 * bound_ms / ms:.1f}% of it")
        if tap_axis == 0:
            # the layer as the one-tap K3 did it: nine zeroed canvases, nine
            # launches, nine casts, and autograd's stack of the nine results
            def pertap():
                return torch.stack([deform_sample.deform_sample_bwd(y[t], sy[t], sx[t], grad)[0]
                                    for t in range(taps)])
            pertap_ms = time_ms(pertap, 10)
            line += f"; the same layer by 9 one-tap K3 and the stack: {pertap_ms:.4f} ms"
            row = {"name": "deform_sample_bwd_taps", "route": "cuda",
                   "source": "upsnet_torch/csrc/deform_sample_bwd.cu",
                   "replaces": "upsnet_tpu/ops/deform_conv_pallas.py:637",
                   "max_abs_err": max(gy_err, gsy_err, gsx_err), "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                   "library_ms": library_ms}
        print(line)
        del y, grad, sy, sx
        torch.cuda.empty_cache()
    return row


def check_k3_unclipped(dev) -> dict:
    """The unclipped all-tap K3 on a nine-tap layer of the ``auto`` and
    ``gather`` routes at P2 of the 832x1344 bucket (9 x 2 x 208 x 336,
    tap-major, C 128, bf16), at two offset fields, neither clipped: ``in
    window``, as in ``check_k1`` (+-2 px, 3% at 6-12 px; its numbers are the
    returned ones), and ``far``, uniform in +-40 px (as far as the train
    steps drive them after one update); each with 5% of the samples on
    integer rows, 5% on integer columns and 1% beyond the image edge. Two
    runs must give the same bits. Timed beside it at each field: the layer
    as the one-tap K3 did it (nine zeroed canvases, launches and casts, and
    the stack of the nine results)."""
    g = torch.Generator(device=dev).manual_seed(10)
    taps, b, c = 9, BATCH, 128
    h, w = BUCKET[0] // 4, BUCKET[1] // 4
    shape = (taps, b, h, w)
    kk = torch.arange(taps, device=dev)
    ky = (kk // 3 - 1).float()[:, None, None, None]
    kx = (kk % 3 - 1).float()[:, None, None, None]
    iy = torch.arange(h, device=dev, dtype=torch.float32)[None, None, :, None]
    ix = torch.arange(w, device=dev, dtype=torch.float32)[None, None, None, :]
    y = torch.randn((taps, b, h, w, c), generator=g, device=dev).to(torch.bfloat16)
    grad = torch.randn((b, h, w, c), generator=g, device=dev).to(torch.bfloat16)
    g32 = grad.float().permute(0, 3, 1, 2).contiguous()
    planes = [y[t].float().permute(0, 3, 1, 2).contiguous() for t in range(taps)]
    row = {}
    for field in ("in window", "far"):
        if field == "far":
            off_y = torch.rand(shape, generator=g, device=dev) * 80 - 40
            off_x = torch.rand(shape, generator=g, device=dev) * 80 - 40
        else:
            off_y, off_x = dcn_offsets(g, dev, shape), dcn_offsets(g, dev, shape)
        sy, sx = _mark_integers(g, dev, iy + ky + off_y, ix + kx + off_x, h)
        tag = f"[K3 deform_sample_bwd_unclipped] {field}, y {tuple(y.shape)} bf16"
        errs = _check_taps_backward(
            "K3 unclipped", lambda: deform_sample.deform_sample_bwd_unclipped(y, sy, sx, grad),
            deform_sample.deform_sample_bwd_taps_plain(y, sy, sx, grad, None), sy, sx, tag)
        ms = time_ms(lambda: deform_sample.deform_sample_bwd_unclipped(y, sy, sx, grad))
        plain_ms = time_ms(
            lambda: deform_sample.deform_sample_bwd_taps_plain(y, sy, sx, grad, None), 3)

        def pertap():
            return torch.stack([deform_sample.deform_sample_bwd(y[t], sy[t], sx[t], grad)[0]
                                for t in range(taps)])

        pertap_ms = time_ms(pertap, 10)
        # library yardstick: 9 calls of grid_sample's backward op on float32
        # copies made outside the timed call (one-sided at integer
        # coordinates and in normalised coordinates: speed only)
        grids = torch.stack([2 * sx / (w - 1) - 1, 2 * sy / (h - 1) - 1], dim=-1)
        library_ms = time_ms(lambda: [torch.ops.aten.grid_sampler_2d_backward(
            g32, planes[t], grids[t], 0, 0, True, [True, True]) for t in range(taps)], 10)
        del grids
        # bytes this run needs: the rows of each tap's projection its counted
        # samples touch, g once for all taps, the coordinates, grad_y (bf16,
        # every element written once) and the coordinate gradients; 4
        # corners x 6 flops per channel
        n_rows, n_inside = touched_rows(sy, sx, h, w)
        coords = 2 * sy.numel() * 4
        n_bytes = n_rows * c * 2 + grad.numel() * 2 + 2 * coords + y.numel() * 2
        bound_ms, bound_by = bound(n_bytes, n_inside * 4 * 6 * c)
        print(f"{tag}: kernel {ms:.4f} ms (sort, gather and coordinate pass), plain "
              f"{plain_ms:.4f} ms, 9x grid_sampler_2d_backward {library_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}: {n_bytes / 1e6:.1f} MB), {100 * bound_ms / ms:.1f}% "
              f"of it; {n_inside} counted samples; the same layer by 9 one-tap K3 and the "
              f"stack: {pertap_ms:.4f} ms")
        if field == "in window":
            row = {"name": "deform_sample_bwd_unclipped", "route": "cuda",
                   "source": "upsnet_torch/csrc/deform_sample_bwd.cu",
                   "replaces": "upsnet_tpu/ops/deform_conv_pallas.py:637",
                   "max_abs_err": max(errs[0], errs[2], errs[3]), "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                   "library_ms": library_ms}
        del sy, sx
    del y, grad, g32, planes
    torch.cuda.empty_cache()
    return row


def check_k6(dev) -> dict:
    """K6 at P2 of the wide canvas (1 x 208 x 832, C 128, bf16) on the
    nine-tap one-matmul projection (1, 208, 832, 9, 128): offsets as in
    ``check_k1`` (+-2 px, 3% at 6-12 px) clipped to +-6 on both axes as the
    tiled form clips them, 5% of the samples on integer rows, 5% on integer
    columns, 1% beyond the image edge (not counted, so beyond the reach).
    The all-tap K6 (its numbers are the returned ones) is held against nine
    one-tap K6 launches with the adds (equal) and its plain version, and
    timed beside them and nine ``grid_sample`` calls and the adds; then its
    float32 form, held the same way on the wide P3 layer (1 x 104 x 416 x 9
    x 128, not timed). The one-tap K6, on no route since the all-tap form
    took the layer, is held against its plain version on tap 4 and timed as
    the yardstick of one launch."""
    g = torch.Generator(device=dev).manual_seed(6)
    taps, tap, c, max_d = 9, 4, 128, 6
    reach = max_d + 1  # max_dy + dilation
    b, (h, w) = WIDE_BATCH, (WIDE_BUCKET[0] // 4, WIDE_BUCKET[1] // 4)
    if deform_sample.pallas_route((b, h, w, c), c, max_d, 1) != ("tiled", max_d):
        raise AssertionError(f"pallas_route does not tile a {h}x{w} map")
    shape = (taps, b, h, w)
    y = torch.randn((b, h, w, taps, c), generator=g, device=dev).to(torch.bfloat16)
    kk = torch.arange(taps, device=dev)
    ky = (kk // 3 - 1).float()[:, None, None, None]
    kx = (kk % 3 - 1).float()[:, None, None, None]
    iy = torch.arange(h, device=dev, dtype=torch.float32)[None, None, :, None]
    ix = torch.arange(w, device=dev, dtype=torch.float32)[None, None, None, :]
    sy = iy + ky + clip_offsets(dcn_offsets(g, dev, shape), float(max_d))
    sx = ix + kx + clip_offsets(dcn_offsets(g, dev, shape), float(max_d))
    sy, sx = _mark_integers(g, dev, sy, sx, h)
    deform_sample.check_reach(sy, sx, reach, reach)

    # the one-tap K6 on tap 4: the same four f32 products summed in another
    # order, rounded once to bf16: at most one bf16 ulp (2^-7 relative)
    # apart, plus slack near 0
    rtol, atol = 2.0 ** -7, 1e-4
    sy4, sx4 = sy[tap], sx[tap]
    one = deform_sample.deform_sample_tiled(y, tap, sy4, sx4, reach, reach)
    one_ref = deform_sample.deform_sample_tiled_plain(y, tap, sy4, sx4, reach, reach)
    torch.cuda.synchronize()
    one_err, one_rel = compare(one, one_ref, rtol, atol)
    if float(one.float().abs().max()) == 0.0:
        raise AssertionError("K6: output is all zero")
    one_ms = time_ms(lambda: deform_sample.deform_sample_tiled(y, tap, sy4, sx4, reach, reach))
    del one, one_ref
    print(f"[K6 deform_sample_tiled] one tap ({tap}) of y {tuple(y.shape)} bf16: max abs err "
          f"{one_err:.3e}, max rel err {one_rel:.3e} (tolerance {rtol:.4g}*|ref| + {atol:g}); "
          f"kernel {one_ms:.4f} ms")

    def run():
        return deform_sample.deform_sample_tiled_taps(y, sy, sx, reach, reach)

    def chain():  # the layer as the one-tap K6 did it: 9 launches, 8 adds
        out = deform_sample.deform_sample_tiled(y, 0, sy[0], sx[0], reach, reach)
        for t in range(1, taps):
            out = out + deform_sample.deform_sample_tiled(y, t, sy[t], sx[t], reach, reach)
        return out

    got = run()
    err, rel = _check_forward_taps(
        "K6 taps", got, chain(),
        deform_sample.deform_sample_tiled_taps_plain(y, sy, sx, reach, reach),
        lambda t: deform_sample.deform_sample_plain(y[:, :, :, t], sy[t], sx[t]), taps)

    # library yardstick: 9 grid_sample calls on float32 copies of the taps'
    # blocks, made outside the timed call (a bf16 grid cannot hold the
    # coordinates), and the adds
    grids = torch.stack([2 * sx / (w - 1) - 1, 2 * sy / (h - 1) - 1], dim=-1)
    planes = [y[:, :, :, t].float().permute(0, 3, 1, 2).contiguous() for t in range(taps)]

    def library():
        acc = F.grid_sample(planes[0], grids[0], mode="bilinear", padding_mode="zeros",
                            align_corners=True)
        for t in range(1, taps):
            acc = acc + F.grid_sample(planes[t], grids[t], mode="bilinear",
                                      padding_mode="zeros", align_corners=True)
        return acc

    ms = time_ms(run)
    queued = [time_queued_ms(f) for f in (run, chain)]
    chain_ms = time_ms(chain)
    plain_ms = time_ms(
        lambda: deform_sample.deform_sample_tiled_taps_plain(y, sy, sx, reach, reach), 3)
    library_ms = time_ms(library, 10)
    # bytes: the rows of each tap's block the counted samples touch, the
    # coordinates, one output; 4 corners x 2 flops per channel and sample,
    # and the K - 1 adds
    n_rows, n_inside = touched_rows(sy, sx, h, w)
    n_bytes = n_rows * c * 2 + 2 * sy.numel() * 4 + got.numel() * 2
    bound_ms, bound_by = bound(n_bytes, n_inside * 4 * 2 * c + (taps - 1) * got.numel())
    print(f"[K6 deform_sample_tiled_taps] y {tuple(y.shape)} bf16: equal to 9 one-tap K6 and 8 "
          f"adds; against the plain version max abs err {err:.3e}, max rel err {rel:.3e} "
          f"(tolerance 2^-7 * (sum |tap| + sum |partial|) + 1e-4); kernel {ms:.4f} ms, the "
          f"one-tap chain {chain_ms:.4f} ms, plain {plain_ms:.4f} ms, 9x grid_sample and adds "
          f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: {n_bytes / 1e6:.1f} MB), "
          f"{100 * bound_ms / ms:.1f}% of it; 20 calls queued, per call: kernel "
          f"{queued[0]:.4f} ms ({100 * bound_ms / queued[0]:.1f}% of the bound), the one-tap "
          f"chain {queued[1]:.4f} ms")
    del y, sy, sx, planes, grids, got

    # float32 at the wide P3 layer
    h, w = h // 2, w // 2
    y = torch.randn((b, h, w, taps, c), generator=g, device=dev)
    iy = torch.arange(h, device=dev, dtype=torch.float32)[None, None, :, None]
    ix = torch.arange(w, device=dev, dtype=torch.float32)[None, None, None, :]
    sy = iy + ky + clip_offsets(dcn_offsets(g, dev, (taps, b, h, w)), float(max_d))
    sx = ix + kx + clip_offsets(dcn_offsets(g, dev, (taps, b, h, w)), float(max_d))
    sy, sx = _mark_integers(g, dev, sy, sx, h)
    f32_err, f32_rel = _check_forward_taps(
        "K6 taps float32", run(), chain(),
        deform_sample.deform_sample_tiled_taps_plain(y, sy, sx, reach, reach),
        lambda t: deform_sample.deform_sample_plain(y[:, :, :, t], sy[t], sx[t]), taps)
    print(f"[K6 deform_sample_tiled_taps] y {tuple(y.shape)} float32: equal to 9 one-tap K6 "
          f"and 8 adds; against the plain version max abs err {f32_err:.3e}, max rel err "
          f"{f32_rel:.3e} (tolerance 2^-20 * (sum |tap| + sum |partial|) + 1e-5)")
    del y, sy, sx
    torch.cuda.empty_cache()
    return {"name": "deform_sample_tiled_taps", "route": "cuda",
            "source": "upsnet_torch/csrc/deform_sample_tiled.cu",
            "replaces": "upsnet_tpu/ops/deform_conv_pallas.py:429",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


# K7b's kernels as the profiler names them: the sort's five, then the
# gather (grad_x) and the coordinate pass
K7B_SORT = ("mt_bwd_count_kernel", "mt_bwd_scan_tiles_kernel", "mt_bwd_scan_totals_kernel",
            "mt_bwd_place_kernel", "mt_bwd_rank_kernel")
K7B_KERNELS = K7B_SORT + ("mt_bwd_gather_kernel", "mt_bwd_coords_kernel")


def _k7_fields(dev) -> list:
    """The coordinate fields of ``check_k7``, (K, B, H, W) = (9, 2, 208, 336),
    P2 of the 832x1344 bucket: ``+-2 px``, offsets uniform in +-2 px around
    each tap (its numbers are the kernels line's); ``+-40 px dx``, dx
    uniform in +-40 px and dy in +-6 px around each tap (within
    +-(max_dy + 1) rows of the pixel, as ``deform_conv2d_mt``'s clamp leaves
    it); ``shared corner``, all nine taps of a pixel at one point within
    +-2 px of it (offsets -kernel_offset + a constant a pixel: the pixel's
    nine samples in one bin, the worst case for K7b's rank key). In each,
    the samples of the first 16 rows lie on exactly integer rows and those
    of the first 16 columns on integer columns (zero coordinate derivative
    there), and 1% are pushed beyond the image edge. Returns
    [(name, sy, sx)]."""
    g = torch.Generator(device=dev).manual_seed(7)
    taps, b = 9, BATCH
    h, w = BUCKET[0] // 4, BUCKET[1] // 4
    shape = (taps, b, h, w)
    kk = torch.arange(taps, device=dev)
    ky = (kk // 3 - 1).float()[:, None, None, None]
    kx = (kk % 3 - 1).float()[:, None, None, None]
    iy = torch.arange(h, device=dev, dtype=torch.float32)[None, None, :, None]
    ix = torch.arange(w, device=dev, dtype=torch.float32)[None, None, None, :]
    fields = []
    for name in ("+-2 px", "+-40 px dx", "shared corner"):
        if name == "+-2 px":
            sy = iy + ky + torch.rand(shape, generator=g, device=dev) * 4 - 2
            sx = ix + kx + torch.rand(shape, generator=g, device=dev) * 4 - 2
        elif name == "+-40 px dx":
            sy = iy + ky + torch.rand(shape, generator=g, device=dev) * 12 - 6
            sx = ix + kx + torch.rand(shape, generator=g, device=dev) * 80 - 40
        else:
            one = (1, b, h, w)
            sy = (iy + torch.rand(one, generator=g, device=dev) * 4 - 2).expand(shape).clone()
            sx = (ix + torch.rand(one, generator=g, device=dev) * 4 - 2).expand(shape).clone()
        sy[:, :, :16] = sy[:, :, :16].round()
        sx[:, :, :, :16] = sx[:, :, :, :16].round()
        edge = torch.rand(shape, generator=g, device=dev) < 0.01
        sy = torch.where(edge, sy + torch.where(sy < h / 2, -float(h), float(h)), sy)
        fields.append((name, sy.contiguous(), sx.contiguous()))
    return fields


def _k7_touched(sy, sx) -> tuple[int, int]:
    """``touched_rows`` of a K7 field: all taps read one x, so distinct rows
    per image, over the taps."""
    taps, b, h, w = sy.shape
    return touched_rows(sy.transpose(0, 1).reshape(b, taps * h, w),
                        sx.transpose(0, 1).reshape(b, taps * h, w), h, w)


def _k7_library(x, sy, sx, grad=None):
    """The library yardstick on float32 copies made outside the timed calls:
    9 grid_sample calls on x (K7a's), or for an upstream gradient ``grad`` 9
    calls of its backward op (K7b's; one-sided at integer coordinates and in
    normalised coordinates, so a yardstick of speed only)."""
    taps, b, h, w = sy.shape
    grids = torch.stack([2 * sx / (w - 1) - 1, 2 * sy / (h - 1) - 1], dim=-1)
    x32 = x.float().permute(0, 3, 1, 2).contiguous()
    if grad is None:
        return lambda: [F.grid_sample(x32, grids[t], mode="bilinear", padding_mode="zeros",
                                      align_corners=True) for t in range(taps)]
    g32 = [grad[:, :, :, t].float().permute(0, 3, 1, 2).contiguous() for t in range(taps)]
    return lambda: [torch.ops.aten.grid_sampler_2d_backward(
        g32[t], x32, grids[t], 0, 0, True, [True, True]) for t in range(taps)]


def check_k7a(dev, fields) -> dict:
    """K7a on each field of ``_k7_fields`` (bf16) at C 256 (the first subnet
    layer) and C 128 (the second; at ``+-2 px`` the kernels line's numbers):
    within one bf16 ulp of its plain version (four f32 products in another
    order, rounded once) plus slack near zero, two runs bit-identical, the
    digest of its columns; card, queued and device ms beside the bound; at
    ``+-2 px`` also the plain version and 9 grid_sample calls."""
    g = torch.Generator(device=dev).manual_seed(71)
    rtol, atol = 2.0 ** -7, 1e-4
    print(f"[K7a deform_sample_mt] ptxas: "
          f"{ptxas_registers('deform_sample_mt', 'deform_sample_mt_kernel')}")
    row = {}
    for field, sy, sx in fields:
        taps, b, h, w = sy.shape
        n_rows, n_inside = _k7_touched(sy, sx)
        for c in (256, 128):
            x = torch.randn((b, h, w, c), generator=g, device=dev).to(torch.bfloat16)

            def run():
                return deform_sample_mt.deform_sample_mt(x, sy, sx)

            got, again = run(), run()
            ref = deform_sample_mt.deform_sample_mt_plain(x, sy, sx)
            torch.cuda.synchronize()
            err, rel = compare(got, ref, rtol, atol)
            if not torch.equal(got, again):
                raise AssertionError(f"K7a, {field}, C {c}: two runs differ")
            del ref, again
            ms, queued = time_ms(run), time_queued_ms(run)
            dev_ms = device_ms(run, "deform_sample_mt_kernel")
            # bytes this run needs: the rows of x its counted samples touch
            # (once, whichever tap reads them), the coordinates, the columns
            # written; 4 corners x 2 flops per channel
            n_bytes = n_rows * c * 2 + 2 * sy.numel() * 4 + got.numel() * 2
            bound_ms, bound_by = bound(n_bytes, n_inside * 4 * 2 * c)
            line = (f"[K7a deform_sample_mt] {field}, x {tuple(x.shape)} bf16 -> cols "
                    f"{tuple(got.shape)}: max abs err {err:.3e}, max rel err {rel:.3e} "
                    f"(tolerance {rtol:.4g}*|ref| + {atol:g}); two runs bit-identical, digest "
                    f"{digest(got)}; kernel {ms:.4f} ms, queued {queued:.4f}, device "
                    f"{dev_ms:.4f}, bound {bound_ms:.4f} ms ({bound_by}: {n_bytes / 1e6:.1f} MB),"
                    f" {100 * bound_ms / dev_ms:.1f}% of it on the device")
            if field == "+-2 px":
                lib_fwd = _k7_library(x, sy, sx)
                lib_err = float((torch.stack(lib_fwd(), 1).permute(0, 3, 4, 1, 2)
                                 - got.float()).abs().max())
                plain_ms = time_ms(lambda: deform_sample_mt.deform_sample_mt_plain(x, sy, sx), 10)
                library_ms = time_ms(lib_fwd, 10)
                line += (f"; plain {plain_ms:.4f} ms, 9x grid_sample {library_ms:.4f} ms (max "
                         f"abs diff {lib_err:.3e})")
                if c == 128:
                    row = {"name": "deform_sample_mt", "route": "cuda",
                           "source": "upsnet_torch/csrc/deform_sample_mt.cu",
                           "replaces": "upsnet_tpu/ops/deform_conv_pallas.py:1135",
                           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                           "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}
                del lib_fwd
            print(line)
            del x, got
            torch.cuda.empty_cache()
    return row


def check_k7b(dev, fields) -> dict:
    """K7b on each field of ``_k7_fields`` (bf16) at C 256 and C 128 (at
    ``+-2 px`` the kernels line's numbers), against its plain version:
    grad_x, f32 sums of about 36 terms in another order rounded once to
    bf16, within one bf16 ulp plus 1e-3 where the terms cancel; gsy, gsx,
    f32 sums of 4 x C products of O(1) values in another order, within 1e-4
    relative plus 1e-3. Two runs bit-identical (grad_x, gsy and gsx),
    exactly 0 at integer coordinates, the outputs' digest; card, queued and
    device ms (K7b's kernels summed) beside the bound, the sort's share of
    the device time, the peak memory of a call above its inputs; at
    ``+-2 px`` also the plain version and 9 calls of grid_sample's backward
    op."""
    g = torch.Generator(device=dev).manual_seed(72)
    rtol, atol, c_rtol, c_atol = 2.0 ** -7, 1e-3, 1e-4, 1e-3
    print("[K7b deform_sample_mt_bwd] ptxas: " + "; ".join(
        f"{sym} {ptxas_registers('deform_sample_mt_bwd', sym)}" for sym in K7B_KERNELS))
    row = {}
    for field, sy, sx in fields:
        taps, b, h, w = sy.shape
        n_rows, n_inside = _k7_touched(sy, sx)
        at_int_y, at_int_x = sy == sy.round(), sx == sx.round()
        for c in (256, 128):
            x = torch.randn((b, h, w, c), generator=g, device=dev).to(torch.bfloat16)
            grad = torch.randn((b, h, w, taps, c), generator=g, device=dev).to(torch.bfloat16)

            def run():
                return deform_sample_mt.deform_sample_mt_bwd(x, sy, sx, grad)

            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            got = run()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            again = run()
            ref = deform_sample_mt.deform_sample_mt_bwd_plain(x, sy, sx, grad)
            torch.cuda.synchronize()
            gx_err, gx_rel = compare(got[0], ref[0], rtol, atol)
            gsy_err, _ = compare(got[1], ref[1], c_rtol, c_atol)
            gsx_err, _ = compare(got[2], ref[2], c_rtol, c_atol)
            del ref
            if not all(torch.equal(u, v) for u, v in zip(got, again)):
                raise AssertionError(f"K7b, {field}, C {c}: two runs differ")
            del again
            if (float(got[1][at_int_y].abs().max()) != 0.0
                    or float(got[2][at_int_x].abs().max()) != 0.0):
                raise AssertionError(f"K7b, {field}: non-zero coordinate gradient at an "
                                     f"integer coordinate")
            if (float(got[1].abs().max()) == 0.0 or float(got[2].abs().max()) == 0.0
                    or float(got[0].float().abs().max()) == 0.0):
                raise AssertionError(f"K7b, {field}: gradients are all zero")
            ms, queued = time_ms(run), time_queued_ms(run)
            per_kernel = device_ms_by_kernel(run, K7B_KERNELS)
            dev_ms = sum(per_kernel.values())
            sort_ms = sum(per_kernel[k] for k in K7B_SORT)
            # bytes this run needs: the rows of x its counted samples touch,
            # g once, the coordinates, grad_x (bf16, every element written)
            # and the two coordinate gradients; 4 corners x 6 flops per
            # channel. Both passes read g, so their floor adds g again.
            coords = 2 * sy.numel() * 4
            n_bytes = n_rows * c * 2 + grad.numel() * 2 + 2 * coords + x.numel() * 2
            bound_ms, bound_by = bound(n_bytes, n_inside * 4 * 6 * c)
            two_pass_ms = (n_bytes + grad.numel() * 2) / HBM_BYTES_PER_S * 1e3
            line = (f"[K7b deform_sample_mt_bwd] {field}, C {c}: grad_x max abs err "
                    f"{gx_err:.3e}, max rel err {gx_rel:.3e} (tolerance {rtol:.4g}*|ref| + "
                    f"{atol:g}); gsy / gsx max abs err {gsy_err:.3e} / {gsx_err:.3e} "
                    f"(tolerance {c_rtol:g}*|ref| + {c_atol:g}); two runs bit-identical, "
                    f"digest {digest(*got)}; exactly 0 at the {int(at_int_y.sum())} integer "
                    f"rows and {int(at_int_x.sum())} integer columns; kernel {ms:.4f} ms "
                    f"(sort, gather and coordinate pass), queued {queued:.4f}, device "
                    f"{dev_ms:.4f} (sort {sort_ms:.4f}, {100 * sort_ms / dev_ms:.1f}%; gather "
                    f"{per_kernel['mt_bwd_gather_kernel']:.4f}; coordinate pass "
                    f"{per_kernel['mt_bwd_coords_kernel']:.4f}), bound {bound_ms:.4f} ms "
                    f"({bound_by}: {n_bytes / 1e6:.1f} MB, g once), "
                    f"{100 * bound_ms / dev_ms:.1f}% of it on the device (two passes read g "
                    f"twice: their floor is {two_pass_ms:.4f} ms); a call's peak memory above "
                    f"its inputs {peak / 1e6:.1f} MB; {n_inside} counted samples")
            if field == "+-2 px":
                lib_bwd = _k7_library(x, sy, sx, grad)
                plain_ms = time_ms(
                    lambda: deform_sample_mt.deform_sample_mt_bwd_plain(x, sy, sx, grad), 10)
                library_ms = time_ms(lib_bwd, 10)
                line += (f"; plain {plain_ms:.4f} ms, 9x grid_sampler_2d_backward "
                         f"{library_ms:.4f} ms")
                if c == 128:
                    row = {"name": "deform_sample_mt_bwd", "route": "cuda",
                           "source": "upsnet_torch/csrc/deform_sample_mt_bwd.cu",
                           "replaces": "upsnet_tpu/ops/deform_conv_pallas.py:1267",
                           "max_abs_err": max(gx_err, gsy_err, gsx_err), "ms": ms,
                           "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                           "library_ms": library_ms}
                del lib_bwd
            print(line)
            del x, grad, got
            torch.cuda.empty_cache()
    return row


def check_k7(dev) -> tuple[dict, dict]:
    """K7a and K7b on the three fields of ``_k7_fields``, each at C 256 and
    C 128 (``check_k7a``, ``check_k7b``); both must give the same bits on
    two runs."""
    fields = _k7_fields(dev)
    return check_k7a(dev, fields), check_k7b(dev, fields)


COUNTERS = {"deform_sample9": (deform_sample, "launches"),
            "deform_sample_taps": (deform_sample, "launches_taps"),
            "deform_sample": (deform_sample, "launches_fwd"),
            "deform_sample_bwd": (deform_sample, "launches_bwd"),
            "deform_sample_bwd_taps": (deform_sample, "launches_bwd_taps"),
            "deform_sample_bwd_unclipped": (deform_sample, "launches_bwd_unclipped"),
            "fpn_roi_align": (roi_align_fpn, "launches"),
            "fpn_roi_align_bwd": (roi_align_fpn, "launches_bwd"),
            "shift_fwd": (deform_shift, "launches_fwd"),
            "shift_adjoint": (deform_shift, "launches_adjoint"),
            "shift_offset_grads": (deform_shift, "launches_offset_grads"),
            "deform_sample_tiled_taps": (deform_sample, "launches_tiled_taps"),
            "deform_sample_tiled": (deform_sample, "launches_tiled"),
            "deform_sample_mt": (deform_sample_mt, "launches_fwd"),
            "deform_sample_mt_bwd": (deform_sample_mt, "launches_bwd")}


def expected_launches(cfg, grad: bool, heads: bool = True, bucket=BUCKET,
                      batch: int = BATCH) -> dict:
    """The launches of one ``forward_predict`` (grad False) or one train step
    (grad True) of ``cfg`` at ``bucket``, from the port's routing rules. A
    DCN layer that ``dcn_impl: shift`` sends to the shift route launches K8a
    (and K8b + K8c in backward); one that ``pallas`` or the fallback of
    ``shift`` sends to the tiled form launches the all-tap K6 (and the
    all-tap K3's two passes in backward); any other launches K1 without
    autograd, and with it the all-tap K2 and the two passes of the all-tap
    K3, clipped where dy is (``pallas``, ``mxu``, ``shift``'s fallback), else
    (``auto``, ``gather``) unclipped. The one-tap K2 and K6 run on no path.
    ``heads`` False leaves out the ROIAlign calls (a pass of the trunk
    alone)."""
    net = cfg.network
    impl = (net.dcn_impl_train or net.dcn_impl) if grad else net.dcn_impl
    n = dict.fromkeys(COUNTERS, 0)
    for stride in (4, 8, 16, 32):
        h, w = -(-bucket[0] // stride), -(-bucket[1] // stride)
        for layer in range(net.fcn_num_layers):
            cin = net.fpn_feature_dim if layer == 0 else net.fcn_head_dim
            shape = (batch, h, w, cin)
            if impl == "shift" and deform_shift.shift_route_ok(
                    shape, net.fcn_head_dim, net.dcn_max_dy, net.dcn_max_dy, 1):
                n["shift_fwd"] += 1
                n["shift_adjoint"] += grad
                n["shift_offset_grads"] += grad
            elif impl in ("pallas", "shift") and deform_sample.pallas_route(
                    shape, net.fcn_head_dim, net.dcn_max_dy, 1)[0] == "tiled":
                n["deform_sample_tiled_taps"] += 1
                n["deform_sample_bwd_taps"] += 2 * grad
            elif grad:
                n["deform_sample_taps"] += 1
                if impl in ("pallas", "mxu", "shift"):
                    n["deform_sample_bwd_taps"] += 2
                else:
                    n["deform_sample_bwd_unclipped"] += 2
            else:
                n["deform_sample9"] += 1
    if heads:
        n["fpn_roi_align"] = 3 if grad else 2  # box, mask (+ GT boxes of the panoptic loss)
        n["fpn_roi_align_bwd"] = 3 if grad else 0
    return n


def nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def reset_launches() -> None:
    for module, attr in COUNTERS.values():
        setattr(module, attr, 0)


def read_launches() -> dict:
    return {name: getattr(module, attr) for name, (module, attr) in COUNTERS.items()}


def shrink_bn_scales(model, generator) -> None:
    """Frozen-BN scales uniform in [0.3, 0.6], below 1 as pretrained
    statistics give them, so that activations stay O(1) through the random
    trunk (identity affines let them grow with depth)."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, layers.FrozenBatchNorm):
                scale = torch.empty(m.scale.shape).uniform_(0.3, 0.6, generator=generator)
                m.scale.copy_(scale)


def perturb_offset_biases(model, generator, dy_px: float = 2.0, dx_px: float = 2.0) -> None:
    """Offset-conv biases uniform in +-dy_px (the dy components) and +-dx_px
    (the dx components), so that the samplers work at fractional positions
    as a trained checkpoint would."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, layers.DeformConv):
                bias = torch.empty(m.offset_conv.bias.shape).uniform_(-1.0, 1.0,
                                                                       generator=generator)
                bias[0::2] *= dy_px
                bias[1::2] *= dx_px
                m.offset_conv.bias.copy_(bias)


def phase_predict(dev, impl: str = "auto", tag: str = "predict", bucket=BUCKET,
                  im_hw=IM_HW, batch_size: int = BATCH):
    """Two full-width requests of ``batch_size`` images on the ``bucket``
    canvas through ``forward_predict`` with ``dcn_impl: impl``. Returns
    (launches, a closure that serves one more request, the model, the last
    batch and its seg_logits)."""
    cfg = default_config()
    cfg = cfg.replace(network=dataclasses.replace(cfg.network, dcn_impl=impl))
    net, ds = cfg.network, cfg.dataset
    expect_n = expected_launches(cfg, grad=False, bucket=bucket, batch=batch_size)
    print(f"[{tag}] {cfg.symbol}: {ds.num_classes} classes, {ds.num_seg_classes} seg "
          f"classes, fpn {net.fpn_feature_dim}, fcn {net.fcn_head_dim}, fc "
          f"{net.rcnn_fc_dim}, {net.compute_dtype}, dcn_impl {net.dcn_impl}, "
          f"bucket {bucket}, batch {batch_size}")
    gen = torch.Generator().manual_seed(cfg.seed)
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, generator=gen)
    perturb_offset_biases(model, gen)
    anchors = tuple(torch.as_tensor(a, device=dev) for a in pyramid_anchors(bucket))
    print(f"[{tag}] model built in {time.perf_counter() - t0:.2f} s")
    g = torch.Generator(device=dev).manual_seed(3)
    batches = [{
        "images": torch.empty((batch_size, *bucket, 3), device=dev).uniform_(-110.0, 140.0,
                                                                        generator=g),
        "im_hw": torch.tensor([im_hw] * batch_size, device=dev),
    } for _ in range(2)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_launches()
    lat, per_request = [], []
    for i, batch in enumerate(batches):
        before = read_launches()
        nms.iterations = 0
        t0 = time.perf_counter()
        out = forward_predict(model, cfg, anchors, batch)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
        per_request.append({k: v - before[k] for k, v in read_launches().items()})
        d = cfg.test.max_det
        hq, wq = bucket[0] // 4, bucket[1] // 4
        expect = {"boxes": (batch_size, d, 4), "scores": (batch_size, d), "classes": (batch_size, d),
                  "det_valid": (batch_size, d), "mask_logits": (batch_size, d, 28, 28),
                  "seg_logits": (batch_size, hq, wq, ds.num_seg_classes),
                  "pan_map": (batch_size, hq, wq), "pan_keep": (batch_size, d)}
        for k, shape in expect.items():
            if tuple(out[k].shape) != shape:
                raise AssertionError(f"{k}: shape {tuple(out[k].shape)} != {shape}")
        for k in ("boxes", "seg_logits", "mask_logits"):
            if not torch.isfinite(out[k]).all():
                raise AssertionError(f"request {i}: non-finite {k}")
        pan = out["pan_map"]
        if int(pan.min()) < 0 or int(pan.max()) > ds.num_stuff + d:
            raise AssertionError(f"request {i}: pan_map outside [0, {ds.num_stuff + d}]")
        print(f"[{tag}] request {i}: {lat[-1]:.1f} ms, {int(out['det_valid'].sum())} "
              f"detections, {int(out['pan_keep'].sum())} in pan_map, launches "
              f"{nonzero(per_request[-1])}, NMS fixpoint iterations "
              f"{nms.iterations} (RPN + detection)")
    launches = read_launches()
    for moved in per_request:  # exact, so a training kernel in a request fails too
        if moved != expect_n:
            raise AssertionError(f"launches per forward {moved}, expected {expect_n}")
    print(f"[{tag}] launches on this path: {launches}")
    print(f"[{tag}] latency per batch-{batch_size} request {[round(x, 2) for x in lat]} ms; "
          f"steady (request 1) {lat[1]:.2f} ms = {batch_size * 1e3 / lat[1]:.2f} img/s; peak "
          f"memory allocated {torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB (weights "
          f"included)")
    run = lambda: forward_predict(model, cfg, anchors, batches[-1])  # noqa: E731
    return launches, run, model, batches[-1], out["seg_logits"]


def phase_profile(run, prefix: str, what: str, other_thread=()) -> None:
    """``run()`` once more under torch.profiler. Per ``<prefix>*`` stage: host
    ms (the CPU range), device span ms (first to last kernel of the range)
    and device busy ms (its kernels' durations); per kernel name, device
    ms; and the device's idle share of the wall time. A stage named in
    ``other_thread`` launches its kernels from another thread (the backward
    pass runs on autograd's), so the profiler's device range for it is
    empty or covers a stray kernel: it gets the device time between its
    neighbours' device ranges instead. The largest device ops that are not
    the port's are named by the stage whose host range holds the aten op
    that launched them (kernel linked to op by correlation), that op, the
    autograd node it ran under, and its input shapes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    host, host_start, host_end, span, spans, kernels = {}, {}, {}, {}, [], []
    for e in prof.events():
        if e.name.startswith(prefix):
            ms = e.time_range.elapsed_us() / 1e3
            if e.device_type != DeviceType.CUDA:
                host[e.name] = ms
                host_start[e.name] = e.time_range.start
                host_end[e.name] = e.time_range.end
            elif e.name not in other_thread:
                span[e.name] = ms
                spans.append((e.time_range.start, e.time_range.end, e.name))
        elif e.device_type == DeviceType.CUDA:
            kernels.append(e)
    order = sorted(host_start, key=host_start.get)
    for i, name in enumerate(order):
        if name not in other_thread:
            continue
        before = [e for s_, e, n in spans if n in order[:i]]
        after = [s_ for s_, e, n in spans if n in order[i + 1:]]
        start = max(before) if before else 0
        end = min(after) if after else max(k.time_range.end for k in kernels)
        span[name] = (end - start) / 1e3
        spans.append((start, end, name))
    busy = {name: 0.0 for name in host}
    per_name: dict[str, float] = {}
    for k in kernels:
        ms = k.time_range.elapsed_us() / 1e3
        per_name[k.name] = per_name.get(k.name, 0.0) + ms
        for start, end, name in spans:
            if start <= k.time_range.start <= end:
                busy[name] = busy.get(name, 0.0) + ms
    busy_ms = sum(per_name.values())
    tag = f"[profile {what}]"
    print(f"{tag} under torch.profiler: wall {wall_ms:.2f} ms, device busy "
          f"{busy_ms:.2f} ms, idle share {1 - busy_ms / wall_ms:.3f}, {len(kernels)} device ops")
    print(f"{tag} per stage, host ms / device span ms / device busy ms: " + ", ".join(
        f"{k[len(prefix):]} {host[k]:.2f} / {span.get(k, 0.0):.2f} / {busy.get(k, 0.0):.2f}"
        for k in host))
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:14]
    print(f"{tag} top device ops (ms): " + "; ".join(f"{n[:70]} {v:.3f}" for n, v in top))
    ours = {}
    for k in kernels:
        for symbol, label in KERNEL_SYMBOLS.items():
            if re.search(rf"\b{symbol}[<(]", k.name):
                ms, n = ours.get(label, (0.0, 0))
                ours[label] = (ms + k.time_range.elapsed_us() / 1e3, n + 1)
    print(f"{tag} the port's kernels, summed device ms (launches): " + "; ".join(
        f"{label} {ms:.3f} ({n})" for label, (ms, n) in ours.items()))
    # the nine-fold copy of x (or of its gradient) that a tap-major batched
    # projection makes: a (9, N, C) or (9, C, N) tensor; the (9, B, H, W)
    # coordinates are not counted
    copies = [(str(e.input_shapes[0]), sum(k.duration for k in e.kernels) / 1e3)
              for e in prof.events()
              if e.name == "aten::copy_" and e.device_type != DeviceType.CUDA
              and e.input_shapes and len(e.input_shapes[0]) == 3 and e.input_shapes[0][0] == 9]
    print(f"{tag} aten::copy_ of a [9, ...] tensor: " + (
        f"{len(copies)} calls, {sum(ms for _, ms in copies):.3f} device ms, shapes "
        f"{sorted({shape for shape, _ in copies})[:4]}" if copies else "none"))
    def stage_of(e):
        return next((n[len(prefix):] for n in order
                     if host_start[n] <= e.time_range.start <= host_end[n]), "no stage")

    # aten::copy_ calls that run a device kernel, per stage: the box and mask
    # branches' are the channel-last pyramid, made once per forward
    copies_at: dict[str, tuple] = {}
    for e in prof.events():
        if e.name == "aten::copy_" and e.device_type != DeviceType.CUDA and e.kernels:
            n, ms = copies_at.get(stage_of(e), (0, 0.0))
            copies_at[stage_of(e)] = (n + 1, ms + sum(k.duration for k in e.kernels) / 1e3)
    print(f"{tag} aten::copy_ with a device kernel per stage, calls (device ms): " + ", ".join(
        f"{stage} {n} ({ms:.3f})" for stage, (n, ms) in copies_at.items()))
    # who launched the largest others: kernel name -> {(stage, op, shapes): (ms, n)}
    launched: dict[str, dict] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA or not e.kernels:
            continue
        stage = stage_of(e)
        node, up = "", e.cpu_parent
        while up is not None and not node:
            node = up.name.split(": ")[-1] if "Backward" in up.name else ""
            up = up.cpu_parent
        op = f"{e.name} under {node}" if node else e.name
        for kk in e.kernels:
            site = launched.setdefault(kk.name, {})
            ms, n = site.get((stage, op, str(e.input_shapes)), (0.0, 0))
            site[(stage, op, str(e.input_shapes))] = (ms + kk.duration / 1e3, n + 1)
    others = [(n, v) for n, v in top
              if not any(re.search(rf"\b{symbol}[<(]", n) for symbol in KERNEL_SYMBOLS)][:4]
    for name, total in others:
        sites = sorted(launched.get(name, {}).items(), key=lambda kv: -kv[1][0])[:2]
        print(f"{tag} largest not the port's: {name[:90]} {total:.3f} ms; launched by "
              + ("; ".join(f"{ms:.3f} ms ({n}) in {stage}: {op}, shapes {shapes[:160]}"
                           for (stage, op, shapes), (ms, n) in sites) or "no linked op"))


# the port's kernel functions as the profiler names them; offset_grads_kernel
# is both K8c and the all-tap K3's coordinate pass, grad_y_gather_kernel both
# K8b and the clipped K3's grad_y pass; the unclipped K3's grad_y pass is six
# kernels, K7b seven (its sort, its gather and its coordinate pass, under
# names of their own)
KERNEL_SYMBOLS = {"deform_sample9_kernel": "K1", "deform_sample_taps_kernel": "K2 taps",
                  "deform_sample_kernel": "K2 one tap",
                  "deform_sample_bwd_kernel": "K3 one tap",
                  "grad_y_gather_kernel": "K3 taps grad_y / K8b",
                  "offset_grads_kernel": "K3 coords / K8c",
                  **dict.fromkeys(("bin_count_kernel", "scan_tiles_kernel",
                                   "scan_totals_kernel", "place_kernel", "rank_kernel",
                                   "grad_y_sorted_kernel"), "K3 unclipped grad_y"),
                  "fpn_roi_align_kernel": "K4", "fpn_roi_align_bwd_kernel": "K5",
                  "deform_sample_tiled_taps_kernel": "K6 taps",
                  "deform_sample_tiled_kernel": "K6 one tap", "deform_sample_mt_kernel": "K7a",
                  **dict.fromkeys(K7B_SORT, "K7b sort"), "mt_bwd_gather_kernel": "K7b grad_x",
                  "mt_bwd_coords_kernel": "K7b coords", "shift_fwd_kernel": "K8a"}
LOSS_KEYS = ("rpn_cls", "rpn_bbox", "cls", "bbox", "mask", "seg", "pano")
METRIC_FIELDS = {*LOSS_KEYS, "total", "iter", "images_per_sec", "step_s", "loader_wait_s",
                 "platform"}
WATCH_FIELDS = {"dcn_max_dy", "dcn_max_dx", "dcn_impl", "dcn_boundary_grad", "dcn_sat_frac"}


def seg_under(model, cfg, anchors, batch, impl: str) -> torch.Tensor:
    """``seg_logits`` of one request with every deformable layer of ``model``
    switched to ``dcn_impl: impl`` for the call."""
    dcns = [m for m in model.modules() if isinstance(m, layers.DeformConv)]
    before = [m.impl for m in dcns]
    for m in dcns:
        m.impl = impl
    try:
        return forward_predict(model, cfg, anchors, batch)["seg_logits"]
    finally:
        for m, was in zip(dcns, before):
            m.impl = was


def compare_seg_with_pallas(model, cfg, anchors, batch, seg_shift, tag: str) -> None:
    """``seg_logits`` of the ``dcn_impl: shift`` model against the same
    weights under ``dcn_impl: pallas`` on the same request. The offset convs
    have zero weights and biases within +-2 px, so neither route's clip acts
    and both sample the same positions with f32 sums rounded once to bf16;
    the one-matmul and the per-tap projections may round a bf16 value
    differently, and two DCN layers, the upsampling and the score conv carry
    that on: within 2^-5 of max |ref| (4 bf16 ulps of the largest logit)."""
    ref = seg_under(model, cfg, anchors, batch, "pallas")
    err = float((seg_shift - ref).abs().max())
    scale = float(ref.abs().max())
    print(f"[{tag}] seg_logits, dcn_impl shift vs pallas on the same weights: max abs diff "
          f"{err:.3e}, max |ref| {scale:.3f} (tolerance 2^-5 * max |ref| = {scale / 32:.3e})")
    if not err <= scale / 32:
        raise AssertionError(f"seg_logits shift vs pallas: {err} > {scale / 32}")


def compare_seg_with_tap_major(model, cfg, anchors, batch, seg) -> None:
    """``seg_logits`` of the ``auto`` model, whose no-grad DCN layers read the
    one-matmul projection side by side, against one more request on the
    same weights with every such layer switched to the tap-major stack of
    ``tap_projections`` and K1 reading that: both K1 forms give the same
    bits on the same projections, so the two differ only where the
    (N, Cin) x (Cin, 9 C) GEMM rounds a bf16 value otherwise than the batched
    one; expected 0.0, held within 2^-5 of max |ref| as ``shift`` against
    ``pallas`` is."""
    real_projections, real_k1 = deform_conv.side_by_side_projections, deform_conv.deform_sample9
    deform_conv.side_by_side_projections = deform_conv.tap_projections
    deform_conv.deform_sample9 = lambda y, sy, sx, tap_axis: real_k1(y, sy, sx)
    try:
        ref = forward_predict(model, cfg, anchors, batch)["seg_logits"]
    finally:
        deform_conv.side_by_side_projections = real_projections
        deform_conv.deform_sample9 = real_k1
    err = float((seg - ref).abs().max())
    scale = float(ref.abs().max())
    print(f"[predict] seg_logits, side-by-side vs tap-major projections on the same weights: "
          f"max abs diff {err:.3e}, max |ref| {scale:.3f} (tolerance 2^-5 * max |ref| = "
          f"{scale / 32:.3e})")
    if not err <= scale / 32:
        raise AssertionError(f"seg_logits side by side vs tap-major: {err} > {scale / 32}")


def compare_wide_with_auto(model, cfg, anchors, batch, seg_pallas) -> None:
    """The wide ``dcn_impl: pallas`` model against the same weights under
    ``auto`` (exact sampling, K1 at every level).

    With offset biases within +-2 px no clip acts and both sample the same
    positions. They differ by rounding: at P2 the tiled form adds its nine
    taps in bf16 (eight roundings of partial sums, each up to 2^-9 of the
    partial sum, so at worst 2^-6 of a layer's output) where K1 adds them in
    f32 and rounds once; two such layers, the upsampling and the score conv
    carry that on: within 2^-5 of max |ref|. With the dx biases redrawn in +-8 px and dy left within
    +-2 px, the untiled levels still compute what ``auto`` computes (they
    clip dy only), and P2 clips dx at +-6: the two must then differ by more
    than that tolerance."""
    ref = seg_under(model, cfg, anchors, batch, "auto")
    err = float((seg_pallas - ref).abs().max())
    scale = float(ref.abs().max())
    print(f"[predict_wide] seg_logits, pallas (P2 tiled) vs auto, offsets within +-2 px: max "
          f"abs diff {err:.3e}, max |ref| {scale:.3f} (tolerance 2^-5 * max |ref| = "
          f"{scale / 32:.3e})")
    if not err <= scale / 32:
        raise AssertionError(f"seg_logits pallas vs auto: {err} > {scale / 32}")
    perturb_offset_biases(model, torch.Generator().manual_seed(17), dy_px=2.0, dx_px=8.0)
    far_pallas = seg_under(model, cfg, anchors, batch, "pallas")
    far_auto = seg_under(model, cfg, anchors, batch, "auto")
    far = float((far_pallas - far_auto).abs().max())
    far_scale = float(far_auto.abs().max())
    print(f"[predict_wide] the same with dx biases in +-8 px (beyond the +-6 window): max abs "
          f"diff {far:.3e}, max |ref| {far_scale:.3f}: P2 clips dx, auto does not")
    if not far > far_scale / 32:
        raise AssertionError(f"dx beyond the window: pallas and auto differ by only {far}")


def phase_train(dev, impl: str = "pallas", n_steps: int = 4, tag: str = "train",
                bucket=BUCKET, im_hw=IM_HW, batch_size: int = BATCH):
    """``n_steps`` SGD steps of the full-width model with ``dcn_impl: impl``
    on one synthetic batch of ``batch_size`` images on the ``bucket`` canvas,
    through ``train_steps`` with a display interval of one step. Returns (launches, a closure that takes one more
    step, the per-step loss dicts)."""
    cfg = default_config()
    cfg = cfg.replace(
        output_path=os.path.join("output", f"chip_smoke_{tag}"),
        # 'warn': from random weights at lr 0.02 one update drives most
        # offsets beyond the window, and the watch's default would end the run
        network=dataclasses.replace(cfg.network, dcn_impl=impl, dcn_boundary_grad="clip",
                                    roi_align_impl="window", dcn_saturation_action="warn"),
        train=dataclasses.replace(cfg.train, display_iter=1))
    net, tc = cfg.network, cfg.train
    print(f"[{tag}] {cfg.symbol}: {net.compute_dtype} from {net.param_dtype} parameters, "
          f"dcn_impl {net.dcn_impl}, dcn_boundary_grad {net.dcn_boundary_grad}, bucket "
          f"{bucket}, batch {batch_size}, batch_rois {tc.batch_rois}, rpn_batch_size "
          f"{tc.rpn_batch_size}, {tc.max_gt_instances} GT slots, lr {tc.lr}, grad_clip "
          f"{tc.grad_clip}")
    # one interval is one step and, where the loop watches the clip
    # ('pallas'), the watch's probe: a pass of the trunk without autograd
    watched = impl in WATCHED_IMPLS
    expect_n = expected_launches(cfg, grad=True, bucket=bucket, batch=batch_size)
    if watched:
        probe = expected_launches(cfg, grad=False, heads=False, bucket=bucket,
                                  batch=batch_size)
        expect_n = {k: v + probe[k] for k, v in expect_n.items()}
    metrics_path = os.path.join(cfg.output_path, cfg.symbol, "metrics.jsonl")
    if os.path.exists(metrics_path):
        os.remove(metrics_path)
    gen = torch.Generator().manual_seed(cfg.seed)
    model = build_model(cfg, device=dev, generator=gen)
    perturb_offset_biases(model, gen)
    shrink_bn_scales(model, gen)  # losses of a sane order, so the steps mean something
    anchors = tuple(torch.as_tensor(a, device=dev) for a in pyramid_anchors(bucket))
    batch = {k: torch.as_tensor(v, device=dev) for k, v in synthetic_batch(
        cfg, bucket, batch_size, seed=7, image_hw=tuple(int(x) for x in im_hw)).items()}
    frozen = {n: p.detach().clone() for n, p in model.named_parameters()
              if not p.requires_grad}
    trainable = {n: p for n, p in model.named_parameters() if p.requires_grad}
    print(f"[{tag}] {len(trainable)} trainable tensors "
          f"({sum(p.numel() for p in trainable.values()) / 1e6:.2f} M parameters), "
          f"{len(frozen)} frozen; {int(batch['gt_valid'].sum())} GT instances")
    optimizer = make_optimizer(cfg, model)
    noise_gen = torch.Generator(device=dev).manual_seed(11)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_launches()
    per_step = []

    def on_step(i, metrics):  # the interval's losses are read: the step is done
        per_step.append(read_launches())
        bad = [k for k in LOSS_KEYS if not math.isfinite(metrics[k])]
        if bad:
            raise AssertionError(f"step {i}: non-finite loss terms {bad}: {metrics}")
        print(f"[{tag}] step {i}: "
              + ", ".join(f"{k} {metrics[k]:.4f}" for k in (*LOSS_KEYS, "total")))

    history = train_steps(model, cfg, anchors, [batch] * n_steps, optimizer=optimizer,
                          generator=noise_gen, on_step=on_step)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    prev = {k: 0 for k in launches}
    for i, now in enumerate(per_step):
        moved = {k: now[k] - prev[k] for k in now}
        if moved != expect_n:
            raise AssertionError(f"step {i}: launches {moved}, expected {expect_n}")
        prev = now
    if len(history) != n_steps or set(history[0]) != {*LOSS_KEYS, "total"}:
        raise AssertionError(f"train_steps returned {len(history)} dicts, keys {set(history[0])}")
    with open(metrics_path) as f:
        entries = [json.loads(line) for line in f]
    fields = METRIC_FIELDS | (WATCH_FIELDS if watched else set())
    if len(entries) != n_steps or any(set(e) != fields for e in entries):
        raise AssertionError(f"{metrics_path}: {len(entries)} lines, fields "
                             f"{[sorted(set(e) ^ fields) for e in entries]} off")
    for name, p in trainable.items():
        if p.grad is None or not torch.isfinite(p.grad).all():
            raise AssertionError(f"{name}: missing or non-finite gradient")
        if not torch.isfinite(p).all():
            raise AssertionError(f"{name}: non-finite after {n_steps} steps")
    offset_grads = {n: float(p.grad.abs().max()) for n, p in trainable.items()
                    if "offset_conv" in n}
    if not offset_grads or max(offset_grads.values()) == 0.0:
        raise AssertionError(f"offset-conv gradients all zero: {offset_grads}")
    now = dict(model.named_parameters())
    for name, before in frozen.items():
        if not torch.equal(now[name], before):
            raise AssertionError(f"frozen parameter {name} changed")
    # step_s of an interval: from the end of the last one to its losses read,
    # without the probe and the write that follow
    ms = [e["step_s"] * 1e3 for e in entries]
    steady = statistics.median(ms[1:])
    print(f"[{tag}] launches per interval {nonzero(expect_n)}; on this path {nonzero(launches)}")
    if watched:
        print(f"[{tag}] saturation watch per interval, max |dy| / max |dx| / share at the "
              f"window edge: " + ", ".join(
                  f"{e['dcn_max_dy']:.2f} / {e['dcn_max_dx']:.2f} / {e['dcn_sat_frac']:.3f}"
                  for e in entries))
    print(f"[{tag}] offset-conv max |grad| after the last step: "
          + ", ".join(f"{n} {v:.3e}" for n, v in offset_grads.items()))
    print(f"[{tag}] step ms {[round(x, 1) for x in ms]} (metrics.jsonl step_s); step 0 "
          f"{ms[0]:.1f} ms, steady (median of steps 1-{n_steps - 1}) {steady:.1f} ms = "
          f"{batch_size * 1e3 / steady:.2f} img/s; peak memory allocated {peak / 2 ** 30:.2f} GiB; "
          f"{len(frozen)} frozen tensors unchanged")
    step = make_train_step(model, cfg, anchors, optimizer, generator=noise_gen)
    return launches, (lambda: step(batch)), history


def compare_step0_losses(shift: dict, pallas: dict) -> None:
    """Step 0 of the ``shift`` and the ``pallas`` train phase: the same
    weights, batch and noise, offsets within +-2 px, so the loss terms
    differ only through bf16 rounding inside the semantic head: within 2%
    of each other (the other heads do not see the DCN route; ``seg`` and
    ``pano`` do)."""
    rel = {k: abs(shift[k] - pallas[k]) / max(abs(pallas[k]), 1e-6) for k in (*LOSS_KEYS, "total")}
    print("[train_shift] step-0 losses, shift vs pallas, relative difference: "
          + ", ".join(f"{k} {v:.2e}" for k, v in rel.items()) + " (tolerance 2e-2)")
    bad = {k: v for k, v in rel.items() if not v <= 2e-2}
    if bad:
        raise AssertionError(f"step-0 losses of shift and pallas differ: {bad}")


def phase_reference(dev) -> None:
    """A tiny float32 model on the card (kernels, cuDNN) against the same
    weights on the CPU (plain versions)."""
    cfg = default_config()
    cfg = cfg.replace(
        network=dataclasses.replace(cfg.network, backbone="resnet_test", fpn_feature_dim=32,
                                    rcnn_fc_dim=64, fcn_head_dim=16, compute_dtype="float32"),
        dataset=dataclasses.replace(cfg.dataset, num_classes=5, num_seg_classes=7,
                                    num_stuff=3),
        test=dataclasses.replace(cfg.test, rpn_pre_nms_top_n=64, rpn_post_nms_top_n=32,
                                 max_det=8),
    )
    gen = torch.Generator().manual_seed(5)
    cpu_model = build_model(cfg, device="cpu", generator=gen)
    perturb_offset_biases(cpu_model, gen)
    shrink_bn_scales(cpu_model, gen)
    gpu_model = build_model(cfg, device=dev)
    gpu_model.load_state_dict(cpu_model.state_dict())
    hw = (64, 96)
    images = torch.empty((2, *hw, 3)).uniform_(-10.0, 10.0, generator=gen)
    im_hw = torch.tensor([[64.0, 96.0], [56.0, 80.0]])
    outs = []
    for model, d in ((cpu_model, "cpu"), (gpu_model, dev)):
        anchors = tuple(torch.as_tensor(a, device=d) for a in pyramid_anchors(hw))
        o = forward_predict(model, cfg, anchors,
                            {"images": images.to(d), "im_hw": im_hw.to(d)})
        outs.append({k: v.cpu() for k, v in o.items()})
    ref, got = outs
    seg_err = float((got["seg_logits"] - ref["seg_logits"]).abs().max())
    seg_scale = float(ref["seg_logits"].abs().max())
    if seg_err > 1e-3 * seg_scale:
        raise AssertionError(f"seg_logits card vs CPU: max abs err {seg_err} "
                             f"(max |ref| {seg_scale})")
    # discrete outputs may flip on near-ties between cuDNN and CPU sums, so
    # they are reported, not required
    same = {k: bool(torch.equal(got[k], ref[k]))
            for k in ("classes", "det_valid", "pan_map", "pan_keep")}
    box_err = float((got["boxes"] - ref["boxes"]).abs().max()) if same["classes"] else None
    print(f"[reference] tiny f32 model, card vs CPU: seg_logits max abs err {seg_err:.3e} "
          f"(max |ref| {seg_scale:.3f}); discrete outputs equal {same}; boxes max abs "
          f"err {box_err}")


def phase_mt_tool(dev) -> dict:
    """The sample-first form through its one caller, the tool
    ``upsnet_torch.tools.bench_deform_impls``: first one ``deform_conv2d_mt``
    call with gradients at the tool's largest shape (exactly one K7a and one
    K7b launch, finite gradients), then the tool itself at batch 2 over its
    five shapes. The launch counters must equal the tool's call counts, and
    at the constant-offset field (|dy| <= 2, so no clamp acts) ``mt`` must
    agree with ``pertap``: both round to bf16 at other places (nine
    projections against nine sampled inputs, then the sums), within 2^-6 of
    max |pertap| (two bf16 ulps of the largest output)."""
    g = torch.Generator(device=dev).manual_seed(12)
    (h, w), cin = bench_deform_impls.SHAPES[0]
    x = torch.randn((BATCH, h, w, cin), generator=g, device=dev).to(torch.bfloat16)
    off = torch.rand((BATCH, h, w, 18), generator=g, device=dev) * 4 - 2
    weight = torch.randn((9, cin, bench_deform_impls.COUT), generator=g, device=dev) * 0.05
    leaves = [t.requires_grad_() for t in (x, off, weight)]
    reset_launches()
    deform_conv2d_mt(*leaves).float().square().sum().backward()
    torch.cuda.synchronize()
    one = nonzero(read_launches())
    if one != {"deform_sample_mt": 1, "deform_sample_mt_bwd": 1}:
        raise AssertionError(f"one mt call with gradients launched {one}")
    for name, t in zip(("x", "offsets", "weight"), leaves):
        if not torch.isfinite(t.grad).all() or float(t.grad.abs().max()) == 0.0:
            raise AssertionError(f"mt: gradient to {name} is zero or not finite")
    del x, off, weight, leaves
    torch.cuda.empty_cache()

    reps = 10
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    rows = bench_deform_impls.main(device=dev, batch=BATCH, reps=reps)
    torch.cuda.synchronize()
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    # per shape and field the tool calls a form once to compare outputs,
    # 1 + reps times forward and 1 + reps times forward + backward
    calls = len(bench_deform_impls.SHAPES) * 2
    expect = dict.fromkeys(COUNTERS, 0)
    expect["deform_sample_mt"] = calls * (1 + 2 * (1 + reps))
    expect["deform_sample_mt_bwd"] = calls * (1 + reps)
    for (h, w), cin in bench_deform_impls.SHAPES:
        route, _ = deform_sample.pallas_route((BATCH, h, w, cin), bench_deform_impls.COUT,
                                              bench_deform_impls.MAX_DY, 1)
        if route == "tiled":
            raise AssertionError(f"the tool's shape {h}x{w} is routed to the tiled form")
        expect["deform_sample9"] += 2 * (2 + reps)
        expect["deform_sample_taps"] += 2 * (1 + reps)
        expect["deform_sample_bwd_taps"] += 2 * 2 * (1 + reps)
    if launches != expect:
        raise AssertionError(f"mt_tool launches {nonzero(launches)}, expected {nonzero(expect)}")
    for row in rows:
        times = {k: v for k, v in row.items() if k.endswith("_ms")}
        if len(times) != 4 or not all(math.isfinite(v) and v > 0 for v in times.values()):
            raise AssertionError(f"mt_tool row without finite times: {row}")
    for row in (r for r in rows if r["impl"] == "mt"):
        out_std = 0.05 * math.sqrt(9 * row["cin"])  # unit inputs, weights of std 0.05
        tol = 2.0 ** -6 * 5 * out_std
        print(f"[mt_tool] {row['h']}x{row['w']} cin {row['cin']}: mt vs pertap max abs diff "
              f"const2 {row['const2_max_abs_diff']:.3e}, rand2 {row['rand2_max_abs_diff']:.3e} "
              f"(tolerance 2^-6 * 5 sigma = {tol:.3e})")
        if not max(row["const2_max_abs_diff"], row["rand2_max_abs_diff"]) <= tol:
            raise AssertionError(f"mt and pertap disagree: {row}")
    print("[mt_tool] rows: " + json.dumps(rows))
    print(f"[mt_tool] launches {nonzero(launches)}; peak memory allocated "
          f"{peak / 2 ** 30:.2f} GiB")
    return launches


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="also profile one request and one train step of each "
                             "dcn_impl with torch.profiler")
    args = parser.parse_args()
    dev = torch.device("cuda", 0)
    print(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    phase_build()
    # the one-tap K2, K3 and K6 are held against their plain versions and
    # timed, but no route takes them any more: they are not in the kernels
    # line
    check_k2_k3(dev)
    check_coords(dev)
    kernels = [check_k1(dev), check_k2_taps(dev), check_k3_taps(dev), check_k3_unclipped(dev),
               check_k4(dev), check_k5(dev), check_k6(dev), *check_k7(dev), *check_k8(dev)]
    launches = dict.fromkeys(COUNTERS, 0)

    def finish(name, counts, run, prefix):
        """Add a phase's launches (counted from 0 over its own path), profile
        one more pass of it on request, and free its memory."""
        for k, v in counts.items():
            launches[k] += v
        if args.profile and run is not None:
            phase_profile(run, prefix, name, other_thread=("train.backward",))
        torch.cuda.empty_cache()

    counts, run, model, batch, seg = phase_predict(dev)
    cfg = default_config()
    anchors = tuple(torch.as_tensor(a, device=dev) for a in pyramid_anchors(BUCKET))
    compare_seg_with_tap_major(model, cfg, anchors, batch, seg)
    finish("predict", counts, run, "predict.")
    del run, model, batch, seg
    counts, run, pallas_history = phase_train(dev)
    finish("train", counts, run, "train.")
    counts, run, model, batch, seg = phase_predict(dev, "shift", "predict_shift")
    compare_seg_with_pallas(model, cfg, anchors, batch, seg, "predict_shift")
    finish("predict_shift", counts, run, "predict.")
    del run, model, batch, seg
    counts, run, shift_history = phase_train(dev, "shift", 3, "train_shift")
    compare_step0_losses(shift_history[0], pallas_history[0])
    finish("train_shift", counts, run, "train.")
    del run
    wide = dict(bucket=WIDE_BUCKET, im_hw=WIDE_IM_HW, batch_size=WIDE_BATCH)
    counts, run, model, batch, seg = phase_predict(dev, "pallas", "predict_wide", **wide)
    cfg = cfg.replace(network=dataclasses.replace(cfg.network, dcn_impl="pallas"))
    anchors = tuple(torch.as_tensor(a, device=dev) for a in pyramid_anchors(WIDE_BUCKET))
    finish("predict_wide", counts, run, "predict.")  # profiled before the biases move
    compare_wide_with_auto(model, cfg, anchors, batch, seg)
    del run, model, batch, seg
    counts, run, _ = phase_train(dev, "pallas", 2, "train_wide", **wide)
    finish("train_wide", counts, run, "train.")
    del run
    counts, run, _ = phase_train(dev, "auto", 2, "train_auto")
    finish("train_auto", counts, run, "train.")
    del run
    torch.cuda.empty_cache()
    finish("mt_tool", phase_mt_tool(dev), None, "")
    phase_reference(dev)
    for k in kernels:
        k["launches"] = launches[k["name"]]
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']} was not launched on a main path")
    print(json.dumps({"kernels": kernels}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
