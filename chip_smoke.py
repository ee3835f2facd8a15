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
   all-zero padded boxes an image) and at sampling ratio 3 (its runtime-S
   path) on the predict calls' RoIs, in bf16 and float32, each with the
   plain version's bits and two runs bit-identical, with its registers from
   ptxas and its device time under the profiler. K1 is checked and
   timed in both layouts it takes, side by side (the no-grad routes') and
   tap-major, which must give the same bits as each other and as K8a, which
   runs its body (K8a is timed beside K1 on the same data); the
   coordinate pass that both all-tap K3 forms share with K8c is checked and
   timed alone on the P2 layers at +-2, +-40 and clipped +-6 px (and on its
   25-tap, C 384 path). The one-tap K2, K3
   and K6, which no route takes any more, are checked and timed as the
   yardsticks of the layers they used to serve, and are not in the kernels
   line. Then, not timed, the kernels of the train entry and the two
   evaluation phases at their own shapes (``check_entry_shapes``): K1, the
   all-tap K2 and the clipped all-tap K3 (reach 9) on every DCN map of
   the GN rehearsal file at batch 8 in both its buckets, 832x1344 and
   1344x832, with K4 and K5 at the three calls of its step; K1 and K4 at
   batch 1 at the evaluations' buckets, 1024x2048 included;
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
9. predict_r101dcn, train_r101dcn: the paper's COCO model from its shipped
   experiment file (``load_config`` of
   ``experiments/upsnet_resnet101_dcn_coco_3x_16gpu.yaml``, built through the
   registry as ``resnet_101_upsnet``): ResNet-101 with deformable 3x3s in
   every block of C3-C5 (4 + 23 + 3 layers) beside the FCN head's 8, two
   batch-2 requests under the file's ``dcn_impl`` (``auto``) and two train
   steps under its ``dcn_impl_train`` (``pallas``), frozen-BN scales shrunk;
   launch counts derived from the routing rules for every DCN layer with its
   own shape and width (38 K1 a forward; 38 all-tap K2, 76 clipped all-tap
   K3 passes, 3 K4, 3 K5 a step, and 38 K1 for the watch's probe), and
   non-zero offset-conv gradients in each of C3, C4 and C5;
10. train_gn: ``experiments/upsnet_r50_synth_rehearsal.yaml`` (R50,
   ``norm: gn``, FCN DCN, ``dcn_impl_train: pallas``, ``dcn_boundary_grad:
   damped``, ``dcn_max_dy: 8``) for two steps at batch 2 (the file trains
   batch 8): every trainable GroupNorm parameter moves, the frozen stem's
   and res2's stay bit-equal;
11. eval_r50coco: the evaluation entry, ``upsnet_torch.tools.test``, as a
   user runs it, on ``experiments/upsnet_resnet50_coco_4gpu.yaml`` with
   ``--dataset-override synthetic --max-images 8 --no-artifacts`` under the
   file's ``dcn_impl`` (``auto``), with ``--weights`` a port checkpoint that
   the phase writes from the seeded model with its offset biases at +-2 px;
   the 256x320 scenes resize into the 832x1344 bucket, one image a forward,
   exactly 8 K1 and 2 K4 an image; images/s, the per-image split (sample,
   predict, host postprocess), the evaluators' seconds, peak memory, the RLE
   codec and the metrics (meaningless at random weights: that they appear is
   what counts), for a cold and a warm run, then a third run under
   torch.profiler for the device's busy ms an image inside ``predict_step``
   and the host's share of the warm run's image time;
12. eval_tiny: ``experiments/upsnet_tiny_synthetic.yaml`` trains its file's
   schedule (400 steps at batch 2) on the card through ``train_steps`` under
   its ``dcn_impl_train`` (``gather``: 8 all-tap K2, 16 unclipped all-tap K3,
   3 K4, 3 K5 a step) on the 8 evaluation scenes, is saved with
   ``save_checkpoint`` and evaluated by the entry twice, ``--dcn-impl auto``
   on the card (8 K1, 2 K4 an image) and ``--device cpu`` (plain versions,
   no launch): PQ / SQ / RQ, box and mask AP and mIoU of the two within
   1e-3 absolute, the tolerance the CPU test holds the port to against JAX;
13. train_entry: the training entry as a user runs it,
   ``upsnet_torch.tools.train.run``, on a copy of
   ``experiments/upsnet_r50_synth_rehearsal.yaml`` (GN R50 at full width,
   batch 8, both buckets with flip, ``image_wire: uint8``, ``num_workers:
   0``, the watch's action 'fail') that changes only the data and output
   paths, ``snapshot_step`` 6, ``display_iter`` 3 and ``max_iteration`` 12,
   reading 16 COCO-layout files written by ``upsnet_torch.tools.make_synth_coco``
   (seed 0, 800x1333 base, a quarter portrait): to step 6, then with
   ``resume: true`` to step 12. The resumed weights and momentum buffers must
   equal the step-6 snapshot bit for bit, the first resumed step's rate
   ``lr_schedule(cfg)(6)``; every step launches 8 all-tap K2, 16 clipped
   all-tap K3, 3 K4, 3 K5, every display interval the probe's 8 K1; every
   loss finite, both buckets drawn, snapshots at 6 and 12. Step ms between
   the steps' decodes on the card (CUDA events), img/s, ``loader_wait_s`` and
   its share from ``metrics.jsonl``, peak memory; then
   ``upsnet_torch.tools.test --dataset-override coco --max-images 8`` on
   ``step_00000012`` (8 K1, 2 K4 an image, finite metrics); with
   ``--profile``, one more step under torch.profiler;
14. eval_cityscapes: ``upsnet_torch.tools.test --dataset-override
   cityscapes`` on a copy of
   ``experiments/upsnet_r50_synth_cityscapes_rehearsal.yaml`` reading two
   1024x2048 gtFine-layout images, from a checkpoint of the seeded model: 8
   K1, 2 K4 an image, the Cityscapes instance AP, box AP, mIoU and PQ;
15. upsample: the FCN head's ``resize_bilinear`` (two float32 matmuls a
   level) timed against ``F.interpolate`` on a batch-8 step's P3-P5 maps;
16. reproducible: two runs of the train entry as shipped (the GN rehearsal
   file, batch 8, 4 steps), one in this process and one in a new process,
   from one seed must give every step's losses and the last snapshot bit for
   bit, without ``torch.use_deterministic_algorithms``; on a difference the
   phase prints which gradients of one step part, then fails;
17. ddp: two gloo ranks on the one card run one data-parallel step of the GN
   R50 model (float32, batch 2 a rank): the ranks' weights the same bits,
   the joined losses and every update within the CPU test's tolerance of
   the single-process step on the joined batch of 4; in the same ranks
   ``spatial_panoptic_fuse`` over two row slabs of a 1024x2048 canvas equal
   to ``panoptic_fuse``; then a world-size-1 NCCL group trains 2 steps
   through ``upsnet_torch.tools.train --backend nccl``;
18. eval_tta: ``upsnet_torch.tools.test`` on a copy of the ResNet-101-DCN
   COCO file with its own ``multi_scale`` [640, 800, 960] and ``flip_test``
   (6 forwards an image, each 38 K1 and 2 K4) on 2 COCO-layout images from a
   checkpoint of the seeded model: img/s and the per-image split (samples,
   predicts, merge, fusion, postprocess);
19. reference: a tiny float32 model on the card against the same model on
   the CPU (plain versions, no kernels), with frozen BN and no backbone DCN,
   then with GroupNorm and DCN in C3-C5.

The line before the last two is a JSON object with the numbers of every
kernel on a path (``launches`` sums the predict, train, eval and tool
phases, each counted from 0);
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
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: CUDA is not available")

import torch.nn.functional as F  # noqa: E402

from upsnet_torch.config import default_config, load_config  # noqa: E402
from upsnet_torch.data.synthetic import SyntheticDataset, synthetic_batch  # noqa: E402
from upsnet_torch.evaluation import inference  # noqa: E402
from upsnet_torch.evaluation.inference import bucket_anchors  # noqa: E402
from upsnet_torch.models import get_model, layers  # noqa: E402
from upsnet_torch.models.resnet import STAGE_BLOCKS  # noqa: E402
from upsnet_torch.models.upsnet import build_model, forward_predict  # noqa: E402
from upsnet_torch.ops import (  # noqa: E402
    cuda_build, deform_conv, deform_sample, deform_sample_mt, deform_shift, nms, roi_align_fpn)
from upsnet_torch.ops.deform_conv import clip_offsets, deform_conv2d_mt  # noqa: E402
from upsnet_torch.tools import bench_deform_impls  # noqa: E402
from upsnet_torch.train.checkpoints import save_checkpoint  # noqa: E402
from upsnet_torch.train.optimizer import make_optimizer  # noqa: E402
from upsnet_torch.train.step import make_train_step  # noqa: E402
from upsnet_torch.train.trainer import WATCHED_IMPLS, train_steps  # noqa: E402
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
EXPERIMENTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "experiments")
R101_DCN_YAML = os.path.join(EXPERIMENTS, "upsnet_resnet101_dcn_coco_3x_16gpu.yaml")
GN_YAML = os.path.join(EXPERIMENTS, "upsnet_r50_synth_rehearsal.yaml")


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
    """A short sha1 of the tensors' bytes in their logical order (whatever
    their memory format), so that two runs (a parent's and a change's) can
    be compared bit for bit from their logs."""
    h = hashlib.sha1()
    for t in tensors:
        h.update(t.detach().reshape(-1).contiguous().view(torch.uint8).cpu().numpy().tobytes())
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


def r101_backbone_maps() -> list:
    """(H, W, C) of the backbone DCN layers of the R101-DCN experiment at
    the 832x1344 bucket, one entry per distinct shape, from ``dcn_layers``:
    C3 104x168x128, C4 52x84x256, C5 26x42x512 (C = Cin = Cout)."""
    cfg = load_config(R101_DCN_YAML)
    cfg = cfg.replace(network=dataclasses.replace(cfg.network, fcn_with_dcn=False))
    return sorted({(shape[1], shape[2], cout) for shape, cout in dcn_layers(cfg)},
                  reverse=True)


def _tap_grid(dev) -> tuple:
    """The 3x3 kernel's row and column offsets, (9, 1, 1, 1) each."""
    kk = torch.arange(9, device=dev)
    return (kk // 3 - 1).float()[:, None, None, None], (kk % 3 - 1).float()[:, None, None, None]


def _k1_inputs(g, dev, b: int, h: int, w: int, c: int) -> tuple:
    """y9 (9, B, H, W, C) bf16 and the sample coordinates sy9, sx9 of a
    nine-tap layer: +-2 px offsets with 3% of the samples moved 6-12 px
    (``dcn_offsets``) and 1% pushed beyond the image edge."""
    taps = 9
    ky, kx = _tap_grid(dev)
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
K1_RTOL, K1_ATOL = 2.0 ** -7, 1e-4


def _check_k1(where: str, y9, sy9, sx9, k8a: bool = True) -> tuple:
    """K1 on one nine-tap layer in both layouts, side by side (the no-grad
    routes') and tap-major, and with ``k8a`` K8a on the side-by-side data:
    the same bits, and within one bf16 ulp of the plain version. Returns
    (the max abs error, the plain version's output)."""
    y_sbs = y9.permute(1, 2, 3, 0, 4).contiguous()
    got = deform_sample.deform_sample9(y_sbs, sy9, sx9, tap_axis=3)
    same = [deform_sample.deform_sample9(y9, sy9, sx9)]
    if k8a:
        same.append(deform_shift.shift_fwd(y_sbs.flatten(3), sy9, sx9))
    ref = deform_sample.deform_sample9_plain(y9, sy9, sx9)
    torch.cuda.synchronize()
    if not all(torch.equal(got, other) for other in same):
        raise AssertionError(f"K1 {where}: the side-by-side, tap-major{' and K8a' * k8a} "
                             f"results differ")
    err, rel = compare(got, ref, K1_RTOL, K1_ATOL)
    print(f"[K1 deform_sample9] {where}, y {tuple(y_sbs.shape)} side by side bf16: max abs err "
          f"{err:.3e}, max rel err {rel:.3e} (tolerance {K1_RTOL:.4g}*|ref| + {K1_ATOL:g}); "
          f"equal to tap-major K1{' and to K8a' * k8a}")
    return err, ref


def check_k1(dev) -> dict:
    """K1 at the three backbone shapes of the R101-DCN path
    (``r101_backbone_maps``, C 128 / 256 / 512) and the four FCN levels
    (P2 208x336 .. P5 26x42, C=128), bf16, 9 taps, on ``_k1_inputs``, in
    both layouts: side by side (B, H, W, 9, C), the output of the one matmul
    that the no-grad routes build (its numbers are the returned ones), and
    tap-major (9, B, H, W, C). At every shape the two layouts and K8a
    (``shift_fwd``) on the same side-by-side data must give the same bits,
    and lie within one bf16 ulp of the plain version (``_check_k1``). Times,
    the bound and the library yardstick are for P2; the tap-major time is
    printed beside the side-by-side one."""
    g = torch.Generator(device=dev).manual_seed(1)
    taps, b, c = 9, BATCH, 128
    max_abs = 0.0
    # the backbone's inputs from a generator of their own, so that the FCN
    # levels' inputs stay what they were; P2 last: its tensors are timed below
    g_backbone = torch.Generator(device=dev).manual_seed(21)
    cases = [(f"backbone {hh}x{ww}", hh, ww, cc, g_backbone)
             for hh, ww, cc in r101_backbone_maps()]
    cases += [(f"FCN P{s}", BUCKET[0] // 2 ** s, BUCKET[1] // 2 ** s, c, g)
              for s in (5, 4, 3, 2)]
    for where, h, w, cc, gen in cases:
        y9, sy9, sx9 = _k1_inputs(gen, dev, b, h, w, cc)
        err, ref = _check_k1(where, y9, sy9, sx9)
        max_abs = max(max_abs, err)
    y_sbs = y9.permute(1, 2, 3, 0, 4).contiguous()

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
    n_bytes = n_rows * c * 2 + 2 * sy9.numel() * 4 + ref.numel() * 2
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


def _random_rois(g, dev, n: int, bucket=BUCKET, batch: int = BATCH) -> torch.Tensor:
    """n RoIs per image over the ``bucket`` canvas: log-uniform 8-800 px
    sides, centers up to 60 px outside the image, and every tenth RoI
    wider than 256 px."""
    hh, ww = bucket
    side = torch.exp(torch.empty((batch, n, 2), device=dev).uniform_(
        math.log(8.0), math.log(800.0), generator=g))
    side[:, ::10, 0] = torch.empty((batch, side[:, ::10].shape[1]), device=dev).uniform_(
        260.0, 1100.0, generator=g)
    cx = torch.empty((batch, n), device=dev).uniform_(-60.0, ww + 60.0, generator=g)
    cy = torch.empty((batch, n), device=dev).uniform_(-60.0, hh + 60.0, generator=g)
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
                 else "") + (f"S={s_arg.group(1)} " if s_arg else "") + (
                     "runtime S " if "_any_" in name else "")
        parts.append(f"{label}{info.get('regs', '?')} registers, {info.get('spill', '?')} B "
                     f"spill stores, {info.get('stack', '?')} B stack")
    return "; ".join(sorted(parts)) or "not in the build log"


def _k4_bound(feats, rois, levels, pooled: int, c: int, s: int = 2) -> tuple[float, str, float]:
    """The bound of one bf16 K4 call at sampling ratio ``s``: bytes of the
    distinct feature rows its counted samples touch, the RoIs, levels and
    output; flops s^2 samples x 4 corners x 2 + 1 per output element.
    Returns (ms, what bounds it, bytes)."""
    n_rois = rois.shape[1]
    n = BATCH * n_rois
    dev = rois.device
    lev = levels.reshape(n).long()
    strides = torch.tensor([4.0, 8.0, 16.0, 32.0], device=dev)
    y, x = _sample_coords(rois.reshape(n, 4) / strides[lev][:, None], 1.0, pooled, s)
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
    ms, by = bound(n_bytes, n_out * (s * s * 4 * 2 + 1))
    return ms, by, n_bytes


def _check_k4_call(what: str, dtype: str, fs, rois, levels, pooled: int, s: int) -> tuple:
    """One K4 call on the levels ``fs`` against its plain version: finite,
    two runs bit-identical; at S 1, 2, 4 (the fused instances: the plain
    version's terms with one rounding fewer each, rounded once to T) within
    one bf16 ulp plus f32 slack near zero in bf16, 1e-5 max|ref| in f32; at
    any other S (the runtime-S path, which sums as the plain version sums)
    its bits. Returns (the max abs error, how it agreed)."""
    got = roi_align_fpn.fpn_roi_align(fs, rois, levels, pooled, s)
    again = roi_align_fpn.fpn_roi_align(fs, rois, levels, pooled, s)
    ref = roi_align_fpn.fpn_roi_align_plain(fs, rois, levels, pooled, s)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"K4 {what} {dtype}: two runs on the same inputs differ")
    if not torch.isfinite(got).all():
        raise AssertionError(f"K4 {what} {dtype}: output not finite")
    if s in (1, 2, 4):
        rtol, atol = (2.0 ** -7, 1e-4) if dtype == "bf16" else (
            0.0, 1e-5 * float(ref.abs().max()))
        max_abs, _ = compare(got, ref, rtol, atol)
        agree = f"max abs err {max_abs:.3e} (tolerance {rtol:.4g}*|ref| + {atol:.3g})"
    else:
        max_abs = float((got.float() - ref.float()).abs().max())
        bits = torch.int16 if dtype == "bf16" else torch.int32
        n_diff = int((got.view(bits) != ref.view(bits)).sum())
        if n_diff:
            raise AssertionError(f"K4 {what} {dtype}: {n_diff} elements differ in bits "
                                 f"from the plain version (max abs {max_abs:.3e})")
        agree = "the plain version's bits"
    return max_abs, f"{agree}, two runs bit-identical"


def check_k4(dev) -> dict:
    """K4 over an 832x1344 pyramid (C=256), batch 2, at the calls of a
    predict forward (1000 RoIs an image at 7x7, the box call; 100 at 14x14,
    the mask call) and of a train step (512 at 7x7; 128 at 14x14; the 100 GT
    slots at 14x14: 3 boxes and 97 all-zero padded ones), and at sampling
    ratio 3 (the runtime-S path) on the predict calls' RoIs, in bf16 and in
    float32. At each: against the plain version, which sums in the kernel's
    order, within one rounding at S 2 (the fused instance) and its bits at
    S 3 (the runtime-S path, unfused); two runs bit-identical, card ms and per
    call of 20 queued; in bf16 also the kernel's device time under the
    profiler (the small calls' queued time is the wrapper's host time), the
    plain time and the bound. The returned times and bounds are the sums
    over the two calls of a forward at the configured ratio 2."""
    g = torch.Generator(device=dev).manual_seed(2)
    c = 256
    feats = tuple(
        torch.randn((BATCH, -(-BUCKET[0] // s), -(-BUCKET[1] // s), c), generator=g,
                    device=dev).to(torch.bfloat16)
        for s in (4, 8, 16, 32))
    feats32 = tuple(f.float() for f in feats)
    # the predict RoIs come first from the generator, so their inputs and bound
    # do not depend on the train shapes
    box, mask = _random_rois(g, dev, 1000), _random_rois(g, dev, 100)
    calls = [("predict box", box, 7, 2), ("predict mask", mask, 14, 2),
             ("train box", _random_rois(g, dev, 512), 7, 2),
             ("train mask", _random_rois(g, dev, 128), 14, 2)]
    gt = torch.cat([_random_rois(g, dev, 3), torch.zeros((BATCH, 97, 4), device=dev)], 1)
    calls += [("train GT", gt.contiguous(), 14, 2), ("S3 box", box, 7, 3),
              ("S3 mask", mask, 14, 3)]
    regs = ptxas_registers("roi_align_fpn", "fpn_roi_align")
    print(f"[K4 fpn_roi_align] ptxas: {regs}")
    out = {"name": "fpn_roi_align", "route": "cuda",
           "source": "upsnet_torch/csrc/roi_align_fpn.cu",
           "replaces": "upsnet_tpu/ops/roi_align_pallas.py:265",
           "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
           "bound_by": "bytes", "library_ms": None}
    sums = {"predict": [0.0] * 4, "train": [0.0] * 4, "S3": [0.0] * 4}  # card, queued, device, bound
    for what, rois, pooled, s in calls:
        levels = (fpn_level_assignment(rois) - 2).to(torch.int32).contiguous()
        for dtype, fs in (("bf16", feats), ("f32", feats32)):
            run = lambda: roi_align_fpn.fpn_roi_align(fs, rois, levels, pooled, s)  # noqa: E731
            max_abs, agree = _check_k4_call(what, dtype, fs, rois, levels, pooled, s)
            out["max_abs_err"] = max(out["max_abs_err"], max_abs)
            head = (f"[K4 fpn_roi_align] {what}, {rois.shape[1]} RoIs x2 at {pooled}x{pooled}, "
                    f"S {s}, {dtype}: {agree}")
            if dtype == "f32":
                print(f"{head}; kernel {time_ms(run):.4f} ms (queued {time_queued_ms(run):.4f})")
                continue
            ms, queued = time_ms(run), time_queued_ms(run)
            dev_ms = device_ms(run, "fpn_roi_align")
            plain_ms = time_ms(
                lambda: roi_align_fpn.fpn_roi_align_plain(fs, rois, levels, pooled, s), 10)
            bound_ms, bound_by, n_bytes = _k4_bound(fs, rois, levels, pooled, c, s)
            print(f"{head}; kernel {ms:.4f} ms (queued {queued:.4f}, device {dev_ms:.4f}), "
                  f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
                  f"{n_bytes / 1e6:.1f} MB; {100 * bound_ms / dev_ms:.1f}% of it on the device)")
            phase = sums[what.split()[0]]
            for i, v in enumerate((ms, queued, dev_ms, bound_ms)):
                phase[i] += v
            if what.startswith("predict"):
                out["ms"] += ms
                out["plain_ms"] += plain_ms
                out["bound_ms"] += bound_ms
    for phase, (ms, queued, dev_ms, bound_ms) in sums.items():
        unit = {"predict": "the calls of a predict forward", "train": "the calls of a train step",
                "S3": "the predict calls at S 3"}[phase]
        print(f"[K4 fpn_roi_align] {unit}, bf16: kernel {ms:.4f} ms ({100 * bound_ms / ms:.1f}% of "
              f"the bound), queued {queued:.4f} ms ({100 * bound_ms / queued:.1f}%), device "
              f"{dev_ms:.4f} ms ({100 * bound_ms / dev_ms:.1f}%), bound {bound_ms:.4f} ms")
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


def _k2_layer(g, dev, b: int, h: int, w: int, c: int, dtype, field: str) -> tuple:
    """y (9, B, H, W, C) in ``dtype``, sy, sx of a nine-tap layer on an
    h x w x c map, tap-major: offsets ``field`` '+-2 px' (``dcn_offsets``)
    or '+-40 px' (uniform), then ``_mark_integers``."""
    taps = 9
    ky, kx = _tap_grid(dev)
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


def _k2_chain(y, sy, sx):
    """The layer as the one-tap K2 did it: 9 launches, 8 adds."""
    out = deform_sample.deform_sample(y[0], sy[0], sx[0])
    for t in range(1, y.shape[0]):
        out = out + deform_sample.deform_sample(y[t], sy[t], sx[t])
    return out


def _check_k2(what: str, y, sy, sx) -> tuple:
    """``_check_forward_taps`` of the all-tap K2 on one tap-major layer."""
    return _check_forward_taps(
        what, deform_sample.deform_sample_taps(y, sy, sx), _k2_chain(y, sy, sx),
        deform_sample.deform_sample_taps_plain(y, sy, sx),
        lambda t: deform_sample.deform_sample_plain(y[t], sy[t], sx[t]), y.shape[0])


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
    168 x 128) at +-2 px, and the bf16 form at the three backbone shapes of
    the R101-DCN path (``r101_backbone_maps``, C 128 / 256 / 512) at +-2 px,
    held the same way (the equality and the plain version's tolerance; not
    timed)."""
    g = torch.Generator(device=dev).manual_seed(13)
    taps, b, c = 9, BATCH, 128

    h, w = BUCKET[0] // 4, BUCKET[1] // 4
    row = {}
    for field in ("+-2 px", "+-40 px"):
        y, sy, sx = _k2_layer(g, dev, b, h, w, c, torch.bfloat16, field)
        planes = [y[t].float().permute(0, 3, 1, 2).contiguous() for t in range(taps)]
        err, rel = _check_k2("K2 taps", y, sy, sx)
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
        queued = [time_queued_ms(f) for f in (run, lambda: _k2_chain(y, sy, sx))]
        chain_ms = time_ms(lambda: _k2_chain(y, sy, sx))
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
    y, sy, sx = _k2_layer(g, dev, b, h // 2, w // 2, c, torch.float32, "+-2 px")
    err, rel = _check_k2("K2 taps float32", y, sy, sx)
    print(f"[K2 deform_sample_taps] +-2 px, y {tuple(y.shape)} float32: equal to 9 one-tap K2 "
          f"and 8 adds; against the plain version max abs err {err:.3e}, max rel err "
          f"{rel:.3e} (tolerance 2^-20 * (sum |tap| + sum |partial|) + 1e-5)")
    del y, sy, sx
    for hh, ww, cc in r101_backbone_maps():
        y, sy, sx = _k2_layer(g, dev, b, hh, ww, cc, torch.bfloat16, "+-2 px")
        err, rel = _check_k2(f"K2 taps backbone {hh}x{ww}x{cc}", y, sy, sx)
        row["max_abs_err"] = max(row["max_abs_err"], err)
        print(f"[K2 deform_sample_taps] backbone, +-2 px, y {tuple(y.shape)} bf16: equal to 9 "
              f"one-tap K2 and 8 adds; against the plain version max abs err {err:.3e}, max "
              f"rel err {rel:.3e} (tolerance 2^-7 * (sum |tap| + sum |partial|) + 1e-4)")
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


# overlapping RoIs add up to thousands of f32 terms per element, in another
# order than the plain version's, then round once to bf16: one bf16 ulp,
# plus 1e-3 where the terms cancel
K5_RTOL, K5_ATOL = 2.0 ** -7, 1e-3


def _check_k5_call(grad, rois, levels, shapes, dtypes) -> tuple:
    """One K5 call against its plain version: every level gradient within
    (K5_RTOL, K5_ATOL), the same bits on two runs, not all zero. Returns
    the max abs and rel errors."""
    got = roi_align_fpn.fpn_roi_align_bwd(grad, rois, levels, shapes, dtypes)
    again = roi_align_fpn.fpn_roi_align_bwd(grad, rois, levels, shapes, dtypes)
    ref = roi_align_fpn.fpn_roi_align_bwd_plain(grad, rois, levels, shapes, dtypes)
    torch.cuda.synchronize()
    errs = [compare(a, r, K5_RTOL, K5_ATOL) for a, r in zip(got, ref)]
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError("K5: two runs on the same inputs differ")
    if not any(float(a.abs().max()) > 0 for a in got):
        raise AssertionError("K5: all level gradients are zero")
    return max(e[0] for e in errs), max(e[1] for e in errs)


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
        max_abs, max_rel = _check_k5_call(grad, rois, levels, shapes, dtypes)
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
              f"err {max_abs:.3e}, max rel err {max_rel:.3e} (tolerance "
              f"{K5_RTOL:.4g}*|ref| + {K5_ATOL:g}); two runs bit-identical; kernel {ms:.4f} ms, "
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
    gsy, gsx: f32 sums of 4 x C products of O(1) values in another order:
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


def _k3_layer(g, dev, b: int, h: int, w: int, c: int, tap_axis: int, max_d: int) -> tuple:
    """y, grad, sy, sx of a nine-tap layer on a b x h x w x c map, bf16, y
    tap-major (``tap_axis`` 0) or side by side (3): ``dcn_offsets`` clipped
    to +-``max_d``, then ``_mark_integers``; within reach ``max_d + 1``."""
    taps = 9
    ky, kx = _tap_grid(dev)
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
    deform_sample.check_reach(sy, sx, max_d + 1, None)
    return y, grad, sy, sx


def _check_k3(tag: str, y, grad, sy, sx, tap_axis: int, reach: int) -> tuple:
    """``_check_taps_backward`` of the clipped all-tap K3 on one layer."""
    return _check_taps_backward(
        f"K3 taps {tag}",
        lambda: deform_sample.deform_sample_bwd_taps(y, sy, sx, grad, reach, tap_axis),
        deform_sample.deform_sample_bwd_taps_plain(y, sy, sx, grad, reach, tap_axis), sy, sx,
        f"[K3 deform_sample_bwd_taps] {tag}, y {tuple(y.shape)} bf16")


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
    one-tap form. Then, held the same way and not timed, tap-major at the
    three backbone shapes of the R101-DCN path (``r101_backbone_maps``,
    C 128 / 256 / 512)."""
    g = torch.Generator(device=dev).manual_seed(9)
    taps, c, max_d = 9, 128, 6
    reach = max_d + 1  # max_dy + half * dilation

    row = {}
    for tag, b, (h, w) in (("P2 tap-major", BATCH, (BUCKET[0] // 4, BUCKET[1] // 4)),
                           ("wide P2 side by side", WIDE_BATCH,
                            (WIDE_BUCKET[0] // 4, WIDE_BUCKET[1] // 4))):
        tap_axis = 0 if tag.endswith("tap-major") else 3
        y, grad, sy, sx = _k3_layer(g, dev, b, h, w, c, tap_axis, max_d)
        gy_err, gy_rel, gsy_err, gsx_err = _check_k3(tag, y, grad, sy, sx, tap_axis, reach)
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
    # the training route's layout at the backbone shapes of the R101-DCN path
    g_backbone = torch.Generator(device=dev).manual_seed(22)
    for hh, ww, cc in r101_backbone_maps():
        y, grad, sy, sx = _k3_layer(g_backbone, dev, BATCH, hh, ww, cc, 0, max_d)
        errs = _check_k3(f"backbone {hh}x{ww} tap-major", y, grad, sy, sx, 0, reach)
        row["max_abs_err"] = max(row["max_abs_err"], errs[0], errs[2], errs[3])
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


def check_entry_shapes(dev, rows: list) -> None:
    """The kernels of the train entry and of the two evaluation phases at
    the shapes those paths give them, which the checks above (batch 2 at
    832x1344) do not reach. Each is held as its check above holds it, at
    the same tolerance, bf16 (the files' compute dtype), and not timed:

    - ``train_entry`` (``GN_YAML``: batch 8 in each of its buckets,
      832x1344 and 1344x832): at every DCN layer's map (``dcn_layers``) the
      all-tap K2 at +-2 px (``_check_k2``), the clipped all-tap K3
      tap-major at the file's ``dcn_max_dy`` (8, reach 9; ``_check_k3``)
      and K1 (the saturation probe's pass; ``_check_k1``); K4 and K5 at the
      three calls of a step: ``batch_rois`` RoIs at the box size,
      ``batch_rois * fg_fraction`` and the ``max_gt_instances`` GT slots (3
      of them boxes, the others padding with no gradient) at the mask size;
    - the evaluations at batch 1 (``GN_YAML``'s test buckets,
      ``CITY_YAML``'s 1024x2048, and ``R101_DCN_YAML``'s, which every TTA
      scale of ``eval_tta``, 640, 800 and 960, lands in): K1 at every DCN
      layer's map (the R101-DCN backbone's C3-C5 too) and K4 at the two calls
      of a request (``rpn_post_nms_top_n`` RoIs at the box size, ``max_det``
      at the mask size).

    Each kernel's largest error joins its entry of ``rows``."""
    by_name = {r["name"]: r for r in rows}
    g = torch.Generator(device=dev).manual_seed(31)

    def fold(name: str, err: float) -> None:
        by_name[name]["max_abs_err"] = max(by_name[name]["max_abs_err"], err)

    def maps(cfg, bucket, batch: int) -> list:
        return sorted({(*shape[:3], cout) for shape, cout in dcn_layers(cfg, bucket, batch)},
                      reverse=True)

    def levels_of(cfg, bucket, batch: int) -> list:
        c = cfg.network.fpn_feature_dim
        return [(batch, -(-bucket[0] // s), -(-bucket[1] // s), c) for s in (4, 8, 16, 32)]

    def roi_calls(cfg, bucket, batch: int, grad: bool) -> list:
        net = cfg.network
        if not grad:
            return [("box", _random_rois(g, dev, cfg.test.rpn_post_nms_top_n, bucket, batch),
                     net.pooled_size_box),
                    ("mask", _random_rois(g, dev, cfg.test.max_det, bucket, batch),
                     net.pooled_size_mask)]
        tc = cfg.train
        gt = _random_rois(g, dev, tc.max_gt_instances, bucket, batch)
        gt[:, 3:] = 0.0
        return [("box", _random_rois(g, dev, tc.batch_rois, bucket, batch), net.pooled_size_box),
                ("mask", _random_rois(g, dev, int(tc.batch_rois * tc.fg_fraction), bucket, batch),
                 net.pooled_size_mask),
                ("GT", gt.contiguous(), net.pooled_size_mask)]

    def check_roi_align(tag: str, cfg, bucket, batch: int, grad: bool) -> None:
        shapes = levels_of(cfg, bucket, batch)
        feats = tuple(torch.randn(sh, generator=g, device=dev).to(torch.bfloat16)
                      for sh in shapes)
        s = cfg.network.roi_sampling_ratio
        for what, rois, pooled in roi_calls(cfg, bucket, batch, grad):
            levels = (fpn_level_assignment(rois) - 2).to(torch.int32).contiguous()
            err, agree = _check_k4_call(f"{tag} {what}", "bf16", feats, rois, levels, pooled, s)
            fold("fpn_roi_align", err)
            head = f"{tag} {what}, {rois.shape[1]} RoIs x{batch} at {pooled}x{pooled}, S {s}, bf16"
            print(f"[K4 fpn_roi_align] {head}: {agree}")
            if not grad:
                continue
            n = rois.shape[1]
            dy = torch.randn((batch, n, pooled, pooled, shapes[0][3]), generator=g,
                             device=dev).to(torch.bfloat16)
            if what == "GT":
                dy[:, 3:] = 0.0
            err, rel = _check_k5_call(dy, rois, levels, shapes, [torch.bfloat16] * 4)
            fold("fpn_roi_align_bwd", err)
            print(f"[K5 fpn_roi_align_bwd] {head}: max abs err {err:.3e}, max rel err {rel:.3e} "
                  f"(tolerance {K5_RTOL:.4g}*|ref| + {K5_ATOL:g}); two runs bit-identical")
            del dy
        del feats
        torch.cuda.empty_cache()

    gn = load_config(GN_YAML)
    tc, net = gn.train, gn.network
    for bucket in map(tuple, tc.image_buckets):
        tag = f"train_entry {bucket[0]}x{bucket[1]}"
        for b, h, w, c in maps(gn, bucket, tc.batch_size):
            where = f"{tag}, map {h}x{w}x{c}"
            y, sy, sx = _k2_layer(g, dev, b, h, w, c, torch.bfloat16, "+-2 px")
            err, rel = _check_k2(f"K2 taps {where}", y, sy, sx)
            fold("deform_sample_taps", err)
            print(f"[K2 deform_sample_taps] {where}, +-2 px, y {tuple(y.shape)} bf16: equal to 9 "
                  f"one-tap K2 and 8 adds; against the plain version max abs err {err:.3e}, max "
                  f"rel err {rel:.3e} (tolerance 2^-7 * (sum |tap| + sum |partial|) + 1e-4)")
            del y, sy, sx
            y, grad, sy, sx = _k3_layer(g, dev, b, h, w, c, 0, net.dcn_max_dy)
            errs = _check_k3(f"{where} tap-major, clipped +-{net.dcn_max_dy}", y, grad, sy, sx,
                             0, net.dcn_max_dy + 1)
            fold("deform_sample_bwd_taps", max(errs[0], errs[2], errs[3]))
            del y, grad, sy, sx
            y9, sy9, sx9 = _k1_inputs(g, dev, b, h, w, c)
            fold("deform_sample9", _check_k1(f"{where} (the probe)", y9, sy9, sx9, k8a=False)[0])
            del y9, sy9, sx9
            torch.cuda.empty_cache()
        check_roi_align(tag, gn, bucket, tc.batch_size, grad=True)
    for name, cfg in (("train_entry eval", gn), ("eval_cityscapes", load_config(CITY_YAML)),
                      ("eval_tta", load_config(R101_DCN_YAML))):
        for bucket in map(tuple, cfg.test.image_buckets):
            tag = f"{name} {bucket[0]}x{bucket[1]}"
            for b, h, w, c in maps(cfg, bucket, 1):
                y9, sy9, sx9 = _k1_inputs(g, dev, b, h, w, c)
                fold("deform_sample9", _check_k1(f"{tag}, map {h}x{w}x{c}", y9, sy9, sx9,
                                                 k8a=False)[0])
                del y9, sy9, sx9
            check_roi_align(tag, cfg, bucket, 1, grad=False)


def dcn_layers(cfg, bucket=BUCKET, batch: int = BATCH) -> list:
    """(input shape (B, H, W, Cin), Cout) of every deformable conv that one
    pass of the trunk of ``cfg`` runs at ``bucket``: where
    ``backbone_with_dcn`` is set, the 3x3 of each bottleneck of the stages in
    ``dcn_stages`` (stage s at stride 2^s, Cin = Cout = 64 * 2^(s-2), the
    caffe stride being on the block's first 1x1), then the FCN head's layers
    at P2..P5."""
    net = cfg.network
    out = []
    if net.backbone_with_dcn:
        for stage in net.dcn_stages:
            h, w = -(-bucket[0] // 2 ** stage), -(-bucket[1] // 2 ** stage)
            width = 64 * 2 ** (stage - 2)
            out += [((batch, h, w, width), width)] * STAGE_BLOCKS[net.backbone][stage - 2]
    if net.fcn_with_dcn:
        for stride in (4, 8, 16, 32):
            h, w = -(-bucket[0] // stride), -(-bucket[1] // stride)
            for layer in range(net.fcn_num_layers):
                cin = net.fpn_feature_dim if layer == 0 else net.fcn_head_dim
                out.append(((batch, h, w, cin), net.fcn_head_dim))
    return out


def expected_launches(cfg, grad: bool, heads: bool = True, bucket=BUCKET,
                      batch: int = BATCH) -> dict:
    """The launches of one ``forward_predict`` (grad False) or one train step
    (grad True) of ``cfg`` at ``bucket``, from the port's routing rules, each
    DCN layer of ``dcn_layers`` routed with its own shape and Cout. A layer
    that ``dcn_impl: shift`` sends to the shift route launches K8a (and K8b +
    K8c in backward); one that ``pallas`` or the fallback of ``shift`` sends
    to the tiled form launches the all-tap K6 (and the all-tap K3's two
    passes in backward); any other launches K1 without autograd, and with it
    the all-tap K2 and the two passes of the all-tap K3, clipped where dy is
    (``pallas``, ``mxu``, ``shift``'s fallback), else (``auto``, ``gather``)
    unclipped. The one-tap K2 and K6 run on no path. ``heads`` False leaves
    out the ROIAlign calls (a pass of the trunk alone)."""
    net = cfg.network
    impl = (net.dcn_impl_train or net.dcn_impl) if grad else net.dcn_impl
    n = dict.fromkeys(COUNTERS, 0)
    for shape, cout in dcn_layers(cfg, bucket, batch):
        if impl == "shift" and deform_shift.shift_route_ok(
                shape, cout, net.dcn_max_dy, net.dcn_max_dy, 1):
            n["shift_fwd"] += 1
            n["shift_adjoint"] += grad
            n["shift_offset_grads"] += grad
        elif impl in ("pallas", "shift") and deform_sample.pallas_route(
                shape, cout, net.dcn_max_dy, 1)[0] == "tiled":
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


def describe(cfg) -> str:
    net, ds = cfg.network, cfg.dataset
    stages = tuple(net.dcn_stages) if net.backbone_with_dcn else "none"
    return (f"{cfg.symbol} ({net.backbone}, norm {net.norm}, backbone DCN stages {stages}): "
            f"{ds.num_classes} classes, {ds.num_seg_classes} seg classes, fpn "
            f"{net.fpn_feature_dim}, fcn {net.fcn_head_dim}, fc {net.rcnn_fc_dim}, "
            f"{net.compute_dtype}, dcn_impl {net.dcn_impl}, dcn_impl_train "
            f"{net.dcn_impl_train or net.dcn_impl}, dcn_max_dy {net.dcn_max_dy}, "
            f"dcn_boundary_grad {net.dcn_boundary_grad}")


def phase_predict(dev, impl: str = "auto", tag: str = "predict", bucket=BUCKET,
                  im_hw=IM_HW, batch_size: int = BATCH, cfg=None, shrink_bn: bool = False):
    """Two full-width requests of ``batch_size`` images on the ``bucket``
    canvas through ``forward_predict``, of ``cfg`` (default: the default
    config with ``dcn_impl: impl``) built through the model registry, with
    frozen-BN scales shrunk where ``shrink_bn``. Returns (launches, a closure
    that serves one more request, the model, the last batch and its
    seg_logits)."""
    if cfg is None:
        cfg = default_config()
        cfg = cfg.replace(network=dataclasses.replace(cfg.network, dcn_impl=impl))
    ds = cfg.dataset
    expect_n = expected_launches(cfg, grad=False, bucket=bucket, batch=batch_size)
    print(f"[{tag}] {describe(cfg)}; bucket {bucket}, batch {batch_size}")
    gen = torch.Generator().manual_seed(cfg.seed)
    t0 = time.perf_counter()
    model = get_model(cfg.symbol, cfg, device=dev, generator=gen)
    perturb_offset_biases(model, gen)
    if shrink_bn:
        shrink_bn_scales(model, gen)
    anchors = bucket_anchors(cfg, bucket, dev)
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
                  "fpn_roi_align_kernel": "K4", "fpn_roi_align_any_kernel": "K4 runtime S",
                  "fpn_roi_align_bwd_kernel": "K5",
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
                bucket=BUCKET, im_hw=IM_HW, batch_size: int = BATCH, cfg=None):
    """``n_steps`` SGD steps of the full-width model of ``cfg`` (default: the
    default config with ``dcn_impl: impl``, ``dcn_boundary_grad: clip``),
    built through the model registry, on one synthetic batch of
    ``batch_size`` images on the ``bucket`` canvas, through ``train_steps``
    with a display interval of one step and the saturation watch set to
    'warn'. Frozen-BN scales are shrunk (a GroupNorm model has none). Every
    trainable GroupNorm parameter must move, and where the backbone has DCN layers
    each of their stages must get a non-zero offset-conv gradient. Returns
    (launches, a closure that takes one more step, the per-step loss
    dicts)."""
    if cfg is None:
        cfg = default_config()
        cfg = cfg.replace(network=dataclasses.replace(
            cfg.network, dcn_impl=impl, dcn_boundary_grad="clip", roi_align_impl="window"))
    cfg = cfg.replace(
        output_path=os.path.join("output", f"chip_smoke_{tag}"),
        # 'warn': from random weights at lr 0.02 one update drives most
        # offsets beyond the window, and the watch's default would end the run
        network=dataclasses.replace(cfg.network, dcn_saturation_action="warn"),
        train=dataclasses.replace(cfg.train, display_iter=1))
    net, tc = cfg.network, cfg.train
    print(f"[{tag}] {describe(cfg)}; {net.param_dtype} parameters, bucket {bucket}, batch "
          f"{batch_size}, batch_rois {tc.batch_rois}, rpn_batch_size {tc.rpn_batch_size}, "
          f"{tc.max_gt_instances} GT slots, lr {tc.lr}, grad_clip {tc.grad_clip}")
    # one interval is one step and, where the loop watches the clip
    # ('pallas'), the watch's probe: a pass of the trunk without autograd
    watched = (net.dcn_impl_train or net.dcn_impl) in WATCHED_IMPLS
    expect_n = expected_launches(cfg, grad=True, bucket=bucket, batch=batch_size)
    if watched:
        probe = expected_launches(cfg, grad=False, heads=False, bucket=bucket,
                                  batch=batch_size)
        expect_n = {k: v + probe[k] for k, v in expect_n.items()}
    metrics_path = os.path.join(cfg.output_path, cfg.symbol, "metrics.jsonl")
    if os.path.exists(metrics_path):
        os.remove(metrics_path)
    gen = torch.Generator().manual_seed(cfg.seed)
    model = get_model(cfg.symbol, cfg, device=dev, generator=gen)
    perturb_offset_biases(model, gen)
    shrink_bn_scales(model, gen)  # losses of a sane order, so the steps mean something
    anchors = bucket_anchors(cfg, bucket, dev)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in synthetic_batch(
        cfg, bucket, batch_size, seed=7, image_hw=tuple(int(x) for x in im_hw)).items()}
    frozen = {n: p.detach().clone() for n, p in model.named_parameters()
              if not p.requires_grad}
    trainable = {n: p for n, p in model.named_parameters() if p.requires_grad}
    gn_names = {f"{m_name}.{p_name}" for m_name, m in model.named_modules()
                if isinstance(m, layers.GroupNorm) for p_name in ("scale", "bias")}
    gn_before = {n: p.detach().clone() for n, p in trainable.items() if n in gn_names}
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
    if net.backbone_with_dcn:
        for stage in net.dcn_stages:
            layer = {n: v for n, v in offset_grads.items()
                     if n.startswith(f"backbone_net.res{stage}_")}
            if not layer or max(layer.values()) == 0.0:
                raise AssertionError(f"C{stage}: no non-zero offset-conv gradient in its "
                                     f"backbone DCN layers {sorted(layer)}")
        print(f"[{tag}] backbone offset-conv max |grad| per stage: " + ", ".join(
            f"C{st} {max(v for n, v in offset_grads.items() if n.startswith(f'backbone_net.res{st}_')):.3e}"
            for st in net.dcn_stages))
    now = dict(model.named_parameters())
    for name, before in frozen.items():
        if not torch.equal(now[name], before):
            raise AssertionError(f"frozen parameter {name} changed")
    still = [n for n, before in gn_before.items() if torch.equal(now[n], before)]
    if still:
        raise AssertionError(f"trainable GroupNorm parameters unchanged: {still}")
    if gn_names:
        frozen_gn = sorted(n for n in gn_names if n in frozen)
        print(f"[{tag}] GroupNorm: {len(gn_before)} trainable tensors all moved; "
              f"{len(frozen_gn)} frozen ones bit-equal (stem and res2: {frozen_gn[:2]} ...)")
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
          + ", ".join(f"{n} {v:.3e}" for n, v in offset_grads.items()
                      if not n.startswith("backbone_net.")))
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


def phase_reference(dev, norm: str = "frozen_bn", dcn_stages=()) -> None:
    """A tiny float32 model on the card (kernels, cuDNN) against the same
    weights on the CPU (plain versions), with the backbone's ``norm`` and
    deformable convs in ``dcn_stages``."""
    cfg = default_config()
    cfg = cfg.replace(
        network=dataclasses.replace(cfg.network, backbone="resnet_test", fpn_feature_dim=32,
                                    rcnn_fc_dim=64, fcn_head_dim=16, compute_dtype="float32",
                                    norm=norm, backbone_with_dcn=bool(dcn_stages),
                                    dcn_stages=tuple(dcn_stages) or (3, 4, 5)),
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
        anchors = bucket_anchors(cfg, hw, d)
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
    n_dcn = sum(isinstance(m, layers.DeformConv) for m in gpu_model.backbone_net.modules())
    print(f"[reference] tiny f32 model, norm {norm}, {n_dcn} backbone DCN layers, card vs CPU: "
          f"seg_logits max abs err {seg_err:.3e} "
          f"(max |ref| {seg_scale:.3f}); discrete outputs equal {same}; boxes max abs "
          f"err {box_err}")


R50_COCO_YAML = os.path.join(EXPERIMENTS, "upsnet_resnet50_coco_4gpu.yaml")
TINY_YAML = os.path.join(EXPERIMENTS, "upsnet_tiny_synthetic.yaml")
EVAL_IMAGES = 8
# PQ / SQ / RQ, AP and mIoU of the card's run against the CPU's: the
# tolerance of tests/test_torch_eval_loop.py (the port against JAX)
METRIC_ABS = 1e-3


def run_eval_entry(tag: str, argv: list, expect_image: dict, n_images: int = EVAL_IMAGES):
    """``upsnet_torch.tools.test`` on ``argv``, as a user runs it, with the
    launch counters set to 0 just before it and read just after, and each
    image's ``predict_step`` timed and its launches counted: each of the
    ``n_images`` images must launch exactly ``expect_image``. Returns
    (results, timings, launches, per-image predict ms)."""
    from upsnet_torch.tools import test as test_cli

    orig = inference.predict_step
    per_image, predict_ms = [], []

    def counted(*a, **kw):
        before = read_launches()
        t0 = time.perf_counter()
        out = orig(*a, **kw)  # ends in a copy to the host: the device is done
        predict_ms.append((time.perf_counter() - t0) * 1e3)
        per_image.append({k: v - before[k] for k, v in read_launches().items()})
        return out

    reset_launches()
    inference.predict_step = counted
    try:
        results, timings = test_cli.run(argv)
    finally:
        inference.predict_step = orig
    launches = read_launches()
    if len(per_image) != n_images or any(m != expect_image for m in per_image):
        raise AssertionError(f"[{tag}] launches per image {[nonzero(m) for m in per_image]}, "
                             f"expected {nonzero(expect_image)} for each of {n_images}")
    if set(results) != {"boxes", "masks", "ssegs", "panoptic"}:
        raise AssertionError(f"[{tag}] results {sorted(results)}")
    return results, timings, launches, predict_ms


def headline(results: dict) -> dict:
    """The metrics compared and reported: PQ / SQ / RQ of All, Things and
    Stuff, box and mask AP / AP50 / AP75, mIoU and pixel accuracy."""
    out = {f"{k}.{m}": results[k][m] for k in ("boxes", "masks") for m in ("AP", "AP50", "AP75")}
    out.update({f"ssegs.{m}": results["ssegs"][m] for m in ("mIoU", "pixel_acc")})
    out.update({f"pq.{part}.{m}": results["panoptic"][part][m]
                for part in ("All", "Things", "Stuff") for m in ("pq", "sq", "rq")})
    return out


def device_busy(run, prefix: str = "predict.") -> dict:
    """``run()`` under torch.profiler: the summed device ms and the count of
    the device ops (kernels and copies) that start inside the device ranges
    of the ``<prefix>*`` profiler ranges (a forward's stages and its copy to
    the host), the same over the whole run (model build and weight copies
    included), and the run's wall ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans, ops = [], []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        if e.name.startswith(prefix):
            spans.append((e.time_range.start, e.time_range.end))
        else:
            ops.append(e)
    inside = [e for e in ops if any(s <= e.time_range.start <= t for s, t in spans)]
    return {"busy_ms": sum(e.time_range.elapsed_us() for e in inside) / 1e3,
            "ops": len(inside), "all_busy_ms": sum(e.time_range.elapsed_us() for e in ops) / 1e3,
            "all_ops": len(ops), "wall_ms": wall}


def phase_eval_r50coco(dev) -> dict:
    """The evaluation entry at full width: ``resnet_50_upsnet`` from
    ``experiments/upsnet_resnet50_coco_4gpu.yaml`` (COCO heads, bf16, its
    ``dcn_impl``), seeded random weights with the offset biases at +-2 px
    written as a port checkpoint, then ``upsnet_torch.tools.test`` with
    ``--weights`` on 8 synthetic 256x320 scenes resized into the 832x1344
    bucket, one image a forward: 8 K1 and 2 K4 an image. Run cold, warm,
    and a third time under torch.profiler for the device's busy time."""
    tag = "eval_r50coco"
    cfg = load_config(R50_COCO_YAML)
    print(f"[{tag}] {os.path.basename(R50_COCO_YAML)}: {describe(cfg)}")
    meta = SyntheticDataset(cfg, 1, training=False).sample(0)
    if meta["images"].shape != (*BUCKET, 3) or tuple(meta["im_hw"]) != (800.0, 1000.0):
        raise AssertionError(f"a 256x320 scene lands in {meta['images'].shape} at "
                             f"{tuple(meta['im_hw'])}, expected {BUCKET} at (800, 1000)")
    gen = torch.Generator().manual_seed(cfg.seed)
    model = get_model(cfg.symbol, cfg, device=dev, generator=gen)
    perturb_offset_biases(model, gen)
    ckpt = save_checkpoint(os.path.join("output", f"chip_smoke_{tag}"), 0, model)
    del model
    torch.cuda.empty_cache()
    argv = ["--cfg", R50_COCO_YAML, "--dataset-override", "synthetic", "--max-images",
            str(EVAL_IMAGES), "--no-artifacts", "--weights", ckpt]
    expect = expected_launches(cfg, grad=False, batch=1)
    torch.cuda.reset_peak_memory_stats()
    # run 0 is cold (cuDNN's first use falls on its image 0), run 1 warm
    for run in range(2):
        results, timings, counts, predict_ms = run_eval_entry(tag, argv, expect)
        n = timings["images"]
        print(f"[{tag}] run {run}: {n} images ({timings['detections']} detections) in "
              f"{timings['wall_s']:.3f} s = "
              f"{n / timings['wall_s']:.2f} img/s (samples, predict, postprocess and "
              f"evaluators); per image: sample {timings['sample_s'] * 1e3 / n:.2f} ms, predict "
              f"{timings['predict_s'] * 1e3 / n:.2f} ms (image 0 {predict_ms[0]:.2f} ms, images "
              f"1-{n - 1} median {statistics.median(predict_ms[1:]):.2f} ms), host postprocess "
              f"{timings['postprocess_s'] * 1e3 / n:.2f} ms; evaluators "
              f"{timings['evaluate_s']:.3f} s; RLE codec {timings['rle_codec']}")
        if run == 0:
            launches = counts
    peak = torch.cuda.max_memory_allocated()
    prof = device_busy(lambda: run_eval_entry(tag, argv, expect))
    wall_image = timings["wall_s"] * 1e3 / n
    busy = prof["busy_ms"] / n
    print(f"[{tag}] device busy {busy:.2f} ms an image inside predict_step ({prof['ops'] / n:.0f} "
          f"device ops; the profiled run's whole device time {prof['all_busy_ms']:.1f} ms over "
          f"{prof['all_ops']} ops, model build and weight copies included, wall "
          f"{prof['wall_ms']:.1f} ms); host share of run 1's time an image "
          f"{1 - busy / wall_image:.3f} ({wall_image:.2f} ms); peak memory allocated "
          f"{peak / 2 ** 30:.3f} GiB")
    print(f"[{tag}] launches per image {nonzero(expect)}; metrics (random weights): "
          + json.dumps(headline(results)))
    return launches


def _train_samples(cfg, batch_size: int, n_steps: int, dev):
    """Batches of the 8 evaluation scenes as the dataset trains on them
    (``SyntheticDataset(training=True).sample``: seeded scale and flip, GT at
    1/4 scale), ``batch_size`` a step in turn, on ``dev``."""
    ds = SyntheticDataset(cfg, EVAL_IMAGES, training=True)
    rng = np.random.RandomState(0)
    keys = ("images", "im_hw", "gt_boxes", "gt_classes", "gt_valid", "gt_masks", "seg_gt",
            "crowd_boxes", "crowd_valid")
    for step in range(n_steps):
        samples = [ds.sample((step * batch_size + j) % len(ds), rng) for j in range(batch_size)]
        yield {k: torch.as_tensor(np.stack([s[k] for s in samples])).to(dev) for k in keys}


def phase_eval_tiny(dev) -> dict:
    """The first accuracy figure on the card: the tiny synthetic config
    (``experiments/upsnet_tiny_synthetic.yaml``) trains its file's schedule
    (``max_iteration`` steps at batch ``train.batch_size``) on the card under
    its ``dcn_impl_train`` through ``train_steps``, on the 8 evaluation
    scenes, is saved with ``save_checkpoint`` and evaluated by
    ``upsnet_torch.tools.test`` twice: ``--dcn-impl auto`` on the card (8 K1,
    2 K4 an image) and ``--device cpu`` (plain versions, no launch). The
    metrics must agree within ``METRIC_ABS``."""
    tag = "eval_tiny"
    cfg = load_config(TINY_YAML)
    cfg = cfg.replace(output_path=os.path.join("output", f"chip_smoke_{tag}"))
    tc = cfg.train
    n_steps, bucket = tc.max_iteration, tuple(tc.image_buckets[0])
    print(f"[{tag}] {os.path.basename(TINY_YAML)}: {describe(cfg)}; {n_steps} steps at batch "
          f"{tc.batch_size}, lr {tc.lr}, warmup {tc.warmup_iteration}, decay at "
          f"{tc.decay_iteration}")
    metrics_path = os.path.join(cfg.output_path, cfg.symbol, "metrics.jsonl")
    if os.path.exists(metrics_path):
        os.remove(metrics_path)
    model = get_model(cfg.symbol, cfg, device=dev)
    optimizer = make_optimizer(cfg, model)
    expect_step = expected_launches(cfg, grad=True, bucket=bucket, batch=tc.batch_size)
    reset_launches()
    t0 = time.perf_counter()
    history = train_steps(model, cfg, bucket_anchors(cfg, bucket, dev),
                          _train_samples(cfg, tc.batch_size, n_steps, dev), optimizer=optimizer,
                          generator=torch.Generator(device=dev).manual_seed(11))
    train_s = time.perf_counter() - t0
    launches = read_launches()
    if launches != {k: v * n_steps for k, v in expect_step.items()}:
        raise AssertionError(f"[{tag}] {n_steps} steps launched {nonzero(launches)}, expected "
                             f"{n_steps} x {nonzero(expect_step)}")
    bad = [i for i, m in enumerate(history) if not all(math.isfinite(v) for v in m.values())]
    if len(history) != n_steps or bad:
        raise AssertionError(f"[{tag}] {len(history)} steps, non-finite losses at {bad[:5]}")
    print(f"[{tag}] trained {n_steps} steps in {train_s:.1f} s ({train_s * 1e3 / n_steps:.1f} ms "
          f"a step, batches built on the host included); total loss {history[0]['total']:.3f} "
          f"-> {history[-1]['total']:.3f}; launches a step {nonzero(expect_step)}")
    ckpt = save_checkpoint(os.path.join(cfg.output_path, "ckpt"), n_steps, model, optimizer)
    del model, optimizer
    argv = ["--cfg", TINY_YAML, "--dataset-override", "synthetic", "--no-artifacts",
            "--weights", ckpt, "--dcn-impl", "auto"]
    auto = cfg.replace(network=dataclasses.replace(cfg.network, dcn_impl="auto"))
    card, card_t, card_launches, _ = run_eval_entry(
        tag, argv, expected_launches(auto, grad=False, bucket=bucket, batch=1))
    for k, v in card_launches.items():
        launches[k] += v
    cpu, cpu_t, _, _ = run_eval_entry(tag, argv + ["--device", "cpu"],
                                      dict.fromkeys(COUNTERS, 0))
    got, ref = headline(card), headline(cpu)
    off = {k: (got[k], ref[k]) for k in ref
           if not ((math.isnan(got[k]) and math.isnan(ref[k]))
                   or abs(got[k] - ref[k]) <= METRIC_ABS)}
    print(f"[{tag}] card ({card_t['device']}, {card_t['images'] / card_t['wall_s']:.2f} img/s) "
          f"against CPU ({cpu_t['images'] / cpu_t['wall_s']:.2f} img/s), tolerance "
          f"{METRIC_ABS} absolute: " + json.dumps({k: [got[k], ref[k]] for k in ref}))
    if off:
        raise AssertionError(f"[{tag}] card and CPU metrics differ: {off}")
    print(f"[{tag}] the tiny model after {n_steps} steps on the card: PQ "
          f"{got['pq.All.pq']:.4f} (things {got['pq.Things.pq']:.4f}, stuff "
          f"{got['pq.Stuff.pq']:.4f}), box AP {got['boxes.AP']:.4f} (AP50 "
          f"{got['boxes.AP50']:.4f}), mask AP {got['masks.AP']:.4f}, mIoU "
          f"{got['ssegs.mIoU']:.4f}")
    return launches


CITY_YAML = os.path.join(EXPERIMENTS, "upsnet_r50_synth_cityscapes_rehearsal.yaml")
SYNTH_SET, SYNTH_IMAGES, CITY_IMAGES = "synthtrain", 16, 2
# the train entry's copy of GN_YAML: snapshots and a resume at step 6 of 12
ENTRY_TRAIN = {"snapshot_step": 6, "display_iter": 3, "max_iteration": 12}
RESUME_AT = 6
REPRO_TRAIN = {"snapshot_step": 4, "display_iter": 1, "max_iteration": 4}
NCCL_TRAIN = {"snapshot_step": 2, "display_iter": 2, "max_iteration": 2}
TTA_IMAGES = 2
# the train entry's profiled device busy ms at batch 8 with F.interpolate as the FCN upsample
# (PERF.md, section 5)
TRAIN_ENTRY_BUSY_MS = 334.56


def yaml_copy(src: str, dst: str, changes: dict) -> str:
    """A copy of the experiment file ``src`` at ``dst`` with only ``changes``
    made: a dict value updates that section's fields, another value sets a
    top-level field."""
    import yaml

    with open(src) as f:
        doc = yaml.safe_load(f)
    for key, value in changes.items():
        if isinstance(value, dict):
            doc[key].update(value)
        else:
            doc[key] = value
    with open(dst, "w") as f:
        yaml.safe_dump(doc, f, sort_keys=False)
    return dst


def write_coco_set(tag: str, tmp: str) -> str:
    """The rehearsal's COCO-layout set, written by the port's tool: 16
    images, seed 0, 800x1333 base, a quarter portrait."""
    from upsnet_torch.tools import make_synth_coco

    root = os.path.join(tmp, "synth_coco")
    t0 = time.perf_counter()
    make_synth_coco.gen_coco(root, SYNTH_SET, SYNTH_IMAGES, seed=0)
    print(f"[{tag}] {SYNTH_IMAGES} COCO-layout images written in "
          f"{time.perf_counter() - t0:.1f} s to a temporary directory")
    return root


def entry_config(tag: str, tmp: str, root: str, train_fields: dict) -> tuple:
    """(path, config) of a copy of ``GN_YAML`` that trains on the set at
    ``root`` into ``output/chip_smoke_<tag>`` with ``train_fields``."""
    out = os.path.join("output", f"chip_smoke_{tag}")
    shutil.rmtree(out, ignore_errors=True)
    changes = {"output_path": out, "dataset": {"dataset_path": root}, "train": train_fields}
    path = yaml_copy(GN_YAML, os.path.join(tmp, f"{tag}.yaml"), changes)
    print(f"[{tag}] {os.path.basename(GN_YAML)}, changed only: {json.dumps(changes)}")
    return path, load_config(path)


def phase_train_entry(dev, tmp: str):
    """The training entry as a user runs it: ``upsnet_torch.tools.train.run``
    on a copy of ``experiments/upsnet_r50_synth_rehearsal.yaml`` (GN R50, COCO
    heads, ``dcn_impl_train: pallas``, batch 8, ``image_wire: uint8``, both
    buckets with flip, the watch's action 'fail'), reading a COCO-layout set
    from disk, to step 6, then again with ``resume: true`` to step 12; the
    resume path alone once more with no step, into a model and optimizer of
    its own, which must then hold the step-6 snapshot's weights and momentum
    buffers bit for bit. Every step launches 8 K2, 16 clipped K3, 3 K4 and 3
    K5 and every display interval the probe's 8 K1; every loss is finite;
    the first resumed step's rate is ``lr_schedule(cfg)(6)``; snapshots at 6
    and 12; both buckets drawn. Then ``upsnet_torch.tools.test`` evaluates
    ``step_00000012`` on 8 of the images (8 K1 and 2 K4 an image). Returns
    (the launches, a closure that takes one more step)."""
    from upsnet_torch.data.coco import COCOPanoptic
    from upsnet_torch.data.pipeline import make_loader
    from upsnet_torch.data.wire import STEP_KEYS, decode_batch, encode_batch
    from upsnet_torch.tools import train as train_cli
    from upsnet_torch.train import trainer
    from upsnet_torch.train.optimizer import lr_schedule

    tag = "train_entry"
    root = write_coco_set(tag, tmp)
    yaml_path, cfg = entry_config(tag, tmp, root, dict(ENTRY_TRAIN))
    resume_path = yaml_copy(yaml_path, os.path.join(tmp, f"{tag}_resume.yaml"),
                            {"train": {"resume": True}})
    tc, net = cfg.train, cfg.network
    print(f"[{tag}] {describe(cfg)}; batch {tc.batch_size}, buckets {tc.image_buckets}, flip "
          f"{tc.flip}, image_wire {tc.image_wire}, {tc.num_workers} loader workers, "
          f"sample_cache_mb {tc.sample_cache_mb}, lr {tc.lr}, saturation action "
          f"{net.dcn_saturation_action}")
    per_bucket = [expected_launches(cfg, grad=True, bucket=tuple(b), batch=tc.batch_size)
                  for b in tc.image_buckets]
    if any(n != per_bucket[0] for n in per_bucket):
        raise AssertionError(f"the buckets' steps launch differently: {per_bucket}")
    step_n = per_bucket[0]
    probe_n = expected_launches(cfg, grad=False, heads=False, batch=tc.batch_size)
    interval_n = {k: tc.display_iter * v + probe_n[k] for k, v in step_n.items()}

    buckets, events, steps = [], [], {}
    prev = {}
    orig_decode = trainer.decode_batch

    def decode(batch):  # once a step, in the loop: the bucket and a device mark
        out = orig_decode(batch)
        buckets.append(tuple(out["images"].shape[1:3]))
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
        return out

    def on_step(it, metrics):
        steps[it] = metrics
        bad = [k for k in (*LOSS_KEYS, "total") if not math.isfinite(metrics[k])]
        if bad:
            raise AssertionError(f"[{tag}] step {it}: non-finite loss terms {bad}: {metrics}")
        if it % tc.display_iter == 0:
            now = read_launches()
            moved = {k: now[k] - prev[k] for k in now}
            if moved != interval_n:
                raise AssertionError(f"[{tag}] interval ending at {it}: launches "
                                     f"{nonzero(moved)}, expected {nonzero(interval_n)}")
            prev.update(now)

    ckpt_dir = os.path.join(cfg.output_path, cfg.symbol, "checkpoints")
    trainer.decode_batch = decode
    try:
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        prev.update(read_launches())
        t0 = time.perf_counter()
        model, history = train_cli.run(["--cfg", yaml_path, "--max-steps", str(RESUME_AT)],
                                       on_step=on_step)
        run_s = [time.perf_counter() - t0]
        marks = [len(events)]
        del model
        torch.cuda.empty_cache()
        # the resume path with no step: into a model and optimizer of our own
        check = get_model(cfg.symbol, cfg, device=dev, generator=torch.Generator().manual_seed(1))
        check_opt = make_optimizer(cfg, check)
        before = read_launches()
        train_cli.run(["--cfg", resume_path, "--max-steps", str(RESUME_AT)], model=check,
                      optimizer=check_opt)
        if read_launches() != before:
            raise AssertionError(f"[{tag}] a resume with no step launched kernels")
        saved = torch.load(os.path.join(ckpt_dir, f"step_{RESUME_AT:08d}"), map_location="cpu",
                           weights_only=True)
        weights = check.state_dict()
        off = [k for k, v in saved["state_dict"].items() if not torch.equal(weights[k].cpu(), v)]
        got_opt, ref_opt = check_opt.state_dict(), saved["optimizer"]
        momenta = [(i, s["momentum_buffer"]) for i, s in ref_opt["state"].items()]
        off += [f"momentum {i}" for i, m in momenta
                if not torch.equal(got_opt["state"][i]["momentum_buffer"].cpu(), m)]
        if off or got_opt["param_groups"] != ref_opt["param_groups"] or not momenta:
            raise AssertionError(f"[{tag}] the resumed state differs from the snapshot: {off[:8]}")
        print(f"[{tag}] resume at {RESUME_AT}: {len(weights)} state_dict tensors, {len(momenta)} "
              f"momentum buffers and the update count "
              f"{got_opt['param_groups'][0]['count']} equal the snapshot bit for bit")
        del check, check_opt, weights, saved, got_opt, ref_opt, momenta
        torch.cuda.empty_cache()
        prev.update(read_launches())
        t0 = time.perf_counter()
        model, resumed = train_cli.run(["--cfg", resume_path], on_step=on_step)
        run_s.append(time.perf_counter() - t0)
        marks.append(len(events))
    finally:
        trainer.decode_batch = orig_decode
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = read_launches()
    n_steps, n_intervals = tc.max_iteration, tc.max_iteration // tc.display_iter
    expect = {k: n_steps * v + n_intervals * probe_n[k] for k, v in step_n.items()}
    if launches != expect:
        raise AssertionError(f"[{tag}] launches {nonzero(launches)}, expected {nonzero(expect)}")
    if sorted(steps) != list(range(1, n_steps + 1)):
        raise AssertionError(f"[{tag}] steps {sorted(steps)}")
    want_lr = lr_schedule(cfg)(RESUME_AT)
    if steps[RESUME_AT + 1]["lr"] != want_lr:
        raise AssertionError(f"[{tag}] first resumed step's rate {steps[RESUME_AT + 1]['lr']}, "
                             f"expected lr_schedule(cfg)({RESUME_AT}) = {want_lr}")
    snaps = sorted(os.listdir(ckpt_dir))
    if snaps != [f"step_{RESUME_AT:08d}", f"step_{n_steps:08d}"]:
        raise AssertionError(f"[{tag}] snapshots {snaps}")
    drawn = {b: buckets.count(b) for b in map(tuple, tc.image_buckets)}
    if min(drawn.values()) == 0 or len(buckets) != n_steps:
        raise AssertionError(f"[{tag}] batches by bucket {drawn} over {len(buckets)} steps")
    # a step's device time: from its decode to the next step's, within a run
    ms = [events[i].elapsed_time(events[i + 1]) for lo, hi in ((0, marks[0]), (marks[0], marks[1]))
          for i in range(lo, hi - 1)]
    steady = statistics.median(ms[1:])
    lines = history + resumed
    wait = sum(e["loader_wait_s"] for e in lines)
    busy = sum(e["step_s"] for e in lines)
    print(f"[{tag}] launches a step {nonzero(step_n)}, the probe a display interval "
          f"{nonzero(probe_n)}; over the {n_steps} steps {nonzero(launches)}")
    print(f"[{tag}] batches by bucket {drawn}; total loss by step "
          + ", ".join(f"{it}: {steps[it]['total']:.3f}" for it in sorted(steps))
          + f"; rate at step {RESUME_AT + 1} {want_lr:.6g} = lr_schedule(cfg)({RESUME_AT})")
    print(f"[{tag}] step ms between decodes (runs 1 and 2, steps 1-{RESUME_AT - 1} and "
          f"{RESUME_AT + 1}-{n_steps - 1}) {[round(x, 1) for x in ms]}; median after step 0 "
          f"{steady:.1f} ms = {tc.batch_size * 1e3 / steady:.2f} img/s; runs {run_s[0]:.1f} s "
          f"and {run_s[1]:.1f} s (model build, data and snapshots included); metrics.jsonl: "
          f"loader_wait_s {wait:.3f} of {wait + busy:.3f} s, share {wait / (wait + busy):.3f}; "
          f"peak memory allocated {peak / 2 ** 30:.2f} GiB; snapshots {snaps}")
    print(f"[{tag}] metrics.jsonl lines: " + json.dumps(
        [{k: e[k] for k in ("iter", "total", "step_s", "loader_wait_s", "images_per_sec",
                            "dcn_max_dy", "dcn_max_dx", "dcn_sat_frac")} for e in lines]))

    results, timings, eval_n, predict_ms = run_eval_entry(
        tag, ["--cfg", yaml_path, "--dataset-override", "coco", "--max-images",
              str(EVAL_IMAGES), "--no-artifacts", "--weights",
              os.path.join(ckpt_dir, f"step_{n_steps:08d}")],
        expected_launches(cfg, grad=False, batch=1))
    metrics = headline(results)
    if not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"[{tag}] non-finite metrics: {metrics}")
    n = timings["images"]
    print(f"[{tag}] eval of step {n_steps}: {n} images ({timings['detections']} detections) at "
          f"{n / timings['wall_s']:.2f} img/s; per image: sample "
          f"{timings['sample_s'] * 1e3 / n:.1f} ms, predict median "
          f"{statistics.median(predict_ms):.2f} ms, host postprocess "
          f"{timings['postprocess_s'] * 1e3 / n:.1f} ms; evaluators {timings['evaluate_s']:.2f} "
          f"s; RLE codec {timings['rle_codec']}; metrics (12 steps: speed and function only) "
          + json.dumps(metrics))
    for k, v in eval_n.items():
        launches[k] += v

    dataset = COCOPanoptic(cfg)
    host = next(iter(make_loader(dataset, tc.batch_size, seed=cfg.seed)))
    batch = decode_batch({k: v.to(dev) for k, v in encode_batch(
        {k: v for k, v in host.items() if k in STEP_KEYS}, net.compute_dtype,
        tc.image_wire).items()})
    step = make_train_step(model, cfg, bucket_anchors(cfg, host["images"].shape[1:3], dev),
                           make_optimizer(cfg, model),
                           generator=torch.Generator(device=dev).manual_seed(cfg.seed))
    return launches, (lambda: step(batch))


def phase_eval_cityscapes(dev, tmp: str) -> dict:
    """The evaluation entry on the Cityscapes layout at 1024x2048: two images
    written by ``make_synth_coco cityscapes``, a copy of
    ``experiments/upsnet_r50_synth_cityscapes_rehearsal.yaml`` reading them,
    a port checkpoint of the seeded model (offset biases at +-2 px), and
    ``upsnet_torch.tools.test --dataset-override cityscapes``: ``Cityscapes``,
    the Cityscapes instance AP and the base class's box AP, mIoU and PQ on
    the card, 8 K1 and 2 K4 an image."""
    from upsnet_torch.tools import make_synth_coco

    tag = "eval_cityscapes"
    root = os.path.join(tmp, "synth_cityscapes")
    t0 = time.perf_counter()
    make_synth_coco.gen_cityscapes(root, "train", CITY_IMAGES, seed=0)
    print(f"[{tag}] {CITY_IMAGES} gtFine-layout images at 1024x2048 written in "
          f"{time.perf_counter() - t0:.1f} s")
    out = os.path.join("output", f"chip_smoke_{tag}")
    shutil.rmtree(out, ignore_errors=True)
    changes = {"output_path": out, "dataset": {"dataset_path": root}}
    yaml_path = yaml_copy(CITY_YAML, os.path.join(tmp, f"{tag}.yaml"), changes)
    cfg = load_config(yaml_path)
    print(f"[{tag}] {os.path.basename(CITY_YAML)}, changed only: {json.dumps(changes)}; "
          f"{describe(cfg)}")
    gen = torch.Generator().manual_seed(cfg.seed)
    model = get_model(cfg.symbol, cfg, device=dev, generator=gen)
    perturb_offset_biases(model, gen)
    ckpt = save_checkpoint(os.path.join(out, "ckpt"), 0, model)
    del model
    torch.cuda.empty_cache()
    bucket = tuple(cfg.test.image_buckets[0])
    results, timings, launches, predict_ms = run_eval_entry(
        tag, ["--cfg", yaml_path, "--dataset-override", "cityscapes", "--no-artifacts",
              "--weights", ckpt],
        expected_launches(cfg, grad=False, bucket=bucket, batch=1), n_images=CITY_IMAGES)
    metrics = {"boxes.AP": results["boxes"]["AP"], "masks.allAp": results["masks"]["allAp"],
               "masks.allAp50%": results["masks"]["allAp50%"],
               "ssegs.mIoU": results["ssegs"]["mIoU"],
               "pq.All.pq": results["panoptic"]["All"]["pq"]}
    if not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"[{tag}] non-finite metrics: {metrics}")
    n = timings["images"]
    print(f"[{tag}] {n} images at {bucket} ({timings['detections']} detections): "
          f"{n / timings['wall_s']:.2f} img/s, predict {predict_ms[0]:.1f} and "
          f"{predict_ms[-1]:.1f} ms, sample {timings['sample_s'] * 1e3 / n:.1f} ms, host "
          f"postprocess {timings['postprocess_s'] * 1e3 / n:.1f} ms an image, evaluators "
          f"{timings['evaluate_s']:.2f} s; metrics (random weights) {json.dumps(metrics)}")
    return launches


def phase_reproducible(dev, tmp: str, root: str) -> dict:
    """Two runs of the train entry as shipped, from the same seed, on copies
    of ``GN_YAML`` (batch 8, both buckets) for ``REPRO_TRAIN`` steps on the
    rehearsal set, without ``torch.use_deterministic_algorithms``: one
    through ``upsnet_torch.tools.train.run`` here, one as a user starts it
    again, ``python -m upsnet_torch.tools.train`` in a process of its own.
    Every step's line of ``metrics.jsonl`` (its losses; ``display_iter`` 1)
    and the last snapshot (weights, momentum buffers, update count) must be
    the same bits in both. Where they are not, ``gradient_divergence``
    prints where one step's gradients part before the phase fails. Returns
    the launches of the first run."""
    from upsnet_torch.tools import train as train_cli

    tag = "reproducible"
    if torch.are_deterministic_algorithms_enabled():
        raise AssertionError(f"[{tag}] deterministic algorithms are on: not the shipped path")
    paths, cfgs, secs = [], [], []
    for i in range(2):
        path, cfg = entry_config(f"{tag}_{i}", tmp, root, dict(REPRO_TRAIN))
        paths.append(path)
        cfgs.append(cfg)
    reset_launches()
    t0 = time.perf_counter()
    train_cli.run(["--cfg", paths[0]])
    secs.append(time.perf_counter() - t0)
    launches = read_launches()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "upsnet_torch.tools.train", "--cfg", paths[1]],
                         capture_output=True, text=True, timeout=900)
    secs.append(time.perf_counter() - t0)
    if out.returncode:
        raise AssertionError(f"[{tag}] the second run exited {out.returncode}:\n"
                             f"{out.stderr[-3000:]}")
    tc = cfgs[0].train
    step_n = expected_launches(cfgs[0], grad=True, bucket=tuple(tc.image_buckets[0]),
                               batch=tc.batch_size)
    probe_n = expected_launches(cfgs[0], grad=False, heads=False, batch=tc.batch_size)
    expect = {k: tc.max_iteration * v + tc.max_iteration // tc.display_iter * probe_n[k]
              for k, v in step_n.items()}
    if launches != expect:
        raise AssertionError(f"[{tag}] launches {nonzero(launches)}, expected {nonzero(expect)}")
    lines, snaps = [], []
    for cfg in cfgs:
        sym = os.path.join(cfg.output_path, cfg.symbol)
        with open(os.path.join(sym, "metrics.jsonl")) as f:
            lines.append([{k: e[k] for k in (*LOSS_KEYS, "total")}
                          for e in map(json.loads, f)])
        snap = torch.load(os.path.join(sym, "checkpoints", f"step_{tc.max_iteration:08d}"),
                          map_location="cpu", weights_only=True)
        snaps.append(digest(*snap["state_dict"].values(),
                            *(st["momentum_buffer"] for st in snap["optimizer"]["state"].values()))
                     + f" count {snap['optimizer']['param_groups'][0]['count']}")
    print(f"[{tag}] two runs of {tc.max_iteration} steps ({secs[0]:.1f} s in this process, "
          f"{secs[1]:.1f} s in a new one): every step's losses equal {lines[0] == lines[1]}, "
          f"last snapshot equal {snaps[0] == snaps[1]} ({snaps[0]} / {snaps[1]}); total by "
          f"step {[e['total'] for e in lines[0]]} and {[e['total'] for e in lines[1]]}")
    if len(lines[0]) != tc.max_iteration or lines[0] != lines[1] or snaps[0] != snaps[1]:
        gradient_divergence(dev, tmp, root)
        raise AssertionError(f"[{tag}] two runs of the shipped train entry differ")
    return launches


def gradient_divergence(dev, tmp: str, root: str) -> None:
    """Where a step stops being reproducible: the seeded model's first
    ``forward_train`` and backward on the set's first batch, twice; prints
    whether the loss terms agree bit for bit and, by top-level module in the
    forward order, how many parameter gradients differ. The op sits
    downstream, in the forward, of the last parameter whose gradient
    differs."""
    from upsnet_torch.data.coco import COCOPanoptic
    from upsnet_torch.data.pipeline import make_loader
    from upsnet_torch.data.wire import STEP_KEYS, decode_batch, encode_batch
    from upsnet_torch.models.upsnet import forward_train

    tag = "reproducible"
    _, cfg = entry_config(f"{tag}_grads", tmp, root, {})
    host = next(iter(make_loader(COCOPanoptic(cfg), cfg.train.batch_size, seed=cfg.seed)))
    batch = decode_batch({k: v.to(dev) for k, v in encode_batch(
        {k: v for k, v in host.items() if k in STEP_KEYS}, cfg.network.compute_dtype,
        cfg.train.image_wire).items()})
    anchors = bucket_anchors(cfg, host["images"].shape[1:3], dev)

    def one():
        model = get_model(cfg.symbol, cfg, device=dev)
        total, losses = forward_train(model, cfg, anchors, batch, None,
                                      torch.Generator(device=dev).manual_seed(cfg.seed))
        total.backward()
        out = ({k: v.item() for k, v in losses.items()},
               {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None})
        del model, total, losses
        torch.cuda.empty_cache()
        return out

    (la, ga), (lb, gb) = one(), one()
    differ = [n for n in ga if not torch.equal(ga[n], gb[n])]
    by_module = {}
    for n in ga:
        top = n.split(".")[0] + ("." + n.split(".")[1].split("_")[0]
                                 if n.startswith("backbone_net") else "")
        equal, total = by_module.get(top, (0, 0))
        by_module[top] = (equal + (n not in differ), total + 1)
    print(f"[{tag}] one step's gradients twice: loss terms equal {la == lb}; {len(differ)} of "
          f"{len(ga)} parameter gradients differ; equal / all by module: "
          + ", ".join(f"{m} {e}/{t}" for m, (e, t) in by_module.items()))
    if differ:
        print(f"[{tag}]   differing, last in the forward order: {differ[-6:]}")


def time_upsample(dev) -> None:
    """The FCN head's upsample in the train entry's step (batch 8, the P3,
    P4 and P5 maps of 832x1344 at 128 channels to P2's 208x336, bf16):
    ``resize_bilinear`` (two float32 matmuls a level, TF32 off) against
    ``F.interpolate(mode='bilinear')``, forward and forward + backward,
    CUDA-event medians; the share of the step's busy time (PERF.md)."""
    from upsnet_torch.models.fcn import resize_bilinear

    g = torch.Generator(device=dev).manual_seed(41)
    xs = [torch.randn((8, 128, 208 // f, 336 // f), generator=g, device=dev)
          .to(torch.bfloat16).to(memory_format=torch.channels_last) for f in (2, 4, 8)]
    grad = torch.randn((8, 128, 208, 336), generator=g, device=dev).to(torch.bfloat16)

    def fwd(fn):
        return lambda: [fn(x) for x in xs]

    def fwd_bwd(fn):
        def run():
            leaves = [x.detach().requires_grad_() for x in xs]
            torch.autograd.backward([fn(x) for x in leaves], [grad] * len(leaves))
        return run

    ours = lambda x: resize_bilinear(x, (208, 336))  # noqa: E731
    theirs = lambda x: F.interpolate(x, size=(208, 336), mode="bilinear",  # noqa: E731
                                     align_corners=False)
    err = max(float((ours(x).float() - theirs(x).float()).abs().max()) for x in xs)
    times = {name: (time_ms(fwd(fn)), time_ms(fwd_bwd(fn)))
             for name, fn in (("resize_bilinear", ours), ("F.interpolate", theirs))}
    flops = sum(2 * 8 * 128 * (h * w * 208 + 208 * w * 336) for h, w in
                ((104, 168), (52, 84), (26, 42)))
    print(f"[upsample] P3-P5 of a batch-8 step to 208x336 at C 128 bf16: "
          + "; ".join(f"{k} forward {f:.3f} ms, forward + backward {fb:.3f} ms"
                      for k, (f, fb) in times.items())
          + f"; max abs difference {err:.3e}; {flops / 1e9:.1f} GFLOP forward in float32; "
          f"forward + backward {100 * times['resize_bilinear'][1] / TRAIN_ENTRY_BUSY_MS:.2f}% "
          f"of the step's {TRAIN_ENTRY_BUSY_MS} busy ms")


def _ddp_card_rank(rank, world, init_file, cfg, batch, noise, fuse_args, out_dir):
    """One rank of ``phase_ddp`` on cuda:0 over gloo: one data-parallel step
    of ``cfg``'s seeded model on its rows of ``batch`` with the joined
    ``noise``, then its row slab of ``spatial_panoptic_fuse``. Rank 0 saves
    its weights to ``out_dir``; each rank returns (the joined losses, the
    sha1 of its weights, its launches, its slab of the panoptic map, keep)."""
    from upsnet_torch.parallel import steps as ddp_steps
    from upsnet_torch.parallel.mesh import close_group, make_group
    from upsnet_torch.parallel.spatial import spatial_panoptic_fuse

    group = make_group(device="cuda:0", backend="gloo", init_method=f"file://{init_file}",
                       rank=rank, world_size=world)
    try:
        dev = group.device
        model = get_model(cfg.symbol, cfg, device=dev)
        opt = make_optimizer(cfg, model)
        ddp = ddp_steps.wrap_model(model, cfg, group)
        b = batch["images"].shape[0] // world
        mine = {k: torch.from_numpy(v[rank * b:(rank + 1) * b]).to(dev) for k, v in batch.items()}
        step = ddp_steps.make_train_step(ddp, cfg, bucket_anchors(cfg, BUCKET, dev), opt, group)
        reset_launches()
        metrics = step(mine, {k: torch.from_numpy(v).to(dev) for k, v in noise.items()})
        torch.cuda.synchronize()
        launches = read_launches()
        state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        if rank == 0:
            torch.save(state, os.path.join(out_dir, "ddp_rank0.pt"))
        seg, dets, kw = fuse_args
        hs = seg.shape[0] // world
        pan, keep = spatial_panoptic_fuse(group, torch.from_numpy(seg[rank * hs:(rank + 1) * hs])
                                          .to(dev), *(torch.from_numpy(d).to(dev) for d in dets),
                                          **kw)
        return ({k: float(v) for k, v in metrics.items()}, digest(*state.values()), launches,
                pan.cpu().numpy(), keep.cpu().numpy())
    finally:
        close_group(group)


def _fuse_inputs(num_classes: int, num_stuff: int, hw=(1024, 2048), n: int = 100) -> tuple:
    """Seeded evidence for one image's fusion on ``hw``: 1/4-scale logits,
    ``n`` boxes (some overlapping, so MaskRemoval drops some), classes,
    28x28 mask logits, sorted scores, all valid but the last."""
    rng = np.random.RandomState(13)
    hq, wq = hw[0] // 4, hw[1] // 4
    seg = rng.randn(hq, wq, num_classes).astype(np.float32)
    x1, y1 = rng.uniform(0, hw[1] - 300, n), rng.uniform(0, hw[0] - 300, n)
    boxes = np.stack([x1, y1, x1 + rng.uniform(16, 300, n), y1 + rng.uniform(16, 300, n)],
                     -1).astype(np.float32)
    boxes[1::3] = boxes[0::3][: len(boxes[1::3])] + 3.5
    classes = rng.randint(1, num_classes - num_stuff + 1, n).astype(np.int64)
    masks = (rng.randn(n, 28, 28) * 3).astype(np.float32)
    scores = np.sort(rng.uniform(0, 1, n))[::-1].astype(np.float32).copy()
    valid = np.ones(n, bool)
    valid[-1] = False
    return seg, (boxes, classes, masks, scores, valid)


def phase_ddp(dev, tmp: str, root: str) -> dict:
    """Data parallelism on the one card.

    1. Two ranks on cuda:0 over gloo (NCCL refuses two ranks on one device),
       spawned with ``spawn_ranks``: ``GN_YAML``'s model (GN R50, full width,
       COCO heads) in float32, batch 2 a rank, one step of the data-parallel
       step (``parallel/steps.py``) with the joined batch's noise. The two
       ranks' weights must be the same bits; every weight's update within
       the CPU test's gradient tolerance (1e-3 |ref| + 1e-4 max|ref leaf| + 2
       ulps of the weight) of one process's step on the same two halves
       (counts summed, both backwards accumulated, one update); the joined
       losses within rtol 1e-4 of the single-process step on the joined
       batch of 4. The updates against that step are printed, not held: the
       card's convolutions round differently at batch 4 and 2 (the P2 gap is
       printed), and the proposals' ranking turns that into other sampled
       RoIs. float32, so that these gaps stay at rounding size.
    2. In the same ranks, ``spatial_panoptic_fuse`` over their two row slabs
       of a 1024x2048 canvas (19 classes, 100 detections): the panoptic map
       and keep flags the same as ``panoptic_fuse``'s on the whole map.
    3. A world-size-1 NCCL group trains 2 steps through
       ``upsnet_torch.tools.train --backend nccl`` on the rehearsal set at
       the file's batch 8 (the DDP wrapper and its sum hook, one rank).
    Returns the launches of the ranks' steps and the NCCL run."""
    from upsnet_torch.models.upsnet import draw_noise, forward_train, panoptic_fuse
    from upsnet_torch.parallel.mesh import spawn_ranks
    from upsnet_torch.train.optimizer import sgd_update
    from upsnet_torch.tools import train as train_cli

    tag = "ddp"
    world, per_rank = 2, 2
    cfg = load_config(GN_YAML)
    cfg = cfg.replace(network=dataclasses.replace(cfg.network, compute_dtype="float32"))
    batch = synthetic_batch(cfg, BUCKET, world * per_rank, seed=5,
                            image_hw=tuple(int(v) for v in IM_HW))
    anchors = bucket_anchors(cfg, BUCKET, dev)
    noise = {k: v.cpu().numpy() for k, v in draw_noise(
        cfg, world * per_rank, sum(a.shape[0] for a in anchors),
        torch.Generator(device=dev).manual_seed(cfg.seed), dev).items()}
    city = load_config(CITY_YAML)
    seg, dets = _fuse_inputs(city.dataset.num_seg_classes, city.dataset.num_stuff)
    kw = dict(score_thresh=0.05, overlap_thresh=city.test.panoptic_mask_overlap_thresh,
              num_stuff=city.dataset.num_stuff)
    t0 = time.perf_counter()
    ranks = spawn_ranks(_ddp_card_rank, world, os.path.join(tmp, "ddp_init"), cfg, batch,
                        noise, (seg, dets, kw), tmp, timeout_s=300)
    spawn_s = time.perf_counter() - t0
    (m0, d0, n0, pan0, keep0), (m1, d1, n1, pan1, keep1) = ranks
    if d0 != d1 or m0 != m1:
        raise AssertionError(f"[{tag}] the two ranks differ: weights {d0} / {d1}, losses equal "
                             f"{m0 == m1}")
    step_n = expected_launches(cfg, grad=True, batch=per_rank)
    if n0 != step_n or n1 != step_n:
        raise AssertionError(f"[{tag}] rank launches {nonzero(n0)} / {nonzero(n1)}, expected "
                             f"{nonzero(step_n)} each")

    got = torch.load(os.path.join(tmp, "ddp_rank0.pt"), map_location=dev, weights_only=True)
    host = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    dnoise = {k: torch.from_numpy(v).to(dev) for k, v in noise.items()}

    def rows(tree, r):
        return {k: v[r * per_rank:(r + 1) * per_rank] for k, v in tree.items()}

    def joined_of_halves(model, opt):
        """The joined batch's step as one process computes it from the
        ranks' halves: their counts summed, both backwards accumulated,
        one update."""
        counts = []
        for r in range(world):
            with torch.no_grad():
                forward_train(model, cfg, anchors, rows(host, r), rows(dnoise, r),
                              joined_counts=lambda c: counts.append(c.clone()) or c)
        joined = counts[0] + counts[1]
        opt.zero_grad(set_to_none=True)
        for r in range(world):
            total, _ = forward_train(model, cfg, anchors, rows(host, r), rows(dnoise, r),
                                     joined_counts=lambda c: joined.clone())
            total.backward()
        sgd_update(opt, cfg)

    def compare(model, before) -> tuple:
        """(the leaves off the CPU test's gradient tolerance on the update,
        or moved where the reference did not or the other way round, or
        frozen and moved; the worst excess over 1e-3 |ref| + 2 ulps, as a
        share of the leaf's largest update). The FCN offset convs start at
        zero, where the clipped backward gives them no gradient: they move
        on neither side."""
        worst, off = 0.0, []
        for n, p in model.named_parameters():
            d_got, d_ref = got[n] - before[n], p.detach() - before[n]
            scale = float(d_ref.abs().max())
            excess = ((d_got - d_ref).abs() - 1e-3 * d_ref.abs()
                      - 2 * torch.finfo(torch.float32).eps * before[n].abs())
            if scale > 0:
                worst = max(worst, float(excess.max()) / scale)
            moved = not torch.equal(got[n], before[n])
            if bool((excess > 1e-4 * scale).any()) or moved != (scale > 0) or (
                    moved and not p.requires_grad):
                off.append(n)
        return off, worst

    model = get_model(cfg.symbol, cfg, device=dev)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    joined_of_halves(model, make_optimizer(cfg, model))
    off, worst_halves = compare(model, before)
    model = get_model(cfg.symbol, cfg, device=dev)
    ref = make_train_step(model, cfg, anchors, make_optimizer(cfg, model))(host, dnoise)
    _, worst_joined = compare(model, before)
    with torch.no_grad():
        x = host["images"].permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        p2_gap = float((model.extract(x)[0][0][:per_rank]
                        - model.extract(x[:per_rank].contiguous(
                            memory_format=torch.channels_last))[0][0]).abs().max())
    losses_off = {k: (m0[k], float(v)) for k, v in ref.items()
                  if not math.isclose(m0[k], float(v), rel_tol=1e-4)}
    print(f"[{tag}] 2 gloo ranks on cuda:0, {describe(cfg)} float32, batch {per_rank} a rank, "
          f"one step ({spawn_s:.1f} s with the ranks' start): weights bit-identical across ranks "
          f"(sha1 {d0}); launches a rank {nonzero(n0)}. Against one process's step on the "
          f"ranks' halves (counts summed, backwards accumulated): worst update excess "
          f"{worst_halves:.3e} of a leaf's largest update (tolerance 1e-4). Against the "
          f"single-process step on the joined batch of {world * per_rank}: total "
          f"{m0['total']:.6f} / {float(ref['total']):.6f}, terms within rtol 1e-4; worst update "
          f"excess {worst_joined:.3e} (not asserted: the card's trunk at batch "
          f"{world * per_rank} and {per_rank} differs by up to {p2_gap:.3e} at P2, and the "
          f"proposals' ranking turns that into other sampled RoIs)")
    if off or losses_off:
        raise AssertionError(f"[{tag}] DDP against one process: leaves {off[:8]}, losses "
                             f"against the joined batch {losses_off}")
    del model, before, got, ref, host, dnoise
    torch.cuda.empty_cache()

    pan_ref, keep_ref = panoptic_fuse(torch.from_numpy(seg)[None].to(dev),
                                      *(torch.from_numpy(d)[None].to(dev) for d in dets), **kw)
    pan = np.concatenate([pan0, pan1], 0)
    if not (np.array_equal(pan, pan_ref[0].cpu().numpy())
            and np.array_equal(keep0, keep_ref[0].cpu().numpy())
            and np.array_equal(keep0, keep1)):
        raise AssertionError(f"[{tag}] spatial_panoptic_fuse differs from panoptic_fuse")
    print(f"[{tag}] spatial_panoptic_fuse over 2 row slabs of {seg.shape[0]}x{seg.shape[1]} "
          f"(canvas 1024x2048, {len(keep0)} detections, {int(keep0.sum())} kept): panoptic map "
          f"and keep equal to panoptic_fuse's")

    path, ecfg = entry_config(f"{tag}_nccl", tmp, root, dict(NCCL_TRAIN))
    tc = ecfg.train
    reset_launches()
    losses = {}
    t0 = time.perf_counter()
    _, history = train_cli.run(["--cfg", path, "--backend", "nccl"],
                               on_step=lambda it, m: losses.update({it: m}))
    nccl_s = time.perf_counter() - t0
    nccl_n = read_launches()
    step_n = expected_launches(ecfg, grad=True, batch=tc.batch_size)
    probe_n = expected_launches(ecfg, grad=False, heads=False, batch=tc.batch_size)
    expect = {k: tc.max_iteration * v + probe_n[k] for k, v in step_n.items()}
    bad = [it for it, m in losses.items() if not all(math.isfinite(m[k]) for k in LOSS_KEYS)]
    if nccl_n != expect or sorted(losses) != [1, 2] or bad:
        raise AssertionError(f"[{tag}] NCCL run: launches {nonzero(nccl_n)} (expected "
                             f"{nonzero(expect)}), steps {sorted(losses)}, non-finite {bad}")
    print(f"[{tag}] world-size-1 NCCL group, tools.train --backend nccl, {tc.max_iteration} steps "
          f"at batch {tc.batch_size} in {nccl_s:.1f} s: total "
          f"{[round(losses[i]['total'], 4) for i in sorted(losses)]}, metrics.jsonl "
          f"{len(history)} line(s)")
    return {k: n0[k] + n1[k] + nccl_n[k] for k in n0}


def phase_eval_tta(dev, tmp: str, root: str) -> dict:
    """Test-time augmentation through the evaluation entry, as a user runs
    it: ``upsnet_torch.tools.test`` on a copy of ``R101_DCN_YAML`` (the
    paper's headline COCO file: ResNet-101-DCN, ``test.scales`` [800] plus
    ``multi_scale`` [640, 800, 960] and ``flip_test``: 6 forwards an image)
    that changes only the data and output paths, on ``TTA_IMAGES`` of the
    rehearsal set's COCO-layout images, from a checkpoint of the seeded
    model with its offset biases at +-2 px. Each forward must launch the
    file's 38 K1 and 2 K4; img/s and the per-image split: building the 6
    samples, the 6 predicts, merging (de-flip, unscale, resize and average
    the logits, class NMS), the fusion, the host postprocess."""
    tag = "eval_tta"
    out = os.path.join("output", f"chip_smoke_{tag}")
    shutil.rmtree(out, ignore_errors=True)
    changes = {"output_path": out,
               "dataset": {"dataset_path": root, "test_image_set": SYNTH_SET}}
    yaml_path = yaml_copy(R101_DCN_YAML, os.path.join(tmp, f"{tag}.yaml"), changes)
    cfg = load_config(yaml_path)
    variants = inference.tta_variants(cfg)
    print(f"[{tag}] {os.path.basename(R101_DCN_YAML)}, changed only: {json.dumps(changes)}; "
          f"{describe(cfg)}; TTA variants (scale, flip) {variants}")
    gen = torch.Generator().manual_seed(cfg.seed)
    model = get_model(cfg.symbol, cfg, device=dev, generator=gen)
    perturb_offset_biases(model, gen)
    ckpt = save_checkpoint(os.path.join(out, "ckpt"), 0, model)
    del model
    torch.cuda.empty_cache()
    per_forward = [expected_launches(cfg, grad=False, bucket=tuple(b), batch=1)
                   for b in cfg.test.image_buckets]
    if any(n != per_forward[0] for n in per_forward):
        raise AssertionError(f"[{tag}] the buckets' forwards launch differently: {per_forward}")
    results, timings, launches, predict_ms = run_eval_entry(
        tag, ["--cfg", yaml_path, "--dataset-override", "coco", "--max-images",
              str(TTA_IMAGES), "--no-artifacts", "--weights", ckpt],
        per_forward[0], n_images=TTA_IMAGES * len(variants))
    metrics = headline(results)
    if not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"[{tag}] non-finite metrics: {metrics}")
    expect = {k: TTA_IMAGES * len(variants) * v for k, v in per_forward[0].items()}
    if launches != expect:
        raise AssertionError(f"[{tag}] launches {nonzero(launches)}, expected {nonzero(expect)}")
    n = timings["images"]
    print(f"[{tag}] {n} images ({timings['detections']} detections), {len(variants)} forwards "
          f"an image of {nonzero(per_forward[0])}: {n / timings['wall_s']:.3f} img/s; per image: "
          f"sample {timings['sample_s'] * 1e3 / n:.1f} ms, {len(variants)} predicts "
          f"{timings['predict_s'] * 1e3 / n:.1f} ms (median forward "
          f"{statistics.median(predict_ms):.2f} ms), merge {timings['merge_s'] * 1e3 / n:.1f} "
          f"ms, fusion {timings['fuse_s'] * 1e3 / n:.1f} ms, host postprocess "
          f"{timings['postprocess_s'] * 1e3 / n:.1f} ms; evaluators {timings['evaluate_s']:.2f} "
          f"s; metrics (random weights) {json.dumps(metrics)}")
    return launches


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
    check_entry_shapes(dev, kernels)
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
    anchors = bucket_anchors(cfg, BUCKET, dev)
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
    anchors = bucket_anchors(cfg, WIDE_BUCKET, dev)
    finish("predict_wide", counts, run, "predict.")  # profiled before the biases move
    compare_wide_with_auto(model, cfg, anchors, batch, seg)
    del run, model, batch, seg
    counts, run, _ = phase_train(dev, "pallas", 2, "train_wide", **wide)
    finish("train_wide", counts, run, "train.")
    del run
    counts, run, _ = phase_train(dev, "auto", 2, "train_auto")
    finish("train_auto", counts, run, "train.")
    del run
    # the paper's COCO model, ResNet-101 with DCN in C3-C5, from its shipped
    # experiment file; the YAML's dcn_impl ('auto') for predict, its
    # dcn_impl_train ('pallas') for train
    r101 = load_config(R101_DCN_YAML)
    counts, run, model, batch, seg = phase_predict(dev, tag="predict_r101dcn", cfg=r101,
                                                   shrink_bn=True)
    finish("predict_r101dcn", counts, run, "predict.")
    del run, model, batch, seg
    counts, run, _ = phase_train(dev, n_steps=2, tag="train_r101dcn", cfg=r101)
    finish("train_r101dcn", counts, run, "train.")
    del run
    # GroupNorm from scratch: the synthetic rehearsal's R50 at batch 2 (its
    # YAML trains batch 8)
    gn = load_config(GN_YAML)
    print(f"[train_gn] {os.path.basename(GN_YAML)}: batch {gn.train.batch_size} in the file, "
          f"run at batch {BATCH} to keep the script inside its time")
    counts, run, _ = phase_train(dev, n_steps=2, tag="train_gn", cfg=gn)
    finish("train_gn", counts, run, "train.")
    del run
    torch.cuda.empty_cache()
    finish("eval_r50coco", phase_eval_r50coco(dev), None, "")
    finish("eval_tiny", phase_eval_tiny(dev), None, "")
    with tempfile.TemporaryDirectory() as tmp:
        counts, run = phase_train_entry(dev, tmp)
        finish("train_entry", counts, run, "train.")
        del run
        finish("eval_cityscapes", phase_eval_cityscapes(dev, tmp), None, "")
        root = os.path.join(tmp, "synth_coco")  # the set write_coco_set wrote for train_entry
        t_new = time.perf_counter()
        time_upsample(dev)
        finish("reproducible", phase_reproducible(dev, tmp, root), None, "")
        finish("ddp", phase_ddp(dev, tmp, root), None, "")
        finish("eval_tta", phase_eval_tta(dev, tmp, root), None, "")
        print(f"[new phases] upsample timing, reproducible, ddp and eval_tta took "
              f"{time.perf_counter() - t_new:.1f} s")
    finish("mt_tool", phase_mt_tool(dev), None, "")
    phase_reference(dev)
    phase_reference(dev, norm="gn", dcn_stages=(3, 4, 5))
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
