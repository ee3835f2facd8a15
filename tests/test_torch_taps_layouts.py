"""The all-tap K2 and both all-tap K3 forms on the two layouts of the tap
projections: tap-major (K, B, H, W, C), ``tap_axis`` 0, and side by side
(B, H, W, K, C), ``tap_axis`` 3, the output of the one matmul of
``side_by_side_projections`` that ``deform_conv2d`` builds on every route.

On the CPU (the plain versions): ``DeformSampleTaps`` on either layout, in
both forms and under each derivative rule, gives exactly the output and the
three gradients of the chain of one-tap plain versions on the tap-major
stack. Tests marked ``card`` run the kernels on a CUDA card and skip here;
this file imports no JAX, so on the card they run with
``python -m pytest tests/test_torch_taps_layouts.py -q -m card --noconftest``.
"""

import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from upsnet_torch.ops import deform_sample

torch.set_num_threads(2)

TAPS = 9
MAX_DY = 2  # the offsets' spread; the clipped form's reach adds the kernel's half width
REACH = MAX_DY + 1
ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here; this test runs on the card")
    return torch.device("cuda")


def _layer(seed, b, h, w, c, dtype, device="cpu"):
    """y (K, B, H, W, C) tap-major in ``dtype`` and f32 sample coordinates
    sy, sx (K, B, H, W) of a 3x3 layer: offsets uniform in +-MAX_DY px, a
    tenth of the dy and another tenth of the dx rounded to integers (where
    the derivative rules differ), so every sample lies within REACH rows of
    its pixel and some beyond the map's edge."""
    g = torch.Generator(device=device).manual_seed(seed)
    shape = (TAPS, b, h, w)
    taps = torch.arange(TAPS, device=device)
    ky = (taps // 3 - 1).float()[:, None, None, None]
    kx = (taps % 3 - 1).float()[:, None, None, None]
    iy = torch.arange(h, device=device, dtype=torch.float32)[None, None, :, None]
    ix = torch.arange(w, device=device, dtype=torch.float32)[None, None, None, :]
    coords = []
    for k, i in ((ky, iy), (kx, ix)):
        off = (torch.rand(shape, generator=g, device=device) * 2 - 1) * MAX_DY
        snap = torch.rand(shape, generator=g, device=device) < 0.1
        coords.append((i + k + torch.where(snap, off.round(), off)).contiguous())
    y = torch.randn((TAPS, b, h, w, c), generator=g, device=device).to(dtype)
    return (y, *coords)


def _side(y):
    """The tap-major stack laid out side by side, (B, H, W, K, C)."""
    return y.permute(1, 2, 3, 0, 4).contiguous()


def _chain(y, sy, sx, g, rule):
    """The tap-major one-tap plain chain: each tap sampled by
    ``deform_sample_plain`` and added in y's dtype in tap order, and each
    tap's backward by ``deform_sample_bwd_plain`` under ``rule``."""
    out = None
    for t in range(TAPS):
        tap = deform_sample.deform_sample_plain(y[t], sy[t], sx[t])
        out = tap if out is None else out + tap
    grads = [deform_sample.deform_sample_bwd_plain(y[t], sy[t], sx[t], g, rule)
             for t in range(TAPS)]
    return out, *(torch.stack(gs) for gs in zip(*grads))


@pytest.mark.parametrize("rule", ["pallas", "hat", "floor"])
@pytest.mark.parametrize("reach", [REACH, None], ids=["clipped", "unclipped"])
@pytest.mark.parametrize("tap_axis", [0, 3])
def test_deform_sample_taps_on_either_layout_is_the_tap_major_chain(tap_axis, reach, rule):
    """Output and gradients to y, sy and sx of ``DeformSampleTaps`` equal,
    bit for bit, the tap-major chain's; grad_y comes back in y's layout."""
    y, sy, sx = _layer(5, 2, 10, 12, 16, torch.float32)
    g = torch.randn((2, 10, 12, 16), generator=torch.Generator().manual_seed(6))
    ref_out, ref_gy, ref_gsy, ref_gsx = _chain(y, sy, sx, g, rule)
    leaves = [(_side(y) if tap_axis == 3 else y).requires_grad_(), sy.clone().requires_grad_(),
              sx.clone().requires_grad_()]
    out = deform_sample.DeformSampleTaps.apply(*leaves, reach, rule, None, tap_axis)
    out.backward(g)
    gy = leaves[0].grad
    assert gy.shape == leaves[0].shape
    if tap_axis == 3:
        gy = gy.permute(3, 0, 1, 2, 4)
    assert torch.equal(out, ref_out)
    assert torch.equal(gy, ref_gy)
    assert torch.equal(leaves[1].grad, ref_gsy) and torch.equal(leaves[2].grad, ref_gsx)
    assert float(ref_gsy.abs().max()) > 0 and float(ref_gy.abs().max()) > 0


# ---------------------------------------------------------------- on the card

SHAPES = {"P2": (208, 336, 128), "C4": (52, 84, 256)}  # the 832x1344 bucket's P2 and C4 maps
BATCH = 8


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_k2_gives_the_same_bits_in_both_layouts(card, shape, dtype):
    h, w, c = SHAPES[shape]
    y, sy, sx = _layer(7, BATCH, h, w, c, dtype, card)
    before = (deform_sample.launches_taps, deform_sample.launches_taps_side)
    tap_major = deform_sample.deform_sample_taps(y, sy, sx, 0)
    side = deform_sample.deform_sample_taps(_side(y), sy, sx, 3)
    torch.cuda.synchronize()
    assert (deform_sample.launches_taps, deform_sample.launches_taps_side) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(tap_major, side)
    assert float(side.float().abs().max()) > 0


@pytest.mark.card
@pytest.mark.parametrize("reach", [REACH, None], ids=["clipped", "unclipped"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_k3_gives_the_same_bits_in_both_layouts(card, shape, reach):
    """grad_y (permuted), gsy and gsx of both all-tap K3 forms, bf16."""
    h, w, c = SHAPES[shape]
    y, sy, sx = _layer(8, BATCH, h, w, c, torch.bfloat16, card)
    g = torch.randn((BATCH, h, w, c), generator=torch.Generator(device=card).manual_seed(9),
                    device=card).to(torch.bfloat16)

    def run(yy, tap_axis):
        if reach is None:
            return deform_sample.deform_sample_bwd_unclipped(yy, sy, sx, g, "pallas", None,
                                                             tap_axis)
        return deform_sample.deform_sample_bwd_taps(yy, sy, sx, g, reach, tap_axis)

    gy0, gsy0, gsx0 = run(y, 0)
    gy3, gsy3, gsx3 = run(_side(y), 3)
    torch.cuda.synchronize()
    assert torch.equal(gy3, _side(gy0))
    assert torch.equal(gsy3, gsy0) and torch.equal(gsx3, gsx0)
    assert float(gy0.float().abs().max()) > 0


@pytest.mark.card
def test_an_r50_training_step_launches_only_side_by_side_taps(card):
    """One training step of the shipped UPSNet-50 COCO file (batch 2 on a
    512x768 canvas, bf16, ``pallas`` training route): its 8 DCN layers launch
    the all-tap K2 and the clipped K3 on the side-by-side layout alone."""
    from upsnet_torch.config.loader import load_config
    from upsnet_torch.data.synthetic import synthetic_batch
    from upsnet_torch.evaluation.inference import bucket_anchors
    from upsnet_torch.models.upsnet import build_model
    from upsnet_torch.train.optimizer import make_optimizer
    from upsnet_torch.train.step import make_train_step

    cfg = load_config(str(ROOT / "experiments" / "upsnet_resnet50_coco_4gpu.yaml"))
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, batch_size=2))
    bucket = (512, 768)
    model = build_model(cfg, device=card, generator=torch.Generator().manual_seed(0))
    step = make_train_step(model, cfg, bucket_anchors(cfg, bucket, card),
                           make_optimizer(cfg, model),
                           generator=torch.Generator(device=card).manual_seed(4))
    batch = synthetic_batch(cfg, bucket, 2, seed=3, image_hw=(480, 720))
    names = ("launches_taps", "launches_bwd_taps", "launches_bwd_unclipped",
             "launches_taps_side", "launches_bwd_taps_side", "launches_bwd_unclipped_side")
    before = {n: getattr(deform_sample, n) for n in names}
    step({k: torch.from_numpy(v).to(card) for k, v in batch.items()})
    torch.cuda.synchronize()
    launched = {n: getattr(deform_sample, n) - before[n] for n in names}
    assert launched == {"launches_taps": 0, "launches_bwd_taps": 0, "launches_bwd_unclipped": 0,
                        "launches_taps_side": 8, "launches_bwd_taps_side": 16,
                        "launches_bwd_unclipped_side": 0}
