"""K2 and both K3 forms through ``DeformSampleTaps`` on the side-by-side tap
projections (B, H, W, K, C), the output of the one matmul of
``side_by_side_projections`` that ``deform_conv2d`` builds on every route.

On the CPU (the plain versions): ``DeformSampleTaps`` in both K3 forms and
under each derivative rule, and ``DeformSampleTiled``, in f32 and bf16, give
exactly the output and the three gradients of the chain of one-tap plain
versions, each tap rounded and added in y's dtype in tap order. A test marked ``card`` runs a
training step on a CUDA card and skips here; this file imports no JAX, so
on the card it runs with
``python -m pytest tests/test_torch_taps_chain.py -q -m card --noconftest``.
"""

import dataclasses
import pathlib

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
    """y (B, H, W, K, C) side by side in ``dtype`` and f32 sample coordinates
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
    return (y.permute(1, 2, 3, 0, 4).contiguous(), *coords)


def _chain(y, sy, sx, g, rule):
    """The one-tap plain chain: each tap sampled by ``deform_sample_plain``
    and added in y's dtype in tap order, and each tap's backward by
    ``deform_sample_bwd_plain`` under ``rule``; grad_y side by side."""
    out = None
    for t in range(TAPS):
        tap = deform_sample.deform_sample_plain(y[:, :, :, t], sy[t], sx[t])
        out = tap if out is None else out + tap
    grads = [deform_sample.deform_sample_bwd_plain(y[:, :, :, t], sy[t], sx[t], g, rule)
             for t in range(TAPS)]
    gy, gsy, gsx = (torch.stack(gs) for gs in zip(*grads))
    return out, gy.permute(1, 2, 3, 0, 4), gsy, gsx


@pytest.mark.parametrize("rule", ["pallas", "hat", "floor"])
@pytest.mark.parametrize("reach", [REACH, None], ids=["clipped", "unclipped"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_deform_sample_taps_is_the_one_tap_chain(dtype, reach, rule):
    """Output and gradients to y, sy and sx of ``DeformSampleTaps`` equal,
    bit for bit, the one-tap chain's, in f32 and in bf16, where each tap is
    rounded and added in bf16 (grad_y in y's layout and dtype)."""
    y, sy, sx = _layer(5, 2, 10, 12, 16, dtype)
    g = torch.randn((2, 10, 12, 16), generator=torch.Generator().manual_seed(6)).to(dtype)
    ref_out, ref_gy, ref_gsy, ref_gsx = _chain(y, sy, sx, g, rule)
    leaves = [y.requires_grad_(), sy.clone().requires_grad_(), sx.clone().requires_grad_()]
    out = deform_sample.DeformSampleTaps.apply(*leaves, reach, rule, None)
    out.backward(g)
    gy = leaves[0].grad
    assert out.dtype == gy.dtype == dtype and gy.shape == y.shape
    assert torch.equal(out, ref_out)
    assert torch.equal(gy, ref_gy)
    assert torch.equal(leaves[1].grad, ref_gsy) and torch.equal(leaves[2].grad, ref_gsx)
    assert float(ref_gsy.abs().max()) > 0 and float(ref_gy.float().abs().max()) > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_deform_sample_tiled_is_the_one_tap_chain(dtype):
    """``DeformSampleTiled`` (K6, backward the clipped K3 under the
    ``pallas`` rule) equals the same chain bit for bit, output and three
    gradients, with every sample within its row and column reach."""
    y, sy, sx = _layer(7, 2, 10, 12, 16, dtype)
    g = torch.randn((2, 10, 12, 16), generator=torch.Generator().manual_seed(8)).to(dtype)
    ref_out, ref_gy, ref_gsy, ref_gsx = _chain(y, sy, sx, g, "pallas")
    leaves = [y.requires_grad_(), sy.clone().requires_grad_(), sx.clone().requires_grad_()]
    out = deform_sample.DeformSampleTiled.apply(*leaves, REACH, REACH)
    out.backward(g)
    assert out.dtype == leaves[0].grad.dtype == dtype
    assert torch.equal(out, ref_out) and torch.equal(leaves[0].grad, ref_gy)
    assert torch.equal(leaves[1].grad, ref_gsy) and torch.equal(leaves[2].grad, ref_gsx)
    assert float(ref_gsx.abs().max()) > 0


# ---------------------------------------------------------------- on the card


@pytest.mark.card
def test_an_r50_training_step_launches_k2_and_the_clipped_k3(card):
    """One training step of the shipped UPSNet-50 COCO file (batch 2 on a
    512x768 canvas, bf16, ``pallas`` training route): its 8 DCN layers launch
    K2 and the clipped K3, and never the unclipped K3."""
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
    names = ("launches_taps", "launches_bwd_taps", "launches_bwd_unclipped")
    before = {n: getattr(deform_sample, n) for n in names}
    step({k: torch.from_numpy(v).to(card) for k, v in batch.items()})
    torch.cuda.synchronize()
    launched = {n: getattr(deform_sample, n) - before[n] for n in names}
    assert launched == {"launches_taps": 8, "launches_bwd_taps": 16, "launches_bwd_unclipped": 0}
