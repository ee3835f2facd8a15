"""``chip_smoke.py --rehearsal {coco,cityscapes,frozenbn}``: the gates that
hold the port's runs of the three shipped rehearsal files to the JAX
package's, and the copy of each file that changes only its paths.

  * the gate functions accept the JAX package's recorded results
    (``STATUS.md``, round 5) and refuse PQ 0.49, PQ Things 0, a non-finite
    loss term, a term that ends above its first interval and a pretrained
    snapshot that did not load as an exact match;
  * the copy of each file (``yaml_copy`` with ``rehearsal_changes``) loads
    to the shipped file's configuration field by field, but for the paths;
  * a step's ms comes from an interval's seconds over its steps;
  * ``chip_smoke.py`` imports without CUDA, and run as a script without
    CUDA exits 1 with nothing on stdout;
  * the whole ``--rehearsal coco`` flow (data, train, evaluate, probe,
    gate) runs on the CPU on a tiny copy, its entries given ``--device cpu``.
"""

import dataclasses
import json
import math
import os
import pathlib
import subprocess
import sys

import pytest
import torch

import chip_smoke
from upsnet_torch.config import load_config

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
LOSS_KEYS = chip_smoke.LOSS_KEYS


def planted_results(metrics: dict, cityscapes: bool) -> dict:
    """The evaluators' results dict with ``metrics`` (``rehearsal_metrics``'
    names) at their places."""
    return {"panoptic": {part: {"pq": metrics.get(f"pq.{part}.pq", 0.5), "sq": 0.9, "rq": 0.9}
                         for part in ("All", "Things", "Stuff")},
            "boxes": {"AP": metrics["boxes.AP"], "AP50": 0.9},
            "masks": {("allAp" if cityscapes else "AP"): metrics["masks.AP"]},
            "ssegs": {"mIoU": metrics["ssegs.mIoU"], "pixel_acc": 0.9}}


def planted_lines(first: float = 32.6, last: float = 3.17, n: int = 15) -> list:
    """metrics.jsonl lines of a run whose every term falls from ``first``
    to ``last`` (the JAX package's frozen-BN totals) over ``n`` intervals."""
    lines = []
    for i in range(n):
        value = first + (last - first) * i / (n - 1)
        lines.append({**{k: value / 7 for k in LOSS_KEYS}, "total": value, "iter": 10 * (i + 1),
                      "step_s": 3.0, "loader_wait_s": 1.0})
    return lines


@pytest.mark.parametrize("name", ["coco", "cityscapes"])
def test_the_eval_gate_accepts_the_reference_results(name):
    ref = dict(chip_smoke.JAX_TPU_RESULTS[name])
    ref.setdefault("pq.Things.pq", 0.776)  # cityscapes: STATUS.md's Things PQ
    metrics = chip_smoke.rehearsal_metrics(planted_results(ref, name == "cityscapes"),
                                           name == "cityscapes")
    assert {k: metrics[k] for k in ref} == ref
    assert chip_smoke.eval_gate(name, metrics) == []


def test_the_frozenbn_gates_accept_the_reference_run():
    lines = planted_lines()
    assert chip_smoke.loss_gate(lines) == []
    log = "... pretrained: loaded /x/step_00000000 (exact match)\n"
    assert chip_smoke.pretrained_gate(log, "/x/step_00000000") == []
    assert chip_smoke.eval_gate("frozenbn", {}) == []  # its metrics are recorded, not gated


@pytest.mark.parametrize("name,key,value", [
    ("coco", "pq.All.pq", 0.49), ("cityscapes", "pq.All.pq", 0.49),
    ("coco", "pq.Things.pq", 0.0), ("coco", "boxes.AP", 0.0), ("coco", "masks.AP", 0.0),
    ("cityscapes", "masks.AP", 0.0), ("coco", "pq.All.pq", math.nan)])
def test_the_eval_gate_refuses(name, key, value):
    ref = dict(chip_smoke.JAX_TPU_RESULTS[name], **{"pq.Things.pq": 0.8})
    ref[key] = value
    metrics = chip_smoke.rehearsal_metrics(planted_results(ref, name == "cityscapes"),
                                           name == "cityscapes")
    failures = chip_smoke.eval_gate(name, metrics)
    assert len(failures) == 1 and failures[0].startswith(key)


@pytest.mark.parametrize("value", [math.nan, math.inf])
def test_the_loss_gate_refuses_a_non_finite_term(value):
    lines = planted_lines()
    lines[7]["mask"] = value
    assert chip_smoke.loss_gate(lines) == [f"mask at iter 80 is {value}"]


@pytest.mark.parametrize("key", [*LOSS_KEYS, "total"])
def test_the_loss_gate_refuses_a_term_that_ends_above_its_start(key):
    lines = planted_lines()
    lines[-1][key] = lines[0][key] + 0.01
    failures = chip_smoke.loss_gate(lines)
    assert len(failures) == 1 and failures[0].startswith(f"{key} ends at")


@pytest.mark.parametrize("log", [
    "pretrained: /x/step_00000000 differs from the model in 4 class-dependent tensors -> "
    "COCO->Cityscapes head remap\n",
    "CheckpointMismatch: pretrained /x/step_00000000: differs from the model beyond the "
    "class-dependent layers: ['fcn_head.conv.weight']\n",
    "pretrained: loaded /y/step_00000000 (exact match)\n"])
def test_the_pretrained_gate_refuses_anything_but_an_exact_match(log):
    assert len(chip_smoke.pretrained_gate(log, "/x/step_00000000")) == 1


ZERO_PROBE = {"max_dy": 0.0, "max_dx": 0.0, "sat_frac": 0.0}


@pytest.mark.parametrize("impl, probe, refused", [
    ("gather", ZERO_PROBE, True), ("mxu", ZERO_PROBE, True),
    ("gather", dict(ZERO_PROBE, max_dx=0.004), False), ("mxu", dict(ZERO_PROBE, max_dy=3.0), False),
    # under these routes offsets that start at zero may stay there, as in the reference
    ("pallas", ZERO_PROBE, False), ("auto", ZERO_PROBE, False), ("shift", ZERO_PROBE, False)])
def test_the_offset_gate_refuses_offsets_left_at_zero(impl, probe, refused):
    """A file trained under ``gather`` or ``mxu`` (frozenbn trains under
    ``gather``) must have moved its offsets from their zero init: those
    routes' derivatives are not 0 at integer coordinates."""
    cfg = chip_smoke.load_config(chip_smoke.FROZENBN_YAML)
    assert cfg.network.dcn_impl_train == "gather"
    cfg = cfg.replace(network=dataclasses.replace(cfg.network, dcn_impl_train=impl))
    failures = chip_smoke.offset_gate(cfg, probe)
    assert len(failures) == int(refused)
    if refused:
        assert failures[0].startswith(f"the offsets did not move from zero under {impl}")


def _fields(cfg) -> dict:
    """Every field of a configuration, by dotted path."""
    out = {}
    for k, v in dataclasses.asdict(cfg).items():
        if isinstance(v, dict):
            out.update({f"{k}.{kk}": vv for kk, vv in v.items()})
        else:
            out[k] = v
    return out


@pytest.mark.parametrize("name", sorted(chip_smoke.REHEARSAL_YAMLS))
def test_the_copy_changes_only_the_paths(name, tmp_path):
    src = chip_smoke.REHEARSAL_YAMLS[name]
    changes = chip_smoke.rehearsal_changes(name, "/o/out", "/d/data", "/p/step_00000000")
    copy = chip_smoke.yaml_copy(src, str(tmp_path / "copy.yaml"), changes)
    shipped, got = _fields(load_config(src)), _fields(load_config(copy))
    paths = {"output_path": "/o/out", "dataset.dataset_path": "/d/data"}
    if name == "frozenbn":
        paths["network.pretrained"] = "/p/step_00000000"
    assert got.keys() == shipped.keys() and len(got) > 100
    assert {k for k in got if got[k] != shipped[k]} == set(paths)
    assert {k: got[k] for k in paths} == paths
    # the schedule, batch, wire, cache and watch fields as shipped
    assert got["train.max_iteration"] == {"coco": 600, "cityscapes": 300, "frozenbn": 150}[name]
    assert got["network.dcn_saturation_action"] == "fail"


def test_interval_rows_give_a_steps_ms():
    lines = [{"iter": 4, "step_s": 1.2, "loader_wait_s": 0.3},
             {"iter": 8, "step_s": 1.0, "loader_wait_s": 0.0},
             {"iter": 10, "step_s": 0.5, "loader_wait_s": 0.5}]
    rows = chip_smoke.interval_rows(lines)
    assert [it for it, _, _ in rows] == [4, 8, 10]
    assert [round(ms, 6) for _, ms, _ in rows] == [300.0, 250.0, 250.0]
    assert [round(share, 6) for _, _, share in rows] == [0.2, 0.0, 0.5]


def test_chip_smoke_imports_and_refuses_to_run_without_cuda():
    assert not torch.cuda.is_available()
    assert callable(chip_smoke.run_rehearsal) and callable(chip_smoke.run_phases)
    proc = subprocess.run([sys.executable, "chip_smoke.py", "--rehearsal", "coco"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1 and proc.stdout == ""
    assert "CUDA is not available" in proc.stderr


TINY_REHEARSAL = """\
symbol: resnet_50_upsnet
output_path: unused
dataset: {dataset: coco, dataset_path: unused, image_set: synthtrain,
          test_image_set: synthtrain, num_classes: 81, num_seg_classes: 133, num_stuff: 53}
network: {backbone: resnet_test, norm: gn, dcn_impl: auto, dcn_impl_train: pallas,
          dcn_boundary_grad: damped, dcn_saturation_action: warn, fpn_feature_dim: 32,
          rcnn_fc_dim: 64, fcn_head_dim: 16, compute_dtype: float32}
train: {image_wire: uint8, scales: [128], max_size: 192,
        image_buckets: [[128, 192], [192, 128]], rpn_pre_nms_top_n: 64,
        rpn_post_nms_top_n: 32, rpn_batch_size: 32, batch_rois: 16, max_gt_instances: 8,
        batch_size: 2, rpn_straddle_thresh: 100000, lr: 0.002, warmup_iteration: 2,
        max_iteration: 5, decay_iteration: [4], snapshot_step: 4, display_iter: 2,
        num_workers: 0, sample_cache_mb: 100}
test: {scales: [128], max_size: 192, image_buckets: [[128, 192], [192, 128]],
       rpn_pre_nms_top_n: 64, rpn_post_nms_top_n: 32, max_det: 8,
       panoptic_stuff_area_limit: 64}
"""


def test_the_coco_rehearsal_runs_end_to_end_on_a_tiny_copy(tmp_path, monkeypatch, capsys):
    """The flow of ``--rehearsal coco`` on the CPU: a tiny GN model on 4
    images of the port's ``make_synth_coco``, 5 steps, the evaluation of the
    last snapshot, the probe and the gate, which 5 steps cannot meet: the
    goldens comparison of the snapshot runs before the failure is raised.
    The entries' processes take 2 threads each, as the test processes do."""
    src = tmp_path / "tiny.yaml"
    src.write_text(TINY_REHEARSAL)
    real = chip_smoke.run_entry
    seen = []

    def on_the_cpu(tag, argv, log_path):
        seen.append(argv[0])
        extra = (["--num-images", "4"] if argv[0].endswith("make_synth_coco")
                 else ["--device", "cpu"])
        return real(tag, [*argv, *extra], log_path)

    monkeypatch.setattr(chip_smoke, "run_entry", on_the_cpu)
    monkeypatch.setattr(chip_smoke, "phase_build", lambda: None)
    monkeypatch.setitem(chip_smoke.REHEARSAL_YAMLS, "coco", str(src))
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(filter(None, (
        str(ROOT), os.environ.get("PYTHONPATH")))))
    monkeypatch.chdir(tmp_path)
    with pytest.raises(AssertionError, match=r"gate is not met: \['pq.All.pq"):
        chip_smoke.run_rehearsal("coco", torch.device("cpu"))
    out = capsys.readouterr().out
    assert seen == ["upsnet_torch.tools.make_synth_coco", "upsnet_torch.tools.train",
                    "upsnet_torch.tools.test"]
    run = tmp_path / "output" / "chip_smoke_rehearsal_coco"
    results = json.loads((run / "results.json").read_text())
    assert set(results) == {"boxes", "masks", "ssegs", "panoptic"}
    lines = [json.loads(line) for line in
             (run / "resnet_50_upsnet" / "metrics.jsonl").read_text().splitlines()]
    assert [e["iter"] for e in lines] == [2, 4, 5] and "dcn_max_dy" in lines[0]
    for text in ("total by interval", "step ms by interval", "the watch's dcn_max_dy",
                 "the probe on the trained weights", "eval: panoptic: ", "the port on the card",
                 "the JAX package's TPU run", "seconds by stage"):
        assert text in out, text
    assert "the reference's gate is met" not in out
    # the goldens of the trained snapshot, here the same device twice: the same tensors
    assert "goldens of the trained snapshot" in out and "worst: 0.0" in out
    assert (run / "goldens_card.npz").exists() and (run / "goldens_cpu.npz").exists()
