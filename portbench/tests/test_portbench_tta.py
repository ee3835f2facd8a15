"""The TTA evaluation cell at a tiny size on the CPU: the harness runs it as a
checkout would (``run.run_cell``), the program's TTA agrees with the float32
reference (``reference/tta_ref.py``) under the mix's limits, and the control
and the fault that the limits were set against fail them; the reference
imports nothing of the program."""

import json
import pathlib
import subprocess
import sys

import pytest

from portbench.drivers import tta as D
from portbench.tests.tiny import CELL, REPO, checkout, tiny_config

SEED = 2 ** 33 + 91
METRICS = ["tta_merge_ms.tta", "tta_forward_busy_ms.tta", "to_host_mb.tta", "mfu.tta"]


def tiny_tta():
    conf = tiny_config()
    conf["model"]["test"].update(scales=[64], max_size=128, image_buckets=[[64, 128]],
                                 multi_scale=[48, 64, 80], flip_test=True)
    mix = json.loads((REPO / "portbench" / "traffic" / "tta_city_b1.json").read_text())
    mix.update(frame=[64, 128], instances=[1, 3], pool=3, trace_requests=1, trace_steps=1,
               check={"pool": 3, "requests": 2})
    return conf, mix


def test_tta_cell_runs_through_the_harness(tmp_path):
    conf, mix = tiny_tta()
    per_layer = [{"name": n, "unit": "x", "better": "lower", "source": "program_span",
                  "layer": "tta", "moves": "predict_img_per_s", "workloads": [CELL]}
                 for n in METRICS]
    root = checkout(tmp_path, conf=conf, mix=mix, per_layer=per_layer)
    code = f"""
import json, sys, time
sys.path[:0] = [{str(root)!r}, {str(REPO)!r}]
from portbench import run
out = []
for trace in (0, 1):
    res, _ = run.run_cell({CELL!r}, {SEED}, 0.5, bool(trace), 'cpu', time.time())
    out.append(res)
print(json.dumps(out))
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=root,
                       timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    untraced, traced = json.loads(r.stdout.strip().splitlines()[-1])
    for res in (untraced, traced):
        assert res["correct"] and res["failed"] == 0, res["checked"]
        assert set(res["checked"]) == set(mix["limits"])
    assert untraced["metrics"]["predict_img_per_s"]["value"] > 0
    # no device on the CPU: the device's readers find nothing; the program's
    # ranges and byte counter are there
    assert {"tta_merge_ms.tta", "to_host_mb.tta"} <= set(traced["metrics"])
    assert traced["metrics"]["to_host_mb.tta"]["value"] > 0
    assert "variants (target, flip)" in r.stderr


@pytest.fixture(scope="module")
def judged():
    conf, mix = tiny_tta()
    cell = D.Cell(conf, mix, SEED, "cpu")
    window = cell.window(0.5, False)
    cell.release()
    return mix, D.judge(cell, window["outs"]), D.controls(cell, window["outs"])


def test_reference_agrees_and_the_limits_refuse_the_control_and_the_fault(judged):
    mix, numbers, controls = judged
    limits = mix["limits"]
    assert all(numbers[k] <= v for k, v in limits.items()), numbers
    for k in ("tta_seg_err", "tta_det_err", "seg_err", "mask_err"):
        assert numbers[k] < 1e-4, (k, numbers[k])
    assert numbers["tta_pan_gap"] == 0.0
    for side in ("control", "drop_flip"):
        got = controls[side]
        assert any(got[k] > limits[k] for k in got if k in limits), (side, got)
    # the fault leaves the program's own variants: only the merge is off
    assert controls["drop_flip"]["tta_seg_err"] > limits["tta_seg_err"]


def test_tta_reference_imports_nothing_of_the_program():
    code = f"""
import json, sys
sys.path[:0] = [{str(REPO)!r}]
from portbench.reference import tta_ref
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    top = set(json.loads(r.stdout.strip().splitlines()[-1]))
    assert not top & {"upsnet_torch", "jax", "jaxlib", "flax", "upsnet_tpu"}


def test_tta_limits_name_every_number():
    from portbench.reference.compare import NUMBERS
    from portbench.reference.tta_ref import NUMBERS as TTA_NUMBERS

    mix = json.loads((REPO / "portbench" / "traffic" / "tta_city_b1.json").read_text())
    assert set(mix["limits"]) <= set(NUMBERS + TTA_NUMBERS)
    assert set(TTA_NUMBERS) <= set(mix["limits"])
    assert mix["kind"] == "tta" and (pathlib.Path(D.__file__).stem == "tta")
    assert mix["trace_steps"] == mix["trace_requests"]


class _Span:
    def __init__(self, start, end):
        self.start, self.end = start, end

    def elapsed_us(self):
        return self.end - self.start


class _Event:
    def __init__(self, name, on_device, annotation, start, end):
        from torch.autograd import DeviceType

        self.name, self.is_user_annotation = name, annotation
        self.device_type = DeviceType.CUDA if on_device else DeviceType.CPU
        self.time_range = _Span(start, end)


def test_forward_busy_counts_the_kernels_that_start_inside_the_host_ranges():
    from portbench import metrics as M

    events = [_Event("tta.predict", False, True, 0, 100),
              _Event("tta.predict", False, True, 200, 300),
              _Event("predict.trunk", False, True, 10, 90),
              _Event("predict.trunk", True, True, 20, 30),  # the range's device span
              _Event("conv", True, False, 20, 30),
              _Event("fuse_kernel", True, False, 150, 160),  # launched by the fusion
              _Event("conv", True, False, 210, 240)]
    ctx = {"traced": {"events": events, "images": 2}}
    assert M.load("tta_forward_busy_ms.tta").read(ctx) == (10 + 30) / 1e3 / 2
    assert M.load("tta_forward_busy_ms.tta").read(
        {"traced": {"events": events[2:], "images": 2}}) is None  # a program without ranges
