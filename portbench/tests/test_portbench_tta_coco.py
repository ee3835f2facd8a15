"""What the COCO TTA cell and the canvas shares add to the benchmark, on the
CPU: the mix names every number the TTA judge gives, the padding share's
reader reads the program's canvas tally (and nothing from a program without
it), and the harness reports it in a traced run of a tiny TTA cell whose
largest scale outgrows its canvas."""

import json
import subprocess
import sys

import pytest

from portbench import metrics as M
from portbench.tests.tiny import CELL, REPO, checkout, tiny_config

SEED = 2 ** 33 + 4093
SHARE = "tta_pad_share.tta"


def test_coco_tta_mix_names_every_number():
    from portbench.reference.compare import NUMBERS
    from portbench.reference.tta_ref import NUMBERS as TTA_NUMBERS

    mix = json.loads((REPO / "portbench" / "traffic" / "tta_coco_b1.json").read_text())
    assert set(TTA_NUMBERS) <= set(mix["limits"]) <= set(NUMBERS + TTA_NUMBERS)
    assert mix["kind"] == "tta" and mix["trace_steps"] == mix["trace_requests"]
    assert mix["frame"] == [480, 640]


def test_pad_share_reads_the_programs_tally(monkeypatch):
    from upsnet_torch.utils import profiling

    pad = M.load(SHARE)
    profiling.reset_syncs()
    assert pad.read({}) is None  # nothing counted yet
    # the COCO TTA cell's 640x480 frame: 800, 640 and 960 (cropped) on 832x1344
    for content in ((800, 1067), (640, 853), (960, 1280)) * 2:
        profiling.count_canvas((832, 1344), content)
    inside = 800 * 1067 + 640 * 853 + 832 * 1280
    assert pad.read({}) == pytest.approx(1 - inside / (3 * 832 * 1344), rel=1e-12)
    assert round(pad.read({}), 3) == 0.265
    monkeypatch.delattr(profiling, "read_canvas")  # a program without the tally
    assert pad.read({}) is None
    profiling.reset_syncs()


def test_the_harness_reports_the_pad_share(tmp_path):
    conf = tiny_config()
    # a 48x64 frame at 64 and 48 on 64x128, and at 80 (80x107), which no
    # bucket holds: cropped to 64x128
    conf["model"]["test"].update(scales=[64], max_size=133, image_buckets=[[64, 128], [128, 64]],
                                 multi_scale=[48, 64, 80], flip_test=True)
    mix = json.loads((REPO / "portbench" / "traffic" / "tta_coco_b1.json").read_text())
    mix.update(frame=[48, 64], instances=[1, 3], pool=2, trace_requests=1, trace_steps=1,
               check={"pool": 2, "requests": 1})
    per_layer = [{"name": SHARE, "unit": "share", "better": "lower", "source": "program_counter",
                  "layer": "tta", "moves": "predict_img_per_s", "workloads": [CELL]}]
    root = checkout(tmp_path, conf=conf, mix=mix, per_layer=per_layer)
    code = f"""
import json, sys, time
sys.path[:0] = [{str(root)!r}, {str(REPO)!r}]
from portbench import run
res, _ = run.run_cell({CELL!r}, {SEED}, 0.5, True, 'cpu', time.time())
print(json.dumps(res))
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=root,
                       timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checked"]
    inside = 64 * 85 + 48 * 64 + 64 * 107
    assert res["metrics"][SHARE]["value"] == pytest.approx(1 - inside / (3 * 64 * 128), rel=1e-12)
