"""The harness is driven by data: a mix, a configuration, a cell or a
per-layer metric is added as files and a manifest entry, with no edit to a
file that exists; and the manifest keeps to the benchmark's contract."""

import json
import re
import subprocess
import sys

from portbench import metrics as M
from portbench.tests.tiny import CELL, REPO, checkout, tiny_mix

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")

PROBE_METRIC = '''
LAYER = "device"
UNIT = "requests"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "predict_img_per_s"


def read(ctx):
    return float(ctx["traced"]["requests"]) if ctx.get("traced") else None
'''


def test_new_mix_and_metric_are_found_without_edits(tmp_path):
    mix = dict(tiny_mix(batch=1), pool=2, trace_requests=3)
    metric = {"name": "throwaway_probe.serve", "unit": "requests", "better": "higher",
              "source": "device_trace", "layer": "device", "moves": "predict_img_per_s",
              "workloads": [CELL]}
    root = checkout(tmp_path, mix=mix, per_layer=[metric])
    before = {p.relative_to(root): p.read_bytes() for p in (root / "portbench").rglob("*.py")}
    (root / "portbench" / "metrics" / "throwaway_probe.serve.py").write_text(PROBE_METRIC)
    code = f"""
import json, sys, time
sys.path[:0] = [{str(root)!r}, {str(REPO)!r}]
from portbench import run
res, _ = run.run_cell({CELL!r}, 5, 1.0, True, 'cpu', time.time())
print(json.dumps(res["metrics"]))
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=root,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    metrics = json.loads(r.stdout.strip().splitlines()[-1])
    assert metrics["throwaway_probe.serve"]["value"] == 3.0  # the new mix's trace_requests
    assert metrics["throwaway_probe.serve"]["unit"] == "requests"
    after = {p.relative_to(root): p.read_bytes() for p in (root / "portbench").rglob("*.py")
             if p.name != "throwaway_probe.serve.py"}
    assert before == after


def test_run_refuses_without_a_card(tmp_path):
    root = checkout(tmp_path)
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload", "r50_coco.serve_b1",
                        "--seed", str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=root, timeout=600)
    assert r.returncode != 0 and not r.stdout.strip()


def test_manifest_keeps_to_the_contract():
    m = json.loads((REPO / "BENCHMARK.json").read_text())
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert m["paths"] == ["portbench"] and m["command"][1].startswith("portbench/")
    assert 1 <= m["run_seconds"] <= 51
    configs = {c["name"]: c for c in m["configs"]}
    used = {w["config"] for w in m["workloads"]}
    assert set(configs) == used
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert (REPO / c["file"]).is_file() and c["file"].startswith("portbench/")
    cells = {w["name"] for w in m["workloads"]}
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["chips"] == 1 and len(w["why"]) <= 200
        mix = json.loads((REPO / "portbench" / "traffic" / f"{w['traffic']}.json").read_text())
        assert (REPO / "portbench" / "drivers" / f"{mix['kind']}.py").is_file()
    e2e = {e["name"]: e for e in m["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for e in m["end_to_end"]:
        assert 0.01 <= e["bound"] <= 0.25 and UNIT.match(e["unit"])
        assert e["source"] in ("host_clock", "device_trace")
        assert set(e.get("workloads", cells)) <= cells
    for p in m["per_layer"]:
        reader = M.load(p["name"])
        assert (p["unit"], p["better"], p["source"], p["layer"], p["moves"]) == (
            reader.UNIT, reader.BETTER, reader.SOURCE, reader.LAYER, reader.MOVES)
        assert p["moves"] in e2e and UNIT.match(p["unit"])
        # every cell that lists the metric reports the metric it moves
        for cell in p["workloads"]:
            assert cell in e2e[p["moves"]].get("workloads", cells)
    for cell in cells:
        assert any(cell in e.get("workloads", cells) and e["name"] != "setup_s"
                   for e in m["end_to_end"])
        assert any(cell in p["workloads"] for p in m["per_layer"])
    assert len(json.dumps(m)) < 64 * 1024
