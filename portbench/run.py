"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. ``BENCHMARK.json`` names the cell's
configuration (``portbench/configs/<config>.json``) and traffic mix
(``portbench/traffic/<traffic>.json``); the mix's ``kind`` names its driver
(``portbench/drivers/<kind>.py``) and the manifest's metrics name their
readers (``portbench/metrics/<metric>.py``), so a cell, a configuration, a
mix or a per-layer metric is added as files and a manifest entry alone.

The run sets up (counted in ``setup_s``, from the process's start), measures
for ``--seconds``, reads the card's allocation peak, frees the program, and
judges the outputs it kept from the window against the float32 reference.
With ``--trace 0`` the result carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics from a profiled stretch of the window.
The last line of standard output is the result as one JSON object; the last
lines of standard error give every compared number beside its limit.
Kernel builds and caches stay inside the checkout, under ``build/``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
BENCH = ROOT / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "upsnet_tpu"}


def process_start() -> float:
    """The process's start on the ``time.time`` clock, from /proc."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/stat") as f:
        btime = next(int(line.split()[1]) for line in f if line.startswith("btime"))
    return btime + ticks / os.sysconf("SC_CLK_TCK")


def set_cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["USE_FLAX"] = "0"


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(workload: str) -> tuple[dict, dict, dict, dict]:
    """(manifest, cell entry, configuration file, mix file) of ``workload``."""
    manifest = load_json(ROOT / "BENCHMARK.json")
    cell = next((w for w in manifest["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"unknown workload {workload!r}")
    config = next(c for c in manifest["configs"] if c["name"] == cell["config"])
    conf = load_json(ROOT / config["file"])
    mix = load_json(BENCH / "traffic" / f"{cell['traffic']}.json")
    return manifest, cell, conf, mix


def load_driver(kind: str):
    path = BENCH / "drivers" / f"{kind}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.drivers.{kind}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_names(entries, workload: str) -> list:
    return [m["name"] for m in entries if workload in m.get("workloads", [workload])]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def power_limit() -> str:
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str,
             t_start: float) -> tuple[dict, dict]:
    """One run of ``workload`` on ``device``. Returns (result, compared
    numbers with their limits)."""
    import torch

    from portbench import endtoend
    from portbench import metrics as M
    from portbench.metrics import _profile

    manifest, cell, conf, mix = cell_files(workload)
    driver = load_driver(mix["kind"])
    torch.set_num_threads(4)
    runner = driver.Cell(conf, mix, seed, device)
    setup_s = time.time() - t_start
    window = runner.window(seconds, trace)
    runner.release()
    numbers = driver.judge(runner, window["outs"])
    limits = mix["limits"]
    checked = {k: {"value": numbers[k] if math.isfinite(numbers[k]) else 1e300,
                   "limit": limits[k]} for k in limits}
    correct = all(v["value"] <= v["limit"] for v in checked.values())
    dev = torch.device(device)
    result = {
        "correct": correct, "attempted": window["requests"], "failed": window["failed"],
        "metrics": {},
        "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": int(cell["chips"]),
                   "memory_peak_bytes": int(window["memory_peak_bytes"])},
    }
    if trace:
        traced = window["traced"]
        summary = (_profile.summarize(traced["events"], window["prefix"], traced["untraced_s"],
                                      window.get("other_thread", ())) if traced else None)
        ctx = {"summary": summary, "traced": traced, "model": conf["model"], "mix": mix,
               "window": window}
        result["metrics"] = M.read_all(metric_names(manifest["per_layer"], workload), ctx)
        if summary:
            result["device"].update(busy_s=summary["busy_ms"] / 1e3, window_s=traced["wall_s"])
            result["breakdown"] = _profile.breakdown(summary)
    else:
        units = {m["name"]: m["unit"] for m in manifest["end_to_end"]}
        values = endtoend.compute(metric_names(manifest["end_to_end"], workload), window, setup_s)
        result["metrics"] = {k: {"value": v, "unit": units[k]} for k, v in values.items()}
    result["card"] = power_limit() if dev.type == "cuda" else "cpu"
    result["checked"] = checked
    return result, checked


def main(argv=None) -> int:
    t_start = process_start()
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    set_cache_dirs()
    sys.path.insert(0, str(ROOT))
    import torch

    chips = next((w["chips"] for w in load_json(ROOT / "BENCHMARK.json")["workloads"]
                  if w["name"] == args.workload), None)
    if chips is None:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    result, checked = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                               "cuda", t_start)
    loaded = forbidden_modules()
    if loaded:
        print(f"the run loaded {loaded}; the benchmark may not", file=sys.stderr)
        return 4
    for k, v in checked.items():
        print(f"{k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
