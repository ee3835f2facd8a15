"""The cells at their own sizes on the card: a short run of each is correct,
and the control (the reference rounded through float8 in the program's
place) fails one of the cell's numbers. Marked ``card``; they skip without
one. Run them on the card with ``python -m pytest portbench/tests -q -m card``."""

import json
import time

import pytest

from portbench import run
from portbench.tests.tiny import REPO

MANIFEST = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MANIFEST["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_is_correct(card, cell):
    result, checked = run.run_cell(cell, 2 ** 31 + 1009, 5.0, False, "cuda", time.time())
    assert result["correct"], checked
    assert result["device"]["platform"] == "gpu" and result["failed"] == 0


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails(card, cell):
    _, _, conf, mix = run.cell_files(cell)
    driver = run.load_driver(mix["kind"])
    runner = driver.Cell(conf, mix, 2 ** 31 + 2003, "cuda")
    window = runner.window(3.0, False)
    runner.release()
    numbers = driver.controls(runner, window["outs"])["control"]
    assert any(numbers[k] > v for k, v in mix["limits"].items() if k in numbers), numbers
