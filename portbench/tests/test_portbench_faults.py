"""A run with its timed path broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a run
(``run.run_cell``: set-up, window, the comparison with its limits) of a tiny
cell on the CPU, with the program's ``forward_predict`` wrapped so that one
fault of the kinds an inference cell can have happens where the answer is
produced: an answer altered (a detection's class, box or mask, a patch of
the semantic or panoptic map), or half of the batch left out. A run without
a fault is correct."""

import json
import subprocess
import sys

import pytest

from portbench.tests.tiny import CELL, REPO, checkout

FAULTS = {
    "none": "",
    "det_class": "k = int(o['det_valid'][0].nonzero()[0]); o['classes'][0, k] = o['classes'][0, k] % 4 + 1",
    "det_box": "k = int(o['det_valid'][0].nonzero()[0]); o['boxes'][0, k] += 8.0",
    "mask": "k = int(o['det_valid'][0].nonzero()[0]); o['mask_logits'][0, k] = -o['mask_logits'][0, k]",
    "seg_map": "o['seg_logits'][0, 2:6, 2:6] = o['seg_logits'][0, 2:6, 2:6].flip(-1)",
    "pan_map": "o['pan_map'][0, 2:6, 2:6] = (o['pan_map'][0, 2:6, 2:6] + 1) % 3",
    "half_batch": "h = o['boxes'].shape[0] // 2\nfor k in o: o[k][h:] = o[k][:h]",
}

_CODE = """
import json, sys, time
sys.path[:0] = [{root!r}, {repo!r}]
from upsnet_torch.evaluation import inference
original = inference.forward_predict
def broken(*a, **kw):
    o = original(*a, **kw)
{fault}
    return o
inference.forward_predict = broken
from portbench import run
res, checked = run.run_cell({cell!r}, 2 ** 31 + 31, 1.5, False, 'cpu', time.time())
print(json.dumps({{'correct': res['correct'], 'checked': checked}}))
"""


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return checkout(tmp_path_factory.mktemp("faults"))


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_makes_the_run_incorrect(root, fault):
    body = "\n".join("    " + line for line in (FAULTS[fault] or "pass").splitlines())
    code = _CODE.format(root=str(root), repo=str(REPO), fault=body, cell=CELL)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=root,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    over = {k: v for k, v in res["checked"].items() if v["value"] > v["limit"]}
    if fault == "none":
        assert res["correct"], over
    else:
        assert not res["correct"] and over, res["checked"]
