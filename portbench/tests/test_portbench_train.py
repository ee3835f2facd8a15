"""The training cells' comparison at a tiny size on the CPU: the float32
reference's step against the program's, the controls, and runs with the
program's step broken underneath (its state left unchanged, half of the
batch left out with the mean taken over the rest), which come out not
correct."""

import json
import subprocess
import sys

import pytest

from portbench import weights as W
from portbench.drivers import train as T
from portbench.reference.compare import train_numbers, train_run
from portbench.tests.tiny import REPO, TRAIN_CELL, checkout, tiny_config, tiny_train_mix


@pytest.fixture(scope="module")
def stepped():
    conf, mix = tiny_config(), tiny_train_mix()
    cell = T.Cell(conf, mix, 2 ** 31 + 77, "cpu")
    cell.release()
    return cell


def test_reference_follows_the_programs_steps(stepped):
    numbers = T.judge(stepped, stepped.check)
    assert numbers["loss1_err"] < 1e-5 and numbers["grad_err"] < 1e-3, numbers
    assert numbers["prop_err"] == 0.0 and numbers["prop_miss"] == 0.0, numbers
    assert numbers["update_med"] < 1e-2, numbers


def test_controls_fail_the_limits(stepped):
    limits = tiny_train_mix()["limits"]
    for side, numbers in T.controls(stepped, stepped.check).items():
        assert any(numbers[k] > v for k, v in limits.items() if k in numbers), (side, numbers)


def test_unchanged_state_reads_one(stepped):
    state = W.make_state(stepped.shapes, stepped.conf["weights"], stepped.seed, "cpu")
    ref = train_run(stepped.conf["model"], state, stepped.check, "cpu")
    side = {"losses": ref["losses"], "g1": ref["g1"], "dp": dict.fromkeys(ref["dp"], 0.0)}
    assert train_numbers(side, ref)["update_err"] == pytest.approx(1.0)


FAULTS = {
    "none": "",
    "unchanged_state": "step_mod.sgd_update = lambda optimizer, cfg, step=None: 0.0",
    "half_batch": """
original = step_mod.forward_train
def half(model, cfg, anchors, batch, noise=None, generator=None, joined_counts=None):
    h = batch['images'].shape[0] // 2
    return original(model, cfg, anchors, {k: v[:h] for k, v in batch.items()},
                    {k: v[:h] for k, v in noise.items()}, generator, joined_counts)
step_mod.forward_train = half
""",
}

_CODE = """
import json, sys, time
sys.path[:0] = [{root!r}, {repo!r}]
from upsnet_torch.train import step as step_mod
{fault}
from portbench import run
res, checked = run.run_cell({cell!r}, 2 ** 31 + 5, 1.0, False, 'cpu', time.time())
print(json.dumps({{'correct': res['correct'], 'checked': checked}}))
"""


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return checkout(tmp_path_factory.mktemp("train_faults"))


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_step_makes_the_run_incorrect(root, fault):
    code = _CODE.format(root=str(root), repo=str(REPO), fault=FAULTS[fault], cell=TRAIN_CELL)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=root,
                       timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    if fault == "none":
        assert res["correct"], res["checked"]
    else:
        assert not res["correct"], res["checked"]
