"""The float32 reference against the program's CPU path at a tiny size, on
the same seeded weights and inputs, and the benchmark's import boundary.

The tests import the program; the reference does not."""

import json
import math
import subprocess
import sys

import pytest
import torch

from portbench import weights as W
from portbench.drivers import predict as D
from portbench.reference.compare import NUMBERS
from portbench.reference.upsnet_ref import Ref
from portbench.tests.tiny import REPO, tiny_config, tiny_mix

SEED = 2 ** 31 + 4242


@pytest.fixture(scope="module")
def judged():
    conf, mix = tiny_config(), tiny_mix()
    cell = D.Cell(conf, mix, SEED, "cpu")
    window = cell.window(1.5, False)
    cell.release()
    return D.judge(cell, window["outs"]), window


def test_reference_agrees_with_the_program_in_float32(judged):
    numbers, window = judged
    assert window["outs"], "the window captured no request for the check"
    assert set(numbers) == set(NUMBERS)
    for k in ("fpn_err", "rpn_err", "seg_err", "prop_err", "box_err", "det_err", "mask_err"):
        assert numbers[k] < 1e-4, (k, numbers[k])
    for k in ("prop_miss", "seg_gap", "pan_gap", "keep_margin"):
        assert numbers[k] == 0.0, (k, numbers[k])


def test_reference_predict_matches_forward_predict():
    """The reference's whole predict path on its own against the program's
    ``forward_predict``: detections, masks, maps."""
    from upsnet_torch.config import default_config
    from upsnet_torch.config.loader import update_config
    from upsnet_torch.evaluation.inference import bucket_anchors
    from upsnet_torch.models import get_model
    from upsnet_torch.models.upsnet import forward_predict
    from portbench.traffic.generator import make_requests

    conf, mix = tiny_config(), tiny_mix()
    cfg = update_config(default_config(), conf["model"])
    model = get_model(cfg.symbol, cfg, device="cpu")
    state = W.make_state(W.state_shapes(model), conf["weights"], SEED, "cpu")
    model.load_state_dict(state)
    images, im_hw = make_requests(mix, 4, 3, SEED)
    batch = {"images": torch.from_numpy(images[0]), "im_hw": torch.from_numpy(im_hw[0])}
    out = forward_predict(model, cfg, bucket_anchors(cfg, tuple(mix["bucket"]), "cpu"), batch)
    ref = Ref(conf["model"], state)
    for j in range(len(images[0])):
        r = ref.predict(torch.from_numpy(images[0, j]), tuple(float(v) for v in im_hw[0, j]))
        v = out["det_valid"][j]
        assert torch.equal(v, r["det_valid"]) and int(v.sum()) > 0
        assert torch.equal(out["classes"][j][v].long(), r["classes"][v].long())
        assert torch.allclose(out["boxes"][j][v], r["boxes"][v], atol=1e-3)
        assert torch.allclose(out["scores"][j][v], r["scores"][v], atol=1e-5)
        # float32 rounding of the decoded boxes moves RoIAlign's samples by
        # about 1e-3 px, so the masks agree to 1e-4 of their largest value
        for got, want in ((out["mask_logits"][j][v], r["mask_logits"][v]),
                          (out["seg_logits"][j], r["seg_logits"])):
            assert (got - want).abs().max() <= 1e-4 * want.abs().max()
        assert torch.equal(out["pan_map"][j].long(), r["pan_map"].long())
        assert torch.equal(out["pan_keep"][j], r["pan_keep"])


_BOUNDARY = """
import json, sys, time
sys.path[:0] = [{repo!r}]
{body}
top = sorted({{m.split('.')[0] for m in sys.modules}})
print(json.dumps(top))
"""


def _loaded(body: str) -> set:
    code = _BOUNDARY.format(repo=str(REPO), body=body)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO,
                       env={"PATH": "/usr/bin:/bin", "HOME": str(REPO / "build")}, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return set(json.loads(r.stdout.strip().splitlines()[-1]))


def test_run_and_reference_load_no_jax():
    """A whole tiny run (the harness, the program, the reference) loads no
    module whose top-level name is jax, jaxlib, flax or upsnet_tpu,
    compared by whole names: upsnet_torch starts with the same letters."""
    body = """
import pathlib, tempfile
from portbench.tests.tiny import checkout, CELL
root = checkout(pathlib.Path(tempfile.mkdtemp()))
sys.path.insert(0, str(root))
for k in [m for m in sys.modules if m == 'portbench' or m.startswith('portbench.')]:
    del sys.modules[k]
from portbench import run
run.run_cell(CELL, 99, 0.5, True, 'cpu', time.time())
"""
    top = _loaded(body)
    assert "upsnet_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "upsnet_tpu"}


def test_reference_imports_nothing_of_the_program():
    body = """
from portbench.reference import compare, train_ref, upsnet_ref
"""
    top = _loaded(body)
    assert not top & {"upsnet_torch", "jax", "jaxlib", "flax", "upsnet_tpu"}


def test_limits_name_every_number():
    for mix in ("serve_b1", "offline_b8"):
        limits = json.loads((REPO / "portbench" / "traffic" / f"{mix}.json").read_text())["limits"]
        assert set(limits) <= set(NUMBERS)
        assert all(math.isfinite(v) and v > 0 for v in limits.values())
