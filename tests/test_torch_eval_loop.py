"""The whole evaluation loop of the port against the JAX package's on the
tiny synthetic config (``experiments/upsnet_tiny_synthetic.yaml``: resnet_test
trunk, GroupNorm, FCN DCN under ``gather``, float32, 128x160 buckets), on the
same 8 ``SyntheticDataset`` images (256x320, resized into the 128x160
bucket).

(a) JAX ``model.init`` weights, written as a port checkpoint by the bridge
    and read back through ``run_evaluation(weights=...)``;
(b) weights trained 40 steps by the port's ``train_steps`` on
    ``synthetic_batch``, crossed to JAX with ``to_jax``;
(c) the CLI, ``python -m upsnet_torch.tools.test --device cpu --weights``.

Tolerances, per image: the same number of detections with the same classes;
boxes within 0.1 px of the original image (0.05 px on the 128x160 canvas)
and scores within 1e-4. The two frameworks sum convolutions in other float32
orders, and the random-init box head turns that into up to 0.055 px and
4.6e-5 (0.013 px and 2.8e-6 after 40 steps), so 1e-3 px and 1e-5 do not
hold. At least 99.9% of the pixels of the decoded mask RLEs, of the semantic
map and of the panoptic id map equal.
Metrics: PQ / SQ / RQ (All, Things, Stuff), box and mask AP / AP50 / AP75,
mIoU and pixel accuracy within 1e-3 absolute. The CLI gives the port's
``run_evaluation`` dict exactly.
"""

import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upsnet_tpu.config import load_config as jax_load_config
from upsnet_tpu.data.synthetic import SyntheticDataset as JaxSynthetic
from upsnet_tpu.evaluation.inference import run_evaluation as jax_run_evaluation
from upsnet_tpu.models.registry import get_model as jax_get_model
from upsnet_torch.config import load_config
from upsnet_torch.convert.from_jax import save_jax_params_checkpoint, to_jax
from upsnet_torch.data.synthetic import SyntheticDataset, synthetic_batch
from upsnet_torch.evaluation import rle
from upsnet_torch.evaluation.inference import bucket_anchors, run_evaluation
from upsnet_torch.models import get_model
from upsnet_torch.tools import test as test_cli
from upsnet_torch.train.checkpoints import save_checkpoint
from upsnet_torch.train.trainer import train_steps

torch.set_num_threads(2)

TINY_YAML = "experiments/upsnet_tiny_synthetic.yaml"
BUCKET = (128, 160)
N_IMAGES = 8
TRAIN_STEPS = 40
BOX_PX, SCORE_ABS, PIXEL_SHARE, METRIC_ABS = 0.1, 1e-4, 0.999, 1e-3
METRICS = {"boxes": ("AP", "AP50", "AP75"), "masks": ("AP", "AP50", "AP75"),
           "ssegs": ("mIoU", "pixel_acc")}


@pytest.fixture(scope="module")
def cfgs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("out"))
    return load_config(TINY_YAML).replace(output_path=out), jax_load_config(TINY_YAML)


@pytest.fixture(scope="module")
def jax_init(cfgs):
    """The JAX model's random init at the first test bucket, as numpy."""
    _, jcfg = cfgs
    model = jax_get_model(jcfg.symbol, jcfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1,) + tuple(jcfg.test.image_buckets[0]) + (3,)))
    return jax.device_get(params["params"])


def _recording(dataset):
    """Keep what ``run_evaluation`` hands each evaluator."""
    seen = {}
    for name in ("evaluate_boxes", "evaluate_ssegs", "evaluate_panoptic"):
        def record(preds, _orig=getattr(dataset, name), _name=name):
            seen[_name] = preds
            return _orig(preds)

        setattr(dataset, name, record)
    return dataset, seen


def _evaluate_jax(jcfg, params):
    ds, seen = _recording(JaxSynthetic(jcfg, N_IMAGES, training=False))
    return jax_run_evaluation(jcfg, ds, params=params, use_mesh=False), seen


def _evaluate_port(tcfg, weights):
    ds, seen = _recording(SyntheticDataset(tcfg, N_IMAGES, training=False))
    timings = {}
    results = run_evaluation(tcfg, ds, weights=weights, device="cpu", timings=timings)
    assert timings["images"] == N_IMAGES and timings["device"] == "cpu"
    return results, seen


def _share_equal(got, ref) -> float:
    got, ref = np.concatenate([g.ravel() for g in got]), np.concatenate([r.ravel() for r in ref])
    return float((got == ref).mean()) if ref.size else 1.0


def _assert_loop_agrees(got, got_seen, ref, ref_seen):
    dets_got, dets_ref = got_seen["evaluate_boxes"], ref_seen["evaluate_boxes"]
    for image in range(N_IMAGES):
        g = [d for d in dets_got if d["image_id"] == image]
        r = [d for d in dets_ref if d["image_id"] == image]
        assert len(g) == len(r), image
        assert [d["category"] for d in g] == [d["category"] for d in r], image
        for key, atol in (("bbox", BOX_PX), ("score", SCORE_ABS)) if r else ():
            np.testing.assert_allclose([d[key] for d in g], [d[key] for d in r], rtol=0,
                                       atol=atol, err_msg=f"image {image} {key}")
    shares = {
        "masks": _share_equal([rle.decode(d["segmentation"]) for d in dets_got],
                              [rle.decode(d["segmentation"]) for d in dets_ref]),
        "seg": _share_equal([p["pred"] for p in got_seen["evaluate_ssegs"]],
                            [p["pred"] for p in ref_seen["evaluate_ssegs"]]),
        "panoptic": _share_equal([p["id_map"] for p in got_seen["evaluate_panoptic"]],
                                 [p["id_map"] for p in ref_seen["evaluate_panoptic"]]),
    }
    assert all(v >= PIXEL_SHARE for v in shares.values()), shares
    assert set(got) == set(ref) == {"boxes", "masks", "ssegs", "panoptic"}
    pairs = [(got[k][m], ref[k][m], f"{k}.{m}") for k, ms in METRICS.items() for m in ms]
    pairs += [(got["panoptic"][part][m], ref["panoptic"][part][m], f"panoptic.{part}.{m}")
              for part in ("All", "Things", "Stuff") for m in ("pq", "sq", "rq")]
    for g, r, name in pairs:
        assert (math.isnan(g) and math.isnan(r)) or abs(g - r) <= METRIC_ABS, (name, g, r)
    return len(dets_ref)


def test_random_init_loop_matches_jax(cfgs, jax_init, tmp_path):
    tcfg, jcfg = cfgs
    ref, ref_seen = _evaluate_jax(jcfg, jax_init)
    weights = save_jax_params_checkpoint(str(tmp_path), 0, jax_init)
    got, got_seen = _evaluate_port(tcfg, weights)
    n_dets = _assert_loop_agrees(got, got_seen, ref, ref_seen)
    assert n_dets > 0  # random class scores pass the 0.05 threshold


@pytest.fixture(scope="module")
def trained(cfgs, jax_init, tmp_path_factory):
    """The tiny model after 40 port train steps on synthetic batches (seeds
    0-3 in turn), its port checkpoint, and the same weights as a JAX tree."""
    tcfg, _ = cfgs
    model = get_model(tcfg.symbol, tcfg, device="cpu")
    anchors = bucket_anchors(tcfg, BUCKET, "cpu")
    batches = [{k: torch.as_tensor(v) for k, v in synthetic_batch(tcfg, BUCKET, 2, seed=s).items()}
               for s in range(4)]
    history = train_steps(model, tcfg, anchors, [batches[i % 4] for i in range(TRAIN_STEPS)],
                          generator=torch.Generator().manual_seed(0))
    assert history[-1]["total"] < history[0]["total"]
    path = save_checkpoint(str(tmp_path_factory.mktemp("ckpt")), TRAIN_STEPS, model)
    return path, to_jax(model.state_dict(), jax_init)


@pytest.fixture(scope="module")
def trained_port_results(cfgs, trained):
    return _evaluate_port(cfgs[0], trained[0])


def test_trained_loop_matches_jax(cfgs, trained, trained_port_results):
    """The first accuracy figure of the port: the same PQ, AP and mIoU as
    the JAX package on weights the port trained."""
    _, jcfg = cfgs
    ref, ref_seen = _evaluate_jax(jcfg, trained[1])
    got, got_seen = trained_port_results
    _assert_loop_agrees(got, got_seen, ref, ref_seen)
    assert got["ssegs"]["mIoU"] > 0.2 and got["panoptic"]["All"]["pq"] > 0.1  # it learned


def _same(got, ref, path=""):
    if isinstance(ref, dict):
        assert set(got) == set(ref), path
        for k in ref:
            _same(got[k], ref[k], f"{path}/{k}")
    else:
        assert (isinstance(ref, float) and math.isnan(ref) and math.isnan(got)) or got == ref, \
            (path, got, ref)


def test_cli_gives_the_same_metrics(cfgs, trained, trained_port_results, tmp_path,
                                    monkeypatch):
    monkeypatch.chdir(tmp_path)  # the yaml's output_path is relative: logs land here
    yaml = str(pathlib.Path(__file__).resolve().parents[1] / TINY_YAML)
    results, timings = test_cli.run(["--cfg", yaml, "--dataset-override", "synthetic",
                                     "--device", "cpu", "--weights", trained[0], "--no-mesh"])
    _same(results, trained_port_results[0])
    assert timings["images"] == N_IMAGES
    assert list((tmp_path / "output/tiny_synthetic/upsnet/panoptic/pred_pans").iterdir())
    assert list((tmp_path / "output/tiny_synthetic/upsnet").glob("upsnet_test_*.log"))
