"""The port's training entry (``train/trainer.py:train``, ``tools/train.py``)
against the JAX loop's rules, on the tiny trunk of ``test_torch_datasets.py``
on the CPU.

* Snapshots at exactly the iterations of the JAX rule (``it % snapshot_step
  == 0`` or the last; ``snapshot_step`` 4, 10 steps: 4, 8, 10) and
  ``metrics.jsonl`` lines at ``iter`` 3, 6, 9 and the tail's 10, with the JAX
  loop's field names.
* The rate of every step equals JAX ``lr_schedule(cfg)`` at optax's update
  count (within 1e-7 relative; the port computes it in float32 as JAX does),
  from a fresh start, with ``begin_iteration``, and across a resume, over
  both buckets.
* A resume restores the weights, the momentum buffers and the update count
  bit for bit, and its steps equal, bit for bit, those of a fresh ``train``
  given the snapshot's weights, optimizer state and count (both replay the
  data from position 0, as the JAX loop does).
* ``load_pretrained_any``: the ``latest`` tail, the exact load, the COCO ->
  Cityscapes remap equal to the JAX remap through the weight bridge, a
  reference ``.pth`` and a JAX (Orbax) snapshot refused by name.
* ``tools.train.run`` and ``tools.test.run`` (coco and cityscapes) end to end
  with ``--device cpu``; without a card the default device is refused.
* ``utils/profiling.py``: ``trace`` writes a Chrome trace.
"""

import dataclasses
import json
import logging
import math
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_datasets import sets  # noqa: F401  (the module fixture)
from upsnet_tpu.config import load_config as jax_load_config
from upsnet_tpu.convert.finetune import remap_coco_params_to_cityscapes
from upsnet_tpu.models.registry import get_model as jax_get_model
from upsnet_tpu.train.checkpoints import save_checkpoint as jax_save_checkpoint
from upsnet_tpu.train.optimizer import lr_schedule as jax_lr_schedule
from upsnet_tpu.utils.dcn_probe import SaturationWatch as JaxSaturationWatch
from upsnet_torch.config import load_config
from upsnet_torch.convert.from_jax import to_jax
from upsnet_torch.data.pipeline import make_loader
from upsnet_torch.data.synthetic import SyntheticDataset, scene
from upsnet_torch.models import get_model
from upsnet_torch.tools import test as test_cli
from upsnet_torch.tools import train as train_cli
from upsnet_torch.train.checkpoints import (
    CheckpointMismatch,
    read_state_dict,
    restore_checkpoint,
    write_checkpoint,
)
from upsnet_torch.train.optimizer import make_optimizer, update_count
from upsnet_torch.train.trainer import load_pretrained_any, train

torch.set_num_threads(2)

LOSS_KEYS = ("rpn_cls", "rpn_bbox", "cls", "bbox", "mask", "seg", "pano", "total")
LR_REL = 1e-7


class TwoBucketSynthetic(SyntheticDataset):
    """``SyntheticDataset`` with the odd scenes drawn portrait, so that the
    samples fill both buckets."""

    def _scene(self, i: int):
        hw = self.image_hw if i % 2 == 0 else self.image_hw[::-1]
        img, boxes, classes, masks, seg = scene(
            np.random.RandomState(self.seed * 1000 + i), hw, self.num_things, self.num_stuff)
        return img, {"boxes": boxes, "classes": classes, "masks": masks, "seg": seg}


def _cfg(sets, out, **train_fields):  # noqa: F811
    cfg = load_config(sets["coco_yaml"]).replace(output_path=str(out))
    return cfg.replace(train=dataclasses.replace(cfg.train, **train_fields))


def _dataset(cfg):
    return TwoBucketSynthetic(cfg, num_images=6, image_hw=(100, 150), training=True)


def _run(cfg, **kw):
    """``train`` on the CPU; returns (model, history, [(it, lr, losses)])."""
    steps = []
    model, history = train(cfg, _dataset(cfg), device="cpu",
                           on_step=lambda it, m: steps.append((it, m["lr"], m)), **kw)
    return model, history, steps


def _ckpt_dir(cfg):
    return os.path.join(cfg.output_path, cfg.symbol, "checkpoints")


@pytest.fixture(scope="module")
def run_a(sets, tmp_path_factory):  # noqa: F811
    """10 steps from scratch: snapshot_step 4, display_iter 3."""
    cfg = _cfg(sets, tmp_path_factory.mktemp("a"))
    return cfg, *_run(cfg)


def _jax_lrs(sets, counts) -> list:  # noqa: F811
    sched = jax_lr_schedule(jax_load_config(sets["coco_yaml"]))
    return [float(sched(jnp.asarray(c, jnp.int32))) for c in counts]


def _assert_lrs(steps, ref):
    got = [lr for _, lr, _ in steps]
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert abs(g - r) <= LR_REL * abs(r), (got, ref)


def test_snapshots_and_metrics_follow_the_jax_rule(run_a):
    cfg, _, history, steps = run_a
    assert sorted(os.listdir(_ckpt_dir(cfg))) == [f"step_{i:08d}" for i in (4, 8, 10)]
    for it in (4, 8, 10):
        assert torch.load(os.path.join(_ckpt_dir(cfg), f"step_{it:08d}"),
                          weights_only=True)["iteration"] == it
    with open(os.path.join(cfg.output_path, cfg.symbol, "metrics.jsonl")) as f:
        lines = [json.loads(x) for x in f]
    assert [e["iter"] for e in lines] == [3, 6, 9, 10] == [e["iter"] for e in history]
    watch_fields, _ = JaxSaturationWatch(8, "pallas", "damped", "warn").update(
        {"fcn/dcn": {"max_dy": 1.0, "max_dx": 1.0, "sat_frac": 0.0}})
    jax_fields = {*LOSS_KEYS, "iter", "images_per_sec", "step_s", "loader_wait_s",
                  "platform", *watch_fields}
    assert all(set(e) == jax_fields for e in lines), [set(e) ^ jax_fields for e in lines]
    assert [it for it, _, _ in steps] == list(range(1, 11))
    assert all(math.isfinite(m[k]) for _, _, m in steps for k in LOSS_KEYS)


def test_lr_follows_the_update_count_over_both_buckets(run_a, sets):  # noqa: F811
    cfg, _, _, steps = run_a
    _assert_lrs(steps, _jax_lrs(sets, range(10)))
    assert len({lr for _, lr, _ in steps}) >= 4  # warmup and decay both show
    loader = iter(make_loader(_dataset(cfg), cfg.train.batch_size, seed=cfg.seed))
    shapes = [next(loader)["images"].shape[1:3] for _ in range(10)]
    assert set(shapes) == {(128, 192), (192, 128)}


def test_begin_iteration_moves_the_iteration_not_the_schedule(sets, tmp_path):  # noqa: F811
    cfg = _cfg(sets, tmp_path, begin_iteration=3)
    _, history, steps = _run(cfg, max_steps=6)
    assert [it for it, _, _ in steps] == [4, 5, 6] and [e["iter"] for e in history] == [6]
    _assert_lrs(steps, _jax_lrs(sets, range(3)))
    assert sorted(os.listdir(_ckpt_dir(cfg))) == ["step_00000004", "step_00000006"]


def _resumable(cfg, run_a_cfg, step: int):
    """``cfg`` with resume on and run A's snapshot ``step`` alone in its
    checkpoint directory."""
    os.makedirs(_ckpt_dir(cfg))
    shutil.copy(os.path.join(_ckpt_dir(run_a_cfg), f"step_{step:08d}"), _ckpt_dir(cfg))
    return cfg.replace(train=dataclasses.replace(cfg.train, resume=True))


def _assert_state_equal(got, ref, what: str):
    """Nested state (dicts, lists, tensors, numbers) equal bit for bit."""
    if isinstance(ref, torch.Tensor):
        assert torch.equal(got, ref), what
    elif isinstance(ref, dict):
        assert got.keys() == ref.keys(), what
        for k in ref:
            _assert_state_equal(got[k], ref[k], f"{what} {k}")
    elif isinstance(ref, (list, tuple)):
        assert len(got) == len(ref), what
        for i, (g, r) in enumerate(zip(got, ref)):
            _assert_state_equal(g, r, f"{what}[{i}]")
    else:
        assert got == ref, f"{what}: {got} != {ref}"


def test_resume_restores_weights_momentum_and_count(run_a, sets, tmp_path):  # noqa: F811
    cfg = _resumable(_cfg(sets, tmp_path), run_a[0], 4)
    model = get_model(cfg.symbol, cfg, device="cpu", generator=torch.Generator().manual_seed(9))
    optimizer = make_optimizer(cfg, model)
    _, history, steps = _run(cfg, max_steps=4, model=model, optimizer=optimizer)
    assert history == [] and steps == []
    saved = torch.load(os.path.join(_ckpt_dir(cfg), "step_00000004"), weights_only=True)
    _assert_state_equal(model.state_dict(), saved["state_dict"], "weights")
    _assert_state_equal(optimizer.state_dict(), saved["optimizer"], "optimizer")
    assert update_count(optimizer) == 4
    assert len(optimizer.state_dict()["state"]) == sum(
        p.requires_grad for p in model.parameters())  # every momentum buffer


def test_resumed_run_equals_a_fresh_run_from_its_snapshot(run_a, sets, tmp_path):  # noqa: F811
    resumed_cfg = _resumable(_cfg(sets, tmp_path / "resumed"), run_a[0], 4)
    resumed, _, resumed_steps = _run(resumed_cfg, max_steps=8)
    _assert_lrs(resumed_steps, _jax_lrs(sets, range(4, 8)))

    fresh_cfg = _cfg(sets, tmp_path / "fresh", begin_iteration=4)
    model = get_model(fresh_cfg.symbol, fresh_cfg, device="cpu")
    optimizer = make_optimizer(fresh_cfg, model)
    restore_checkpoint(os.path.join(_ckpt_dir(run_a[0]), "step_00000004"), model, optimizer)
    fresh, _, fresh_steps = _run(fresh_cfg, max_steps=8, model=model, optimizer=optimizer)

    assert [it for it, _, _ in resumed_steps] == [it for it, _, _ in fresh_steps] == [5, 6, 7, 8]
    for (_, lr_a, a), (_, lr_b, b) in zip(resumed_steps, fresh_steps):
        assert lr_a == lr_b and a == b
    _assert_state_equal(resumed.state_dict(), fresh.state_dict(), "weights after 8")
    for name in ("step_00000008",):
        _assert_state_equal(read_state_dict(os.path.join(_ckpt_dir(resumed_cfg), name)),
                            read_state_dict(os.path.join(_ckpt_dir(fresh_cfg), name)), name)
    # the stream replays from position 0, so this is not run A's steps 5-8
    assert [m for _, _, m in resumed_steps] != [m for _, _, m in run_a[3][4:8]]


def _jax_template(yaml: str) -> dict:
    """The JAX parameter tree of ``yaml``'s model, as zeros of its shapes."""
    jcfg = jax_load_config(yaml)
    model = jax_get_model(jcfg.symbol, jcfg)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1,) + tuple(jcfg.train.image_buckets[0]) + (3,)))
    return jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes["params"])


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, np.asarray(tree)


def test_load_pretrained_any(run_a, sets, tmp_path):  # noqa: F811
    cfg = run_a[0]
    log = logging.getLogger("test")
    model = get_model(cfg.symbol, cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    load_pretrained_any(os.path.join(_ckpt_dir(cfg), "latest"), model, log)
    _assert_state_equal(model.state_dict(),
                        read_state_dict(os.path.join(_ckpt_dir(cfg), "step_00000010")), "latest")
    step4 = os.path.join(_ckpt_dir(cfg), "step_00000004")
    load_pretrained_any(step4, model, log)
    _assert_state_equal(model.state_dict(), read_state_dict(step4), "exact")

    # a COCO snapshot into the Cityscapes model: the remap, held against JAX's
    city_cfg = load_config(sets["city_yaml"])
    city = get_model(city_cfg.symbol, city_cfg, device="cpu")
    city_init = {k: v.clone() for k, v in city.state_dict().items()}
    load_pretrained_any(step4, city, log)
    coco_t, city_t = _jax_template(sets["coco_yaml"]), _jax_template(sets["city_yaml"])
    ref = remap_coco_params_to_cityscapes(to_jax(read_state_dict(step4), coco_t),
                                          to_jax(city_init, city_t))
    got = dict(_leaves(to_jax(city.state_dict(), city_t)))
    for path, leaf in _leaves(ref):
        np.testing.assert_array_equal(got[path], leaf, err_msg=".".join(path))
    coco_sd = read_state_dict(step4)
    w = city.state_dict()["box_head.cls_score.weight"]
    assert torch.equal(w[4], coco_sd["box_head.cls_score.weight"][8])  # truck <- coco 8
    assert torch.equal(city.state_dict()["box_head.bbox_pred.weight"][16:20],
                       coco_sd["box_head.bbox_pred.weight"][32:36])  # 4 rows a class
    assert not torch.equal(w, city_init["box_head.cls_score.weight"])

    # other differences, a reference .pth and a JAX snapshot are refused by name
    short = dict(read_state_dict(step4))
    short.pop("fpn.lateral2.weight")
    with pytest.raises(CheckpointMismatch, match="fpn.lateral2.weight"):
        load_pretrained_any(write_checkpoint(str(tmp_path / "short"), 1, short), model, log)
    not_tensors = tmp_path / "upsnet_coco.pth"  # a .pth now goes through the converter,
    torch.save({"state_dict": {"w": torch.zeros(2)}, "fn": logging.getLogger}, not_tensors)
    with pytest.raises(ValueError, match="weights_only"):  # which reads tensors only
        load_pretrained_any(str(not_tensors), model, log)
    orbax = jax_save_checkpoint(str(tmp_path / "orbax"), 3, {"w": np.zeros(2, np.float32)},
                                {"m": np.zeros(2, np.float32)})
    for path in (orbax, str(tmp_path / "orbax" / "latest")):
        with pytest.raises(ValueError, match="Orbax.*from_jax.py"):
            load_pretrained_any(path, model, log)


def test_train_and_test_entries_run_on_the_cpu(sets, tmp_path):  # noqa: F811
    yaml = sets["coco_yaml"]
    model, history = train_cli.run(["--cfg", yaml, "--device", "cpu", "--max-steps", "2"])
    cfg = load_config(yaml)
    out = os.path.join(cfg.output_path, cfg.symbol)
    assert os.path.exists(os.path.join(out, os.path.basename(yaml)))  # the cfg copied
    assert [e["iter"] for e in history] == [2]
    ckpt = os.path.join(out, "checkpoints", "step_00000002")
    results, timings = test_cli.run(["--cfg", yaml, "--device", "cpu", "--weights", ckpt,
                                     "--dataset-override", "coco", "--max-images", "3"])
    assert set(results) == {"boxes", "masks", "ssegs", "panoptic"} and timings["images"] == 3
    assert math.isfinite(results["panoptic"]["All"]["pq"])
    results, timings = test_cli.run(["--cfg", sets["city_yaml"], "--device", "cpu",
                                     "--dataset-override", "cityscapes", "--no-artifacts"])
    assert set(results) == {"boxes", "masks", "ssegs", "panoptic"} and timings["images"] == 2
    assert set(results["masks"]) == {"allAp", "allAp50%", "classes"}


def test_train_entry_refuses_a_missing_card(sets, monkeypatch):  # noqa: F811
    assert train_cli.parse_args(["--cfg", "x"]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.run(["--cfg", sets["coco_yaml"]])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(load_config(sets["coco_yaml"]), None)


def test_profiling_trace_and_timed(tmp_path):
    """``trace`` writes a Chrome trace of its region, and nothing without a
    directory."""
    from upsnet_torch.utils.profiling import trace

    with trace(str(tmp_path / "prof")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())["traceEvents"]
    assert any("aten::mm" in e.get("name", "") for e in events)
    with trace(None):
        pass
