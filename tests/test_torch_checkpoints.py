"""The port's checkpoints (``upsnet_torch/train/checkpoints.py``): the
reference's ``torch.save({state_dict, optimizer, iteration})`` format,
latest-snapshot lookup, full and partial restore, and the named key diff of
``CheckpointMismatch``. Every comparison is bit for bit."""

import dataclasses

import pytest
import torch

from upsnet_torch.config import load_config
from upsnet_torch.data.synthetic import synthetic_batch
from upsnet_torch.evaluation.inference import bucket_anchors
from upsnet_torch.models import get_model
from upsnet_torch.models.upsnet import forward_predict
from upsnet_torch.train.checkpoints import (
    CheckpointMismatch,
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
    write_checkpoint,
)
from upsnet_torch.train.optimizer import make_optimizer
from upsnet_torch.train.step import make_train_step

torch.set_num_threads(2)

TINY_YAML = "experiments/upsnet_tiny_synthetic.yaml"
BUCKET = (128, 160)


@pytest.fixture(scope="module")
def trained():
    """The tiny model and its optimizer after two SGD steps, so that the
    optimizer holds momentum buffers."""
    cfg = load_config(TINY_YAML)
    model = get_model(cfg.symbol, cfg, device="cpu")
    optimizer = make_optimizer(cfg, model)
    anchors = bucket_anchors(cfg, BUCKET, "cpu")
    step = make_train_step(model.train(), cfg, anchors, optimizer,
                           generator=torch.Generator().manual_seed(0))
    batch = {k: torch.as_tensor(v) for k, v in synthetic_batch(cfg, BUCKET, 2, seed=1).items()}
    for _ in range(2):
        step(batch)
    return cfg, model.eval(), optimizer, anchors


def _fresh(cfg, seed=99):
    """Another draw of the same model, so a restore must change every weight."""
    cfg = cfg.replace(seed=seed)
    model = get_model(cfg.symbol, cfg, device="cpu")
    return model, make_optimizer(cfg, model)


def _assert_state_equal(got: dict, ref: dict):
    assert got.keys() == ref.keys()
    for k, v in ref.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(got[k], v) and got[k].dtype == v.dtype, k
        elif isinstance(v, dict):
            _assert_state_equal(got[k], v)
        else:
            assert got[k] == v, k


def test_save_latest_restore_round_trip(trained, tmp_path):
    cfg, model, optimizer, _ = trained
    assert latest_checkpoint(str(tmp_path / "none")) is None
    first = save_checkpoint(str(tmp_path), 5, model, optimizer)
    path = save_checkpoint(str(tmp_path), 12, model, optimizer)
    (tmp_path / "step_00000099.tmp").write_bytes(b"")  # a write cut short
    assert first.endswith("step_00000005") and path.endswith("step_00000012")
    assert latest_checkpoint(str(tmp_path)) == path
    saved = torch.load(path, weights_only=True)
    assert set(saved) == {"state_dict", "optimizer", "iteration"}
    assert saved["iteration"] == 12

    model2, optimizer2 = _fresh(cfg)
    assert not torch.equal(model2.fpn.lateral2.weight, model.fpn.lateral2.weight)
    assert restore_checkpoint(path, model2, optimizer2) == 12
    _assert_state_equal(model2.state_dict(), model.state_dict())
    ref, got = optimizer.state_dict(), optimizer2.state_dict()
    assert ref["state"] and len(got["state"]) == len(ref["state"])
    _assert_state_equal(got["state"], ref["state"])
    assert got["param_groups"] == ref["param_groups"]


def test_partial_restore_takes_the_weights_alone(trained, tmp_path):
    cfg, model, optimizer, _ = trained
    path = save_checkpoint(str(tmp_path), 3, model, optimizer)
    model2, optimizer2 = _fresh(cfg)
    with pytest.raises(ValueError, match="partial=True"):
        restore_checkpoint(path, model2)
    assert restore_checkpoint(path, model2, partial=True) == 3
    _assert_state_equal(model2.state_dict(), model.state_dict())
    assert not optimizer2.state_dict()["state"]  # untouched

    weights_only = save_checkpoint(str(tmp_path / "w"), 4, model)
    with pytest.raises(CheckpointMismatch, match="missing from checkpoint: optimizer"):
        restore_checkpoint(weights_only, model2, optimizer2)
    assert restore_checkpoint(weights_only, model2, partial=True) == 4


def test_mismatch_names_the_differing_keys(trained, tmp_path):
    cfg, model, _, _ = trained
    sd = dict(model.state_dict())
    sd.pop("rpn.conv.bias")
    sd["stray.weight"] = torch.zeros(2)
    path = write_checkpoint(str(tmp_path), 1, sd)
    with pytest.raises(CheckpointMismatch) as err:
        restore_checkpoint(path, model, partial=True)
    msg = str(err.value)
    assert "missing from checkpoint: rpn.conv.bias (32,)" in msg
    assert "unexpected in checkpoint: stray.weight (2,)" in msg
    assert "2 differences" in msg

    wider = cfg.replace(dataset=dataclasses.replace(cfg.dataset, num_classes=7))
    other = get_model(wider.symbol, wider, device="cpu")
    with pytest.raises(CheckpointMismatch) as err:
        restore_checkpoint(save_checkpoint(str(tmp_path / "w"), 1, model), other, partial=True)
    assert "shape mismatch at box_head.cls_score.weight: checkpoint (5, 64) vs model (7, 64)" \
        in str(err.value)


def test_restored_model_predicts_the_same_bits(trained, tmp_path):
    cfg, model, _, anchors = trained
    path = save_checkpoint(str(tmp_path), 2, model)
    model2, _ = _fresh(cfg)
    restore_checkpoint(path, model2, partial=True)
    g = torch.Generator().manual_seed(4)
    batch = {"images": torch.empty((1, *BUCKET, 3)).uniform_(-100, 100, generator=g),
             "im_hw": torch.tensor([[128.0, 150.0]])}
    ref = forward_predict(model, cfg, anchors, batch)
    got = forward_predict(model2.eval(), cfg, anchors, batch)
    for k, v in ref.items():
        assert torch.equal(got[k], v), k
