"""The port's YAML loader against the JAX package's, and every shipped
experiment built by the port.

- ``load_config`` on each file of ``experiments/``: the same ``to_dict()``
  as the JAX loader's;
- ``update_config`` on the reference's key schema (``gpus`` as a device
  list, the aliases, the dropped keys, unknown keys ignored), against the
  JAX function;
- ``build_model(cfg, device="cpu")`` on each file at tiny widths
  (``resnet_test`` depth, narrow heads): ``DeformConv`` at
  ``res{3,4,5}_*.conv2`` exactly where ``backbone_with_dcn`` and
  ``dcn_stages`` say, ``GroupNorm`` exactly where ``norm: gn`` says, and a
  ``norm`` or ``roi_align_impl`` the port does not know refused by name.
"""

import dataclasses
import pathlib

import pytest
import torch

from upsnet_tpu.config import load_config as jax_load_config
from upsnet_tpu.config import update_config as jax_update_config
from upsnet_tpu.config.defaults import default_config as jax_default_config
from upsnet_torch.config import default_config, load_config, update_config
from upsnet_torch.models import layers
from upsnet_torch.models.upsnet import ROI_ALIGN_IMPLS, build_model

torch.set_num_threads(2)

EXPERIMENTS = sorted((pathlib.Path(__file__).resolve().parents[1] / "experiments").glob("*.yaml"))


def test_all_nine_experiments_are_found():
    assert len(EXPERIMENTS) == 9


@pytest.mark.parametrize("path", EXPERIMENTS, ids=[p.stem for p in EXPERIMENTS])
def test_load_config_matches_jax(path):
    got = load_config(str(path)).to_dict()
    assert got == jax_load_config(str(path)).to_dict()
    assert got != default_config().to_dict()


REFERENCE_OVERRIDES = {
    "device_list": {"gpus": "0,1,2,3"},
    "aliases": {"train": {"warmup_iters": 250}, "test": {"max_per_image": 50}},
    "dropped": {"network": {"image_stride": 32, "pixel_means": [102.9, 115.9, 122.7]}},
    "unknown": {"mystery": 1, "network": {"no_such_field": True},
                "train": {"scales": [640, 800], "lr": "0.01"}},
}


@pytest.mark.parametrize("what", list(REFERENCE_OVERRIDES))
def test_update_config_reads_the_reference_schema(what):
    overrides = REFERENCE_OVERRIDES[what]
    got = update_config(default_config(), overrides)
    assert got.to_dict() == jax_update_config(jax_default_config(), overrides).to_dict()
    if what == "device_list":
        assert got.num_devices == 4
    elif what == "aliases":
        assert got.train.warmup_iteration == 250 and got.test.max_det == 50
    elif what == "dropped":
        assert got == default_config()
    else:
        assert got.train.scales == (640, 800) and got.train.lr == 0.01


def tiny_widths(cfg):
    """The experiment at test widths: resnet_test depth, narrow heads, its
    norm, DCN and every other setting kept."""
    return cfg.replace(network=dataclasses.replace(
        cfg.network, backbone="resnet_test", fpn_feature_dim=32, rcnn_fc_dim=64,
        fcn_head_dim=16))


@pytest.mark.parametrize("path", EXPERIMENTS, ids=[p.stem for p in EXPERIMENTS])
def test_every_shipped_experiment_builds(path):
    cfg = load_config(str(path))
    net = cfg.network
    model = build_model(tiny_widths(cfg), device="cpu")
    trunk = dict(model.backbone_net.named_modules())
    dcn = {n for n, m in trunk.items() if isinstance(m, layers.DeformConv)}
    want = {f"res{s}_0.conv2" for s in net.dcn_stages} if net.backbone_with_dcn else set()
    assert dcn == want
    for name in dcn:
        assert trunk[name].bias is None and trunk[name].impl == net.dcn_impl
        assert trunk[name].impl_train == (net.dcn_impl_train or net.dcn_impl)
    norms = [m for n, m in trunk.items() if n.endswith(("bn1", "bn2", "bn3", "shortcut_bn"))]
    kind = layers.GroupNorm if net.norm == "gn" else layers.FrozenBatchNorm
    assert len(norms) == 1 + 4 * 4 and all(type(m) is kind for m in norms)
    assert not any(isinstance(m, layers.GroupNorm) for m in model.modules()
                   if m not in norms)


@pytest.mark.parametrize("field", ["norm", "roi_align_impl"])
def test_build_model_refuses_an_unknown_setting_by_name(field):
    cfg = tiny_widths(default_config())
    bad = cfg.replace(network=dataclasses.replace(cfg.network, **{field: "batch_norm"}))
    with pytest.raises(ValueError, match=f"network.{field}='batch_norm'"):
        build_model(bad, device="cpu")
    known = layers.NORMS if field == "norm" else ROI_ALIGN_IMPLS
    for value in known:
        build_model(cfg.replace(network=dataclasses.replace(cfg.network, **{field: value})),
                    device="cpu")
