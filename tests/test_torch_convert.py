"""The port's reference ``.pth`` converter (``upsnet_torch/convert/
upsnet_names.py``, ``convert/torch_converter.py``) and its report tool
(``upsnet_torch/tools/convert_report.py``) against the JAX package's.

No released checkpoint is in the tree, so the sources are built here with
numpy from a seed: an UPSNet-named state dict (the JAX converter test's
``_synthetic_upsnet_state``: ``resnet_backbone.*``, ``fpn.fpn_p*``,
``rpn.*``, ``rcnn.fc6`` over (C, P, P)-flattened features, ``mask_branch.*``,
``fcn_head.fcn_subnet.conv.*`` with its offset convs, backbone DCN in
res3-res5, BatchNorm with running statistics) and a torchvision ResNet-50
one, each written with ``torch.save`` under ``tmp_path``. Each goes through
the JAX ``load_pretrained`` into a parameter tree, then
``jax_params_to_state_dict``, and through the port's ``load_pretrained``
into the port model: every tensor equal, bit for bit (fc1 permuted, BN
folded in the same float32 order). A missing and a leftover key each raise
``ConversionError`` naming it, and the two report tools count the same
units, missing, leftover and shape errors.
"""

import dataclasses
import importlib.util
import logging
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from test_upsnet_convert import _micro_cfg, _synthetic_upsnet_state
from upsnet_tpu.config import default_config as jax_default_config
from upsnet_tpu.convert.torch_converter import load_pretrained as jax_load_pretrained
from upsnet_tpu.convert.upsnet_names import build_specs as jax_build_specs
from upsnet_tpu.convert.upsnet_names import convert_upsnet_state as jax_convert
from upsnet_tpu.models.upsnet import build_model as jax_build_model
from upsnet_torch.config import default_config
from upsnet_torch.convert.from_jax import jax_params_to_state_dict, load_jax_params
from upsnet_torch.convert.torch_converter import load_pretrained, load_torch_state
from upsnet_torch.convert.upsnet_names import (
    ConversionError,
    build_specs,
    convert_upsnet_state,
    looks_like_upsnet,
)
from upsnet_torch.models import upsnet as tup
from upsnet_torch.tools import convert_report
from upsnet_torch.train.trainer import load_pretrained_any

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
MICRO = {"num_classes": 5, "num_seg_classes": 7, "num_stuff": 3}
MICRO_NET = {"backbone": "resnet_test", "backbone_with_dcn": True, "dcn_stages": [3, 4, 5],
             "dcn_impl": "gather", "norm": "frozen_bn", "fpn_feature_dim": 32,
             "rcnn_fc_dim": 64, "fcn_head_dim": 16, "compute_dtype": "float32"}


def _port_cfg(**net):
    cfg = default_config()
    return cfg.replace(dataset=dataclasses.replace(cfg.dataset, **MICRO),
                       network=dataclasses.replace(cfg.network, **{**MICRO_NET, **net}))


def _zeros_params(jcfg, hw=(64, 64)):
    """The JAX parameter tree of ``jcfg`` as zeros (shapes from
    ``eval_shape``: no init runs)."""
    model = jax_build_model(jcfg)
    shapes = jax.eval_shape(lambda k: model.init(k, jnp.zeros((1,) + hw + (3,))),
                            jax.random.PRNGKey(0))["params"]
    return jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)


@pytest.fixture(scope="module")
def upsnet_pth(tmp_path_factory):
    """(the micro config's JAX init tree, the seeded UPSNet-named state dict,
    its .pth path)."""
    jcfg = _micro_cfg(with_dcn=True)
    params = _zeros_params(jcfg)
    state = _synthetic_upsnet_state(params, np.random.RandomState(3))
    path = tmp_path_factory.mktemp("pth") / "upsnet_micro.pth"
    torch.save({"state_dict": {f"module.{k}": torch.as_tensor(v) for k, v in state.items()}},
               path)
    return params, state, str(path)


def _assert_states_equal(got: dict, ref: dict):
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == torch.float32, k
        assert torch.equal(got[k], ref[k].to(got[k].dtype)), k


def test_upsnet_state_converts_as_the_jax_map(upsnet_pth):
    params, state, path = upsnet_pth
    model = tup.build_model(_port_cfg(), device="cpu")
    assert len(build_specs(model.state_dict())) == len(jax_build_specs(params))
    ref_tree, ref_report = jax_convert(state, params, strict=True)
    got, report = convert_upsnet_state(state, model.state_dict(), strict=True)
    assert {k: sorted(v) for k, v in report.items()} == {k: sorted(v)
                                                         for k, v in ref_report.items()}
    assert report["defaulted"] and not (report["missing"] or report["leftover"])
    _assert_states_equal(got, jax_params_to_state_dict(ref_tree))

    # through the files: the JAX load_pretrained and the port's (module. stripped)
    assert looks_like_upsnet(load_torch_state(path))
    load_pretrained(path, model)
    _assert_states_equal(model.state_dict(),
                         jax_params_to_state_dict(jax_load_pretrained(path, params)))
    # fc1: the reference flattens (C, P, P), the port (P, P, C)
    w = state["rcnn.fc6.weight"]
    c = w.shape[1] // 49
    np.testing.assert_array_equal(
        model.state_dict()["box_head.fc1.weight"].numpy(),
        w.reshape(-1, c, 7, 7).transpose(0, 2, 3, 1).reshape(w.shape[0], -1))


def test_network_pretrained_pth_loads_through_the_converter(upsnet_pth):
    params, _, path = upsnet_pth
    model = tup.build_model(_port_cfg(), device="cpu")
    load_pretrained_any(path, model, logging.getLogger("test"))
    _assert_states_equal(model.state_dict(),
                         jax_params_to_state_dict(jax_load_pretrained(path, params)))


@pytest.mark.parametrize("case", ["missing", "leftover"])
def test_conversion_is_strict_both_ways(upsnet_pth, case):
    _, state, _ = upsnet_pth
    state = dict(state)
    if case == "missing":
        del state["rcnn.fc7.weight"], state["rcnn.fc7.bias"]
        name = "box_head.fc2"
    else:
        state["panoptic_extra.mystery.weight"] = np.zeros((3, 3), np.float32)
        name = "panoptic_extra.mystery.weight"
    target = tup.build_model(_port_cfg(), device="cpu").state_dict()
    with pytest.raises(ConversionError, match=name):
        convert_upsnet_state(state, target, strict=True)
    _, report = convert_upsnet_state(state, target, strict=False)
    assert any(name in m for m in report[case])


def _torchvision_state(rng):
    """A seeded torchvision ResNet-50 state dict (names and shapes)."""
    st = {"conv1.weight": rng.randn(64, 3, 7, 7)}

    def bn(prefix, c):
        st[f"{prefix}.weight"] = rng.rand(c) + 0.5
        st[f"{prefix}.bias"] = rng.randn(c)
        st[f"{prefix}.running_mean"] = rng.randn(c)
        st[f"{prefix}.running_var"] = rng.rand(c) + 0.5

    bn("bn1", 64)
    cin = 64
    for li, (n, width) in enumerate(zip((3, 4, 6, 3), (64, 128, 256, 512)), start=1):
        for b in range(n):
            p = f"layer{li}.{b}"
            st[f"{p}.conv1.weight"] = rng.randn(width, cin, 1, 1)
            st[f"{p}.conv2.weight"] = rng.randn(width, width, 3, 3)
            st[f"{p}.conv3.weight"] = rng.randn(width * 4, width, 1, 1)
            for ci, c in ((1, width), (2, width), (3, width * 4)):
                bn(f"{p}.bn{ci}", c)
            if b == 0:
                st[f"{p}.downsample.0.weight"] = rng.randn(width * 4, cin, 1, 1)
                bn(f"{p}.downsample.1", width * 4)
            cin = width * 4
    st["fc.weight"] = rng.randn(1000, 2048)
    return {k: v.astype(np.float32) for k, v in st.items()}


def test_torchvision_backbone_loads_as_the_jax_converter(tmp_path):
    jcfg = jax_default_config()
    jcfg = jcfg.replace(dataset=dataclasses.replace(jcfg.dataset, **MICRO),
                        network=dataclasses.replace(jcfg.network, **{
                            **MICRO_NET, "backbone": "resnet50", "backbone_with_dcn": False}))
    params = _zeros_params(jcfg)
    state = _torchvision_state(np.random.RandomState(4))
    path = tmp_path / "resnet50.pth"
    torch.save({k: torch.from_numpy(v) for k, v in state.items()}, path)
    model = tup.build_model(_port_cfg(backbone="resnet50", backbone_with_dcn=False),
                            device="cpu")
    load_jax_params(model, params)
    load_pretrained(str(path), model)
    ref = jax_params_to_state_dict(jax_load_pretrained(str(path), params))
    _assert_states_equal(model.state_dict(), ref)
    assert model.state_dict()["backbone_net.res5_2.bn3.scale"].abs().sum() > 0
    assert model.state_dict()["fpn.lateral2.weight"].abs().sum() == 0  # heads keep their init


def _jax_report_main():
    spec = importlib.util.spec_from_file_location("jax_convert_report",
                                                  ROOT / "tools" / "convert_report.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


def _counts(text: str) -> dict:
    lines = text.splitlines()
    loaded = next(int(x.split(":")[1]) for x in lines if x.startswith("loaded units"))
    return {"loaded": loaded, **{k: sum(x.strip().startswith(k) for x in lines)
                                 for k in ("MISSING", "LEFTOVER", "SHAPE", "DEFAULTED")},
            "clean": "CLEAN" in lines[-1] and "NOT" not in lines[-1]}


def test_report_tool_counts_as_the_jax_tool(upsnet_pth, tmp_path, capsys, monkeypatch):
    _, state, _ = upsnet_pth
    state = dict(state)
    del state["rpn.bbox_pred.weight"], state["rpn.bbox_pred.bias"]
    state["rcnn.extra.weight"] = np.zeros(2, np.float32)
    state["rpn.cls_score.weight"] = np.zeros((12, 32, 1, 1), np.float32)
    pth = tmp_path / "bad.pth"
    torch.save({k: torch.as_tensor(v) for k, v in state.items()}, pth)
    cfg_path = tmp_path / "micro.yaml"
    cfg_path.write_text(yaml.safe_dump({"symbol": "upsnet", "dataset": MICRO,
                                        "network": MICRO_NET,
                                        "train": {"image_buckets": [[64, 64]]}}))
    args = ["--pth", str(pth), "--cfg", str(cfg_path)]
    assert convert_report.main(args) == 2
    got = _counts(capsys.readouterr().out)
    monkeypatch.setattr(sys, "argv", ["convert_report.py", *args])
    assert _jax_report_main()() == 2
    ref = _counts(capsys.readouterr().out)
    assert got == ref
    assert got["MISSING"] == 1 and got["LEFTOVER"] == 1 and got["SHAPE"] == 1
