"""The port's folded frozen-BN init (``upsnet_torch/tools/make_synth_pretrained.py``)
against the JAX package's ``tools/make_synth_pretrained.py``.

One ``fold_once`` pass of the port must refold every ``FrozenBatchNorm`` as
the JAX tool's ``_fold_once`` does, on the same weights (a tiny frozen-BN
model's JAX init, bridged with ``jax_params_to_state_dict``) and the same
calibration batch: scale and bias within 1e-4 relative (float32 statistics
over the same values, summed in another order), and the same worst |mean| and
|std - 1|. A dead channel (constant under the batch) keeps its affine. The
tool itself must converge within its 0.1 gate, refuse ``norm: gn`` by name,
and write a snapshot that ``load_pretrained_any`` loads as an exact match
from the experiment file's relative ``network.pretrained``.
"""

import importlib.util
import logging
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_predict import H, W, tiny
from upsnet_tpu.config import default_config as jax_default_config
from upsnet_tpu.models import upsnet as jup
from upsnet_tpu.models.layers import FrozenBatchNorm as JaxFrozenBatchNorm
from upsnet_torch.config import default_config, load_config
from upsnet_torch.convert.from_jax import jax_params_to_state_dict, load_jax_params
from upsnet_torch.models import get_model
from upsnet_torch.models import upsnet as tup
from upsnet_torch.models.layers import FrozenBatchNorm
from upsnet_torch.tools import make_synth_pretrained as tool
from upsnet_torch.train.trainer import load_pretrained_any

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
TINY_FROZEN_BN_YAML = """\
symbol: upsnet
output_path: output/tiny_frozenbn
dataset:
  dataset: coco
  num_classes: 5
  num_seg_classes: 7
  num_stuff: 3
network:
  backbone: resnet_test
  norm: {norm}
  pretrained: model/tiny_frozenbn/step_00000000
  fpn_feature_dim: 32
  rcnn_fc_dim: 64
  fcn_head_dim: 16
  compute_dtype: float32
"""


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "root_make_synth_pretrained", ROOT / "tools" / "make_synth_pretrained.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bn_affines(model) -> dict:
    return {f"{n}.{k}": getattr(m, k).clone() for n, m in model.named_modules()
            if isinstance(m, FrozenBatchNorm) for k in ("scale", "bias")}


@pytest.fixture(scope="module")
def models():
    """The tiny frozen-BN model's JAX init, its stem's channel 3 dead (zero
    conv weights: a constant BN input), in both packages."""
    jcfg, tcfg = tiny(jax_default_config()), tiny(default_config())
    assert jcfg.network.norm == tcfg.network.norm == "frozen_bn"
    jm = jup.build_model(jcfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)))["params"]
    params = jax.tree.map(np.array, params)
    params["backbone_net"]["conv1"]["kernel"][..., 3] = 0.0
    tm = tup.build_model(tcfg, device="cpu")
    load_jax_params(tm, params)
    return jm, params, tm


def test_one_pass_matches_the_jax_fold(models):
    jm, params, tm = models
    x = tool.calibration_images(0, H, W)
    new, jmu, jsd = _jax_tool()._fold_once(jm, params, jnp.asarray(x), JaxFrozenBatchNorm)
    bridged = jax_params_to_state_dict(jax.tree.map(np.asarray, new))
    before = _bn_affines(tm)
    mu, sd = tool.fold_once(tm, torch.from_numpy(x))
    got = _bn_affines(tm)
    assert got.keys() <= bridged.keys() and len(got) > 10
    ref = {k: bridged[k] for k in got}
    unfolded = jax_params_to_state_dict(params)  # the JAX pass leaves all else as it was
    assert all(torch.equal(v, unfolded[k]) for k, v in bridged.items() if k not in got)
    moved = 0
    for k, r in ref.items():
        np.testing.assert_allclose(got[k].numpy(), r.numpy(), rtol=1e-4,
                                   atol=1e-4 * float(r.abs().max()), err_msg=k)
        moved += not torch.equal(got[k], before[k])
    assert moved == len(ref)
    np.testing.assert_allclose([mu, sd], [jmu, jsd], rtol=1e-4)
    assert mu > 1.0  # identity affines at random init: far from whitened


def test_dead_channels_keep_their_affine(models):
    _, params, _ = models
    tm = tup.build_model(tiny(default_config()), device="cpu")
    load_jax_params(tm, params)
    bn = tm.backbone_net.bn1
    with torch.no_grad():
        bn.scale.uniform_(0.5, 2.0)
        bn.bias.uniform_(-1.0, 1.0)
    scale, bias = bn.scale.clone(), bn.bias.clone()
    tool.fold_once(tm, torch.from_numpy(tool.calibration_images(0, H, W)))
    assert torch.equal(bn.scale[3], scale[3]) and torch.equal(bn.bias[3], bias[3])
    live = torch.arange(scale.numel()) != 3
    assert not torch.isclose(bn.scale[live], scale[live]).any()


def test_the_tool_converges_and_its_snapshot_loads_as_pretrained(tmp_path, monkeypatch, caplog):
    monkeypatch.chdir(tmp_path)
    (tmp_path / "tiny.yaml").write_text(TINY_FROZEN_BN_YAML.format(norm="frozen_bn"))
    path, passes = tool.run(["--cfg", "tiny.yaml", "--out", "model/tiny_frozenbn",
                             "--calib-hw", "64", "96", "--device", "cpu"])
    assert len(passes) == 6 and max(passes[-1]) <= tool.CONVERGED < max(passes[0])
    cfg = load_config("tiny.yaml")
    assert pathlib.Path(cfg.network.pretrained).resolve() == pathlib.Path(path)
    model = get_model(cfg.symbol, cfg, device="cpu", generator=torch.Generator().manual_seed(99))
    with caplog.at_level(logging.INFO):
        load_pretrained_any(cfg.network.pretrained, model, logging.getLogger("pretrained"))
    assert "(exact match)" in caplog.text
    saved = torch.load(path, map_location="cpu", weights_only=True)
    assert saved["iteration"] == 0 and saved["optimizer"] is None
    for k, v in model.state_dict().items():
        assert torch.equal(v, saved["state_dict"][k]), k
    folded = [v for k, v in saved["state_dict"].items() if k.endswith(".scale")]
    assert folded and all(not torch.equal(v, torch.ones_like(v)) for v in folded)


def test_the_tool_refuses_group_norm_by_name(tmp_path):
    (tmp_path / "gn.yaml").write_text(TINY_FROZEN_BN_YAML.format(norm="gn"))
    with pytest.raises(SystemExit, match="network.norm='gn'"):
        tool.run(["--cfg", str(tmp_path / "gn.yaml"), "--out", str(tmp_path / "out"),
                  "--device", "cpu"])
    assert not (tmp_path / "out").exists()
