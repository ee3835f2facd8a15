"""The JAX -> torch weight bridge, the port's import boundary and its
entry-point rules."""

import dataclasses
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upsnet_tpu.config import default_config as jax_default_config
from upsnet_tpu.convert import torch_converter as tc
from upsnet_tpu.models import upsnet as jup
from upsnet_tpu.models.heads import BoxHead as JaxBoxHead
from upsnet_tpu.models.heads import MaskHead as JaxMaskHead
from upsnet_torch.config import default_config
from upsnet_torch.convert.from_jax import jax_params_to_state_dict, load_jax_params
from upsnet_torch.models import get_model
from upsnet_torch.models import upsnet as tup
from upsnet_torch.models.heads import BoxHead, MaskHead
from test_torch_predict import H, W, tiny

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jax_params():
    jm = jup.build_model(tiny(jax_default_config()))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)))["params"]
    return jax.device_get(params)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, np.asarray(tree)


def test_bridge_fills_every_parameter_and_buffer(jax_params):
    model = tup.build_model(tiny(default_config()), device="cpu")
    sd = jax_params_to_state_dict(jax_params)
    assert len(sd) == len(list(_leaves(jax_params)))
    assert set(sd) == set(model.state_dict())
    load_jax_params(model, jax_params)
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k


def test_bridge_is_strict(jax_params):
    model = tup.build_model(tiny(default_config()), device="cpu")
    extra = dict(jax_params, stray={"kernel": np.zeros((3, 3, 1, 1), np.float32)})
    with pytest.raises(RuntimeError):
        load_jax_params(model, extra)
    missing = {k: v for k, v in jax_params.items() if k != "rpn"}
    with pytest.raises(RuntimeError):
        load_jax_params(model, missing)
    bad = dict(jax_params, rpn=dict(jax_params["rpn"], conv={
        "kernel": np.zeros((1, 1, 32, 32), np.float32),
        "bias": jax_params["rpn"]["conv"]["bias"]}))
    with pytest.raises(RuntimeError):
        load_jax_params(model, bad)


def test_bridge_round_trips_bit_exact(jax_params):
    """torch state_dict -> the JAX package's own torch->flax transforms ->
    the original tree, bit for bit."""
    sd = jax_params_to_state_dict(jax_params)
    for path, leaf in _leaves(jax_params):
        name = "weight" if path[-1] == "kernel" else path[-1]
        t = sd[".".join(path[:-1] + (name,))].numpy()
        if path[-1] == "kernel" and leaf.ndim == 4:
            back = tc.deconv_w(t) if path[-2] == "deconv" else tc.conv_w(t)
        elif path[-1] == "kernel" and leaf.ndim == 3:
            back = tc.deform_w(t)
        elif path[-1] == "kernel":
            back = tc.dense_w(t)
        else:
            back = t
        np.testing.assert_array_equal(back, leaf, err_msg=".".join(path))


def test_box_head_fc1_flatten_order(rng):
    """The box head flattens pooled (R, P, P, C) features in the JAX
    order, so converted fc1 weights give the JAX output."""
    pooled = rng.randn(6, 7, 7, 8).astype(np.float32)
    jm = JaxBoxHead(num_classes=5, fc_dim=16)
    params = jax.device_get(jm.init(jax.random.PRNGKey(1), jnp.asarray(pooled))["params"])
    ref = jm.apply({"params": params}, jnp.asarray(pooled))
    head = BoxHead(5, 7 * 7 * 8, 16)
    head.load_state_dict(jax_params_to_state_dict(params))
    with torch.no_grad():
        got = head(torch.from_numpy(pooled))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5, rtol=1e-5)


def test_mask_head_deconv_flip(rng):
    """flax ConvTranspose applies its kernel unflipped; the bridge reverses
    it spatially for torch. Without the reversal the outputs differ."""
    pooled = rng.randn(3, 14, 14, 8).astype(np.float32)
    jm = JaxMaskHead(num_classes=5, channels=8)
    params = jax.device_get(jm.init(jax.random.PRNGKey(2), jnp.asarray(pooled))["params"])
    ref = np.moveaxis(np.asarray(jm.apply({"params": params}, jnp.asarray(pooled))), -1, 1)
    head = MaskHead(5, 8, channels=8)
    sd = jax_params_to_state_dict(params)
    head.load_state_dict(sd)
    with torch.no_grad():
        got = head(torch.from_numpy(pooled)).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
        head.deconv.weight.copy_(sd["deconv.weight"].flip(2, 3))
        unflipped = head(torch.from_numpy(pooled)).numpy()
    assert np.abs(unflipped - ref).max() > 1e-2


def test_import_leaves_jax_out():
    """Importing every module of the port loads neither jax, flax, orbax, the
    JAX package nor the root tools; the evaluation entry, its evaluators, the
    dataset base and the checkpoints are among them, and so are the train
    entry, the datasets, the loader and the wire, the process group, the DDP
    step and the row-slab fusion, TTA, and the reference converter with its
    report tool."""
    code = (
        "import pkgutil, sys, importlib, upsnet_torch\n"
        "for m in pkgutil.walk_packages(upsnet_torch.__path__, 'upsnet_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'orbax', 'upsnet_tpu', 'tools'))\n"
        "print(' '.join(k for k in sys.modules if k.startswith('upsnet_torch.')))\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = set(out.stdout.split())
    assert len(loaded) >= 20
    assert {"upsnet_torch.ops.deform_shift", "upsnet_torch.utils.dcn_probe",
            "upsnet_torch.train.trainer", "upsnet_torch.ops.cuda_build",
            "upsnet_torch.ops.deform_sample_mt",
            "upsnet_torch.tools.bench_deform_impls", "upsnet_torch.tools.test",
            "upsnet_torch.evaluation.inference", "upsnet_torch.evaluation.rle",
            "upsnet_torch.evaluation.rle_native", "upsnet_torch.evaluation.coco_eval",
            "upsnet_torch.evaluation.pq", "upsnet_torch.evaluation.seg_eval",
            "upsnet_torch.evaluation.panoptic_format", "upsnet_torch.data.base",
            "upsnet_torch.data.transforms", "upsnet_torch.utils.logging",
            "upsnet_torch.train.checkpoints", "upsnet_torch.tools.train",
            "upsnet_torch.tools.make_synth_coco", "upsnet_torch.data.pipeline",
            "upsnet_torch.data.wire", "upsnet_torch.data.coco", "upsnet_torch.data.cityscapes",
            "upsnet_torch.evaluation.cityscapes_eval", "upsnet_torch.convert.finetune",
            "upsnet_torch.train.step", "upsnet_torch.utils.profiling",
            "upsnet_torch.parallel.mesh", "upsnet_torch.parallel.steps",
            "upsnet_torch.parallel.spatial", "upsnet_torch.evaluation.tta",
            "upsnet_torch.convert.upsnet_names", "upsnet_torch.convert.torch_converter",
            "upsnet_torch.tools.convert_report"} <= loaded


def test_chip_smoke_imports_neither_jax_nor_the_jax_package():
    import ast
    import pathlib

    source = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    roots = set()
    for node in ast.walk(ast.parse(source.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            roots.add((node.module or "").split(".")[0])
    assert "upsnet_torch" in roots
    assert not roots & {"jax", "jaxlib", "flax", "upsnet_tpu"}


def test_build_model_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tup.build_model(tiny(default_config()))


def test_registry_builds_resnet50_and_rejects_unknown():
    cfg = default_config()
    model = get_model("resnet_50_upsnet", cfg, device="cpu")
    assert [len(n) for n in model.backbone_net.block_names] == [3, 4, 6, 3]
    assert model.fcn_head.subnet.dcn1.weight.shape == (128, 256, 3, 3)
    assert model.box_head.fc1.weight.shape == (1024, 7 * 7 * 256)
    with pytest.raises(KeyError):
        get_model("resnet_18_upsnet", cfg, device="cpu")


def test_config_copy_matches_jax_defaults():
    """The port's own config copy has the JAX package's fields and defaults,
    so one experiment description configures both."""
    assert dataclasses.asdict(default_config()) == dataclasses.asdict(jax_default_config())
