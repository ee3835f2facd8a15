"""The port's goldens harness (``upsnet_torch/tools/goldens.py``) against the
JAX package's ``tools/goldens.py``.

The tiny synthetic configuration (``experiments/upsnet_tiny_synthetic.yaml``,
float32) is dumped by both tools on synthetic image 1 from one set of
weights: the JAX init of ``cfg.seed``, with O(1) activations and +-2 px
offset biases (``perturbed_params``), as an Orbax snapshot for the JAX tool
and bridged to a port snapshot (``save_jax_params_checkpoint``) for the
port's. The two dumps must hold the same keys with the same shapes and
dtypes, and the port's ``compare`` must pass them at ``ATOL``; it must
report a planted difference, a changed shape and a missing key.
"""

import argparse
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_predict import perturbed_params
from upsnet_tpu.config import load_config as jax_load_config
from upsnet_tpu.models.registry import get_model as jax_get_model
from upsnet_tpu.train.checkpoints import save_checkpoint as jax_save_checkpoint
from upsnet_torch.config import load_config
from upsnet_torch.convert.from_jax import save_jax_params_checkpoint
from upsnet_torch.tools import goldens

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
TINY = str(ROOT / "experiments" / "upsnet_tiny_synthetic.yaml")
# float32 through the whole model on both sides, sums in another order:
# the CPU predict test's 1e-4 of max|ref| at the largest values a dump holds,
# box corners on the 160-px canvas (measured: 3.9e-3 there, 1.2e-4 on P2)
ATOL = 1e-4 * 160


def _jax_goldens():
    spec = importlib.util.spec_from_file_location("root_goldens", ROOT / "tools" / "goldens.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("goldens")
    cfg = jax_load_config(TINY)
    model = jax_get_model(cfg.symbol, cfg)
    bucket = tuple(cfg.test.image_buckets[0])
    params = model.init(jax.random.PRNGKey(cfg.seed), jnp.zeros((1,) + bucket + (3,)))["params"]
    params = perturbed_params(params)
    jax_ckpt = jax_save_checkpoint(str(tmp / "jax_ckpt"), 0, params, {})
    port_ckpt = save_jax_params_checkpoint(str(tmp / "port_ckpt"), 0, params)
    jax_out, port_out = str(tmp / "jax.npz"), str(tmp / "port.npz")
    _jax_goldens().dump(argparse.Namespace(cfg=TINY, weights=jax_ckpt, pth=None, image=None,
                                           synthetic=1, out=jax_out))
    assert goldens.main(["dump", "--cfg", TINY, "--weights", port_ckpt, "--synthetic", "1",
                         "--out", port_out, "--device", "cpu"]) == 0
    return jax_out, port_out, tmp


def _compare(a, b, atol=ATOL) -> int:
    return goldens.main(["compare", a, b, "--atol", str(atol)])


def test_port_dump_has_the_jax_tools_keys_shapes_and_dtypes(dumps):
    jax_out, port_out, _ = dumps
    ref, got = np.load(jax_out), np.load(port_out)
    assert sorted(got.files) == sorted(ref.files)
    assert {"C2", "C5", "P6", "rpn_cls_P2", "rpn_bbox_P6", "pan_map"} <= set(got.files)
    for k in ref.files:
        assert (got[k].shape, got[k].dtype) == (ref[k].shape, ref[k].dtype), k


def test_expected_layout_is_the_jax_dumps(dumps):
    """The layout ``chip_smoke.py`` holds a full-size dump on the card to."""
    ref = np.load(dumps[0])
    cfg = load_config(TINY)
    assert goldens.expected_layout(cfg, tuple(cfg.test.image_buckets[0])) == {
        k: ref[k].shape for k in ref.files}


def test_compare_passes_a_port_dump_against_a_jax_dump(dumps, capsys):
    jax_out, port_out, _ = dumps
    assert _compare(port_out, jax_out) == 0
    lines = capsys.readouterr().out.splitlines()
    assert sum(line.endswith(" OK") for line in lines) == len(np.load(jax_out).files)


def test_compare_reports_a_planted_difference(dumps, capsys):
    _, port_out, tmp = dumps
    arrays = dict(np.load(port_out))
    planted = dict(arrays, P3=arrays["P3"].copy())
    planted["P3"][0, 1, 2] += 1.0
    np.savez_compressed(tmp / "planted.npz", **planted)
    capsys.readouterr()
    assert _compare(port_out, str(tmp / "planted.npz")) == 1
    out = capsys.readouterr().out
    assert "P3: max_abs=1.000e+00" in out and "DIFF" in out
    reshaped = dict(arrays, C2=arrays["C2"][:-1])
    np.savez_compressed(tmp / "reshaped.npz", **reshaped)
    assert _compare(port_out, str(tmp / "reshaped.npz")) == 1
    assert "C2: SHAPE MISMATCH" in capsys.readouterr().out
    fewer = {k: v for k, v in arrays.items() if k != "pan_keep"}
    np.savez_compressed(tmp / "fewer.npz", **fewer)
    assert _compare(port_out, str(tmp / "fewer.npz")) == 1
    assert "only in one file: ['pan_keep']" in capsys.readouterr().out


def test_compare_reads_bfloat16_bits(tmp_path):
    vals = torch.tensor([1.0, -2.5, 3.140625], dtype=torch.bfloat16)
    bits = goldens._np(vals)
    assert bits.dtype == np.dtype("V2")
    np.testing.assert_array_equal(goldens._float64(bits), [1.0, -2.5, 3.140625])
    np.savez_compressed(tmp_path / "a.npz", x=bits)
    np.savez_compressed(tmp_path / "b.npz", x=np.array([1.0, -2.5, 3.140625], np.float32))
    assert _compare(str(tmp_path / "a.npz"), str(tmp_path / "b.npz"), atol=0.0) == 0
