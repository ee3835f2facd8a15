"""GroupNorm and the backbone's deformable convs in the port against the
JAX package on the CPU.

- ``GroupNorm`` against flax's ``nn.GroupNorm(32, eps 1e-5)``, float32 and
  bfloat16, on normal inputs and on inputs with a large common mean on a
  2^-2 grid, where every sum of the statistics is exact in float32 in any
  order, so the fast variance ``E[x^2] - E[x]^2`` cancels the same way in
  both: float32 within 1e-6 |ref| + 1e-6 max|ref| (sums in another order,
  rsqrt), bfloat16 within one bf16 ulp (one rounding of float32 values that
  agree that closely). A two-pass variance (``F.group_norm``) misses the
  float32 tolerance on the large-mean input, so the test tells the two apart.
- C2..C5 of the tiny trunk (``resnet_test``) against the JAX backbone under
  (gn, no DCN), (frozen_bn, DCN in stages 3-5) and (gn, DCN in 3-5), no
  grad, under ``dcn_impl`` ``auto`` and ``pallas``: the existing module
  tolerance (rtol 1e-4, atol 1e-4 max|ref|).
- The bridge with GroupNorm and backbone-DCN leaves: every parameter and
  buffer filled, strict, bit-exact round trips.
- The offset probe: the same layers (the backbone's ``res3_0/conv2`` ...
  beside the FCN head's) and the same statistics as the JAX probe.
- The whole predict slice of the tiny GN + backbone-DCN model against JAX
  ``forward_predict``, as ``test_torch_predict.py`` holds the frozen-BN one.
Shared weights come from the JAX init through the bridge, with offset
biases at +-2 px and norm scales in [0.3, 0.6] (``perturbed_params``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as nn

from test_torch_modules import assert_close
from test_torch_predict import CONTINUOUS, DISCRETE, H, W, perturbed_params, tiny
from test_torch_train import _leaves
from upsnet_tpu.config import default_config as jax_default_config
from upsnet_tpu.convert import torch_converter as tc
from upsnet_tpu.models import upsnet as jup
from upsnet_tpu.ops.anchors import pyramid_anchors
from upsnet_tpu.utils import dcn_probe as jprobe
from upsnet_torch.config import default_config
from upsnet_torch.convert.from_jax import jax_params_to_state_dict, load_jax_params, to_jax
from upsnet_torch.models import layers
from upsnet_torch.models import upsnet as tup
from upsnet_torch.utils import dcn_probe as tprobe

torch.set_num_threads(2)

# (norm, backbone_with_dcn)
VARIANTS = {"gn": ("gn", False), "dcn": ("frozen_bn", True), "gn_dcn": ("gn", True)}


def variant(cfg, name: str, impl: str = "auto"):
    norm, with_dcn = VARIANTS[name]
    cfg = tiny(cfg)
    return cfg.replace(network=dataclasses.replace(
        cfg.network, norm=norm, backbone_with_dcn=with_dcn, dcn_stages=(3, 4, 5),
        dcn_impl=impl))


@pytest.fixture(scope="module")
def built():
    """Per variant, built on first use: the JAX model, its perturbed
    parameters and the port's model holding them."""
    cache = {}

    def get(name):
        if name not in cache:
            jm = jup.build_model(variant(jax_default_config(), name))
            params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)))["params"]
            params = perturbed_params(params)
            tm = tup.build_model(variant(default_config(), name), device="cpu")
            load_jax_params(tm, params)
            cache[name] = (jm, params, tm)
        return cache[name]

    return get


def _images(seed=0):
    return np.random.RandomState(seed).uniform(-10, 10, (2, H, W, 3)).astype(np.float32)


# ---------------------------------------------------------------- GroupNorm


def _bf16_ulp(a):
    """One bf16 ulp at each value of a (8 significant bits)."""
    mag = np.maximum(np.abs(a), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("inputs", ["normal", "common_mean"])
def test_group_norm_matches_flax(inputs, dtype, rng):
    b, c, h, w = 2, 64, 8, 8
    if inputs == "normal":
        x = (rng.randn(b, h, w, c) * 3 + 0.5).astype(np.float32)
    else:  # mean 48, spread +-2 on a 2^-2 grid: exact in bf16, exact sums
        x = (48 + rng.randint(-8, 9, (b, h, w, c)) / 4).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.randn(c).astype(np.float32)
    jdt = jnp.dtype(dtype)
    flax_gn = nn.GroupNorm(num_groups=32, epsilon=1e-5, dtype=jdt, param_dtype=jnp.float32)
    ref = flax_gn.apply({"params": {"scale": scale, "bias": bias}}, jnp.asarray(x).astype(jdt))
    assert ref.dtype == jdt
    ref = np.asarray(ref.astype(jnp.float32))
    gn = layers.GroupNorm(c, dtype=getattr(torch, dtype))
    xt = torch.from_numpy(np.moveaxis(x, -1, 1).copy()).to(getattr(torch, dtype))
    with torch.no_grad():
        gn.scale.copy_(torch.from_numpy(scale))
        gn.bias.copy_(torch.from_numpy(bias))
        out = gn(xt)
        two_pass = F.group_norm(xt.float(), 32, gn.scale, gn.bias, 1e-5)
    assert out.dtype == getattr(torch, dtype)
    got = out.float().permute(0, 2, 3, 1).numpy()
    scale_ref = np.abs(ref).max()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6 * scale_ref)
        if inputs == "common_mean":
            err = np.abs(two_pass.permute(0, 2, 3, 1).numpy() - ref)
            assert (err > 1e-6 * np.abs(ref) + 1e-6 * scale_ref).any()
    else:
        assert (np.abs(got - ref) <= _bf16_ulp(ref)).all()
    assert [n for n, _ in gn.named_parameters()] == ["scale", "bias"]
    assert not list(gn.buffers())


# -------------------------------------------------------------------- trunk


@pytest.mark.parametrize("impl", ["auto", "pallas"])
@pytest.mark.parametrize("name", list(VARIANTS))
def test_backbone_matches_jax(built, name, impl):
    """C2..C5 with every DCN layer of both models under ``impl``."""
    jm, params, tm = built(name)
    jm = jm.clone(dcn_impl=impl)
    images = _images()
    ref = jax.jit(lambda p, x: jm.apply({"params": p}, x,
                                        method=lambda m, x: m.backbone_net(x)))(params, images)
    dcns = [m for m in tm.modules() if isinstance(m, layers.DeformConv)]
    n_backbone = sum(1 for n, m in tm.backbone_net.named_modules()
                     if isinstance(m, layers.DeformConv))
    assert n_backbone == (3 if VARIANTS[name][1] else 0)
    for m in dcns:
        m.impl = impl
    try:
        with torch.no_grad():
            got = tm.backbone_net(torch.from_numpy(np.moveaxis(images, -1, 1).copy()))
    finally:
        for m in dcns:
            m.impl = "auto"
    assert len(got) == len(ref) == 4
    for i, (g, r) in enumerate(zip(got, jax.device_get(ref))):
        assert_close(g.permute(0, 2, 3, 1), r, name=f"C{i + 2}")


# ------------------------------------------------------------------- bridge


def test_bridge_fills_gn_and_backbone_dcn_leaves(built):
    _, params, _ = built("gn_dcn")
    model = tup.build_model(variant(default_config(), "gn_dcn"), device="cpu")
    sd = jax_params_to_state_dict(params)
    assert len(sd) == len(list(_leaves(params)))
    assert set(sd) == set(model.state_dict())
    assert not list(model.buffers())  # GroupNorm's affines are parameters
    assert "backbone_net.res4_0.conv2.weight" in sd and \
        "backbone_net.res4_0.conv2.bias" not in sd
    assert sd["backbone_net.res4_0.conv2.offset_conv.weight"].shape == (18, 256, 3, 3)
    load_jax_params(model, params)
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k


def test_bridge_is_strict_on_gn_and_backbone_dcn_leaves(built):
    _, params, _ = built("gn_dcn")
    model = tup.build_model(variant(default_config(), "gn_dcn"), device="cpu")
    res3 = params["backbone_net"]["res3_0"]
    stray = dict(params, backbone_net=dict(params["backbone_net"], res3_0=dict(
        res3, conv2=dict(res3["conv2"], bias=np.zeros(128, np.float32)))))
    missing = dict(params, backbone_net=dict(params["backbone_net"], res3_0={
        k: v for k, v in res3.items() if k != "bn2"}))
    wrong = dict(params, backbone_net=dict(params["backbone_net"], bn1={
        "scale": np.ones(32, np.float32), "bias": np.zeros(32, np.float32)}))
    for tree in (stray, missing, wrong):
        with pytest.raises(RuntimeError):
            load_jax_params(model, tree)


def test_bridge_round_trips_gn_and_backbone_dcn_bit_exact(built):
    """state_dict -> the JAX package's torch->flax transforms, and
    ``to_jax``, each give the original tree bit for bit."""
    _, params, tm = built("gn_dcn")
    sd = jax_params_to_state_dict(params)
    back = dict(_leaves(to_jax(tm.state_dict(), params)))
    n_deform = 0
    for path, leaf in _leaves(params):
        name = "weight" if path[-1] == "kernel" else path[-1]
        t = sd[".".join(path[:-1] + (name,))].numpy()
        if path[-1] == "kernel" and leaf.ndim == 4:
            via_tc = tc.deconv_w(t) if path[-2] == "deconv" else tc.conv_w(t)
        elif path[-1] == "kernel" and leaf.ndim == 3:
            via_tc = tc.deform_w(t)
            n_deform += 1
        elif path[-1] == "kernel":
            via_tc = tc.dense_w(t)
        else:
            via_tc = t
        np.testing.assert_array_equal(via_tc, leaf, err_msg=".".join(path))
        np.testing.assert_array_equal(back[path], leaf, err_msg=".".join(path))
    assert n_deform == 3 + 2  # the backbone's res3-5 and the FCN head's two


# -------------------------------------------------------------------- probe


def test_offset_probe_sees_the_backbone_layers_as_jax_does(built):
    """The same layer names (``backbone_net/res3_0/conv2`` ...) and the same
    [max |dy|, max |dx|, share at the window edge] per layer: 1e-5."""
    jm, params, tm = built("gn_dcn")
    images = _images(1)
    ref = jprobe.stats_from_intermediates(
        jprobe.make_offset_probe(jm)(params, jnp.asarray(images)))
    got = tprobe.probe_dcn_offsets(tm, torch.from_numpy(images))
    assert set(got) == set(ref) == {
        "backbone_net/res3_0/conv2", "backbone_net/res4_0/conv2", "backbone_net/res5_0/conv2",
        "fcn_head/subnet/dcn1", "fcn_head/subnet/dcn2"}
    assert [p for p, _ in tprobe._dcn_layers(tm)][:3] == sorted(got)[:3]
    for layer, r in ref.items():
        assert set(got[layer]) == set(r)
        for k, v in r.items():
            np.testing.assert_allclose(got[layer][k], v, rtol=1e-5, atol=1e-6,
                                       err_msg=f"{layer} {k}")
        assert r["max_dy"] > 0


# ------------------------------------------------------------------ predict


def test_forward_predict_matches_jax_under_gn_and_backbone_dcn(built):
    """Discrete outputs equal; continuous ones within rtol 1e-4 and atol
    1e-4 max|ref|, as ``test_torch_predict.py``."""
    jm, params, tm = built("gn_dcn")
    jcfg, tcfg = variant(jax_default_config(), "gn_dcn"), variant(default_config(), "gn_dcn")
    anchors = pyramid_anchors((H, W))
    images = _images(2)
    im_hw = np.array([[H, W], [H - 8, W - 16]], np.float32)
    janchors = tuple(jnp.asarray(a) for a in anchors)
    ref = jax.device_get(jax.jit(lambda p, b: jup.forward_predict(jm, p, jcfg, janchors, b))(
        params, {"images": jnp.asarray(images), "im_hw": jnp.asarray(im_hw)}))
    got = tup.forward_predict(tm, tcfg, tuple(torch.from_numpy(a) for a in anchors),
                              {"images": torch.from_numpy(images),
                               "im_hw": torch.from_numpy(im_hw)})
    assert set(got) == set(ref)
    assert np.asarray(ref["det_valid"]).any() and np.asarray(ref["pan_keep"]).any()
    for k in DISCRETE:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
    for k in CONTINUOUS:
        g, r = got[k].numpy(), np.asarray(ref[k])
        fin = np.isfinite(r)
        np.testing.assert_array_equal(np.isfinite(g), fin, err_msg=k)
        np.testing.assert_allclose(np.where(fin, g, 0), np.where(fin, r, 0), rtol=1e-4,
                                   atol=1e-4 * np.abs(r[fin]).max(), err_msg=k)
