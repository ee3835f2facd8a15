"""The ``dcn_impl: shift`` slice of the port against the JAX package on the
CPU: ``deform_conv2d_shift`` and its gradients, the routing of
``deform_conv2d(impl="shift")``, the tiny model's predict outputs and loss
dict, the offset probe, the saturation watch and ``metrics.jsonl``.

The JAX side runs ``deform_conv2d_pallas_shift`` with ``pl.pallas_call`` in
interpret mode. On a CPU the JAX ``shift_route_ok`` is false and
``DeformConv(impl='shift')`` would take its dense ``mxu`` form, which does
not clip dx; the model tests therefore answer its backend test with 'tpu'
for that one function, so that the JAX model runs the interpreted shift
kernels on the eligible levels (P2 16x24 and P3 8x12 of the 64x96 input at
fcn 128) and its ``pallas`` fallback (``mxu`` on the CPU) on the others, as
the port routes them. Windows are +-3 px to keep the interpreted kernels'
unrolled candidate loops small.
"""

import dataclasses
import json
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_predict import CONTINUOUS, DISCRETE, H, W, perturbed_params
from test_torch_train import BSZ, LOSS_KEYS, _batch, _jax_noise, _t, tiny_train
from upsnet_tpu.config import default_config as jax_default_config
from upsnet_tpu.models import upsnet as jup
from upsnet_tpu.ops import deform_shift_pallas as dsp
from upsnet_tpu.ops.anchors import pyramid_anchors
from upsnet_tpu.utils import dcn_probe as jprobe
from upsnet_torch.config import default_config
from upsnet_torch.convert.from_jax import load_jax_params
from upsnet_torch.models import upsnet as tup
from upsnet_torch.models.layers import DeformConv
from upsnet_torch.ops import deform_conv as tdc
from upsnet_torch.ops import deform_shift as tshift
from upsnet_torch.train.trainer import train_steps
from upsnet_torch.utils import dcn_probe as tprobe

torch.set_num_threads(2)

MAX_D = 3


@pytest.fixture(autouse=True)
def interpreted_shift_route(monkeypatch):
    """``pl.pallas_call`` in interpret mode, and the JAX ``shift_route_ok``
    evaluated as on a TPU."""
    import jax.experimental.pallas as pl

    real_call = pl.pallas_call

    def fake_call(*args, **kw):
        kw["interpret"] = True
        return real_call(*args, **kw)

    real_ok = dsp.shift_route_ok

    def ok_as_on_tpu(*args, **kw):
        with mock.patch.object(jax, "default_backend", lambda: "tpu"):
            return real_ok(*args, **kw)

    monkeypatch.setattr(pl, "pallas_call", fake_call)
    monkeypatch.setattr(dsp, "shift_route_ok", ok_as_on_tpu)
    yield


# ------------------------------------------------------- deform_conv2d_shift


def _conv_inputs(seed, b=1, h=16, w=20, cin=16, cout=128, off_scale=5.0):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, h, w, cin).astype(np.float32)
    offsets = rng.uniform(-off_scale, off_scale, (b, h, w, 18)).astype(np.float32)
    weight = (rng.randn(9, cin, cout) * 0.1).astype(np.float32)
    bias = rng.randn(cout).astype(np.float32)
    return x, offsets, weight, bias


@pytest.mark.parametrize("dilation", [1, 2])
@pytest.mark.parametrize("boundary_grad", ["clip", "damped", "straight_through"])
def test_deform_conv2d_shift_matches_jax_forward_and_gradients(boundary_grad, dilation):
    """Offsets uniform in +-5 px against a +-3 window on both axes (about
    40% of the components clipped), samples outside the image along every
    edge. Forward atol 2e-4 (float32, sums in another order); each gradient
    within 1e-4 of its largest reference entry."""
    x, offsets, weight, bias = _conv_inputs(0)
    kw = dict(kernel_size=3, dilation=dilation, max_dy=MAX_D, max_dx=MAX_D,
              boundary_grad=boundary_grad)

    def jloss(x_, o_, w_, b_):
        out = dsp.deform_conv2d_pallas_shift(x_, o_, w_, b_, **kw)
        return jnp.sum(out ** 2), out

    (_, ref_out), ref_grads = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3), has_aux=True)(
        *(jnp.asarray(a) for a in (x, offsets, weight, bias)))
    targs = [_t(a).requires_grad_() for a in (x, offsets, weight, bias)]
    out = tdc.deform_conv2d_shift(*targs, **kw)
    out.square().sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out), atol=2e-4)
    beyond = np.abs(offsets) > MAX_D
    assert beyond[..., 0::2].any() and beyond[..., 1::2].any()
    for name, t, ref in zip(("x", "offsets", "weight", "bias"), targs, ref_grads):
        ref = np.asarray(ref)
        scale = np.abs(ref).max()
        assert scale > 0, name
        np.testing.assert_allclose(t.grad.numpy(), ref, rtol=0, atol=1e-4 * scale,
                                   err_msg=name)
    got_off = targs[1].grad.numpy()
    if boundary_grad == "clip":
        assert not got_off[beyond].any()  # a saturated offset is stuck
    else:
        assert got_off[beyond].any()  # the escape gradient


def test_deform_conv2d_shift_gradient_is_zero_at_integer_coordinates():
    """Integer offsets put every sample on a grid point: the gradient to the
    offsets is exactly 0 on both sides; the other gradients agree."""
    x, _, weight, _ = _conv_inputs(1)
    offsets = np.random.RandomState(2).randint(-2, 3, (1, 16, 20, 18)).astype(np.float32)
    kw = dict(max_dy=MAX_D, max_dx=MAX_D)
    ref = jax.grad(lambda x_, o_, w_: jnp.sum(
        dsp.deform_conv2d_pallas_shift(x_, o_, w_, **kw) ** 2), argnums=(0, 1, 2))(
            jnp.asarray(x), jnp.asarray(offsets), jnp.asarray(weight))
    targs = [_t(a).requires_grad_() for a in (x, offsets, weight)]
    tdc.deform_conv2d_shift(*targs, **kw).square().sum().backward()
    assert not np.asarray(ref[1]).any() and not targs[1].grad.numpy().any()
    for t, r in ((targs[0], ref[0]), (targs[2], ref[2])):
        r = np.asarray(r)
        np.testing.assert_allclose(t.grad.numpy(), r, rtol=0, atol=1e-4 * np.abs(r).max())


def test_deform_conv2d_shift_bfloat16_batch_and_bias():
    """bf16, batch 2, bias: both sides round the projections to bf16, add
    the taps in float32 and round once: one bf16 ulp of the output apart,
    plus 2^-7 absolute for the differently rounded projections."""
    x, offsets, weight, bias = _conv_inputs(3, b=2, off_scale=3.0)
    kw = dict(max_dy=MAX_D, max_dx=MAX_D)
    ref = dsp.deform_conv2d_pallas_shift(
        jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(offsets),
        jnp.asarray(weight).astype(jnp.bfloat16), jnp.asarray(bias).astype(jnp.bfloat16), **kw)
    got = tdc.deform_conv2d_shift(_t(x).bfloat16(), _t(offsets), _t(weight).bfloat16(),
                                  _t(bias).bfloat16(), **kw)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               rtol=2.0 ** -7, atol=2.0 ** -7)


# ------------------------------------------------------------------ routing


@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "grad"])
def test_impl_shift_routes_as_the_jax_layer(monkeypatch, grad):
    """An eligible shape takes the fused sampler, also under autograd; an
    ineligible one (height 12) takes the ``pallas`` route, which clips dy
    only."""
    x, offsets, weight, bias = _conv_inputs(4)
    args = [_t(a).requires_grad_(grad) for a in (x, offsets, weight, bias)]
    calls = []
    real = tshift.shift_fwd
    monkeypatch.setattr(tshift, "shift_fwd", lambda *a: (calls.append(1), real(*a))[1])
    with torch.set_grad_enabled(grad):
        got = tdc.deform_conv2d(*args, impl="shift", max_dy=MAX_D)
    assert calls == [1] and got.requires_grad == grad
    want = tdc.deform_conv2d_shift(*args, max_dy=MAX_D, max_dx=MAX_D)
    assert torch.equal(got, want)

    small = [a[:, :12] for a in args[:2]] + args[2:]
    assert not tshift.shift_route_ok(small[0].shape, 128, MAX_D, MAX_D, 1)
    with torch.set_grad_enabled(grad):
        got = tdc.deform_conv2d(*small, impl="shift", max_dy=MAX_D)
        as_pallas = tdc.deform_conv2d(*small, impl="pallas", max_dy=MAX_D)
        as_shift = tdc.deform_conv2d_shift(*small, max_dy=MAX_D, max_dx=MAX_D)
    assert calls == [1, 1, 1]  # want and as_shift sampled through K8a, got did not
    assert torch.equal(got, as_pallas) and not torch.allclose(got, as_shift, atol=1e-3)


def test_unknown_impl_is_refused():
    x, offsets, weight, _ = (_t(a) for a in _conv_inputs(5))
    with pytest.raises(NotImplementedError):
        tdc.deform_conv2d(x, offsets, weight, impl="tiled")


# ----------------------------------------------------------- the tiny model


def tiny_shift(cfg):
    """``tiny_train`` with ``dcn_impl: shift``, an FCN head 128 wide (the
    shift route wants a multiple of 128) and a +-3 px window."""
    cfg = tiny_train(cfg)
    return cfg.replace(network=dataclasses.replace(
        cfg.network, dcn_impl="shift", fcn_head_dim=128, dcn_max_dy=MAX_D))


@pytest.fixture(scope="module")
def model_setup():
    jcfg, tcfg = tiny_shift(jax_default_config()), tiny_shift(default_config())
    jm = jup.build_model(jcfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)))["params"]
    params = perturbed_params(params)
    tm = tup.build_model(tcfg, device="cpu")
    load_jax_params(tm, params)
    anchors = pyramid_anchors((H, W))
    return dict(jcfg=jcfg, tcfg=tcfg, jm=jm, params=params, tm=tm, anchors=anchors,
                janchors=tuple(jnp.asarray(a) for a in anchors),
                tanchors=tuple(torch.from_numpy(a) for a in anchors))


def test_jax_tree_loads_into_a_shift_model(model_setup):
    """The shift route has the parameters of every other route: the bridge
    needs no new mapping."""
    tm = model_setup["tm"]
    auto = tup.build_model(model_setup["tcfg"].replace(network=dataclasses.replace(
        model_setup["tcfg"].network, dcn_impl="auto")), device="cpu")
    assert set(tm.state_dict()) == set(auto.state_dict())
    dcns = [m for m in tm.modules() if isinstance(m, DeformConv)]
    assert len(dcns) == 2 and all(m.impl == m.impl_train == "shift" for m in dcns)
    kernel = model_setup["params"]["fcn_head"]["subnet"]["dcn1"]["kernel"]  # (9, Cin, Cout)
    w = tm.fcn_head.subnet.dcn1.weight.detach().numpy()  # (Cout, Cin, 3, 3)
    np.testing.assert_array_equal(w.reshape(*w.shape[:2], 9).transpose(2, 1, 0), kernel)


def test_forward_predict_shift_matches_jax(model_setup):
    """Predict outputs of the tiny ``dcn_impl: shift`` model: discrete ones
    equal, continuous ones within rtol 1e-4 and atol 1e-4 * max |ref|, as
    ``test_torch_predict.py`` holds the default route."""
    s = model_setup
    rng = np.random.RandomState(0)
    images = rng.uniform(-10, 10, (2, H, W, 3)).astype(np.float32)
    im_hw = np.array([[H, W], [H - 8, W - 16]], np.float32)
    jpredict = jax.jit(lambda p, b: jup.forward_predict(s["jm"], p, s["jcfg"],
                                                        s["janchors"], b))
    ref = jax.device_get(jpredict(s["params"], {"images": jnp.asarray(images),
                                                "im_hw": jnp.asarray(im_hw)}))
    calls = []
    real = tshift.shift_fwd
    with mock.patch.object(tshift, "shift_fwd", lambda *a: (calls.append(a[0].shape), real(*a))[1]):
        got = tup.forward_predict(s["tm"], s["tcfg"], s["tanchors"],
                                  {"images": _t(images), "im_hw": _t(im_hw)})
    # two layers on each of P2 and P3; P4 and P5 fall back
    assert sorted(c[1] for c in calls) == [8, 8, 16, 16]
    assert np.asarray(ref["det_valid"]).any()
    for k in DISCRETE:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
    for k in CONTINUOUS:
        g, r = got[k].numpy(), np.asarray(ref[k])
        fin = np.isfinite(r)
        np.testing.assert_array_equal(np.isfinite(g), fin, err_msg=k)
        np.testing.assert_allclose(np.where(fin, g, 0), np.where(fin, r, 0), rtol=1e-4,
                                   atol=1e-4 * np.abs(r[fin]).max(), err_msg=k)


def test_forward_train_shift_loss_dict_matches_jax(model_setup):
    """The 7 loss terms with shared weights and shared noise: rtol 1e-4, as
    ``test_torch_train.py`` holds the ``pallas`` route."""
    s = model_setup
    tcfg = s["tcfg"]
    batch = _batch(tcfg)
    key = jax.random.PRNGKey(5)
    n_anchors = sum(a.shape[0] for a in s["anchors"])
    n_cand = tcfg.train.rpn_post_nms_top_n + tcfg.train.max_gt_instances
    _, noise = _jax_noise(key, n_anchors, n_cand, tcfg.train.max_gt_instances)
    _, ref = jax.jit(lambda p, b: jup.forward_train(
        s["jm"], p, s["jcfg"], s["janchors"], b, key))(
            s["params"], {k: jnp.asarray(v) for k, v in batch.items()})
    ref = jax.device_get(ref)
    total, losses = tup.forward_train(s["tm"], tcfg, s["tanchors"],
                                      {k: _t(v) for k, v in batch.items()},
                                      {k: _t(v) for k, v in noise.items()})
    assert tuple(losses) == LOSS_KEYS
    for k in LOSS_KEYS:
        assert np.isfinite(float(ref[k])) and float(ref[k]) > 0, k
        np.testing.assert_allclose(float(losses[k].detach()), float(ref[k]), rtol=1e-4,
                                   err_msg=k)
    total.backward()  # K8b + K8c (plain) reach the offset convs
    off = s["tm"].fcn_head.subnet.dcn1.offset_conv
    assert off.weight.grad.abs().max() > 0 and off.bias.grad.abs().max() > 0
    s["tm"].zero_grad(set_to_none=True)


# ------------------------------------------------------ probe, watch, loop


def test_offset_probe_matches_the_jax_probe(model_setup):
    """[max |dy|, max |dx|, share at >= 0.9 * max_dy] per layer over the
    four levels against what the JAX layers sow: 1e-5 (float32 offset convs
    on both sides)."""
    s = model_setup
    images = np.random.RandomState(1).uniform(-10, 10, (BSZ, H, W, 3)).astype(np.float32)
    # dcn1's +-2 px offset biases stretched to +-2.9: some reach the edge band
    params = jax.tree.map(np.array, s["params"])
    params["fcn_head"]["subnet"]["dcn1"]["offset_conv"]["bias"] *= 1.45
    tm = tup.build_model(s["tcfg"], device="cpu")
    load_jax_params(tm, params)
    s = dict(s, params=params, tm=tm)
    ref = jprobe.probe_dcn_offsets(s["jm"], s["params"], jnp.asarray(images))
    got = tprobe.probe_dcn_offsets(s["tm"], _t(images))
    assert set(got) == set(ref) == {"fcn_head/subnet/dcn1", "fcn_head/subnet/dcn2"}
    for layer, r in ref.items():
        assert set(got[layer]) == set(r) == {"max_dy", "max_dx", "sat_frac"}
        for k, v in r.items():
            np.testing.assert_allclose(got[layer][k], v, rtol=1e-5, atol=1e-6,
                                       err_msg=f"{layer} {k}")
    assert 0 < got["fcn_head/subnet/dcn1"]["sat_frac"] < 1
    assert tprobe.check_window(got, MAX_D, MAX_D) == jprobe.check_window(ref, MAX_D, MAX_D)
    assert not tprobe.check_window(got, 0.5)


def _offset_hooks(model):
    return sum(len(m.offset_conv._forward_hooks) for m in model.modules()
               if isinstance(m, DeformConv))


def test_offset_probe_records_only_while_it_probes(model_setup):
    """The probe's hooks live for its one pass: none before or after it, a
    forward outside it leaves every layer as it was (no attribute, no hook),
    and two probes in a row give the same numbers."""
    tm = model_setup["tm"]
    images = _t(np.random.RandomState(2).uniform(-10, 10, (BSZ, H, W, 3)).astype(np.float32))
    before = {n: dict(vars(m)) for n, m in tm.named_modules() if isinstance(m, DeformConv)}
    assert _offset_hooks(tm) == 0
    first = tprobe.probe_dcn_offsets(tm, images)
    assert _offset_hooks(tm) == 0
    assert set(first) == {n.replace(".", "/") for n in before}
    with torch.no_grad():
        tm.extract(images.permute(0, 3, 1, 2))
    assert {n: dict(vars(m)) for n, m in tm.named_modules()
            if isinstance(m, DeformConv)} == before
    assert tprobe.probe_dcn_offsets(tm, images) == first


def test_offset_probe_removes_its_hooks_when_the_pass_raises(model_setup):
    """A pass that fails (here an image with a channel too many) leaves no
    hook behind, and a model without deformable layers gives no numbers."""
    tm = model_setup["tm"]
    with pytest.raises(RuntimeError):
        tprobe.probe_dcn_offsets(tm, torch.zeros((1, H, W, 4)))
    assert _offset_hooks(tm) == 0
    plain = torch.nn.Module()
    plain.extract = lambda x: x
    assert tprobe.probe_dcn_offsets(plain, torch.zeros((1, H, W, 3))) == {}


@pytest.mark.parametrize("impl", ["gather", "pallas"])
def test_offset_probe_matches_the_jax_probe_under_each_impl(model_setup, impl):
    """The probe on the tiny model built with ``dcn_impl`` ``impl`` against
    the JAX probe of the same model: dcn1's +-2 px offset biases stretched
    to +-5 px, beyond the +-3 window, so that the second layer's offsets
    follow the first layer's route (``pallas`` clips dy, ``mxu`` on the
    JAX side's CPU; ``gather`` does not). 1e-5, as above."""
    s = model_setup
    images = np.random.RandomState(3).uniform(-10, 10, (BSZ, H, W, 3)).astype(np.float32)
    params = jax.tree.map(np.array, s["params"])
    params["fcn_head"]["subnet"]["dcn1"]["offset_conv"]["bias"] *= 2.5
    jcfg, tcfg = (c.replace(network=dataclasses.replace(c.network, dcn_impl=impl))
                  for c in (s["jcfg"], s["tcfg"]))
    tm = tup.build_model(tcfg, device="cpu")
    load_jax_params(tm, params)
    ref = jprobe.probe_dcn_offsets(jup.build_model(jcfg), params, jnp.asarray(images))
    got = tprobe.probe_dcn_offsets(tm, _t(images))
    assert set(got) == set(ref) == {"fcn_head/subnet/dcn1", "fcn_head/subnet/dcn2"}
    assert ref["fcn_head/subnet/dcn1"]["max_dy"] > MAX_D
    for layer, r in ref.items():
        for k, v in r.items():
            np.testing.assert_allclose(got[layer][k], v, rtol=1e-5, atol=1e-6,
                                       err_msg=f"{impl} {layer} {k}")


@pytest.mark.parametrize("boundary_grad", ["clip", "straight_through"])
@pytest.mark.parametrize("with_rate", [True, False], ids=["rate", "max_only"])
def test_saturation_watch_matches_jax_on_a_stats_sequence(boundary_grad, with_rate):
    """The port's watch and the JAX package's on the same sequence of
    stats: equal fields and equal warnings in 'warn' mode, equal errors in
    'fail' mode."""
    def stats(dy, dx, frac):
        s = {"a/dcn1": {"max_dy": dy, "max_dx": dx}, "a/dcn2": {"max_dy": 0.5, "max_dx": 0.25}}
        if with_rate:
            s["a/dcn1"]["sat_frac"], s["a/dcn2"]["sat_frac"] = frac, 0.0
        return s

    seq = [stats(1.0, 2.0, 0.0), stats(5.8, 2.0, 0.2), stats(5.9, 7.0, 0.3),
           stats(30.0, 1.0, 0.0), stats(1.0, 1.0, 0.01), {}, stats(5.9, 5.9, 0.5),
           stats(5.9, 5.9, 0.5), stats(5.9, 5.9, 0.5)]
    watches = [cls(6, "pallas", boundary_grad, "warn") for cls in
               (tprobe.SaturationWatch, jprobe.SaturationWatch)]
    warned = 0
    for st in seq:
        (got, got_msg), (ref, ref_msg) = (w.update(st) for w in watches)
        assert got == ref and got_msg == ref_msg
        warned += got_msg is not None
    assert warned == 2
    fails = [cls(6, "mxu", boundary_grad, "fail", patience=2) for cls in
             (tprobe.SaturationWatch, jprobe.SaturationWatch)]
    errors = []
    for w in fails:
        w.update(seq[1])
        with pytest.raises(RuntimeError) as err:
            w.update(seq[2])
        errors.append(str(err.value))
    assert errors[0] == errors[1] and "saturating" in errors[0]


JAX_METRIC_FIELDS = {*LOSS_KEYS, "total", "iter", "images_per_sec", "step_s",
                     "loader_wait_s", "platform"}
JAX_WATCH_FIELDS = {"dcn_max_dy", "dcn_max_dx", "dcn_impl", "dcn_boundary_grad",
                    "dcn_sat_frac"}


@pytest.mark.parametrize("impl", ["pallas", "shift"])
def test_train_steps_writes_metrics_jsonl(model_setup, tmp_path, impl):
    """Three steps at a display interval of two: two lines (the tail
    too) with the JAX loop's field names; the watch's fields under
    ``pallas`` and, as in the JAX loop, not under ``shift``. The callback
    sees every step once, in order, when its interval is read."""
    s = model_setup
    tcfg = s["tcfg"].replace(
        output_path=str(tmp_path),
        network=dataclasses.replace(s["tcfg"].network, dcn_impl=impl,
                                    dcn_saturation_action="warn"),
        train=dataclasses.replace(s["tcfg"].train, display_iter=2, lr=1e-3))
    tm = tup.build_model(tcfg, device="cpu")
    load_jax_params(tm, s["params"])
    batch = {k: _t(v) for k, v in _batch(tcfg).items()}
    seen = []
    history = train_steps(tm, tcfg, s["tanchors"], iter([batch] * 3),
                          generator=torch.Generator().manual_seed(3),
                          on_step=lambda i, m: seen.append((i, m["total"])))
    assert [i for i, _ in seen] == [0, 1, 2] and len(history) == 3
    with open(os.path.join(tmp_path, tcfg.symbol, "metrics.jsonl")) as f:
        entries = [json.loads(line) for line in f]
    assert [e["iter"] for e in entries] == [2, 3]
    fields = JAX_METRIC_FIELDS | (JAX_WATCH_FIELDS if impl == "pallas" else set())
    for e in entries:
        assert set(e) == fields
        assert e["platform"] == "cpu" and e["images_per_sec"] > 0 and e["step_s"] > 0
    np.testing.assert_allclose(entries[0]["total"],
                               (history[0]["total"] + history[1]["total"]) / 2, rtol=1e-6)
    np.testing.assert_allclose(entries[1]["total"], history[2]["total"], rtol=1e-6)
    if impl == "pallas":
        assert entries[0]["dcn_impl"] == "pallas" and entries[0]["dcn_boundary_grad"] == "clip"
        assert 0 < entries[0]["dcn_max_dy"] and 0 <= entries[0]["dcn_sat_frac"] <= 1


def test_train_steps_fails_on_sustained_saturation(model_setup, tmp_path):
    """Offset biases far beyond the window: with the default action the
    loop raises after three saturated intervals, and those before it were
    written."""
    s = model_setup
    tcfg = s["tcfg"].replace(
        output_path=str(tmp_path),
        network=dataclasses.replace(s["tcfg"].network, dcn_impl="pallas"),
        train=dataclasses.replace(s["tcfg"].train, display_iter=1, lr=1e-5))
    assert tcfg.network.dcn_saturation_action == "fail"
    tm = tup.build_model(tcfg, device="cpu")
    load_jax_params(tm, s["params"])
    with torch.no_grad():
        tm.fcn_head.subnet.dcn1.offset_conv.bias.fill_(5.0)
    batch = {k: _t(v) for k, v in _batch(tcfg).items()}
    with pytest.raises(RuntimeError, match="saturating the train window"):
        train_steps(tm, tcfg, s["tanchors"], [batch] * 4,
                    generator=torch.Generator().manual_seed(3))
    with open(os.path.join(tmp_path, tcfg.symbol, "metrics.jsonl")) as f:
        assert len(f.readlines()) == 2
