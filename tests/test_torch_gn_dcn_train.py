"""Training under GroupNorm and backbone DCN: the port against the JAX
package on the CPU.

Tiny train config of ``test_torch_train.py`` (``resnet_test`` trunk,
float32, 64x96, batch 2) with ``norm: gn`` and deformable convs in stages
3-5, weights shared through the bridge, offset biases at +-2 px
(fractional), and under ``gather`` also at zero as shipped (every sample on
an integer coordinate, where each route takes its JAX function's
derivative), JAX's random draws handed to the port as ``noise``.

- ``forward_train`` gradients against ``jax.grad`` under ``dcn_impl``
  ``pallas`` (dy clipped; the JAX package differentiates its dense ``mxu``
  form on the CPU) and ``gather`` (exact), per trainable leaf within
  1e-3 |ref| + 1e-4 max|ref leaf|, the tolerance of ``test_torch_train.py``.
  The one allowance: the mask head's ReLU after its deconv sees
  pre-activations within 1e-5 of zero (f32 sums of 1024 terms in another
  order round them apart, and their sign with them), so the deconv's kernel
  and bias may also differ by what flipping those ReLUs moves them
  (``_relu_tie_allowance``, from the port's own activations and gradients
  at such positions, fewer than 1e-4 of them);
- the optimizer's groups and freezing against ``_param_labels(...,
  freeze_norm=False)``: GroupNorm ``scale`` and ``bias`` in ``bias`` (2x lr,
  no decay), the backbone's offset convs in ``offset`` / ``offset_bias``,
  the stem's GroupNorm frozen with conv1 under stage 1 and res2's under 2;
- SGD updates against optax with the clip active, as
  ``test_optimizer_steps_match_optax`` (frozen leaves get zero gradients on
  both sides).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_predict import H, W, perturbed_params
from test_torch_train import (_as_state_dict, _batch, _jax_noise, _leaves, _leaves_str,
                              _t, _trainable_paths, _unflatten, tiny_train)
from upsnet_tpu.config import default_config as jax_default_config
from upsnet_tpu.models import upsnet as jup
from upsnet_tpu.ops.anchors import pyramid_anchors
from upsnet_tpu.train import optimizer as joptim
from upsnet_torch.config import default_config
from upsnet_torch.convert.from_jax import _restore_kernel, load_jax_params, to_jax
from upsnet_torch.models import layers
from upsnet_torch.models import upsnet as tup
from upsnet_torch.train import optimizer as toptim

torch.set_num_threads(2)


def gn_dcn_train(cfg, impl: str = "pallas", frozen_stages=(1, 2)):
    cfg = tiny_train(cfg)
    return cfg.replace(network=dataclasses.replace(
        cfg.network, norm="gn", backbone_with_dcn=True, dcn_stages=(3, 4, 5), dcn_impl=impl,
        frozen_stages=frozen_stages))


@pytest.fixture(scope="module")
def params():
    jm = jup.build_model(gn_dcn_train(jax_default_config()))
    tree = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)))["params"]
    return perturbed_params(tree)


TIE = 1e-5  # |pre-activation| below which rounding may decide a ReLU


def _record_deconv_relu(tm):
    """Hooks on the mask head recording, per call, the deconv's input x, its
    output z and the gradient g that reaches relu(z)."""
    calls = []

    def after_deconv(module, inputs, out):
        calls.append({"x": inputs[0].detach(), "z": out.detach()})

    def before_score(module, inputs):
        rec = calls[-1]
        inputs[0].register_hook(lambda g: rec.__setitem__("g", g.detach()))

    tm.mask_head.deconv.register_forward_hook(after_deconv)
    tm.mask_head.mask_score.register_forward_pre_hook(before_score)
    return calls


def _relu_tie_allowance(calls, params):
    """For the deconv's kernel and bias (flax layouts): the sum over the
    positions where |z| < TIE of what the ReLU passes there, |x| |g| per
    kernel entry and |g| per bias entry: the most that ReLU decisions taken
    by rounding can move those gradients. Also the share of such
    positions."""
    kernel = np.zeros(params["mask_head"]["deconv"]["kernel"].shape, np.float32)
    bias = np.zeros(params["mask_head"]["deconv"]["bias"].shape, np.float32)
    ties = total = 0
    for c in calls:
        near = c["z"].abs() < TIE
        w = (near * c["g"].abs()).float()  # (R, Cout, 2 Hin, 2 Win)
        r, cout, h2, w2 = w.shape
        w = w.reshape(r, cout, h2 // 2, 2, w2 // 2, 2)  # out[2i + k, 2j + l]
        per_tap = torch.einsum("rcij,rdikjl->cdkl", c["x"].abs().float(), w)
        kernel += _restore_kernel(("mask_head", "deconv", "kernel"), per_tap.numpy(), kernel)
        bias += w.sum(dim=(0, 2, 3, 4, 5)).numpy()
        ties += int(near.sum())
        total += near.numel()
    return {("mask_head", "deconv", "kernel"): kernel,
            ("mask_head", "deconv", "bias"): bias}, ties / total


def _zero_offset_biases(tree, path=()):
    """``tree`` with every offset conv's bias at zero: with the kernels at
    their zero init, as shipped, every DCN sample starts on an integer
    coordinate."""
    if isinstance(tree, dict):
        return {k: _zero_offset_biases(v, path + (k,)) for k, v in tree.items()}
    return np.zeros_like(tree) if path[-2:] == ("offset_conv", "bias") else tree


@pytest.mark.parametrize("impl, zero_offsets", [
    pytest.param("pallas", False, id="pallas"), pytest.param("gather", False, id="gather"),
    pytest.param("gather", True, id="gather-zero_offsets")])
def test_gradients_match_jax_grad(params, impl, zero_offsets):
    """Every trainable leaf, the backbone's GroupNorms and DCN layers among
    them, against ``jax.grad``; the frozen ones (stem and res2, their
    GroupNorms included) carry no gradient in the port. ``zero_offsets``:
    the offset convs' biases at zero as well as their kernels, as shipped,
    so that every sample lies on an integer coordinate, where ``gather``
    takes the gather form's one-sided derivative and the offset convs get
    their gradients from it. There the mask head's last conv has output
    positions within 1e-4 of zero, where f32 rounding decides its ReLU
    apart in the two packages (measured: two of its output channels, and
    the same on the tree before the rule; the mask head's gradients pass
    through no DCN): its kernel and bias are held outside the channels with
    such a position, and the three convs before it, whose gradients come
    through those ReLUs, are not held."""
    if zero_offsets:
        params = _zero_offset_biases(params)
    jcfg, tcfg = gn_dcn_train(jax_default_config(), impl), gn_dcn_train(default_config(), impl)
    jm = jup.build_model(jcfg)
    anchors = pyramid_anchors((H, W))
    janchors = tuple(jnp.asarray(a) for a in anchors)
    batch = _batch(tcfg)
    key = jax.random.PRNGKey(5)
    n_cand = tcfg.train.rpn_post_nms_top_n + tcfg.train.max_gt_instances
    _, noise = _jax_noise(key, sum(a.shape[0] for a in anchors), n_cand,
                          tcfg.train.max_gt_instances)
    (_, ref_losses), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jup.forward_train(jm, p, jcfg, janchors, b, key), has_aux=True))(
            params, {k: jnp.asarray(v) for k, v in batch.items()})

    tm = tup.build_model(tcfg, device="cpu")
    load_jax_params(tm, params)
    calls = _record_deconv_relu(tm)
    conv4 = []
    tm.mask_head.conv4.register_forward_hook(lambda m, a, out: conv4.append(out.detach()))
    total, losses = tup.forward_train(tm, tcfg, tuple(torch.from_numpy(a) for a in anchors),
                                      {k: _t(v) for k, v in batch.items()},
                                      {k: _t(v) for k, v in noise.items()})
    for k, v in jax.device_get(ref_losses).items():
        np.testing.assert_allclose(float(losses[k].detach()), float(v), rtol=1e-4, err_msg=k)
    total.backward()
    named = dict(tm.named_parameters())
    frozen = {n for n, p in named.items() if not p.requires_grad}
    assert {"backbone_net.bn1.scale", "backbone_net.res2_0.bn2.bias"} <= frozen
    assert all(n.startswith(("backbone_net.conv1.", "backbone_net.bn1.", "backbone_net.res2_"))
               for n in frozen)
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in named.items()}
    got_tree = to_jax(grads, params)
    trainable = _trainable_paths(tm, params)
    ref_leaves = dict(_leaves(jax.device_get(jgrads)))
    allowance, tie_share = _relu_tie_allowance(calls, params)
    assert len(calls) == 2 and tie_share < 1e-4
    near = torch.cat([(z.abs() < 1e-4).any(dim=(0, 2, 3))[None] for z in conv4]).any(0).numpy()
    checked = 0
    for path, got in _leaves(got_tree):
        ref = ref_leaves[path]
        name = ".".join(path)
        if path not in trainable:
            assert not got.any(), name
            continue
        scale = np.abs(ref).max()
        assert np.isfinite(got).all() and scale > 0, name
        bound = 1e-3 * np.abs(ref) + 1e-4 * scale + allowance.get(path, 0.0)
        held = np.ones(got.shape, bool)
        if zero_offsets and path[:2] == ("mask_head", "conv4"):
            held[..., near] = False  # the last axis is the output channel
            assert 0 < near.sum() < 16, name
        elif zero_offsets and path[0] == "mask_head" and path[1] in ("conv1", "conv2", "conv3"):
            continue
        assert (np.abs(got - ref) <= bound)[held].all(), (name, float(np.abs(got - ref).max()))
        checked += 1
    assert checked == len(named) - len(frozen) - (6 if zero_offsets else 0)
    for stage in (3, 4, 5):
        off = got_tree["backbone_net"][f"res{stage}_0"]["conv2"]["offset_conv"]
        assert np.abs(off["kernel"]).max() > 0 and np.abs(off["bias"]).max() > 0


@pytest.mark.parametrize("frozen_stages", [(1,), (2,), (1, 2)], ids=["1", "2", "1_2"])
def test_param_groups_and_freezing_follow_the_jax_labels(params, frozen_stages):
    tcfg = gn_dcn_train(default_config(), frozen_stages=frozen_stages)
    tm = tup.build_model(tcfg, device="cpu")
    labels = dict(_leaves_str(joptim._param_labels(params, frozen_stages, freeze_norm=False)))
    opt = toptim.make_optimizer(tcfg, tm)
    in_group = {id(p): g["name"] for g in opt.param_groups for p in g["params"]}
    named = dict(tm.named_parameters())
    assert len(labels) == len(named)
    for path, label in labels.items():
        name = ".".join(path[:-1] + ("weight" if path[-1] == "kernel" else path[-1],))
        assert in_group.get(id(named[name]), "frozen") == label, name
    assert in_group[id(named["backbone_net.res3_0.bn1.scale"])] == "bias"
    assert in_group[id(named["backbone_net.res4_0.conv2.offset_conv.weight"])] == "offset"
    assert in_group[id(named["backbone_net.res4_0.conv2.offset_conv.bias"])] == "offset_bias"
    assert (1 in frozen_stages) == (id(named["backbone_net.bn1.scale"]) not in in_group)
    assert (2 in frozen_stages) == (id(named["backbone_net.res2_0.bn3.bias"]) not in in_group)
    assert all(isinstance(m, layers.GroupNorm) for n, m in tm.backbone_net.named_modules()
               if n.endswith(("bn1", "bn2", "bn3", "shortcut_bn")))


def test_optimizer_steps_match_optax(params, rng):
    """Eight updates from shared random gradients, scaled so that the
    global-norm clip acts, through the warmup and a decay boundary with
    momentum, weight decay and every group: updated parameters within 1e-6
    of optax's (rtol and atol; the schedule is float64 in the port)."""
    sched = dict(lr=0.05, warmup_iteration=4, warmup_factor=1.0 / 3.0, decay_iteration=(6,),
                 decay_factor=0.1, grad_clip=35.0, wd=1e-2, dcn_offset_lr_mult=0.5)
    jcfg = gn_dcn_train(jax_default_config())
    jcfg = jcfg.replace(train=dataclasses.replace(jcfg.train, **sched))
    tcfg = gn_dcn_train(default_config())
    tcfg = tcfg.replace(train=dataclasses.replace(tcfg.train, **sched))
    tm = tup.build_model(tcfg, device="cpu")
    load_jax_params(tm, params)
    named = dict(tm.named_parameters())
    opt = toptim.make_optimizer(tcfg, tm)
    tx = joptim.make_optimizer(jcfg, params)
    jparams = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(jparams)

    @jax.jit
    def optax_step(grads, state, p):
        updates, state = tx.update(grads, state, p)
        return optax.apply_updates(p, updates), state

    trainable = _trainable_paths(tm, params)
    norms = []
    for step in range(8):
        grads = {}
        for path, leaf in _leaves(params):
            g = (rng.randn(*leaf.shape) * 50.0 * 0.05).astype(np.float32)
            grads[path] = g if path in trainable else np.zeros_like(g)
        norms.append(np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                                 for g in grads.values())))
        jg = _unflatten(grads)
        sd_grads = _as_state_dict(jg)
        for n, p in named.items():
            p.grad = sd_grads[n].clone() if p.requires_grad else None
        jparams, opt_state = optax_step(jax.tree.map(jnp.asarray, jg), opt_state, jparams)
        toptim.sgd_update(opt, tcfg, step)
        got = dict(_leaves(to_jax(tm.state_dict(), params)))
        for path, ref in _leaves(jax.device_get(jparams)):
            np.testing.assert_allclose(got[path], ref, rtol=1e-6, atol=1e-6,
                                       err_msg=f"step {step} {'.'.join(path)}")
    assert min(norms) > sched["grad_clip"]
    moved = dict(_leaves(to_jax(tm.state_dict(), params)))
    for path, leaf in _leaves(params):
        assert (path not in trainable) == np.array_equal(moved[path], leaf), path
