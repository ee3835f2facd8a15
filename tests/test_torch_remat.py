"""``train.remat`` and ``train.remat_policy`` in the port
(``upsnet_torch/models/remat.py``) against the JAX package's
``jax.checkpoint`` around ``extract``.

  * one train step of the tiny model (8 DCN layers in the FCN head) from the
    same weights, batch and noise gives the same bits, losses, gradients and
    SGD update, without remat, under full remat and under ``save_dcn``, on
    each training route (``dcn_impl_train`` ``pallas``, ``gather`` and
    ``shift``, the last with every layer sent to the shift route); under
    ``auto`` with one layer's offsets beyond its window, the recompute takes
    each layer's coordinate derivative as the first forward did;
  * the sampling forwards, counted at their wrappers, run once per DCN layer
    and step without remat and under ``save_dcn``, twice under full remat;
  * under ``remat: True, remat_policy: save_dcn`` in both packages the loss
    dict matches JAX ``forward_train`` (rtol 1e-4) and the gradients
    ``jax.grad`` (1e-3 |ref| + 1e-4 max|ref leaf|), the tolerances of
    ``test_torch_train.py``;
  * the checkpoint is the non-reentrant one: no DCN layer takes its
    inference route (K1) in a checkpointed step, which the reentrant form,
    shown alongside, does;
  * a 2-rank DDP step under ``save_dcn`` matches the single-process step on
    the joined batch at ``test_torch_parallel.py``'s tolerances;
  * ``save_dcn`` runs no Python dispatch mode in the trunk; its store of
    sampled outputs is read back in the recompute and emptied by the
    backward, and freed with a graph dropped without one (also from a
    forward that raised), after which a step still gives the ``off`` step's
    bits; the step's bits are the same with the checkpoint's early stop on
    and off.
"""

import dataclasses
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

from test_torch_parallel import (
    B_RANK, WORLD, _assert_update_close, _ddp_rank, _joined_batch, _model, _params,
    _perturbed_state)
from test_torch_parallel import H as PH
from test_torch_parallel import W as PW
from test_torch_predict import H, W, perturbed_params
from test_torch_train import (
    BSZ, LOSS_KEYS, _batch, _jax_noise, _leaves, _t, _trainable_paths, tiny_train)
from upsnet_tpu.config import default_config as jax_default_config
from upsnet_tpu.models import upsnet as jup
from upsnet_torch.config import default_config
from upsnet_torch.convert.from_jax import load_jax_params, to_jax
from upsnet_torch.models import remat
from upsnet_torch.models import upsnet as tup
from upsnet_torch.ops import deform_conv, deform_sample, deform_shift, recompute
from upsnet_torch.ops.anchors import pyramid_anchors
from upsnet_torch.parallel.mesh import spawn_ranks
from upsnet_torch.train.optimizer import make_optimizer
from upsnet_torch.train.step import make_train_step

torch.set_num_threads(2)

POLICIES = {"off": (False, "save_dcn"), "full": (True, ""), "save_dcn": (True, "save_dcn")}
SAMPLERS = ((deform_sample, "deform_sample_taps"), (deform_sample, "deform_sample_tiled_taps"),
            (deform_shift, "shift_fwd"))
N_DCN = 8  # the tiny FCN head: 2 deformable layers at each of P2..P5


def _cfg(policy: str, impl: str = "pallas"):
    remat_on, name = POLICIES[policy]
    cfg = tiny_train(default_config())
    return cfg.replace(
        network=dataclasses.replace(cfg.network, dcn_impl="auto", dcn_impl_train=impl),
        train=dataclasses.replace(cfg.train, remat=remat_on, remat_policy=name))


@pytest.fixture
def sampling_calls(monkeypatch):
    """Counts of each sampling forward's wrapper calls (the dispatcher ops
    look their wrapper up at call time), and of K1's (the inference route)."""
    calls = {}

    def spy(module, name):
        real = getattr(module, name)
        calls[name] = 0

        def counted(*a, **kw):
            calls[name] += 1
            return real(*a, **kw)

        monkeypatch.setattr(module, name, counted)

    for module, name in SAMPLERS:
        spy(module, name)
    spy(deform_conv, "deform_sample9")
    return calls


def _one_step(cfg, state, batch, noise):
    """One train step from ``state``: (metrics, gradients, updated weights)."""
    model = tup.build_model(cfg, device="cpu")
    model.load_state_dict(state)
    anchors = tuple(torch.from_numpy(a) for a in pyramid_anchors((H, W)))
    step = make_train_step(model, cfg, anchors, make_optimizer(cfg, model))
    metrics = step({k: _t(v) for k, v in batch.items()}, {k: _t(v) for k, v in noise.items()})
    grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
    return metrics, grads, {n: p.detach().clone() for n, p in model.named_parameters()}


@pytest.fixture(scope="module")
def inputs():
    """Weights with O(1) activations and +-2 px offset biases, a batch and
    the JAX draws as noise (``test_torch_train.py``'s)."""
    cfg = _cfg("off")
    state = tup.build_model(cfg, device="cpu").state_dict()
    rng = np.random.RandomState(42)
    for k, v in state.items():
        if k.endswith("offset_conv.bias"):
            state[k] = torch.from_numpy(rng.uniform(-2, 2, v.shape).astype(np.float32))
        elif k.endswith(".scale"):
            state[k] = torch.from_numpy(rng.uniform(0.3, 0.6, v.shape).astype(np.float32))
    anchors = pyramid_anchors((H, W))
    n_anchors = sum(a.shape[0] for a in anchors)
    n_cand = cfg.train.rpn_post_nms_top_n + cfg.train.max_gt_instances
    _, noise = _jax_noise(jax.random.PRNGKey(5), n_anchors, n_cand, cfg.train.max_gt_instances)
    return state, _batch(cfg), noise


@pytest.mark.parametrize("impl", ["pallas", "gather", "shift"])
def test_the_three_policies_give_the_same_step_bits(inputs, impl, monkeypatch, sampling_calls):
    if impl == "shift":  # every layer on the shift route, as on the TPU at P2 and P3
        monkeypatch.setattr(deform_conv, "shift_route_ok", lambda *a, **kw: True)
    state, batch, noise = inputs
    runs = {p: _one_step(_cfg(p, impl), state, batch, noise) for p in POLICIES}
    (m_ref, g_ref, w_ref) = runs["off"]
    for policy, (m, g, w) in runs.items():
        assert m.keys() == m_ref.keys() and all(torch.equal(m[k], m_ref[k]) for k in m), policy
        assert g.keys() == g_ref.keys() and len(g) > 50
        assert all(torch.equal(g[n], g_ref[n]) for n in g), policy
        assert all(torch.equal(w[n], w_ref[n]) for n in w), policy
    used = "shift_fwd" if impl == "shift" else "deform_sample_taps"
    assert sampling_calls[used] == 4 * N_DCN  # off 8, full 16, save_dcn 8
    assert sampling_calls["deform_sample9"] == 0


def test_auto_takes_the_same_rule_in_the_recompute(inputs, monkeypatch):
    """``dcn_impl_train: auto`` decides each layer's coordinate derivative
    from a flag on the device, the JAX cond's predicate, computed from the
    layer's offsets. Offsets as shipped (zero, every sample on an integer
    coordinate, where the rules differ) but the FCN head's first DCN with
    one dy of 7 px, beyond the +-6 window: its backwards take ``floor``, the
    second DCN's the ``hat`` rule of its route. The recompute of a
    checkpointed step computes the flag again from the recomputed offsets,
    beside the store of sampled outputs, and must reach the same choice:
    under ``off``, ``full`` and ``save_dcn`` the backwards see the same
    rules and flags, in order, and the step gives the same bits."""
    state, batch, noise = inputs
    state = dict(state)
    for k, v in state.items():
        if k.endswith("offset_conv.bias"):
            state[k] = torch.zeros_like(v)
            if ".dcn1." in k:
                state[k][0] = 7.0
    real = deform_sample.deform_sample_bwd_unclipped
    seen = []

    def spy(y, sy, sx, g, rule="pallas", fast=None):
        seen.append((rule, None if fast is None else bool(fast)))
        return real(y, sy, sx, g, rule, fast)

    monkeypatch.setattr(deform_sample, "deform_sample_bwd_unclipped", spy)
    runs, choices = {}, {}
    for policy in POLICIES:
        seen.clear()
        runs[policy] = _one_step(_cfg(policy, "auto"), state, batch, noise)
        choices[policy] = list(seen)
    assert sorted(set(choices["off"])) == [("hat", False), ("hat", True)]
    assert len(choices["off"]) == N_DCN
    m_ref, g_ref, w_ref = runs["off"]
    for policy, (m, g, w) in runs.items():
        assert choices[policy] == choices["off"], policy
        assert all(torch.equal(m[k], m_ref[k]) for k in m), policy
        assert all(torch.equal(g[n], g_ref[n]) for n in g_ref), policy
        assert all(torch.equal(w[n], w_ref[n]) for n in w_ref), policy
    offset_grads = [g_ref[n] for n in g_ref if n.endswith("offset_conv.weight")]
    assert offset_grads and all(float(t.abs().max()) > 0 for t in offset_grads)


@pytest.mark.parametrize("policy,per_step", [("off", 1), ("full", 2), ("save_dcn", 1)])
def test_sampling_forwards_per_step(inputs, sampling_calls, policy, per_step):
    state, batch, noise = inputs
    _one_step(_cfg(policy), state, batch, noise)
    assert sampling_calls["deform_sample_taps"] == per_step * N_DCN
    assert sampling_calls["deform_sample_tiled_taps"] == sampling_calls["shift_fwd"] == 0


def test_save_dcn_matches_the_saved_outputs_not_a_rerun(inputs, monkeypatch):
    """Under ``save_dcn`` the recompute hands the forward's sampled outputs
    back: a sampler that gives other values on a second call would change a
    full-remat step, but not a ``save_dcn`` one."""
    state, batch, noise = inputs
    real = deform_sample.deform_sample_taps
    n = [0]

    def drifting(y, sy, sx):
        n[0] += 1
        out = real(y, sy, sx)
        return out if n[0] <= N_DCN else out * 2.0

    ref = _one_step(_cfg("off"), state, batch, noise)
    monkeypatch.setattr(deform_sample, "deform_sample_taps", drifting)
    saved = _one_step(_cfg("save_dcn"), state, batch, noise)
    assert n[0] == N_DCN
    assert all(torch.equal(saved[1][k], ref[1][k]) for k in ref[1])
    n[0] = 0
    full = _one_step(_cfg("full"), state, batch, noise)
    assert n[0] == 2 * N_DCN
    assert not all(torch.equal(full[1][k], ref[1][k]) for k in ref[1])


def test_checkpointed_steps_never_take_the_inference_route(inputs, sampling_calls, monkeypatch):
    state, batch, noise = inputs
    seen = []
    real_checkpoint = remat.checkpoint

    def recorded(fn, *a, **kw):
        seen.append(kw["use_reentrant"])
        return real_checkpoint(fn, *a, **kw)

    monkeypatch.setattr(remat, "checkpoint", recorded)
    for policy in ("full", "save_dcn"):
        _one_step(_cfg(policy), state, batch, noise)
    assert seen == [False, False]
    assert sampling_calls["deform_sample9"] == 0 and sampling_calls["deform_sample_taps"] == 24
    # the reentrant form runs its first forward without autograd: K1's route
    model = _model(_cfg("save_dcn"), state)
    x = _t(batch["images"]).permute(0, 3, 1, 2).contiguous()
    with pytest.warns(UserWarning, match="None of the inputs have requires_grad"):
        out = torch.utils.checkpoint.checkpoint(model.extract, x, use_reentrant=True)
    assert sampling_calls["deform_sample9"] == N_DCN
    assert not out[0][0].requires_grad  # and no parameter would get a gradient


@pytest.fixture(scope="module")
def jax_setup():
    """JAX ``forward_train`` and ``jax.grad`` with ``remat: True,
    remat_policy: save_dcn``, on ``test_torch_train.py``'s weights, batch
    and key."""
    jcfg = tiny_train(jax_default_config())
    jcfg = jcfg.replace(train=dataclasses.replace(jcfg.train, remat=True,
                                                  remat_policy="save_dcn"))
    tcfg = _cfg("save_dcn", "pallas")
    tcfg = tcfg.replace(network=dataclasses.replace(tcfg.network, dcn_impl="pallas",
                                                    dcn_impl_train=""))
    jm = jup.build_model(jcfg)
    params = perturbed_params(jax.jit(jm.init)(jax.random.PRNGKey(0),
                                               jnp.zeros((1, H, W, 3)))["params"])
    anchors = pyramid_anchors((H, W))
    janchors = tuple(jnp.asarray(a) for a in anchors)
    batch = _batch(tcfg)
    key = jax.random.PRNGKey(5)
    n_anchors = sum(a.shape[0] for a in anchors)
    n_cand = tcfg.train.rpn_post_nms_top_n + tcfg.train.max_gt_instances
    _, noise = _jax_noise(key, n_anchors, n_cand, tcfg.train.max_gt_instances)
    (_, jl), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jup.forward_train(jm, p, jcfg, janchors, b, key), has_aux=True))(
            params, {k: jnp.asarray(v) for k, v in batch.items()})
    tm = tup.build_model(tcfg, device="cpu")
    load_jax_params(tm, params)
    return dict(tcfg=tcfg, tm=tm, params=params, batch=batch, noise=noise,
                anchors=tuple(torch.from_numpy(a) for a in anchors),
                jlosses=jax.device_get(jl), jgrads=jax.device_get(jg))


def test_save_dcn_matches_jax_forward_train_and_grad(jax_setup):
    s = jax_setup
    tm = s["tm"]
    assert s["tcfg"].train.remat and s["tcfg"].train.remat_policy == "save_dcn"
    tm.zero_grad(set_to_none=True)
    total, losses = tup.forward_train(tm, s["tcfg"], s["anchors"],
                                      {k: _t(v) for k, v in s["batch"].items()},
                                      {k: _t(v) for k, v in s["noise"].items()})
    for k in LOSS_KEYS:
        np.testing.assert_allclose(float(losses[k].detach()), float(s["jlosses"][k]),
                                   rtol=1e-4, err_msg=k)
    total.backward()
    named = dict(tm.named_parameters())
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in named.items()}
    grads.update({n: torch.zeros_like(b) for n, b in tm.named_buffers()})
    got_tree = to_jax(grads, s["params"])
    trainable = _trainable_paths(tm, s["params"])
    ref_leaves = dict(_leaves(s["jgrads"]))
    checked = 0
    for path, got in _leaves(got_tree):
        if path not in trainable:
            continue
        ref = ref_leaves[path]
        scale = np.abs(ref).max()
        assert np.isfinite(got).all() and scale > 0, path
        np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4 * scale,
                                   err_msg=".".join(path))
        checked += 1
    assert checked == sum(p.requires_grad for p in named.values())
    assert BSZ == 2


def test_ddp_step_under_save_dcn_equals_the_joined_batch_step(tmp_path):
    cfg = _cfg("save_dcn")
    cfg = cfg.replace(network=dataclasses.replace(cfg.network, dcn_impl="pallas",
                                                  dcn_impl_train=""),
                      train=dataclasses.replace(cfg.train, grad_clip=1e6))
    assert (PH, PW) == (H, W)
    state = _perturbed_state(cfg)
    batch = _joined_batch(cfg)
    anchors = pyramid_anchors((H, W))
    n_anchors = sum(a.shape[0] for a in anchors)
    n_cand = cfg.train.rpn_post_nms_top_n + cfg.train.max_gt_instances
    rng = np.random.RandomState(3)
    noise = {k: rng.rand(WORLD * B_RANK, n).astype(np.float32) for k, n in (
        ("rpn_fg", n_anchors), ("rpn_bg", n_anchors), ("roi_fg", n_cand), ("roi_bg", n_cand),
        ("unknown", cfg.train.max_gt_instances))}
    ranks = spawn_ranks(_ddp_rank, WORLD, str(tmp_path / "init"), cfg, state, batch, noise,
                        timeout_s=240)
    model = _model(cfg, state)
    before = _params(model)
    step = make_train_step(model, cfg, tuple(torch.from_numpy(a) for a in anchors),
                           make_optimizer(cfg, model), torch.Generator().manual_seed(3))
    ref = step({k: torch.from_numpy(np.array(v)) for k, v in batch.items()},
               {k: torch.from_numpy(v) for k, v in noise.items()})
    ref_first = _params(model)
    (m0, first0, _, _), (m1, first1, _, _) = ranks
    assert m0 == m1
    for n in first0:
        assert np.array_equal(first0[n], first1[n]), n
    for k in (*LOSS_KEYS, "total"):
        np.testing.assert_allclose(m0[0][k], float(ref[k]), rtol=1e-4, err_msg=k)
    for n, p in before.items():
        _assert_update_close(first0[n], ref_first[n], p, n)


# ---------------------------------------------------------------------------
# ``save_dcn`` keeps the sampled outputs in a per-checkpoint store
# (``upsnet_torch/ops/recompute.py``), with no dispatch mode
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def off_step(inputs):
    state, batch, noise = inputs
    return _one_step(_cfg("off"), state, batch, noise)


def _assert_same_step(got, ref, what):
    (m, g, w), (m_ref, g_ref, w_ref) = got, ref
    assert m.keys() == m_ref.keys() and all(torch.equal(m[k], m_ref[k]) for k in m), what
    assert g.keys() == g_ref.keys() and all(torch.equal(g[n], g_ref[n]) for n in g), what
    assert all(torch.equal(w[n], w_ref[n]) for n in w), what


@pytest.fixture
def stores(monkeypatch):
    """Every ``SavedSamples`` store that ``save_dcn`` makes, by weak reference."""
    made = []

    class Recorded(recompute.SavedSamples):
        def __init__(self):
            super().__init__()
            made.append(weakref.ref(self))

    monkeypatch.setattr(remat, "SavedSamples", Recorded)
    return made


def test_no_dispatch_mode_runs_inside_the_trunk_under_save_dcn(inputs, monkeypatch):
    state, batch, noise = inputs
    seen = []

    def spy(module, name):
        real = getattr(module, name)

        def recorded(*a, **kw):
            seen.append((name, recompute.recomputing(), _get_current_dispatch_mode()))
            return real(*a, **kw)

        monkeypatch.setattr(module, name, recorded)

    spy(deform_sample, "deform_sample_taps")
    spy(deform_conv, "sample_coords")
    _one_step(_cfg("save_dcn"), state, batch, noise)
    assert [s for s in seen if s[0] == "deform_sample_taps"] == [
        ("deform_sample_taps", False, None)] * N_DCN
    coords = [s for s in seen if s[0] == "sample_coords"]
    assert coords == [("sample_coords", False, None)] * N_DCN + [
        ("sample_coords", True, None)] * N_DCN  # the first forward, then the recompute


def test_the_store_is_read_back_and_emptied_by_the_backward(inputs, off_step, stores):
    state, batch, noise = inputs
    kept = []
    real = recompute.sampled

    def watched(launch):
        out = real(launch)
        store = recompute._state.store
        kept.append((recompute.recomputing(), store.next, len(store.outs),
                     sum(o is not None for o in store.outs)))
        return out

    with pytest.MonkeyPatch.context() as mp:
        for module in (deform_sample, deform_shift):
            mp.setattr(module, "sampled", watched)
        _assert_same_step(_one_step(_cfg("save_dcn"), state, batch, noise), off_step,
                          "save_dcn")
    assert kept == [(False, 0, i + 1, i + 1) for i in range(N_DCN)] + [
        (True, i + 1, N_DCN, N_DCN - i - 1) for i in range(N_DCN)]
    assert len(stores) == 1
    store = stores[0]()
    assert store is None or (store.outs == [] and store.next == N_DCN)  # emptied
    gc.collect()
    assert stores[0]() is None  # freed with the step's graph
    assert getattr(recompute._state, "store", None) is None and not recompute.recomputing()


def _forward_train(cfg, state, batch, noise):
    model = tup.build_model(cfg, device="cpu")
    model.load_state_dict(state)
    anchors = tuple(torch.from_numpy(a) for a in pyramid_anchors((H, W)))
    return tup.forward_train(model, cfg, anchors, {k: _t(v) for k, v in batch.items()},
                             {k: _t(v) for k, v in noise.items()})


def test_a_forward_dropped_without_a_backward_leaves_nothing_behind(
        inputs, off_step, stores, monkeypatch):
    state, batch, noise = inputs
    total, losses = _forward_train(_cfg("save_dcn"), state, batch, noise)
    assert total.requires_grad and len(stores) == 1
    assert len(stores[0]().outs) == N_DCN and all(o is not None for o in stores[0]().outs)
    del total, losses
    gc.collect()
    assert stores[0]() is None
    # a step that raises in the middle of the trunk, with half the outputs kept
    real = deform_sample.deform_sample_taps
    n = [0]

    def failing(*a):
        n[0] += 1
        if n[0] > N_DCN // 2:
            raise RuntimeError("planted")
        return real(*a)

    monkeypatch.setattr(deform_sample, "deform_sample_taps", failing)
    with pytest.raises(RuntimeError, match="planted") as raised:
        _forward_train(_cfg("save_dcn"), state, batch, noise)
    del raised
    monkeypatch.setattr(deform_sample, "deform_sample_taps", real)
    gc.collect()
    assert len(stores) == 2 and stores[1]() is None
    assert getattr(recompute._state, "store", None) is None and not recompute.recomputing()
    _assert_same_step(_one_step(_cfg("save_dcn"), state, batch, noise), off_step,
                      "save_dcn after dropped graphs")


@pytest.mark.parametrize("early_stop", [True, False])
@pytest.mark.parametrize("policy,per_step", [("full", 2), ("save_dcn", 1)])
def test_early_stop_on_and_off_give_the_same_step(inputs, off_step, sampling_calls,
                                                  policy, per_step, early_stop):
    state, batch, noise = inputs
    with torch.utils.checkpoint.set_checkpoint_early_stop(early_stop):
        got = _one_step(_cfg(policy), state, batch, noise)
    _assert_same_step(got, off_step, f"{policy}, early stop {early_stop}")
    assert sampling_calls["deform_sample_taps"] == per_step * N_DCN
