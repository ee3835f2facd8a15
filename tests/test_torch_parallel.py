"""The port's data-parallel slice on the CPU: the process group
(``upsnet_torch/parallel/mesh.py``), the DDP train step
(``parallel/steps.py``), ``train`` and ``run_evaluation`` under a group,
and the row-slab fusion (``parallel/spatial.py``).

Multi-process cases spawn 2 gloo ranks that meet through a ``file://``
init under ``tmp_path`` (fixed TCP ports would collide under xdist), each
joined with a timeout (``spawn_ranks``), so a hung rank fails its test.
The rank functions import torch and the port only: JAX is imported inside
the tests that hold the port against it.

Gates:
  * one DDP step on 2 ranks of 2 images equals the single-process step on
    the joined batch of 4 (the same noise; then a second step drawn from
    the generator), and the JAX ``make_train_step`` on a 2-device mesh of
    the conftest's CPU devices: the loss dict at rtol 1e-4, the update of
    every leaf within the gradient tolerance of ``test_torch_train.py``
    (1e-3 |ref| + 1e-4 max|ref leaf|); the two ranks' weights bit-identical;
  * ``train`` on 2 ranks, then ``run_evaluation`` on 2 ranks: rank 0 alone
    writes ``metrics.jsonl`` and snapshots, both ranks hold the same weights,
    and the metrics exactly equal those of one process on those weights;
  * ``spatial_panoptic_fuse`` on 2 ranks bit-equal to ``panoptic_fuse`` and
    to the JAX ``spatial_panoptic_fuse``.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from upsnet_torch.config import default_config, load_config
from upsnet_torch.data.synthetic import SyntheticDataset, synthetic_batch
from upsnet_torch.evaluation.inference import run_evaluation
from upsnet_torch.models import upsnet as tup
from upsnet_torch.ops.anchors import pyramid_anchors
from upsnet_torch.parallel import steps as psteps
from upsnet_torch.parallel.mesh import Group, close_group, make_group, spawn_ranks
from upsnet_torch.parallel.spatial import spatial_panoptic_fuse
from upsnet_torch.train.optimizer import make_optimizer
from upsnet_torch.train.step import make_train_step
from upsnet_torch.train.trainer import train

torch.set_num_threads(2)

H, W = 64, 96
WORLD, B_RANK = 2, 2
LOSS_KEYS = ("rpn_cls", "rpn_bbox", "cls", "bbox", "mask", "seg", "pano")
TINY_YAML = "experiments/upsnet_tiny_synthetic.yaml"
TIMEOUT_S = 240


def tiny_train(cfg):
    """``test_torch_train.tiny_train``: resnet_test trunk, narrow widths,
    float32, ``dcn_impl: pallas``, 16 RoIs, 32 anchors, 4 GT slots."""
    return cfg.replace(
        network=dataclasses.replace(
            cfg.network, backbone="resnet_test", fpn_feature_dim=32, rcnn_fc_dim=64,
            fcn_head_dim=16, compute_dtype="float32", dcn_impl="pallas",
            dcn_boundary_grad="clip"),
        dataset=dataclasses.replace(cfg.dataset, num_classes=5, num_seg_classes=7,
                                    num_stuff=3),
        test=dataclasses.replace(cfg.test, rpn_pre_nms_top_n=64, rpn_post_nms_top_n=32,
                                 max_det=8, panoptic_score_thresh=0.0),
        train=dataclasses.replace(
            cfg.train, rpn_pre_nms_top_n=64, rpn_post_nms_top_n=32, batch_rois=16,
            rpn_batch_size=32, rpn_straddle_thresh=12.0, max_gt_instances=4, remat=False),
    )


def _perturbed_state(cfg):
    """The seeded model's weights with O(1) activations: frozen-BN scales in
    [0.3, 0.6] and fractional DCN offset biases within +-2 px."""
    rng = np.random.RandomState(42)
    state = tup.build_model(cfg, device="cpu").state_dict()
    for k, v in state.items():
        if k.endswith("offset_conv.bias"):
            state[k] = torch.from_numpy(rng.uniform(-2, 2, v.shape).astype(np.float32))
        elif k.endswith(".scale"):
            state[k] = torch.from_numpy(rng.uniform(0.3, 0.6, v.shape).astype(np.float32))
    return state


def _joined_batch(cfg):
    return synthetic_batch(cfg, (H, W), WORLD * B_RANK, 1, image_hw=(H - 4, W - 8))


def _rows(tree, lo, hi):
    return {k: torch.from_numpy(np.array(v[lo:hi])) for k, v in tree.items()}


def _model(cfg, state):
    model = tup.build_model(cfg, device="cpu")
    model.load_state_dict(state)
    return model


def _params(model):
    """Parameters as numpy copies (a rank returns numpy: a tensor handed to
    the parent by file descriptor would need its rank alive to be read)."""
    return {n: p.detach().numpy().copy() for n, p in model.named_parameters()}


# ------------------------------------------------------------------ ranks


def _ddp_rank(rank, world, init_file, cfg, state, batch, noise):
    """Two steps on this rank's rows: the first with the joined batch's
    ``noise``, the second drawn from a generator seeded 3. Also the
    saturation watch's reduction of per-rank probe statistics."""
    torch.set_num_threads(2)  # as the parent: CPU conv sums follow the thread count
    group = make_group(device="cpu", backend="gloo", init_method=f"file://{init_file}",
                       rank=rank, world_size=world)
    try:
        model = _model(cfg, state)
        opt = make_optimizer(cfg, model)
        anchors = tuple(torch.from_numpy(a) for a in pyramid_anchors((H, W)))
        step = psteps.make_train_step(psteps.wrap_model(model, cfg, group), cfg, anchors, opt,
                                      group, torch.Generator().manual_seed(3))
        mine = _rows(batch, rank * B_RANK, (rank + 1) * B_RANK)
        metrics = [step(mine, {k: torch.from_numpy(v) for k, v in noise.items()})]
        first = _params(model)
        metrics.append(step(mine))
        stats = group.max_stats({"a/dcn1": {"max_dy": 1.0 + rank, "max_dx": 5.0 - rank,
                                            "sat_frac": 0.25 * rank}})
        return ([{k: float(v) for k, v in m.items()} for m in metrics], first,
                _params(model), stats)
    finally:
        close_group(group)


def _train_eval_rank(rank, world, init_file, cfg, max_steps):
    """``train`` for ``max_steps`` iterations on 2 ranks, then
    ``run_evaluation`` on 2 ranks of the trained model."""
    torch.set_num_threads(2)  # as the parent: CPU conv sums follow the thread count
    group = make_group(device="cpu", backend="gloo", init_method=f"file://{init_file}",
                       rank=rank, world_size=world)
    try:
        model, history = train(cfg, SyntheticDataset(cfg, 8, training=True),
                               max_steps=max_steps, device="cpu", group=group)
        results = run_evaluation(cfg, SyntheticDataset(cfg, 4, training=False), model=model,
                                 group=group)
        return history, {k: v.numpy().copy() for k, v in model.state_dict().items()}, results
    finally:
        close_group(group)


def _fuse_rank(rank, world, init_file, seg, dets, kw):
    torch.set_num_threads(2)  # as the parent: CPU conv sums follow the thread count
    group = make_group(device="cpu", backend="gloo", init_method=f"file://{init_file}",
                       rank=rank, world_size=world)
    try:
        hs = seg.shape[0] // world
        slab = torch.from_numpy(seg[rank * hs:(rank + 1) * hs])
        pan, keep = spatial_panoptic_fuse(group, slab, *(torch.from_numpy(d) for d in dets),
                                          **kw)
        return pan.numpy(), keep.numpy()
    finally:
        close_group(group)


# ------------------------------------------------------------------ group


def test_world_of_one_makes_no_group(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    g = make_group(device="cpu")
    assert (g.rank, g.world, g.distributed, g.device) == (0, 1, False, torch.device("cpu"))
    t = torch.arange(3.0)
    assert g.all_reduce_sum(t) is t and g.gather_to_main(5) == [5]
    assert g.max_stats({"x": {"max_dy": 1.0}}) == {"x": {"max_dy": 1.0}}


def test_num_devices_caps_the_world(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "1")
    with pytest.raises(ValueError, match="num_devices=2"):
        make_group(num_devices=2, device="cpu")
    assert load_config("experiments/upsnet_resnet50_coco_16gpu.yaml").num_devices == 16


def test_a_rank_that_raises_fails_the_world():
    with pytest.raises(RuntimeError, match="rank 1"):
        spawn_ranks(_raise_on_rank_1, 2, timeout_s=60)


def _raise_on_rank_1(rank, world):
    if rank == 1:
        raise ValueError("boom")
    return rank


# ------------------------------------------------------------------ steps


def _jax_noise(key, bsz, n_anchors, n_cand, g):
    """The uniform draws of the JAX ``forward_train`` for ``key`` on a batch
    of ``bsz``, as the port's ``noise`` (``test_torch_train._jax_noise``)."""
    import jax

    keys = jax.random.split(key, (3, bsz))

    def pris(row, n):
        halves = [jax.random.split(k) for k in keys[row]]
        return (np.stack([np.asarray(jax.random.uniform(kf, (n,))) for kf, _ in halves]),
                np.stack([np.asarray(jax.random.uniform(kb, (n,))) for _, kb in halves]))

    rpn_fg, rpn_bg = pris(0, n_anchors)
    roi_fg, roi_bg = pris(1, n_cand)
    unknown = np.asarray(jax.random.uniform(jax.random.fold_in(key, 7), (bsz, g)))
    return {"rpn_fg": rpn_fg, "rpn_bg": rpn_bg, "roi_fg": roi_fg, "roi_bg": roi_bg,
            "unknown": unknown}


def _no_clip(cfg):
    """A gradient clip that does not engage: optax's global norm counts the
    gradients of the frozen stages, which the port does not compute
    (ROADMAP, "Decided and pinned"), so a clipped step differs by design."""
    return cfg.replace(train=dataclasses.replace(cfg.train, grad_clip=1e6))


def _assert_update_close(got, ref, before, name):
    """The gradient tolerance of ``test_torch_train.py`` on the update
    (1e-3 |ref| + 1e-4 max|ref leaf|), plus the float32 rounding of the
    updated weights themselves (two ulps of each weight)."""
    d_got, d_ref = got - before, ref - before
    bound = (1e-3 * np.abs(d_ref) + 1e-4 * np.abs(d_ref).max()
             + 2 * np.spacing(np.abs(before).astype(np.float32)))
    bad = np.abs(d_got - d_ref) > bound
    assert not bad.any(), (f"{name}: {bad.sum()} of {bad.size} updates off; worst "
                           f"{np.abs(d_got - d_ref)[bad].max():.3g}, max|update| "
                           f"{np.abs(d_ref).max():.3g}")


def test_ddp_step_equals_the_joined_batch_step_and_jax_mesh_step(tmp_path):
    import jax
    import jax.numpy as jnp

    from upsnet_tpu.config import default_config as jax_default_config
    from upsnet_tpu.models import upsnet as jup
    from upsnet_tpu.parallel.mesh import make_mesh
    from upsnet_tpu.parallel.steps import make_train_step as jax_make_train_step
    from upsnet_tpu.train import optimizer as joptim
    from upsnet_torch.convert.from_jax import to_jax

    cfg = _no_clip(tiny_train(default_config()))
    state = _perturbed_state(cfg)
    batch = _joined_batch(cfg)
    anchors = pyramid_anchors((H, W))
    n_anchors = sum(a.shape[0] for a in anchors)
    n_cand = cfg.train.rpn_post_nms_top_n + cfg.train.max_gt_instances
    key = jax.random.PRNGKey(5)
    noise = _jax_noise(key, WORLD * B_RANK, n_anchors, n_cand, cfg.train.max_gt_instances)

    ranks = spawn_ranks(_ddp_rank, WORLD, str(tmp_path / "init"), cfg, state, batch, noise,
                        timeout_s=TIMEOUT_S)

    # the single-process step on the joined batch, same noise, then drawn
    model = _model(cfg, state)
    before = _params(model)
    step = make_train_step(model, cfg, tuple(torch.from_numpy(a) for a in anchors),
                           make_optimizer(cfg, model), torch.Generator().manual_seed(3))
    joined = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    ref = [step(joined, {k: torch.from_numpy(v) for k, v in noise.items()})]
    ref_first = _params(model)
    ref.append(step(joined))

    (m0, first0, last0, stats0), (m1, first1, last1, stats1) = ranks
    assert m0 == m1
    for n in first0:  # the two ranks hold the same weights, bit for bit
        assert np.array_equal(first0[n], first1[n]) and np.array_equal(last0[n], last1[n]), n
    for i in range(2):
        for k in (*LOSS_KEYS, "total"):
            np.testing.assert_allclose(m0[i][k], float(ref[i][k]), rtol=1e-4,
                                       err_msg=f"step {i} {k}")
    trainable = {n for n, p in model.named_parameters() if p.requires_grad}
    for n, p in before.items():  # step 2 starts from weights that already differ
        _assert_update_close(first0[n], ref_first[n], p, n)
        assert (n in trainable) != np.array_equal(first0[n], p), n
    assert stats0 == stats1 == {"a/dcn1": {"max_dy": 2.0, "max_dx": 5.0, "sat_frac": 0.25}}

    # the JAX step on a 2-device mesh of the joined batch, with the same draws
    jcfg = _no_clip(tiny_train(jax_default_config()))
    jm = jup.build_model(jcfg)
    template = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(0),
                                               jnp.zeros((1, H, W, 3)))["params"])
    params = to_jax(state, template)
    tx = joptim.make_optimizer(jcfg, params)
    jstep = jax_make_train_step(jm, jcfg, tuple(jnp.asarray(a) for a in anchors), tx,
                                make_mesh(WORLD))
    jparams = jax.tree.map(jnp.asarray, params)
    new_params, _, jmetrics = jstep(jparams, tx.init(jparams),
                                    {k: jnp.asarray(v) for k, v in batch.items()}, key)
    for k in (*LOSS_KEYS, "total"):
        np.testing.assert_allclose(m0[0][k], float(jmetrics[k]), rtol=1e-4, err_msg=k)
    got = to_jax({**state, **{n: torch.from_numpy(v) for n, v in first0.items()}}, template)
    _compare_trees(got, jax.device_get(new_params), params)


def _compare_trees(got, ref, before, path=()):
    if isinstance(ref, dict):
        for k in ref:
            _compare_trees(got[k], ref[k], before[k], path + (k,))
        return
    _assert_update_close(np.asarray(got), np.asarray(ref), np.asarray(before), ".".join(path))


# ------------------------------------------------------- train and evaluate


def test_train_and_evaluate_under_a_group_equal_one_process(tmp_path):
    out = str(tmp_path / "out")
    cfg = load_config(TINY_YAML).replace(output_path=out)
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, batch_size=2, display_iter=1,
                                                snapshot_step=2))
    ranks = spawn_ranks(_train_eval_rank, WORLD, str(tmp_path / "init"), cfg, 2,
                        timeout_s=TIMEOUT_S)
    (h0, s0, r0), (h1, s1, r1) = ranks
    assert len(h0) == len(h1) == 2
    for a, b in zip(h0, h1):
        assert {k: a[k] for k in (*LOSS_KEYS, "total")} == {k: b[k] for k in (*LOSS_KEYS,
                                                                                "total")}
    for k in s0:
        assert np.array_equal(s0[k], s1[k]), k
    sym = os.path.join(out, cfg.symbol)
    with open(os.path.join(sym, "metrics.jsonl")) as f:
        lines = [json.loads(x) for x in f]
    assert [x["iter"] for x in lines] == [1, 2]  # rank 0 alone wrote
    assert sorted(os.listdir(os.path.join(sym, "checkpoints"))) == ["step_00000002"]

    model = tup.build_model(cfg, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in s0.items()})
    ref = run_evaluation(cfg, SyntheticDataset(cfg, 4, training=False), model=model)
    assert _same(r0, ref) and _same(r1, ref), (r0, ref)
    assert set(ref) == {"boxes", "masks", "ssegs", "panoptic"}


def _same(a, b) -> bool:
    """Equal nested results, NaN equal to NaN (an empty AP field is NaN)."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_same(a[k], b[k])
                                                                     for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b or (a != a and b != b)


# ----------------------------------------------------------- spatial fuse


def _fuse_inputs(rng, hq=32, wq=40, d=12, c=7):
    seg = rng.randn(hq, wq, c).astype(np.float32)
    x1 = rng.uniform(0, wq * 4 - 40, d)
    y1 = rng.uniform(0, hq * 4 - 40, d)
    boxes = np.stack([x1, y1, x1 + rng.uniform(8, 40, d), y1 + rng.uniform(8, 40, d)],
                     -1).astype(np.float32)
    boxes[2] = boxes[1] + 0.5  # overlapping masks, so MaskRemoval drops some
    classes = rng.randint(1, 5, d).astype(np.int64)
    masks = (rng.randn(d, 28, 28) * 3).astype(np.float32)
    scores = np.sort(rng.uniform(0, 1, d))[::-1].astype(np.float32).copy()
    valid = np.ones(d, bool)
    valid[-1] = False
    return seg, (boxes, classes, masks, scores, valid)


def test_spatial_fuse_equals_panoptic_fuse_and_jax(tmp_path, rng):
    import jax.numpy as jnp

    from upsnet_tpu.parallel.mesh import make_mesh
    from upsnet_tpu.parallel.spatial import spatial_panoptic_fuse as jax_spatial

    seg, dets = _fuse_inputs(rng)
    kw = dict(score_thresh=0.1, overlap_thresh=0.5, num_stuff=3)
    ranks = spawn_ranks(_fuse_rank, WORLD, str(tmp_path / "init"), seg, dets, kw,
                        timeout_s=TIMEOUT_S)
    pan = np.concatenate([p for p, _ in ranks], 0)
    keep = ranks[0][1]
    assert np.array_equal(keep, ranks[1][1])

    t = [torch.from_numpy(d)[None] for d in dets]
    ref_pan, ref_keep = tup.panoptic_fuse(torch.from_numpy(seg)[None], t[0], t[1], t[2],
                                          t[3], t[4], **kw)
    np.testing.assert_array_equal(pan, ref_pan[0].numpy())
    np.testing.assert_array_equal(keep, ref_keep[0].numpy())
    assert 0 < keep.sum() < keep.size - 1

    jpan, jkeep = jax_spatial(make_mesh(WORLD, spatial=WORLD), jnp.asarray(seg),
                              *(jnp.asarray(d) for d in dets), **kw)
    np.testing.assert_array_equal(pan, np.asarray(jpan))
    np.testing.assert_array_equal(keep, np.asarray(jkeep))


def test_spatial_fuse_on_one_rank_is_panoptic_fuse(rng):
    seg, dets = _fuse_inputs(rng, hq=24, wq=28, d=6)
    kw = dict(score_thresh=0.0, overlap_thresh=0.3, num_stuff=3)
    pan, keep = spatial_panoptic_fuse(Group(), torch.from_numpy(seg),
                                      *(torch.from_numpy(d) for d in dets), **kw)
    t = [torch.from_numpy(d)[None] for d in dets]
    ref_pan, ref_keep = tup.panoptic_fuse(torch.from_numpy(seg)[None], *t, **kw)
    assert torch.equal(pan, ref_pan[0]) and torch.equal(keep, ref_keep[0])
