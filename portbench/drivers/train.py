"""Training cells: steps of ``upsnet_torch.train.step.make_train_step``.

Set-up builds the model of the configuration through the program's
registry, loads the benchmark's weights (``weights.py``), builds one
optimizer (``make_optimizer``) and one step function per image bucket over
it, as ``train/trainer.py:train`` does, and makes the mix's batches
(``traffic/generator.py:make_train_batches``) as pinned host tensors. Every
step gets its batch copied to the card and its sampling noise (the uniform
draws of ``forward_train``) drawn from a generator on the card seeded from
the seed; steps cycle the buckets in the mix's order.

The first steps of set-up are the ones the comparison follows: the first
three step the same objects the window then steps. Their seven losses, the
norm of each trainable tensor's first gradient (the optimizer's momentum
buffers after one step: the clipped gradient plus weight decay), the norm
of each tensor's change over the three steps, the proposals the program
drew (a wrapper around its ``pyramid_proposals``) and its RPN outputs (a
forward hook) are kept. Set-up then steps once more for every bucket not
yet seen, so that every shape of the window is warmed.

The window steps until ``seconds`` have passed, reading the losses every
``display_iter`` steps as ``IntervalLog`` does; a step whose seven terms
are not all finite counts as failed. A traced run runs ``trace_steps``
steps from the window's middle as ``predict.traced_stretch`` does: untraced
and timed, then in the profiler's warm-up and its recorded active phase,
with a ``portbench.dcn`` range around every deformable conv's forward.
"""

from __future__ import annotations

import time

import torch

from portbench import weights as W
from portbench.drivers.predict import quiet_host, traced_stretch
from portbench.traffic.generator import make_train_batches

PREFIX = "train."
LOSS_KEYS = ("rpn_cls", "rpn_bbox", "cls", "bbox", "mask", "seg", "pano")
CHECK_STEPS = 3


def _buffer_norm(optimizer, p) -> torch.Tensor:
    """The norm of ``p``'s momentum buffer; 0 where the optimizer holds none
    (no update was made)."""
    buf = optimizer.state.get(p, {}).get("momentum_buffer")
    return buf.norm() if buf is not None else torch.zeros((), device=p.device)


class Cell:
    def __init__(self, conf: dict, mix: dict, seed: int, device):
        from upsnet_torch.config import default_config
        from upsnet_torch.config.loader import update_config
        from upsnet_torch.evaluation.inference import bucket_anchors
        from upsnet_torch.models import get_model
        from upsnet_torch.models import upsnet as upsnet_module
        from upsnet_torch.train.optimizer import make_optimizer
        from upsnet_torch.train.step import make_train_step

        self.conf, self.mix, self.seed, self.dev = conf, mix, seed, torch.device(device)
        self.cfg = cfg = update_config(default_config(), conf["model"])
        self.model = get_model(cfg.symbol, cfg, device=self.dev)
        self.shapes = W.state_shapes(self.model)
        self.model.load_state_dict(W.make_state(self.shapes, conf["weights"], seed, self.dev))
        self.optimizer = make_optimizer(cfg, self.model)
        self.trainable = {n: p for n, p in self.model.named_parameters() if p.requires_grad}
        self.buckets = [tuple(b) for b in mix["buckets"]]
        self.steps, self.n_anchors = {}, {}
        for b in self.buckets:
            anchors = bucket_anchors(cfg, b, self.dev)
            self.steps[b] = make_train_step(self.model, cfg, anchors, self.optimizer)
            self.n_anchors[b] = sum(len(a) for a in anchors)
        ds = cfg.dataset
        pin = self.dev.type == "cuda"
        dtype = torch.bfloat16 if cfg.network.compute_dtype == "bfloat16" else torch.float32
        self.batches = {}
        for b, batches in make_train_batches(mix, ds.num_classes - 1, ds.num_stuff,
                                             cfg.train.max_gt_instances, seed).items():
            conv = []
            for batch in batches:
                t = {k: torch.from_numpy(v) for k, v in batch.items()}
                t["images"] = t["images"].to(dtype)
                conv.append({k: v.pin_memory() if pin else v for k, v in t.items()})
            self.batches[b] = conv
        self.gen = torch.Generator(device=self.dev).manual_seed(int(seed) % 2 ** 63 ^ 0x6e6f)
        self.record, self.check = None, []
        self._capture(upsnet_module)
        self.i = 0
        for k in range(CHECK_STEPS + len(self.buckets)):
            if k < CHECK_STEPS:
                self.record = {}
            self.step()
            if self.record is not None:
                self.check.append(self.record)
                self.record = None
            if k == 0:
                self.g1 = {n: _buffer_norm(self.optimizer, p) for n, p in self.trainable.items()}
            if k == CHECK_STEPS - 1:
                p0 = W.make_state(self.shapes, conf["weights"], seed, self.dev)
                self.dp = {n: (p.detach() - p0[n]).norm() for n, p in self.trainable.items()}
                del p0
        self._sync()

    def _capture(self, upsnet_module):
        self.module, self.original = upsnet_module, upsnet_module.pyramid_proposals

        def proposals(*a, **kw):
            out = self.original(*a, **kw)
            if self.record is not None:
                self.record["proposals"] = tuple(t.detach() for t in out)
            return out

        def rpn_hook(module, args, out):
            if self.record is not None and "rpn" not in self.record:
                self.record["rpn"] = ([t.detach() for t in out[0]], [t.detach() for t in out[1]])

        upsnet_module.pyramid_proposals = proposals
        self.hook = self.model.rpn.register_forward_hook(rpn_hook)

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def noise(self, bucket) -> dict:
        tc, b = self.cfg.train, int(self.mix["batch"])
        n_cand = tc.rpn_post_nms_top_n + tc.max_gt_instances
        shapes = {"rpn_fg": self.n_anchors[bucket], "rpn_bg": self.n_anchors[bucket],
                  "roi_fg": n_cand, "roi_bg": n_cand, "unknown": tc.max_gt_instances}
        return {k: torch.rand((b, n), device=self.dev, generator=self.gen)
                for k, n in shapes.items()}

    def step(self, at: int | None = None) -> dict:
        """Step ``at`` of the cycle over buckets and batches; the next one,
        moving the count on, when ``at`` is None."""
        k = self.i if at is None else at
        bucket = self.buckets[k % len(self.buckets)]
        pool = self.batches[bucket]
        host = pool[(k // len(self.buckets)) % len(pool)]
        batch = {k: v.to(self.dev, non_blocking=True) for k, v in host.items()}
        noise = self.noise(bucket)
        metrics = self.steps[bucket](batch, noise)
        if self.record is not None:
            self.record.update(bucket=bucket, batch=host, noise=noise,
                               losses={n: float(metrics[n]) for n in LOSS_KEYS})
        if at is None:
            self.i += 1
        return metrics

    def window(self, seconds: float, trace: bool) -> dict:
        display = max(int(self.cfg.train.display_iter), 1)
        n_trace, traced = int(self.mix["trace_steps"]), None
        bad = torch.zeros((), dtype=torch.int64, device=self.dev)
        steps = images = 0
        cuda = self.dev.type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats(self.dev)
        quiet_host()
        start = time.perf_counter()
        end = start + seconds
        while time.perf_counter() < end:
            if trace and traced is None and time.perf_counter() >= start + seconds / 2:
                traced = self._traced(n_trace)
                steps += 3 * n_trace
                images += 3 * n_trace * int(self.mix["batch"])
                continue
            m = self.step()
            bad += (~torch.isfinite(torch.stack([m[k] for k in LOSS_KEYS]))).any()
            steps += 1
            images += int(self.mix["batch"])
            if steps % display == 0:
                {k: float(v) for k, v in m.items()}  # the interval's read, a sync
        if trace and traced is None:  # a window too short to reach its middle
            traced = self._traced(n_trace)
            steps += 3 * n_trace
            images += 3 * n_trace * int(self.mix["batch"])
        self._sync()
        window_s = time.perf_counter() - start
        peak = torch.cuda.max_memory_allocated(self.dev) if cuda else 0
        return {"latencies_s": [], "images": images, "steps": steps, "window_s": window_s,
                "requests": steps, "failed": int(bad), "memory_peak_bytes": peak,
                "outs": self.check, "traced": traced, "prefix": PREFIX,
                "other_thread": ("train.backward",)}

    def _traced(self, n: int) -> dict:
        """``n`` steps from the current one, run as ``traced_stretch`` runs
        them: the same steps (batches and buckets) each time, the step count
        then moved on by ``n``."""
        i0 = self.i
        buckets = [self.buckets[(i0 + k) % len(self.buckets)] for k in range(n)]

        def work():
            for k in range(n):
                self.step(at=i0 + k)

        traced = traced_stretch(self.model, self.dev, work)
        self.i = i0 + n
        return dict(traced, requests=n, steps=n, images=n * int(self.mix["batch"]),
                    buckets=buckets)

    def release(self):
        self.hook.remove()
        self.module.pyramid_proposals = self.original
        self.g1 = {n: float(v) for n, v in self.g1.items()}
        self.dp = {n: float(v) for n, v in self.dp.items()}
        del self.model, self.optimizer, self.steps, self.trainable
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()


def judge(cell: Cell, outs: list) -> dict:
    """The first three steps against the float32 reference's, run after the
    program is freed from the weights made again from the seed."""
    from portbench.reference.compare import judge_train
    from portbench.reference.upsnet_ref import no_tf32

    no_tf32()
    state = W.make_state(cell.shapes, cell.conf["weights"], cell.seed, cell.dev)
    return judge_train(cell.conf["model"], state, outs, cell.g1, cell.dp, cell.dev)


def controls(cell: Cell, outs: list) -> dict:
    """Numbers that set the limits' upper readings, each against the float32
    reference's three steps: the reference rounded through float8 in the
    program's place ("control"), and the reference keeping half of each
    batch, the mean taken over the rest ("half_batch"). Both follow the
    program's proposals, as the judged reference does. A step that returns
    its state unchanged reads 1 on ``update_err`` by that number's measure
    and needs no run."""
    from portbench.reference.compare import train_numbers, train_run
    from portbench.reference.upsnet_ref import no_tf32

    no_tf32()
    state = W.make_state(cell.shapes, cell.conf["weights"], cell.seed, cell.dev)
    model = cell.conf["model"]
    ref = train_run(model, state, outs, cell.dev)
    half = int(cell.mix["batch"]) // 2
    return {"control": train_numbers(train_run(model, state, outs, cell.dev, fp8=True), ref),
            "half_batch": train_numbers(train_run(model, state, outs, cell.dev, images=half), ref)}
