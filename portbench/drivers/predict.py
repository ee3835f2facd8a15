"""Inference cells: requests through ``upsnet_torch.evaluation.inference.
predict_step`` in a closed loop.

Set-up builds the model of the configuration through the program's registry,
loads the benchmark's weights (``weights.py``), makes the mix's requests
(``traffic/generator.py``) as pinned host tensors, and warms up the canvas
with two requests. The window then sends one request after another, each
timed from its submission (the copy of its images to the card included) to
its outputs on the host, until ``seconds`` have passed; the window ends with
the last request's outputs.

The comparison's inputs are taken on the timed path: forward hooks on the
model's FPN, RPN, FCN head and box head, and a wrapper around the program's
``pyramid_proposals``, keep their outputs for the requests that the seed
drew for the check (from the first ``check.pool`` requests) and for no
other; a window too short to reach one of them sends it after its close.
In a traced run a steady stretch of ``trace_requests`` requests from the
window's middle runs three times (``traced_stretch``): untraced, timed on
the host clock; under the profiler's warm-up, which takes its start-up; and
under its active phase, recorded, with a ``portbench.dcn`` range around
every deformable conv (hooks from this file, not the program).
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch
from torch.profiler import record_function

from portbench import weights as W
from portbench.metrics._profile import DCN_RANGE
from portbench.traffic.generator import make_requests, request_order

PREFIX = "predict."


def quiet_host() -> None:
    """Before a window: one intra-op thread (the host only dispatches), and
    set-up's objects moved out of the garbage collector's reach
    (``gc.freeze``), so that a collection in the window walks only what the
    window made."""
    torch.set_num_threads(1)
    gc.collect()
    gc.freeze()


class Capture:
    """Keeps the intermediates of the requests whose index is in ``wanted``."""

    def __init__(self, model, upsnet_module, wanted):
        self.wanted, self.active, self.store, self.handles = set(wanted), None, {}, []
        for name in ("fpn", "rpn", "fcn_head", "box_head"):
            self.handles.append(getattr(model, name).register_forward_hook(self._hook(name)))
        self.module = upsnet_module
        self.original = upsnet_module.pyramid_proposals

        def proposals(*a, **kw):
            out = self.original(*a, **kw)
            if self.active is not None:
                self.store[self.active]["proposals"] = out
            return out

        upsnet_module.pyramid_proposals = proposals

    def _hook(self, name):
        def hook(module, args, out):
            if self.active is not None:
                self.store[self.active][name] = out
        return hook

    def begin(self, i: int):
        self.active = i if i in self.wanted else None
        if self.active is not None:
            self.store[i] = {}

    def close(self):
        for h in self.handles:
            h.remove()
        self.module.pyramid_proposals = self.original

    def per_image(self, i: int, out: dict) -> list:
        """The captured and returned values of request ``i``, one dict an image."""
        s = self.store[i]
        fpn, (rpn_cls, rpn_bbox), (seg, _) = s["fpn"], s["rpn"], s["fcn_head"]
        rois, roi_scores, roi_valid = s["proposals"]
        box_cls, box_bbox = s["box_head"]
        b, r = rois.shape[:2]
        res = []
        for j in range(b):
            res.append({
                "fpn": [p[j:j + 1] for p in fpn],
                "rpn_cls": [c[j:j + 1] for c in rpn_cls],
                "rpn_bbox": [c[j:j + 1] for c in rpn_bbox],
                "seg_logits": seg[j].permute(1, 2, 0),
                "rois": rois[j], "roi_scores": roi_scores[j], "roi_valid": roi_valid[j],
                "box_cls": box_cls[j * r:(j + 1) * r], "box_bbox": box_bbox[j * r:(j + 1) * r],
                **{k: torch.from_numpy(np.asarray(out[k][j])) for k in (
                    "boxes", "scores", "classes", "det_valid", "mask_logits", "seg_pred_q",
                    "pan_map", "pan_keep")},
            })
        return res


def dcn_ranges(model) -> list:
    """A ``portbench.dcn`` profiler range around every deformable conv's
    forward. Returns the hook handles."""
    from upsnet_torch.models.layers import DeformConv

    handles = []
    for m in model.modules():
        if isinstance(m, DeformConv):
            def pre(mod, args):
                mod._portbench_range = record_function(DCN_RANGE)
                mod._portbench_range.__enter__()

            def post(mod, args, out):
                mod._portbench_range.__exit__(None, None, None)

            handles += [m.register_forward_pre_hook(pre), m.register_forward_hook(post)]
    return handles


def traced_stretch(model, dev, work) -> dict:
    """Runs ``work`` (a stretch of requests or steps) three times: untraced,
    timed on the host clock (``untraced_s``: the clock that the idle share
    and the peak shares divide by, free of the profiler's cost per op); then
    under ``torch.profiler``'s schedule, once in its warm-up, which takes the
    profiler's start-up and records nothing, and once in its active phase,
    recorded and timed (``wall_s``). Returns the active phase's events too."""
    from torch.profiler import ProfilerActivity, profile, schedule

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    sync()
    t0 = time.perf_counter()
    work()
    sync()
    untraced = time.perf_counter() - t0
    handles = dcn_ranges(model)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    try:
        with profile(activities=acts,
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            work()
            sync()
            prof.step()
            t0 = time.perf_counter()
            work()
            sync()
            wall = time.perf_counter() - t0
            prof.step()
    finally:
        for h in handles:
            h.remove()
    return {"events": prof.events(), "wall_s": wall, "untraced_s": untraced}


def malformed(out: dict, num_channels: int) -> bool:
    """Whether an image of a request came back not well formed: a non-finite
    kept box, score or mask logit, or a map index out of range. Such a
    request counts as failed."""
    for j in range(len(out["boxes"])):
        v = out["det_valid"][j]
        if not (np.isfinite(out["boxes"][j][v]).all() and np.isfinite(out["scores"][j][v]).all()
                and np.isfinite(out["mask_logits"][j][v]).all()
                and int(out["pan_map"][j].max()) < num_channels):
            return True
    return False


class Cell:
    def __init__(self, conf: dict, mix: dict, seed: int, device):
        from upsnet_torch.config import default_config
        from upsnet_torch.config.loader import update_config
        from upsnet_torch.evaluation.inference import bucket_anchors, predict_step
        from upsnet_torch.models import get_model
        from upsnet_torch.models import upsnet as upsnet_module

        self.conf, self.mix, self.seed, self.dev = conf, mix, seed, torch.device(device)
        self.cfg = cfg = update_config(default_config(), conf["model"])
        self.predict_step = predict_step
        self.model = get_model(cfg.symbol, cfg, device=self.dev)
        self.shapes = W.state_shapes(self.model)
        state = W.make_state(self.shapes, conf["weights"], seed, self.dev)
        self.model.load_state_dict(state)
        del state
        self.anchors = bucket_anchors(cfg, tuple(mix["bucket"]), self.dev)
        ds = cfg.dataset
        images, im_hw = make_requests(mix, ds.num_classes - 1, ds.num_stuff, seed)
        dtype = torch.bfloat16 if cfg.network.compute_dtype == "bfloat16" else torch.float32
        pin = self.dev.type == "cuda"
        self.images = [torch.from_numpy(x).to(dtype) for x in images]
        self.images = [x.pin_memory() if pin else x for x in self.images]
        self.im_hw = [torch.from_numpy(x) for x in im_hw]
        self.num_channels = ds.num_stuff + cfg.test.max_det + 1
        check = mix["check"]
        rng = np.random.default_rng([int(seed), 0x6368])
        self.wanted = sorted(rng.choice(int(check["pool"]), int(check["requests"]),
                                        replace=False).tolist())
        self.capture = Capture(self.model, upsnet_module, self.wanted)
        for k in range(int(mix.get("warmup", 2))):
            self.request(k % len(self.images))
        self._sync()

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def request(self, p: int) -> dict:
        batch = {"images": self.images[p].to(self.dev, non_blocking=True),
                 "im_hw": self.im_hw[p].to(self.dev, non_blocking=True)}
        return self.predict_step(self.model, self.cfg, self.anchors, batch)

    def window(self, seconds: float, trace: bool) -> dict:
        order = request_order(self.mix, self.seed, 1 << 16)
        lat, outs, bad, images = [], {}, 0, 0
        traced = None
        n_trace = int(self.mix["trace_requests"])
        quiet_host()
        start = time.perf_counter()
        end = start + seconds
        i = 0
        while time.perf_counter() < end:
            if trace and traced is None and time.perf_counter() >= start + seconds / 2:
                traced = self._traced(order[i:i + n_trace])
                i += n_trace
                images += 3 * n_trace * int(self.mix["batch"])
                continue
            self.capture.begin(i)
            t0 = time.perf_counter()
            out = self.request(int(order[i]))
            lat.append(time.perf_counter() - t0)
            if i in self.capture.store:
                outs[i] = (int(order[i]), out)
            bad += malformed(out, self.num_channels)
            images += len(out["boxes"])
            i += 1
        if trace and traced is None:  # a window too short to reach its middle
            traced = self._traced(order[i:i + n_trace])
            i += n_trace
            images += 3 * n_trace * int(self.mix["batch"])
        window_s = time.perf_counter() - start
        done = i
        while any(w >= i for w in self.wanted):  # sampled requests the window did not reach
            self.capture.begin(i)
            outs[i] = (int(order[i]), self.request(int(order[i])))
            i += 1
        self.capture.begin(-1)
        peak = torch.cuda.max_memory_allocated(self.dev) if self.dev.type == "cuda" else 0
        return {"latencies_s": lat, "images": images, "window_s": window_s, "requests": done,
                "failed": bad, "memory_peak_bytes": peak, "outs": outs, "traced": traced,
                "prefix": PREFIX}

    def _traced(self, pool_ids) -> dict:
        def work():
            for p in pool_ids:
                self.request(int(p))

        return dict(traced_stretch(self.model, self.dev, work), requests=len(pool_ids),
                    images=len(pool_ids) * int(self.mix["batch"]))

    def release(self):
        """Frees the program's state before the comparison runs."""
        self.capture.close()
        del self.model
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()


def judge(cell: Cell, outs: dict) -> dict:
    """The comparison of the captured requests with the float32 reference,
    run after the program is freed, with the weights made again from the seed."""
    from portbench.reference.compare import judge as judge_all
    from portbench.reference.upsnet_ref import Ref, no_tf32

    no_tf32()
    progs, images, hws = [], [], []
    for i, (p, out) in sorted(outs.items()):
        per = cell.capture.per_image(i, out)
        for j, prog in enumerate(per):
            progs.append(prog)
            images.append(cell.images[p][j].to(cell.dev).float())
            hws.append(tuple(float(v) for v in cell.im_hw[p][j]))
    cell.capture.store.clear()
    state = W.make_state(cell.shapes, cell.conf["weights"], cell.seed, cell.dev)
    ref = Ref(cell.conf["model"], state)
    return judge_all(ref, progs, images, hws)


def controls(cell: Cell, outs: dict) -> dict:
    """The control's numbers: the float32 reference rounded through float8
    in the program's place on the requests the seed sampled, judged as the
    program is."""
    from portbench.reference.compare import judge as judge_all
    from portbench.reference.upsnet_ref import Ref, no_tf32

    no_tf32()
    order = request_order(cell.mix, cell.seed, max(cell.wanted) + 1)
    state = W.make_state(cell.shapes, cell.conf["weights"], cell.seed, cell.dev)
    low = Ref(cell.conf["model"], state, fp8=True)
    progs, images, hws = [], [], []
    with torch.no_grad():
        for i in cell.wanted:
            p = int(order[i])
            for j in range(len(cell.images[p])):
                img = cell.images[p][j].to(cell.dev).float()
                hw = tuple(float(v) for v in cell.im_hw[p][j])
                progs.append(low.predict(img, hw))
                images.append(img)
                hws.append(hw)
    return {"control": judge_all(Ref(cell.conf["model"], state), progs, images, hws)}
