"""Evaluation cells under test-time augmentation (TTA): frames through the
program's ``upsnet_torch/evaluation/tta.py:predict_image_tta``, one image at
a time, back to back.

Set-up builds the model of the configuration through the program's registry,
loads the benchmark's weights (``weights.py``), makes the mix's frames from
the seed (``traffic/generator.py:scene``, uint8 BGR, as a decoded file) and
serves them from memory through a subclass of the program's own dataset
(``data/base.py:BaseDataset``), so that each variant's resize, flip and
canvas are the program's ``sample(i, target_scale=, hflip=)``. Each variant
runs ``predict_step`` with the full float32 semantic logits through the
program's ``evaluation/inference.py:sample_predictor``, as the evaluation
loop does (a copy of that loop's closure where a program has no such
function). The window then runs one image after another, each timed from its
first sample to its fused panoptic map on the host, until ``seconds`` have
passed.

The comparison's inputs are taken on the timed path, for the images that the
seed drew from the first ``check.pool`` (and for no other): the first
variant's intermediates through the hooks of ``predict.py`` (``Capture``),
every variant's sample and outputs as the program's predict returned them,
the merged evidence as the program hands it to ``fuse_tta`` (a wrapper, as
the hooks are), and the program's result. A traced run adds a steady stretch
of ``trace_requests`` images from the window's middle, run three times
(``predict.py:traced_stretch``), and the bytes that the program's
``read_bytes()`` counted in its untraced run, where the program counts them.

``step`` and ``i`` let ``sync_audit.py`` drive the cell one image at a time
(its branch for step-driven cells reads ``trace_steps`` from the mix).
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from portbench import weights as W
from portbench.drivers.predict import Capture, quiet_host, traced_stretch
from portbench.traffic.generator import request_order, scene

PREFIX = "tta."


def make_frames(mix: dict, num_things: int, num_stuff: int, seed: int) -> list:
    """The mix's ``pool`` frames (H, W, 3) uint8 BGR of size ``frame``, with
    thing counts spread evenly over ``instances`` (every seed the same
    multiset of counts, in its own order)."""
    rng = np.random.default_rng([int(seed), 0x7474])
    n = int(mix["pool"])
    counts = rng.permutation(np.rint(np.linspace(*mix["instances"], n)).astype(int))
    return [scene(rng, tuple(mix["frame"]), num_things, num_stuff, (int(c), int(c)),
                  int(mix.get("texture", 0)))[0] for c in counts]


def frames_dataset(cfg, frames: list):
    """The program's test-time dataset over frames held in memory."""
    from upsnet_torch.data.base import BaseDataset

    class Frames(BaseDataset):
        def __len__(self):
            return len(frames)

        def load_image(self, i: int) -> np.ndarray:
            return frames[i]

    return Frames(cfg, training=False)


def program_predictor(model, cfg):
    """The program's ``sample_predictor``, or, in a program without it, the
    evaluation loop's closure copied."""
    from upsnet_torch.evaluation import inference

    if hasattr(inference, "sample_predictor"):
        return inference.sample_predictor(model, cfg)
    dev = next(model.parameters()).device
    anchors = {tuple(b): inference.bucket_anchors(cfg, b, dev) for b in cfg.test.image_buckets}
    dtype = torch.bfloat16 if cfg.network.compute_dtype == "bfloat16" else torch.float32

    def predict(bucket, s, seg_argmax=True):
        batch = {"images": torch.from_numpy(s["images"][None]).to(dtype).to(dev),
                 "im_hw": torch.from_numpy(s["im_hw"][None]).to(dev)}
        out = inference.predict_step(model, cfg, anchors[bucket], batch, seg_argmax)
        return {k: v[0] for k, v in out.items()}

    return predict


def bytes_read():
    """The bytes the program has counted to the host, or None where it
    counts none."""
    from upsnet_torch.utils import profiling

    read = getattr(profiling, "read_bytes", None)
    return None if read is None else sum(read().values())


def malformed(r: dict, num_channels: int) -> bool:
    """An image whose merged detections are not finite or whose panoptic map
    holds a channel out of range."""
    return not (np.isfinite(r["boxes"]).all() and np.isfinite(r["scores"]).all()
                and np.isfinite(r["mask_logits"]).all() and int(r["pan_map"].min()) >= 0
                and int(r["pan_map"].max()) < num_channels)


class Cell:
    def __init__(self, conf: dict, mix: dict, seed: int, device):
        from upsnet_torch.config import default_config
        from upsnet_torch.config.loader import update_config
        from upsnet_torch.evaluation import tta
        from upsnet_torch.models import get_model
        from upsnet_torch.models import upsnet as upsnet_module

        self.conf, self.mix, self.seed, self.dev = conf, mix, seed, torch.device(device)
        self.cfg = cfg = update_config(default_config(), conf["model"])
        self.tta = tta
        self.model = get_model(cfg.symbol, cfg, device=self.dev)
        self.shapes = W.state_shapes(self.model)
        state = W.make_state(self.shapes, conf["weights"], seed, self.dev)
        self.model.load_state_dict(state)
        del state
        ds = cfg.dataset
        self.frames = make_frames(mix, ds.num_classes - 1, ds.num_stuff, seed)
        self.dataset = frames_dataset(cfg, self.frames)
        self.program_predict = program_predictor(self.model, cfg)
        self.num_channels = ds.num_stuff + cfg.test.max_det + 1
        check = mix["check"]
        rng = np.random.default_rng([int(seed), 0x6368])
        self.wanted = sorted(rng.choice(int(check["pool"]), int(check["requests"]),
                                        replace=False).tolist())
        self.order = request_order(mix, seed, 1 << 16)
        self.capture = Capture(self.model, upsnet_module, self.wanted)
        self.store, self.recording, self.i, self.timings = {}, None, 0, {}
        self.fuse_original = tta.fuse_tta

        def fuse(*args, **kw):
            if self.recording is not None:  # args: cfg, then the merged evidence
                self.recording["merged"] = dict(zip(
                    ("seg_logits", "boxes", "scores", "classes", "mask_logits"), args[1:6]))
            return self.fuse_original(*args, **kw)

        tta.fuse_tta = fuse
        canvases = []
        for _ in range(int(mix.get("warmup", 1))):
            self.image(int(self.order[0]), None, canvases)
        print("variants (target, flip): scale, content, canvas: " + "; ".join(
            f"{v}: {c}" for v, c in zip(tta.tta_variants(cfg), canvases)), file=sys.stderr)
        self._sync()

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def image(self, p: int, key, canvases=None, timings=None) -> dict:
        """Frame ``p`` through ``predict_image_tta``; where ``key`` is one of
        the sampled images, its comparison inputs are kept under it; where
        ``canvases`` is a list, each variant's scale, content size and
        canvas are appended to it; ``timings`` takes the program's own
        split of the image's host seconds."""
        rec = {"variants": []} if key in self.wanted else None
        self.recording = rec

        def predict(bucket, s):
            self.capture.begin(key if rec is not None and not rec["variants"] else -1)
            out = self.program_predict(bucket, s, False)
            if rec is not None:
                rec["variants"].append({"scale": float(s["scale"]), "im_hw": s["im_hw"],
                                        "bucket": tuple(bucket), "out": out})
            if canvases is not None:
                canvases.append((float(s["scale"]), tuple(int(v) for v in s["im_hw"]),
                                 tuple(bucket)))
            return out

        r = self.tta.predict_image_tta(self.cfg, self.dataset, p, predict, self.dev, timings)
        self.capture.begin(-1)
        self.recording = None
        if rec is not None:
            rec["result"] = r
            self.store[key] = (p, rec)
        return r

    def step(self) -> dict:
        """The next image of the window's order."""
        r = self.image(int(self.order[self.i]), self.i, timings=self.timings)
        self.i += 1
        return r

    def window(self, seconds: float, trace: bool) -> dict:
        lat, bad, images = [], 0, 0
        traced = None
        n_trace = int(self.mix["trace_requests"])
        quiet_host()
        start = time.perf_counter()
        end = start + seconds
        while time.perf_counter() < end:
            if trace and traced is None and time.perf_counter() >= start + seconds / 2:
                traced = self._traced(n_trace)
                images += 3 * n_trace
                continue
            t0 = time.perf_counter()
            r = self.step()
            lat.append(time.perf_counter() - t0)
            bad += malformed(r, self.num_channels)
            images += 1
        if trace and traced is None:  # a window too short to reach its middle
            traced = self._traced(n_trace)
            images += 3 * n_trace
        window_s = time.perf_counter() - start
        done = len(lat) + (n_trace if traced else 0)
        print("host ms an image, predict_image_tta's own split over the window's untraced "
              "images: " + ", ".join(f"{k} {1e3 * v / max(len(lat), 1):.1f}"
                                     for k, v in self.timings.items()), file=sys.stderr)
        for w in self.wanted:  # sampled images the window did not reach
            if w not in self.store:
                self.image(int(self.order[w]), w)
        peak = torch.cuda.max_memory_allocated(self.dev) if self.dev.type == "cuda" else 0
        return {"latencies_s": lat, "images": images, "window_s": window_s, "requests": done,
                "failed": bad, "memory_peak_bytes": peak, "outs": dict(self.store),
                "traced": traced, "prefix": PREFIX}

    def _traced(self, n: int) -> dict:
        """``n`` images from ``i`` on, three times (``traced_stretch``), none
        of them kept for the comparison; ``i`` then moves past them."""
        start, counted = self.i, []

        def work():
            b0 = bytes_read()
            for k in range(n):
                self.image(int(self.order[start + k]), None)
            b1 = bytes_read()
            counted.append(None if b0 is None else b1 - b0)

        out = traced_stretch(self.model, self.dev, work)
        self.i = start + n
        return dict(out, requests=n, steps=n, images=n, to_host_bytes=counted[0])

    def release(self):
        """Frees the program's state before the comparison runs."""
        self.capture.close()
        self.tta.fuse_tta = self.fuse_original
        del self.model, self.program_predict
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()


def _base_prog(cell: Cell, key: int, rec: dict) -> dict:
    """The first variant's captured intermediates and outputs, as the
    predict judge reads one image; its argmax map is taken here from the
    program's logits (the TTA path takes none)."""
    out = {k: v[None] for k, v in rec["variants"][0]["out"].items()}
    out["seg_pred_q"] = out["seg_logits"].argmax(-1)
    return cell.capture.per_image(key, out)[0]


def _prog_variants(cell: Cell, rec: dict) -> list:
    return [{"target": t, "flip": f, "scale": v["scale"], "bucket": v["bucket"],
             "im_hw": tuple(float(x) for x in v["im_hw"]), **v["out"]}
            for (t, f), v in zip(cell.tta.tta_variants(cell.cfg), rec["variants"])]


def _prog_merged(rec: dict) -> dict:
    merged, r = rec["merged"], rec["result"]
    return {**merged, "pan_map": r["pan_map"], "pan_keep": r["pan_keep"]}


def _judge_all(cell: Cell, ref, sides: list) -> dict:
    """The worst of each number over the sampled images. ``sides``: per image
    (frame, first variant's outputs and intermediates or None, variants,
    merged); the first variant's numbers where it is given."""
    from portbench.reference import tta_ref
    from portbench.reference.compare import NUMBERS, judge_image

    model = cell.conf["model"]
    worst = dict.fromkeys((NUMBERS if sides[0][1] is not None else ()) + tta_ref.NUMBERS, 0.0)
    for frame, base, variants, merged in sides:
        ref_outs = tta_ref.run_variants(ref, frame, model)
        b = ref_outs[0]
        numbers = {} if base is None else judge_image(ref, base, b["canvas"], b["im_hw"])
        numbers.update(tta_ref.judge_tta(ref_outs, variants, merged, model))
        for k, v in numbers.items():
            worst[k] = max(worst[k], v) if v == v else float("inf")
    return worst


def judge(cell: Cell, outs: dict) -> dict:
    """The comparison of the sampled images with the float32 reference, run
    after the program is freed, with the weights made again from the seed."""
    from portbench.reference.upsnet_ref import Ref, no_tf32

    no_tf32()
    sides = []
    for key, (p, rec) in sorted(outs.items()):
        frame = torch.from_numpy(cell.frames[p]).to(cell.dev)
        sides.append((frame, _base_prog(cell, key, rec), _prog_variants(cell, rec),
                      _prog_merged(rec)))
    cell.capture.store.clear()
    state = W.make_state(cell.shapes, cell.conf["weights"], cell.seed, cell.dev)
    return _judge_all(cell, Ref(cell.conf["model"], state), sides)


def controls(cell: Cell, outs: dict) -> dict:
    """The control and the fault, judged as the program is on the same
    images: ``control``, the float32 reference rounded through float8 in
    the program's place (its variants, merged and fused by the reference);
    ``drop_flip``, the program's own variants merged without the flipped
    ones (a merge that drops them), on the TTA numbers alone (its first
    variant is the program's)."""
    from portbench.reference import tta_ref
    from portbench.reference.upsnet_ref import Ref, no_tf32

    no_tf32()
    model = cell.conf["model"]
    state = W.make_state(cell.shapes, cell.conf["weights"], cell.seed, cell.dev)
    ref, low = Ref(model, state), Ref(model, state, fp8=True)
    control, fault = [], []
    for key, (p, rec) in sorted(outs.items()):
        frame = torch.from_numpy(cell.frames[p]).to(cell.dev)
        orig_hw = tuple(frame.shape[:2])
        low_outs = tta_ref.run_variants(low, frame, model)
        with torch.no_grad():
            b = low_outs[0]
            base = low.predict(b["canvas"], b["im_hw"])
        control.append((frame, base, low_outs, tta_ref.tta(low_outs, orig_hw, model)))
        variants = _prog_variants(cell, rec)
        unflipped = [v for v in variants if not v["flip"]]
        kept = tta_ref.tta(unflipped, orig_hw, model)
        fault.append((frame, None, variants,
                      {k: (v.cpu() if torch.is_tensor(v) else v) for k, v in kept.items()}))
    return {"control": _judge_all(cell, ref, control), "drop_flip": _judge_all(cell, ref, fault)}
