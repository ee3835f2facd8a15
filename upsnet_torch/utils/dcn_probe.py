"""DCN offset-magnitude probe and the saturation watch of the train loop.

The port's copy of ``upsnet_tpu/utils/dcn_probe.py``. ``probe_dcn_offsets``
runs the trunk once and collects ``[max |dy|, max |dx|, saturation rate]``
of the raw offsets of every ``DeformConv`` (``models/layers.py``) through
forward hooks that live only as long as the probe: how far the learned
offsets reach is the evidence for whether a clipped route (``dcn_impl``
'pallas', 'mxu', 'shift') is exact for a checkpoint, and the trigger data of
``SaturationWatch``.

Usage:
    stats = probe_dcn_offsets(model, images)
    # {"fcn_head/subnet/dcn1": {"max_dy": 3.1, "max_dx": 4.7, "sat_frac": 0.0}, ...}
"""

from __future__ import annotations

import torch

from upsnet_torch.models.layers import DeformConv


def _dcn_layers(model):
    return [(name.replace(".", "/"), m) for name, m in model.named_modules()
            if isinstance(m, DeformConv)]


def _offset_stats(offsets: torch.Tensor, max_dy: float) -> torch.Tensor:
    """[max |dy|, max |dx|, share of offset components at >= 0.9 * max_dy]
    of raw offsets (B, 2K, H, W) with (dy, dx) interleaved, as the JAX layer
    sows them."""
    ody, odx = offsets[:, 0::2].abs(), offsets[:, 1::2].abs()
    edge = 0.9 * float(max_dy)
    return torch.stack([ody.max(), odx.max(), ((ody >= edge) | (odx >= edge)).float().mean()])


@torch.no_grad()
def probe_dcn_offsets(model, images) -> dict:
    """Run the dense trunk once on ``images`` (B, H, W, 3), preprocessed, and
    return {layer_path: {max_dy, max_dx, sat_frac}} of that run, the
    elementwise maximum over a layer's calls, layers never called left out.
    A forward hook on each layer's offset conv collects the numbers on the
    device; one device read for all layers."""
    layers = _dcn_layers(model)
    seen: dict = {}

    def recorder(path, max_dy):
        def hook(_module, _inputs, offsets):
            stat = _offset_stats(offsets, max_dy)
            seen[path] = torch.maximum(seen[path], stat) if path in seen else stat
        return hook

    hooks = []
    try:
        for path, m in layers:
            hooks.append(m.offset_conv.register_forward_hook(recorder(path, m.max_dy)))
        model.extract(images.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last))
    finally:
        for h in hooks:
            h.remove()
    paths = [path for path, _ in layers if path in seen]
    if not paths:
        return {}
    rows = torch.stack([seen[p].float() for p in paths]).cpu().tolist()
    return {path: {"max_dy": r[0], "max_dx": r[1], "sat_frac": r[2]}
            for path, r in zip(paths, rows)}


class SaturationWatch:
    """Sustained-saturation detector for the windowed DCN train impls.

    Feed it the per-layer offset stats every display interval. An interval
    counts as saturated when any layer's saturation rate (the fraction of
    offset components at >= 90% of the window) exceeds ``rate``, or when the
    raw offset maximum exceeds ``hard_mult * max_dy`` (raw divergence).
    Stats without a rate fall back to the max-based tripwire at
    ``frac * max_dy``, a twitchy statistic over about half a million offsets,
    which is why the rate exists. After ``patience`` consecutive saturated
    intervals the watch raises (action='fail') or returns a warning message
    (action='warn'). Gradient beyond the window is zero under
    boundary_grad='clip', so saturation is invisible in the loss curve: this
    is the loud failure in its place.
    """

    def __init__(self, max_dy: float, impl: str, boundary_grad: str,
                 action: str = "fail", frac: float = 0.9,
                 patience: int = 3, rate: float = 0.05,
                 hard_mult: float = 3.0):
        self.max_dy = float(max_dy)
        self.impl = impl
        self.boundary_grad = boundary_grad
        self.action = action
        self.limit = frac * float(max_dy)
        self.rate = rate
        self.hard_limit = hard_mult * float(max_dy)
        self.patience = patience
        self.streak = 0

    def _remedies(self) -> str:
        """Remedies that fit the active configuration: never the setting
        that is already active, and never 'straight_through', whose
        two-sided escape gradient is itself a divergence mechanism (see
        ``ops/deform_conv.py:clip_offsets``)."""
        opts = []
        if self.boundary_grad != "damped":
            opts.append(
                "set network.dcn_boundary_grad='damped' (inward-only "
                "escape gradient through the clip)"
            )
        opts.append(f"raise network.dcn_max_dy (currently {self.max_dy:g})")
        if self.impl != "gather":
            opts.append(
                "set network.dcn_impl_train='gather' (unbounded-exact, "
                "slower)"
            )
        return "; or ".join(opts)

    def update(self, stats: dict) -> tuple[dict, str | None]:
        """-> (metrics-entry fields, warning message or None); raises
        RuntimeError on sustained saturation when action='fail'."""
        if not stats:
            return {}, None
        max_dy = max(s["max_dy"] for s in stats.values())
        max_dx = max(s["max_dx"] for s in stats.values())
        fracs = [s["sat_frac"] for s in stats.values() if "sat_frac" in s]
        # the active impl and boundary_grad beside the magnitudes, so that a
        # metrics.jsonl stream describes itself
        entry = {
            "dcn_max_dy": max_dy,
            "dcn_max_dx": max_dx,
            "dcn_impl": self.impl,
            "dcn_boundary_grad": self.boundary_grad,
        }
        worst = max(max_dy, max_dx)
        if fracs:
            entry["dcn_sat_frac"] = max(fracs)
            saturated = (entry["dcn_sat_frac"] > self.rate
                         or worst > self.hard_limit)
        else:  # stats without a rate
            saturated = worst > self.limit
        self.streak = self.streak + 1 if saturated else 0
        if self.streak < self.patience:
            return entry, None
        cause = (
            " boundary_grad='straight_through' is the LIKELY CAUSE: its "
            "outward gradient component is fabricated (the clipped forward "
            "is constant beyond the window) and integrates without a "
            "restoring force — switch to 'damped'."
            if self.boundary_grad == "straight_through"
            else ""
        )
        if fracs:
            what = (
                f"{100 * entry['dcn_sat_frac']:.1f}% of offsets at >= 90% "
                f"of the +-{self.max_dy:g} window (max |dy| {max_dy:.2f}, "
                f"|dx| {max_dx:.2f}; trip: rate > {100 * self.rate:g}% or "
                f"max > {self.hard_limit:g})"
            )
        else:
            what = (
                f"max |dy| = {max_dy:.2f} > "
                f"{self.limit / self.max_dy:.1f} * {self.max_dy:g}"
            )
        desc = (
            f"DCN offsets saturating the train window: {what} "
            f"for {self.streak} consecutive display intervals (impl "
            f"'{self.impl}' clips with boundary_grad="
            f"'{self.boundary_grad}').{cause} Remedies: {self._remedies()}."
        )
        if self.action == "fail":
            raise RuntimeError(desc)
        self.streak = 0  # warn once per streak
        return entry, desc


def check_window(stats: dict, max_dy: float, max_dx: float | None = None,
                 logger=None) -> bool:
    """True iff every probed layer's offsets fit the window of a clipped
    route (``max_dx`` None: the routes that leave dx alone)."""
    ok = True
    for layer, s in sorted(stats.items()):
        layer_ok = s["max_dy"] <= max_dy and (
            max_dx is None or s["max_dx"] <= max_dx
        )
        ok &= layer_ok
        if logger:
            logger.info(
                "DCN offsets %-40s max|dy|=%.2f max|dx|=%.2f %s",
                layer, s["max_dy"], s["max_dx"],
                "in-window" if layer_ok else "BEYOND WINDOW",
            )
    return ok
