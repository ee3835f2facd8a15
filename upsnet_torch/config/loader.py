"""YAML experiment-config loader.

The port's own copy of ``upsnet_tpu/config/loader.py``. It reads both the
native schema (keys are the dataclass fields of ``defaults.py``) and the
reference's experiment-yaml schema (uber-research/UPSNet
``upsnet/experiments/*.yaml``, read there by ``upsnet/config/config.py:
update_config``), so one file configures both packages the same way.
"""

from __future__ import annotations

import yaml

from upsnet_torch.config.defaults import Config, default_config, merge_into_dataclass

# Reference-yaml key -> native dotted key, for the keys whose names differ;
# None drops the key.
_REFERENCE_KEY_ALIASES = {
    "gpus": "num_devices",
    "train.warmup_iters": "train.warmup_iteration",
    "train.warmup_step": "train.warmup_iteration",
    "test.max_per_image": "test.max_det",
    "test.score_thresh": "test.score_thresh",
    "test.panoptic_stuff_area_limit": "test.panoptic_stuff_area_limit",
    "network.image_stride": None,  # canvases are padded to image_buckets instead
    "network.pixel_means": None,  # fixed caffe means
}


def _flatten(d: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in d.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "."))
        else:
            out[key] = v
    return out


def _unflatten(d: dict) -> dict:
    out: dict = {}
    for k, v in d.items():
        parts = k.split(".")
        cur = out
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = v
    return out


def _normalize_reference_keys(raw: dict) -> dict:
    flat = _flatten(raw)
    normalized = {}
    for key, value in flat.items():
        alias = _REFERENCE_KEY_ALIASES.get(key, key)
        if alias is None:
            continue
        if key == "gpus" and isinstance(value, str):
            # reference style: gpus: '0,1,2,3'
            value = len([g for g in value.split(",") if g != ""])
        normalized[alias] = value
    return _unflatten(normalized)


def update_config(cfg: Config, overrides: dict) -> Config:
    """Deep-merge a dict (native or reference schema) into a Config."""
    return merge_into_dataclass(cfg, _normalize_reference_keys(overrides))


def load_config(yaml_path: str, base: Config | None = None) -> Config:
    """The Config of the yaml file at ``yaml_path`` merged into ``base``
    (default: ``default_config()``)."""
    with open(yaml_path) as f:
        raw = yaml.safe_load(f) or {}
    cfg = base if base is not None else default_config()
    return update_config(cfg, raw)
