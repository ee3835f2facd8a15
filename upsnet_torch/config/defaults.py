"""Typed configuration tree of the PyTorch port.

The port's own copy of ``upsnet_tpu/config/defaults.py``: the same
dataclasses, field names and defaults, so one experiment description
configures both packages. Only the hyperparameter names of the reference's
easydict config (``upsnet/config/config.py`` in uber-research/UPSNet) and a
few static-shape fields appear here; see the JAX file for the history of
each choice.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Tuple


@dataclass
class NetworkConfig:
    backbone: str = "resnet50"  # resnet50 | resnet101 | resnet_test
    pretrained: str = ""
    fpn_feature_dim: int = 256
    backbone_with_dcn: bool = False
    dcn_stages: Tuple[int, ...] = (3, 4, 5)
    num_anchors: int = 3
    anchor_ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    anchor_scale: float = 8.0
    rpn_channels: int = 256
    rcnn_fc_dim: int = 1024
    pooled_size_box: int = 7
    pooled_size_mask: int = 14
    mask_size: int = 28
    roi_sampling_ratio: int = 2
    bbox_reg_weights: Tuple[float, ...] = (10.0, 10.0, 5.0, 5.0)
    fcn_head_dim: int = 128
    fcn_num_layers: int = 2
    fcn_with_dcn: bool = True
    fcn_shared_subnet: bool = True
    # 'auto' | 'gather': exact DCNv1 sampling at any offset.
    # 'pallas' | 'mxu': vertical offsets clamped to +-dcn_max_dy first (the
    # JAX package's windowed routes); the same sampling kernels afterwards.
    # 'shift': the fused 9-tap sampler with both axes clamped to
    # +-dcn_max_dy, on the layers where the JAX package's TPU route takes it
    # (fcn_head_dim a multiple of 128, level height a multiple of 8); the
    # other layers run as under 'pallas'. dcn_impl_train "" inherits dcn_impl.
    dcn_impl: str = "auto"
    dcn_impl_train: str = ""
    dcn_max_dy: int = 6
    dcn_boundary_grad: str = "clip"
    dcn_saturation_action: str = "fail"
    roi_align_impl: str = "window"
    norm: str = "frozen_bn"
    has_fcn_head: bool = True
    has_rpn: bool = True
    has_rcnn: bool = True
    has_mask_head: bool = True
    has_panoptic_head: bool = True
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    frozen_stages: Tuple[int, ...] = (1, 2)


@dataclass
class DatasetConfig:
    dataset: str = "coco"
    dataset_path: str = "data/coco"
    image_set: str = "train2017"
    test_image_set: str = "val2017"
    num_classes: int = 81  # things + background
    num_seg_classes: int = 133  # stuff + things
    num_stuff: int = 53  # leading semantic channels are stuff


@dataclass
class TrainConfig:
    scales: Tuple[int, ...] = (800,)
    max_size: int = 1333
    flip: bool = True
    batch_size: int = 1
    rpn_pre_nms_top_n: int = 2000
    rpn_post_nms_top_n: int = 1000
    rpn_nms_thresh: float = 0.7
    rpn_min_size: float = 0.0
    rpn_batch_size: int = 256
    rpn_fg_fraction: float = 0.5
    rpn_positive_overlap: float = 0.7
    rpn_negative_overlap: float = 0.3
    rpn_straddle_thresh: float = 0.0
    batch_rois: int = 512
    fg_fraction: float = 0.25
    fg_thresh: float = 0.5
    bg_thresh_hi: float = 0.5
    bg_thresh_lo: float = 0.0
    crowd_filter_thresh: float = 0.7
    max_crowd_instances: int = 8
    fcn_loss_weight: float = 0.2
    panoptic_loss_weight: float = 0.1
    fcn_with_roi_loss: bool = True
    fcn_roi_loss_weight: float = 1.0
    panoptic_box_keep_fraction: float = 0.7
    lr: float = 0.02
    momentum: float = 0.9
    wd: float = 1e-4
    grad_clip: float = 35.0
    dcn_offset_lr_mult: float = 1.0
    warmup_iteration: int = 500
    warmup_factor: float = 1.0 / 3.0
    max_iteration: int = 90000
    decay_iteration: Tuple[int, ...] = (60000, 80000)
    decay_factor: float = 0.1
    snapshot_step: int = 5000
    display_iter: int = 20
    resume: bool = False
    begin_iteration: int = 0
    remat: bool = True
    remat_policy: str = "save_dcn"
    image_buckets: Tuple[Tuple[int, int], ...] = ((832, 1344), (1344, 832))
    max_gt_instances: int = 100
    num_workers: int = 4
    sample_cache_mb: int = 0
    image_wire: str = "bf16"


@dataclass
class TestConfig:
    scales: Tuple[int, ...] = (800,)
    max_size: int = 1333
    batch_size: int = 1
    rpn_pre_nms_top_n: int = 1000  # per level
    rpn_post_nms_top_n: int = 1000
    rpn_nms_thresh: float = 0.7
    nms_thresh: float = 0.5  # per-class detection NMS
    score_thresh: float = 0.05
    max_det: int = 100
    # score-ranked candidate pool entering the joint class-offset NMS
    # (0 = all RoIs x classes)
    detection_nms_pool: int = 2048
    panoptic_score_thresh: float = 0.6
    panoptic_mask_overlap_thresh: float = 0.5
    panoptic_stuff_area_limit: int = 4096
    image_buckets: Tuple[Tuple[int, int], ...] = ((832, 1344), (1344, 832))
    multi_scale: Tuple[int, ...] = ()
    flip_test: bool = False


@dataclass
class Config:
    symbol: str = "resnet_50_upsnet"  # model registry key
    output_path: str = "output"
    num_devices: int = 0
    seed: int = 3407
    network: NetworkConfig = field(default_factory=NetworkConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    test: TestConfig = field(default_factory=TestConfig)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def default_config() -> Config:
    return Config()


def _coerce(value: Any, target: Any) -> Any:
    """Coerce a yaml value to the type of the dataclass default."""
    if isinstance(target, bool):
        return bool(value)
    if isinstance(target, int) and not isinstance(value, bool):
        return int(value)
    if isinstance(target, float):
        return float(value)
    if isinstance(target, tuple):
        if isinstance(value, (list, tuple)):
            return tuple(
                tuple(v) if isinstance(v, (list, tuple)) else v for v in value
            )
        return (value,)
    return value


def merge_into_dataclass(dc: Any, overrides: dict) -> Any:
    """Deep-merge a plain dict of overrides into a dataclass tree; keys that
    name no field are ignored (the reference's yamls carry extras)."""
    updates = {}
    names = {f.name for f in dataclasses.fields(dc)}
    for key, value in overrides.items():
        if key not in names:
            continue
        cur = getattr(dc, key)
        if dataclasses.is_dataclass(cur) and isinstance(value, dict):
            updates[key] = merge_into_dataclass(cur, value)
        else:
            updates[key] = _coerce(value, cur)
    return dataclasses.replace(dc, **updates)
