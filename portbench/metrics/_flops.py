"""Operations and bytes of the model, counted from the configuration's shapes.

Only convolutions and dense layers count as the model's operations (two per
multiply-add): the caffe ResNet (stride on each block's first 1x1, the
stride-2 stem and max pool), the FPN's laterals and output convs, the RPN
head on P2..P6, the FCN head's deformable convs on P2..P5 (each an offset
conv and a nine-tap GEMM) and its 1x1 score, the box head's four dense
layers on every padded proposal row, and the mask head's four 3x3 convs, its
2x2 deconv and its 1x1 on every detection slot. Sampling, RoIAlign, NMS,
pastes and resizes are not counted.

The published peaks of one H100 SXM (NVIDIA's data sheet, dense, at the
700 W limit): 989 TFLOP/s in bf16, 67 TFLOP/s in float32 outside the tensor
cores, 3.35 TB/s of HBM.
"""

from __future__ import annotations

BF16_FLOPS = 989e12
F32_FLOPS = 67e12
HBM_BYTES = 3.35e12
STAGE_BLOCKS = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3), "resnet_test": (1, 1, 1, 1)}
DTYPE_BYTES = {"bfloat16": 2, "float32": 4}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def conv(cin: int, cout: int, k: int, hw) -> float:
    return 2.0 * cin * cout * k * k * hw[0] * hw[1]


def dcn_layers(model: dict, bucket) -> list:
    """(cin, cout, (h, w)) of every deformable conv of one image's pass."""
    net = model["network"]
    out = []
    if net.get("backbone_with_dcn"):
        for stage, n in zip((2, 3, 4, 5), STAGE_BLOCKS[net["backbone"]]):
            if stage in net["dcn_stages"]:
                width = 64 * 2 ** (stage - 2)
                hw = (_cdiv(bucket[0], 2 ** stage), _cdiv(bucket[1], 2 ** stage))
                out += [(width, width, hw)] * n
    if net["fcn_with_dcn"]:
        for stride in (4, 8, 16, 32):
            hw = (_cdiv(bucket[0], stride), _cdiv(bucket[1], stride))
            for j in range(net["fcn_num_layers"]):
                out.append((net["fpn_feature_dim"] if j == 0 else net["fcn_head_dim"],
                            net["fcn_head_dim"], hw))
    return out


def dcn_flops(cin: int, cout: int, hw) -> tuple[float, float]:
    """(the nine-tap GEMM's, the float32 offset conv's) operations."""
    return conv(cin, cout, 3, hw), conv(cin, 18, 3, hw)


def dcn_least_s(model: dict, bucket, images: int) -> tuple[float, str]:
    """The least time of every deformable conv of ``images`` passes: x, the
    offsets and the weights read once, the output written once, against the
    GEMM at the compute precision's peak plus the offset conv at the float32
    peak (the program computes offsets in float32). Returns (seconds, the
    bound that applies)."""
    net = model["network"]
    xb = DTYPE_BYTES[net["compute_dtype"]]
    t_bytes = t_ops = 0.0
    for cin, cout, hw in dcn_layers(model, bucket):
        px = hw[0] * hw[1] * images
        n_bytes = px * (cin * xb + 18 * 4 + cout * xb) + (cout * cin * 9 + 18 * cin * 9) * 4
        gemm, off = dcn_flops(cin, cout, hw)
        peak = BF16_FLOPS if net["compute_dtype"] == "bfloat16" else F32_FLOPS
        t_bytes += n_bytes / HBM_BYTES
        t_ops += gemm * images / peak + off * images / F32_FLOPS
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def trunk_flops(model: dict, bucket) -> float:
    net = model["network"]
    h, w = bucket
    total = conv(3, 64, 7, (_cdiv(h, 2), _cdiv(w, 2)))
    cin = 64
    backbone_dcn = net.get("backbone_with_dcn")
    for stage, n in zip((2, 3, 4, 5), STAGE_BLOCKS[net["backbone"]]):
        width = 64 * 2 ** (stage - 2)
        hw = (_cdiv(h, 2 ** stage), _cdiv(w, 2 ** stage))
        for b in range(n):
            if b == 0:
                total += conv(cin, width * 4, 1, hw)
            total += conv(cin, width, 1, hw) + conv(width, width * 4, 1, hw)
            if backbone_dcn and stage in net["dcn_stages"]:
                total += sum(dcn_flops(width, width, hw))
            else:
                total += conv(width, width, 3, hw)
            cin = width * 4
    f = net["fpn_feature_dim"]
    for i, c in enumerate((256, 512, 1024, 2048)):
        hw = (_cdiv(h, 4 * 2 ** i), _cdiv(w, 4 * 2 ** i))
        total += conv(c, f, 1, hw) + conv(f, f, 3, hw)
    a = net["num_anchors"]
    for s in (4, 8, 16, 32, 64):
        hw = (_cdiv(h, s), _cdiv(w, s))
        total += conv(f, f, 3, hw) + conv(f, 6 * a, 1, hw)
    for stride in (4, 8, 16, 32):
        hw = (_cdiv(h, stride), _cdiv(w, stride))
        for j in range(net["fcn_num_layers"]):
            cin_ = f if j == 0 else net["fcn_head_dim"]
            cout = net["fcn_head_dim"]
            total += (sum(dcn_flops(cin_, cout, hw)) if net["fcn_with_dcn"]
                      else conv(cin_, cout, 3, hw))
    total += conv(4 * net["fcn_head_dim"], model["dataset"]["num_seg_classes"], 1,
                  (_cdiv(h, 4), _cdiv(w, 4)))
    return total


def head_flops(model: dict, rois: int, dets: int) -> float:
    net, ncls = model["network"], model["dataset"]["num_classes"]
    f, fc, pb = net["fpn_feature_dim"], net["rcnn_fc_dim"], net["pooled_size_box"]
    box = 2.0 * rois * (pb * pb * f * fc + fc * fc + fc * ncls + fc * 4 * ncls)
    pm = net["pooled_size_mask"]
    mask = dets * (conv(f, 256, 3, (pm, pm)) + 3 * conv(256, 256, 3, (pm, pm))
                   + 2.0 * 256 * 256 * 4 * pm * pm
                   + conv(256, ncls, 1, (2 * pm, 2 * pm)))
    return box + mask


def predict_flops(model: dict, bucket) -> float:
    """One image's ``forward_predict`` at ``bucket``."""
    t = model["test"]
    return trunk_flops(model, bucket) + head_flops(model, t["rpn_post_nms_top_n"], t["max_det"])


def frozen_flops(model: dict, bucket) -> tuple[float, float]:
    """(the forward operations of the layers that do not train, those of the
    lowest trained layers' input-side convs): the stem and, where stage 2 is
    frozen, res2; the first block of the next stage then needs no gradient
    of its input."""
    net = model["network"]
    h, w = bucket
    frozen = conv(3, 64, 7, (_cdiv(h, 2), _cdiv(w, 2))) if 1 in net["frozen_stages"] else 0.0
    if 2 not in net["frozen_stages"]:
        return frozen, 0.0
    hw = (_cdiv(h, 4), _cdiv(w, 4))
    cin = 64
    for b in range(STAGE_BLOCKS[net["backbone"]][0]):
        frozen += conv(cin, 64, 1, hw) + conv(64, 64, 3, hw) + conv(64, 256, 1, hw)
        frozen += conv(cin, 256, 1, hw) if b == 0 else 0.0
        cin = 256
    hw3 = (_cdiv(h, 8), _cdiv(w, 8))
    return frozen, conv(256, 128, 1, hw3) + conv(256, 512, 1, hw3)


def train_flops(model: dict, bucket) -> float:
    """One image's training step at ``bucket``: the forward (trunk, the box
    head on ``batch_rois`` rows, the mask head on the fg quarter of them and
    on the ``max_gt_instances`` GT boxes of the panoptic loss) and the
    backward, the weights' gradients of every trained layer and the inputs'
    gradients above the lowest trained layer, each as many operations as
    the layer's forward. A checkpointed trunk's recompute is not counted."""
    tc = model["train"]
    k_fg = int(tc["batch_rois"] * tc["fg_fraction"])
    fwd = trunk_flops(model, bucket) + head_flops(model, tc["batch_rois"], 0)
    fwd += head_flops(model, 0, k_fg + tc["max_gt_instances"])
    frozen, lowest = frozen_flops(model, bucket)
    return fwd + 2 * (fwd - frozen) - lowest
