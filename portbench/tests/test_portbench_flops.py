"""The FLOP counter of ``metrics/_flops.py`` against PyTorch's
``FlopCounterMode`` on the program's CPU path at a tiny size.

They count the same work in different places. The counter takes every
convolution and dense layer from the configuration's shapes, the deformable
convs as an offset conv plus a nine-tap GEMM; FlopCounterMode takes the
deformable convs' GEMM as the ``mm`` of the program's side-by-side
projection (inside ``FCNHead.subnet``), and it also counts the matmuls of
the FCN head's bilinear upsample and of the mask paste, which are resizes
and not the model's operations: the counter leaves them out."""

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import weights as W
from portbench.metrics import _flops
from portbench.tests.tiny import tiny_config


def test_predict_flops_match_flop_counter_mode():
    from upsnet_torch.config import default_config
    from upsnet_torch.config.loader import update_config
    from upsnet_torch.evaluation.inference import bucket_anchors
    from upsnet_torch.models import get_model
    from upsnet_torch.models.upsnet import forward_predict

    conf = tiny_config()
    cfg = update_config(default_config(), conf["model"])
    model = get_model(cfg.symbol, cfg, device="cpu")
    model.load_state_dict(W.make_state(W.state_shapes(model), conf["weights"], 7, "cpu"))
    bucket = (64, 96)
    batch = {"images": torch.randn(1, *bucket, 3) * 50, "im_hw": torch.tensor([[60.0, 90.0]])}
    with FlopCounterMode(display=False) as fc:
        forward_predict(model, cfg, bucket_anchors(cfg, bucket, "cpu"), batch)
    counts = fc.get_flop_counts()
    glob = {str(k): v for k, v in counts["Global"].items()}
    dcn_gemm = {str(k): v for k, v in counts["FCNHead.subnet"].items()}["aten.mm"]
    expected = glob["aten.convolution"] + glob["aten.addmm"] + dcn_gemm
    assert _flops.predict_flops(conf["model"], bucket) == expected
    # what the counter leaves out: resize and paste matmuls
    assert glob["aten.mm"] > dcn_gemm and glob["aten.bmm"] > 0


def test_dcn_least_time_names_its_bound():
    conf = tiny_config()
    t, bound = _flops.dcn_least_s(conf["model"], (64, 96), 2)
    assert t > 0 and bound in ("bytes", "operations")
    full = __import__("json").loads(
        (__import__("pathlib").Path(_flops.__file__).parents[1] / "configs" / "r50_coco.json")
        .read_text())
    assert len(_flops.dcn_layers(full["model"], (832, 1344))) == 8
