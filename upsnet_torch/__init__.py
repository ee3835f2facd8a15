"""upsnet_torch — the PyTorch/CUDA port of ``upsnet_tpu``.

The same model, ops and predict path as the JAX package, written for an
NVIDIA H100: plain tensor code is PyTorch, and each function the JAX package
wrote as a Pallas TPU kernel is a CUDA C++ kernel under ``csrc/``, built with
``nvcc`` at first use on a CUDA tensor and bound with ``ctypes``. Every
kernel wrapper keeps a plain PyTorch version of the same function beside it;
CPU tensors take that version, CUDA tensors always launch the kernel.

Layout mirrors ``upsnet_tpu`` module for module:
  config/   dataclass config tree (own copy)
  ops/      anchors, boxes, NMS, proposals, deformable conv + its sampling
            kernel, ROIAlign + its FPN kernel, mask paste, panoptic fusion
  models/   ResNet, FPN, RPN, box/mask heads, FCN head, UPSNet assembly
  convert/  JAX parameter tree -> state_dict bridge
  tools/    timing tools (``python3 -m upsnet_torch.tools.<name>``)
  csrc/     CUDA sources of the kernels

The package never imports ``jax`` or ``upsnet_tpu``.
"""

__version__ = "0.1.0"
