"""JAX parameter tree <-> ``upsnet_torch`` state_dict.

The port's module tree follows the flax tree name for name
(``backbone_net.res2_0.conv1``, ``fpn.lateral2``,
``fcn_head.subnet.dcn1.offset_conv``, ...), so the bridge is a leaf-by-leaf
layout transform, the inverse of ``upsnet_tpu/convert/torch_converter.py``:

  * conv kernel HWIO -> OIHW;
  * Dense kernel (in, out) -> (out, in); the box head's fc1 needs no
    permutation because the port flattens pooled features in the same
    (P, P, C) order;
  * ConvTranspose (the mask head's ``deconv``): flax HWIO, which applies the
    kernel without a flip -> torch (in, out, kh, kw), spatially reversed;
  * deformable conv kernel, tap-major (K, in, out) -> (out, in, k, k), in
    the FCN head and in the backbone's ``-DCN`` stages
    (``backbone_net.res4_0.conv2``, its ``offset_conv`` a plain conv);
  * FrozenBN ``scale`` / ``bias`` -> the module's buffers of the same name,
    GroupNorm ``scale`` / ``bias`` -> its parameters of the same name.

Input is the tree as ``jax.device_get(params)`` gives it: nested dicts of
numpy arrays. ``to_jax`` runs the same rules backwards, so that parameters
or gradients of the port can be held against the JAX package's leaf by
leaf. ``save_jax_params_checkpoint`` writes a tree as a port checkpoint
(``train/checkpoints.py``), which ``tools/test.py --weights`` reads. This
module imports neither jax nor the JAX package.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from upsnet_torch.train.checkpoints import write_checkpoint

DECONV_NAMES = ("deconv",)


def _convert_kernel(path: tuple, k: np.ndarray) -> np.ndarray:
    if k.ndim == 4 and path[-2] in DECONV_NAMES:
        return np.transpose(k[::-1, ::-1], (2, 3, 0, 1))
    if k.ndim == 4:
        return np.transpose(k, (3, 2, 0, 1))
    if k.ndim == 3:  # deformable conv, tap-major
        taps, cin, cout = k.shape
        ks = math.isqrt(taps)
        if ks * ks != taps:
            raise ValueError(f"{'.'.join(path)}: {taps} taps is not a square kernel")
        return np.transpose(k, (2, 1, 0)).reshape(cout, cin, ks, ks)
    if k.ndim == 2:
        return k.T
    raise ValueError(f"{'.'.join(path)}: unexpected kernel rank {k.ndim}")


def jax_params_to_state_dict(tree: dict) -> dict:
    """Every leaf of the flax parameter tree as a torch state_dict entry."""
    out = {}

    def visit(node, path):
        if isinstance(node, dict):
            for key, val in node.items():
                visit(val, path + (key,))
            return
        arr = np.asarray(node, dtype=np.float32)
        name = path[-1]
        if name == "kernel":
            arr = _convert_kernel(path, arr)
            name = "weight"
        elif name not in ("bias", "scale"):
            raise ValueError(f"unexpected parameter {'.'.join(path)}")
        key = ".".join(path[:-1] + (name,))
        out[key] = torch.from_numpy(np.array(arr, np.float32))  # owned copy

    visit(tree, ())
    return out


def load_jax_params(model: torch.nn.Module, tree: dict) -> None:
    """Load a flax parameter tree into ``model`` strictly: every leaf must
    land on a parameter or buffer of matching shape and every parameter and
    buffer must be filled, or this raises."""
    model.load_state_dict(jax_params_to_state_dict(tree), strict=True)


def save_jax_params_checkpoint(ckpt_dir: str, step: int, tree: dict) -> str:
    """Write the flax parameter tree ``tree`` (nested dicts of numpy arrays)
    as the port checkpoint ``<ckpt_dir>/step_{step:08d}``, with no optimizer
    state. Returns its path."""
    return write_checkpoint(ckpt_dir, step, jax_params_to_state_dict(tree))


def _restore_kernel(path: tuple, w: np.ndarray, like: np.ndarray) -> np.ndarray:
    """The inverse of ``_convert_kernel`` for the leaf at ``path`` whose JAX
    shape is ``like.shape``."""
    if like.ndim == 4 and path[-2] in DECONV_NAMES:
        return np.transpose(w, (2, 3, 0, 1))[::-1, ::-1]
    if like.ndim == 4:
        return np.transpose(w, (2, 3, 1, 0))
    if like.ndim == 3:  # deformable conv: (out, in, k, k) -> tap-major
        cout, cin = w.shape[:2]
        return np.transpose(w.reshape(cout, cin, -1), (2, 1, 0))
    if like.ndim == 2:
        return w.T
    raise ValueError(f"{'.'.join(path)}: unexpected kernel rank {like.ndim}")


def to_jax(state_dict: dict, template: dict) -> dict:
    """A state_dict-shaped mapping (name -> tensor or array: parameters, or
    their gradients) as the JAX parameter tree of numpy arrays. ``template``
    is a JAX tree of the same model; it gives the structure and each
    kernel's rank. Every leaf of the template must be present."""

    def visit(node, path):
        if isinstance(node, dict):
            return {key: visit(val, path + (key,)) for key, val in node.items()}
        name = "weight" if path[-1] == "kernel" else path[-1]
        value = state_dict[".".join(path[:-1] + (name,))]
        if isinstance(value, torch.Tensor):
            value = value.detach().cpu().numpy()
        arr = np.asarray(value, np.float32)
        if path[-1] == "kernel":
            arr = _restore_kernel(path, arr, np.asarray(node))
        if arr.shape != np.shape(node):
            raise ValueError(f"{'.'.join(path)}: shape {arr.shape} != {np.shape(node)}")
        return np.ascontiguousarray(arr)

    return visit(template, ())
