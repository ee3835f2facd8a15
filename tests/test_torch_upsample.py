"""The FCN head's bilinear upsample (``upsnet_torch/models/fcn.py:
resize_bilinear``) against ``upsnet_tpu/models/fcn.py:resize_bilinear``
(``jax.image.resize(method='bilinear')``): the forward, and the gradient
through ``jax.vjp``, at the P3, P4 and P5 maps of the 832x1344 bucket
upsampled to P2 (208x336), on a size that is not a power of two
(13x21 -> 37x50) and on a downsample (37x50 -> 13x21, the antialiased
kernel). Batch 2, 3 channels, numpy-seeded.

Tolerances, of max|ref|: float32 1e-5 (the weights are built in float32 as
JAX builds them; the contractions sum in another order: measured 1.5e-7 at
P3-P5, 2.9e-6 on the odd size); bfloat16 2^-6 (JAX contracts in bfloat16
with bfloat16 weights, rounding after each axis, the port in float32 with
one rounding at the end: measured 0.0044-0.0091).

The backward is two matmuls (no scatter), so it is the same function of its
inputs on every run; ``chip_smoke.py``'s ``reproducible`` phase holds two
runs of the train entry bit-identical on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upsnet_tpu.models.fcn import resize_bilinear as jax_resize
from upsnet_torch.models import fcn

torch.set_num_threads(2)

SHAPES = {
    "P3": ((104, 168), (208, 336)),
    "P4": ((52, 84), (208, 336)),
    "P5": ((26, 42), (208, 336)),
    "odd": ((13, 21), (37, 50)),
    "down": ((37, 50), (13, 21)),
}
TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -6}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(SHAPES))
def test_resize_and_its_gradient_match_jax(rng, case, dtype):
    (h, w), (oh, ow) = SHAPES[case]
    x = rng.randn(2, h, w, 3).astype(np.float32)
    g = rng.randn(2, oh, ow, 3).astype(np.float32)
    ref, vjp = jax.vjp(lambda a: jax_resize(a, (oh, ow)), jnp.asarray(x).astype(dtype))
    (ref_grad,) = vjp(jnp.asarray(g).astype(dtype))

    tdt = getattr(torch, dtype)
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).to(tdt).requires_grad_()
    y = fcn.resize_bilinear(tx, (oh, ow))
    assert y.dtype == tdt and tuple(y.shape) == (2, 3, oh, ow)
    y.backward(torch.from_numpy(g).permute(0, 3, 1, 2).to(tdt))
    assert tx.grad.dtype == tdt
    for got, want, name in ((y, ref, "forward"), (tx.grad, ref_grad, "gradient")):
        got = got.detach().float().permute(0, 2, 3, 1).numpy()
        want = np.asarray(want.astype(jnp.float32))
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL[dtype] * np.abs(want).max(),
                                   err_msg=name)


def test_weight_matrices_are_jax_s_and_cached(rng):
    """Each axis's matrix is the one ``jax.image.resize`` contracts with: it
    maps a one-hot input row to that row's resize, and it is built once per
    (in, out, device)."""
    for n_in, n_out in ((26, 208), (13, 37), (37, 13)):
        eye = jnp.eye(n_in, dtype=jnp.float32)[:, :, None, None]  # (n_in, n_in, 1, 1)
        ref = np.asarray(jax_resize(eye, (n_out, 1)))[:, :, 0, 0]
        np.testing.assert_allclose(fcn._weight_mat_np(n_in, n_out), ref, rtol=0, atol=1e-6)
    a = fcn._weight_mat(26, 208, "cpu")
    assert fcn._weight_mat(26, 208, torch.device("cpu")) is a and a.dtype == torch.float32
    x = torch.from_numpy(rng.randn(1, 2, 5, 7).astype(np.float32))
    assert fcn.resize_bilinear(x, (5, 7)) is x
