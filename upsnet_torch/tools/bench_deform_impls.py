"""Compare the deformable-conv forms at trained-like (small) offsets.

The port's counterpart of ``tools/bench_deform_impls.py``: for each of the
flagship FCN-head shapes, both subnet layers at P2 (256 -> 128 and
128 -> 128) and the smaller levels, it runs

  * ``pertap``: ``deform_conv2d(impl="pallas")``, project-first (K1 without
    gradients, the all-tap K2 + K3 with them), and
  * ``mt``: ``deform_conv2d_mt``, sample-first (K7a, one GEMM, K7b),

at two offset fields: ``const2``, constant per-tap offsets in +-2 px (what
offset convs with biases only give), and ``rand2``, uniform +-2 px per
pixel; forward alone and forward + backward of ``sum(out ** 2)``. It prints
one line per shape and form and returns the rows.

    python3 -m upsnet_torch.tools.bench_deform_impls

runs on the first CUDA device; ``main(device="cpu", ...)`` runs the plain
versions on the CPU (a check of the tool, not a measurement). On CUDA the
times are CUDA-event medians; on the CPU, host-clock medians.
"""

from __future__ import annotations

import statistics
import time

import torch

from upsnet_torch.ops.deform_conv import deform_conv2d, deform_conv2d_mt

# ((H, W), Cin) of the JAX tool: P2 for both subnet layers, P3, P4, and a
# small map; Cout 128, bf16, 3x3, max_dy 6
SHAPES = (((208, 336), 256), ((208, 336), 128), ((104, 168), 128), ((52, 84), 128),
          ((32, 48), 128))
COUT = 128
MAX_DY = 6

IMPLS = {
    "pertap": lambda x, o, w: deform_conv2d(x, o, w, None, 3, 1, "pallas", MAX_DY),
    "mt": lambda x, o, w: deform_conv2d_mt(x, o, w, None, 3, 1, MAX_DY),
}


def _median_ms(fn, device: torch.device, reps: int) -> float:
    """Median time of ``reps`` calls after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def main(device=None, batch: int = 2, shapes=SHAPES, reps: int = 10,
         dtype=torch.bfloat16) -> list[dict]:
    """Time both forms on ``device`` (default: the first CUDA device; raises
    without one) at ``batch`` over ``shapes``. Returns one row per (shape,
    form): ``h, w, cin, impl`` and, per offset field, ``<field>_fwd_ms``,
    ``<field>_fwdbwd_ms``; ``mt`` rows also carry ``<field>_max_abs_diff``,
    its forward output against ``pertap`` on the same inputs."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("bench_deform_impls needs a CUDA device (or device='cpu')")
        device = "cuda:0"
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(0)
    const18 = torch.rand(18, generator=gen, device=device) * 4 - 2
    print(f"device={device} "
          + (torch.cuda.get_device_name(device) if device.type == "cuda" else "(plain versions)")
          + f" batch={batch} dtype={dtype}")
    rows = []
    for (h, w), cin in shapes:
        x = torch.randn((batch, h, w, cin), generator=gen, device=device).to(dtype)
        weight = torch.randn((9, cin, COUT), generator=gen, device=device) * 0.05
        fields = {
            "const2": const18.expand(batch, h, w, 18).contiguous(),
            "rand2": torch.rand((batch, h, w, 18), generator=gen, device=device) * 4 - 2,
        }
        outs = {}
        for name, fn in IMPLS.items():
            row = {"h": h, "w": w, "cin": cin, "impl": name}
            for field, off in fields.items():
                def fwd():
                    with torch.no_grad():
                        return fn(x, off, weight)

                def fwdbwd():
                    leaves = [t.detach().requires_grad_() for t in (x, off, weight)]
                    fn(*leaves).float().square().sum().backward()

                out = fwd().float()
                if name == "pertap":
                    outs[field] = out
                else:
                    row[f"{field}_max_abs_diff"] = float((out - outs[field]).abs().max())
                del out
                row[f"{field}_fwd_ms"] = _median_ms(fwd, device, reps)
                row[f"{field}_fwdbwd_ms"] = _median_ms(fwdbwd, device, reps)
            rows.append(row)
            print(f"{h}x{w} cin={cin} {name:6s}: " + "   ".join(
                f"{field} fwd {row[f'{field}_fwd_ms']:8.3f} ms, fwd+bwd "
                f"{row[f'{field}_fwdbwd_ms']:8.3f} ms" for field in fields))
        # the columns of mt are 9x the input: free them before the next shape
        del x, weight, fields, outs
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return rows


if __name__ == "__main__":
    main()
