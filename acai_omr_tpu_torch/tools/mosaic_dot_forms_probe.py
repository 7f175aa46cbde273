"""The three GEMM forms of the training backward on K16, fp32 out.

    python -m acai_omr_tpu_torch.tools.mosaic_dot_forms_probe

Port of ``tools/mosaic_dot_forms_probe.py`` (``make_kernel`` :23, ``run``
:30): one product of bf16 operands with fp32 out in each form the fused
training layer needs, checked against the plain fp32 product:

  * A @ B   ((1,),(0,))  forward             K16 layout "nn"
  * A @ B^T ((1,),(1,))  dx = g W^T, logits  K16 layout "nt"
  * A^T @ B ((0,),(0,))  dW = x^T g          K16 layout "tn"
  * S^T @ q over T = 256 rows, the attention backward's dK

at the JAX script's shapes (tile 64x64x32), then each of the three forms
timed at (8192, 768, 3072) (tile 128x128x32) beside ``torch.matmul`` of the
same form: what a transposed operand costs on K16's persistent TMA +
``wgmma`` kernel, which loads every operand as stored (an MN-major operand
in 64-column boxes read with the instruction's transpose bit).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops.probe_kernels import tile_gemm
from ._probe import gemm_bound_ms, label, resolve, time_ms

# fp32 out of bf16 operands: the sums differ from the plain product's only
# in their order, ~1e-6 of the largest output over these depths
REL_TOL = 1e-5
CHECK_TILE = (64, 64, 32)
TIME_TILE, TIME_SHAPE = (128, 128, 32), (8192, 768, 3072)
M, K, N = 256, 1024, 512
FORMS = [("A@B   ((1,),(0,))", "nn", (M, K), (K, N)),
         ("A@B^T ((1,),(1,))", "nt", (M, K), (N, K)),
         ("A^T@B ((0,),(0,))", "tn", (K, M), (K, N)),
         ("S^T@q ((0,),(0,)) T-contract", "tn", (256, 256), (256, 64))]


def operands(a_shape, b_shape, dev):
    """The JAX script's operands: standard normals from numpy seeds 0 and 1,
    rounded to bf16."""
    a = np.random.default_rng(0).standard_normal(a_shape)
    b = np.random.default_rng(1).standard_normal(b_shape)
    return (torch.from_numpy(a).to(dev, torch.bfloat16),
            torch.from_numpy(b).to(dev, torch.bfloat16))


def library_call(a, b, layout):
    """torch.matmul of the same form, on the stored operands' views."""
    if layout == "tn":
        return lambda: torch.matmul(a.t(), b)
    if layout == "nt":
        return lambda: torch.matmul(a, b.t())
    return lambda: torch.matmul(a, b)


def run(form: str, layout: str, a_shape, b_shape, device="cuda",
        tile=CHECK_TILE) -> dict:
    dev = resolve(device)
    a, b = operands(a_shape, b_shape, dev)
    out = tile_gemm(a, b, tile, layout, torch.float32)
    ref = tile_gemm.plain(a, b, tile, layout, torch.float32)
    err = (out - ref).abs().max().item()
    ok = err <= REL_TOL * max(1.0, ref.abs().max().item())
    ms = time_ms(lambda: tile_gemm(a, b, tile, layout, torch.float32), dev)
    print(f"{form}: {'OK' if ok else 'FAIL'}  max_abs_err={err:.3e}  "
          f"{ms:.4f} ms at {tuple(out.shape)} on {label(dev)}", flush=True)
    return {"form": form, "layout": layout, "ok": ok, "max_abs_err": err,
            "ms": ms}


def time_form(form: str, layout: str, m: int, k: int, n: int, device="cuda",
              tile=TIME_TILE, reps: int = 20) -> dict:
    dev = resolve(device)
    g = torch.Generator(device=dev).manual_seed(0)
    a_shape = (k, m) if layout == "tn" else (m, k)
    b_shape = (n, k) if layout == "nt" else (k, n)
    a = torch.randn(*a_shape, generator=g, device=dev).to(torch.bfloat16)
    b = torch.randn(*b_shape, generator=g, device=dev).to(torch.bfloat16)
    ms = time_ms(lambda: tile_gemm(a, b, tile, layout, torch.float32), dev,
                 iters=reps, reps=1)
    lib = time_ms(library_call(a, b, layout), dev, iters=reps, reps=1)
    bound = gemm_bound_ms(m, k, n)
    print(f"{form} at ({m},{k},{n}) tile {'x'.join(map(str, tile))}: "
          f"{ms:7.3f} ms, {ms / bound:5.2f}x bound, torch.matmul {lib:7.3f} "
          f"ms (bf16 out)", flush=True)
    return {"form": form, "layout": layout, "shape": (m, k, n), "ms": ms,
            "library_ms": lib, "bound_ms": bound}


def main(argv=None, device="cuda", time_shape=TIME_SHAPE) -> int:
    dev = resolve(device)
    print(f"device: {label(dev)}", flush=True)
    checks = [run(*f, device=dev) for f in FORMS]
    for form, layout, *_ in FORMS[:3]:
        time_form(form, layout, *time_shape, device=dev)
    return 0 if all(c["ok"] for c in checks) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
