"""GEMM throughput of the library at the model's training shapes.

    python -m acai_omr_tpu_torch.tools.gemm_probe

Port of ``tools/gemm_probe.py`` (``bench`` :22): bf16 products with fp32
accumulation (``torch.matmul``, bf16 out) at the training shapes and two
square giants, 30 back-to-back calls timed on the card. This is the library
yardstick for the tiled kernel of ``pallas_gemm_probe`` and the dot forms of
``mosaic_dot_forms_probe``; no kernel of the port runs here.
"""

from __future__ import annotations

import sys

import torch

from ._probe import PEAK_BF16_FLOP_PER_S, label, resolve, time_ms

REPS = 30
SHAPES = [(8192, 768, 3072), (8192, 768, 768), (8192, 1024, 4096),
          (8192, 3072, 768), (4096, 4096, 4096), (8192, 8192, 8192)]


def bench(m: int, k: int, n: int, device="cuda", reps: int = REPS) -> dict:
    dev = resolve(device)
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
    w = torch.randn(k, n, generator=g, device=dev).to(torch.bfloat16)
    ms = time_ms(lambda: torch.matmul(x, w), dev, iters=reps, reps=1)
    tf = 2 * m * k * n / ms / 1e9
    share = 100 * tf * 1e12 / PEAK_BF16_FLOP_PER_S
    print(f"({m:5d},{k:5d},{n:5d}) bfloat16: {ms:7.3f} ms -> {tf:6.1f} "
          f"TFLOP/s ({share:.1f}% of 989) on {label(dev)}", flush=True)
    return {"shape": (m, k, n), "ms": ms, "tflops": tf, "peak_share": share}


def main(argv=None, device="cuda") -> int:
    dev = resolve(device)
    print(f"device: {label(dev)}", flush=True)
    for shape in SHAPES:
        bench(*shape, device=dev)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
