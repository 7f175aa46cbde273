"""The hand-written tiled GEMM (K16) against the library at the model's
training shapes.

    python -m acai_omr_tpu_torch.tools.pallas_gemm_probe

Port of ``tools/pallas_gemm_probe.py`` (``make_mm`` :23, ``bench`` :58):
bf16 ``x (m, k) @ w (k, n)``, fp32 accumulation, bf16 out, over (bm, bn, bk)
tiles, checked against the plain product and timed beside ``torch.matmul``.
K16 is a persistent, warp-specialised kernel: TMA loads through a ring a
producer warp feeds, ``wgmma`` m64nBNk16 in BM / 64 consumer warpgroups, the
tiles walked by as many blocks as the SMs hold, each tile's TMA stores
overlapping the next tile's mainloop; so the sweep asks what a tile shape
costs in the form a Hopper kernel of the port would take. The sweep uses
tiles Hopper's shared memory holds (64-256 wide, bk 32 / 64; the TPU's
512-2048 VMEM tiles do not carry over) at the stage-2 encoder's ff1 shape
(8192, 768, 3072) and the stage-1 MAE decoder's (32768, 512, 1536) and
(32768, 512, 3072). Per tile and shape: ms, TFLOP/s, times its bound (2mkn
at 989 TFLOP/s) and the library's ms.
"""

from __future__ import annotations

import sys

import torch

from ..ops.probe_kernels import SWEEP_TILES, check_tile, tile_gemm
from ._probe import gemm_bound_ms, label, resolve, time_ms

REPS = 30
SHAPES = [(8192, 768, 3072), (32768, 512, 1536), (32768, 512, 3072)]


def make_mm(m: int, k: int, n: int, bm: int, bn: int, bk: int = 32):
    """K16 at one tile: ``mm(x, w)`` for x (m, k), w (k, n); refuses a tile
    that is not compiled or does not divide the shape."""
    check_tile(m, k, n, (bm, bn, bk))
    return lambda x, w: tile_gemm(x, w, (bm, bn, bk))


def bench(m: int, k: int, n: int, bm: int, bn: int, bk: int = 32,
          device="cuda", reps: int = REPS) -> dict:
    dev = resolve(device)
    mm = make_mm(m, k, n, bm, bn, bk)
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
    w = torch.randn(k, n, generator=g, device=dev).to(torch.bfloat16)
    # correctness spot check against the product rounded once
    y = mm(x, w)
    ref = tile_gemm.plain(x, w, (bm, bn, bk))
    err = (y.float() - ref.float()).abs().max().item()
    ms = time_ms(lambda: mm(x, w), dev, iters=reps, reps=1)
    lib = time_ms(lambda: torch.matmul(x, w), dev, iters=reps, reps=1)
    tf = 2 * m * k * n / ms / 1e9
    bound = gemm_bound_ms(m, k, n)
    print(f"tile_gemm ({m},{k},{n}) bm={bm} bn={bn} bk={bk}: {ms:7.3f} ms -> "
          f"{tf:6.1f} TFLOP/s, {ms / bound:5.2f}x bound, torch.matmul "
          f"{lib:7.3f} ms (maxerr {err:.3f})", flush=True)
    return {"shape": (m, k, n), "tile": (bm, bn, bk), "ms": ms,
            "library_ms": lib, "bound_ms": bound, "tflops": tf,
            "max_abs_err": err, "ref_max": ref.float().abs().max().item()}


def main(argv=None, device="cuda", shapes=SHAPES, tiles=SWEEP_TILES,
         reps: int = REPS) -> list:
    dev = resolve(device)
    print(f"device: {label(dev)}", flush=True)
    return [bench(*shape, *tile, device=dev, reps=reps) for shape in shapes
            for tile in tiles]


if __name__ == "__main__":
    main(sys.argv[1:])
