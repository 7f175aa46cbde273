"""What one bulk copy costs to issue on the card (K22).

    python -m acai_omr_tpu_torch.tools.dma_issue_probe [--steps 48]
        [--slots 3] [--slot-kb 64] [--blocks N]
        [--frags 1 2 4 8 16 64 256] [--reps 20]

Port of ``tools/dma_issue_probe.py`` (``build`` :66): the same bytes a step
streamed in F fragments through an S-slot ring with no compute: F = 1..16 as
the TPU tool, and 64 and 256 (1 KB and 256-byte copies at 64 KB a slot),
where the issue cost is not hidden under the stream.
On Hopper one block per SM (``--blocks``, default the card's SM count)
streams its ``--slot-kb`` share of every step through its own ring in
shared memory: F bulk copies a refill, each completing on the slot's
mbarrier (``ops/stream_probe_kernels.bulk_copy_ring``). A step is blocks x
slot bytes (8.25 MiB on 132 SMs at 64 KB; the TPU tool's 21 MB step does
not fit 227 KB a block). Per F: the copies one SM issues in a call, ms, GB/s.
Then a least-squares line of ms against those issues: its slope is the cost
of one issue on an SM, its intercept the F -> 0 time and rate. The stream
(396 MiB at the defaults) is more than twice the L2, so every call reads
from device memory.
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..ops.stream_probe_kernels import LANES, ROW_BYTES, bulk_copy_ring
from ._probe import (PEAK_BYTES_PER_S, cold_copies, l2_bytes, label, resolve,
                     residency, time_ms)

CPU_BLOCKS = 4


def make_src(steps: int, slot_kb: int, blocks: int, device) -> torch.Tensor:
    """(steps, blocks x rows of one slot, 1024) bf16, seeded."""
    rows = slot_kb * 1024 // ROW_BYTES * blocks
    g = torch.Generator(device=device).manual_seed(0)
    return torch.randn(steps, rows, LANES, generator=g,
                       device=device).to(torch.bfloat16)


def fit(xs: list, ys: list) -> tuple[float, float]:
    """(intercept, slope) of the least-squares line through (xs, ys)."""
    n = len(xs)
    mx, my = sum(xs) / n, sum(ys) / n
    sxx = sum((x - mx) ** 2 for x in xs)
    slope = sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / sxx if sxx \
        else 0.0
    return my - slope * mx, slope


def main(argv=None, device="cuda") -> dict:
    ap = argparse.ArgumentParser(prog="dma_issue_probe")
    ap.add_argument("--steps", type=int, default=48)
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--slot-kb", type=int, default=64)
    ap.add_argument("--blocks", type=int, default=None)
    ap.add_argument("--frags", type=int, nargs="*",
                    default=[1, 2, 4, 8, 16, 64, 256])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args([] if argv is None else argv)
    dev = resolve(device)
    blocks = args.blocks or (
        torch.cuda.get_device_properties(dev).multi_processor_count
        if dev.type == "cuda" else CPU_BLOCKS)
    src = make_src(args.steps, args.slot_kb, blocks, dev)
    nbytes = src.numel() * 2
    copies = cold_copies(nbytes, l2_bytes(dev))
    srcs = [src] + [src.clone() for _ in range(copies - 1)]
    where = residency(dev, copies, nbytes)
    want = src[-1, :8, :128]
    print(f"device: {label(dev)}  {blocks} blocks x {args.slots} slots x "
          f"{args.slot_kb} KB, {args.steps} steps of "
          f"{nbytes / args.steps / 2 ** 20:.2f} MiB ({nbytes / 2 ** 20:.0f} "
          f"MiB a call, {where})", flush=True)
    rows = []
    for frags in args.frags:
        tile_ok = torch.equal(
            bulk_copy_ring(src, args.slots, frags, blocks), want)
        ms = time_ms(lambda i: bulk_copy_ring(srcs[i], args.slots, frags,
                                              blocks),
                     dev, iters=args.reps, copies=copies)
        issues = frags * args.steps
        rows.append({"frags": frags, "issues_per_sm": issues, "ms": ms,
                     "gbps": nbytes / (ms * 1e-3) / 1e9, "tile_ok": tile_ok})
        print(f"frags={frags:3d}  issues/step={issues:5d} per SM "
              f"({issues * blocks} a call)  {ms:7.3f} ms  "
              f"{rows[-1]['gbps']:6.1f} GB/s  tile "
              f"{'OK' if tile_ok else 'WRONG'}", flush=True)
    a, b = fit([r["issues_per_sm"] for r in rows], [r["ms"] for r in rows])
    res = {"rows": rows, "intercept_ms": a, "ns_per_issue": b * 1e6,
           "f0_gbps": nbytes / (a * 1e-3) / 1e9 if a > 0 else None,
           "bound_ms": 1e3 * nbytes / PEAK_BYTES_PER_S, "where": where,
           "tile_ok": all(r["tile_ok"] for r in rows)}
    f0 = "not measured" if res["f0_gbps"] is None \
        else f"{res['f0_gbps']:.1f} GB/s"
    print(f"fit: {res['ns_per_issue']:.2f} ns per issue on an SM; F -> 0: "
          f"{a:.4f} ms ({f0}); bound {res['bound_ms']:.4f} ms at 3.35 TB/s",
          flush=True)
    return res


if __name__ == "__main__":
    out = main(sys.argv[1:])
    sys.exit(0 if out["tile_ok"] else 1)
