"""Do 64-byte rows stream from device memory as fast as 512-byte rows on the
card (K24)?

    python -m acai_omr_tpu_torch.tools.narrow_lane_dma_probe [--lanes 128 16]
        [--iters 20]

Port of ``tools/narrow_lane_dma_probe.py`` (``stream_sum`` :25): ``c +`` the
sum over blocks and rows of x (256, 512, lanes) fp32, lanes 128 (the TPU's
full lane width) or 16 (the (T, H = 16) scale planes of the int8 caches that
K6 and K12 read). Each call's output is the next call's ``c``, as the TPU
tool chains them. Memory is linear on Hopper, so the kernel
(``ops/stream_probe_kernels.lane_stream_sum``) reads x flat, 16 bytes a
thread, and reduces by lane; the question carried over is whether the
narrow rows stream as fast from device memory. The 16-lane array is 8 MiB
and fits the L2, so the calls rotate over 16 copies of it (the 128-lane
array over 2), and each line says so. Per width: GB/s of x; then the ratio,
and the ratio again with the 16-lane rows in as many bytes as the 128-lane
call (2048 blocks), which separates the row width from the call's size.
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..ops.stream_probe_kernels import lane_stream_sum
from ._probe import cold_copies, l2_bytes, label, resolve, residency, time_ms

N_BLOCKS, T = 256, 512
REL_TOL = 1e-5  # of the largest |output|: fp32 sums in another order


def stream_sum(lanes: int, iters: int = 20, device="cuda",
               n_blocks: int = N_BLOCKS, t: int = T) -> dict:
    dev = resolve(device)
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(n_blocks, t, lanes, generator=g, device=dev)
    c0 = torch.zeros(1, lanes, device=dev)
    out = lane_stream_sum(x, c0)
    ref = lane_stream_sum.plain(x, c0)
    err = (out - ref).abs().max().item()
    tol = REL_TOL * max(1.0, ref.abs().max().item())
    nbytes = x.numel() * 4
    copies = cold_copies(nbytes, l2_bytes(dev))
    xs = [x] + [x.clone() for _ in range(copies - 1)]
    carry = [c0]

    def call(i):  # the carry chains each call to the one before
        carry[0] = lane_stream_sum(xs[i], carry[0])

    ms = time_ms(call, dev, iters=iters, copies=copies)
    gbps = nbytes / (ms * 1e-3) / 1e9
    where = residency(dev, copies, nbytes)
    print(f"lanes={lanes:4d}: {gbps:7.1f} GB/s effective ({ms:.4f} ms a call "
          f"for {nbytes / 2 ** 20:.0f} MiB, {n_blocks} blocks), {where}; "
          f"max|err| {err:.2e} (tol {tol:.1e})", flush=True)
    return {"lanes": lanes, "blocks": n_blocks, "gbps": gbps, "ms": ms,
            "max_abs_err": err, "tol": tol, "copies": copies, "where": where}


def main(argv=None, device="cuda", n_blocks: int = N_BLOCKS,
         t: int = T) -> dict:
    ap = argparse.ArgumentParser(prog="narrow_lane_dma_probe")
    ap.add_argument("--lanes", type=int, nargs="*", default=[128, 16])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args([] if argv is None else argv)
    dev = resolve(device)
    print(f"device: {label(dev)}", flush=True)
    rows = {n: stream_sum(n, args.iters, dev, n_blocks, t)
            for n in args.lanes}
    res = {"rows": rows}
    if 16 in rows and 128 in rows:
        res["efficiency"] = rows[16]["gbps"] / rows[128]["gbps"]
        print(f"narrow/full efficiency: {res['efficiency']:.3f}", flush=True)
        # the same 16-lane rows in as many bytes as the 128-lane call: the
        # row width apart from the call's size
        same = rows["16 at 128's bytes"] = stream_sum(
            16, args.iters, dev, n_blocks * 8, t)
        res["efficiency_same_bytes"] = same["gbps"] / rows[128]["gbps"]
        print(f"narrow/full efficiency at equal bytes: "
              f"{res['efficiency_same_bytes']:.3f}", flush=True)
    res["ok"] = all(r["max_abs_err"] <= r["tol"] for r in rows.values())
    return res


if __name__ == "__main__":
    sys.exit(0 if main(sys.argv[1:])["ok"] else 1)
