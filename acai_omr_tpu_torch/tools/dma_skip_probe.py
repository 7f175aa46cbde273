"""Do reads of a cache past a device-side length cost memory traffic on the
card (K23)?

    python -m acai_omr_tpu_torch.tools.dma_skip_probe [--clamps 1 31 63]
        [--modes clamped skip] [--reps 20]

Port of ``tools/dma_skip_probe.py`` (``run`` :44): the fp32 column sums of
chunks 0..s of x (64, 4096, 1024) bf16 (512 MiB, 8 MiB a chunk), s an int32
in device memory. The kernel walks the chunks as the TPU's grid does and
copies chunk min(k, s) only where the step adds it and the index changed
(the Pallas pipeline's rule): ``clamped`` walks all n steps, as the TPU
kernel's index map does, and issues nothing past s; ``skip`` ends the walk
at s. Per s and mode: ms a call beside the full-read and the clamped floors
at 3.35 TB/s and ``torch.sum`` of chunks 0..s in fp32 (s known on the host)
on the same inputs, the sum held against the plain fp32 sum, two runs
bit-equal; then the ratio of the full to the small clamp per mode (>> 1: the
steps past s cost little). Every call reads its chunks from device memory:
where (s + 1) chunks are under twice the L2, the calls, and the library's,
rotate over copies of x that start (s + 1) chunks apart in one larger
tensor.
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..ops.stream_probe_kernels import MODES, clamped_chunk_sum
from ._probe import (PEAK_BYTES_PER_S, cold_copies, l2_bytes, label, resolve,
                     residency, time_ms)

N_CHUNKS, CH, E = 64, 4096, 1024
REL_TOL = 1e-5  # of the largest |output|: fp32 sums in another order


def main(argv=None, device="cuda", shape=(N_CHUNKS, CH, E)) -> dict:
    n, ch, e = shape
    ap = argparse.ArgumentParser(prog="dma_skip_probe")
    ap.add_argument("--clamps", type=int, nargs="*",
                    default=[1, n // 2 - 1, n - 1])
    ap.add_argument("--modes", nargs="*", default=list(MODES))
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args([] if argv is None else argv)
    dev = resolve(device)
    chunk = ch * e * 2
    l2 = l2_bytes(dev)
    plan = {s: cold_copies((s + 1) * chunk, l2) for s in args.clamps}
    extra = max((c - 1) * (s + 1) for s, c in plan.items())
    g = torch.Generator(device=dev).manual_seed(0)
    x_all = torch.randn(n + extra, ch, e, generator=g,
                        device=dev).to(torch.bfloat16)
    print(f"device: {label(dev)}  x ({n}, {ch}, {e}) bf16, "
          f"{n * chunk / 2 ** 20:.0f} MiB, {chunk / 2 ** 20:.0f} MiB a chunk",
          flush=True)
    rows, times = [], {}
    full_ms = 1e3 * n * chunk / PEAK_BYTES_PER_S
    for mode in args.modes:
        for s in args.clamps:
            copies = plan[s]
            views = [x_all[j * (s + 1): j * (s + 1) + n]
                     for j in range(copies)]
            s_dev = torch.tensor([s], dtype=torch.int32, device=dev)
            out = clamped_chunk_sum(views[0], s_dev, mode)
            again = clamped_chunk_sum(views[0], s_dev, mode)
            ref = clamped_chunk_sum.plain(views[0], s_dev, mode)
            err = (out - ref).abs().max().item()
            tol = REL_TOL * max(1.0, ref.abs().max().item())
            ms = time_ms(lambda i: clamped_chunk_sum(views[i], s_dev, mode),
                         dev, iters=args.reps, copies=copies)
            lib_ms = time_ms(lambda i: torch.sum(
                views[i][:s + 1], dim=(0, 1), dtype=torch.float32), dev,
                iters=args.reps, copies=copies)
            bound = 1e3 * min(s + 1, n) * chunk / PEAK_BYTES_PER_S
            where = residency(dev, copies, (s + 1) * chunk)
            rows.append({"mode": mode, "s": s, "ms": ms, "bound_ms": bound,
                         "library_ms": lib_ms, "max_abs_err": err,
                         "tol": tol, "equal_runs": torch.equal(out, again),
                         "where": where})
            times[(mode, s)] = ms
            print(f"clamp={s:3d} [{mode:7s}]: {ms:7.3f} ms/call (full-read "
                  f"floor {full_ms:.3f} ms, clamped floor {bound:.3f} ms; "
                  f"torch.sum of chunks 0..s {lib_ms:.3f} ms), {where}; "
                  f"max|err| {err:.2e} (tol {tol:.1e}), two runs "
                  f"{'equal' if rows[-1]['equal_runs'] else 'DIFFER'}",
                  flush=True)
    ratios = {}
    lo, hi = min(args.clamps), max(args.clamps)
    for mode in args.modes:
        ratios[mode] = times[(mode, hi)] / times[(mode, lo)]
        print(f"[{mode}] ratio full/small = {ratios[mode]:.2f} (>> 1: the "
              f"steps past s cost little)", flush=True)
    ok = all(r["max_abs_err"] <= r["tol"] and r["equal_runs"] for r in rows)
    return {"rows": rows, "ratio": ratios, "ok": ok}


if __name__ == "__main__":
    sys.exit(0 if main(sys.argv[1:])["ok"] else 1)
