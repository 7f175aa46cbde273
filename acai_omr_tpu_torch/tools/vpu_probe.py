"""Rate of softmax, LayerNorm and the GELU forms per element on data held
on-chip (K27).

    python -m acai_omr_tpu_torch.tools.vpu_probe [--iters 2000]

Port of ``tools/vpu_probe.py``: one launch of
``ops/vpu_probe_kernels.resident_elementwise`` runs ``iters`` chained passes
``x <- work(x) + 0.5 x + (i & 1) 1e-6`` over an fp32 block whose rows stay in
registers from the first pass to the last. Method as the JAX tool's: time
``iters`` and ``2 iters`` passes (CUDA events around one launch, the least of
three), and report the difference per pass, so the launch and the one load
and store cancel. Works and shapes: softmax (256, 256), (256, 1024),
(1024, 1024) (the attention-prob recompute); ln (256, 1024), (1024, 768);
gelu (the A&S rational erf), gelu_poly (the two-branch polynomial) and
gelu_erff (CUDA's erff, the GELU of the port's K1 / K5 / K14 epilogues) at
(256, 4096) and (1024, 3072). Per row: ns a pass, Gelem/s, and the bound: the
work's fp32 instructions at 128 a SM a clock or its MUFU operations at 16,
whichever is longer, at the card's highest SM clock (``nvidia-smi
--query-gpu=clocks.max.sm``); counts per element in
``vpu_probe_kernels.OPS_PER_ELEMENT``. Last line: one JSON object with every
row, ``device`` and ``iters``.

Each shape is also held against the plain twin at 8 passes
(``max_rel_err``): the rates are measured on other values. GELU's feedback
``y ~ 1.5 x`` overflows to inf within a few hundred passes for x > 0 (as it
does on the TPU), so the timed passes run on infs and on values decaying
to 0; the kernel's pass costs the same on them as on finite values (the
A&S erf's argument is clamped where erf is already 1, so its reciprocal
never takes the slow path). Numerical checks use 16 passes or fewer.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..ops.vpu_probe_kernels import bound_s, resident_elementwise
from ._probe import (FP32_LANES_PER_SM, MUFU_PER_SM, cpu_note, label, resolve,
                     sm_clock_hz, sm_count)

SHAPES = {
    "softmax": [(256, 256), (256, 1024), (1024, 1024)],
    "ln": [(256, 1024), (1024, 768)],
    "gelu": [(256, 4096), (1024, 3072)],
    "gelu_poly": [(256, 4096), (1024, 3072)],
    "gelu_erff": [(256, 4096), (1024, 3072)],
}
CHECK_ITERS = 8
REL_TOL = 1e-5  # of the largest |output| after CHECK_ITERS passes


def make_block(rows: int, cols: int, dev) -> torch.Tensor:
    """0.1 x standard normal from ``default_rng(0)``, as the JAX tool draws."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((rows, cols)) * 0.1
    return torch.from_numpy(x.astype(np.float32)).to(dev)


def _seconds(x, work: str, n: int, dev) -> float:
    """Seconds of one launch of n passes: the least of three after a warm-up
    (CUDA events on the card, the host clock on the CPU)."""
    resident_elementwise(x, work, n)
    best = float("inf")
    for _ in range(3):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            resident_elementwise(x, work, n)
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) * 1e-3)
        else:
            t0 = time.perf_counter()
            resident_elementwise(x, work, n)
            best = min(best, time.perf_counter() - t0)
    return best


def run(work: str, rows: int, cols: int, iters: int, dev,
        clock_hz: float | None) -> dict:
    x = make_block(rows, cols, dev)
    out = resident_elementwise(x, work, CHECK_ITERS)
    ref = resident_elementwise.plain(x, work, CHECK_ITERS)
    scale = max(1.0, ref.abs().max().item())
    err = (out - ref).abs().max().item() / scale
    t1, t2 = _seconds(x, work, iters, dev), _seconds(x, work, 2 * iters, dev)
    dt = (t2 - t1) / iters
    elems = rows * cols
    row = {"ns_per_iter": dt * 1e9, "elems_per_s": elems / dt / 1e9,
           "max_rel_err": err, "ok": err <= REL_TOL}
    if clock_hz is not None:
        b = bound_s(work, elems, 1, clock_hz, sm_count(dev),
                    FP32_LANES_PER_SM, MUFU_PER_SM)
        row.update(bound_ns_per_iter=b * 1e9, x_bound=dt / b)
    return row


def main(argv=None, device="cuda", shapes=None) -> dict:
    ap = argparse.ArgumentParser(prog="vpu_probe")
    ap.add_argument("--iters", type=int, default=2000)
    args = ap.parse_args([] if argv is None else argv)
    dev = resolve(device)
    note = cpu_note(dev)
    clock = sm_clock_hz(dev)
    print(f"device: {label(dev)}, highest SM clock "
          + ("not measured" if clock is None else f"{clock / 1e6:.0f} MHz")
          + note, flush=True)
    out = {"device": label(dev), "iters": args.iters, "sm_clock_hz": clock}
    for work, shps in (shapes or SHAPES).items():
        for rows, cols in shps:
            key = f"{work}_{rows}x{cols}"
            r = out[key] = run(work, rows, cols, args.iters, dev, clock)
            bound = "" if clock is None else (
                f", bound {r['bound_ns_per_iter'] / 1e3:.2f} us/iter "
                f"({r['x_bound']:.1f}x)")
            print(f"[{key}] {r['ns_per_iter'] / 1e3:.2f} us/iter, "
                  f"{r['elems_per_s']:.1f} Gelem/s{bound}; {CHECK_ITERS} "
                  f"passes vs twin rel err {r['max_rel_err']:.1e} "
                  f"{'ok' if r['ok'] else 'FAIL'}{note}", flush=True)
    print(json.dumps(out))
    out["ok"] = all(v["ok"] for v in out.values() if isinstance(v, dict))
    return out


if __name__ == "__main__":
    sys.exit(0 if main(sys.argv[1:])["ok"] else 1)
