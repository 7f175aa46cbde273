"""Which int4 weight-delivery scheme brings an 8-row W4A8 product closest to
its weight-stream bound on the card (K20).

    python -m acai_omr_tpu_torch.tools.int4_probe [--legality-only]
        [--reps 200] [--variants i8ref,s4dot,s4conv,i8shift,f32unpack]

Port of ``tools/int4_probe.py`` (``run_variant`` :96, ``time_variant`` :130):
``out = x @ W`` exactly, x int8 (bt, cin), W int4 values (cin, cout) in
[-8, 7] whose rows 0..cin/2 are ``lo`` and the rest ``hi``, out int32. Each
scheme (``ops/int4_probe_kernels.py``: ``i8ref`` full int8 weights,
``s4dot`` / ``s4conv`` K14's eight-rows-a-word int4, ``i8shift`` /
``f32unpack`` the TPU's ``(hi << 4) | (lo + 8)`` bytes) is first checked
exact against the int64 product at (8, 256, 512), then timed at ff1's
(8, 1024, 4096) from HBM: the weights rotate over enough copies that every
call streams them from device memory, as the decode step streams twelve
layers' weights. Per scheme: us a call, times its bound (the weight, row and
output bytes at 3.35 TB/s). No library call computes this at 8 rows:
``torch._int_mm`` takes more than 16.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..ops.int4_probe_kernels import (GEMM_SCHEMES, int4_delivery_gemm,
                                      scheme_weights)
from ._probe import (PEAK_BYTES_PER_S, PEAK_INT8_OP_PER_S, cold_copies,
                     l2_bytes, label, resolve, residency, time_ms)

LEGALITY_SHAPE = (8, 256, 512)
TIMING_SHAPE = (8, 1024, 4096)


def make_inputs(bt: int, cin: int, cout: int, device="cpu") -> tuple:
    """The JAX tool's draws (``np.random.default_rng(0)``: lo, hi, then x)
    as int8 tensors: lo, hi (cin/2, cout), x (bt, cin)."""
    rng = np.random.default_rng(0)
    lo = rng.integers(-8, 8, (cin // 2, cout), np.int32)
    hi = rng.integers(-8, 8, (cin // 2, cout), np.int32)
    x = rng.integers(-127, 128, (bt, cin), np.int32)
    return tuple(torch.from_numpy(a.astype(np.int8)).to(device)
                 for a in (lo, hi, x))


def weight_bytes(scheme: str, cin: int, cout: int) -> int:
    return cin * cout // (1 if scheme == "i8ref" else 2)


def bound_ms(scheme: str, bt: int, cin: int, cout: int) -> float:
    """Least time of one call: the weights, the rows and the int32 output at
    the memory rate, or the products at the int8 peak."""
    nbytes = weight_bytes(scheme, cin, cout) + bt * cin + 4 * bt * cout
    return 1e3 * max(nbytes / PEAK_BYTES_PER_S,
                     2 * bt * cin * cout / PEAK_INT8_OP_PER_S)


def run_variant(name: str, bt: int, cin: int, cout: int,
                device="cuda") -> bool:
    """Whether ``name`` gives the int64 product exactly."""
    dev = resolve(device)
    lo, hi, x = make_inputs(bt, cin, cout, dev)
    want = x.double() @ torch.cat([lo, hi], 0).double()
    out = int4_delivery_gemm(x, scheme_weights(lo, hi, name), name)
    return out.dtype == torch.int32 and torch.equal(out.double(), want)


def time_variant(name: str, bt: int, cin: int, cout: int, reps: int,
                 device="cuda") -> dict:
    """ms of one call from HBM: ``reps`` calls in a CUDA graph (a whole
    number of rotations over the weight copies), replayed three times."""
    dev = resolve(device)
    lo, hi, x = make_inputs(bt, cin, cout, dev)
    w = scheme_weights(lo, hi, name)
    nbytes = weight_bytes(name, cin, cout)
    copies = cold_copies(nbytes, l2_bytes(dev))
    ws = [w] + [w.clone() for _ in range(copies - 1)]
    ms = time_ms(lambda i: int4_delivery_gemm(x, ws[i], name), dev,
                 iters=reps, copies=copies)
    return {"ms": ms, "bound_ms": bound_ms(name, bt, cin, cout),
            "copies": copies, "where": residency(dev, copies, nbytes)}


def main(argv=None, device="cuda", legality_shape=LEGALITY_SHAPE,
         timing_shape=TIMING_SHAPE) -> dict:
    ap = argparse.ArgumentParser(prog="int4_probe")
    ap.add_argument("--legality-only", action="store_true")
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--variants", default=",".join(GEMM_SCHEMES))
    args = ap.parse_args([] if argv is None else argv)
    dev = resolve(device)
    print(f"device: {label(dev)}", flush=True)
    bt, cin, cout = timing_shape
    res = {"legality": {}, "timing": {}}
    for name in args.variants.split(","):
        ok = run_variant(name, *legality_shape, device=dev)
        res["legality"][name] = ok
        print(f"[legality] {name:10s}: {'EXACT' if ok else 'WRONG'}",
              flush=True)
        if args.legality_only or not ok:
            continue
        t = time_variant(name, bt, cin, cout, args.reps, dev)
        res["timing"][name] = t
        print(f"[timing]   {name:10s}: {t['ms'] * 1e3:8.2f} us/iter "
              f"(bt={bt}, {cin}x{cout}), {t['ms'] / t['bound_ms']:6.2f}x "
              f"its bound {t['bound_ms'] * 1e3:.2f} us, {t['where']}",
              flush=True)
    if res["timing"]:
        best = min(res["timing"], key=lambda n: res["timing"][n]["ms"]
                   / res["timing"][n]["bound_ms"])
        print(f"closest to its bound: {best}; library: none at bt={bt} "
              f"(torch._int_mm takes more than 16 rows)", flush=True)
    return res


if __name__ == "__main__":
    out = main(sys.argv[1:])
    sys.exit(0 if all(out["legality"].values()) else 1)
