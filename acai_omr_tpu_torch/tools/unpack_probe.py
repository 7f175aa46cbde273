"""Which int4 unpack scheme is cheapest on the card (K21).

    python -m acai_omr_tpu_torch.tools.unpack_probe [--reps 50]
        [--variants f32,i32,i16,i8div,eyedot]

Port of ``tools/unpack_probe.py`` (``run`` :112): one ff1-sized packed
block, (512, 4096) int8 bytes ``(hi << 4) | (lo + 8)``, unpacked to (1024,
4096) int8, lo rows then hi rows, by five schemes (``ops/int4_probe_kernels``
K21: float convert and floor, int32 shifts, int16 shifts, floor division on
int8, the identity product on the tensor cores then float floor). Each is
checked exact first, then the unpack repeats ``reps`` and ``2 reps`` times
inside one launch; the time of one unpack is ``(t(2n) - t(n)) / n``, so the
launch and the read of the packed block cancel. The output (4 MiB) is
written every rep and stays in L2, so the time is "warm": it measures the
unpack and its stores, not a stream from device memory.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..ops.int4_probe_kernels import UNPACK_SCHEMES, int4_unpack, pack_bytes
from ._probe import label, resolve, time_ms

HALF, OUT = 512, 4096


def make_block(half: int = HALF, out: int = OUT, device="cpu") -> tuple:
    """The JAX tool's draws (``np.random.default_rng(0)``: lo, hi): the
    packed block and the unpacked rows it must give."""
    rng = np.random.default_rng(0)
    lo = torch.from_numpy(rng.integers(-8, 8, (half, out), np.int32))
    hi = torch.from_numpy(rng.integers(-8, 8, (half, out), np.int32))
    want = torch.cat([lo, hi], 0).to(torch.int8)
    return pack_bytes(lo, hi).to(device), want.to(device)


def run(name: str, reps: int, device="cuda", shape=(HALF, OUT),
        variant=None) -> dict:
    """One scheme: exact first, then ``(t(2n) - t(n)) / n``. ``variant``
    (chip_smoke.py's turns): ``"bytewise"`` times the kernel K21's word-wide
    kernel replaced."""
    dev = resolve(device)
    wp, want = make_block(*shape, device=dev)
    unpack = lambda r: int4_unpack(wp, name, r, variant=variant)
    out = unpack(1)
    if not torch.equal(out, want):
        diff = (out.int() - want.int()).abs().max().item()
        return {"exact": False, "line": f"WRONG (diff {diff})"}
    t_n = time_ms(lambda: unpack(reps), dev, iters=5)
    t_2n = time_ms(lambda: unpack(2 * reps), dev, iters=5)
    ms = (t_2n - t_n) / reps
    packed = wp.numel()
    rate = f"{packed / (ms * 1e-3) / 1e9:6.1f} GB/s packed" if ms > 0 \
        else "rate not measured: t(2n) <= t(n)"
    where = "cpu" if dev.type != "cuda" else "warm"
    return {"exact": True, "ms": ms, "t_n_ms": t_n, "t_2n_ms": t_2n,
            "line": f"EXACT  {ms * 1e3:8.2f} us/unpack ({rate}), {where}; "
                    f"t(n={reps}) {t_n:.4f} ms, t(2n) {t_2n:.4f} ms"}


def main(argv=None, device="cuda", shape=(HALF, OUT)) -> dict:
    ap = argparse.ArgumentParser(prog="unpack_probe")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--variants", default=",".join(UNPACK_SCHEMES))
    args = ap.parse_args([] if argv is None else argv)
    dev = resolve(device)
    print(f"device: {label(dev)}  block: ({shape[0]}x{shape[1]}) packed",
          flush=True)
    res = {}
    for name in args.variants.split(","):
        res[name] = run(name, args.reps, dev, shape)
        print(f"[{name:7s}] {res[name]['line']}", flush=True)
    return res


if __name__ == "__main__":
    out = main(sys.argv[1:])
    sys.exit(0 if all(r["exact"] for r in out.values()) else 1)
