"""Does reading a head's columns straight out of a fused (T, E) buffer cost
anything on the card, against a pre-shaped (H, T, Dh) copy (K25)?

    python -m acai_omr_tpu_torch.tools.mosaic_head_access_probe
        [--shapes 256,1024,16 1024,768,12] [--iters 20]

Port of ``tools/mosaic_head_access_probe.py`` (``main``): per-head logits
S[h] = Q_h K_h^T, (H, T, T) fp32 from bf16 q and k, in the three forms the
TPU probe tries (``ops/head_logits_kernels.head_logits``): 1 ``lane_slice``
(one block per query tile loops over the heads, reading each head's 64
columns of row-major (T, E)), 2 ``reshape`` (a block per head and query
tile, the same strided columns), 3 ``preshaped`` (a block per head and query
tile over contiguous (H, T, 64)). Shapes (T, E, H): the TPU probe's (256,
1024, 16) and K3's encoder (1024, 768, 12). Per form: ``OK`` and the largest
|error| against the fp32 reference (the JAX tool's line), then ms a call
with its inputs from HBM, the bound (the fp32 output written once at 3.35
TB/s) and ``x bound``; last ``torch.matmul`` on the bf16 (H, T, Dh) views as
the yardstick (bf16 out: the library call, never the kernel).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..ops.head_logits_kernels import DH, FORMS, as_heads, head_logits
from ._probe import (PEAK_BF16_FLOP_PER_S, PEAK_BYTES_PER_S, cold_copies,
                     cpu_note, l2_bytes, label, resolve, residency, time_ms)

SHAPES = ((256, 1024, 16), (1024, 768, 12))
REL_TOL = 1e-5  # of the largest |logit|: exact products, fp32 sums reordered


def bound_ms(t: int, e: int, h: int) -> float:
    """Least ms of one call: q and k read once, the fp32 logits written once,
    or the 2 H T^2 Dh flops at the bf16 peak, whichever is longer."""
    nbytes = 2 * 2 * t * e + 4 * h * t * t
    return 1e3 * max(nbytes / PEAK_BYTES_PER_S,
                     2 * h * t * t * DH / PEAK_BF16_FLOP_PER_S)


def make_inputs(t: int, e: int, dev) -> tuple:
    """q, k (T, E) bf16 from ``default_rng(0)``, as the JAX tool draws them
    (float64 rounded once to bf16)."""
    rng = np.random.default_rng(0)
    q, k = (torch.from_numpy(rng.standard_normal((t, e))).to(torch.bfloat16)
            for _ in range(2))
    return q.to(dev), k.to(dev)


def run_shape(t: int, e: int, h: int, dev, iters: int) -> dict:
    q, k = make_inputs(t, e, dev)
    qh, kh = (as_heads(a, h).contiguous() for a in (q, k))
    ref = torch.einsum("htd,hsd->hts", qh.float(), kh.float())
    tol = REL_TOL * max(1.0, ref.abs().max().item())
    bound = bound_ms(t, e, h)
    in_bytes = 2 * 2 * t * e
    # rotate the inputs out of L2 on the card; not on the CPU
    copies = cold_copies(in_bytes, l2_bytes(dev)) if dev.type == "cuda" \
        else 1
    note = cpu_note(dev)
    print(f"T={t} E={e} H={h} Dh={DH}: q, k bf16 {in_bytes / 2 ** 20:.1f} "
          f"MiB, logits fp32 {4 * h * t * t / 2 ** 20:.1f} MiB; bound "
          f"{bound:.4f} ms{note}", flush=True)
    rows = {}
    for n, form in enumerate(FORMS, 1):
        a, b = (qh, kh) if form == "preshaped" else (q, k)
        try:
            err = (head_logits(a, b, form, h) - ref).abs().max().item()
        except Exception as exc:  # noqa: BLE001 - reported as the JAX tool does
            print(f"{n} {form}: FAIL  {str(exc).splitlines()[0][:160]}{note}",
                  flush=True)
            rows[form] = {"ok": False, "error": str(exc)}
            continue
        ok = err <= tol
        sets = [(a, b)] + [(a.clone(), b.clone()) for _ in range(copies - 1)]
        ms = time_ms(lambda i: head_logits(*sets[i], form, h), dev,
                     iters=iters, copies=copies)
        where = residency(dev, copies, in_bytes)
        rows[form] = {"ok": ok, "max_abs_err": err, "tol": tol, "ms": ms,
                      "bound_ms": bound, "where": where}
        ratio = f", {ms / bound:.1f}x bound" if dev.type == "cuda" else ""
        print(f"{n} {form}: {'OK' if ok else 'FAIL'}  max_abs_err={err:.3e} "
              f"(tol {tol:.1e})  {ms:.4f} ms{ratio}, {where}{note}",
              flush=True)
        del sets
    lib = time_ms(lambda: torch.matmul(as_heads(q, h), as_heads(k, h)
                                       .transpose(-1, -2)), dev, iters=iters)
    ratio = f", {lib / bound:.1f}x bound" if dev.type == "cuda" else ""
    print(f"torch.matmul on the (H, T, Dh) views, bf16 out (yardstick): "
          f"{lib:.4f} ms{ratio}{note}", flush=True)
    return {"shape": (t, e, h), "forms": rows, "bound_ms": bound,
            "library_ms": lib}


def main(argv=None, device="cuda", shapes=SHAPES) -> dict:
    ap = argparse.ArgumentParser(prog="mosaic_head_access_probe")
    ap.add_argument("--shapes", nargs="*", default=None,
                    help="T,E,H triples")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args([] if argv is None else argv)
    if args.shapes:
        shapes = [tuple(int(v) for v in s.split(",")) for s in args.shapes]
    dev = resolve(device)
    print(f"device: {label(dev)}", flush=True)
    res = {"shapes": [run_shape(t, e, h, dev, args.iters)
                      for t, e, h in shapes]}
    res["ok"] = all(r["ok"] for s in res["shapes"]
                    for r in s["forms"].values())
    return res


if __name__ == "__main__":
    sys.exit(0 if main(sys.argv[1:])["ok"] else 1)
