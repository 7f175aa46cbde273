"""Batched single-query attention logits and their column sums on the card
(K26), in fp32 and int8.

    python -m acai_omr_tpu_torch.tools.mosaic_batched_attn_probe [--iters 20]

Port of ``tools/mosaic_batched_attn_probe.py`` (``run``): for BT = 8 images
of T = 128 keys, E = 1024, H = 16 heads of 64, the per-head logits
``compact[t, b H + h] = k[b, t, head h] . q[b, head h]`` (T, BT H), their
column sums (1, BT H) and the sums' transpose (BT H, 1)
(``ops/head_logits_kernels.batched_head_logits``). The int8 variant rounds q
to int8 and sums int8 x int8 products in int32. The TPU tool checks the
Mosaic constructs of a block-diagonal product; the port computes the same
three outputs per (image, head) and keeps the tool's checks: the three error
lines against the same numpy oracle, with its limits (fp32 < 1e-2, int8
< 1e-6, the transpose exactly equal; AssertionError past them), then
``all constructs OK``. Each
variant adds ms a call with k from HBM, the bound (k read once at 3.35 TB/s)
and, for fp32, ``torch.einsum``'s time on the same inputs.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..ops.head_logits_kernels import DH, batched_head_logits
from ._probe import (PEAK_BYTES_PER_S, cold_copies, cpu_note, l2_bytes, label,
                     resolve, residency, time_ms)

BT, T, E, H = 8, 128, 1024, 16


def make_inputs(int8: bool, bt=BT, t=T, e=E) -> tuple:
    """(k, q) as numpy arrays, drawn from ``default_rng(0)`` as the JAX tool
    draws them: int8 k and integer-valued fp32 q in [-127, 127], or standard
    normal fp32."""
    rng = np.random.default_rng(0)
    if int8:
        k = rng.integers(-127, 128, (bt, t, e)).astype(np.int8)
        q = rng.integers(-127, 128, (bt, e)).astype(np.float32)
    else:
        k = rng.standard_normal((bt, t, e)).astype(np.float32)
        q = rng.standard_normal((bt, e)).astype(np.float32)
    return k, q


def oracle(k: np.ndarray, q: np.ndarray, int8: bool, h: int) -> np.ndarray:
    """The JAX tool's numpy oracle: (T, BT H) per-head logits."""
    bt, t, e = k.shape
    dh = e // h
    kf, qf = k.astype(np.float32), q.astype(np.float32)
    want = np.zeros((t, bt * h), np.float32)
    for b in range(bt):
        for hh in range(h):
            qsel = np.zeros(e, np.float32)
            part = qf[b, hh * dh:(hh + 1) * dh]
            qsel[hh * dh:(hh + 1) * dh] = np.round(part) if int8 else part
            want[:, b * h + hh] = kf[b] @ qsel
    return want


def run(int8: bool, device="cuda", iters: int = 20,
        shape=(BT, T, E, H)) -> dict:
    bt, t, e, h = shape
    dev = resolve(device)
    note = cpu_note(dev)
    k_np, q_np = make_inputs(int8, bt, t, e)
    k, q = torch.from_numpy(k_np).to(dev), torch.from_numpy(q_np).to(dev)
    out, outc, col = (a.cpu().numpy() for a in batched_head_logits(k, q, h))
    want = oracle(k_np, q_np, int8, h)
    name = "int8" if int8 else "f32"
    err = np.abs(out - want).max() / (np.abs(want).max() + 1e-9)
    print(f"{name}: compact rel err {err:.2e}{note}", flush=True)
    wantc = want.sum(axis=0, keepdims=True)
    errc = np.abs(outc - wantc).max() / (np.abs(wantc).max() + 1e-9)
    print(f"  colsum rel err {errc:.2e}{note}", flush=True)
    errt = np.abs(col[:, 0] - outc[0, :]).max()
    print(f"  transpose abs err {errt:.2e}{note}", flush=True)
    tol = 1e-6 if int8 else 1e-2
    if not (err < tol and errc < tol and errt == 0.0):  # the JAX tool's limits
        raise AssertionError(f"{name}: compact {err:.2e}, colsum {errc:.2e} "
                             f"(limit {tol:.0e}), transpose {errt:.2e} (0)")

    nbytes = k.numel() * k.element_size()
    # rotate k out of L2 on the card; the CPU has nothing to rotate out of
    copies = cold_copies(nbytes, l2_bytes(dev)) if dev.type == "cuda" else 1
    ks = [k] + [k.clone() for _ in range(copies - 1)]
    ms = time_ms(lambda i: batched_head_logits(ks[i], q, h), dev, iters=iters,
                 copies=copies)
    bound = 1e3 * (nbytes + q.numel() * 4 + 4 * (t + 2) * bt * h) \
        / PEAK_BYTES_PER_S
    where = residency(dev, copies, nbytes)
    lib = None
    if not int8:
        q3 = q.view(bt, h, DH)
        lib = time_ms(lambda i: torch.einsum(
            "bthd,bhd->tbh", ks[i].view(bt, t, h, DH), q3), dev, iters=iters,
            copies=copies)
    ratio = f" ({ms / bound:.1f}x)" if dev.type == "cuda" else ""
    print(f"  {ms:.4f} ms a call, bound {bound:.4f} ms{ratio}, {where}; "
          f"library "
          + ("none (no int8 einsum)" if lib is None
             else f"torch.einsum {lib:.4f} ms") + note, flush=True)
    return {"compact_rel_err": float(err), "colsum_rel_err": float(errc),
            "transpose_abs_err": float(errt), "ms": ms, "bound_ms": bound,
            "library_ms": lib, "where": where}


def main(argv=None, device="cuda", shape=(BT, T, E, H)) -> dict:
    ap = argparse.ArgumentParser(prog="mosaic_batched_attn_probe")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args([] if argv is None else argv)
    dev = resolve(device)
    print(f"device: {label(dev)}", flush=True)
    res = {"f32": run(False, dev, args.iters, shape),
           "int8": run(True, dev, args.iters, shape)}
    print(f"all constructs OK{cpu_note(dev)}", flush=True)
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
