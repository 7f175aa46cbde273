"""Microbenchmark of single-query decode-attention formulations on the card.

    python -m acai_omr_tpu_torch.tools.attn_microbench

Port of ``tools/attn_microbench.py`` (``main`` :191). One query per (row,
head) against lane-major kT / vT (B, H, Dh, T) at B = 32, H = 16, Dh = 64,
T = 512, bf16 and int8 caches (fp32 (B, H, T) scales), timed in turns:

  * the PyTorch form of ``xla_attn`` (:67), K17 / K18's plain twin: einsums
    of the upcast operands, fp32 softmax, the reference every other line's
    maxerr is read against;
  * ``scaled_dot_product_attention`` with one query (bf16), the library call;
  * "perhead": the per-op decode step's K11 / K12, the counterparts of
    ``pallas_decode.decode_attention``;
  * "blockdiag": K17, the block-diagonal tensor-core form, bf16 at bt 2 / 4 /
    8 and int8 at bt 4 / 8, each on one thread-block cluster a row with the
    keys split across it as ``blockdiag_plan`` says (the line names the
    split; ``bt`` no longer shapes the grid, so the lines of one cache read
    alike);
  * "batcheddot": K18, one warp per (row, head), bf16 at bt 4.

Each line prints microseconds, the bound (K and V read once, plus the
scales for int8, at 3.35 TB/s) and the maxerr against the reference.
"""

from __future__ import annotations

import sys

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.decode_hd_kernel import decode_attention_hd, decode_attention_hd_int8
from ..ops.probe_kernels import (batched_decode_attention,
                                 blockdiag_decode_attention, blockdiag_plan,
                                 decode_attention_probe_plain)
from ._probe import PEAK_BYTES_PER_S, label, resolve, time_ms

B, H, DH, T = 32, 16, 64, 512


def make_inputs(cache_dtype=torch.bfloat16, device="cuda", shape=None):
    """The JAX script's inputs (numpy seed 0): q (B, H, Dh) bf16, kT / vT
    (B, H, Dh, T) bf16, or int8 with their fp32 (B, H, T) absmax / 127
    scales, and a zero bias (B, T) fp32. Returns (q, kT, vT, bias, ks, vs),
    the scales None for bf16."""
    b, h, dh, t = shape or (B, H, DH, T)
    dev = resolve(device)
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((b, h, dh))).to(dev,
                                                               torch.bfloat16)
    k = rng.standard_normal((b, h, dh, t))
    v = rng.standard_normal((b, h, dh, t))
    bias = torch.zeros((b, t), dtype=torch.float32, device=dev)
    if cache_dtype == torch.int8:
        ks = np.abs(k).max(axis=2) / 127.0
        vs = np.abs(v).max(axis=2) / 127.0
        kq = np.clip(np.round(k / ks[:, :, None, :]), -127, 127).astype(np.int8)
        vq = np.clip(np.round(v / vs[:, :, None, :]), -127, 127).astype(np.int8)
        return (q, torch.from_numpy(kq).to(dev), torch.from_numpy(vq).to(dev),
                bias, torch.from_numpy(ks).to(dev, torch.float32),
                torch.from_numpy(vs).to(dev, torch.float32))
    return (q, torch.from_numpy(k).to(dev, torch.bfloat16),
            torch.from_numpy(v).to(dev, torch.bfloat16), bias, None, None)


def torch_attn(q, kT, vT, bias, ks, vs):
    """``xla_attn``: bf16 operands multiplied with fp32 sums, scaled logits
    (times ks for int8) plus bias, fp32 softmax (times vs for int8), the
    weights rounded to bf16 before the V sum, bf16 out; the roundings K17 and
    K18 keep, so it is their twin."""
    return decode_attention_probe_plain(q, kT, vT, bias, ks, vs, bt=1)


def bound_ms(kT, ks=None) -> float:
    """K and V read once (and the fp32 scales of both), at 3.35 TB/s."""
    n = 2 * kT.numel() * kT.element_size()
    if ks is not None:
        n += 2 * ks.numel() * 4
    return 1e3 * n / PEAK_BYTES_PER_S


def _line(name: str, us: float, bound: float, err=None, what="maxerr"):
    tail = "" if err is None else f"  ({what} {err:.2e})"
    print(f"{name:29s} {us:8.1f} us  {us / (1e3 * bound):6.2f}x bound{tail}",
          flush=True)


def main(argv=None, device="cuda", shape=None, reps: int = 200) -> list:
    dev = resolve(device)
    print(f"device: {label(dev)}", flush=True)
    rows = []

    def timed(name, fn, bound, ref=None, what="maxerr", **kw):
        err = None
        if ref is not None:
            err = (fn().float() - ref.float()).abs().max().item()
        us = 1e3 * time_ms(fn, dev, iters=reps, reps=1)
        _line(name, us, bound, err, what)
        rows.append({"name": name, "us": us, "bound_us": 1e3 * bound,
                     "max_abs_err": err, **kw})

    qb, kb, vb, bias, _, _ = make_inputs(torch.bfloat16, dev, shape)
    qi, ki, vi, bias_i, ks, vs = make_inputs(torch.int8, dev, shape)
    ref = torch_attn(qb, kb, vb, bias, None, None)
    bb, bi = bound_ms(kb), bound_ms(ki, ks)

    timed("torch bf16:", lambda: torch_attn(qb, kb, vb, bias, None, None), bb)
    timed("torch int8:", lambda: torch_attn(qi, ki, vi, bias_i, ks, vs), bi)
    ql = qb[:, :, None, :]
    kl, vl = (a.transpose(-1, -2).contiguous() for a in (kb, vb))
    timed("sdpa bf16:", lambda: F.scaled_dot_product_attention(ql, kl, vl),
          bb)
    timed("perhead bf16:", lambda: decode_attention_hd(qb, kb, vb, bias), bb,
          ref, kernel="decode_attention_hd")
    timed("perhead int8:", lambda: decode_attention_hd_int8(
        qi, ki, vi, ks, vs, bias_i), bi, kernel="decode_attention_hd_int8")
    b, _, dh, t = kb.shape
    split = {c: blockdiag_plan(b, t, dh, c == "int8")[1]
             for c in ("bf16", "int8")}
    for bt in (2, 4, 8):
        timed(f"blockdiag bf16 bt={bt} split{split['bf16']}:",
              lambda: blockdiag_decode_attention(qb, kb, vb, bias, bt=bt), bb,
              ref, kernel="blockdiag_decode_attention", bt=bt,
              split=split["bf16"])
    for bt in (4, 8):
        timed(f"blockdiag int8 bt={bt} split{split['int8']}:",
              lambda: blockdiag_decode_attention(
                  qi, ki, vi, bias_i, ks, vs, bt=bt), bi, ref,
              "maxerr-vs-bf16", kernel="blockdiag_decode_attention", bt=bt,
              split=split["int8"])
    timed("batcheddot bf16 bt=4:", lambda: batched_decode_attention(
        qb, kb, vb, bias, bt=4), bb, ref, kernel="batched_decode_attention",
        bt=4)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
