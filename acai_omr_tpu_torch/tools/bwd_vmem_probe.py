"""Which kernels of the hand-written backward spill registers, and what limits
their occupancy, stage by stage?

    python -m acai_omr_tpu_torch.tools.bwd_vmem_probe \
        {full|nocross|noself|noffn|attnonly}

Port of ``tools/bwd_vmem_probe.py``, which compiles the fused decoder
backward (``pallas_train_layer._bwd_call``) with stages stubbed by
``set_ablate`` and reports which stage ran out of VMEM. On the card the same
question reads: does a kernel need more registers than it gets (local
memory: spill and stack), and how many of its blocks fit an SM. So this runs
one backward of the decoder stack (``train_layer_kernel.decoder_stack_fused``
under autograd; its forward keeps ``_bwd_call``'s current seven saves a
layer: x, z1, z2, z3, h1, gelu', qkv) with the mode's stages stubbed by
``train_layer_kernel.set_ablate``, and prints for every kernel variant the
backward launched: launches, registers a thread, local bytes a thread, static
and dynamic shared bytes a block, and blocks an SM (``KernelOp.resources``,
``csrc/func_attrs.cuh``); then the backward's device time and peak device
memory (the second backward of the process: the first loads the kernels'
modules) beside the full backward's bound, in ``full`` also the plain twins'
backward under autograd, and ``<mode>: OK`` or ``<mode>: FAIL ...``. FAIL: the backward
raised, a gradient is not finite, or (on the card) the launches differ from
the layer arithmetic of the mode.

Shapes from the environment as the JAX tool reads them, with its defaults:
PB=8 PT=256 PM=1024 PE=1024 PH=16 PF=4096 PL=12, bf16, weights and inputs
from seed 0, every key valid, no dropout. The JAX tool at this revision
builds six saves and fails before it compiles (``_bwd_call`` unpacks seven);
the port follows ``_bwd_call``.
"""

from __future__ import annotations

import os
import sys
import time
import traceback

import torch

from ..ops import _build
from ..ops import train_layer_kernel as tlk
from ..ops import transformer
from ._probe import (PEAK_BF16_FLOP_PER_S, PEAK_BYTES_PER_S, cpu_note, label,
                     resolve)

MODES = tlk.ABLATE_MODES
_ENV = (("b", "PB", 8), ("t", "PT", 256), ("m", "PM", 1024), ("e", "PE", 1024),
        ("h", "PH", 16), ("f", "PF", 4096), ("l", "PL", 12))


def shapes() -> dict:
    return {k: int(os.environ.get(var, default)) for k, var, default in _ENV}


def expected_launches(mode: str, layers: int) -> dict:
    """Wrapper calls of one decoder backward under ``mode``, per op. A layer
    in full: three K8, the x2 and x1 LayerNorm recomputes (K4), the qc
    projection (K1), both attention recomputes (K3), six K9 dgrad (du, dx2,
    da_c, dx1, da_s, dx), six K9 wgrad, two K7."""
    per = {"layernorm_bwd": 3, "add_layernorm": 2, "linear_bias_act": 1,
           "encoder_attention": 2, "linear_dgrad": 6, "linear_wgrad": 6,
           "attention_bwd": 2}
    stubbed = {
        "noffn": {"add_layernorm": 1, "linear_dgrad": 2, "linear_wgrad": 2},
        "nocross": {"add_layernorm": 1, "linear_bias_act": 1,
                    "encoder_attention": 1, "linear_dgrad": 2,
                    "linear_wgrad": 2, "attention_bwd": 1},
        "noself": {"encoder_attention": 1, "linear_dgrad": 2,
                   "linear_wgrad": 2, "attention_bwd": 1},
    }.get(mode, {})
    return {k: layers * (n - stubbed.get(k, 0)) for k, n in per.items()}


def make_inputs(s: dict, dev) -> tuple:
    """Seeded decoder weights (bf16 leaves), x, mem_kv, the validity masks
    and the output's gradient."""
    gen = torch.Generator().manual_seed(0)
    stacked = transformer.stack_init(transformer.decoder_layer_init, gen,
                                     s["l"], s["e"], s["f"],
                                     dtype=torch.bfloat16, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    randn = lambda *shape: torch.randn(*shape, generator=g, device=dev) \
        .to(torch.bfloat16)
    x = randn(s["b"], s["t"], s["e"])
    mem_kv = randn(s["l"], s["b"], s["m"], 2 * s["e"])
    sv = torch.ones(s["b"], s["t"], dtype=torch.bool, device=dev)
    mv = torch.ones(s["b"], s["m"], dtype=torch.bool, device=dev)
    return stacked, x, mem_kv, sv, mv, randn(s["b"], s["t"], s["e"])


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def bound_ms(s: dict) -> float:
    """Least ms of the full decoder backward on an H100: its products (each
    forward product's dgrad and wgrad, the qc recompute) and attention (the
    recomputed QKᵀ and PV and the backward's four products, causal self
    over the (T + 1) / 2 keys a query sees on average, cross over M) at the
    bf16 peak, or its bytes (the seven saves, mem_kv, the weights read once;
    dx, d(mem_kv), the weight gradients written once) at 3.35 TB/s,
    whichever is longer."""
    b, t, m, e, h, f, n_l = (s[k] for k in "btmehfl")
    r, dh = b * t, e // h
    products = 2 * 2 * r * e * (6 * e + 2 * f) + 2 * r * e * e
    attention = 6 * 2 * b * h * t * dh * ((t + 1) / 2 + m)
    nbytes = 2 * (r * (7 * e + 2 * f) + 2 * 2 * b * m * 2 * e
                  + 2 * e * (6 * e + 2 * f)) + 2 * 2 * r * e / n_l
    return 1e3 * n_l * max((products + attention) / PEAK_BF16_FLOP_PER_S,
                           nbytes / PEAK_BYTES_PER_S)


def backward(mode: str, s: dict, dev, plain: bool = False) -> dict:
    """One decoder backward under ``mode``, after one untimed forward and
    backward (the first launch of each kernel in a process loads its module):
    launches, device ms, peak bytes, whether every gradient is finite.
    ``plain``: the plain twins under autograd instead (no stage stubbed)."""
    stacked, x, mem_kv, sv, mv, gout = make_inputs(s, dev)
    leaves = [x, mem_kv, *_leaves(stacked)]
    for a in leaves:
        a.requires_grad_(True)
    cuda = dev.type == "cuda"
    tlk.set_ablate(mode)
    try:
        run = lambda: tlk.decoder_stack_fused(stacked, x, mem_kv, sv, mv,
                                              s["h"], plain=plain)
        run().backward(gout)
        for a in leaves:
            a.grad = None
        out = run()
        if cuda:
            torch.cuda.synchronize(dev)
            held = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
        before = _counts()
        t0 = time.perf_counter()
        if cuda:
            start.record()
        out.backward(gout)
        if cuda:
            end.record()
            end.synchronize()
        ms = start.elapsed_time(end) if cuda else \
            1e3 * (time.perf_counter() - t0)
    finally:
        tlk.set_ablate("full")
    launched = _launched_since(before)
    return {"ms": ms, "launched": launched,
            "launches": {n: k for n, (k, _) in launched.items()},
            "peak_bytes": torch.cuda.max_memory_allocated(dev) if cuda
            else None,
            "bytes_before": held if cuda else None,
            "finite": all(bool(torch.isfinite(a.grad).all()) for a in leaves)}


def _counts() -> dict:
    return {n: (op.launches, dict(op.variants))
            for n, op in _build.REGISTRY.items()}


def _launched_since(before: dict) -> dict:
    """{op: (launches, {variant: launches})} since ``before`` (the counts are
    the whole process's; a caller's own counting is left as it was)."""
    out = {}
    for n, (k, variants) in _counts().items():
        k0, v0 = before.get(n, (0, {}))
        if k > k0:
            out[n] = (k - k0, {v: c - v0.get(v, 0) for v, c in variants.items()
                               if c > v0.get(v, 0)})
    return out


def resource_rows(launched: dict) -> list[dict]:
    """The resource rows of every kernel variant the backward launched."""
    rows = []
    for name, (k, variants) in launched.items():
        for r in _build.REGISTRY[name].resources():
            if r["variant"] == "" or r["variant"] in variants:
                rows.append({**r, "launches": variants.get(r["variant"], k)})
    return rows


def main(argv=None, device="cuda") -> dict:
    argv = [] if argv is None else list(argv)
    mode = argv[0] if argv else "full"
    if mode not in MODES:
        raise SystemExit(f"mode must be one of {MODES}, got {mode!r}")
    dev = resolve(device)
    note = cpu_note(dev)
    s = shapes()
    print(f"device: {label(dev)}; mode {mode}; B={s['b']} T={s['t']} "
          f"M={s['m']} E={s['e']} H={s['h']} F={s['f']} L={s['l']} bf16"
          + note, flush=True)
    res = {"mode": mode, "shapes": s, "ok": False}
    try:
        run = backward(mode, s, dev)
    except Exception as exc:  # noqa: BLE001 - reported as the JAX tool does
        print(f"{mode}: FAIL {str(exc).splitlines()[0][:200]}{note}",
              flush=True)
        res["error"] = traceback.format_exc()
        return res
    want = {k: n for k, n in expected_launches(mode, s["l"]).items() if n}
    rows = resource_rows(run["launched"]) if dev.type == "cuda" else []
    res.update(backward_ms=run["ms"], peak_bytes=run["peak_bytes"],
               launches=run["launches"], expected_launches=want,
               finite=run["finite"], resources=rows)
    if rows:
        print(f"{'kernel (variant)':44s} {'launches':>8s} {'regs':>5s} "
              f"{'local':>6s} {'static':>7s} {'dynamic':>8s} {'blocks/SM':>9s}",
              flush=True)
        for r in rows:
            name = f"{r['op']} {r['kernel']}" + (
                f" ({r['variant']})" if r["variant"] else "")
            print(f"{name:44s} {r['launches']:8d} {r['registers']:5d} "
                  f"{r['local_bytes']:6d} {r['static_smem']:7d} "
                  f"{r['dynamic_smem']:8d} {r['blocks_per_sm']:9d}",
                  flush=True)
    else:
        print(f"launches and resources: not counted on the CPU (no kernel "
              f"launches){note}", flush=True)
    if dev.type == "cuda":
        res["bound_ms"] = bound_ms(s)
        print(f"backward {run['ms']:.3f} ms on the card, peak device memory "
              f"{run['peak_bytes'] / 2 ** 30:.2f} GiB "
              f"({run['bytes_before'] / 2 ** 30:.2f} GiB held before it); "
              f"the full backward's bound {res['bound_ms']:.3f} ms",
              flush=True)
        if mode == "full":
            res["plain_ms"] = backward(mode, s, dev, plain=True)["ms"]
            print(f"the plain twins under autograd: {res['plain_ms']:.3f} ms "
                  f"(library: none, no one PyTorch call runs the stack's "
                  f"backward)", flush=True)
    else:
        print(f"backward {run['ms']:.1f} ms{note}", flush=True)
    faults = []
    if not run["finite"]:
        faults.append("a gradient is not finite")
    if dev.type == "cuda" and run["launches"] != want:
        faults.append(f"launches {run['launches']} != {want}")
    res["ok"] = not faults
    print(f"{mode}: OK{note}" if res["ok"]
          else f"{mode}: FAIL {'; '.join(faults)}{note}", flush=True)
    return res


if __name__ == "__main__":
    sys.exit(0 if main(sys.argv[1:])["ok"] else 1)
