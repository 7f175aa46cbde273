"""How much on-chip scratch one block of the card can hold (K19).

    python -m acai_omr_tpu_torch.tools.vmem_probe [KB ...]

Port of ``tools/vmem_probe.py`` (``probe`` :13): a trivial kernel with an
(n, 128) bf16 scratch, here dynamic shared memory, launched with a growing
scratch until the card refuses it. The sizes are KB (the TPU's were MB);
without arguments the probe tries 16, 32, 64, 96, 128, 160, 192, 224 and
1024 KB, then every KB after the last that launched up to the first
refused. It prints the largest size that launched beside
cudaDevAttrMaxSharedMemoryPerBlockOptin and whether the 227 KB that
``ops/decode_hd_kernel.py`` assumes (``MAX_KEYS``) holds. The refusal past
the limit is the probe's answer, printed with its CUDA error.
"""

from __future__ import annotations

import sys

import torch

from ..ops.probe_kernels import SmemRefused, smem_optin_bytes, smem_probe
from ._probe import label, resolve

COARSE_KB = [16, 32, 64, 96, 128, 160, 192, 224]
ASSUMED_KB = 227  # ops/decode_hd_kernel.py: MAX_KEYS = 227 * 1024 // 4 - ...


def probe(kb: int, device="cuda") -> bool:
    """Whether a block with ``kb`` KB of scratch launches; its row 0 must come
    back doubled."""
    dev = resolve(device)
    x = torch.arange(8 * 128, dtype=torch.float32, device=dev) \
        .reshape(8, 128).to(torch.bfloat16)
    try:
        out = smem_probe(x, kb * 1024)
    except SmemRefused as e:
        print(f"  {kb} KB failed: {e}", file=sys.stderr, flush=True)
        return False
    if not torch.equal(out[0], x[0] * 2):
        raise RuntimeError(f"smem_probe at {kb} KB: row 0 is not x[0] * 2")
    return True


def main(argv=None, device="cuda", limit_kb: int = 1024) -> dict:
    """Walk the sizes (``argv``: KB, in order) until one is refused, or
    search: the coarse sizes and ``limit_kb``, then every KB after the last
    that launched up to the first refused. Returns the largest size that
    launched, the first refused (None if none was) and the device's
    attribute (None on the CPU, where the twin has no limit)."""
    dev = resolve(device)
    print(f"device: {label(dev)}", flush=True)

    def tried(kb):
        ok = probe(kb, dev)
        print(f"smem scratch {kb} KB: {'OK' if ok else 'FAIL'}", flush=True)
        return ok

    largest, refused = 0, None
    for kb in [int(s) for s in argv] if argv else COARSE_KB + [limit_kb]:
        if not tried(kb):
            refused = kb
            break
        largest = kb
    if not argv and refused is not None:
        for kb in range(largest + 1, refused):
            if not tried(kb):
                refused = kb
                break
            largest = kb
    optin = smem_optin_bytes() if dev.type == "cuda" else None
    holds = None if optin is None else \
        optin >= ASSUMED_KB * 1024 and largest >= ASSUMED_KB
    print(f"largest scratch that launched: {largest} KB ({largest * 1024} "
          f"bytes); first refused: {refused} KB; "
          f"cudaDevAttrMaxSharedMemoryPerBlockOptin: "
          f"{'not measured' if optin is None else f'{optin} bytes'}; "
          f"the {ASSUMED_KB} KB of decode_hd_kernel.MAX_KEYS: "
          f"{'not measured' if holds is None else ('holds' if holds else 'does NOT hold')}",
          flush=True)
    return {"largest_kb": largest, "refused_kb": refused,
            "optin_bytes": optin, "assumed_holds": holds}


if __name__ == "__main__":
    res = main(sys.argv[1:])
    sys.exit(0 if res["refused_kb"] is not None else 1)
