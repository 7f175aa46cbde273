"""Offline dataset statistics: resolution, aspect and patch-count
percentiles (the twin of the JAX package's ``utils/calc_dataset_stats.py``).

Used to choose the PE grid and the token budgets; also derives suggested
bucket boundaries for :class:`..data.bucketing.BucketBatchSampler`. Images
are read with PIL (their headers only).

Run: ``python -m acai_omr_tpu_torch.utils.calc_dataset_stats DIR [DIR...]``
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
from PIL import Image


def collect_stats(paths, patch_size: int = 16, limit: int | None = None):
    widths, heights = [], []
    files = []
    for root in paths:
        files += [p for p in Path(root).rglob("*") if p.suffix.lower() in
                  (".png", ".jpg", ".jpeg")]
    if limit:
        files = files[:limit]
    for p in files:
        try:
            with Image.open(p) as img:
                w, h = img.size
        except Exception:
            continue
        widths.append(w)
        heights.append(h)
    widths = np.asarray(widths)
    heights = np.asarray(heights)
    aspects = widths / np.maximum(heights, 1)
    patches = (widths // patch_size) * (heights // patch_size)
    return {"widths": widths, "heights": heights, "aspects": aspects,
            "patch_counts": patches}


def summarize(stats: dict) -> dict:
    out = {}
    for k, v in stats.items():
        if len(v) == 0:
            continue
        out[k] = {
            "min": float(v.min()), "max": float(v.max()),
            "mean": float(v.mean()),
            "p50": float(np.percentile(v, 50)),
            "p90": float(np.percentile(v, 90)),
            "p99": float(np.percentile(v, 99)),
        }
    return out


def suggest_buckets(stats: dict, num_buckets: int = 8,
                    patch_size: int = 16):
    """Quantile-based (h, w) bucket boundaries minimizing padding waste,
    aligned to ``patch_size`` (the same value collect_stats used)."""
    hs, ws = stats["heights"], stats["widths"]
    if len(hs) == 0:
        return []
    p = patch_size
    qs = np.linspace(1.0 / num_buckets, 1.0, num_buckets)
    return [(int(np.ceil(np.quantile(hs, q) / p) * p),
             int(np.ceil(np.quantile(ws, q) / p) * p)) for q in qs]


def main(argv=None):
    ap = argparse.ArgumentParser(description="dataset image statistics")
    ap.add_argument("dirs", nargs="+")
    ap.add_argument("--patch-size", type=int, default=16)
    ap.add_argument("--limit", type=int, default=None)
    args = ap.parse_args(argv)
    stats = collect_stats(args.dirs, args.patch_size, args.limit)
    import json
    print(json.dumps(summarize(stats), indent=2))
    print("suggested bucket boundaries:",
          suggest_buckets(stats, patch_size=args.patch_size))


if __name__ == "__main__":
    main()
