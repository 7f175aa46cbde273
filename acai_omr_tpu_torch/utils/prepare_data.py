"""Dataset preparation for PrIMuS and DoReMi (the twin of the JAX
package's ``utils/prepare_data.py``).

Flattens each corpus into ``<dst>/images/*.png`` + ``ids.csv``, the layout
``data.datasets.PreparedDataset`` reads: one greyscale PNG per id. DoReMi
pages are trimmed of their header and footer margins.

Run: ``python -m acai_omr_tpu_torch.utils.prepare_data {primus|doremi} SRC DST``
"""

from __future__ import annotations

import argparse
import csv
from pathlib import Path

from PIL import Image


def prepare_primus(src: Path, dst: Path) -> int:
    """Primus layout: <src>/<id>/<id>.png (one system per directory)."""
    images = dst / "images"
    images.mkdir(parents=True, exist_ok=True)
    rows = []
    for d in sorted(p for p in src.iterdir() if p.is_dir()):
        png = d / f"{d.name}.png"
        if not png.exists():
            continue
        img = Image.open(png).convert("L")
        img.save(images / f"{d.name}.png")
        rows.append(d.name)
    _write_ids(dst, rows)
    return len(rows)


def prepare_doremi(src: Path, dst: Path, crop_top: float = 0.08,
                   crop_bottom: float = 0.08) -> int:
    """DoReMi images: full pages; trim header/footer margins heuristically."""
    images = dst / "images"
    images.mkdir(parents=True, exist_ok=True)
    rows = []
    seen: dict = {}
    for png in sorted(src.rglob("*.png")):
        img = Image.open(png).convert("L")
        w, h = img.size
        img = img.crop((0, int(h * crop_top), w, int(h * (1 - crop_bottom))))
        # key by relative path, not bare stem: DoReMi organizes pages per
        # piece, and same-named pages in different directories would
        # overwrite each other. "_"-joined parts can still collide (a_b/c vs
        # a/b_c), so collisions get a numeric suffix: no image is dropped.
        name = "_".join(png.relative_to(src).with_suffix("").parts)
        if name in seen:
            # the suffixed name must be re-checked too: a renamed duplicate
            # of 'X' landing on 'X-1' would overwrite a genuine page 'X-1'
            while True:
                seen[name] += 1
                candidate = f"{name}-{seen[name]}"
                if candidate not in seen:
                    name = candidate
                    break
        seen.setdefault(name, 0)
        img.save(images / f"{name}.png")
        rows.append(name)
    _write_ids(dst, rows)
    return len(rows)


def _write_ids(dst: Path, ids) -> None:
    with open(dst / "ids.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["id"])
        for i in ids:
            w.writerow([i])


def main(argv=None):
    ap = argparse.ArgumentParser(description="prepare PrIMuS or DoReMi")
    ap.add_argument("corpus", choices=["primus", "doremi"])
    ap.add_argument("src", type=Path)
    ap.add_argument("dst", type=Path)
    args = ap.parse_args(argv)
    fn = prepare_primus if args.corpus == "primus" else prepare_doremi
    n = fn(args.src, args.dst)
    print(f"Prepared {n} images into {args.dst}")


if __name__ == "__main__":
    main()
