"""Training observability: a CSV scalar sink (the twin of the JAX package's
``utils/metrics.py`` without its TensorBoard writer, which needs a package
the GPU machine does not carry)."""

from __future__ import annotations

import csv
from pathlib import Path


class MetricsWriter:
    """Buffers (step, tag, value) rows and appends them to a CSV on flush."""

    def __init__(self, csv_path: str | None = None):
        self.csv_path = Path(csv_path) if csv_path else None
        self._rows = []

    def scalar(self, tag: str, value, step: int) -> None:
        if self.csv_path:
            self._rows.append({"step": step, "tag": tag,
                               "value": float(value)})

    def scalars(self, prefix: str, values: dict, step: int) -> None:
        for k, v in values.items():
            self.scalar(f"{prefix}/{k}", v, step)

    def flush(self) -> None:
        if not (self.csv_path and self._rows):
            return
        self.csv_path.parent.mkdir(parents=True, exist_ok=True)
        exists = self.csv_path.exists()
        with open(self.csv_path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=["step", "tag", "value"])
            if not exists:
                w.writeheader()
            w.writerows(self._rows)
        self._rows = []
