"""Resolution-bucketed batch sampling (own copy of the JAX package's
``data/bucketing.py``; numpy only).

Batches group images of similar size so the padded shapes stay few:
smallest-fitting bucket by an (h, w) boundary list plus an inf bucket,
shuffled bucket order and intra-bucket order from a seeded numpy generator.
"""

from __future__ import annotations

import numpy as np


class BucketBatchSampler:
    """Yields index batches grouped by image resolution.

    ``resolutions_fn(dataset, i) -> (h, w)`` lets callers avoid loading full
    images when sizes are known cheaply; the default indexes the dataset and
    reads the first item's shape (every example is materialised once).
    """

    def __init__(self, dataset, bucket_boundaries, batch_size, shuffle=True,
                 resolutions_fn=None, seed=0):
        if resolutions_fn is None:
            def resolutions_fn(ds, i):
                item = ds[i]
                img = item[0] if isinstance(item, tuple) else item
                return img.shape[-2], img.shape[-1]
        resolutions = np.array([resolutions_fn(dataset, i)
                                for i in range(len(dataset))])

        boundaries = list(bucket_boundaries) + [(float("inf"), float("inf"))]
        buckets = [[] for _ in boundaries]
        for i, (h, w) in enumerate(resolutions):
            for j, (bh, bw) in enumerate(boundaries):
                if h <= bh and w <= bw:
                    buckets[j].append(i)
                    break
        self.buckets = [np.array(b) for b in buckets if len(b) > 0]
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.dataset = dataset
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        # per-bucket ceil: __iter__ yields a ragged tail batch PER BUCKET
        return sum(-(len(b) // -self.batch_size) for b in self.buckets)

    def __iter__(self):
        order = np.arange(len(self.buckets))
        if self.shuffle:
            self.rng.shuffle(order)
        for bi in order:
            bucket = self.buckets[bi].copy()
            if self.shuffle:
                self.rng.shuffle(bucket)
            for i in range(0, len(bucket), self.batch_size):
                yield bucket[i:i + self.batch_size]


def default_bucket_boundaries(patch_size: int = 16):
    """Resolution buckets in pixels (h, w), from the dataset statistics the
    JAX package records."""
    return [
        (128, 512), (128, 1024), (192, 1024), (256, 1024),
        (256, 2048), (384, 2048), (512, 2048), (768, 3200),
    ]
