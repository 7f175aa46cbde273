"""Dataset classes of stage-2 training: GrandStaff-LMX and OLiMPiC (own copy
of the seq2seq half of the JAX package's ``data/datasets.py``).

Same on-disk layouts, split files, transform hooks and wrapper semantics;
items are numpy arrays / python strings consumed by the bucket loader.
Neither dataset is in the repository: :class:`DebugDataset` generates the
seeded synthetic examples the tests and ``chip_smoke.py`` train on.
``pandas`` is imported where a split file is read, not with the module.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
from PIL import Image


class LMXDataset:
    """Base: CSV split file -> example ids."""

    def __init__(self, root_dir, split_file_name, img_transform=None,
                 lmx_transform=None):
        import pandas as pd
        self.root_dir = Path(root_dir)
        self.id_df = pd.read_csv(self.root_dir / split_file_name, header=None)
        self.img_transform = img_transform
        self.lmx_transform = lmx_transform

    def __len__(self):
        return len(self.id_df)

    def _load_img(self, path) -> Image.Image:
        return Image.open(path).convert("L")

    def _load_lmx(self, path) -> str:
        with open(path, "r") as f:
            lmx = f.read()
        return self.lmx_transform(lmx) if self.lmx_transform else lmx


class GrandStaffLMXDataset(LMXDataset):
    """(original, distorted-resized, lmx)."""

    def __getitem__(self, idx):
        ex_id = self.id_df.iat[idx, 0]
        original = self._load_img(self.root_dir / "grandstaff" / (ex_id + ".jpg"))
        distorted = self._load_img(
            self.root_dir / "grandstaff" / (ex_id + "_distorted.jpg"))
        distorted = distorted.resize(original.size,
                                     resample=Image.Resampling.BILINEAR)
        if self.img_transform:
            original = self.img_transform(original)
            distorted = self.img_transform(distorted)
        return original, distorted, self._load_lmx(self.root_dir / (ex_id + ".lmx"))


class OlimpicDataset(LMXDataset):
    """(img, lmx) for synthetic/scanned OLiMPiC."""

    def __getitem__(self, idx):
        ex_id = self.id_df.iat[idx, 0]
        img = self._load_img(self.root_dir / (ex_id + ".png"))
        if self.img_transform:
            img = self.img_transform(img)
        return img, self._load_lmx(self.root_dir / (ex_id + ".lmx"))


class GrandStaffOMRTrainWrapper:
    """(input_img, lmx): with probability ``augment_p`` the transformed
    distorted image, else the original."""

    def __init__(self, base_dataset, augment_p=0.0, transform=None, rng=None):
        if augment_p > 0 and transform is None:
            raise ValueError("Augmentation transform must be specified for "
                             "non-zero augment_p")
        self.base_dataset = base_dataset
        self.augment_p = augment_p
        self.transform = transform
        self.rng = rng or np.random.default_rng()

    def __len__(self):
        return len(self.base_dataset)

    def __getitem__(self, idx):
        original, distorted, lmx = self.base_dataset[idx]
        if self.rng.random() < self.augment_p:
            return self.transform(distorted), lmx
        return original, lmx


class ConcatDataset:
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self):
        return int(self.offsets[-1])

    def __getitem__(self, idx):
        ds = int(np.searchsorted(self.offsets, idx, side="right")) - 1
        return self.datasets[ds][idx - int(self.offsets[ds])]


class DebugDataset:
    """Random-tensor dataset for loop smoke tests: (img, token sequence) with
    <bos> = 0 first and <eos> = 2 last, image sizes cycling over ``sizes``."""

    def __init__(self, n=8, sizes=((64, 96), (48, 64)), seq_len=12, vocab=11,
                 seed=0):
        self.n = n
        self.sizes = sizes
        self.seq_len = seq_len
        self.vocab = vocab
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        h, w = self.sizes[idx % len(self.sizes)]
        img = self.rng.random((1, h, w), dtype=np.float32)
        seq = np.concatenate([[0], self.rng.integers(3, self.vocab, self.seq_len),
                              [2]])
        return img, seq.astype(np.int32)
