"""Dataset classes of stage-1 and stage-2 training: GrandStaff-LMX, OLiMPiC
and the prepared PrIMuS / DoReMi image sets (own copy of the JAX package's
``data/datasets.py``).

Same on-disk layouts, split files, transform hooks and wrapper semantics
(the MAE wrappers augment the input only, so the target is the clean image);
items are numpy arrays / python strings consumed by the bucket loader.
No dataset is in the repository: :class:`DebugDataset` generates the seeded
synthetic examples the tests and ``chip_smoke.py`` train on. ``pandas`` is
imported where a split file or ``ids.csv`` is read, not with the module.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
from PIL import Image


class LMXDataset:
    """Base: CSV split file -> example ids. ``include_musicxml`` appends the
    example's MusicXML string to every item (stage 3 scores against it)."""

    def __init__(self, root_dir, split_file_name, img_transform=None,
                 lmx_transform=None, include_musicxml=False):
        import pandas as pd
        self.root_dir = Path(root_dir)
        self.id_df = pd.read_csv(self.root_dir / split_file_name, header=None)
        self.img_transform = img_transform
        self.lmx_transform = lmx_transform
        self.include_musicxml = include_musicxml

    def __len__(self):
        return len(self.id_df)

    def _load_img(self, path) -> Image.Image:
        return Image.open(path).convert("L")

    def _load_lmx(self, path) -> str:
        with open(path, "r") as f:
            lmx = f.read()
        return self.lmx_transform(lmx) if self.lmx_transform else lmx

    def _with_musicxml(self, item: tuple, ex_id: str) -> tuple:
        if not self.include_musicxml:
            return item
        with open(self.root_dir / (ex_id + ".musicxml"), "r") as f:
            return item + (f.read(),)


class GrandStaffLMXDataset(LMXDataset):
    """(original, distorted-resized, lmx[, musicxml])."""

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
        return self._with_musicxml(
            (original, distorted,
             self._load_lmx(self.root_dir / (ex_id + ".lmx"))), ex_id)


class OlimpicDataset(LMXDataset):
    """(img, lmx[, musicxml]) for synthetic/scanned OLiMPiC."""

    def __getitem__(self, idx):
        ex_id = self.id_df.iat[idx, 0]
        img = self._load_img(self.root_dir / (ex_id + ".png"))
        if self.img_transform:
            img = self.img_transform(img)
        return self._with_musicxml(
            (img, self._load_lmx(self.root_dir / (ex_id + ".lmx"))), ex_id)


class PreparedDataset:
    """PrIMuS / DoReMi images listed in the ``ids.csv`` (column ``id``) that
    the prepare scripts write beside ``images/``."""

    def __init__(self, root_dir, transform=None):
        import pandas as pd
        self.root_dir = Path(root_dir)
        self.id_df = pd.read_csv(self.root_dir / "ids.csv")
        self.transform = transform

    def __len__(self):
        return len(self.id_df)

    def __getitem__(self, idx):
        img_id = self.id_df.at[idx, "id"]
        img = Image.open(
            self.root_dir / "images" / (img_id + ".png")).convert("L")
        return self.transform(img) if self.transform else img


class PreTrainWrapper:
    """(input, target) pairs for the MAE; the transform applies to the input
    only, so the model reconstructs the clean image. The base item is loaded
    once: without a transform the target IS the input object, which
    :func:`.loader.pack_mae_batch` uses to patchify it once."""

    def __init__(self, base_dataset, transform=None,
                 rng: np.random.Generator | None = None):
        self.base_dataset = base_dataset
        self.transform = transform
        self.rng = rng or np.random.default_rng()

    def __len__(self):
        return len(self.base_dataset)

    def __getitem__(self, idx):
        img = self.base_dataset[idx]
        return (self.transform(img) if self.transform else img), img


class OlimpicPreTrainWrapper(PreTrainWrapper):
    def __getitem__(self, idx):
        img, _ = self.base_dataset[idx]
        return (self.transform(img) if self.transform else img), img


class GrandStaffPreTrainWrapper(PreTrainWrapper):
    """With probability ``augment_p``: (transform(distorted), original); else
    (original, original)."""

    def __init__(self, base_dataset, augment_p=0.0, transform=None, rng=None):
        if augment_p > 0 and transform is None:
            raise ValueError("Augmentation transform must be specified for "
                             "non-zero augment_p")
        super().__init__(base_dataset, transform, rng)
        self.augment_p = augment_p

    def __getitem__(self, idx):
        original, distorted, _ = self.base_dataset[idx]
        if self.rng.random() < self.augment_p:
            return self.transform(distorted), original
        return original, original


class GrandStaffOMRTrainWrapper:
    """(input_img, lmx[, musicxml]): with probability ``augment_p`` the
    transformed distorted image, else the original."""

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
        original, distorted, *rest = self.base_dataset[idx]
        if self.rng.random() < self.augment_p:
            return (self.transform(distorted), *rest)
        return (original, *rest)


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
    """Random-tensor dataset for loop smoke tests, image sizes cycling over
    ``sizes``. ``kind="mae"``: (img, img), the un-augmented MAE pair;
    ``kind="omr"``: (img, token sequence) with <bos> = 0 first and <eos> = 2
    last."""

    def __init__(self, n=8, sizes=((64, 96), (48, 64)), seq_len=12, vocab=11,
                 kind="mae", seed=0):
        self.n = n
        self.sizes = sizes
        self.seq_len = seq_len
        self.vocab = vocab
        self.kind = kind
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        h, w = self.sizes[idx % len(self.sizes)]
        img = self.rng.random((1, h, w), dtype=np.float32)
        if self.kind == "mae":
            return img, img
        seq = np.concatenate([[0], self.rng.integers(3, self.vocab, self.seq_len),
                              [2]])
        return img, seq.astype(np.int32)
