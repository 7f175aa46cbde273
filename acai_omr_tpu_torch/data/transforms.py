"""Host-side image transforms of the inference path.

The twin of the JAX package's ``data/transforms.py`` (its inference transforms
only), implemented with numpy so the device never sees ragged shapes: images
are resized on the host, patchified, and bucket-packed before transfer.

All transforms take and return float32 (C, H, W) arrays in [0, 1] (grayscale:
C=1). ``DynamicResize`` keeps the reference's exact integer-division
aspect-ratio math so token budgets match image for image.

Resize: the antialiased bicubic of ``native/libimgproc.so`` (a PIL-equivalent
filter, bound here by this package's own ctypes loader,
:mod:`.native_imgproc`) when it builds, else PIL's bicubic in float mode --
the same choice, in the same order, as the JAX package makes, so both sides
resize an image to the same array.
"""

from __future__ import annotations

import math

import numpy as np
from PIL import Image


def to_float_chw(img) -> np.ndarray:
    """PIL image or array -> float32 (C, H, W) in [0, 1]."""
    if isinstance(img, Image.Image):
        # branch on the SOURCE dtype, not the data: a near-black uint8
        # image (max pixel <= 1) must still divide by 255 — the old
        # max()-based heuristic mapped its 1-valued pixels to full white
        # (round-4 review). PIL float modes ("F") pass through unscaled.
        raw = np.asarray(img)
        arr = raw.astype(np.float32)
        if arr.ndim == 2:
            arr = arr[None]
        else:
            arr = arr.transpose(2, 0, 1)
        if np.issubdtype(raw.dtype, np.integer):
            arr = arr / 255.0
        return arr
    raw = np.asarray(img)
    arr = raw.astype(np.float32)
    if np.issubdtype(raw.dtype, np.integer):
        # same source-dtype rule as the PIL branch: an integer array
        # (cv2/imageio uint8) is 0-255 data — passing it through unscaled
        # fed a [0,1] pipeline values that clip to saturated white
        # (round-5 review)
        arr = arr / 255.0
    if arr.ndim == 2:
        arr = arr[None]
    return arr


def _resize_chw(arr: np.ndarray, size_hw: tuple[int, int],
                resample=Image.Resampling.BICUBIC) -> np.ndarray:
    """Antialiased per-channel resize: native C++ kernel when built
    (native/imgproc.cpp, PIL-equivalent filter), PIL 'F'-mode fallback."""
    h, w = size_hw
    if resample == Image.Resampling.BICUBIC:
        from . import native_imgproc
        if native_imgproc.available():
            return np.stack([native_imgproc.resize_bicubic(ch, h, w)
                             for ch in arr])
    out = np.empty((arr.shape[0], h, w), dtype=np.float32)
    for c in range(arr.shape[0]):
        im = Image.fromarray(arr[c], mode="F")
        out[c] = np.asarray(im.resize((w, h), resample=resample), dtype=np.float32)
    return out


def center_crop(arr: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """torchvision-style center crop (pads with zeros when target is larger)."""
    c, h, w = arr.shape
    if out_h > h or out_w > w:
        padded = np.zeros((c, max(out_h, h), max(out_w, w)), dtype=arr.dtype)
        top = (padded.shape[1] - h) // 2
        left = (padded.shape[2] - w) // 2
        padded[:, top:top + h, left:left + w] = arr
        arr, h, w = padded, padded.shape[1], padded.shape[2]
    top = int(round((h - out_h) / 2.0))
    left = int(round((w - out_w) / 2.0))
    return arr[:, top:top + out_h, left:left + out_w]


class DynamicResize:
    """Budgeted aspect-preserving resize (reference: utils.py:334-370).

    Resizes so the patchified sequence fits ``max_seq_len`` tokens; keeps the
    reference's integer-division aspect ratio and floor-sqrt sizing exactly.
    Optionally center-crops dims exceeding the PE grid.
    """

    def __init__(self, patch_size: int, max_seq_len: int, pe_max_height: int,
                 pe_max_width: int, crop_imgs: bool):
        self.patch_size = patch_size
        self.max_seq_len = max_seq_len
        self.pe_max_height = pe_max_height
        self.pe_max_width = pe_max_width
        self.crop_imgs = crop_imgs

    def target_size(self, h: int, w: int) -> tuple[int, int]:
        p = self.patch_size
        if w > h:
            aspect_ratio = w // h
            target_h = p * math.floor(math.sqrt(self.max_seq_len / aspect_ratio))
            target_w = target_h * aspect_ratio
        else:
            aspect_ratio = h // w
            target_w = p * math.floor(math.sqrt(self.max_seq_len / aspect_ratio))
            target_h = target_w * aspect_ratio
        return target_h, target_w

    def __call__(self, img) -> np.ndarray:
        arr = to_float_chw(img)
        _, h, w = arr.shape
        th, tw = self.target_size(h, w)
        arr = _resize_chw(arr, (th, tw))
        if self.crop_imgs:
            if th / self.patch_size > self.pe_max_height:
                arr = center_crop(arr, self.pe_max_height * self.patch_size, arr.shape[-1])
            if tw / self.patch_size > self.pe_max_width:
                arr = center_crop(arr, arr.shape[-2], self.pe_max_width * self.patch_size)
        return np.clip(arr, 0.0, 1.0)


class Compose:
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, x):
        for t in self.transforms:
            x = t(x)
        return x
