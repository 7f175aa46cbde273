"""Host-side image transforms of inference and of training.

The twin of the JAX package's ``data/transforms.py``, implemented with PIL
and numpy so the device never sees ragged shapes: images are resized and
augmented on the host, patchified, and bucket-packed before transfer.

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


class PatchDivisibleResize:
    """Round dims down to patch multiples (reference: utils.py:309-330)."""

    def __init__(self, patch_size: int):
        self.patch_size = patch_size

    def __call__(self, img) -> np.ndarray:
        arr = to_float_chw(img)
        _, h, w = arr.shape
        p = self.patch_size
        new_w = max(w // p * p, p)
        new_h = max(h // p * p, p)
        if (new_h, new_w) == (h, w):
            return arr
        return _resize_chw(arr, (new_h, new_w))


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


class RandomApply:
    def __init__(self, transforms, p: float, rng: np.random.Generator | None = None):
        self.transforms = list(transforms)
        self.p = p
        self.rng = rng or np.random.default_rng()

    def __call__(self, x):
        if self.rng.random() < self.p:
            for t in self.transforms:
                x = t(x)
        return x


# ---------------------------------------------------------------------------
# camera augmentations of training
# ---------------------------------------------------------------------------

class GaussianBlur:
    """Separable gaussian blur, kernel size + sigma range as torchvision."""

    def __init__(self, kernel_size: int = 15, sigma=(0.2, 0.7),
                 rng: np.random.Generator | None = None):
        self.kernel_size = kernel_size
        self.sigma = sigma
        self.rng = rng or np.random.default_rng()

    def __call__(self, arr: np.ndarray) -> np.ndarray:
        sigma = float(self.rng.uniform(*self.sigma))
        r = self.kernel_size // 2
        xs = np.arange(-r, r + 1, dtype=np.float32)
        k = np.exp(-0.5 * (xs / sigma) ** 2)
        k /= k.sum()

        def blur_axis(x, axis):
            pad = [(0, 0)] * x.ndim
            pad[axis] = (r, r)
            xp = np.pad(x, pad, mode="reflect")
            out = np.zeros_like(x)
            for i, kv in enumerate(k):
                sl = [slice(None)] * x.ndim
                sl[axis] = slice(i, i + x.shape[axis])
                out += kv * xp[tuple(sl)]
            return out

        return blur_axis(blur_axis(arr.astype(np.float32), 1), 2)


class GaussianNoise:
    def __init__(self, sigma: float = 0.03, rng=None):
        self.sigma = sigma
        self.rng = rng or np.random.default_rng()

    def __call__(self, arr: np.ndarray) -> np.ndarray:
        noise = self.rng.normal(0.0, self.sigma, arr.shape).astype(np.float32)
        return np.clip(arr + noise, 0.0, 1.0)


class RandomRotation:
    def __init__(self, degrees=(-2, 2), rng=None):
        self.degrees = degrees
        self.rng = rng or np.random.default_rng()

    def __call__(self, arr: np.ndarray) -> np.ndarray:
        angle = float(self.rng.uniform(*self.degrees))
        out = np.empty_like(arr)
        for c in range(arr.shape[0]):
            im = Image.fromarray(arr[c], mode="F")
            out[c] = np.asarray(im.rotate(angle, resample=Image.Resampling.BILINEAR),
                                dtype=np.float32)
        return out


class RandomPerspective:
    """Random 4-corner perspective warp (torchvision distortion_scale style)."""

    def __init__(self, distortion_scale: float = 0.2, p: float = 1.0, rng=None):
        self.distortion_scale = distortion_scale
        self.p = p
        self.rng = rng or np.random.default_rng()

    def _coeffs(self, src, dst):
        a = []
        for (x, y), (u, v) in zip(dst, src):
            a.append([x, y, 1, 0, 0, 0, -u * x, -u * y])
            a.append([0, 0, 0, x, y, 1, -v * x, -v * y])
        A = np.asarray(a, dtype=np.float64)
        b = np.asarray(src, dtype=np.float64).reshape(8)
        return np.linalg.solve(A, b)

    def __call__(self, arr: np.ndarray) -> np.ndarray:
        if self.rng.random() >= self.p:
            return arr
        _, h, w = arr.shape
        d = self.distortion_scale
        dx, dy = d * w / 2.0, d * h / 2.0
        src = [(0, 0), (w, 0), (w, h), (0, h)]
        dst = [(self.rng.uniform(0, dx), self.rng.uniform(0, dy)),
               (w - self.rng.uniform(0, dx), self.rng.uniform(0, dy)),
               (w - self.rng.uniform(0, dx), h - self.rng.uniform(0, dy)),
               (self.rng.uniform(0, dx), h - self.rng.uniform(0, dy))]
        coeffs = self._coeffs(src, dst)
        out = np.empty_like(arr)
        for c in range(arr.shape[0]):
            im = Image.fromarray(arr[c], mode="F")
            out[c] = np.asarray(
                im.transform((w, h), Image.Transform.PERSPECTIVE, coeffs,
                             resample=Image.Resampling.BILINEAR),
                dtype=np.float32)
        return np.clip(out, 0.0, 1.0)


class ColorJitter:
    """Brightness/contrast jitter (saturation/hue are no-ops on grayscale)."""

    def __init__(self, brightness=0.15, saturation=0.2, contrast=0.2, hue=0,
                 rng=None):
        self.brightness = brightness
        self.contrast = contrast
        self.rng = rng or np.random.default_rng()

    def __call__(self, arr: np.ndarray) -> np.ndarray:
        if self.brightness:
            f = float(self.rng.uniform(1 - self.brightness, 1 + self.brightness))
            arr = arr * f
        if self.contrast:
            f = float(self.rng.uniform(1 - self.contrast, 1 + self.contrast))
            mean = arr.mean()
            arr = (arr - mean) * f + mean
        return np.clip(arr, 0.0, 1.0)


def default_camera_augment(p: float, rng=None) -> RandomApply:
    """The camera augmentation stack of stage-2 training."""
    rng = rng or np.random.default_rng()
    return RandomApply([
        GaussianBlur(15, (0.2, 0.7), rng),
        GaussianNoise(0.03, rng),
        RandomRotation((-2, 2), rng),
        RandomPerspective(0.2, 1.0, rng),
        ColorJitter(0.15, 0.2, 0.2, 0, rng),
    ], p=p, rng=rng)
