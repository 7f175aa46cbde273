"""Patchify / unpatchify on numpy arrays and on tensors.

Patch order matches ``nn.Unfold(P, stride=P)`` exactly: row-major over the
patch grid, each patch flattened channel-major then row-major, so weights
carried over from the JAX package see identical sequences. Each function
takes a numpy array or a tensor and returns the same kind (a tensor stays on
its device).
"""

from __future__ import annotations

import numpy as np
import torch


def _transpose(x, axes):
    return x.permute(*axes) if torch.is_tensor(x) else np.transpose(x, axes)


def patchify(img, patch_size: int):
    """(C, H, W) or (H, W) image -> (L, C*P*P) patches, L = (H//P)*(W//P)."""
    if img.ndim == 2:
        img = img[None]
    c, h, w = img.shape
    p = patch_size
    hp, wp = h // p, w // p
    img = img[:, : hp * p, : wp * p]
    x = img.reshape(c, hp, p, wp, p)
    x = _transpose(x, (1, 3, 0, 2, 4))  # (hp, wp, C, P, P)
    return x.reshape(hp * wp, c * p * p)


def unpatchify(patches, hp: int, wp: int, patch_size: int, channels: int = 1):
    """(L, C*P*P) -> (C, hp*P, wp*P). Inverse of :func:`patchify`."""
    p = patch_size
    x = patches.reshape(hp, wp, channels, p, p)
    x = _transpose(x, (2, 0, 3, 1, 4))  # (C, hp, P, wp, P)
    return x.reshape(channels, hp * p, wp * p)


def batched_patchify(imgs, patch_size: int):
    """(B, C, H, W) -> (B, L, C*P*P) for a batch of images of one size."""
    b, c, h, w = imgs.shape
    p = patch_size
    hp, wp = h // p, w // p
    x = imgs.reshape(b, c, hp, p, wp, p)
    x = _transpose(x, (0, 2, 4, 1, 3, 5))
    return x.reshape(b, hp * wp, c * p * p)
