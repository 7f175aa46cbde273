"""Patchify on host numpy arrays.

Patch order matches ``nn.Unfold(P, stride=P)`` exactly: row-major over the
patch grid, each patch flattened channel-major then row-major, so weights
carried over from the JAX package see identical sequences.
"""

from __future__ import annotations

import numpy as np


def patchify(img: np.ndarray, patch_size: int) -> np.ndarray:
    """(C, H, W) or (H, W) image -> (L, C*P*P) patches, L = (H//P)*(W//P)."""
    if img.ndim == 2:
        img = img[None]
    c, h, w = img.shape
    p = patch_size
    hp, wp = h // p, w // p
    img = img[:, : hp * p, : wp * p]
    x = img.reshape(c, hp, p, wp, p)
    x = np.transpose(x, (1, 3, 0, 2, 4))  # (hp, wp, C, P, P)
    return x.reshape(hp * wp, c * p * p)

