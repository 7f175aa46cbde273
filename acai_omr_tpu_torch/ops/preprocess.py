"""Device ingest: resize -> clamp -> patchify on the card (the twin of the
JAX package's ``ops/preprocess.py``).

Antialiased bicubic resampling is a linear operator per axis, so the resize
is two products with precomputed interpolation matrices, then the clamp of
``DynamicResize`` and the ``nn.Unfold``-order patch reshape. The weights are
PIL's "bicubic, antialias" filter (Keys kernel, a = -0.5, support scaled by
the downsampling factor), as ``native/imgproc.cpp`` computes them, so the
host and device resizes agree to float rounding. The products run in full
fp32 (TF32 off while they run): the host pipeline is the yardstick, within
2e-5.

The host pipeline (``data/transforms``) stays the default for training
input; this is the single-call ingest for an image already on (or headed to)
the card. Runs on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

from .. import resolve_device


def bicubic_axis_weights(in_size: int, out_size: int) -> np.ndarray:
    """Dense (out_size, in_size) antialiased bicubic resampling matrix:
    ``native/imgproc.cpp``'s ``axis_weights`` in weight placement and
    normalisation (PIL: Keys a = -0.5, support 2 * max(scale, 1))."""

    def kernel(x: float) -> float:
        a = -0.5
        x = abs(x)
        if x < 1.0:
            return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0
        if x < 2.0:
            return (((x - 5.0) * x + 8.0) * x - 4.0) * a
        return 0.0

    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    mat = np.zeros((out_size, in_size), dtype=np.float32)
    for o in range(out_size):
        center = (o + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        ws = np.array([kernel((xmin + i - center + 0.5) / filterscale)
                       for i in range(xmax - xmin)], dtype=np.float64)
        s = ws.sum()
        if s != 0.0:
            ws = ws / s
        mat[o, xmin:xmax] = ws.astype(np.float32)
    return mat


@functools.lru_cache(maxsize=64)
def _weights_cached(in_size: int, out_size: int,
                    device: torch.device) -> torch.Tensor:
    return torch.from_numpy(bicubic_axis_weights(in_size, out_size)).to(device)


@contextlib.contextmanager
def _full_fp32():
    """fp32 products in full precision (no TF32) inside the block."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def resize_normalize_patchify(img, out_h: int, out_w: int, patch_size: int,
                              device=None) -> torch.Tensor:
    """(C, H, W) float [0, 1] image (numpy or a tensor) -> (L, C*P*P) fp32
    patches on ``device``, resized antialiased-bicubic to (out_h, out_w)
    and clamped to [0, 1]."""
    device = resolve_device(device)
    x = torch.as_tensor(np.asarray(img) if not torch.is_tensor(img) else img
                        ).to(device=device, dtype=torch.float32)
    c, h, w = x.shape
    rh = _weights_cached(h, out_h, device)
    rw = _weights_cached(w, out_w, device)
    with _full_fp32():
        x = torch.matmul(rh, x)          # rows: (out_h, H) @ (C, H, W)
        x = torch.matmul(x, rw.t())      # cols: (C, out_h, W) @ (W, out_w)
    x = x.clamp(0.0, 1.0)                # DynamicResize's clamp
    p = patch_size
    hp, wp = out_h // p, out_w // p
    x = x.reshape(c, hp, p, wp, p).permute(1, 3, 0, 2, 4)  # nn.Unfold order
    return x.reshape(hp * wp, c * p * p)


def dynamic_resize_patchify(img, patch_size: int, max_seq_len: int,
                            pe_max_height: int, pe_max_width: int,
                            device=None):
    """Device-side ``DynamicResize`` + patchify: the target size of
    :class:`..data.transforms.DynamicResize`, then
    :func:`resize_normalize_patchify`. Returns (patches (L, C*P*P),
    (hp, wp))."""
    from ..data.transforms import DynamicResize
    dr = DynamicResize(patch_size, max_seq_len, pe_max_height, pe_max_width,
                       crop_imgs=False)
    h, w = int(img.shape[-2]), int(img.shape[-1])
    out_h, out_w = dr.target_size(h, w)
    patches = resize_normalize_patchify(img, out_h, out_w, patch_size, device)
    return patches, (out_h // patch_size, out_w // patch_size)
