"""Positional-embedding grid addressing.

The learned (pe_max_height, pe_max_width, E) grid is sliced top-left per image,
or bilinearly resized for images beyond the grid. Both cases become one
static-shape gather:

host side  -> for every image, an (L, 4) int32 index array into the flattened
              grid plus an (L, 4) fp32 weight array (exact slice = one index
              with weight 1; bilinear = 4 corner indices with bilinear
              weights), padded to the bucket length;
device side-> ``sum_k w[..., k, None] * pe_flat[idx[..., k]]`` (:func:`gather_pe`).

Bilinear coordinates replicate torch's align_corners=False mapping.
"""

from __future__ import annotations

import numpy as np
import torch


def slice_indices(hp: int, wp: int, pe_width: int):
    """Exact top-left slice of the PE grid as gather indices.

    Returns (idx, w): (L, 4) int32 / (L, 4) float32 with L = hp*wp. Only the
    first column carries weight.
    """
    rows = np.repeat(np.arange(hp), wp)
    cols = np.tile(np.arange(wp), hp)
    flat = rows * pe_width + cols
    idx = np.zeros((hp * wp, 4), dtype=np.int32)
    idx[:, 0] = flat
    w = np.zeros((hp * wp, 4), dtype=np.float32)
    w[:, 0] = 1.0
    return idx, w


def bilinear_indices(hp: int, wp: int, pe_height: int, pe_width: int):
    """Bilinear resize of the full (pe_height, pe_width) grid to (hp, wp).

    Matches torch F.interpolate(mode="bilinear", align_corners=False):
    src = (dst + 0.5) * (in / out) - 0.5, edges clamped.
    Returns (idx, w): (L, 4) gather indices / weights, L = hp*wp.
    """
    def axis_coords(out_size, in_size):
        src = (np.arange(out_size) + 0.5) * (in_size / out_size) - 0.5
        src = np.clip(src, 0.0, in_size - 1)
        lo = np.floor(src).astype(np.int64)
        hi = np.minimum(lo + 1, in_size - 1)
        frac = (src - lo).astype(np.float32)
        return lo, hi, frac

    r_lo, r_hi, r_f = axis_coords(hp, pe_height)
    c_lo, c_hi, c_f = axis_coords(wp, pe_width)

    # broadcast to the (hp, wp) target grid, flattened row-major
    RL = np.repeat(r_lo, wp); RH = np.repeat(r_hi, wp); RF = np.repeat(r_f, wp)
    CL = np.tile(c_lo, hp);   CH = np.tile(c_hi, hp);   CF = np.tile(c_f, hp)

    idx = np.stack([
        RL * pe_width + CL,
        RL * pe_width + CH,
        RH * pe_width + CL,
        RH * pe_width + CH,
    ], axis=1).astype(np.int32)
    w = np.stack([
        (1 - RF) * (1 - CF),
        (1 - RF) * CF,
        RF * (1 - CF),
        RF * CF,
    ], axis=1).astype(np.float32)
    return idx, w


def pe_indices(hp: int, wp: int, pe_height: int, pe_width: int):
    """Slice when the image fits the grid, bilinear-interpolate when not
    (reference: acai_omr/models/models.py:315-318)."""
    if hp <= pe_height and wp <= pe_width:
        return slice_indices(hp, wp, pe_width)
    return bilinear_indices(hp, wp, pe_height, pe_width)


def gather_pe(pe_grid: torch.Tensor, idx: torch.Tensor,
              w: torch.Tensor) -> torch.Tensor:
    """Device-side PE lookup: a gather of four grid rows and their weighted sum.

    pe_grid: (pe_h, pe_w, E) learned grid; idx/w: (..., L, 4) from the host
    packers above. Returns (..., L, E) in the grid's dtype.
    """
    flat = pe_grid.reshape(-1, pe_grid.shape[-1])
    # Entries of weight 0 (every padded position, and the unused corners of a
    # slice) add nothing whichever row they name, and the packers name row 0
    # for all of them. The gradient of a gather is a scatter-add that walks
    # repeated rows one after another (26 ms of a 218 ms flagship training
    # microbatch on an H100 with half the positions padding), so they are
    # pointed at rows of their own instead.
    n_pos = idx.shape[-2] * idx.shape[-1]
    own = (torch.arange(n_pos, device=idx.device) % flat.shape[0]) \
        .view(idx.shape[-2:])
    vecs = flat[torch.where(w != 0, idx.long(), own)]    # (..., L, 4, E)
    return torch.einsum("...k,...ke->...e", w.to(vecs.dtype), vecs)
