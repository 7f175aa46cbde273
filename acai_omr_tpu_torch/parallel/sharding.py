"""Tensor-parallel decode layout: the decode half of the JAX package's
``parallel/sharding.py``.

The fused qkv kernels store their columns as ``[q | k | v]``, each E wide and
head-major; cutting the last dim into tp pieces would give shard 0 a slab of
q only. :func:`tp_shuffle_decoder_params` reorders the columns to
``[q_0|k_0|v_0 | q_1|k_1|v_1 | ...]`` so that each shard's piece is a fused
``[q_i|k_i|v_i]`` block over its own heads ``i*H/tp .. (i+1)*H/tp``.
:func:`tp_split_decoder_params` then cuts the decoder the way JAX's
``tp_decode_param_specs`` shards it and returns one parameter dict per model
rank:

* split: the attention ``in_kernel`` / ``in_bias`` columns, the attention
  ``out`` kernel rows, the ``linear1`` columns and the ``linear2`` rows;
* replicated: the norms, embeddings and unembed, the ``out`` biases and the
  ``linear2`` bias.
"""

from __future__ import annotations

import torch

Params = dict


def tp_shuffle_decoder_params(params: Params, num_heads: int, head_dim: int,
                              tp: int) -> Params:
    """Reorder the fused-qkv columns of every attention block for ``tp``-way
    decode. Other leaves are shared, not copied."""
    blocks = dict(params["blocks"])
    for name in ("self_attn", "cross_attn"):
        blk = dict(blocks[name])
        kern, bias = blk["in_kernel"], blk["in_bias"]
        l, e, _ = kern.shape
        k6 = kern.reshape(l, e, 3, tp, num_heads // tp, head_dim)
        blk["in_kernel"] = k6.permute(0, 1, 3, 2, 4, 5).reshape(l, e, 3 * e)
        b5 = bias.reshape(l, 3, tp, num_heads // tp, head_dim)
        blk["in_bias"] = b5.permute(0, 2, 1, 3, 4).reshape(l, 3 * e)
        blocks[name] = blk
    return {**params, "blocks": blocks}


def tp_split_dim(path: tuple) -> int | None:
    """The dim of the leaf at ``path`` that the model axis splits, or None
    when the leaf is replicated (the rules of JAX's
    ``tp_decode_param_specs``; stacked ``blocks`` leaves carry the layer axis
    first)."""
    name = path[-1]
    parent = path[-2] if len(path) >= 2 else ""
    grandparent = path[-3] if len(path) >= 3 else ""
    lead = 1 if "blocks" in path else 0
    if parent in ("self_attn", "cross_attn"):
        if name == "in_kernel":
            return lead + 1
        if name == "in_bias":
            return lead
    if grandparent in ("self_attn", "cross_attn") and parent == "out" \
            and name == "kernel":
        return lead
    if parent == "linear1":
        return lead + 1 if name == "kernel" else lead
    if parent == "linear2" and name == "kernel":
        return lead
    return None


def tp_split_decoder_params(params: Params, tp: int, devices=None
                            ) -> list[Params]:
    """One decoder parameter dict per model rank: each split leaf's rank-th
    piece (contiguous), each replicated leaf shared. ``params`` must already
    be shuffled (:func:`tp_shuffle_decoder_params`). ``devices[r]``, when
    given, is where rank r's leaves go."""

    def split(tree, path):
        if isinstance(tree, dict):
            return [dict(zip(tree, vals)) for vals in zip(
                *(split(v, path + (k,)) for k, v in tree.items()))]
        dim = tp_split_dim(path)
        if dim is None:
            pieces = [tree] * tp
        else:
            if tree.shape[dim] % tp:
                raise ValueError(f"{'/'.join(path)} dim {dim} of "
                                 f"{tuple(tree.shape)} does not split {tp} "
                                 f"ways")
            pieces = [p.contiguous() for p in torch.chunk(tree, tp, dim=dim)]
        if devices is not None:
            pieces = [p.to(devices[r]) for r, p in enumerate(pieces)]
        return pieces

    return split(params, ())
