"""Parameter layouts over a mesh: the twin of the JAX package's
``parallel/sharding.py``.

Training (:func:`param_specs`, :func:`param_shardings`,
:func:`shard_params`): the Megatron rules of JAX's ``_spec_for_path``. A
spec is a tuple with one entry per leading dim, an axis name or None (JAX's
``PartitionSpec``; ``()`` replicates): the fused qkv and ``linear1`` kernels
and biases split their output features over ``model``, the attention
``out`` and ``linear2`` kernels their input features, the unembed its vocab
columns; norms, embeddings, PE grids and the row-parallel biases replicate.
Stacked ``blocks`` leaves carry their layer axis first, never split.
JAX's ``sequence_parallel`` (a GSPMD hint that changes no value) has no
counterpart.

Decode:
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

from .mesh import MODEL_AXIS

Params = dict


def _spec_for_path(path: tuple[str, ...]) -> tuple:
    """The spec of one parameter leaf, identified by its tree path."""
    name = path[-1]
    parent = path[-2] if len(path) >= 2 else ""
    grandparent = path[-3] if len(path) >= 3 else ""
    stacked = "blocks" in path  # a leading layer axis

    def with_layer(*dims):
        return (None, *dims) if stacked else dims

    if parent in ("self_attn", "cross_attn"):
        if name == "in_kernel":
            return with_layer(None, MODEL_AXIS)   # (E, 3E): heads
        if name == "in_bias":
            return with_layer(MODEL_AXIS)
    if grandparent in ("self_attn", "cross_attn") and parent == "out":
        if name == "kernel":
            return with_layer(MODEL_AXIS, None)   # row-parallel
        return with_layer(None) if stacked else ()
    if parent == "linear1":
        if name == "kernel":
            return with_layer(None, MODEL_AXIS)
        return with_layer(MODEL_AXIS)
    if parent == "linear2":
        if name == "kernel":
            return with_layer(MODEL_AXIS, None)
        return with_layer(None) if stacked else ()
    if parent == "unembed" and name == "kernel":
        return (None, MODEL_AXIS)
    return ()  # norms, embeddings, PE grids, scalars


def _map_with_path(fn, tree: Params, path: tuple = ()) -> Params:
    return {k: _map_with_path(fn, v, path + (k,)) if isinstance(v, dict)
            else fn(path + (k,), v) for k, v in tree.items()}


def param_specs(params: Params) -> Params:
    """The spec tree of ``params`` (one tuple per leaf)."""
    return _map_with_path(lambda path, _: _spec_for_path(path), params)


def param_shardings(mesh, params: Params) -> Params:
    """The specs as placed on ``mesh``: a leaf whose split dim does not
    divide by its axis's size (tiny test configurations, the 227-token
    unembed over an even axis) is replicated, ``()``."""
    def fit(path, leaf):
        spec = _spec_for_path(path)
        for dim, axis in enumerate(spec):
            if axis is not None and leaf.shape[dim] % mesh.shape[axis]:
                return ()
        return spec
    return _map_with_path(fit, params)


def shard_params(mesh, params: Params) -> list[list[Params]]:
    """Each shard's parameters: ``out[d][m]`` holds, for every leaf, the
    m-th contiguous piece along its ``model`` dim (the whole leaf where it
    is replicated), on ``mesh.devices[d][m]``."""
    specs = param_shardings(mesh, params)
    n_model = mesh.shape[MODEL_AXIS]

    def piece(path, leaf, m, dev):
        spec = specs
        for k in path:
            spec = spec[k]
        if MODEL_AXIS in spec:
            dim = spec.index(MODEL_AXIS)
            leaf = torch.chunk(leaf, n_model, dim=dim)[m]
        return leaf.to(dev).contiguous()

    return [[_map_with_path(lambda path, v: piece(path, v, m, dev), params)
             for m, dev in enumerate(row)] for row in mesh.devices]


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
    when the leaf is replicated: the training rules (:func:`_spec_for_path`)
    with the unembed replicated, as JAX's ``tp_decode_param_specs`` (each
    shard computes the whole (B, V) logits; stacked ``blocks`` leaves carry
    the layer axis first)."""
    spec = _spec_for_path(path)
    if MODEL_AXIS not in spec or (len(path) >= 2 and path[-2] == "unembed"):
        return None
    return spec.index(MODEL_AXIS)


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
