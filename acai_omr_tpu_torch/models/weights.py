"""Weights carried over from the JAX package.

The JAX parameter tree (``init_vitomr_params``: nested dicts, stacked
``(L, ...)`` layer leaves, dense kernels ``(in, out)``, fused qkv
``in_kernel`` ``(L, E, 3E)``) is the port's own layout, so carrying it over is
a strict leaf-for-leaf copy into tensors. :func:`params_from_jax` takes the
tree as numpy arrays (e.g. ``jax.tree.map(np.asarray, params)`` on the JAX
side) and raises on any missing or extra key; :func:`load_npz` reads the same
tree from a ``.npz`` whose keys are ``/``-joined paths, or from a checkpoint
directory the JAX package wrote (orbax; read through
:mod:`..utils.orbax_tree`, which needs the optional ``tensorstore``). bf16
leaves (``ml_dtypes.bfloat16`` arrays) carry over bit for bit.
:func:`mae_params_from_jax` and :func:`load_mae_npz` do the same for the MAE
tree of stage-1 pretraining (``init_mae_params``).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..utils import orbax_tree

_DENSE = ("kernel", "bias")
_NORM = ("scale", "bias")
_MHA = {"in_kernel": None, "in_bias": None, "out": _DENSE}

# key structure of the ViTOMR parameter tree (leaves are None)
TEMPLATE = {
    "encoder": {
        "pos_embedding": None,
        "projection": _DENSE,
        "blocks": {"self_attn": _MHA, "norm1": _NORM, "linear1": _DENSE,
                   "linear2": _DENSE, "norm2": _NORM},
        "final_norm": _NORM,
    },
    "transition_head": {"linear1": _DENSE, "linear2": _DENSE},
    "decoder": {
        "vocab_embedding": ("table",),
        "pos_embedding": None,
        "blocks": {"self_attn": _MHA, "norm1": _NORM, "cross_attn": _MHA,
                   "norm2": _NORM, "linear1": _DENSE, "linear2": _DENSE,
                   "norm3": _NORM},
        "final_norm": _NORM,
        "unembed": _DENSE,
    },
}

_ENCODER = TEMPLATE["encoder"]

# key structure of the MAE parameter tree
MAE_TEMPLATE = {
    "encoder": _ENCODER,
    "decoder_embed": _DENSE,
    "decoder_blocks": _ENCODER["blocks"],
    "decoder_norm": _NORM,
    "decoder_unembed": _DENSE,
    "mask_token": None,
    "decoder_pos_embedding": None,
}


def _paths(template, prefix=()):
    if template is None:
        return {"/".join(prefix)}
    if isinstance(template, tuple):
        return {"/".join(prefix + (k,)) for k in template}
    out = set()
    for k, v in template.items():
        out |= _paths(v, prefix + (k,))
    return out


def _flatten(tree, prefix=()) -> dict:
    if not isinstance(tree, dict):
        return {"/".join(prefix): tree}
    out = {}
    for k, v in tree.items():
        out.update(_flatten(v, prefix + (str(k),)))
    return out


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        *parents, last = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return tree


def leaf_tensor(leaf) -> torch.Tensor:
    """A numpy (or array-like) leaf as a CPU tensor of its own dtype; an
    ``ml_dtypes.bfloat16`` array, which torch cannot take, goes through its
    16-bit pattern, so it carries over bit for bit."""
    if torch.is_tensor(leaf):
        return leaf
    a = np.array(leaf, copy=True)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_jax(params: dict, device=None, dtype=None,
                    template: dict = TEMPLATE) -> dict:
    """JAX ViTOMR param tree of numpy arrays -> the port's tensor tree.

    Strict: a missing or an extra key raises. Floating leaves are cast to
    ``dtype`` when given. Tensors land on ``device`` (``cuda`` unless the
    caller passes ``device="cpu"``). ``template`` is the key structure the
    tree is held to.
    """
    device = resolve_device(device)
    flat = _flatten(params)
    want = _paths(template)
    missing, extra = sorted(want - flat.keys()), sorted(flat.keys() - want)
    if missing or extra:
        raise KeyError(f"parameter tree mismatch: missing {missing}, "
                       f"extra {extra}")
    out = {}
    for path, leaf in flat.items():
        t = leaf_tensor(leaf)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        out[path] = t.to(device)
    return _unflatten(out)


def mae_params_from_jax(params: dict, device=None, dtype=None) -> dict:
    """JAX MAE param tree (``init_mae_params``) of numpy arrays -> the port's
    tensor tree, as strict as :func:`params_from_jax`."""
    return params_from_jax(params, device, dtype, MAE_TEMPLATE)


def load_npz(path: str, device=None, dtype=None,
             template: dict = TEMPLATE) -> dict:
    """Read a parameter tree through :func:`params_from_jax`: from a ``.npz``
    of ``/``-joined parameter paths (see :func:`save_npz`), or from a
    checkpoint directory the JAX package wrote (``save_pytree`` /
    ``save_train_state``: orbax, read by :func:`..utils.orbax_tree.read`).
    A train state's ``params`` subtree is taken, as JAX's ``load_params``
    does."""
    if orbax_tree.is_orbax_dir(path):
        tree = orbax_tree.read(path)
    else:
        with np.load(path) as data:
            tree = _unflatten({k: data[k] for k in data.files})
    if "params" in tree:
        tree = tree["params"]
    return params_from_jax(tree, device, dtype, template)


def load_mae_npz(path: str, device=None, dtype=None) -> dict:
    """Read an MAE tree (what stage-1 pretraining writes as
    ``pretrained_mae.npz``, or a JAX checkpoint directory of one) through
    :func:`mae_params_from_jax`."""
    return load_npz(path, device, dtype, MAE_TEMPLATE)


def save_npz(path: str, params: dict) -> None:
    """Write a parameter tree (numpy arrays or tensors) as a ``.npz``."""
    flat = {k: (v.float().cpu().numpy() if torch.is_tensor(v) else
                np.asarray(v)) for k, v in _flatten(params).items()}
    np.savez(path, **flat)
