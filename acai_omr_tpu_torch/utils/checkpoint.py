"""Checkpoints as ``.npz`` files of ``/``-joined tree paths (the twin of the
JAX package's orbax-backed ``utils/checkpoint.py``).

A bare parameter tree is what :func:`..models.weights.load_npz` reads, so
``save_pytree(path, params)`` writes the file inference loads. A train state
adds ``step`` and the Adam moments under ``opt_state/``, enough to resume.

The readers also take a checkpoint directory the JAX package wrote (orbax,
read by :mod:`.orbax_tree`, which needs the optional ``tensorstore``):
:func:`load_pytree` and :func:`load_params` return its tree of numpy arrays;
:func:`load_train_state` refuses a JAX train state, whose optimizer state is
optax's chain and not the port's ``{mu, nu}``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..models.weights import _flatten, _unflatten
from . import orbax_tree


def _npz(path) -> Path:
    path = Path(path)
    return path if path.suffix == ".npz" else path.with_name(path.name + ".npz")


def save_pytree(path, tree: dict) -> Path:
    """Write a nested dict of tensors / arrays / scalars; returns the file."""
    path = _npz(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    flat = {k: (v.detach().cpu().numpy() if torch.is_tensor(v)
                else np.asarray(v)) for k, v in _flatten(tree).items()
            if v is not None}
    np.savez(path, **flat)
    return path


def _leaf_spec(leaf) -> tuple | None:
    """(shape, dtype name) of a tensor, array or scalar leaf; None for a
    leaf stored as None."""
    if leaf is None:
        return None
    if torch.is_tensor(leaf):
        return tuple(leaf.shape), str(leaf.dtype).removeprefix("torch.")
    a = np.asarray(leaf)
    return a.shape, a.dtype.name


def _check_like(tree: dict, like: dict, path) -> None:
    """Raise ValueError naming the first leaf whose key, shape or dtype
    differs between the tree read from ``path`` and ``like``."""
    got, want = _flatten(tree), _flatten(like)
    for key in sorted(want.keys() | got.keys()):
        if key not in got:
            raise ValueError(f"{path}: leaf {key!r} is missing")
        if key not in want:
            raise ValueError(f"{path}: leaf {key!r} is not in `like`")
        g, w = _leaf_spec(got[key]), _leaf_spec(want[key])
        if g != w:
            raise ValueError(f"{path}: leaf {key!r} holds (shape, dtype) {g}"
                             f", `like` has {w}")


def load_pytree(path, like: dict | None = None) -> dict:
    """The nested dict of numpy arrays :func:`save_pytree` wrote, or that the
    JAX package's ``save_pytree`` / ``save_train_state`` wrote into the
    orbax directory ``path``. With ``like`` (a tree of tensors, arrays or
    scalars), the tree read must have its keys, shapes and dtypes: a
    mismatch raises ValueError naming the leaf."""
    if orbax_tree.is_orbax_dir(path):
        tree = orbax_tree.read(path)
    else:
        with np.load(_npz(path)) as data:
            tree = _unflatten({k: data[k] for k in data.files})
    if like is not None:
        _check_like(tree, like, path)
    return tree


def save_train_state(path, state) -> Path:
    """Save a :class:`..parallel.trainer.TrainState` (step, params, Adam
    moments; the LLRD scales are rebuilt from the config on resume)."""
    return save_pytree(path, {
        "step": state.step, "params": state.params,
        "opt_state": {"mu": state.opt_state["mu"],
                      "nu": state.opt_state["nu"]}})


def load_params(path) -> dict:
    """Just the model parameters (numpy arrays) from a train-state or a
    bare-params checkpoint, of the port or of the JAX package. A parameter
    tree has no top-level ``params`` key, so the rule is JAX's
    ``load_params``: a tree with one is a train state."""
    tree = load_pytree(path)
    return tree["params"] if "params" in tree else tree


def load_train_state(path, like_state):
    """Restore step, params and moments into ``like_state``'s buffers.

    Only the port's own train state resumes: a JAX train state's
    ``opt_state`` is optax's chain (``(ScaleByAdamState(count, mu, nu),
    ...)``), which no rule maps onto the port's ``{mu, nu}``, so it raises
    ``ValueError`` (its parameters still load with :func:`load_params`)."""
    tree = load_pytree(path)
    opt = tree.get("opt_state")
    if not (isinstance(opt, dict) and set(opt) == {"mu", "nu"}):
        found = sorted(opt) if isinstance(opt, dict) else type(opt).__name__
        raise ValueError(
            f"{path}: opt_state holds {found}, not the port's {{mu, nu}} "
            "Adam moments: a JAX (optax chain) train state cannot resume in "
            "the port; load its parameters with load_params instead")

    def fill(dst: dict, src: dict):
        for k, v in dst.items():
            if isinstance(v, dict):
                fill(v, src[k])
            else:
                v.copy_(torch.from_numpy(np.asarray(src[k])))

    fill(like_state.params, tree["params"])
    fill(like_state.opt_state["mu"], tree["opt_state"]["mu"])
    fill(like_state.opt_state["nu"], tree["opt_state"]["nu"])
    like_state.step = int(tree["step"])
    return like_state
