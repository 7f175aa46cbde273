"""Checkpoints as ``.npz`` files of ``/``-joined tree paths (the twin of the
JAX package's orbax-backed ``utils/checkpoint.py``).

A bare parameter tree is what :func:`..models.weights.load_npz` reads, so
``save_pytree(path, params)`` writes the file inference loads. A train state
adds ``step`` and the Adam moments under ``opt_state/``, enough to resume.

The readers also take a checkpoint directory the JAX package wrote (orbax,
read by :mod:`.orbax_tree`, which needs the optional ``tensorstore``):
:func:`load_pytree` and :func:`load_params` return its tree of numpy arrays,
and :func:`load_train_state` resumes a JAX train state, whose optimizer state
is the optax chain of the JAX package's ``parallel/trainer.adamw``: its one
Adam state's moments become the port's ``{mu, nu}``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..models.weights import _flatten, _unflatten, leaf_tensor
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


def _adam_states(node, where: tuple = ()) -> list:
    """Every (path, node) of an optax state tree, as :mod:`.orbax_tree`
    reads it (a chain's tuple as keys ``"0"``, ``"1"``, ...), that holds
    ``count``, ``mu`` and ``nu``: a ``ScaleByAdamState``."""
    if not isinstance(node, dict):
        return []
    if {"count", "mu", "nu"} <= node.keys():
        return [(where, node)]
    return [hit for k, v in node.items()
            for hit in _adam_states(v, where + (k,))]


def _check_tree(tree, like: dict, what: str, path) -> None:
    """Raise ValueError unless ``tree`` holds ``like``'s keys and shapes."""
    got = _flatten(tree) if isinstance(tree, dict) else {}
    want = _flatten(like)
    if got.keys() != want.keys():
        missing, extra = sorted(want.keys() - got.keys()), sorted(
            got.keys() - want.keys())
        raise ValueError(f"{path}: {what} do not match the parameters: "
                         f"missing {missing[:4]}, extra {extra[:4]}")
    for k, v in want.items():
        if tuple(np.shape(got[k])) != tuple(v.shape):
            raise ValueError(f"{path}: {what} leaf {k!r} has shape "
                             f"{tuple(np.shape(got[k]))}, the parameter "
                             f"{tuple(v.shape)}")


def _jax_moments(tree: dict, path) -> tuple[dict, dict, str]:
    """``mu``, ``nu`` and the path of the one Adam state in a JAX train
    state's optax chain (``clip_by_global_norm``, ``adamw``,
    ``layerwise_lr_scale``, the first and last optional), after checking
    that its ``count`` equals the state's ``step``. The chain's other states
    (the schedule's count, the LLRD or frozen scales) are not read: the
    scales are rebuilt from the config, as on any resume."""
    found = _adam_states(tree["opt_state"])
    if len(found) != 1:
        where = ["opt_state/" + "/".join(w) for w, _ in found]
        raise ValueError(
            f"{path}: a JAX train state's opt_state must hold one Adam state "
            f"(count, mu, nu); found {len(found)} {where}, top-level keys "
            f"{sorted(tree['opt_state'])}")
    where, adam = found[0]
    name = "opt_state/" + "/".join(where)
    step, count = int(tree["step"]), int(np.asarray(adam["count"]))
    if step != count:
        raise ValueError(f"{path}: step {step} differs from the Adam count "
                         f"{count} at {name}")
    return adam["mu"], adam["nu"], name


def load_train_state(path, like_state):
    """Restore step, params and Adam moments into ``like_state``'s buffers,
    from the port's own train state (``opt_state`` = ``{mu, nu}``) or from
    a JAX train state (an orbax directory whose ``opt_state`` is the optax
    chain of the JAX package's ``trainer.adamw``; see :func:`_jax_moments`).
    The moments are copied as fp32; ``like_state``'s scale tree, built from
    the config, is kept. A state of neither form, or whose moments or
    parameters do not have ``like_state``'s keys and shapes, raises
    ``ValueError`` naming what it found."""
    tree = load_pytree(path)
    opt = tree.get("opt_state")
    if not isinstance(opt, dict) or "params" not in tree or "step" not in tree:
        found = sorted(tree)
        raise ValueError(f"{path}: not a train state (step, params, "
                         f"opt_state): top-level keys {found}")
    if set(opt) == {"mu", "nu"}:
        mu, nu, name = opt["mu"], opt["nu"], "opt_state"
    else:
        mu, nu, name = _jax_moments(tree, path)
    for what, src in (("params", tree["params"]), (f"{name}/mu", mu),
                      (f"{name}/nu", nu)):
        _check_tree(src, like_state.params, what, path)

    def fill(dst: dict, src: dict):
        for k, v in dst.items():
            if isinstance(v, dict):
                fill(v, src[k])
            else:
                v.copy_(leaf_tensor(src[k]))

    fill(like_state.params, tree["params"])
    fill(like_state.opt_state["mu"], mu)
    fill(like_state.opt_state["nu"], nu)
    like_state.step = int(tree["step"])
    return like_state
