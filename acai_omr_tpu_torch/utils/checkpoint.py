"""Checkpoints as ``.npz`` files of ``/``-joined tree paths (the twin of the
JAX package's orbax-backed ``utils/checkpoint.py``).

A bare parameter tree is what :func:`..models.weights.load_npz` reads, so
``save_pytree(path, params)`` writes the file inference loads. A train state
adds ``step`` and the Adam moments under ``opt_state/``, enough to resume.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..models.weights import _flatten, _unflatten


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


def load_pytree(path) -> dict:
    """The nested dict of numpy arrays :func:`save_pytree` wrote."""
    with np.load(_npz(path)) as data:
        return _unflatten({k: data[k] for k in data.files})


def save_train_state(path, state) -> Path:
    """Save a :class:`..parallel.trainer.TrainState` (step, params, Adam
    moments; the LLRD scales are rebuilt from the config on resume)."""
    return save_pytree(path, {
        "step": state.step, "params": state.params,
        "opt_state": {"mu": state.opt_state["mu"],
                      "nu": state.opt_state["nu"]}})


def load_params(path) -> dict:
    """Just the model parameters (numpy arrays) from a train-state or a
    bare-params checkpoint."""
    tree = load_pytree(path)
    return tree["params"] if "params" in tree and "step" in tree else tree


def load_train_state(path, like_state):
    """Restore step, params and moments into ``like_state``'s buffers."""
    tree = load_pytree(path)

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
