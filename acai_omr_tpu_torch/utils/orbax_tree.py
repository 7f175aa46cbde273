"""Read a checkpoint directory the JAX package writes (orbax), without JAX.

The JAX package's ``utils/checkpoint.save_pytree`` / ``save_train_state``
write an orbax ``PyTreeCheckpointer`` directory: ``_METADATA`` (JSON) lists
every leaf's key path under ``tree_metadata``; the arrays live in an OCDBT
key-value store (``manifest.ocdbt``, ``d/``) as zarr arrays named by the
``.``-joined key path (or, with ``use_ocdbt`` off, in one directory per
leaf). :func:`read` opens each leaf with ``tensorstore`` and rebuilds the
nested dict of numpy arrays: bf16 leaves come back as ``ml_dtypes.bfloat16``
arrays, scalars such as ``step`` as 0-d arrays, leaves orbax stored as None
(optax's empty states) as None. Sequence nodes (optax's chain tuple) come
back as dicts keyed ``"0"``, ``"1"``, ...

``tensorstore`` is imported inside :func:`read` only: it is optional, and
nothing else of the port needs it.
"""

from __future__ import annotations

import json
from pathlib import Path

METADATA = "_METADATA"


def is_orbax_dir(path) -> bool:
    """True for a directory that holds an orbax checkpoint's ``_METADATA``."""
    path = Path(path)
    return path.is_dir() and (path / METADATA).is_file()


def _spec(root: Path, name: str, meta: dict) -> dict:
    driver = "zarr3" if meta.get("use_zarr3") else "zarr"
    if meta.get("use_ocdbt", False):
        kvstore = {"driver": "ocdbt", "base": root.as_uri(),
                   "path": f"{name}/"}
    else:
        kvstore = {"driver": "file", "path": str(root / name)}
    return {"driver": driver, "kvstore": kvstore}


def read(path) -> dict:
    """The nested dict of numpy arrays stored in orbax directory ``path``."""
    try:
        import tensorstore as ts
    except ImportError as e:
        raise ImportError(
            f"reading a JAX (orbax) checkpoint ({path}) needs the optional "
            "package `tensorstore`, which is not installed") from e
    root = Path(path).absolute()
    meta = json.loads((root / METADATA).read_text())
    tree: dict = {}
    for entry in meta["tree_metadata"].values():
        keys = [str(k["key"]) for k in entry["key_metadata"]]
        value = entry.get("value_metadata", {})
        leaf = None
        if not value.get("skip_deserialize", False):
            leaf = ts.open(_spec(root, ".".join(keys), meta)).result()
            leaf = leaf.read().result()
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf
    return tree
