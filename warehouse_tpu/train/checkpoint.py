"""Checkpoint/resume as NumPy archives keyed by pytree path (SURVEY.md §5.4).

Capability parity with ``tune``/``Algorithm.save()``: the full training
pytree {params, opt_state, env_state, rng key, step} is saved and
restored bit-identically (tested in tests/test_checkpoint.py). Recovery
model (SURVEY.md §5.3): frequent checkpoints + restart-from-latest;
elastic resize is out of scope.

Format: ``<dir>/step_<8 digits>/`` holds ``arrays.npz`` (one entry per
leaf, named by its key path, e.g. ``params/params/Dense_0/kernel``) and
``manifest.json`` (each leaf's dtype and shape, in flattening order).
Dtypes NumPy cannot store natively (bfloat16) are saved as same-width
unsigned integers and viewed back on load. A save is written to a
temporary directory and renamed into place, so a crash mid-save never
leaves a directory that :func:`latest_step` counts.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

_ARRAYS = "arrays.npz"
_MANIFEST = "manifest.json"


def _step_dir(directory: str, step: int) -> str:
    return os.path.abspath(os.path.join(directory, f"step_{step:08d}"))


def _path_name(path) -> str:
    parts = []
    for k in path:
        if isinstance(k, jax.tree_util.GetAttrKey):
            part = k.name
        elif isinstance(k, jax.tree_util.DictKey):
            part = str(k.key)
        elif isinstance(k, jax.tree_util.SequenceKey):
            part = str(k.idx)
        elif isinstance(k, jax.tree_util.FlattenedIndexKey):
            part = str(k.key)
        else:
            raise TypeError(f"unsupported pytree key {k!r}")
        if "/" in part:
            raise ValueError(f"pytree key {part!r} contains '/'")
        parts.append(part)
    return "/".join(parts)


def _to_host(x) -> np.ndarray:
    if isinstance(x, jax.Array) and not x.is_fully_addressable:
        from jax.experimental import multihost_utils

        x = multihost_utils.process_allgather(x, tiled=True)
    return np.asarray(x)


def save(directory: str, step: int, tree: Any) -> str:
    """Save pytree under directory/step_{step}; returns the path.

    Every process takes part (sharded leaves are gathered); process 0
    writes."""
    path = _step_dir(directory, step)
    leaves = [(_path_name(p), _to_host(x))
              for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]]
    if jax.process_index() != 0:
        return path
    manifest, arrays = [], {}
    for name, arr in leaves:
        manifest.append({"name": name, "dtype": str(arr.dtype),
                         "shape": list(arr.shape)})
        if arr.dtype.kind not in "biufc":   # e.g. bfloat16
            arr = arr.view(f"u{arr.dtype.itemsize}")
        arrays[name] = arr
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, _ARRAYS), **arrays)
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)
    return path


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    # Only finalized checkpoints (exact `step_XXXXXXXX` names) count; a
    # crash mid-save leaves a `step_XXXXXXXX.tmp-<pid>` directory.
    steps = [
        int(m.group(1))
        for name in os.listdir(directory)
        if (m := re.fullmatch(r"step_(\d+)", name))
    ]
    return max(steps) if steps else None


def _load(path: str) -> dict[str, np.ndarray]:
    """{leaf name: host array} of one checkpoint directory."""
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, _ARRAYS)) as z:
        return {m["name"]: z[m["name"]].view(jnp.dtype(m["dtype"]))
                for m in manifest}


def restore(directory: str, step: int, target: Any) -> Any:
    """Restore into the structure of ``target``, whose leaves may be
    arrays or ``jax.ShapeDtypeStruct``s; each leaf is placed with the
    target leaf's sharding when it has one."""
    arrays = _load(_step_dir(directory, step))
    flat, treedef = jax.tree_util.tree_flatten_with_path(target)
    out = []
    for p, ref in flat:
        name = _path_name(p)
        if name not in arrays:
            raise KeyError(f"checkpoint has no leaf {name!r}")
        arr = arrays[name]
        if arr.shape != tuple(ref.shape) or arr.dtype != ref.dtype:
            raise ValueError(
                f"{name}: checkpoint {arr.dtype}{list(arr.shape)} vs "
                f"target {ref.dtype}{list(ref.shape)}")
        sharding = getattr(ref, "sharding", None)
        out.append(jax.device_put(arr, sharding) if sharding is not None
                   else jnp.asarray(arr))
    return jax.tree_util.tree_unflatten(treedef, out)


def restore_latest(directory: str, target: Any) -> tuple[int, Any] | None:
    step = latest_step(directory)
    if step is None:
        return None
    return step, restore(directory, step, target)


def restore_params(directory: str, step: int | None = None) -> Any:
    """Restore only the ``params`` subtree of a training checkpoint.

    Structure-free: no model object is needed — the nested parameter
    dicts are rebuilt from the leaf names, on the default device, so
    serving (``warehouse_tpu.serve``) and evaluation load params knowing
    only the directory, whatever device the checkpoint was saved from.
    """
    if step is None:
        step = latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    params: dict = {}
    for name, arr in _load(_step_dir(directory, step)).items():
        head, *rest = name.split("/")
        if head != "params" or not rest:
            continue
        node = params
        for part in rest[:-1]:
            node = node.setdefault(part, {})
        node[rest[-1]] = jnp.asarray(arr)
    if not params:
        raise KeyError(f"checkpoint step {step} has no params")
    return params
