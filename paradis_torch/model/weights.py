"""Weight bridge: fill a ``Paradis`` from the JAX package's parameter tree.

``load_flax_params(model, tree)`` takes the flax parameters as nested dicts
of numpy arrays (``{"params": {...}}`` or the inner dict) and copies them into
the port.  The mapping is a renaming plus layout changes:

* the physics-layer leaves under ``layers`` are stacked ``[L, ...]``; slice
  ``i`` goes to ``layers.{i}``;
* Dense kernels ``[in, out]`` (``conv``/``pointwise``) and the GlobalBias
  ``projection`` become ``[out, in]``;
* depthwise kernels ``[k, k, 1, C]`` become ``[C, 1, k, k]``;
* every ``kernel`` is the port's ``weight``; other leaf names are kept.

The bridge is strict: a leaf with no port parameter, a port parameter with no
leaf, or a shape that does not match raises ``ValueError`` and changes nothing.
"""

from __future__ import annotations

import numpy as np
import torch


def _flatten(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flatten(val, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(val)


def flax_leaf(name: str, ndim: int) -> str:
    """The flax leaf name of the port parameter ``name`` of rank ``ndim``.

    The inverse of the renaming below: a ``weight`` of rank ≥ 2 is a flax
    ``kernel`` (the only other ``weight``, ChannelNorm's, is 1-D in both
    packages); every other leaf keeps its name.
    """
    leaf = name.rsplit(".", 1)[-1]
    return "kernel" if leaf == "weight" and ndim >= 2 else leaf


def _convert(parts: tuple, arr: np.ndarray):
    leaf = parts[-1]
    name = list(parts)
    if leaf == "kernel":
        name[-1] = "weight"
        arr = np.transpose(arr, (3, 2, 0, 1)) if arr.ndim == 4 else arr.T
    elif leaf == "projection":
        arr = arr.T
    return ".".join(name), arr


def flax_to_state(tree: dict, num_layers: int) -> dict[str, np.ndarray]:
    """``{port parameter name: array}`` for a flax parameter tree."""
    tree = tree.get("params", tree)
    out = {}
    for parts, arr in _flatten(tree):
        if parts[0] == "layers":
            if arr.shape[0] != num_layers:
                raise ValueError(f"{'/'.join(parts)}: stacked over {arr.shape[0]} layers, "
                                 f"the model has {num_layers}")
            for i in range(num_layers):
                name, a = _convert(parts[1:], arr[i])
                out[f"layers.{i}.{name}"] = a
        else:
            name, a = _convert(parts, arr)
            out[name] = a
    return out


def load_flax_params(model: torch.nn.Module, tree: dict) -> None:
    """Copy a flax parameter tree into ``model`` (in place, strict)."""
    state = flax_to_state(tree, len(model.layers))
    params = dict(model.named_parameters())
    extra = sorted(set(state) - set(params))
    missing = sorted(set(params) - set(state))
    if extra or missing:
        raise ValueError(f"weight bridge mismatch: leaves with no parameter {extra}; "
                         f"parameters with no leaf {missing}")
    for name, arr in state.items():
        if tuple(arr.shape) != tuple(params[name].shape):
            raise ValueError(f"{name}: leaf shape {tuple(arr.shape)} != parameter shape "
                             f"{tuple(params[name].shape)}")
    with torch.no_grad():
        for name, arr in state.items():
            params[name].copy_(torch.tensor(arr, dtype=torch.float32))
