"""Carry the JAX package's params across into the port.

The port's parameter names follow the flax paths with the ``params``
collection level dropped, so the mapping is mechanical:

* ``.../kernel`` of a Dense ``(in, out)`` -> ``.../weight`` ``(out, in)``;
* ``.../kernel`` of a conv, HWIO -> ``.../weight`` OIHW;
* ``.../scale`` and ``.../embedding`` -> ``.../weight``;
* ``.../bias`` -> ``.../bias``;
* raw params (``translation_projection``, ``position_embedding``) as they are.

The input is the JAX param tree as nested dicts of numpy arrays, e.g.
``jax.tree.map(np.asarray, pipe.params)`` for a whole pipeline
(``{"mvd": ..., "vae": ..., "text_encoder": ...}``) or one module's tree.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], np.ndarray]:
    out = {}
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            out.update(_flatten(value, path))
        else:
            out[path] = np.asarray(value)
    return out


def convert_jax_params(tree: Mapping) -> Dict[str, np.ndarray]:
    """Flax param tree -> {port parameter name: array in torch layout}."""
    out = {}
    for path, arr in _flatten(tree).items():
        path = tuple(p for p in path if p != "params")
        *mods, leaf = path
        if leaf == "kernel":
            if arr.ndim == 2:
                arr = arr.T
            elif arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            else:
                raise ValueError(f"kernel {'/'.join(path)} of rank {arr.ndim}")
            leaf = "weight"
        elif leaf in ("scale", "embedding"):
            leaf = "weight"
        out[".".join(mods + [leaf])] = np.ascontiguousarray(arr)
    return out


@torch.no_grad()
def load_jax_params(module: nn.Module, tree: Mapping) -> nn.Module:
    """Copy a flax param tree into ``module`` in place. Raises if any JAX
    leaf or any port parameter is left unmatched, or a shape differs."""
    converted = convert_jax_params(tree)
    params = dict(module.named_parameters())
    only_jax = sorted(set(converted) - set(params))
    only_port = sorted(set(params) - set(converted))
    if only_jax or only_port:
        raise KeyError(
            f"JAX/port params do not match 1:1: JAX only {only_jax[:10]}"
            f" ({len(only_jax)}), port only {only_port[:10]} ({len(only_port)})"
        )
    for name, p in params.items():
        arr = converted[name]
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{name}: JAX shape {arr.shape} != port shape {tuple(p.shape)}")
        p.copy_(torch.from_numpy(arr).to(p.dtype))
    return module
