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

``load_jax_train_state`` carries a JAX ``TrainState`` across (its step, its
multi-view UNet params and optax's AdamW moments of the trainable leaves),
so a run started in JAX continues in the port.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..tensor_parallel import refuse_sharded
from ..train.state import TrainState
from .torch_convert import unflatten_tree


def _is_masked(value) -> bool:
    """optax's ``MaskedNode``: the placeholder of a leaf outside a mask."""
    return type(value).__name__ == "MaskedNode"


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], np.ndarray]:
    out = {}
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            out.update(_flatten(value, path))
        elif not _is_masked(value):
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
def export_jax_params(module: nn.Module) -> Dict:
    """The inverse of ``convert_jax_params``: ``module``'s parameters as a
    flax param tree (nested dicts of numpy arrays, no ``params`` level) in
    the JAX package's names and layouts."""
    owners = dict(module.named_modules())
    flat = {}
    for name, p in module.named_parameters():
        *mods, leaf = name.split(".")
        arr = p.detach().cpu().numpy()
        if leaf == "weight":
            if isinstance(owners[".".join(mods)], nn.Embedding):
                leaf = "embedding"
            elif arr.ndim == 2:
                leaf, arr = "kernel", arr.T
            elif arr.ndim == 4:
                leaf, arr = "kernel", arr.transpose(2, 3, 1, 0)
            else:
                leaf = "scale"
        flat[tuple(mods) + (leaf,)] = np.ascontiguousarray(arr)
    return unflatten_tree(flat)


@torch.no_grad()
def load_jax_params(module: nn.Module, tree: Mapping, keep_missing: bool = False) -> List[str]:
    """Copy a flax param tree into ``module`` in place. Raises if a JAX leaf
    has no port parameter or a shape differs, and, unless ``keep_missing``,
    if a port parameter has no JAX leaf. Returns the names of the port
    parameters the tree lacks, which keep their values. A model-sharded
    ``module`` raises: load first, then shard."""
    refuse_sharded(module, "load_jax_params")
    converted = convert_jax_params(tree)
    params = dict(module.named_parameters())
    only_jax = sorted(set(converted) - set(params))
    only_port = sorted(set(params) - set(converted))
    if only_jax or (only_port and not keep_missing):
        raise KeyError(
            f"JAX/port params do not match 1:1: JAX only {only_jax[:10]}"
            f" ({len(only_jax)}), port only {only_port[:10]} ({len(only_port)})"
        )
    for name, arr in converted.items():
        p = params[name]
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{name}: JAX shape {arr.shape} != port shape {tuple(p.shape)}")
        p.copy_(torch.from_numpy(arr).to(p.dtype))
    return only_port


def _find_states(node, fields: Tuple[str, ...], found: List[Any]) -> List[Any]:
    """Every named tuple of an optax state tree (tuples, named tuples,
    dicts) that has all of ``fields``, in tree order."""
    if all(f in getattr(node, "_fields", ()) for f in fields):
        found.append(node)
    elif isinstance(node, Mapping):
        for v in node.values():
            _find_states(v, fields, found)
    elif isinstance(node, tuple):  # optax states are (named) tuples
        for v in node:
            _find_states(v, fields, found)
    return found


def load_jax_train_state(model: nn.ModuleDict, jax_state, cfg, total_steps: int):
    """A port ``TrainState`` from a JAX ``TrainState`` (``step``, ``params``
    of the multi-view UNet, ``opt_state`` of ``make_optimizer``; JAX or
    numpy leaves). ``model["vae"]`` and ``model["text_encoder"]`` must hold
    their weights already. AdamW's ``mu``/``nu`` of the trainable leaves
    become ``exp_avg``/``exp_avg_sq`` and its count the optimizer's step.
    Raises if a moment leaf and a trainable parameter do not match 1:1."""
    load_jax_params(model["mvd"], jax_state.params)
    state = TrainState.create(model, cfg, total_steps)
    adam = _find_states(jax_state.opt_state, ("count", "mu", "nu"), [])
    sched = [s for s in _find_states(jax_state.opt_state, ("count",), [])
             if "mu" not in s._fields]
    if len(adam) != 1:
        raise ValueError(f"expected one AdamW state in the optax state, found {len(adam)}")
    count = int(np.asarray(adam[0].count))
    step = int(np.asarray(jax_state.step))
    if any(int(np.asarray(s.count)) != count for s in sched) or count != step:
        raise ValueError(f"optax counts {count}, {[int(np.asarray(s.count)) for s in sched]} "
                         f"disagree with the step {step}")
    mu, nu = convert_jax_params(adam[0].mu), convert_jax_params(adam[0].nu)
    names = set(state.trainable)
    if set(mu) != names or set(nu) != names:
        raise KeyError(
            f"AdamW moments and trainable params do not match 1:1: moments only "
            f"{sorted(set(mu) - names)[:10]}, params only {sorted(names - set(mu))[:10]}"
        )
    for name, p in state.trainable.items():
        if mu[name].shape != tuple(p.shape) or nu[name].shape != tuple(p.shape):
            raise ValueError(f"{name}: moment shape {mu[name].shape} != {tuple(p.shape)}")
        state.optimizer.state[p] = {
            "step": torch.tensor(float(count)),
            "exp_avg": torch.from_numpy(mu[name]).to(p.device, p.dtype),
            "exp_avg_sq": torch.from_numpy(nu[name]).to(p.device, p.dtype),
        }
    state.step = state.updates = step
    return state
