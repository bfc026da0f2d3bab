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
(``{"mvd": ..., "vae": ..., "text_encoder": ...}``) or one module's tree,
or the same tree read from an orbax checkpoint by
``orbax_read.read_tree`` (``lazy=True``: leaves read one by one as they
are copied into the parameters).

``load_jax_train_state`` carries a JAX ``TrainState`` across (its step, its
multi-view UNet params, optax's AdamW moments of the trainable leaves and,
with gradient accumulation, optax's MultiSteps state), in memory or as read
from a Trainer step on disk, so a run started in JAX continues in the port.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..tensor_parallel import refuse_sharded
from ..train.state import TrainState
from .torch_convert import unflatten_tree


def _is_masked(value) -> bool:
    """optax's ``MaskedNode`` (``None`` in a tree read from disk): the
    placeholder of a leaf outside a mask."""
    return value is None or type(value).__name__ == "MaskedNode"


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], Any]:
    out = {}
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            out.update(_flatten(value, path))
        elif not _is_masked(value):
            out[path] = value
    return out


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else np.shape(leaf)


def _plan(tree: Mapping) -> Dict[str, Tuple[Any, str]]:
    """Flax param tree -> {port parameter name: (leaf, layout)}, the leaf
    not read yet; layout "dense" (``(in, out)`` kernel), "conv" (HWIO
    kernel) or "" (as it is)."""
    out = {}
    for path, leaf in _flatten(tree).items():
        path = tuple(p for p in path if p != "params")
        *mods, name = path
        layout = ""
        if name == "kernel":
            ndim = len(_shape(leaf))
            if ndim not in (2, 4):
                raise ValueError(f"kernel {'/'.join(path)} of rank {ndim}")
            layout, name = ("dense" if ndim == 2 else "conv"), "weight"
        elif name in ("scale", "embedding"):
            name = "weight"
        out[".".join(mods + [name])] = (leaf, layout)
    return out


def _port_shape(shape: Tuple[int, ...], layout: str) -> Tuple[int, ...]:
    if layout == "dense":
        return shape[1], shape[0]
    if layout == "conv":
        return shape[3], shape[2], shape[0], shape[1]
    return tuple(shape)


def _to_port(arr, layout: str, device=None) -> torch.Tensor:
    """A loaded leaf (numpy, JAX or torch) as a torch tensor in the port's
    layout, moved to ``device`` first so that the layout change runs there
    (a view; the copy into the parameter makes it contiguous)."""
    if not torch.is_tensor(arr):
        arr = np.asarray(arr)
        arr = torch.from_numpy(arr if arr.flags.writeable else arr.copy())
    if device is not None:
        arr = arr.to(device)
    if layout == "dense":
        return arr.t()
    if layout == "conv":
        return arr.permute(3, 2, 0, 1)
    return arr


def _loaded(plan: Dict[str, Tuple[Any, str]]):
    """(name, loaded leaf, layout) for every entry of a plan, in order;
    leaves read from disk load on threads a bounded number of bytes ahead
    (``orbax_read.prefetch``), so a whole tree never sits in memory."""
    from .orbax_read import prefetch

    layouts = {name: layout for name, (_, layout) in plan.items()}
    for name, arr in prefetch((name, leaf) for name, (leaf, _) in plan.items()):
        yield name, arr, layouts[name]


def convert_jax_params(tree: Mapping) -> Dict[str, np.ndarray]:
    """Flax param tree -> {port parameter name: array in torch layout}."""
    out = {}
    for name, (leaf, layout) in _plan(tree).items():
        arr = np.asarray(leaf.load() if hasattr(leaf, "load") else leaf)
        if layout == "dense":
            arr = arr.T
        elif layout == "conv":
            arr = arr.transpose(3, 2, 0, 1)
        out[name] = np.ascontiguousarray(arr)
    return out


@torch.no_grad()
def jax_param_path(owners: Mapping[str, nn.Module], name: str, ndim: int) -> Tuple[Tuple[str, ...], str]:
    """The flax path (no ``params`` level) of the port parameter ``name``
    of rank ``ndim`` (``owners``: ``dict(module.named_modules())``), and
    its layout there: "dense" (``(in, out)`` kernel), "conv" (HWIO kernel)
    or "" (as it is)."""
    *mods, leaf = name.split(".")
    layout = ""
    if leaf == "weight":
        if isinstance(owners[".".join(mods)], nn.Embedding):
            leaf = "embedding"
        elif ndim in (2, 4):
            leaf, layout = "kernel", ("dense" if ndim == 2 else "conv")
        else:
            leaf = "scale"
    return tuple(mods) + (leaf,), layout


@torch.no_grad()
def export_jax_params(module: nn.Module, tensors: Optional[Mapping[str, torch.Tensor]] = None,
                      dtype: Optional[torch.dtype] = None) -> Dict:
    """The inverse of ``convert_jax_params``: ``module``'s parameters as a
    flax param tree (nested dicts of numpy arrays, no ``params`` level) in
    the JAX package's names and layouts. ``tensors`` (keyed by parameter
    names, laid out as the parameters: AdamW's moments, say) replaces the
    parameters' values; ``dtype`` casts each first (``torch.float32`` for a
    ``TrainState``'s bf16 frozen weights, which numpy cannot hold)."""
    owners = dict(module.named_modules())
    if tensors is None:
        tensors = dict(module.named_parameters())
    flat = {}
    for name, p in tensors.items():
        arr = p.detach().to(dtype or p.dtype).cpu().numpy()
        path, layout = jax_param_path(owners, name, arr.ndim)
        if layout == "dense":
            arr = arr.T
        elif layout == "conv":
            arr = arr.transpose(2, 3, 1, 0)
        flat[path] = np.ascontiguousarray(arr)
    return unflatten_tree(flat)


@torch.no_grad()
def load_jax_params(module: nn.Module, tree: Mapping, keep_missing: bool = False) -> List[str]:
    """Copy a flax param tree into ``module`` in place. Raises if a JAX leaf
    has no port parameter or a shape differs, and, unless ``keep_missing``,
    if a port parameter has no JAX leaf. Returns the names of the port
    parameters the tree lacks, which keep their values. A model-sharded
    ``module`` raises: load first, then shard."""
    refuse_sharded(module, "load_jax_params")
    plan = _plan(tree)
    params = dict(module.named_parameters())
    only_jax = sorted(set(plan) - set(params))
    only_port = sorted(set(params) - set(plan))
    if only_jax or (only_port and not keep_missing):
        raise KeyError(
            f"JAX/port params do not match 1:1: JAX only {only_jax[:10]}"
            f" ({len(only_jax)}), port only {only_port[:10]} ({len(only_port)})"
        )
    for name, (leaf, layout) in plan.items():
        shape = _port_shape(_shape(leaf), layout)
        if shape != tuple(params[name].shape):
            raise ValueError(f"{name}: JAX shape {shape} != port shape {tuple(params[name].shape)}")
    for name, arr, layout in _loaded(plan):
        p = params[name]
        p.copy_(_to_port(arr, layout, p.device).to(p.dtype))
    return only_port


def _names(node) -> Tuple[str, ...]:
    """The fields of an optax state node: a named tuple's, or the keys of
    the dict it becomes on disk."""
    return tuple(node) if isinstance(node, Mapping) else getattr(node, "_fields", ())


def _field(node, name: str):
    return node[name] if isinstance(node, Mapping) else getattr(node, name)


def _int(leaf) -> int:
    return int(np.asarray(leaf.load() if hasattr(leaf, "load") else leaf))


def _find_states(node, fields: Tuple[str, ...], found: List[Any]) -> List[Any]:
    """Every state of an optax state tree that has all of ``fields``, in
    tree order: named tuples in memory, dicts of their fields on disk
    (tuples become lists there)."""
    if all(f in _names(node) for f in fields):
        found.append(node)
    elif isinstance(node, Mapping):
        for v in node.values():
            _find_states(v, fields, found)
    elif isinstance(node, (tuple, list)):
        for v in node:
            _find_states(v, fields, found)
    return found


MULTI_STEPS_FIELDS = ("mini_step", "gradient_step", "inner_opt_state", "acc_grads")


def _moments(tree, trainable: Dict[str, nn.Parameter], what: str) -> Dict[str, torch.Tensor]:
    """A masked tree of the trainable leaves (AdamW's ``mu``/``nu``,
    MultiSteps' ``acc_grads``) as tensors laid out as the parameters,
    read leaf by leaf."""
    plan = _plan(tree)
    names = set(trainable)
    if set(plan) != names:
        raise KeyError(
            f"{what} and trainable params do not match 1:1: {what} only "
            f"{sorted(set(plan) - names)[:10]}, params only {sorted(names - set(plan))[:10]}"
        )
    for name, (leaf, layout) in plan.items():
        shape = _port_shape(_shape(leaf), layout)
        if shape != tuple(trainable[name].shape):
            raise ValueError(f"{name}: {what} shape {shape} != {tuple(trainable[name].shape)}")
    out = {}
    for name, arr, layout in _loaded(plan):
        p = trainable[name]
        out[name] = torch.empty_like(p, requires_grad=False).copy_(_to_port(arr, layout, p.device))
    return out


@torch.no_grad()
def carry_jax_train_state(state: TrainState, jax_state) -> TrainState:
    """Load a JAX ``TrainState`` into the port's ``state`` in place: its
    step, the multi-view UNet's params (cast to the dtypes ``state`` holds
    them in), AdamW's ``mu``/``nu`` of the trainable leaves as
    ``exp_avg``/``exp_avg_sq`` and its count as the optimizer's step, and
    with optax's ``MultiSteps`` (``grad_accum_steps`` k > 1) its
    ``mini_step``, ``gradient_step`` (the port's ``updates``) and
    ``acc_grads`` (the port's ``acc``).

    ``jax_state`` is the JAX object or the dict ``orbax_read.read_step``
    gives (named tuples as dicts of their fields, masked leaves ``None``,
    leaves loaded or not). Raises, naming the case, where the state does
    not carry: no or several AdamW states, counts that disagree with the
    step, a MultiSteps state under k = 1 or none under k > 1, moments
    that do not match the trainable parameters 1:1."""
    opt_state = _field(jax_state, "opt_state")
    step = _int(_field(jax_state, "step"))
    k = state.grad_accum_steps
    multi = _find_states(opt_state, MULTI_STEPS_FIELDS, [])
    if len(multi) > 1:
        raise ValueError(f"expected at most one optax MultiSteps state, found {len(multi)}")
    if multi and k == 1:
        raise ValueError("the optax state is MultiSteps (the JAX run accumulated gradients): "
                         "set grad_accum_steps to the JAX run's")
    if not multi and k > 1:
        raise ValueError(f"grad_accum_steps is {k} but the optax state has no MultiSteps state "
                         "(the JAX run did not accumulate gradients)")
    inner = _field(multi[0], "inner_opt_state") if multi else opt_state
    adam = _find_states(inner, ("count", "mu", "nu"), [])
    if len(adam) != 1:
        raise ValueError(f"expected one AdamW state in the optax state, found {len(adam)}")
    sched = [_int(_field(s, "count")) for s in _find_states(inner, ("count",), [])
             if "mu" not in _names(s)]
    count = _int(_field(adam[0], "count"))
    if multi:
        mini, updates = _int(_field(multi[0], "mini_step")), _int(_field(multi[0], "gradient_step"))
        if (any(c != count for c in sched) or updates != count or not 0 <= mini < k
                or step != updates * k + mini):
            raise ValueError(f"optax MultiSteps counts (mini_step {mini}, gradient_step {updates}, "
                             f"AdamW count {count}, schedule counts {sched}) disagree with the step "
                             f"{step} at grad_accum_steps {k}")
    else:
        mini = 0
        if any(c != count for c in sched) or count != step:
            raise ValueError(f"optax counts {count}, {sched} disagree with the step {step}")
    load_jax_params(state.model["mvd"], _field(jax_state, "params"))
    mu = _moments(_field(adam[0], "mu"), state.trainable, "AdamW moments")
    nu = _moments(_field(adam[0], "nu"), state.trainable, "AdamW moments")
    state.optimizer.state.clear()
    for name, p in state.trainable.items():
        state.optimizer.state[p] = {"step": torch.tensor(float(count)), "exp_avg": mu[name],
                                    "exp_avg_sq": nu[name]}
    state.acc = _moments(_field(multi[0], "acc_grads"), state.trainable, "MultiSteps acc_grads") \
        if multi else None
    state.step, state.updates, state.mini_step = step, count, mini
    return state


def load_jax_train_state(model: nn.ModuleDict, jax_state, cfg, total_steps: int) -> TrainState:
    """A port ``TrainState`` from a JAX ``TrainState``: ``TrainState.create``
    on ``model`` (whose ``vae`` and ``text_encoder`` must hold their
    weights already), then ``carry_jax_train_state``."""
    return carry_jax_train_state(TrainState.create(model, cfg, total_steps), jax_state)
