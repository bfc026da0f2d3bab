"""View-sharded (joint multi-view) model execution over a mesh of processes.

Counterpart of ``mvd_tpu/parallel.py``. Multi-view batches are (B, V, ...):
axis 0 over the ``data`` axis of the mesh, axis 1 over ``view``. Each rank
takes its (B_l, V_l, ...) block (``Mesh.block``) and flattens it to the
model's rows (row = b * V_l + v, views fastest), so every per-row operation
(convolutions, norms, cross-attention, adapters, FiLM) stays on the rank;
the only communication inside the model is the ring K/V exchange of joint
self-attention (``kernels/ring_attention.py``), bound to the mesh for the
call (``Mesh.bind``). The functions take the global tensors, the same on
every rank (conditioning computed unsharded, as the JAX pipeline's twin
computes it), and return this rank's block.

The ``model`` axis (``model_parallel_shardings``,
``shard_params_model_parallel``) is the JAX rule for the widest 2-D params
(``mvd_tpu/parallel.py:195-224``) made explicit: where GSPMD partitions
the products in JAX, the port swaps the marked layers for the
tensor-parallel forms of ``tensor_parallel.py``, Megatron's pairs where
the network has them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch
import torch.nn as nn

from .diffusion.schedules import ddim_step, ddpm_step, inference_timesteps


def tree_map(fn, tree):
    """``fn`` over the tensors of a tree of dicts, tuples and lists (None
    stays None)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def _flatten_bv(x: torch.Tensor) -> torch.Tensor:
    return x.reshape((-1,) + tuple(x.shape[2:]))


def local_rows(mesh, tree):
    """This rank's flat rows of every global (B, V, ...) tensor of ``tree``."""
    return tree_map(lambda x: _flatten_bv(mesh.block(x)), tree)


def _check(mvd_unet, mesh) -> int:
    """The local view count V_l of a view-sharded model on ``mesh``."""
    ucfg = mvd_unet.cfg.unet
    if ucfg.view_axis != "view":
        raise ValueError(f"a view-sharded call needs a model with view_axis 'view', got {ucfg.view_axis!r}")
    if ucfg.num_views % mesh.shape["view"]:
        raise ValueError(f"{ucfg.num_views} views do not divide over the mesh's "
                         f"{mesh.shape['view']} view processes")
    return ucfg.num_views // mesh.shape["view"]


def sharded_denoise_fn(mvd_unet, mesh) -> Callable:
    """A view-sharded denoise: ``fn(sample_bv, t, text_bv, film=None,
    ref_features=None, ref_scale=None)`` with sample (B, V, h, w, 4), text
    (B, V, 77, D), FiLM pairs (B, V, C) and reference features or their
    precomputed K/V (B, V, S, C), all global; returns this rank's
    prediction block (B_l, V_l, h, w, 4). The model must have
    ``cfg.unet.view_axis == "view"`` and ``num_views == V``."""
    V_l = _check(mvd_unet, mesh)

    def fn(sample, t, text, film=None, ref_features=None, ref_scale=None):
        with mesh.bind():
            out = mvd_unet.denoise(local_rows(mesh, sample), t, local_rows(mesh, text),
                                   local_rows(mesh, film), local_rows(mesh, ref_features), ref_scale)
        return out.reshape((-1, V_l) + tuple(out.shape[1:]))

    return fn


def sharded_denoise_cache_fns(mvd_unet, mesh):
    """The cache-returning and cache-consuming forms of
    ``sharded_denoise_fn`` for encoder-propagation sampling (the pipeline's
    ``encoder_reuse``). The encoder cache holds this rank's rows; it only
    flows from one call into the next on the same rank.

    Returns ``(with_cache, cached)``:
      * ``with_cache(sample_bv, t, text_bv, film, ref, scale)`` ->
        ``(pred block, cache)``;
      * ``cached(cache, sample_bv, t, text_bv, film, ref, scale)`` ->
        ``pred block`` (the down path is skipped; the sample is unused)."""
    V_l = _check(mvd_unet, mesh)

    def run(sample, t, text, film, ref_features, ref_scale, **kw):
        with mesh.bind():
            return mvd_unet.denoise(None if sample is None else local_rows(mesh, sample), t,
                                    local_rows(mesh, text), local_rows(mesh, film),
                                    local_rows(mesh, ref_features), ref_scale, **kw)

    def with_cache(sample, t, text, film=None, ref_features=None, ref_scale=None):
        out, cache = run(sample, t, text, film, ref_features, ref_scale, return_encoder_cache=True)
        return out.reshape((-1, V_l) + tuple(out.shape[1:])), cache

    def cached(cache, sample, t, text, film=None, ref_features=None, ref_scale=None):
        out = run(None, t, text, film, ref_features, ref_scale, cached_encoder=cache)
        return out.reshape((-1, V_l) + tuple(out.shape[1:]))

    return with_cache, cached


def make_sharded_sampler(mvd_unet, mesh, schedule, num_inference_steps: int, sampler: str = "ddpm"):
    """A view-sharded sampling loop without guidance: ``fn(latents_bv,
    text_bv, film_bv=None, ref_bv=None, ref_scale=None, generator=None,
    step_noises=None)`` -> the final latents (B, V, h, w, 4) on every rank.
    Each step's prediction blocks are gathered over the mesh, and every rank
    takes the sampler's step on the whole batch with the same noise (DDPM:
    ``step_noises[i]`` (B, V, h, w, 4) where given, else drawn from
    ``generator``), so the trajectory is the unsharded one."""
    if sampler not in ("ddpm", "ddim"):
        raise ValueError(f"the sharded sampler takes ddpm or ddim, got {sampler!r}")
    denoise = sharded_denoise_fn(mvd_unet, mesh)
    ts = inference_timesteps(schedule, num_inference_steps).tolist()

    def fn(latents, text, film=None, ref_features=None, ref_scale=None, generator=None,
           step_noises=None):
        lat = latents
        for i, t in enumerate(ts):
            t_dev = torch.tensor(t, dtype=torch.int64, device=lat.device)
            pred = mesh.gather_blocks(denoise(lat, t_dev, text, film, ref_features, ref_scale))
            if sampler == "ddim":
                lat = ddim_step(schedule, pred, t, lat, num_inference_steps)
            else:
                noise = step_noises[i] if step_noises is not None else torch.randn(
                    lat.shape, generator=generator, device=lat.device)
                lat = ddpm_step(schedule, pred, t, lat, noise, num_inference_steps)
        return lat

    return fn


# ---------------------------------------------------------------------------
# the model axis: tensor parallelism of the widest products
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelParallelPlan:
    """How ``shard_params_model_parallel`` cuts a network over a model axis
    of ``size``: ``marked``, the parameters the JAX rule shards
    (``P(None, "model")``); ``layers``, module name -> (form, options), the
    forms of ``tensor_parallel.py`` ("column" with ``gather`` and
    ``chunks``, "row", "embedding", "param" for a raw parameter); ``cut``,
    every parameter those forms cut; ``partners`` the cut ones the JAX rule
    leaves whole (the row-parallel partner of a marked column-parallel
    product, column-parallel biases)."""

    size: int
    min_dim: int
    marked: Tuple[str, ...]
    layers: Dict[str, Tuple[str, Dict[str, Any]]]
    cut: Tuple[str, ...]

    @property
    def partners(self) -> Tuple[str, ...]:
        return tuple(sorted(set(self.cut) - set(self.marked)))


def _pair_rules():
    """(module type, its column-parallel projections, their blocks, the
    row-parallel projection that takes their shards, the attribute whose
    count the axis must divide): Megatron's pairs, one all-reduce each."""
    from .nn.clip_text import CLIPAttention, CLIPLayer
    from .nn.layers import Attention, CrossViewAdapter, FeedForward, TimestepEmbedMLP

    return (
        (Attention, ("to_q", "to_k", "to_v"), 1, "to_out", "heads"),
        (CrossViewAdapter, ("to_q_ref", "to_k_ref", "to_v_ref"), 1, "to_out_ref", "heads"),
        (CLIPAttention, ("q_proj", "k_proj", "v_proj"), 1, "out_proj", "heads"),
        (FeedForward, ("proj_geglu",), 2, "proj_out", None),
        (TimestepEmbedMLP, ("linear_1",), 1, "linear_2", None),
        (CLIPLayer, ("fc1",), 1, "fc2", None),
    )


# the raw 2-D parameters whose modules take a ParallelParam in their place
_RAW_PARAMS = ("translation_projection", "position_embedding")


def _join(*names: str) -> str:
    return ".".join(n for n in names if n)


def model_parallel_shardings(module: nn.Module, mesh, min_dim: int = 1024) -> ModelParallelPlan:
    """The tensor-parallel plan of ``module`` over the ``model`` axis of
    ``mesh`` (a ``Mesh``, or ``tensor_parallel.virtual_model_axis(n)``).

    The JAX rule (``mvd_tpu/parallel.py:model_parallel_shardings``) marks
    every 2-D param whose last dimension is at least ``min_dim`` and
    divides by the axis: a Dense kernel's output features, which are a
    torch ``Linear``'s ``weight.shape[0]``; an embedding's features; a raw
    2-D param's last dimension. Every marked weight is cut into n equal
    parts. Where it belongs to a Megatron pair (q/k/v and the output
    projection, cut by whole heads; GEGLU's two halves in matching parts
    and ``proj_out``; the time MLP; CLIP's MLP) the whole pair is cut, so
    that one all-reduce serves it; any other marked ``Linear`` is
    column-parallel with its output gathered."""
    from .tensor_parallel import model_axis

    n = model_axis(mesh).size
    marks = lambda dim: dim >= min_dim and dim % n == 0
    marked, layers = [], {}
    for name, m in module.named_modules():
        for pname, p in m.named_parameters(recurse=False):
            if p.dim() != 2:
                continue
            dim = p.shape[0] if isinstance(m, nn.Linear) else p.shape[-1]
            if marks(dim):
                marked.append(_join(name, pname))
    marked_set = set(marked)
    is_marked = lambda mod_name: _join(mod_name, "weight") in marked_set
    rules = _pair_rules()
    for name, m in module.named_modules():
        for kind, cols, chunks, row, count in rules:
            if not isinstance(m, kind):
                continue
            members = cols + (row,)
            if not any(is_marked(_join(name, c)) for c in members):
                continue
            if count is not None and getattr(m, count) % n:
                raise ValueError(f"{name}: {getattr(m, count)} {count} do not divide over a model "
                                 f"axis of {n}")
            for c in cols:
                layers[_join(name, c)] = ("column", {"gather": False, "chunks": chunks})
            layers[_join(name, row)] = ("row", {})
    for name, m in module.named_modules():
        if name in layers:
            continue
        if isinstance(m, nn.Linear) and is_marked(name):
            layers[name] = ("column", {"gather": True, "chunks": 1})
        elif isinstance(m, nn.Embedding) and is_marked(name):
            layers[name] = ("embedding", {})
        else:
            for pname, p in m.named_parameters(recurse=False):
                full = _join(name, pname)
                if full in marked_set and not isinstance(m, (nn.Linear, nn.Embedding)):
                    if pname not in _RAW_PARAMS:
                        raise NotImplementedError(f"{full}: no tensor-parallel form for this parameter")
                    layers[full] = ("param", {})
    modules = dict(module.named_modules())
    cut = []
    for name, (form, _) in layers.items():
        if form == "param":
            cut.append(name)
        elif form == "column" and modules[name].bias is not None:
            cut += [_join(name, "weight"), _join(name, "bias")]
        else:
            cut.append(_join(name, "weight"))
    missing = marked_set - set(cut)
    if missing:
        raise NotImplementedError(f"no tensor-parallel form for {sorted(missing)}")
    return ModelParallelPlan(n, min_dim, tuple(marked), layers, tuple(sorted(cut)))


@torch.no_grad()
def shard_params_model_parallel(module: nn.Module, mesh, min_dim: int = 1024) -> nn.Module:
    """Swap ``module``'s layers, in place, for the tensor-parallel forms of
    ``model_parallel_shardings(module, mesh, min_dim)``, each holding this
    rank's part (all n parts on a virtual axis); returns ``module``. Load
    the weights first: a sharded network refuses a load, and a second cut."""
    from .tensor_parallel import (
        ColumnParallelLinear,
        ParallelEmbedding,
        ParallelParam,
        RowParallelLinear,
        model_axis,
        refuse_sharded,
    )

    refuse_sharded(module, "shard_params_model_parallel")
    axis = model_axis(mesh)
    plan = model_parallel_shardings(module, axis, min_dim)
    for name, (form, opts) in plan.layers.items():
        owner_name, _, attr = name.rpartition(".")
        owner = module.get_submodule(owner_name)
        old = getattr(owner, attr)
        if form == "column":
            new = ColumnParallelLinear(old, axis, **opts)
        elif form == "row":
            new = RowParallelLinear(old, axis)
        elif form == "embedding":
            new = ParallelEmbedding(old, axis)
        else:
            new = ParallelParam(old, axis)
            del owner._parameters[attr]
        setattr(owner, attr, new)
    return module


def for_view_sharding(model_cfg, num_views: int, view_devices: int):
    """Return a ModelConfig whose UNet runs joint attention over
    ``num_views`` with the view axis sharded over ``view_devices`` devices."""
    unet = dataclasses.replace(
        model_cfg.unet, num_views=num_views, view_axis="view" if view_devices > 1 else None)
    return dataclasses.replace(model_cfg, unet=unet)
