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
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

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


def for_view_sharding(model_cfg, num_views: int, view_devices: int):
    """Return a ModelConfig whose UNet runs joint attention over
    ``num_views`` with the view axis sharded over ``view_devices`` devices."""
    unet = dataclasses.replace(
        model_cfg.unet, num_views=num_views, view_axis="view" if view_devices > 1 else None)
    return dataclasses.replace(model_cfg, unet=unet)
