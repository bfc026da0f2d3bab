"""Shared helpers of the tests that hold the PyTorch port against the JAX
package: random flax params from a numpy seed (no jitted init), the
signal-to-noise ratio the parity bars are stated in, and the depth cut of
TINY_MODEL that keeps the JAX compiles short."""

import dataclasses

import jax
import numpy as np


def cut_config(cfg):
    """TINY_MODEL cut to two UNet levels of one resnet each and one VAE
    resnet per level (widths and the VAE's 8x scale kept): still a
    cross-attention level with adapters, the mid block, FiLM at every block
    boundary and the feature pass, at a fraction of the JAX compile. Works
    on the JAX package's config and on the port's alike."""
    unet = dataclasses.replace(
        cfg.unet, block_out_channels=(32, 64), num_attention_heads=(2, 4),
        down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
        up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"), layers_per_block=1,
    )
    vae = dataclasses.replace(cfg.vae, layers_per_block=1)
    return dataclasses.replace(cfg, unet=unet, vae=vae)


def snr_db(want, got) -> float:
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    err = np.mean((want - got) ** 2)
    if err == 0:
        return np.inf
    return float(10 * np.log10(np.mean(want**2) / err))


def random_params(init_fn, *args, seed=0, **kwargs):
    """A flax param tree of numpy leaves shaped as ``init_fn(key, *args)``
    would make it (traced with ``jax.eval_shape``, never compiled), filled
    from ``np.random.default_rng(seed)``: kernels N(0, 1/fan_in), norm scales
    near 1, biases and other leaves small and nonzero."""
    shapes = jax.eval_shape(init_fn, jax.random.PRNGKey(0), *args, **kwargs)
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = str(path[-1].key)
        shape = leaf.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return rng.normal(0.0, fan_in**-0.5, shape).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.normal(size=shape)).astype(np.float32)
        if name == "embedding":
            return rng.normal(0.0, shape[-1] ** -0.5, shape).astype(np.float32)
        if name in ("translation_projection",):
            return rng.normal(0.0, shape[0] ** -0.5, shape).astype(np.float32)
        return (0.1 * rng.normal(size=shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)
