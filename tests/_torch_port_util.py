"""Shared helpers of the tests that hold the PyTorch port against the JAX
package: random flax params from a numpy seed (no jitted init), and the
signal-to-noise ratio the parity bars are stated in."""

import jax
import numpy as np


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
