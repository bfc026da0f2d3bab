"""Write the orbax fixtures of ``tests/test_torch_port_orbax.py``,
``tests/test_torch_port_zstd.py`` and ``chip_smoke.py`` phase 10 with the
JAX package, and ``jax_sha256.json``: for each array leaf, its dtype,
shape and the sha256 of the bytes the JAX package's own reader gives back
(``mvd_tpu/checkpoint/orbax_io.py:load_params`` and
``CheckpointManager.restore``; bf16 as its uint16 bits).

    JAX_PLATFORMS=cpu python tests/fixtures/torch_port_orbax/make_fixtures.py

* ``params/``: ``save_params`` of a small tree: f32 (one value over
  orbax's 1024-byte inline limit, so stored indirect, and small inline
  ones), bf16, int32, a 0-d array and a list;
* ``run/checkpoints/2/``: one step of the JAX package's
  ``CheckpointManager`` over a ``TrainState`` of a small tree with
  ``make_optimizer`` (masked AdamW over the adapter, ``set_to_zero`` over
  the rest) after two updates, with ``dataset_state``, ``wandb_run_id``
  and ``val/noise_loss``.

The arrays are made from fixed seeds; orbax's uuids, file names and
timestamps differ from run to run, the digests do not.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(HERE))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from mvd_tpu.checkpoint.orbax_io import CheckpointManager, load_params, save_params  # noqa: E402
from mvd_tpu.config import OptimizerConfig  # noqa: E402
from mvd_tpu.train import TrainState, make_optimizer  # noqa: E402


def params_tree() -> dict:
    rng = np.random.default_rng(0)
    return {
        "dense": {"kernel": jnp.asarray(rng.standard_normal((300, 4)), jnp.float32),
                  "bias": jnp.asarray(rng.standard_normal(4), jnp.float32)},
        "norm": {"scale": jnp.asarray(rng.standard_normal(6), jnp.bfloat16)},
        "ids": jnp.arange(7, dtype=jnp.int32) * 3 - 5,
        "temperature": jnp.asarray(0.07, jnp.float32),
        "stack": [jnp.ones(3, jnp.float32), jnp.asarray(rng.standard_normal((2, 2)), jnp.float32)],
    }


def train_state() -> TrainState:
    rng = np.random.default_rng(1)
    f = lambda *s: jnp.asarray(rng.standard_normal(s), jnp.float32)
    params = {"params": {
        "unet": {"conv_in": {"kernel": f(3, 3, 4, 8), "bias": f(8)},
                 "blk": {"adapter_self": {"to_q_ref": {"kernel": f(8, 8)},
                                          "to_out_ref": {"kernel": f(8, 8), "bias": f(8)}}}},
        "camera_encoder": {"dense_0": {"kernel": f(12, 8), "bias": f(8)}},
    }}
    tx = make_optimizer(OptimizerConfig(learning_rate=1e-3), params, total_steps=10)
    state = TrainState.create(params, tx)
    for _ in range(2):
        state = state.apply_gradients(jax.tree.map(lambda p: jnp.asarray(
            rng.standard_normal(p.shape), p.dtype), state.params))
    return state


def digests(tree) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        arr = np.asarray(leaf)
        if arr.dtype.name == "bfloat16":
            data = arr.view(np.uint16).tobytes()
        else:
            data = arr.tobytes()
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", getattr(p, "name", p)))) for p in path)
        out[key] = {"dtype": arr.dtype.name, "shape": list(arr.shape),
                    "sha256": hashlib.sha256(data).hexdigest()}
    return out


def main() -> None:
    for name in ("params", "run"):
        shutil.rmtree(os.path.join(HERE, name), ignore_errors=True)
    params_dir = os.path.join(HERE, "params")
    save_params(params_dir, params_tree())
    ckpt_dir = os.path.join(HERE, "run", "checkpoints")
    mgr = CheckpointManager(ckpt_dir, save_interval_steps=1)
    state = train_state()
    mgr.save(2, state, dataset_state={"train": {"seed": 3, "epoch": 1}}, extra={"wandb_run_id": "fixture"},
             metrics={"val/noise_loss": 0.25})
    mgr.wait()
    restored, meta = mgr.restore(state)
    mgr.close()
    record = {
        "params": digests(load_params(params_dir)),
        "run/checkpoints/2": {
            "state": digests({"step": restored.step, "params": restored.params,
                              "opt_state": restored.opt_state}),
            "meta": meta,
            "metrics": {"val/noise_loss": 0.25},
        },
    }
    with open(os.path.join(HERE, "jax_sha256.json"), "w") as f:
        json.dump(record, f, indent=1, sort_keys=True)
    total = sum(os.path.getsize(os.path.join(d, n)) for d, _, fs in os.walk(HERE) for n in fs)
    print(f"wrote the fixtures under {HERE}: {total} bytes")


if __name__ == "__main__":
    main()
