"""Write the fixtures of ``tests/test_torch_port_evidence.py`` and
``chip_smoke.py`` phase 11 with the JAX package's tools.

    JAX_PLATFORMS=cpu python tests/fixtures/torch_port_evidence/make_fixtures.py

* ``renders_final/proc_00000.zip``, ``proc_00001.zip``:
  ``tools/rendering/procedural.py``'s ``generate_corpus`` for 2 objects x 8
  views at 256² (supersample 2), seed 0: the objects that the port's
  generator must render to the same pixels;
* ``jax_vae/``: ``tools/pretrain_vae.py``'s ``main`` for 1 step at
  ``tiny_vae.yaml`` (TINY_VAE's widths and groups, f32, 32²), batch 2, on
  a copy of those zips (2 objects: no val split, so the latent probe takes
  the next batch);
* ``jax_vae_sha256.json``: for each leaf of ``jax_vae/`` its dtype, shape
  and the sha256 of the bytes that ``mvd_tpu.checkpoint.load_params`` gives
  back.

The zips are the same bytes on every run with the same numpy and PIL;
orbax's file names in ``jax_vae/`` differ from run to run, the digests
do not.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))
sys.path.insert(0, os.path.join(REPO, "tools", "rendering"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pretrain_vae  # noqa: E402
import procedural  # noqa: E402

from mvd_tpu.checkpoint import load_params  # noqa: E402

OBJECTS, VIEWS, SIZE, SEED = 2, 8, 256, 0


def digests(tree) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        arr = np.asarray(leaf)
        key = "/".join(str(p.key) for p in path)
        out[key] = {"dtype": arr.dtype.name, "shape": list(arr.shape),
                    "sha256": hashlib.sha256(arr.tobytes()).hexdigest()}
    return out


def main() -> None:
    for name in ("renders_final", "jax_vae"):
        shutil.rmtree(os.path.join(HERE, name), ignore_errors=True)
    renders = procedural.generate_corpus(HERE, OBJECTS, VIEWS, SIZE, SEED)
    with tempfile.TemporaryDirectory() as tmp:  # the JAX tool writes a pair cache into its corpus
        shutil.copytree(renders, os.path.join(tmp, "renders_final"))
        pretrain_vae.main(["--dataset-path", tmp, "--output", os.path.join(HERE, "jax_vae"),
                           "--config", os.path.join(HERE, "tiny_vae.yaml"), "--steps", "1",
                           "--batch-size", "2", "--platform", "cpu"])
    with open(os.path.join(HERE, "jax_vae_sha256.json"), "w") as f:
        json.dump(digests(load_params(os.path.join(HERE, "jax_vae"))), f, indent=1, sort_keys=True)
    total = sum(os.path.getsize(os.path.join(d, n)) for d, _, fs in os.walk(HERE) for n in fs)
    print(f"wrote the fixtures under {HERE}: {total} bytes")


if __name__ == "__main__":
    main()
