"""Precompute the VAE latent-moment cache of a rendered corpus.

    python -m mvd_tpu_torch.cli.precompute_latents --dataset-path /data/objaverse \
        --image-size 768 [--checkpoint PARAMS_DIR] [--out DIR]

Counterpart of ``mvd_tpu/cli/precompute_latents.py``, on the port's VAE:
encodes every view of every object zip once and writes the posterior
moments (``data/latent_cache.py``, the JAX package's format); pass
``--latent-cache-dir`` to ``cli.train`` afterwards. The same flags, plus
``--device`` (the GPU by default; without one it raises; ``--tiny`` runs
on the CPU only). ``--checkpoint`` takes a ``save_params`` directory (the
port's, or the JAX package's orbax one) with a ``vae`` component; without it the VAE has random weights
from seed 0 (smoke tests only).
"""

from __future__ import annotations

import argparse
import os


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Precompute the VAE latent-moment cache")
    p.add_argument("--dataset-path", required=True)
    p.add_argument("--image-size", type=int, default=None,
                   help="encode resolution (default: the --config YAML's image_size, or 768)")
    p.add_argument("--out", default=None,
                   help="cache directory (default <dataset>/.mvd_latent_cache/<size>)")
    p.add_argument("--checkpoint", default=None,
                   help="a save_params dir (the port's or the JAX package's orbax one) holding the VAE weights; without it the VAE is "
                   "RANDOM (smoke tests only)")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--dtype", default="float32", choices=["float32", "float16"],
                   help="cache STORAGE dtype; float16 halves the cache size")
    p.add_argument("--compute-dtype", default=None, choices=["float32", "bfloat16"],
                   help="VAE COMPUTE dtype of the encode (default: the model config's, so that "
                   "cached moments equal the pixel path's at the training numerics)")
    p.add_argument("--overwrite", action="store_true")
    p.add_argument("--tiny", action="store_true", help="tiny debug VAE (CPU only)")
    p.add_argument("--config", default=None,
                   help="training YAML whose model (vae_config, dtype) the encode should match")
    p.add_argument("--device", type=str, default="cuda")
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)

    import torch

    from ..config import TINY_MODEL, ModelConfig, train_config_from_yaml
    from ..data.latent_cache import corpus_zips, precompute_latent_cache
    from ..nn.vae import AutoencoderKL
    from ..pipeline.pipeline import DTYPES, cast_for_compute, init_weights, resolve_device

    device = resolve_device(args.device)
    if args.tiny and device.type != "cpu":
        raise ValueError("--tiny runs on the CPU only: add --device cpu")
    if args.config:
        tc = train_config_from_yaml(args.config)
        cfg = tc.model
        if args.image_size is None:
            args.image_size = tc.image_size
    else:
        cfg = TINY_MODEL if args.tiny else ModelConfig()
    if args.image_size is None:
        args.image_size = 768
    compute_dtype = args.compute_dtype or cfg.dtype

    with torch.device(device):
        vae = AutoencoderKL(cfg.vae)
    if args.checkpoint:
        from ..checkpoint import load_component

        load_component(vae, args.checkpoint, "vae")
    else:
        init_weights(vae, torch.Generator(device).manual_seed(0))
        print("WARNING: no --checkpoint given: encoding with RANDOM VAE weights (only useful "
              "for smoke tests)")
    if compute_dtype != "float32":  # frozen weights cast as TrainState.create casts them
        vae = cast_for_compute(vae, DTYPES[compute_dtype])
    vae.eval()

    zips = corpus_zips(args.dataset_path)
    if not zips:
        raise SystemExit(f"no corpus zips under {args.dataset_path!r}")
    out = args.out or os.path.join(args.dataset_path, ".mvd_latent_cache", str(args.image_size))
    stats = precompute_latent_cache(
        vae, zips, out, image_size=args.image_size, batch_size=args.batch_size,
        dtype=args.dtype, overwrite=args.overwrite, compute_dtype=compute_dtype,
    )
    print(f"latent cache at {out}: {stats['zips']} zips encoded ({stats['views']} views), "
          f"{stats['skipped']} already cached")
    return stats


if __name__ == "__main__":
    main()
