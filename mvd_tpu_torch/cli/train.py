"""Training CLI of the port.

    python -m mvd_tpu_torch.cli.train --dataset-path /data/objaverse --output-dir outputs
    python -m mvd_tpu_torch.cli.train --resume outputs/<run> --max-steps 2000
    python -m mvd_tpu_torch.cli.train --tiny --device cpu --dataset-path D --batch-size 2
    torchrun --nproc-per-node 4 -m mvd_tpu_torch.cli.train --mesh-data 2 --mesh-view 2 \
        --num-views 2 --dataset-path D

The flags of ``mvd_tpu/cli/train.py``, plus ``--device`` (the GPU by
default; without one the CLI raises; ``--tiny`` runs on the CPU only, as in
``cli/infer.py``) and ``--wandb`` (log to W&B as well as the JSONL; W&B is
not imported otherwise). ``--config`` needs PyYAML. ``--init-params`` takes
a directory written by ``save_params`` (the port's, or the JAX package's
orbax one); ``--resume`` a run of either package (a JAX step restores
through ``checkpoint.from_jax.carry_jax_train_state``; the port then saves
its own steps beside the JAX ones and never replaces one). ``--num-views`` V above 1
trains joint multi-view attention over the V views of each sample (the
loader yields V views a sample).

Several processes, one per GPU (``distributed.initialize``): under torchrun
or SLURM, or with ``--coordinator``, ``--num-processes`` and
``--process-id``; ``--device cpu`` runs them on the CPU over gloo. The mesh
is ``--mesh-view`` processes on the view axis (ring attention over the V
views, ``parallel.for_view_sharding(cfg, V, mesh_view)``; V must divide
over them) times ``--mesh-data`` (default: the rest) on the data axis;
``--batch-size`` is per data index, as in the JAX CLI (the reference's
per-rank batch), so the global batch is ``batch_size * mesh_data``. Each
process loads its data index's rows. ``--num-slices`` k above 1 makes the
data axis span k slices (``mesh.make_mesh``: the ranks grouped by host,
contiguously where every rank reports one host), so the view axis's ring
stays inside a node; the data axis must divide by k.
``main(argv, **overrides)`` returns the ``Trainer`` after ``fit``;
``overrides`` are ``TrainConfig`` fields that no flag reaches (for example
``metrics_log_interval``), applied after the flags.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train the multi-view diffusion model (PyTorch/CUDA)")
    p.add_argument("--config", type=str, default=None, help="YAML config path (needs PyYAML)")
    p.add_argument("--dataset-path", type=str, default=None)
    p.add_argument("--dataset-format", type=str, default=None, choices=("objaverse", "co3d"),
                   help="corpus layout: rendered-zip shards or CO3D-style sequences")
    p.add_argument("--native-loader", action="store_true",
                   help="read the objaverse zips with the C++ reader (data/native_loader.py: float "
                        "composite, bilinear resize), built with the host's c++ on first use; "
                        "raises where it cannot build or read. The port's explicit form of the "
                        "JAX package's automatic choice, which takes its C++ reader whenever g++ "
                        "and libpng build it. Off: the PIL path's function (Lanczos), bitwise")
    p.add_argument("--resume", type=str, default=None,
                   help="run dir, its checkpoints/ dir, or one step dir to resume from (the port's "
                   "or the JAX package's)")
    p.add_argument("--output-dir", type=str, default="outputs")
    p.add_argument("--wandb", action="store_true", help="also log to W&B")
    p.add_argument("--wandb-id", type=str, default=None)
    p.add_argument("--run-name", type=str, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--image-size", type=int, default=None)
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--num-views", type=int, default=1,
                   help="views per sample; >1 trains joint multi-view attention over them")
    p.add_argument("--mesh-data", type=int, default=None,
                   help="data-parallel processes (default: all processes / --mesh-view)")
    p.add_argument("--mesh-view", type=int, default=1,
                   help="view-parallel processes (ring attention over the views)")
    p.add_argument("--num-slices", type=int, default=1,
                   help=">1 builds a multi-slice mesh: the data axis spans slices (nodes, the "
                        "ranks grouped by host), the view axis stays within a slice")
    p.add_argument("--coordinator", type=str, default=None,
                   help="host:port of rank 0 (or MVD_COORDINATOR; torchrun's MASTER_ADDR/PORT)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="process count (MVD_NUM_PROCESSES; torchrun's WORLD_SIZE)")
    p.add_argument("--process-id", type=int, default=None,
                   help="this process's rank (MVD_PROCESS_ID; torchrun's RANK)")
    p.add_argument("--latent-cache-dir", type=str, default=None,
                   help="latent-moment cache (cli/precompute_latents.py): train batches skip the "
                   "per-step VAE encode")
    p.add_argument("--use-ray-conditioning", action="store_true",
                   help="concatenate per-pixel Plücker ray maps to the UNet input")
    p.add_argument("--init-params", type=str, default=None,
                   help="a save_params dir (the port's or the JAX package's orbax one) whose components (vae / text_encoder / "
                   "mvd) replace the fresh init")
    p.add_argument("--tiny", action="store_true", help="tiny model (smoke test; CPU only)")
    p.add_argument("--debug-nans", action="store_true")
    p.add_argument("--device", type=str, default="cuda")
    return p


def _refuse_unported(args) -> None:
    if args.mesh_view > 1 and args.num_views % args.mesh_view:
        raise SystemExit(f"--mesh-view {args.mesh_view} shards the views of a sample: "
                         f"--num-views ({args.num_views}) must divide over it")


def _load_init_params(pipe, path: str) -> None:
    from ..checkpoint import load_params_into

    try:
        loaded = load_params_into(pipe, path)
    except ValueError as e:
        raise SystemExit(f"--init-params: {e}") from e
    logging.getLogger(__name__).info("initialized %s from %s", ", ".join(loaded), path)


def _check_cache_dtype(latent_cache_dir: str, dtype: str) -> None:
    """The cache must have been encoded at the model's compute dtype."""
    from ..data.latent_cache import read_meta

    meta = read_meta(latent_cache_dir) or {}
    cache_cd = meta.get("compute_dtype")
    if cache_cd and cache_cd != dtype:
        raise SystemExit(
            f"latent cache at {latent_cache_dir!r} was encoded at compute_dtype={cache_cd} but "
            f"the model config computes in {dtype}; rebuild the cache "
            f"(precompute_latents --compute-dtype {dtype}) or change the model dtype")
    if meta and not cache_cd:
        logging.getLogger(__name__).warning(
            "latent cache at %s predates compute_dtype tracking; cannot verify that its "
            "encoder numerics match model dtype %s", latent_cache_dir, dtype)


def main(argv=None, **overrides):
    args = build_argparser().parse_args(argv)
    _refuse_unported(args)

    import torch.distributed as dist

    from .. import distributed

    cpu = args.device == "cpu"
    started = not dist.is_initialized() and distributed.initialize(
        args.coordinator, args.num_processes, args.process_id,
        backend="gloo" if cpu else "nccl", device=args.device)
    try:
        return _main(args, overrides)
    finally:
        if started:
            distributed.shutdown()


def _main(args, overrides):
    import torch

    from .. import distributed
    from ..checkpoint import peek_checkpoint_meta
    from ..config import TINY_MODEL, DataConfig, TrainConfig, data_config_from_yaml, train_config_from_yaml
    from ..data.objaverse import ObjaverseDataModule
    from ..mesh import make_mesh
    from ..parallel import for_view_sharding
    from ..pipeline import MVDPipeline
    from ..pipeline.pipeline import resolve_device
    from ..train.loop import Trainer
    from ..utils.logging import MetricLogger, enable_nan_debugging

    device = resolve_device(args.device)
    world = distributed.process_count()
    mesh_view = args.mesh_view
    mesh_data = args.mesh_data or max(1, world // mesh_view)
    if mesh_data * mesh_view > world:
        raise SystemExit(f"a mesh of {mesh_data} x {mesh_view} processes needs as many, have "
                         f"{world}: launch under torchrun or SLURM, or pass --coordinator, "
                         "--num-processes and --process-id")
    mesh = None
    # a process group, even of one under torchrun; several slices need one
    if torch.distributed.is_initialized() or args.num_slices > 1:
        mesh = make_mesh(data=mesh_data, view=mesh_view, num_slices=args.num_slices)
        if device.type == "cuda":
            device = distributed.device()
    if args.tiny and device.type != "cpu":
        raise ValueError("--tiny runs on the CPU only (f32, 16-wide heads; the GPU kernels take "
                         "bf16 and 64-wide heads): add --device cpu")
    if args.debug_nans:
        enable_nan_debugging()

    cfg = train_config_from_yaml(args.config) if args.config else TrainConfig()
    if args.tiny:
        cfg = dataclasses.replace(cfg, model=TINY_MODEL, image_size=TINY_MODEL.unet.sample_size * 8)
    if args.batch_size:
        cfg = dataclasses.replace(cfg, batch_size=args.batch_size)
    if args.image_size:
        cfg = dataclasses.replace(cfg, image_size=args.image_size)
    if args.max_steps:
        cfg = dataclasses.replace(cfg, max_steps=args.max_steps)
    cfg = dataclasses.replace(cfg, num_views=args.num_views, **overrides)
    model_cfg = cfg.model
    if args.num_views > 1:
        model_cfg = for_view_sharding(model_cfg, args.num_views, mesh_view)
    if args.use_ray_conditioning:
        model_cfg = dataclasses.replace(model_cfg, use_ray_conditioning=True)
    # the latent size follows the training resolution
    model_cfg = dataclasses.replace(
        model_cfg, unet=dataclasses.replace(model_cfg.unet, sample_size=cfg.image_size // 8))
    cfg = dataclasses.replace(cfg, model=model_cfg)

    dataset_path = args.dataset_path or os.environ.get("MVD_DATASET_PATH", "")
    data_cfg = data_config_from_yaml(args.config) if args.config else DataConfig()
    latent_cache_dir = args.latent_cache_dir or data_cfg.latent_cache_dir
    if latent_cache_dir:
        _check_cache_dtype(latent_cache_dir, cfg.model.dtype)

    pipe = MVDPipeline.create(model_cfg, seed=cfg.seed, device=device)
    if args.init_params:
        _load_init_params(pipe, args.init_params)
    # batch_size is per data index (the reference's per-rank batch); each
    # process loads its data index's rows of the global batch
    dm = ObjaverseDataModule(
        dataset_path, pipe.tokenizer, image_size=cfg.image_size,
        batch_size=cfg.batch_size * mesh_data,
        max_views_per_object=data_cfg.max_views_per_object,
        dataset_samples=data_cfg.dataset_samples, num_workers=data_cfg.num_workers,
        views_per_sample=max(1, args.num_views), seed=cfg.seed,
        dataset_format=args.dataset_format or data_cfg.dataset_format,
        latent_cache_dir=latent_cache_dir,
        process_count=mesh_data, process_index=mesh.axis("data").index if mesh is not None else 0,
        use_native=args.native_loader,
    )
    dm.setup()

    # the W&B run id rides in the checkpoint meta, so a resumed run
    # continues the same W&B run
    wandb_id = args.wandb_id
    if args.resume and not wandb_id:
        wandb_id = peek_checkpoint_meta(args.resume).get("wandb_run_id")
    metric_logger = MetricLogger(os.path.join(args.output_dir, "logs"), run_name=args.run_name,
                                 run_id=wandb_id, config={"config": str(cfg)},
                                 use_wandb=args.wandb, enabled=distributed.is_primary())
    trainer = Trainer(cfg, pipe, dm, mesh=mesh, view_sharded=mesh_view > 1,
                      output_dir=args.output_dir, logger=metric_logger, resume_from=args.resume)
    trainer.fit(resume=bool(args.resume))
    return trainer


if __name__ == "__main__":
    main()
