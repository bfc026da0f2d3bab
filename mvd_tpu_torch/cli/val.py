"""Validation CLI of the port: generation over the test split with the
metric sweep of ``metrics/harness.py:run_validation`` and its two CSVs.

    python -m mvd_tpu_torch.cli.val --checkpoint outputs/<run> --dataset-path D \\
        --vgg-weights vgg16.pth --lpips-weights lpips_alex.pth \\
        --clip-vision-weights clip_vision.bin --inception-weights pt_inception.pth
    python -m mvd_tpu_torch.cli.val --tiny --device cpu --dataset-path D --num-samples 2

The flags of ``mvd_tpu/cli/val.py``, plus ``--device`` (the GPU by default;
without one the CLI raises; ``--tiny`` runs on the CPU only, as in
``cli/infer.py``). ``--checkpoint`` takes a reference Lightning ``.ckpt``,
a Trainer run dir of the port or of the JAX package (its ``checkpoints/``
dir or one step dir; the latest step is restored into the multi-view UNet
and printed), or a directory written by ``save_params`` (the port's, or the
JAX package's orbax one of the whole pipeline tree); anything else raises,
naming those forms. ``--vae-params`` reads the ``vae`` component of a
``save_params`` directory of either package. ``--config`` builds the model
from the YAML (needs PyYAML). A weight file that cannot be loaded raises,
and so does ``--fid`` without ``--vgg-weights`` or ``--inception-weights``.
``main(argv)`` returns (the pipeline, the overall metrics).
"""

from __future__ import annotations

import argparse
import dataclasses
import os


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Validation metric sweep (PyTorch/CUDA)")
    p.add_argument("--config", type=str, default=None,
                   help="training YAML; the model is built with its arch/scheduler/conditioning "
                   "settings (the SD2.1 shape when omitted)")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="Lightning .ckpt, a save_params dir (the port's or the JAX package's orbax "
                   "one), or a Trainer run dir of either package (checkpoints/ restored at the "
                   "latest step)")
    p.add_argument("--vae-params", type=str, default=None,
                   help="save_params dir (the port's or the JAX package's orbax one) holding a "
                   "pretrained 'vae' component")
    p.add_argument("--dataset-path", type=str, default=None)
    p.add_argument("--output-dir", type=str, default="outputs/validation")
    p.add_argument("--num-samples", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--num-steps", type=int, default=20)
    p.add_argument("--guidance-scale", type=float, default=1.0)
    p.add_argument("--ref-scale", type=float, default=0.1)
    p.add_argument("--image-size", type=int, default=768)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--vgg-weights", default=None, help="torchvision vgg16 .pth")
    p.add_argument("--lpips-weights", default=None, help="lpips package .pth")
    p.add_argument("--clip-vision-weights", default=None,
                   help="transformers CLIPVisionModelWithProjection .bin/.pth")
    p.add_argument("--inception-weights", default=None,
                   help="pytorch-fid InceptionV3 .pth (standard FID)")
    p.add_argument("--fid", action="store_true", help="FID-VGG (needs --vgg-weights)")
    p.add_argument("--sampler", type=str, default=None, choices=["ddpm", "ddim", "dpmpp_2m"],
                   help="override the config sampler")
    p.add_argument("--encoder-reuse", type=int, default=1,
                   help="k>1: approximate encoder-propagation fast sampling")
    return p


def _is_run_dir(path: str) -> bool:
    """A Trainer run dir, its checkpoints dir or one step dir (a flat
    save_params dir holds no step dirs)."""
    if not os.path.isdir(path):
        return False
    base = os.path.basename(os.path.abspath(path).rstrip(os.sep))
    if os.path.isdir(os.path.join(path, "checkpoints")):
        return True
    return base == "checkpoints" or base.isdigit() or any(
        e.isdigit() and os.path.isdir(os.path.join(path, e))
        for e in os.listdir(path)
    )


def _restore_run_dir(train_cfg, pipe, path: str) -> int:
    """Restore the trained multi-view UNet from a Trainer run dir at its
    latest step (or the step dir given): the model is frozen and cast as
    the Trainer's ``TrainState.create`` left it, then loaded bitwise.
    Returns the step."""
    from ..checkpoint import CheckpointManager, resolve_resume_path
    from ..config import TrainConfig
    from ..train.state import TrainState

    cfg = dataclasses.replace(train_cfg or TrainConfig(), model=pipe.config)
    ckpt_dir, step = resolve_resume_path(path)
    template = TrainState.create(pipe.model, cfg, total_steps=max(1, cfg.max_steps or 1000))
    state, _ = CheckpointManager(ckpt_dir).restore(template, step)
    if state is None:
        raise SystemExit(f"no checkpoint found under {path}")
    pipe.drop_compute_model()
    return int(state.step)


def _load_vae_params(pipe, path: str) -> None:
    from ..checkpoint import load_component

    try:
        load_component(pipe.model["vae"], path, "vae")
    except ValueError as e:
        raise ValueError(f"--vae-params {e}") from None
    pipe.drop_compute_model()


def main(argv=None):
    args = build_argparser().parse_args(argv)

    from ..checkpoint import load_checkpoint
    from ..config import TINY_MODEL, ModelConfig
    from ..data.objaverse import ObjaverseDataModule
    from ..metrics.harness import run_validation
    from ..metrics.load_towers import load_towers
    from ..pipeline import MVDPipeline
    from ..pipeline.pipeline import resolve_device

    device = resolve_device(args.device)
    if args.tiny and device.type != "cpu":
        raise ValueError("--tiny runs on the CPU only (f32, 16-wide heads; the GPU kernels take "
                         "bf16 and 64-wide heads): add --device cpu")
    train_cfg = None
    if args.config:
        from ..config import train_config_from_yaml

        train_cfg = train_config_from_yaml(args.config)
        cfg = train_cfg.model
        size = args.image_size if args.image_size != 768 else train_cfg.image_size
    elif args.tiny:
        cfg = TINY_MODEL
        size = cfg.unet.sample_size * 8
    else:
        cfg = ModelConfig()
        size = args.image_size
    if not args.tiny:
        unet = dataclasses.replace(cfg.unet, sample_size=size // 8, remat=False)
        cfg = dataclasses.replace(cfg, unet=unet)

    pipe = MVDPipeline.create(cfg, seed=0, device=device)
    if args.vae_params:
        _load_vae_params(pipe, args.vae_params)
    if args.checkpoint:
        if not args.checkpoint.endswith(".ckpt") and _is_run_dir(args.checkpoint):
            step = _restore_run_dir(train_cfg, pipe, args.checkpoint)
            print(f"restored run checkpoint at step {step}")
        else:  # a Lightning .ckpt or a save_params dir; anything else raises
            load_checkpoint(pipe, args.checkpoint)

    # the towers load before any generation: a bad weight file fails fast
    towers = load_towers(
        vgg_weights=args.vgg_weights,
        lpips_weights=args.lpips_weights,
        clip_vision_weights=args.clip_vision_weights,
        inception_weights=args.inception_weights,
        with_fid=args.fid,
    )
    dataset_path = args.dataset_path or os.environ.get("MVD_DATASET_PATH", "")
    dm = ObjaverseDataModule(dataset_path, pipe.tokenizer, image_size=size,
                             batch_size=args.batch_size, dataset_samples=args.num_samples)
    max_batches = None if args.num_samples is None else max(1, args.num_samples // args.batch_size)
    overall = run_validation(
        pipe,
        dm.loader("test"),
        args.output_dir,
        num_inference_steps=args.num_steps,
        guidance_scale=args.guidance_scale,
        ref_scale=args.ref_scale,
        max_batches=max_batches,
        towers=towers,
        sampler=args.sampler,
        encoder_reuse=args.encoder_reuse,
    )
    for k, v in overall.items():
        print(f"{k}: {v}")
    return pipe, overall


if __name__ == "__main__":
    main()
