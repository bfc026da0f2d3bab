"""Inference CLI of the port: random-init weights from ``--seed``, fixed
look-at source/target cameras, N generations, and source / generated /
side-by-side PNGs in ``--output-dir``.

Same flags as ``mvd_tpu/cli/infer.py`` except ``--checkpoint``,
``--invert-init``, ``--encoder-reuse``, ``--sampler`` and
``--use-ray-conditioning``, which are not ported yet; ``--device`` picks the
device (the GPU by default; without one the CLI raises). ``--tiny`` runs on
the CPU only: its f32, 16-wide attention heads are not what the GPU kernels
take (bf16, 64 wide).

    python -m mvd_tpu_torch.cli.infer --image-size 512 --num-images 2
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Multi-view inference (PyTorch/CUDA)")
    p.add_argument("--image-path", type=str, default=None)
    p.add_argument("--prompt", type=str, default="")
    p.add_argument("--output-dir", type=str, default="outputs/inference")
    p.add_argument("--num-images", type=int, default=8)
    p.add_argument("--num-steps", type=int, default=20)
    p.add_argument("--guidance-scale", type=float, default=1.0)
    p.add_argument("--ref-scale", type=float, default=1.0)
    p.add_argument("--image-size", type=int, default=768)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--reference-rescale-quirk", action="store_true")
    p.add_argument("--device", type=str, default="cuda")
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)

    from ..camera import look_at_camera, to_homogeneous
    from ..config import TINY_MODEL, ModelConfig
    from ..pipeline import MVDPipeline
    from ..pipeline.pipeline import resolve_device
    from ..utils import load_image, save_image, side_by_side

    if args.tiny and resolve_device(args.device).type != "cpu":
        raise ValueError(
            "--tiny runs on the CPU only (f32, 16-wide heads; the GPU kernels take "
            "bf16 and 64-wide heads): add --device cpu"
        )
    cfg = TINY_MODEL if args.tiny else ModelConfig()
    if not args.tiny:
        cfg = dataclasses.replace(
            cfg, unet=dataclasses.replace(cfg.unet, sample_size=args.image_size // 8)
        )
    pipe = MVDPipeline.create(cfg, seed=args.seed, device=args.device)

    size = args.image_size if not args.tiny else cfg.unet.sample_size * 8
    if args.image_path:
        src_img = load_image(args.image_path, size)[None]  # [-1,1]
    else:
        src_img = np.zeros((1, size, size, 3), np.float32)

    source_cam = to_homogeneous(look_at_camera([2.0, 0.0, 0.5]))
    target_cam = to_homogeneous(look_at_camera([0.0, 2.0, 0.5]))

    os.makedirs(args.output_dir, exist_ok=True)
    save_image(src_img[0], os.path.join(args.output_dir, "source.png"))
    for i in range(args.num_images):
        out = pipe(
            args.prompt,
            num_inference_steps=args.num_steps,
            guidance_scale=args.guidance_scale,
            height=size,
            width=size,
            source_camera=source_cam,
            target_camera=target_cam,
            source_images=(src_img + 1) / 2,
            ref_scale=args.ref_scale,
            seed=args.seed + i,
        )
        img = out["images"][0]
        if args.reference_rescale_quirk:
            img = (img + 1) / 2  # the reference's double rescale
        save_image(img, os.path.join(args.output_dir, f"generated_{i:02d}.png"))
        sheet = side_by_side([(src_img[0] + 1) / 2, img])
        save_image(sheet, os.path.join(args.output_dir, f"comparison_{i:02d}.png"))
    print(f"wrote {args.num_images} generations to {args.output_dir}")


if __name__ == "__main__":
    main()
