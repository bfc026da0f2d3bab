"""Inference CLI of the port: weights from a reference Lightning
``--checkpoint`` (else random from ``--seed``), fixed look-at source/target
cameras, N generations, and source / generated / side-by-side PNGs in
``--output-dir``.

Same flags as ``mvd_tpu/cli/infer.py``; ``--device`` picks the device (the
GPU by default; without one the CLI raises). ``--checkpoint`` takes the
JAX CLI's two forms: a reference Lightning ``.ckpt``, or a directory written
by ``save_params``: the port's, loaded component by component, or the JAX
package's orbax directory of the whole pipeline tree, loaded 1:1 (anything
else raises, naming the forms). ``--tiny`` runs on the
CPU only: its f32, 16-wide attention heads are not what the GPU kernels take
(bf16, 64 wide).

    python -m mvd_tpu_torch.cli.infer --image-size 512 --num-images 2
    python -m mvd_tpu_torch.cli.infer --checkpoint last.ckpt --sampler dpmpp_2m --num-steps 10
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
    p.add_argument("--checkpoint", type=str, default=None,
                   help="a reference Lightning .ckpt (the multi-view UNet and camera encoder) "
                   "or a save_params directory (the port's, or the JAX package's orbax one)")
    p.add_argument("--encoder-reuse", type=int, default=1,
                   help="k > 1: run the UNet's down path at one of every k steps and reuse its "
                   "state at the others (approximate; arXiv 2312.09608)")
    p.add_argument("--sampler", type=str, default=None, choices=["ddpm", "ddim", "dpmpp_2m"],
                   help="override the config's sampler (dpmpp_2m: second-order DPM-Solver++, "
                   "about 10 steps where DDIM needs 20-50)")
    p.add_argument("--use-ray-conditioning", action="store_true",
                   help="sample a model conditioned on Plücker ray maps (6 more conv_in channels, "
                   "zero-padded when the checkpoint was trained without them)")
    p.add_argument("--invert-init", action="store_true",
                   help="start from the DDIM inversion of the source image under the source "
                   "camera instead of noise (arXiv 2508.10688)")
    return p


def main(argv=None):
    """Run the CLI; returns the pipeline it sampled."""
    args = build_argparser().parse_args(argv)

    from ..camera import look_at_camera, to_homogeneous
    from ..checkpoint import load_checkpoint
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
    if args.use_ray_conditioning:
        cfg = dataclasses.replace(cfg, use_ray_conditioning=True)
    pipe = MVDPipeline.create(cfg, seed=args.seed, device=args.device)
    if args.checkpoint:
        load_checkpoint(pipe, args.checkpoint)

    size = args.image_size if not args.tiny else cfg.unet.sample_size * 8
    if args.image_path:
        src_img = load_image(args.image_path, size)[None]  # [-1,1]
    else:
        src_img = np.zeros((1, size, size, 3), np.float32)

    source_cam = to_homogeneous(look_at_camera([2.0, 0.0, 0.5]))
    target_cam = to_homogeneous(look_at_camera([0.0, 2.0, 0.5]))

    os.makedirs(args.output_dir, exist_ok=True)
    save_image(src_img[0], os.path.join(args.output_dir, "source.png"))

    init_latents = None
    if args.invert_init:
        # the image is the source view: invert it under the source camera
        init_latents = pipe.invert(
            (src_img + 1) / 2, args.prompt, num_inference_steps=args.num_steps,
            source_camera=source_cam, target_camera=source_cam,
            source_images=(src_img + 1) / 2, ref_scale=args.ref_scale,
        )["latents"]
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
            encoder_reuse=args.encoder_reuse,
            sampler=args.sampler,
            latents=init_latents,
        )
        img = out["images"][0]
        if args.reference_rescale_quirk:
            img = (img + 1) / 2  # the reference's double rescale
        save_image(img, os.path.join(args.output_dir, f"generated_{i:02d}.png"))
        sheet = side_by_side([(src_img[0] + 1) / 2, img])
        save_image(sheet, os.path.join(args.output_dir, f"comparison_{i:02d}.png"))
    print(f"wrote {args.num_images} generations to {args.output_dir}")
    return pipe


if __name__ == "__main__":
    main()
