#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``mvd_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Thirteen phases; any failure exits non-zero:

1. build: compiles every kernel source under ``mvd_tpu_torch/csrc/`` (one
   ``nvcc`` each, in parallel; the host C++ readers with ``c++`` beside
   them) and prints the seconds and ptxas's report;
2. kernels: holds each kernel against its plain PyTorch version on the card,
   in bf16, at the main path's shapes, and times the kernel, the plain
   version and one PyTorch library call computing the same function (a
   yardstick the port never calls), beside the least time the card could
   take (bytes over 3.35 TB/s or operations over 989 TFLOP/s bf16 tensor /
   1,979 TOP/s int8 tensor / 67 TFLOP/s f32, whichever is larger; for K6
   also its exponentials at 16 a clock per SM). K6 (int8) is held to its
   plain core on the operands its quantizer K6q writes, and with K6q to the
   plain version and to exact attention (>= 30 dB); K6q to the plain
   quantizers; both timed by CUDA-graph replay beside the eager quantizers
   and K1 at the same shape; through the differentiable custom operator
   ``flash_fwd_op``, forward and straight-through backward at the 768²
   train shape; K5 ((B, H, S, D)) forward and backward. K2 runs at the
   GroupNorm shapes of generation and of the train step, on both of its
   paths, timed through the wrapper and through its C entry alone (device
   time by CUDA-graph replay), and is checked for bitwise repeatability and
   for batch 0 unchanged by NaN in batch 1;
3. main path: ``MVDPipeline.create`` at full SD2.1 width with random weights
   from seed 0, then 4-view 512² generation, 20-step DDPM, guidance 1.0, a
   zero source image and ``orbit_cameras(4)``, in bf16. Checks the images,
   that every kernel launched exactly as often as the model structure says,
   that no plain version ran and that the denoise loop never waited for
   the device (``torch.cuda.set_sync_debug_mode("error")``); prints K2's
   summed bytes bound over every GroupNorm call; then times a second call;
3b. int8: the same pipeline and weights with ``attention_impl="int8"``:
   the same checks, K6 at exactly the sites the JAX package quantizes on a
   TPU (610 launches, K6q before each, K1 at the other 702), the PSNR of
   its images against
   phase 3's from the same weights and noise, and later calls of the two
   pipelines timed in turns;
3c. entry points, on phase 3's pipeline and weights: phase 3's UNet and
   camera encoder exported under the reference's Lightning names to a
   ``.ckpt``, loaded by ``checkpoint.load_checkpoint`` into a fresh pipeline
   (every parameter and the images bitwise phase 3's), and sampled by
   ``python -m mvd_tpu_torch.cli.infer --checkpoint`` (DPM-Solver++ at 10
   steps); DPM-Solver++(2M) at 10 steps, DDIM inversion of phase 3's images
   then DDIM at 20, and DDPM at 20 with ``encoder_reuse=2``, each with its
   launches held to the structure (a cached step runs the mid block and the
   up path only), no plain call and its loops under the sync check, then
   two later calls of each timed in turns with phase 3's DDPM; the
   ray-conditioned pipeline (conv_in zero-padded by
   ``zero_pad_conv_in``) with its PSNR against phase 3's images; and the
   HTTP server of ``cli/serve.py`` on 127.0.0.1, which must answer
   ``/healthz`` and five ``/generate`` requests (one with a PNG source
   image, two at once, one with a JPEG source image at 20 DDPM steps whose
   decode in the server must be PIL's pixels by sha256 and whose launches
   must be phase 3's) with 200 and PNGs that decode to 512x512x3;
4. train: holds K3a/K3b against the plain backward at every attention shape
   of the 768² train step (timed beside the backward of
   ``scaled_dot_product_attention``, a yardstick the port never calls, and
   their bounds), at every tile-edge (Sq, Sk) in both layouts, for batch
   independence under NaN and for bitwise repeatability, then
   builds the adapter + camera-encoder train step at full SD2.1 width from
   seed 0 (bf16 compute, f32 masters, batch 6, one view, Min-SNR
   v-prediction, AdamW) and takes 3 steps on a seeded random pixel batch
   with remat on (the config's default) and 3 with it off from the same
   state, then one more step of each traced (``phase_train``).
   Checks for each a finite loss and gradients, trainable parameters
   unchanged by step 1 (lr 0) and moved by step 2, the launches of every
   kernel in each step against the model structure, and no plain call;
   then frozen parameters bitwise unchanged, step 1's loss bitwise equal
   with and without remat and K1/K3a/K3b per step equal; prints s/step
   and samples/s (the median of 4 steps of each setting taken in turns),
   the peak memory, the traced step's device ms and idle share and what
   remat costs a step, split into device and host time;
5. the train entry point: a seeded synthetic corpus (16 objects x 4 views
   of smooth 512² RGBA PNGs with real alpha, ``orbit_cameras`` ``.npy``
   cameras, ``prompt.txt``) in a temporary directory, then (a)
   ``mvd_tpu_torch.cli.train.main`` in this process at phase 4's training
   point (``--config config/train_config.yaml``) for 3 steps (``metrics_log_interval`` 2): finite
   ``train/noise_loss`` at steps 1-3 with ``train/lr`` the schedule's, the
   reconstruction metrics at step 2 and the end-of-run validation finite
   (SSIM in [-1, 1]), the comparison PNGs decoding to 768 x 2312 x 3, K3a
   and K3b exactly 64 and 48 per step, no plain call, every frozen
   parameter bitwise unchanged, the final checkpoint on disk; (b)
   ``--resume`` to step 5: the restored parameters and AdamW state bitwise
   the saved ones before the first step, exactly 2 steps, the checkpoints
   kept the latest plus the top k; (c) ``cli.precompute_latents`` at 768²
   in bf16, then 2 steps from the cache, each with the structure's
   launches less the VAE encoder's GroupNorms. Prints the host ms per
   decoded view, s/step and loader wait per step, samples/s, validation,
   checkpoint bytes and save/restore seconds, peak memory and the phase's
   seconds;
6. joint multi-view attention (``UNetConfig.num_views``): (a) K1 at the
   joint self lengths (``JOINT_ATTN_CASES``: one 4-view 512² group of
   16,384 tokens; batch 6 of 2-view 768² groups, 18,432 tokens) held to its
   plain version on row 0, K3a/K3b at the 2-view length held to the plain
   backward head by head on row 0, each timed beside SDPA and its bound;
   (b) after phase 3c, on phase 3's weights, the main path's call with
   joint attention over its 4 views: exactly the pairwise launches (K1
   1312, K2 1333), no plain call, the loop under the sync check, images
   that differ from phase 3's (PSNR printed), later calls timed in turns
   with phase 3's and one of each traced for device ms; (c) one joint call
   with ``attention_impl="int8"``, K6 at the sites the JAX package's
   routing gives at the merged lengths; (d) the joint train step at the
   reference point (batch 6 of 2 views, 12 UNet rows, 768²): phase 4 with
   two views, the same checks and prints; (e) ``cli.train.main
   --num-views 2`` on phase 5's corpus, 2 steps and one validation;
7. the multi-device path on one card: (a) K4m (``csrc/ring_merge.cu``)
   against ``ring_merge_plain`` at a rank's shape of each ``RING_CASES``
   case (f32, within ``MERGE_ULPS`` ulp, bitwise repeatable, batch 0
   unchanged by NaN in batch 1), timed beside its bytes bound; then ring
   attention (K4) as n virtual ranks in one process (``RING_CASES``: 4
   ranks of S 4096 at B 1, the 4-view 512² joint length; 2 ranks of S 9216
   at B 6, the 2-view 768² train length), forward and backward, with
   exactly K1 n², K4m n(n - 1), K3a and K3b n² launches each and no plain
   call, held on every row to the unsharded K1 and K3a/K3b at the whole
   length and timed in turns with them beside SDPA; (b) NCCL at world size
   1: ``distributed.initialize`` from torchrun's variables, ``make_mesh``,
   and phase 4's train step through the data-parallel branch, one
   all-reduce a step, bitwise equal to the step without a mesh; (c) run
   right after 6c, on phase 3's pipeline and weights: the ``model`` axis
   as n virtual ranks in one process (``tensor_parallel.py``): K1 at the
   shard's heads (H 10 at n = 2, H 5 at n = 4) at the sites the axis cuts
   (B 4, S 256 and 64, self / adapter and Sk 77) held to its plain version
   and timed beside SDPA and the unsharded H 20; then phase 3's call with
   the networks cut by ``shard_params_model_parallel`` at n = 2 and 4: K1
   and K2 exactly the sharded structure's launches, no plain call, the
   loop under the sync check, the 16² Transformer2D within relative RMS
   1e-2 of the unsharded bf16 block, one denoise step within max(1e-2,
   1.25 x the bf16 floor measured in the run) of the unsharded bf16 step,
   the images' PSNR against phase 3's, one traced call's device ms and the
   parameter bytes per rank.
8. the validation CLI, after phase 6e on phase 5's corpus (objects added
   until its test split holds two whole batches) and run dir:
   ``mvd_tpu_torch.cli.val.main`` in this process with the YAML phase 5
   trained with, ``--checkpoint`` phase 5's run dir, 8 samples in batches of
   4 at 768², 20 DDPM steps, and random full-width weight files of the four
   metric towers in their public layouts (torchvision VGG16, lpips-alex,
   transformers CLIP ViT-L/14, pytorch-fid InceptionV3). Checks the
   restored step (phase 5's latest) and the multi-view UNet bitwise that
   checkpoint's, K1 and K2 exactly ``expected_launches(pipe, 20)`` per
   batch with no plain call and no launch inside a tower, both CSVs with
   the JAX harness's columns and order, finite values and SSIM, LPIPS and
   CLIP in range, and each tower on two pairs of the last batch on the card
   against the CPU (relative 1e-4; FID printed from both). Prints the
   second batch's seconds and img/s, each tower's device ms per batch,
   the peak memory and the phase's seconds.
9. the image readers (host C++ built from the checkout with the host's
   ``c++`` in phase 1), after phase 8: (a) every fixture of
   ``tests/fixtures/torch_port_jpeg`` and ``tests/fixtures/torch_port_images``
   (sequential, progressive, block-smoothed, arithmetic-coded, lossless,
   CMYK and YCCK JPEG; PNG of every colour type and depth, Adam7 or not;
   lossless, lossy, lossy-with-alpha and animated WebP; GIF, BMP/DIB and
   TIFF of every form ``make_formats.py`` writes; PPM/PGM/PBM/PFM, TGA,
   ICO/CUR, QOI, PCX, SGI, PSD and DDS of every form
   ``make_small_formats.py`` writes) decoded to PIL's pixels
   (sha256; the white composite too where PIL opens it as RGBA; a WebP in
   PIL's mode; each file PIL refuses refused, each form PIL reads and the
   port does not named ROADMAP item 13c); (b)
   ``cli.train.main --dataset-format co3d`` on a CO3D-layout corpus of
   1067x800 JPEG frames (``frame_annotations.jgz``; 9 sequences, so no val
   split) at phase 5's point for 3 steps: K1, K2, K3a and K3b exactly the
   train step's launches per step, no plain call, finite losses; (c) the
   native reader held to ``load_view_plain`` on 4 views, ``cli.train.main
   --native-loader`` on phase 5's corpus for 2 steps; (d) right after
   phase 7c, on phase 3's pipeline: phase 3's call from CO3D's 1067x800
   frame through ``load_image`` as a progressive, a block-smoothed
   progressive, an arithmetic-coded and a lossless JPEG (the last two
   written on the host by the fixture script's ``frame_forms``), a lossy
   WebP, a GIF (its palette quantized in numpy), a 24-bit BMP, a TIFF with
   LZW and predictor 2 in strips, a tiled deflate TIFF and a 16-bit TIFF
   (written on the host by ``make_formats.py``'s ``frame_formats``), a TGA
   RLE, a PSD with PackBits and a DDS of BC7 blocks (written on the host by
   ``make_small_formats.py``'s ``frame_small_forms``, which also writes the
   frame as PPM, PFM, QOI, PCX, SGI RLE and DDS BC1, each only decoded to
   PIL's digest), and
   from a 512² procedural render as lossless RGBA WebP, lossy WebP with
   alpha and an RLE8 BMP (each decode PIL's pixels by digest, its Huffman
   twin's, or the pixels it was written from), and from each one's pixels
   as PNG, sources and images bitwise equal, K1 1312 and K2 1333 each with
   no plain call, then a server request with each of the progressive JPEG,
   the arithmetic-coded JPEG, the lossy WebP, the LZW TIFF, the GIF and
   the TGA base64-encoded (the server's decode those pixels, phase 3's
   launches); (e)
   ``cli.train.main`` for 2 steps at phase 5's point on 9
   objects of 16-bit Adam7 RGBA PNG renders: the train step's launches per
   step, no plain call, finite losses, and its first batch bitwise that
   of an 8-bit corpus of the same high bytes; then the host ms to decode a
   1067x800 frame as progressive, baseline, block-smoothed, arithmetic-coded
   and lossless JPEG, 16-bit PNG, Adam7 PNG, lossy WebP, GIF, BMP and LZW,
   deflate and 16-bit TIFF, PPM, PFM, TGA, QOI, PCX, SGI, PSD and DDS BC1
   and BC7, and the 512² render as lossless and
   lossy-with-alpha WebP and RLE8 BMP, the host ms per 768² view
   of the PIL path, the native
   reader and a JPEG frame, and the loader's seconds a batch of 6 with
   each reader, in turns, against the step, beside the card's name and
   power limit.
10. the JAX package's orbax checkpoints read on the host by the port's own
   OCDBT, zarr and zstd readers (the zstd decoder built with the host's
   ``c++`` in phase 1), after phase 9: (a) every fixture of
   ``tests/fixtures/torch_port_orbax`` (a JAX ``save_params`` and a JAX
   Trainer step) read to the digests the JAX package's arrays gave; (b)
   phase 3's pipeline parameters, exported before phase 4 and written in the
   JAX package's orbax layout by ``tests/_torch_port_orbax_writer.py``,
   loaded by ``load_checkpoint`` into a fresh pipeline of NaNs: every
   parameter and the images of phase 3's call bitwise phase 3's, K1 1312
   and K2 1333, no plain call, then ``cli.infer.main --checkpoint DIR``;
   (c) phase 5's latest Trainer state written as a JAX Trainer step into a
   fresh run dir and ``cli.train.main --resume`` on it for 2 steps at phase
   5's point: the restored step, parameters and AdamW moments bitwise
   phase 5's, the train step's launches per step, no plain call, finite
   losses, the JAX step's files unchanged. Prints the checkpoints' bytes
   and each read's seconds and GB/s beside the card's name and power limit.
11. the evidence chain's first stages (``mvd_tpu_torch/tools/``), after
   phase 10: (a) ``tools.procedural`` writes 20 objects x 8 views at 256²
   (seed 0) on the host, object 0 in this process (host ms a view), the
   rest in 8 spawned processes; objects 0 and 1 held to the JAX tool's zips in
   ``tests/fixtures/torch_port_evidence`` (members, prompt and metadata
   equal, cameras within 1e-6, RGBA pixels counted where they differ: at
   most 1 level off on at most 1e-4 of them); every split loads through
   ``ObjaverseDataset``; (b) ``tools.pretrain_vae.main`` without
   ``--config`` (SD2.1's VAE, (128, 256, 512, 512)) at 256², batch 16, 8
   steps, validation at 4 and 8: K2 exactly once per GroupNorm (52 a step
   and a validation forward, 22 a probe encode) and nothing else, no plain
   call, the non-logging steps under ``torch.cuda.set_sync_debug_mode
   ("error")``, finite losses, the saved directory bitwise in a VAE of
   NaNs, K2 against its plain version at every GroupNorm shape of the
   step; prints ms a step, peak memory, the host ms to make a batch and
   the GroupNorm backward's f32 recompute at the largest shape; (c) the
   chain at ``config/evidence_256.yaml``: the tool for 4 steps,
   ``cli.precompute_latents --checkpoint``, ``cli.train.main
   --init-params --latent-cache-dir`` for 2 steps (the VAE bitwise the
   tool's output, K1/K2/K3a/K3b a step as the structure says, no plain
   call, finite losses) and ``cli.val.main --checkpoint <run> --vae-params``
   on 2 test samples.

With ``--trace OUT.json`` it also traces one more generation, one more int8
generation, one call of each sampler configuration of phase 3c and one
more step of phase 5's Trainer (its pinned batch copy,
the step, the metric fetch and the log line) with ``torch.profiler`` and
prints, and writes to OUT.json (the int8 generation under
``"int8_generation"``, phase 3c's under ``"entry_points"``, phase 4's
traced step with remat under ``"train_step"``, the Trainer's under
``"train_entry"``, phase 11b's last step under ``"vae_pretrain_step"``),
the wall time, the summed device-kernel time, the device's idle share, the
share of each port kernel and the kernels that take the most device time
(for phase 11b also the device time under the GroupNorm backward).

Prints the card's name and power limit, a ``{"kernels": [...]}`` line and,
last, ``{"ok": true, "device": {...}}``. Without a GPU, or outside the
repository, it exits non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import hashlib
import importlib.util
import json
import math
import os
import re
import shutil
import statistics
import sys
import tempfile
import time
import zipfile

STEPS, VIEWS, RES = 20, 4, 512
TRAIN_BATCH, TRAIN_RES, TRAIN_STEPS, TRAIN_TOTAL = 6, 768, 3, 100
REMAT_TURNS = 4


def phase_build() -> float:
    from mvd_tpu_torch.kernels import HOST_SOURCES, KERNEL_SOURCES, _build

    secs = _build.build_all(KERNEL_SOURCES, HOST_SOURCES)
    print(f"[build] host C++ {list(HOST_SOURCES)} with c++ {' '.join(_build.HOST_FLAGS)}, beside nvcc")
    for name in KERNEL_SOURCES:
        _build.load(name)
        for line in _build.build_logs.get(name, "").splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
    smem = _build.load("flash_attn_fwd").flash_attn_fwd_smem_bytes
    print(f"[build] flash_attn_fwd: dynamic shared memory per CTA (K1 and K5) {smem(2)} bytes "
          f"with 2 consumer warpgroups, {smem(3)} with 3")
    smem = _build.load("flash_attn_bwd").flash_attn_bwd_smem_bytes
    print(f"[build] flash_attn_bwd: dynamic shared memory per CTA {smem(0)} bytes (K3a), "
          f"{smem(1)} (K3b)")
    print(f"[build] flash_attn_int8: dynamic shared memory per CTA (K6) "
          f"{_build.load('flash_attn_int8').flash_attn_int8_smem_bytes()} bytes")
    print(f"[build] {len(KERNEL_SOURCES)} CUDA and {len(HOST_SOURCES)} host sources built in {secs:.1f} s")
    return secs


# K1/K5 tile edges (128 query rows and 128 keys per tile): one row or key,
# one short of and one past a tile, one past 32 tiles; every (Sq, Sk) pair
EDGE_SIZES = (1, 127, 129, 4097)
# K1/K5's tolerances are ATTN_TOL, ATTN_REL_RMS and LSE_TOL, K2's shapes
# GN_CASES and TRAIN_GN_CASES and its tolerance GN_TOL, in
# mvd_tpu_torch/kernels/measure.py


def _attn_bound_fields(bounds, ms):
    """A K1/K5 case's bound (operations or bytes, whichever is larger), the
    exponentials' bound beside it, and the kernel's share of each."""
    t_ops, t_bytes = bounds["ops_ms"], bounds["bytes_ms"]
    return dict(bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes",
                ops_bound_ms=t_ops, exp_bound_ms=bounds["exp_ms"],
                ops_bound_share=t_ops / ms, exp_bound_share=bounds["exp_ms"] / ms)


def _bound_text(case, clock) -> str:
    return (f"bound {case['bound_ms']:.4f} ms ({case['bound_by']}); share of the operations "
            f"bound {case['ops_bound_share']:.3f}, of the exponentials' bound "
            f"({case['exp_bound_ms']:.4f} ms at {clock / 1e6:.0f} MHz) {case['exp_bound_share']:.3f}")


def check_tile_edges(layout: str) -> float:
    """K1 (``layout="packed"``) or K5 (``"bhsd"``) against its plain version
    at every (Sq, Sk) of EDGE_SIZES, batch 2, 2 heads, different data per
    batch; then batch independence: with batch 1's K and V turned to NaN,
    batch 0's out and lse stay bitwise the same (a tensor map that read
    past a batch's last row into the next batch would bring the NaN in).
    Returns the largest absolute error."""
    import torch

    from mvd_tpu_torch.kernels import (
        attention_packed_plain,
        attention_plain,
        flash_attention_fwd,
        flash_attention_packed_fwd,
    )
    from mvd_tpu_torch.kernels.measure import check_attention

    B, H, bhsd = 2, 2, layout == "bhsd"
    name = "K5" if bhsd else "K1"
    gen = torch.Generator("cuda").manual_seed(4)
    make = lambda S: torch.randn((B, H, S, 64) if bhsd else (B, S, H * 64), generator=gen,
                                 device="cuda").bfloat16()
    kernel = flash_attention_fwd if bhsd else (lambda q, k, v: flash_attention_packed_fwd(q, k, v, H))
    plain = attention_plain if bhsd else (lambda q, k, v: attention_packed_plain(q, k, v, H))
    worst = 0.0
    for Sq in EDGE_SIZES:
        for Sk in EDGE_SIZES:
            q, k, v = make(Sq), make(Sk), make(Sk)
            out, lse = kernel(q, k, v)
            torch.cuda.synchronize()
            worst = max(worst, check_attention(out, lse, *plain(q, k, v), f"{name} Sq {Sq} Sk {Sk}")[0])
    q, k, v = make(4097), make(129), make(129)
    out, lse = kernel(q, k, v)
    k[1], v[1] = float("nan"), float("nan")
    out2, lse2 = kernel(q, k, v)
    torch.cuda.synchronize()
    if not (torch.equal(out[0], out2[0]) and torch.equal(lse[0], lse2[0])):
        raise AssertionError(f"{name}: batch 0's out or lse changed with batch 1's K/V")
    print(f"[kernels] {name} tile edges: Sq, Sk in {EDGE_SIZES} (B {B}, {H} heads) within "
          f"tolerance, max abs err {worst:.3g}; batch 0 bitwise unchanged by NaN in batch 1's K/V")
    return worst


def check_groupnorm() -> list:
    """K2 against its plain version at every shape of GN_CASES and
    TRAIN_GN_CASES, on the path ``launch_plan`` picks there; timed through
    the wrapper and through the C entry alone (y and scratch allocated
    once, device time by CUDA-graph replay), beside the plain version,
    ``group_norm`` + ``silu`` and the bytes bound; two calls bitwise equal,
    and batch 0 bitwise unchanged when batch 1 turns to NaN."""
    import torch
    import torch.nn.functional as F

    from mvd_tpu_torch.kernels import groupnorm_silu, groupnorm_silu_plain
    from mvd_tpu_torch.kernels.groupnorm_silu import FUSED, TWO_PASS, _entry, launch, launch_plan
    from mvd_tpu_torch.kernels.measure import (
        GN_CASES,
        GN_TOL,
        TRAIN_GN_CASES,
        gn_bounds,
        max_err,
        time_graph_ms,
        time_ms,
    )

    gen = torch.Generator("cuda").manual_seed(6)
    randn = lambda *s: torch.randn(s, generator=gen, device="cuda")
    results, paths = [], set()
    G, eps = 32, 1e-6
    for label, B, Hh, W, C, silu in GN_CASES + TRAIN_GN_CASES:
        x = (randn(B, Hh, W, C) * 2 + 0.5).bfloat16()
        w, b = 1 + 0.1 * randn(C), 0.1 * randn(C)
        y = groupnorm_silu(x, w, b, G, eps, silu)
        again = groupnorm_silu(x, w, b, G, eps, silu)
        torch.cuda.synchronize()
        err = max_err(y, groupnorm_silu_plain(x, w, b, G, eps, silu), GN_TOL, f"K2 {label}")
        if not torch.equal(y, again):
            raise AssertionError(f"K2 {label}: two calls on the same input differ")
        del again
        plan = launch_plan(B, Hh * W, C, G)
        paths.add(plan.path)
        iters = max(5, min(100, int(4e9 / x.numel())))
        yy = torch.empty_like(x)
        scratch = torch.empty(plan.scratch, device="cuda") if plan.scratch else None
        ms = time_graph_ms(lambda: launch(_entry(), x, w, b, yy, scratch, G, eps, silu, plan), iters)
        wrapper_ms = time_ms(lambda: groupnorm_silu(x, w, b, G, eps, silu), iters)
        plain_ms = time_ms(lambda: groupnorm_silu_plain(x, w, b, G, eps, silu), max(2, iters // 4), 1)
        xn = x.permute(0, 3, 1, 2)  # NCHW view in channels_last memory
        wb, bb = w.bfloat16(), b.bfloat16()  # F.group_norm takes params in x's dtype

        def lib():
            out = F.group_norm(xn, G, wb, bb, eps)
            return F.silu(out) if silu else out

        lib_ms = time_ms(lib, iters)
        x[1] = float("nan")
        poisoned = groupnorm_silu(x, w, b, G, eps, silu)
        torch.cuda.synchronize()
        if not torch.equal(poisoned[0], y[0]):
            raise AssertionError(f"K2 {label}: batch 0 changed with NaN in batch 1")
        bound = gn_bounds(B, Hh * W, C, silu)
        path = "fused" if plan.path == FUSED else "two-pass"
        results.append(dict(case=label, max_abs_err=err, ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                            library_ms=lib_ms, path=path, plan=dataclasses.asdict(plan),
                            bound_share=bound["bound_ms"] / ms, **bound))
        print(f"[kernels] K2 {label}: {path} (cluster {plan.cluster}, set {plan.set}, rows {plan.rows}, "
              f"{plan.grid[0] * plan.grid[1] * plan.grid[2]} CTAs); err {err:.3g}; C entry {ms:.4f} ms, "
              f"wrapper {wrapper_ms:.4f} ms, plain {plain_ms:.4f} ms, group_norm+silu {lib_ms:.4f} ms, "
              f"bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}), share of bound "
              f"{bound['bound_ms'] / ms:.3f}")
        del x, y, yy, scratch, poisoned
        torch.cuda.empty_cache()
    if paths != {FUSED, TWO_PASS}:
        raise AssertionError(f"K2's cases took only path(s) {paths}")
    print(f"[kernels] K2: both paths within {GN_TOL} at {len(results)} shapes; two calls bitwise equal "
          f"and batch 0 bitwise unchanged by NaN in batch 1 at every shape")
    return results


def phase_kernels():
    import torch
    import torch.nn.functional as F

    from mvd_tpu_torch.kernels import attention_packed_plain, flash_attention_packed_fwd
    from mvd_tpu_torch.kernels.measure import (
        ATTN_CASES,
        ATTN_REL_RMS,
        ATTN_TOL,
        GN_TOL,
        LSE_TOL,
        attn_bounds,
        check_attention,
        sm_clock_hz,
        time_ms,
    )

    clock = sm_clock_hz()
    gen = torch.Generator("cuda").manual_seed(0)
    randn = lambda *s: torch.randn(s, generator=gen, device="cuda")
    results = {"flash_attn_fwd": [], "groupnorm_silu": []}
    print(f"[kernels] K1 tolerance out {ATTN_TOL} and relative RMS error <= {ATTN_REL_RMS}, "
          f"lse {LSE_TOL}; K2 tolerance {GN_TOL}")
    for label, B, Sq, Sk, H in ATTN_CASES:
        D = 64
        q = randn(B, Sq, H * D).bfloat16()
        k, v = randn(B, Sk, H * D).bfloat16(), randn(B, Sk, H * D).bfloat16()
        out, lse = flash_attention_packed_fwd(q, k, v, H)
        torch.cuda.synchronize()
        ref_out, ref_lse = attention_packed_plain(q, k, v, H)
        err, rel_rms = check_attention(out, lse, ref_out, ref_lse, f"K1 {label}")
        print(f"[kernels] K1 {label}: typical |out| (RMS) "
              f"{ref_out.float().pow(2).mean().sqrt().item():.4f}, relative RMS error {rel_rms:.3g}")
        iters = max(3, min(50, int(2e10 / (B * H * Sq * Sk * D))))
        ms = time_ms(lambda: flash_attention_packed_fwd(q, k, v, H), iters)
        plain_ms = time_ms(lambda: attention_packed_plain(q, k, v, H), max(2, iters // 4), 1)
        split = lambda t, s: t.view(B, s, H, D).transpose(1, 2)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(split(q, Sq), split(k, Sk), split(v, Sk)), iters)
        results["flash_attn_fwd"].append(dict(
            case=label, max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
            **_attn_bound_fields(attn_bounds(B, Sq, Sk, H, clock), ms),
        ))
        print(f"[kernels] K1 {label}: err {err:.3g} kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
              f"sdpa {lib_ms:.4f} ms " + _bound_text(results["flash_attn_fwd"][-1], clock))
        del q, k, v, out, lse, ref_out, ref_lse
    results["flash_attn_fwd"].append(dict(case="tile edges", max_abs_err=check_tile_edges("packed")))
    results["groupnorm_silu"] = check_groupnorm()
    torch.cuda.empty_cache()
    return results


# the largest int8 site of the 768² train step, where K6 runs through
# the int8 flash_fwd_op with its straight-through backward; the int8 sites of
# 512² generation (INT8_CASES) and K6's and K6q's checks (INT8_TOL,
# INT8_REL_RMS, INT8_MIN_DB, check_quantize) are in
# mvd_tpu_torch/kernels/measure.py
INT8_TRAIN_CASE = ("self 96x96", 6, 9216, 9216, 5)
# (label, B, heads, Sq, Sk): K5 at the hot self shape and a ragged text shape
K5_CASES = [("self 64x64", 4, 5, 4096, 4096), ("text 64x64", 4, 5, 4096, 77)]


def _snr_db(got, want) -> float:
    want = want.float()
    return 10 * math.log10(want.pow(2).mean().item() / (got.float() - want).pow(2).mean().item())


def phase_int8_kernels():
    """K6 against its plain core on identical operands (K6q's) and, with
    K6q, against the plain version; K6q against the plain quantizers; both
    timed by CUDA-graph replay beside the eager quantizers, K1 at the same
    shape and their bounds, at the int8 sites of the main path; and
    the int8 flash_fwd_op forward and backward at the 768² train shape."""
    import torch

    from mvd_tpu_torch.kernels import (
        attention_int8_core_plain,
        attention_packed_int8_plain,
        attention_packed_plain,
        flash_attention_packed_fwd,
        flash_attention_packed_int8,
        flash_attention_packed_int8_fwd,
        quantize_int8,
        quantize_int8_plain,
    )
    from mvd_tpu_torch.kernels.flash_attention import launch_int8
    from mvd_tpu_torch.kernels.measure import (
        INT8_CASES,
        INT8_MIN_DB,
        INT8_REL_RMS,
        INT8_TOL,
        K6Q_K8_OFF_SHARE,
        K6Q_SK_RTOL,
        LSE_TOL,
        check_attention,
        check_grad,
        check_quantize,
        int8_bounds,
        k6q_bounds,
        plain_bwd_by_row,
        sm_clock_hz,
        time_graph_ms,
        time_ms,
    )

    clock = sm_clock_hz()
    gen = torch.Generator("cuda").manual_seed(2)
    randn = lambda *s: torch.randn(s, generator=gen, device="cuda").bfloat16()
    results = {"flash_attn_int8": [], "quantize_int8": []}
    print(f"[kernels] K6 tolerance out {INT8_TOL} and relative RMS error <= {INT8_REL_RMS}, lse "
          f"{LSE_TOL}, against its plain core on identical operands and, with K6q, against the plain "
          f"version; int8 against exact >= {INT8_MIN_DB} dB. K6q: q8, sq, v8t, sv bitwise; sk within "
          f"{K6Q_SK_RTOL}, k8 off by at most 1 in at most {K6Q_K8_OFF_SHARE} of its elements")
    for label, B, Sq, Sk, H in INT8_CASES:
        HD = H * 64
        q, k, v = randn(B, Sq, HD), randn(B, Sk, HD), randn(B, Sk, HD)
        ops = quantize_int8(q, k, v, H)
        out, lse = launch_int8(ops, H)
        wrap_out, wrap_lse = flash_attention_packed_int8_fwd(q, k, v, H)
        torch.cuda.synchronize()
        want = quantize_int8_plain(q, k, v, H)
        qcheck = check_quantize(ops, want, f"K6q {label}")
        q_err = max((a.float() - b.float()).abs().max().item() for a, b in zip(ops, want))
        del want
        err, rel_rms = check_attention(out, lse, *attention_int8_core_plain(ops, H), f"K6 {label}",
                                       INT8_TOL, INT8_REL_RMS)
        wrap_err, wrap_rms = check_attention(wrap_out, wrap_lse, *attention_packed_int8_plain(q, k, v, H),
                                             f"K6q + K6 {label}", INT8_TOL, INT8_REL_RMS)
        db = _snr_db(wrap_out, attention_packed_plain(q, k, v, H)[0])
        if not db >= INT8_MIN_DB:
            raise AssertionError(f"K6 {label}: int8 against exact {db:.2f} dB < {INT8_MIN_DB}")
        ms = time_graph_ms(lambda: launch_int8(ops, H))
        q_ms = time_graph_ms(lambda: quantize_int8(q, k, v, H))
        wrapper_ms = time_graph_ms(lambda: flash_attention_packed_int8_fwd(q, k, v, H))
        k1_ms = time_graph_ms(lambda: flash_attention_packed_fwd(q, k, v, H))
        plain_ms = time_ms(lambda: attention_int8_core_plain(ops, H), 2, 1)
        eager_ms = time_ms(lambda: quantize_int8_plain(q, k, v, H), 10)
        b6, bq = int8_bounds(B, Sq, Sk, H, clock), k6q_bounds(B, Sq, Sk, H)
        results["flash_attn_int8"].append(dict(
            case=label, max_abs_err=max(err, wrap_err), ms=ms, plain_ms=plain_ms, library_ms=None,
            bound_ms=b6["bound_ms"], bound_by=b6["bound_by"], ops_bound_ms=b6["ops_ms"],
            exp_bound_ms=b6["exp_ms"], bytes_bound_ms=b6["bytes_ms"], bound_share=b6["bound_ms"] / ms,
            ops_bound_share=b6["ops_ms"] / ms, with_k6q_ms=wrapper_ms, k1_ms=k1_ms,
            int8_vs_exact_db=db, rel_rms=rel_rms, with_k6q_rel_rms=wrap_rms,
        ))
        results["quantize_int8"].append(dict(
            case=label, max_abs_err=q_err, ms=q_ms, plain_ms=eager_ms, library_ms=None,
            bound_ms=bq["bound_ms"], bound_by=bq["bound_by"], bound_share=bq["bound_ms"] / q_ms,
            two_read_ms=bq["two_read_ms"], **qcheck,
        ))
        print(f"[kernels] K6q {label}: {q_ms:.4f} ms against the eager quantizers' {eager_ms:.4f} ms; "
              f"bytes bound {bq['bound_ms']:.4f} ms, share {bq['bound_ms'] / q_ms:.3f} (k and v read "
              f"twice: {bq['two_read_ms']:.4f} ms); sk relative error {qcheck['sk_rel_err']:.3g}, k8 off "
              f"in a share {qcheck['k8_off_share']:.3g}")
        print(f"[kernels] K6 {label}: err {err:.3g} rel RMS err {rel_rms:.3g} (with K6q against the "
              f"plain version {wrap_err:.3g} / {wrap_rms:.3g}), int8 vs exact {db:.2f} dB; K6 "
              f"{ms:.4f} ms, K6q + K6 {wrapper_ms:.4f} ms, K1 {k1_ms:.4f} ms, plain core {plain_ms:.4f} "
              f"ms; bound {b6['bound_ms']:.4f} ms (exponentials at {clock / 1e6:.0f} MHz; operations "
              f"{b6['ops_ms']:.4f}, bytes {b6['bytes_ms']:.4f}), share {b6['bound_ms'] / ms:.3f}, of "
              f"the operations bound {b6['ops_ms'] / ms:.3f}")
        del q, k, v, ops, out, lse, wrap_out, wrap_lse

    label, B, Sq, Sk, H = INT8_TRAIN_CASE
    HD = H * 64
    q, k, v, do = randn(B, Sq, HD), randn(B, Sk, HD), randn(B, Sk, HD), randn(B, Sq, HD)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_attention_packed_int8(*leaves, H)
    got = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    rows = [attention_packed_int8_plain(q[b:b + 1], k[b:b + 1], v[b:b + 1], H) for b in range(B)]
    ref_out, ref_lse = (torch.cat(parts) for parts in zip(*rows))
    lse = flash_attention_packed_int8_fwd(q, k, v, H)[1]
    err, rel_rms = check_attention(out.detach(), lse, ref_out, ref_lse, f"int8 flash_fwd_op {label}",
                              INT8_TOL, INT8_REL_RMS)
    want = plain_bwd_by_row(q, k, v, ref_out, ref_lse, do, H)
    checks = {n: check_grad(g, w, f"int8 flash_fwd_op {label} {n}")
              for n, g, w in zip(("dq", "dk", "dv"), got, want)}
    del got, want, rows
    ms = time_ms(lambda: flash_attention_packed_int8_fwd(q, k, v, H), 3)
    step_ms = time_ms(lambda: torch.autograd.grad(flash_attention_packed_int8(*leaves, H), leaves, do), 3)
    print(f"[kernels] int8 flash_fwd_op {label}: out err {err:.3g} rel RMS err {rel_rms:.3g}; "
          + ", ".join(f"{n} rel RMS err {r:.3g}" for n, (_, _, r) in checks.items())
          + f"; K6q + K6 {ms:.4f} ms, forward + backward {step_ms:.4f} ms")
    del q, k, v, do, leaves, out, lse, ref_out, ref_lse
    torch.cuda.empty_cache()
    return results


def phase_k5():
    """K5 and the (B, H, S, D) backward against their plain versions,
    timed beside scaled_dot_product_attention."""
    import torch
    import torch.nn.functional as F

    from mvd_tpu_torch.kernels import attention_plain, flash_attention_fwd
    from mvd_tpu_torch.kernels.flash_attention import (
        _delta,
        flash_attention_packed_bwd,
        flash_attention_packed_bwd_dkv,
        flash_attention_packed_bwd_dq,
    )
    from mvd_tpu_torch.kernels.measure import (
        attn_bounds,
        check_attention,
        check_grad,
        plain_bwd_by_row,
        sm_clock_hz,
        time_ms,
    )

    clock = sm_clock_hz()
    gen = torch.Generator("cuda").manual_seed(3)
    randn = lambda *s: torch.randn(s, generator=gen, device="cuda").bfloat16()
    results = []
    for label, B, H, Sq, Sk in K5_CASES:
        D = 64
        q, k, v, do = randn(B, H, Sq, D), randn(B, H, Sk, D), randn(B, H, Sk, D), randn(B, H, Sq, D)
        out, lse = flash_attention_fwd(q, k, v)
        got = flash_attention_packed_bwd(q, k, v, out, lse, do, H, layout="bhsd")
        torch.cuda.synchronize()
        ref_out, ref_lse = attention_plain(q, k, v)
        err, rel_rms = check_attention(out, lse, ref_out, ref_lse, f"K5 {label}")
        want = plain_bwd_by_row(q, k, v, out, lse, do, H, layout="bhsd")
        checks = {n: check_grad(g, w, f"K5 {label} {n}")
                  for n, g, w in zip(("dq", "dk", "dv"), got, want)}
        del got, want
        iters = max(3, min(50, int(2e10 / (B * H * Sq * Sk * D))))
        ms = time_ms(lambda: flash_attention_fwd(q, k, v), iters)
        plain_ms = time_ms(lambda: attention_plain(q, k, v), max(2, iters // 4), 1)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v), iters)
        delta = _delta(out, do, H, "bhsd")
        bwd_ms = time_ms(lambda: (flash_attention_packed_bwd_dq(q, k, v, do, lse, delta, H, layout="bhsd"),
                                  flash_attention_packed_bwd_dkv(q, k, v, do, lse, delta, H, layout="bhsd")), iters)
        leaf = q.detach().requires_grad_(), k.detach().requires_grad_(), v.detach().requires_grad_()
        o_lib = F.scaled_dot_product_attention(*leaf)
        lib_bwd_ms = time_ms(lambda: torch.autograd.grad(o_lib, leaf, do, retain_graph=True), iters)
        results.append(dict(
            case=label, max_abs_err=max([err] + [c[0] for c in checks.values()]), ms=ms,
            plain_ms=plain_ms, library_ms=lib_ms, rel_rms=rel_rms, bwd_ms=bwd_ms,
            library_bwd_ms=lib_bwd_ms, **_attn_bound_fields(attn_bounds(B, Sq, Sk, H, clock), ms),
        ))
        print(f"[kernels] K5 {label}: err {err:.3g} rel RMS err {rel_rms:.3g}, backward "
              + ", ".join(f"{n} rel RMS err {r:.3g}" for n, (_, _, r) in checks.items())
              + f"; kernel {ms:.4f} ms plain {plain_ms:.4f} ms sdpa {lib_ms:.4f} ms "
              + _bound_text(results[-1], clock)
              + f"; K3a + K3b on (B, H, S, D) {bwd_ms:.4f} ms, sdpa backward {lib_bwd_ms:.4f} ms")
        del q, k, v, do, out, lse, ref_out, ref_lse, leaf, o_lib, delta
    results.append(dict(case="tile edges", max_abs_err=check_tile_edges("bhsd")))
    torch.cuda.empty_cache()
    return {"flash_attn_fwd_bhsd": results}


def expected_launches(pipe, steps: int, cached_steps: int = 0, inversion: bool = False):
    """Launch counts the model structure implies for one generation with
    guidance 1.0 and image conditioning: attention sites per transformer
    block are attn1 + attn2 in the feature pass, plus both adapters in each
    denoise, each site one K1 launch per shard of its heads that the
    process holds (several on a virtual model axis); every GroupNorm runs
    once per UNet pass (feature pass + steps)
    and once per VAE encode (one source image) and decode. ``cached_steps``
    of the steps run from an encoder cache, which runs the mid block and the
    up path only. ``inversion``: a DDIM inversion instead, whose VAE encodes
    the images and the source image and decodes nothing."""
    from mvd_tpu_torch.nn.layers import BasicTransformerBlock, GroupNorm
    from mvd_tpu_torch.tensor_parallel import ColumnParallelLinear

    mvd, vae = pipe.model["mvd"], pipe.model["vae"]
    decoder = ("mid_", "up_", "conv_norm_out")
    count = lambda kind, mods: sum(isinstance(m, kind) for _, m in mods)
    unet_mods = list(mvd.unet.named_modules())
    dec_mods = [(n, m) for n, m in unet_mods if n.startswith(decoder)]
    unet_gn, dec_gn = count(GroupNorm, unet_mods), count(GroupNorm, dec_mods)
    vae_gn = (2 * count(GroupNorm, vae.encoder.named_modules()) if inversion
              else count(GroupNorm, vae.named_modules()))
    full = steps - cached_steps
    shards = lambda q: q.weight.shape[0] if isinstance(q, ColumnParallelLinear) else 1

    def sites(mods):  # (feature-pass launches, denoise launches) of the blocks
        blocks = [m for _, m in mods if isinstance(m, BasicTransformerBlock)]
        feat = sum(shards(b.attn1.to_q) + shards(b.attn2.to_q) for b in blocks)
        return feat, feat + sum(shards(b.adapter_self.to_q_ref) + shards(b.adapter_cross.to_q_ref)
                                for b in blocks)

    (feat, den), (_, dec_den) = sites(unet_mods), sites(dec_mods)
    return {
        "flash_attn_fwd": feat + den * full + dec_den * cached_steps,
        "flash_attn_fwd_bhsd": 0,
        "flash_attn_bwd_dq": 0,
        "flash_attn_bwd_dkv": 0,
        "flash_attn_int8": 0,
        "quantize_int8": 0,
        "groupnorm_silu": unet_gn * (full + 1) + dec_gn * cached_steps + vae_gn,
        "ring_merge": 0,
    }


def expected_int8_launches(pipe, steps: int):
    """As ``expected_launches`` with ``attention_impl="int8"``: each
    attention site of a transformer block at latent side s (s² tokens; text
    K/V 77 tokens; the adapters' K/V come from the same level) runs K6 where
    ``int8_site`` says the JAX package quantizes on a TPU, K1 elsewhere;
    K6q once before each K6."""
    from mvd_tpu_torch.kernels import int8_site
    from mvd_tpu_torch.nn.layers import BasicTransformerBlock

    unet = pipe.model["mvd"].unet
    views = pipe.config.unet.num_views
    last = len(pipe.config.unet.block_out_channels) - 1
    n_int8 = n_exact = 0
    for name, m in unet.named_modules():
        if not isinstance(m, BasicTransformerBlock):
            continue
        kind, index = name.split("_")[:2]  # down_<i>_attn_<j>, mid_attn_0, up_<i>_attn_<j>
        level = int(index) if kind == "down" else last - int(index) if kind == "up" else last
        S = (RES // 8 >> level) ** 2
        J = views * S if views > 1 else S
        sites = [(J, J), (S, 77)] + steps * [(J, J), (S, 77), (S, S), (S, S)]
        quantized = sum(int8_site(sq, sk) for sq, sk in sites)
        n_int8 += quantized
        n_exact += len(sites) - quantized
    return {**expected_launches(pipe, steps), "flash_attn_fwd": n_exact, "flash_attn_int8": n_int8,
            "quantize_int8": n_int8}


def main_path_call():
    """The main path: full-width pipeline from seed 0 on the GPU, and the
    arguments of one 4-view generation."""
    import numpy as np
    import torch

    from mvd_tpu_torch.camera import orbit_cameras
    from mvd_tpu_torch.config import ModelConfig, UNetConfig
    from mvd_tpu_torch.pipeline import MVDPipeline

    cfg = ModelConfig(unet=UNetConfig(sample_size=RES // 8), dtype="bfloat16")
    pipe = MVDPipeline.create(cfg, seed=0, device="cuda")
    cams = orbit_cameras(VIEWS)
    kwargs = dict(
        num_inference_steps=STEPS, guidance_scale=1.0, height=RES, width=RES,
        source_camera=np.tile(cams[:1], (VIEWS, 1, 1)), target_camera=cams,
        source_images=torch.zeros((1, RES, RES, 3), device="cuda"), ref_scale=1.0,
        output_type="pt",
    )
    return pipe, ["a 3d object"] * VIEWS, kwargs


def reset_counts() -> None:
    from mvd_tpu_torch.kernels import KERNELS

    for fn in KERNELS.values():
        fn.launches = fn.plain_calls = 0


def read_counts():
    from mvd_tpu_torch.kernels import KERNELS

    return ({name: fn.launches for name, fn in KERNELS.items()},
            {name: fn.plain_calls for name, fn in KERNELS.items()})


def sync_checked_loop(pipe, name: str = "denoise_loop") -> list:
    """Makes the next call of ``pipe.denoise_loop`` (from the first denoise
    step to the last sampler step), or of the loop method ``name``, run
    under ``torch.cuda.set_sync_debug_mode("error")``, so that any call in
    it that waits for the device raises; the decode and the output copy
    stay outside. Returns a list that holds True once the loop ran so."""
    import torch

    inner, ran = getattr(pipe, name), []

    def checked(*args, **kwargs):
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = inner(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
            delattr(pipe, name)
        ran.append(True)
        return out

    setattr(pipe, name, checked)
    return ran


def record_groupnorm_calls(model) -> tuple:
    """(calls, hooks): every GroupNorm call of ``model`` from now on, as
    (B, HW, C, groups, silu), recorded by forward pre-hooks (which touch no
    tensor data); remove the hooks when done."""
    from mvd_tpu_torch.nn.layers import GroupNorm

    calls = []

    def hook(mod, inputs):
        B, C, H, W = inputs[0].shape
        calls.append((B, H * W, C, mod.num_groups, mod.fuse_silu))

    hooks = [m.register_forward_pre_hook(hook) for m in model.modules() if isinstance(m, GroupNorm)]
    return calls, hooks


def groupnorm_summary(calls) -> dict:
    """The summed bytes bound of K2 over ``calls`` and the device kernels
    its plans launch (one per fused call, two per two-pass call)."""
    from mvd_tpu_torch.kernels.groupnorm_silu import FUSED, launch_plan
    from mvd_tpu_torch.kernels.measure import gn_bounds

    fused = sum(launch_plan(B, HW, C, G).path == FUSED for B, HW, C, G, _ in calls)
    return dict(calls=len(calls), fused_calls=fused, two_pass_calls=len(calls) - fused,
                device_kernels=fused + 2 * (len(calls) - fused),
                bound_ms=sum(gn_bounds(B, HW, C, silu)["bound_ms"] for B, HW, C, _, silu in calls))


def _psnr(images, want) -> float:
    mse = (images.float() - want.float()).pow(2).mean().item()
    return 10 * math.log10(1.0 / mse) if mse > 0 else math.inf


def _check_images(images, what: str) -> None:
    import torch

    if tuple(images.shape) != (VIEWS, RES, RES, 3):
        raise AssertionError(f"{what}: images shape {tuple(images.shape)}")
    if not torch.isfinite(images).all() or images.min() < 0 or images.max() > 1:
        raise AssertionError(f"{what}: images not finite or outside [0, 1]")


def _counted_call(fn, want: dict, label: str, loops=(), pipe=None):
    """One call of ``fn`` with the counts set to 0 before it and read after:
    the launches must be ``want``, no plain version may run, and each loop
    method of ``pipe`` named in ``loops`` must run under the sync check.
    Prints a line that starts with ``label``; returns (the call's result,
    its seconds, the launches)."""
    import torch

    checked = [sync_checked_loop(pipe, name) for name in loops]
    reset_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches, plain = read_counts()
    print(f"{label} first call {secs:.2f} s; launches {launches} (expected {want}); plain calls {plain}"
          + (f"; {' and '.join(loops)} under the sync check" if loops else ""))
    if launches != want or any(plain.values()):
        raise AssertionError(f"{label} kernel launches {launches} != expected {want}, or plain calls {plain}")
    if any(ran != [True] for ran in checked):
        raise AssertionError(f"{label} a loop did not run under the sync check")
    return out, secs, launches


def phase_main_path():
    import torch

    t0 = time.perf_counter()
    pipe, prompts, kwargs = main_path_call()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in pipe.model.parameters())
    print(f"[main] created full-width pipeline ({n_params / 1e6:.1f} M params) "
          f"in {time.perf_counter() - t0:.1f} s")
    # pipe.compute_model casts once, outside the counted run
    gn_calls, hooks = record_groupnorm_calls(pipe.compute_model)
    want = expected_launches(pipe, STEPS)
    out, first_s, launches = _counted_call(lambda: pipe(prompts, seed=0, **kwargs), want, "[main]",
                                           ("denoise_loop",), pipe)
    images = first_images = out["images"]
    for h in hooks:
        h.remove()
    print(f"[main] the {STEPS}-step denoise loop ran under torch.cuda.set_sync_debug_mode(\"error\"): "
          f"no call in it waited for the device")
    gn = groupnorm_summary(gn_calls)
    if gn["calls"] != want["groupnorm_silu"]:
        raise AssertionError(f"{gn['calls']} GroupNorm calls recorded, {want['groupnorm_silu']} launched")
    print(f"[main] K2: {gn['calls']} GroupNorm calls, {gn['fused_calls']} fused (one device kernel "
          f"each) and {gn['two_pass_calls']} two-pass (two each): {gn['device_kernels']} device "
          f"kernels; summed bytes bound of every call {gn['bound_ms']:.3f} ms")
    _check_images(images, "main path")
    print(f"[main] images {tuple(images.shape)} in [{images.min().item():.4f}, "
          f"{images.max().item():.4f}], mean {images.mean().item():.4f}, std {images.std().item():.4f}")

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    images = pipe(prompts, seed=1, **kwargs)["images"]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[main] second call {dt:.3f} s per {VIEWS}-view batch = {VIEWS / dt:.4f} img/s, "
          f"peak memory {peak:.2f} GiB")
    metrics = dict(sec_per_batch=dt, img_per_s=VIEWS / dt, peak_gib=peak, first_call_s=first_s,
                   groupnorm=gn)
    return launches, metrics, (pipe, prompts, kwargs), first_images


def phase_int8_main_path(call, bf16_images):
    """The main path with ``attention_impl="int8"``, on phase 3's weights."""
    import torch

    from mvd_tpu_torch.pipeline import MVDPipeline
    from mvd_tpu_torch.pipeline.pipeline import build_model

    pipe, prompts, kwargs = call
    cfg = dataclasses.replace(
        pipe.config, unet=dataclasses.replace(pipe.config.unet, attention_impl="int8"))
    t0 = time.perf_counter()
    with torch.device("cuda"):
        model = build_model(cfg)
    model.load_state_dict(pipe.model.state_dict())
    pipe8 = MVDPipeline(cfg, model, "cuda", pipe.tokenizer)
    pipe8.compute_model  # cast once, outside the counted run
    torch.cuda.synchronize()
    print(f"[int8] built the int8 pipeline from phase 3's weights in {time.perf_counter() - t0:.1f} s")
    out, first_s, launches = _counted_call(lambda: pipe8(prompts, seed=0, **kwargs),
                                           expected_int8_launches(pipe8, STEPS), "[int8]")
    images = out["images"]
    _check_images(images, "int8")
    psnr = _psnr(images, bf16_images)
    print(f"[int8] images {tuple(images.shape)} in [{images.min().item():.4f}, "
          f"{images.max().item():.4f}], mean {images.mean().item():.4f}; PSNR against phase 3's "
          f"images (same weights and noise) {psnr:.2f} dB")
    # later calls of both pipelines in turns, so that host noise shows as spread
    turns = {"bf16": [], "int8": []}
    for which in ("bf16", "int8", "int8", "bf16"):
        turns[which].append(_timed(lambda: (pipe if which == "bf16" else pipe8)(prompts, seed=1, **kwargs)))
    dt = sum(turns["int8"]) / 2
    print(f"[int8] later calls in turns (bf16, int8, int8, bf16): bf16 "
          f"{turns['bf16'][0]:.3f} / {turns['bf16'][1]:.3f} s, int8 {turns['int8'][0]:.3f} / "
          f"{turns['int8'][1]:.3f} s per {VIEWS}-view batch; int8 {VIEWS / dt:.4f} img/s")
    metrics = dict(sec_per_batch=dt, img_per_s=VIEWS / dt, first_call_s=first_s,
                   psnr_vs_bf16_db=psnr, turns_s=turns)
    return launches, metrics, (pipe8, prompts, kwargs)


def _timed(fn) -> float:
    import torch

    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _check_png(data: bytes, shape, what: str) -> None:
    from mvd_tpu_torch.utils.images import decode_png

    img = decode_png(data)
    if img.shape != shape:
        raise AssertionError(f"{what}: a PNG decodes to {img.shape}, not {shape}")


def phase_entry_points(call, bf16_images, trace: bool = False):
    """Phase 3c, on phase 3's pipeline and weights at full width, 4 views,
    512²: (a) the checkpoint round trip through the reference's Lightning
    names and the infer CLI on that checkpoint; (b) DPM-Solver++(2M) at 10
    steps, DDIM inversion then DDIM at 20, DDPM at 20 with encoder reuse 2,
    each with exact launches, no plain call and its loops under the sync
    check, and timed in turns with phase 3's DDPM (and traced with
    ``trace``); (c) the zero-padded ray-conditioned pipeline; (d) the HTTP
    server."""
    import base64
    import tempfile
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    import numpy as np
    import torch

    from mvd_tpu_torch.checkpoint import (
        export_jax_params,
        export_lightning_state_dict,
        load_checkpoint,
        load_jax_params,
        zero_pad_conv_in,
    )
    from mvd_tpu_torch.cli import infer
    from mvd_tpu_torch.cli import serve as serve_mod
    from mvd_tpu_torch.cli.serve import make_handler
    from mvd_tpu_torch.pipeline import MVDPipeline
    from mvd_tpu_torch.pipeline.pipeline import build_model
    from mvd_tpu_torch.utils.images import encode_png, resize

    pipe, prompts, kwargs = call
    metrics = {}

    # (a) checkpoint round trip: phase 3's UNet and camera encoder under the
    # reference's Lightning names, into a fresh pipeline whose every
    # parameter the checkpoint holds is NaN before the load
    t0 = time.perf_counter()
    tree = export_jax_params(pipe.model["mvd"])
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "last.ckpt")
        sd = {k: torch.from_numpy(np.ascontiguousarray(v))
              for k, v in export_lightning_state_dict(tree).items()}
        torch.save({"state_dict": sd, "epoch": 0}, path)
        n_keys = len(sd)
        del sd
        fresh = MVDPipeline.create(pipe.config, seed=0, device=pipe.device)
        with torch.no_grad():
            for name, p in fresh.model["mvd"].named_parameters():
                if not name.endswith("translation_projection"):
                    p.fill_(float("nan"))
        kept, skipped = load_checkpoint(fresh, path)
        if kept != ["mvd.camera_encoder.translation_projection"] or skipped:
            raise AssertionError(f"the loader kept {kept} from init and skipped {skipped}")
        mine = dict(pipe.model.named_parameters())
        differ = [n for n, p in fresh.model.named_parameters() if not torch.equal(p, mine[n])]
        if differ:
            raise AssertionError(f"{len(differ)} parameters differ after the round trip: {differ[:5]}")
        reloaded = fresh(prompts, seed=0, **kwargs)["images"]
        torch.cuda.synchronize()
        if not torch.equal(reloaded, bf16_images):
            raise AssertionError("the reloaded pipeline's images differ from phase 3's")
        round_trip_s = time.perf_counter() - t0
        print(f"[entry] checkpoint: {n_keys} Lightning keys; every parameter bitwise phase 3's after "
              f"the load (the translation projection kept from init), images bitwise phase 3's at "
              f"the same noise; {round_trip_s:.1f} s")
        del fresh, reloaded
        torch.cuda.empty_cache()
        out_dir = os.path.join(tmp, "infer")
        t0 = time.perf_counter()
        infer.main(["--checkpoint", path, "--sampler", "dpmpp_2m", "--num-steps", "10",
                    "--image-size", str(RES), "--num-images", "1", "--output-dir", out_dir])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        names = sorted(os.listdir(out_dir))
        if names != ["comparison_00.png", "generated_00.png", "source.png"]:
            raise AssertionError(f"the infer CLI wrote {names}")
        for name in names[1:]:
            with open(os.path.join(out_dir, name), "rb") as f:
                _check_png(f.read(), (RES, RES, 3), f"infer CLI {name}")
        print(f"[entry] python -m mvd_tpu_torch.cli.infer --checkpoint last.ckpt --sampler dpmpp_2m "
              f"--num-steps 10 --image-size {RES} --num-images 1: {names}, each decoded, in {cli_s:.1f} s")
    torch.cuda.empty_cache()
    metrics["checkpoint"] = dict(lightning_keys=n_keys, round_trip_s=round_trip_s, infer_cli_s=cli_s)

    # (b) samplers, inversion and encoder reuse
    gen_kw = {k: v for k, v in kwargs.items() if k != "num_inference_steps"}
    inv_kw = {k: kwargs[k] for k in ("source_camera", "target_camera", "source_images", "ref_scale")}

    def invert_then_ddim(seed):
        lat = pipe.invert(bf16_images, prompts, num_inference_steps=STEPS, output_type="pt",
                          **inv_kw)["latents"]
        return pipe(prompts, seed=seed, num_inference_steps=STEPS, latents=lat, sampler="ddim",
                    **gen_kw)

    both = lambda a, b: {k: a[k] + b[k] for k in a}
    runs = [
        ("dpmpp_2m 10 steps", 10,
         lambda seed: pipe(prompts, seed=seed, num_inference_steps=10, sampler="dpmpp_2m", **gen_kw),
         expected_launches(pipe, 10), ("denoise_loop",)),
        (f"invert + ddim {STEPS} steps", STEPS, invert_then_ddim,
         both(expected_launches(pipe, STEPS, inversion=True), expected_launches(pipe, STEPS)),
         ("inversion_loop", "denoise_loop")),
        (f"ddpm {STEPS} steps, encoder_reuse 2", STEPS,
         lambda seed: pipe(prompts, seed=seed, num_inference_steps=STEPS, encoder_reuse=2, **gen_kw),
         expected_launches(pipe, STEPS, cached_steps=STEPS // 2), ("denoise_loop",)),
    ]
    for label, steps, fn, want, loops in runs:
        out, first_s, _ = _counted_call(lambda: fn(0), want, f"[entry] {label}:", loops, pipe)
        _check_images(out["images"], label)
        metrics[label] = dict(steps=steps, first_call_s=first_s, launches=want,
                              psnr_vs_ddpm_db=_psnr(out["images"], bf16_images))
    # later calls of each, and of phase 3's DDPM, in turns (forward, then
    # backward), so that host noise shows as spread
    timed = {f"ddpm {STEPS} steps": lambda seed: pipe(prompts, seed=seed, **kwargs)}
    timed.update({label: fn for label, _, fn, _, _ in runs})
    turns = {label: [] for label in timed}
    for label in list(timed) + list(timed)[::-1]:
        turns[label].append(_timed(lambda: timed[label](1)))
    for label, secs in turns.items():
        dt = sum(secs) / len(secs)
        row = metrics.setdefault(label, {})
        row.update(turns_s=secs, sec_per_call=dt, img_per_s=VIEWS / dt)
        psnr = f"; PSNR against phase 3's images {row['psnr_vs_ddpm_db']:.2f} dB" if "launches" in row else ""
        print(f"[entry] {label}: later calls in turns {secs[0]:.3f} / {secs[1]:.3f} s per {VIEWS}-view "
              f"batch, {VIEWS / dt:.4f} img/s{psnr}")
    if trace:
        metrics["traces"] = {label: trace_run(lambda: fn(2), f"generation, {label}")
                             for label, _, fn, _, _ in runs}

    # (c) ray conditioning: phase 3's weights with conv_in zero-padded
    ray_cfg = dataclasses.replace(pipe.config, use_ray_conditioning=True)
    with torch.device(pipe.device):
        model = build_model(ray_cfg)
    tree["unet"] = zero_pad_conv_in(tree["unet"])
    load_jax_params(model["mvd"], tree)
    del tree
    for net in ("vae", "text_encoder"):
        model[net].load_state_dict(pipe.model[net].state_dict())
    ray_pipe = MVDPipeline(ray_cfg, model, pipe.device, pipe.tokenizer)
    ray_pipe.compute_model  # cast once, outside the counted run
    out, ray_s, _ = _counted_call(lambda: ray_pipe(prompts, seed=0, **kwargs),
                                  expected_launches(ray_pipe, STEPS),
                                  f"[entry] ray-conditioned ddpm {STEPS} steps:", ("denoise_loop",), ray_pipe)
    _check_images(out["images"], "ray")
    psnr = _psnr(out["images"], bf16_images)
    metrics["ray"] = dict(first_call_s=ray_s, psnr_vs_unpadded_db=psnr)
    print(f"[entry] ray conditioning (conv_in {tuple(model['mvd'].unet.conv_in.weight.shape)}, zero-"
          f"padded): PSNR against phase 3's images at the same noise {psnr:.2f} dB (bf16; no bar)")
    del ray_pipe, model, out
    torch.cuda.empty_cache()

    # (d) the HTTP server over phase 3's pipeline
    srv = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(pipe, RES, threading.Lock()))
    server = threading.Thread(target=srv.serve_forever, daemon=True)
    server.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"

    def get_health():
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            return json.loads(r.read())

    def post(payload):
        req = urllib.request.Request(url + "/generate", data=json.dumps(payload).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as r:
            if r.status != 200:
                raise AssertionError(f"/generate answered {r.status}")
            return json.loads(r.read())

    try:
        health = get_health()
        if not (health["ok"] and health["backend"] == pipe.device.type and health["queue_depth"] == 0):
            raise AssertionError(f"/healthz: {health}")
        fast = {"prompt": "a 3d object", "num_views": VIEWS, "num_steps": 10, "sampler": "dpmpp_2m"}
        source = resize((bf16_images[0].float().cpu().numpy() * 255).round().astype(np.uint8), 384, 384)
        replies = {"dpmpp_2m 10 steps": post(fast),
                   "source image (384² PNG)": post({**fast, "seed": 1, "source_image_b64":
                                                    base64.b64encode(encode_png(source)).decode()})}
        both_at_once = {}
        threads = [threading.Thread(target=lambda i=i: both_at_once.__setitem__(i, post({**fast, "seed": 2 + i})))
                   for i in range(2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        if sorted(both_at_once) != [0, 1]:
            raise AssertionError("a concurrent request did not finish")
        replies.update({f"concurrent {i}": both_at_once[i] for i in range(2)})
        # a JPEG upload (a CO3D-sized 4:2:0 frame) at 20 DDPM steps: the
        # server's own decode is bitwise PIL's pixels for it (by sha256), and
        # the call launches K1 and K2 as phase 3's does
        jpeg_name = "frame_a.jpg"
        with open(os.path.join(JPEG_FIXTURES, jpeg_name), "rb") as f:
            jpeg = f.read()
        decoded = []

        def recorded(decode):
            def run(data, *a, **k):
                img = decode(data, *a, **k)
                decoded.append(img)
                return img
            return run

        with _Hooks() as hooks:
            hooks.wrap(serve_mod, "decode_image", recorded)
            reset_counts()
            label = f"JPEG source ({jpeg_name}), DDPM {STEPS}"
            replies[label] = post({"prompt": "a 3d object", "num_views": VIEWS, "num_steps": STEPS,
                                   "seed": 4, "source_image_b64": base64.b64encode(jpeg).decode()})
            jpeg_launches, jpeg_plain = read_counts()
        want = expected_launches(pipe, STEPS)
        digest = fixture_digests()[jpeg_name]
        got = [hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest() for img in decoded]
        if jpeg_launches != want or any(jpeg_plain.values()):
            raise AssertionError(f"serve {label}: launches {jpeg_launches} != {want}, plain {jpeg_plain}")
        if got != [digest["sha256"]] or list(decoded[0].shape) != digest["shape"]:
            raise AssertionError(f"serve {label}: the server decoded {got}, PIL's pixels are "
                                 f"{digest['sha256']}")
        print(f"[entry] serve {label}: the server's decode {tuple(decoded[0].shape)} is bitwise PIL's "
              f"(sha256 {got[0][:16]}...); launches {jpeg_launches}; no plain call")
        for label, reply in replies.items():
            if len(reply["images_b64"]) != VIEWS:
                raise AssertionError(f"serve {label}: {len(reply['images_b64'])} images")
            for b64 in reply["images_b64"]:
                _check_png(base64.b64decode(b64), (RES, RES, 3), f"serve {label}")
        health = get_health()
        if health["queue_depth"] != 0:
            raise AssertionError(f"/healthz after the requests: {health}")
    finally:
        srv.shutdown()
        srv.server_close()
        server.join(timeout=60)
    latency = {label: reply["latency_s"] for label, reply in replies.items()}
    metrics["serve"] = dict(latency_s=latency, compiled_signatures=health["compiled_signatures"],
                            jpeg_launches=jpeg_launches)
    print(f"[entry] serve: /healthz {health}; every /generate answered 200 with {VIEWS} PNGs of "
          f"{RES}x{RES}x3; latency_s {latency}")
    return metrics


def check_bwd_tile_edges(layout: str) -> float:
    """K3a/K3b (through ``flash_attention_packed_bwd``) in ``layout``
    ("packed" or "bhsd") against the plain backward at every (Sq, Sk) of
    EDGE_SIZES, batch 2, 2 heads, different data per batch; then batch
    independence (with batch 1's q, k, v and dO turned to NaN, batch 0's dq,
    dk and dv stay bitwise the same: a tensor map or statistics slice that
    read past a batch's last row would bring the NaN in) and repeatability
    (two launches on the same inputs are bitwise equal). Returns the largest
    absolute error."""
    import torch

    from mvd_tpu_torch.kernels import (
        attention_packed_bwd_plain,
        flash_attention_fwd,
        flash_attention_packed_bwd,
        flash_attention_packed_fwd,
    )
    from mvd_tpu_torch.kernels.measure import check_grad

    B, H, bhsd = 2, 2, layout == "bhsd"
    gen = torch.Generator("cuda").manual_seed(5)
    make = lambda S: torch.randn((B, H, S, 64) if bhsd else (B, S, H * 64), generator=gen,
                                 device="cuda").bfloat16()
    fwd = flash_attention_fwd if bhsd else (lambda q, k, v: flash_attention_packed_fwd(q, k, v, H))
    bwd = lambda q, k, v, out, lse, do: flash_attention_packed_bwd(q, k, v, out, lse, do, H, layout=layout)
    worst = 0.0
    for Sq in EDGE_SIZES:
        for Sk in EDGE_SIZES:
            q, k, v, do = make(Sq), make(Sk), make(Sk), make(Sq)
            out, lse = fwd(q, k, v)
            got = bwd(q, k, v, out, lse, do)
            torch.cuda.synchronize()
            want = attention_packed_bwd_plain(q, k, v, out, lse, do, H, layout=layout)
            # With one key, O = V and dS = P (dO V^T - rowsum(dO O)) is exactly
            # 0, so dq and dk are rounding noise in both versions: they are held
            # to the size of their terms, RMS(dO V^T) RMS(K or Q) / sqrt(D),
            # times sqrt(Sq) for dk's sum over the rows.
            scale = {}
            if Sk == 1:
                dp = (do.float() * v.float()).sum(-1).pow(2).mean().sqrt().item() / 8
                scale = {"dq": dp * k.float().pow(2).mean().sqrt().item(),
                         "dk": dp * q.float().pow(2).mean().sqrt().item() * Sq**0.5}
            for n, g, w in zip(("dq", "dk", "dv"), got, want):
                what = f"K3 {layout} Sq {Sq} Sk {Sk} {n}"
                worst = max(worst, check_grad(g, w, what, rms=scale.get(n))[0])
    q, k, v, do = make(4097), make(129), make(129), make(4097)
    out, lse = fwd(q, k, v)
    first = bwd(q, k, v, out, lse, do)
    again = bwd(q, k, v, out, lse, do)
    for t in (q, k, v, do):
        t[1] = float("nan")
    poisoned = bwd(q, k, v, out, lse, do)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(first, again)):
        raise AssertionError(f"K3 {layout}: two launches on the same inputs differ")
    if not all(torch.equal(a[0], b[0]) for a, b in zip(first, poisoned)):
        raise AssertionError(f"K3 {layout}: batch 0's gradients changed with NaN in batch 1")
    print(f"[train-kernels] K3a/K3b {layout} tile edges: Sq, Sk in {EDGE_SIZES} (B {B}, {H} heads) "
          f"within tolerance, max abs err {worst:.3g}; batch 0 bitwise unchanged by NaN in batch "
          f"1's q, k, v, dO; two launches bitwise equal")
    return worst


def phase_train_kernels():
    import torch
    import torch.nn.functional as F

    from mvd_tpu_torch.kernels import (
        flash_attention_packed_bwd,
        flash_attention_packed_bwd_dkv,
        flash_attention_packed_bwd_dq,
        flash_attention_packed_fwd,
    )
    from mvd_tpu_torch.kernels.flash_attention import _delta
    from mvd_tpu_torch.kernels.measure import (
        GRAD_ATOL_RMS,
        GRAD_REL_RMS,
        GRAD_RTOL,
        TRAIN_ATTN_CASES,
        bwd_bounds,
        check_grad,
        plain_bwd_by_row,
        time_ms,
    )

    gen = torch.Generator("cuda").manual_seed(1)
    randn = lambda *s: torch.randn(s, generator=gen, device="cuda").bfloat16()
    results = {"flash_attn_bwd_dq": [], "flash_attn_bwd_dkv": []}
    print(f"[train-kernels] K3a/K3b tolerance: rtol {GRAD_RTOL}, atol {GRAD_ATOL_RMS} x RMS(grad), "
          f"relative RMS error <= {GRAD_REL_RMS} for each of dq, dk, dv")
    for label, B, Sq, Sk, H in TRAIN_ATTN_CASES:
        D = 64
        q, do = randn(B, Sq, H * D), randn(B, Sq, H * D)
        k, v = randn(B, Sk, H * D), randn(B, Sk, H * D)
        out, lse = flash_attention_packed_fwd(q, k, v, H)
        got = flash_attention_packed_bwd(q, k, v, out, lse, do, H)
        torch.cuda.synchronize()
        want = plain_bwd_by_row(q, k, v, out, lse, do, H)
        checks = {name: check_grad(g, w, f"K3 {label} {name}")
                  for name, g, w in zip(("dq", "dk", "dv"), got, want)}
        print(f"[train-kernels] K3 {label}: " + ", ".join(
            f"{n} typical |grad| {rms:.4g} max err {e:.3g} rel RMS err {r:.3g}"
            for n, (e, rms, r) in checks.items()))
        del got, want
        delta = _delta(out, do, H)
        iters = max(3, min(50, int(2e10 / (B * H * Sq * Sk * D))))
        ms_dq = time_ms(lambda: flash_attention_packed_bwd_dq(q, k, v, do, lse, delta, H), iters)
        ms_dkv = time_ms(lambda: flash_attention_packed_bwd_dkv(q, k, v, do, lse, delta, H), iters)
        plain_ms = time_ms(lambda: plain_bwd_by_row(q, k, v, out, lse, do, H), 2, 1)

        def sdpa_bwd_ms(grad_q: bool):
            split = lambda t, s: t.detach().view(B, s, H, D).transpose(1, 2)
            qh, kh, vh = split(q, Sq), split(k, Sk), split(v, Sk)
            leaf = lambda t: t.detach().requires_grad_()
            qh, kh, vh = (leaf(qh), kh, vh) if grad_q else (qh, leaf(kh), leaf(vh))
            inputs = (qh,) if grad_q else (kh, vh)
            oh = F.scaled_dot_product_attention(qh, kh, vh)
            doh = split(do, Sq)
            return time_ms(lambda: torch.autograd.grad(oh, inputs, doh, retain_graph=True), iters)

        lib_dq, lib_dkv = sdpa_bwd_ms(True), sdpa_bwd_ms(False)
        bounds = bwd_bounds(B, Sq, Sk, H)
        for key, part, ms, lib in (("flash_attn_bwd_dq", "dq", ms_dq, lib_dq),
                                   ("flash_attn_bwd_dkv", "dkv", ms_dkv, lib_dkv)):
            err = max(checks[n][0] for n in (("dq",) if part == "dq" else ("dk", "dv")))
            results[key].append(dict(
                case=label, max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib,
                bound_ms=bounds[part]["bound_ms"], bound_by=bounds[part]["bound_by"],
                bound_share=bounds[part]["bound_ms"] / ms,
            ))
        dq_row, dkv_row = results["flash_attn_bwd_dq"][-1], results["flash_attn_bwd_dkv"][-1]
        print(f"[train-kernels] K3 {label}: K3a {ms_dq:.4f} ms (sdpa bwd dq {lib_dq:.4f} ms), "
              f"K3b {ms_dkv:.4f} ms (sdpa bwd dk,dv {lib_dkv:.4f} ms), plain dq,dk,dv "
              f"{plain_ms:.2f} ms, bounds {dq_row['bound_ms']:.4f} / {dkv_row['bound_ms']:.4f} ms "
              f"({dq_row['bound_by']}), share of bound {dq_row['bound_share']:.3f} / "
              f"{dkv_row['bound_share']:.3f}")
        del q, k, v, do, out, lse, delta
        torch.cuda.empty_cache()
    for layout in ("packed", "bhsd"):
        worst = check_bwd_tile_edges(layout)
        for key in results:
            results[key].append(dict(case=f"tile edges {layout}", max_abs_err=worst))
    torch.cuda.empty_cache()
    return results


def expected_train_launches(model):
    """Launches per train step that the model structure implies (image and
    camera conditioning, feature matching off; the same with joint
    attention, which merges the views of a site into one launch): K1 at
    attn1 and attn2 of every transformer block in the no-grad feature pass
    and at attn1, attn2 and both adapters in the denoise pass; in the
    backward, K3a at those four denoise sites and K3b at the three whose K/V
    carry gradient (attn1 and the adapters; attn2's K/V come from the frozen
    text, and carry gradient only where the whole UNet trains,
    ``train_denoising_unet``, through attn2's own K/V projections; the
    feature pass is not differentiated); K2 at every UNet GroupNorm in both UNet passes and at every VAE
    encoder GroupNorm in the source and the target encode. With remat (the
    config default, as in the JAX package) the backward runs every
    ResnetBlock and Transformer2D again, K2 with them, but not K1, whose
    (out, lse) the policy saves (under ``MVD_REMAT_POLICY=none`` K1 runs
    again at the four denoise sites). The GroupNorm backward recomputes in
    PyTorch and launches no kernel."""
    from mvd_tpu_torch.nn.layers import BasicTransformerBlock, GroupNorm, ResnetBlock, Transformer2D

    unet = model["mvd"].unet
    blocks = sum(isinstance(m, BasicTransformerBlock) for m in unet.modules())
    unet_gn = sum(isinstance(m, GroupNorm) for m in unet.modules())
    enc_gn = sum(isinstance(m, GroupNorm) for m in model["vae"].encoder.modules())
    remat = unet.cfg.remat
    again_gn = sum(isinstance(g, GroupNorm) for b in unet.modules()
                   if isinstance(b, (ResnetBlock, Transformer2D)) for g in b.modules()) if remat else 0
    again_k1 = blocks * 4 if remat and os.environ.get("MVD_REMAT_POLICY") == "none" else 0
    text_kv = any(p.requires_grad for n, p in unet.named_parameters() if ".attn2.to_k." in n)
    return {
        "flash_attn_fwd": blocks * 2 + blocks * 4 + again_k1,
        "flash_attn_fwd_bhsd": 0,
        "flash_attn_bwd_dq": blocks * 4,
        "flash_attn_bwd_dkv": blocks * (4 if text_kv else 3),
        "flash_attn_int8": 0,
        "quantize_int8": 0,
        "groupnorm_silu": unet_gn * 2 + enc_gn * 2 + again_gn,
        "ring_merge": 0,
    }


def train_setup(views: int = 1):
    """The train step's operating point on the GPU from seed 0: the model,
    its train state, the step and one seeded random pixel batch of
    TRAIN_BATCH samples of ``views`` views (one source view a sample, as the
    group loader gives it; joint attention over the views when ``views`` >
    1)."""
    import numpy as np
    import torch

    from mvd_tpu_torch.camera import orbit_cameras
    from mvd_tpu_torch.config import ModelConfig, TrainConfig, UNetConfig
    from mvd_tpu_torch.data.tokenizer import load_tokenizer
    from mvd_tpu_torch.nn.adapter_init import init_adapters_from_frozen
    from mvd_tpu_torch.parallel import for_view_sharding
    from mvd_tpu_torch.pipeline.pipeline import build_model, build_schedule, init_weights
    from mvd_tpu_torch.train import TrainState, make_train_step

    mcfg = ModelConfig(unet=UNetConfig(sample_size=TRAIN_RES // 8), dtype="bfloat16")
    if views > 1:
        mcfg = for_view_sharding(mcfg, views, 1)
    cfg = TrainConfig(model=mcfg)
    with torch.device("cuda"):
        model = build_model(mcfg)
    init_weights(model, torch.Generator("cuda").manual_seed(0))
    init_adapters_from_frozen(model["mvd"])
    state = TrainState.create(model, cfg, TRAIN_TOTAL)
    step = make_train_step(build_schedule(mcfg).to("cuda"), cfg)

    gen = torch.Generator("cuda").manual_seed(0)
    B, V, R = TRAIN_BATCH, views, TRAIN_RES
    img = lambda n: torch.rand((B, n, R, R, 3), generator=gen, device="cuda") * 2 - 1
    if V == 1:
        cams = torch.as_tensor(orbit_cameras(B), device="cuda")
        src_cam, tgt_cam = cams[:1].expand(B, 4, 4).reshape(B, 1, 4, 4).contiguous(), cams.reshape(B, 1, 4, 4)
    else:
        cams = torch.as_tensor(orbit_cameras(V), device="cuda")
        src_cam = cams[:1].expand(B, V, 4, 4).contiguous()
        tgt_cam = cams[None].expand(B, V, 4, 4).contiguous()
    tok = load_tokenizer(vocab_size=mcfg.text_encoder.vocab_size)
    ids = torch.as_tensor(np.asarray(tok(["a 3d object"] * B)), device="cuda")
    batch = {
        "source_image": img(1).expand(B, V, R, R, 3).contiguous(), "target_image": img(V),
        "source_camera": src_cam, "target_camera": tgt_cam,
        "input_ids": ids[:, None].expand(B, V, ids.shape[-1]).contiguous(),
    }
    return state, step, batch, gen


def phase_train(views: int = 1, tag: str = "train"):
    """The train step at the reference point (phase 4 with one view, 6d with
    JOINT_TRAIN_VIEWS): TRAIN_STEPS steps with remat on (the config's
    default) and TRAIN_STEPS with it off from the same state, batch and
    draws, then one more step of each traced for its device time, then
    REMAT_TURNS steps of each in turns for s/step. Checks
    for each: a finite loss and gradient norm, the structure's launches in
    every step and no plain call, trainable parameters unchanged by step 1
    (lr 0) and moved by step 2; then frozen parameters bitwise unchanged,
    step 1's loss bitwise equal with and without remat and K1/K3a/K3b per
    step equal. Prints each setting's s/step, peak memory, device ms and
    idle share of the traced step, what remat costs split into device and
    host time, and the RMS of the difference of step 1's gradients. The
    snapshots live on the host, so the peak memory is the step's own.
    Returns (the remat run's launches, counted from 0 over its steps;
    metrics)."""
    import torch

    t0 = time.perf_counter()
    state, step, batch, _ = train_setup(views=views)
    model = state.model
    unet = model["mvd"].unet
    torch.cuda.synchronize()
    n_train = sum(p.numel() for p in state.trainable.values())
    n_all = sum(p.numel() for p in model.parameters())
    print(f"[{tag}] built the train state ({n_all / 1e6:.1f} M params, {n_train / 1e6:.2f} M trainable, "
          f"f32 masters; frozen in bf16; batch {TRAIN_BATCH} of {views} view(s): {TRAIN_BATCH * views} "
          f"UNet rows at {TRAIN_RES}²) in {time.perf_counter() - t0:.1f} s")
    host = lambda t: t.detach().to("cpu", copy=True)
    frozen = {f"{net}.{n}": host(p) for net, m in model.items()
              for n, p in m.named_parameters() if not p.requires_grad}
    start = {n: host(p) for n, p in state.trainable.items()}
    opt0 = {k: ({i: {n: host(t) if torch.is_tensor(t) else t for n, t in st.items()}
                 for i, st in v.items()} if k == "state" else v)
            for k, v in state.optimizer.state_dict().items()}
    runs = {}
    for remat in (True, False):
        unet.cfg = dataclasses.replace(unet.cfg, remat=remat)
        with torch.no_grad():
            for n, p in state.trainable.items():
                p.copy_(start[n])
        state.optimizer.load_state_dict(opt0)
        state.step = state.updates = 0
        want = expected_train_launches(model)
        gen = torch.Generator("cuda").manual_seed(1)
        torch.cuda.empty_cache()
        if remat:
            reset_counts()
        times, losses, snaps = [], [], [start]
        for i in range(TRAIN_STEPS):
            if i == 1:
                torch.cuda.reset_peak_memory_stats()
            before, _ = read_counts()
            t1 = time.perf_counter()
            m = step(state, batch, generator=gen)
            loss, gnorm = m["noise_loss"].clone(), m["grad_norm/total"].item()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
            after, plain = read_counts()
            per_step = {k: after[k] - before[k] for k in after}
            losses.append(loss)
            print(f"[{tag}] remat {'on' if remat else 'off'}, step {i + 1}: {times[-1]:.3f} s, "
                  f"noise_loss {loss.item():.5f}, grad_norm/total {gnorm:.5g}, launches {per_step}")
            if per_step != want or any(plain.values()):
                raise AssertionError(f"{tag} step {i + 1} (remat {remat}): launches {per_step} != "
                                     f"expected {want}, or plain calls {plain}")
            if not (math.isfinite(loss.item()) and math.isfinite(gnorm)):
                raise AssertionError(f"{tag} step {i + 1} (remat {remat}): loss {loss.item()} or "
                                     f"gradient norm {gnorm} not finite")
            if i == 0:
                grads1 = {n: host(p.grad) for n, p in state.trainable.items()}
            if i < 2:
                snaps.append({n: host(p) for n, p in state.trainable.items()})
        peak = torch.cuda.max_memory_allocated() / 2**30
        if remat:
            launches, _ = read_counts()
        if any(not torch.equal(snaps[1][n], snaps[0][n]) for n in start):
            raise AssertionError(f"{tag} (remat {remat}): a trainable parameter moved in step 1, at lr 0")
        moved = sum(not torch.equal(snaps[2][n], snaps[1][n]) for n in start)
        if moved == 0:
            raise AssertionError(f"{tag} (remat {remat}): no trainable parameter moved in step 2")
        trace = trace_run(lambda: step(state, batch, generator=gen),
                          f"{tag} step, remat {'on' if remat else 'off'}", top=8)
        runs[remat] = dict(peak_gib=peak, step_s=times, losses=[x.item() for x in losses],
                           launches_per_step=want, moved=moved, trace=trace, grads1=grads1,
                           loss1=losses[0])
        print(f"[{tag}] remat {'on' if remat else 'off'}: peak memory {peak:.2f} GiB; step 2 moved {moved} "
              f"of {len(start)} trainable tensors; traced step: wall {trace['wall_ms']:.1f} ms, device "
              f"{trace['device_busy_ms']:.1f} ms, idle share {trace['idle_share']:.3f}")
    # s/step from steps taken in turns (on, off, off, on, ...): the host is
    # shared, and its load drifts across one setting's run
    turns = {True: [], False: []}
    for i in range(REMAT_TURNS):
        for remat in (True, False) if i % 2 == 0 else (False, True):
            unet.cfg = dataclasses.replace(unet.cfg, remat=remat)
            t1 = time.perf_counter()
            step(state, batch, generator=gen)["noise_loss"].item()
            torch.cuda.synchronize()
            turns[remat].append(time.perf_counter() - t1)
    for remat, r in runs.items():
        sec = statistics.median(turns[remat])
        r.update(sec_per_step=sec, samples_per_s=TRAIN_BATCH / sec, turns_s=turns[remat])
        print(f"[{tag}] remat {'on' if remat else 'off'}: {sec:.3f} s/step = {TRAIN_BATCH / sec:.3f} "
              f"samples/s (median of {REMAT_TURNS} steps in turns: {[round(t, 3) for t in turns[remat]]})")
    if any(not torch.equal(p.detach().cpu(), frozen[f"{net}.{n}"])
           for net, m in model.items() for n, p in m.named_parameters() if not p.requires_grad):
        raise AssertionError(f"{tag}: a frozen parameter changed")
    on, off = runs[True], runs[False]
    if not torch.equal(on["loss1"], off["loss1"]):
        raise AssertionError(f"{tag}: step 1's loss with remat {on['loss1'].item()!r} != without "
                             f"{off['loss1'].item()!r}")
    # the policy keeps the flash forward's (out, lse) unless it is "none"
    same = ("flash_attn_bwd_dq", "flash_attn_bwd_dkv") + (
        () if os.environ.get("MVD_REMAT_POLICY") == "none" else ("flash_attn_fwd",))
    for key in same:
        if on["launches_per_step"][key] != off["launches_per_step"][key]:
            raise AssertionError(f"{tag} {key}: {on['launches_per_step'][key]} a step with remat, "
                                 f"{off['launches_per_step'][key]} without")
    diffs = [(on["grads1"][n].float() - off["grads1"][n].float()).pow(2).mean().sqrt().item() for n in start]
    worst, n_differ = max(diffs), sum(d > 0 for d in diffs)
    d_wall = (on["sec_per_step"] - off["sec_per_step"]) * 1e3
    d_dev = on["trace"]["device_busy_ms"] - off["trace"]["device_busy_ms"]
    print(f"[{tag}] frozen params unchanged ({len(frozen)} tensors); step 1's loss bitwise equal with "
          f"and without remat ({on['loss1'].item():.6f}); K1/K3a/K3b per step equal; K2 "
          f"{on['launches_per_step']['groupnorm_silu']} with remat, {off['launches_per_step']['groupnorm_silu']} "
          f"without; step 1's gradients: {n_differ} of {len(diffs)} tensors differ, largest RMS "
          f"difference {worst:.3g}")
    print(f"[{tag}] remat costs {d_wall:+.1f} ms a step ({on['sec_per_step'] / off['sec_per_step'] - 1:+.1%}): "
          f"device {d_dev:+.1f} ms (traced: {off['trace']['device_busy_ms']:.1f} -> "
          f"{on['trace']['device_busy_ms']:.1f}), the rest {d_wall - d_dev:+.1f} ms host or idle; peak "
          f"memory {on['peak_gib']:.2f} GiB with remat, {off['peak_gib']:.2f} GiB without")
    for r in runs.values():
        del r["grads1"], r["loss1"]
    metrics = dict(remat_on=on, remat_off=off, grad_rms_diff_max=worst, grad_tensors_differing=n_differ,
                   remat_cost_ms=d_wall, remat_device_cost_ms=d_dev, phase_s=time.perf_counter() - t0)
    del state, step, batch, model, unet, frozen, start
    torch.cuda.empty_cache()
    return launches, metrics


CORPUS_OBJECTS, CORPUS_VIEWS, CORPUS_RES = 16, 4, 512
# the YAML phase 5 trains with and phase 8 builds its model from: the
# reference's config, whose settings are TrainConfig's defaults
TRAIN_YAML = os.path.join(os.path.dirname(os.path.abspath(__file__)), "config", "train_config.yaml")


def write_corpus(root: str, seed: int = 0, first: int = 0, count: int = CORPUS_OBJECTS, encode=None) -> int:
    """A seeded synthetic Objaverse corpus in the rendered-zip layout under
    ``root/renders_final``: smooth RGBA renders (a soft-edged disk of real
    alpha over transparent black) at CORPUS_RES², so the loader composites
    over white and resizes; a 4x4 ``.npy`` camera per view from
    ``orbit_cameras``; ``prompt.txt``. Writes objects ``first`` to
    ``first + count - 1``, each view's (H, W, 4) uint8 pixels as
    ``encode`` makes a PNG of them (default ``encode_png``: 8-bit RGBA);
    returns their bytes."""
    import io
    import zipfile

    import numpy as np

    from mvd_tpu_torch.camera import orbit_cameras
    from mvd_tpu_torch.utils.images import encode_png

    encode = encode or encode_png
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "renders_final"), exist_ok=True)
    yy, xx = np.mgrid[0:CORPUS_RES, 0:CORPUS_RES] / CORPUS_RES
    r = np.hypot(yy - 0.5, xx - 0.5)
    alpha = (np.clip((0.42 - r) / 0.04, 0.0, 1.0) * 255).round().astype(np.uint8)
    total = 0
    for i in range(first, first + count):
        path = os.path.join(root, "renders_final", f"obj_{i:03d}.zip")
        cams = orbit_cameras(CORPUS_VIEWS, start_azimuth_deg=float(rng.uniform(0, 360)))
        with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as z:
            for v in range(CORPUS_VIEWS):
                f, ph = rng.uniform(1, 4, 3), rng.uniform(0, 2 * np.pi, 3)
                rgb = [127.5 + 127.5 * np.sin(2 * np.pi * f[c] * (xx + (c + 1) * yy) + ph[c] + v)
                       for c in range(3)]
                rgba = np.stack(rgb + [alpha], -1).round().astype(np.uint8)
                z.writestr(f"{v:03d}.png", encode(rgba))
                buf = io.BytesIO()
                np.save(buf, cams[v].astype(np.float32))
                z.writestr(f"{v:03d}.npy", buf.getvalue())
            z.writestr("prompt.txt", f"a smooth test object number {i}")
        total += os.path.getsize(path)
    return total


class _Hooks:
    """Wraps methods for the length of a ``with`` block: ``wrap(owner,
    name, make)`` replaces ``owner.name`` by ``make(original)``."""

    def __init__(self):
        self._undo = []

    def wrap(self, owner, name, make):
        original = getattr(owner, name)
        self._undo.append((owner, name, original))
        setattr(owner, name, make(original))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for owner, name, original in reversed(self._undo):
            setattr(owner, name, original)


def counted_train_steps(per_call: list):
    """For ``_Hooks.wrap(loop, "make_train_step", ...)``: each step of the
    step function made appends (its launches, its plain calls, its noise
    loss, the model) to ``per_call``."""
    def wrap(make_step):
        def make(schedule, cfg, **kw):
            step = make_step(schedule, cfg, **kw)

            def run(state, batch, **k):
                before, _ = read_counts()
                out = step(state, batch, **k)
                after, plain = read_counts()
                per_call.append(({n: after[n] - before[n] for n in after}, plain,
                                 float(out["noise_loss"]), state.model))
                return out
            return run
        return make
    return wrap


def _state_snapshot(state) -> dict:
    """Copies, on the card, of what a checkpoint holds: the multi-view
    UNet's parameters and buffers, the AdamW state and the counts."""
    import torch

    params = {k: v.detach().clone() for k, v in state.model["mvd"].state_dict().items()}
    opt = {name: {k: (v.clone() if torch.is_tensor(v) else v)
                  for k, v in state.optimizer.state[p].items()}
           for name, p in state.trainable.items()}
    return dict(step=state.step, updates=state.updates, params=params, opt=opt)


def _assert_state_equal(state, snap: dict, what: str) -> None:
    import torch

    now = _state_snapshot(state)
    if (now["step"], now["updates"]) != (snap["step"], snap["updates"]):
        raise AssertionError(f"{what}: step {now['step']} / {now['updates']} updates, not "
                             f"{snap['step']} / {snap['updates']}")
    bad = [k for k, v in snap["params"].items()
           if v.dtype != now["params"][k].dtype or not torch.equal(v, now["params"][k])]
    bad += [f"adamw {n}.{k}" for n, st in snap["opt"].items() for k, v in st.items()
            if not torch.equal(torch.as_tensor(v), torch.as_tensor(now["opt"][n][k]))]
    if bad or now["params"].keys() != snap["params"].keys():
        raise AssertionError(f"{what}: {len(bad)} tensors differ, e.g. {bad[:5]}")


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def _records(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f]


def phase_train_entry(corpus: str, corpus_bytes: int, run_home: str, trace: bool = False):
    """Phase 5: ``python -m mvd_tpu_torch.cli.train --config
    config/train_config.yaml`` (the reference training point) on the
    synthetic corpus ``corpus`` (``write_corpus``), through ``main(argv)``
    in this process, its run dir under ``run_home``: (a) 3 steps with the
    reconstruction metrics at step 2, the end-of-run validation (eval loss,
    20-step generation, comparison PNGs) and the final checkpoint; (b)
    ``--resume`` to step 5; (c) ``cli.precompute_latents`` over the corpus,
    then 2 steps from the cache. Returns (the launches of run (a), metrics,
    the trace or None, the run dir of (a) and (b), which phase 8 reads)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from mvd_tpu_torch.checkpoint.io import CheckpointManager
    from mvd_tpu_torch.cli import precompute_latents
    from mvd_tpu_torch.cli import train as train_cli
    from mvd_tpu_torch.data.objaverse import _load_image_from_bytes
    from mvd_tpu_torch.nn.layers import GroupNorm
    from mvd_tpu_torch.train import loop
    from mvd_tpu_torch.train.loop import Trainer, fetch_metrics
    from mvd_tpu_torch.utils.images import decode_png

    t_phase = time.perf_counter()
    metrics, traced = {}, None
    tmp = tempfile.mkdtemp(prefix="mvd_train_entry_")
    try:
        import zipfile

        with zipfile.ZipFile(os.path.join(corpus, "renders_final", "obj_000.zip")) as z:
            pngs = [z.read(f"{v:03d}.png") for v in range(CORPUS_VIEWS)]
        t0 = time.perf_counter()
        for data in pngs * 2:
            _load_image_from_bytes(data, TRAIN_RES)
        decode_ms = (time.perf_counter() - t0) * 1e3 / (2 * len(pngs))
        t0 = time.perf_counter()
        for data in pngs * 2:
            decode_png(data, composite_alpha=True)
        png_ms = (time.perf_counter() - t0) * 1e3 / (2 * len(pngs))
        print(f"[train_entry] host ms per decoded {TRAIN_RES}² view (one thread): {decode_ms:.1f} "
              f"(PNG decode and white composite {png_ms:.1f}, the rest Lanczos {CORPUS_RES}² -> "
              f"{TRAIN_RES}² and scaling)")
        base = ["--config", TRAIN_YAML, "--dataset-path", corpus, "--batch-size", str(TRAIN_BATCH),
                "--image-size", str(TRAIN_RES)]
        timed = {"validate": [], "save": [], "restore": []}
        frozen_changed = []

        def timer(key):
            def make(fn):
                def run(*a, **k):
                    t = time.perf_counter()
                    out = fn(*a, **k)
                    torch.cuda.synchronize()
                    timed[key].append(time.perf_counter() - t)
                    return out
                return run
            return make

        def frozen_guard(fit):
            def run(self, *a, **k):
                frozen = {f"{net}.{n}": p.detach().clone() for net, m in self.state.model.items()
                          for n, p in m.named_parameters() if not p.requires_grad}
                out = fit(self, *a, **k)
                params = {f"{net}.{n}": p for net, m in self.state.model.items()
                          for n, p in m.named_parameters()}
                frozen_changed.extend(n for n, v in frozen.items() if not torch.equal(v, params[n]))
                frozen_changed.append(len(frozen))
                return out
            return run

        # (a) train and validate
        out_a = os.path.join(run_home, "out")
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        with _Hooks() as hooks:
            hooks.wrap(Trainer, "validate", timer("validate"))
            hooks.wrap(CheckpointManager, "save", timer("save"))
            hooks.wrap(Trainer, "fit", frozen_guard)
            tr = train_cli.main(base + ["--output-dir", out_a, "--max-steps", str(TRAIN_STEPS)],
                                metrics_log_interval=2)
        torch.cuda.synchronize()
        run_a_s = time.perf_counter() - t0
        launches, plain = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        per_step = expected_train_launches(tr.state.model)
        n_frozen = frozen_changed.pop()
        print(f"[train_entry] (a) cli.train.main --config config/train_config.yaml {' '.join(base[4:])} "
              f"--max-steps {TRAIN_STEPS}: "
              f"{run_a_s:.1f} s; launches {launches}; plain calls {plain}")
        if any(plain.values()):
            raise AssertionError(f"(a): plain versions ran: {plain}")
        for key in ("flash_attn_bwd_dq", "flash_attn_bwd_dkv"):
            if launches[key] != per_step[key] * TRAIN_STEPS:
                raise AssertionError(f"(a): {key} launched {launches[key]} times, not "
                                     f"{per_step[key]} x {TRAIN_STEPS}")
        if frozen_changed:
            raise AssertionError(f"(a): frozen parameters changed: {frozen_changed[:5]}")
        recs = _records(tr.logger.jsonl_path)
        steps = {r["step"]: r for r in recs if "train/noise_loss" in r}
        if sorted(steps) != list(range(1, TRAIN_STEPS + 1)):
            raise AssertionError(f"(a): train records at steps {sorted(steps)}")
        for s_, r in steps.items():
            if not math.isfinite(r["train/noise_loss"]) or r["train/lr"] != tr.state.lr_schedule(s_):
                raise AssertionError(f"(a) step {s_}: noise_loss {r['train/noise_loss']}, lr "
                                     f"{r['train/lr']} (schedule {tr.state.lr_schedule(s_)})")
        recon = [r for r in recs if "train/ssim_value" in r]
        val = [r for r in recs if "val/noise_loss" in r]
        if [r["step"] for r in recon] != [2] or len(val) != 1:
            raise AssertionError(f"(a): reconstruction metrics at {[r['step'] for r in recon]}, "
                                 f"{len(val)} validations")
        checks = {**{k: recon[0][k] for k in ("train/latent_recon_loss", "train/pixel_recon_loss",
                                              "train/ssim_value")},
                  **{k: val[0][k] for k in ("val/noise_loss", "val/gen_psnr", "val/gen_ssim",
                                            "val/gen_pixel_mse")}}
        if (not all(math.isfinite(v) for v in checks.values())
                or not all(-1 <= checks[k] <= 1 for k in ("train/ssim_value", "val/gen_ssim"))):
            raise AssertionError(f"(a): metrics {checks}")
        sheets = sorted(os.listdir(tr.dirs["comparisons"]))
        for name in sheets:
            with open(os.path.join(tr.dirs["comparisons"], name), "rb") as f:
                _check_png(f.read(), (TRAIN_RES, 3 * TRAIN_RES + 8, 3), f"(a) {name}")
        if sheets != ["epoch000_sample0.png", "epoch000_sample1.png"]:
            raise AssertionError(f"(a): comparison sheets {sheets}")
        ckpt_dir = os.path.join(tr.dirs["checkpoints"], str(TRAIN_STEPS))
        if tr.ckpt.all_steps() != [TRAIN_STEPS] or not os.path.isfile(os.path.join(ckpt_dir, "state.pt")):
            raise AssertionError(f"(a): checkpoints {tr.ckpt.all_steps()}")
        ckpt_bytes = _dir_bytes(ckpt_dir)
        times = [t["step_s"] for t in tr.timings]
        waits = [t["loader_wait_s"] for t in tr.timings]
        sec = sum(times[1:]) / len(times[1:])
        print(f"[train_entry] (a) train/noise_loss {[round(steps[s_]['train/noise_loss'], 5) for s_ in sorted(steps)]}, "
              f"train/lr {[steps[s_]['train/lr'] for s_ in sorted(steps)]} (the schedule's); "
              f"reconstruction at step 2 {json.dumps({k: round(v, 5) for k, v in checks.items()})}")
        print(f"[train_entry] (a) s per step {[round(t, 3) for t in times]}; loader wait per step "
              f"{[round(w, 3) for w in waits]} s; steps 2-{TRAIN_STEPS}: {sec:.3f} s/step = "
              f"{TRAIN_BATCH / sec:.3f} samples/s; validation {timed['validate'][0]:.2f} s; "
              f"checkpoint {ckpt_bytes} bytes saved in {timed['save'][0]:.2f} s; peak memory "
              f"{peak:.2f} GiB; {n_frozen} frozen tensors bitwise unchanged; comparison sheets "
              f"{sheets} decode to ({TRAIN_RES}, {3 * TRAIN_RES + 8}, 3)")
        # the loader alone at its steady state: 8 batches after 4 to fill
        # its prefetch, against the step it has to feed
        it = iter(tr.train_loader)
        for _ in range(4):
            next(it)
        t0 = time.perf_counter()
        for _ in range(8):
            next(it)
        loader_s = (time.perf_counter() - t0) / 8
        it.close()
        print(f"[train_entry] (a) the loader alone ({len(tr.train_loader)} batches an epoch, "
              f"{tr.train_loader.num_workers} threads on {os.cpu_count()} cores): {loader_s:.3f} s "
              f"per batch of {2 * TRAIN_BATCH} views against {sec:.3f} s per step")
        metrics["a"] = dict(run_s=run_a_s, sec_per_step=sec, samples_per_s=TRAIN_BATCH / sec,
                            loader_s_per_batch=loader_s,
                            step_s=times, loader_wait_s=waits, validation_s=timed["validate"][0],
                            checkpoint_bytes=ckpt_bytes, save_s=timed["save"][0], peak_gib=peak,
                            host_ms_per_view=decode_ms, png_decode_ms=png_ms,
                            corpus_bytes=corpus_bytes, launches=launches, metrics=checks)
        snap = _state_snapshot(tr.state)
        if trace:
            batch = next(iter(tr.train_loader))
            gen = torch.Generator("cuda").manual_seed(0)

            def one_step():
                m = tr.step_fn(tr.state, tr._put_batch(batch), generator=gen)
                tr.logger.log(fetch_metrics({k: v for k, v in m.items() if not k.startswith("hist/")}),
                              step=tr.state.step)

            one_step()  # warm, then trace one more
            traced = trace_run(one_step, "train entry step")
        run_root = tr.dirs["root"]
        del tr
        torch.cuda.empty_cache()

        # (b) resume to step 5
        restored = []

        def resume_guard(resume):
            def run(self, *a, **k):
                ok = resume(self, *a, **k)
                _assert_state_equal(self.state, snap, "(b) the restored state")
                restored.append(self.state.step)
                return ok
            return run

        reset_counts()
        t0 = time.perf_counter()
        with _Hooks() as hooks:
            hooks.wrap(Trainer, "resume", resume_guard)
            hooks.wrap(CheckpointManager, "restore", timer("restore"))
            hooks.wrap(CheckpointManager, "save", timer("save"))
            tr = train_cli.main(base + ["--output-dir", out_a, "--resume", run_root, "--max-steps", "5"],
                                metrics_log_interval=2, checkpoint_every_steps=2)
        torch.cuda.synchronize()
        run_b_s = time.perf_counter() - t0
        launches_b, plain_b = read_counts()
        took = [t["step"] for t in tr.timings]
        if restored != [TRAIN_STEPS] or took != [4, 5] or tr.state.step != 5:
            raise AssertionError(f"(b): restored {restored}, took steps {took}")
        for key in ("flash_attn_bwd_dq", "flash_attn_bwd_dkv"):
            if launches_b[key] != per_step[key] * 2 or any(plain_b.values()):
                raise AssertionError(f"(b): {key} launched {launches_b[key]}, plain {plain_b}")
        if tr.ckpt.all_steps() != [TRAIN_STEPS, 5]:
            raise AssertionError(f"(b): checkpoints kept {tr.ckpt.all_steps()}, not the latest (5) "
                                 f"plus the top k ({TRAIN_STEPS}: step 4 had no metric)")
        print(f"[train_entry] (b) --resume {os.path.basename(run_root)} --max-steps 5: restored step "
              f"{TRAIN_STEPS} with every parameter and the AdamW state bitwise the saved ones in "
              f"{timed['restore'][0]:.2f} s, took steps {took} in {run_b_s:.1f} s; checkpoints kept "
              f"{tr.ckpt.all_steps()} (saves {[round(t, 2) for t in timed['save'][1:]]} s)")
        metrics["b"] = dict(run_s=run_b_s, restore_s=timed["restore"][0], save_s=timed["save"][1:],
                            step_s=[t["step_s"] for t in tr.timings],
                            loader_wait_s=[t["loader_wait_s"] for t in tr.timings])
        del tr
        torch.cuda.empty_cache()

        # (c) the latent cache
        cache = os.path.join(tmp, "latents")
        t0 = time.perf_counter()
        stats = precompute_latents.main(["--dataset-path", corpus, "--image-size", str(TRAIN_RES),
                                         "--out", cache, "--compute-dtype", "bfloat16"])
        torch.cuda.synchronize()
        pre_s = time.perf_counter() - t0
        if stats != {"zips": CORPUS_OBJECTS, "views": CORPUS_OBJECTS * CORPUS_VIEWS, "skipped": 0}:
            raise AssertionError(f"(c): precompute {stats}")
        per_call = []
        torch.cuda.empty_cache()
        reset_counts()
        with _Hooks() as hooks:
            hooks.wrap(loop, "make_train_step", counted_train_steps(per_call))
            tr = train_cli.main(base + ["--output-dir", os.path.join(tmp, "out_c"), "--max-steps", "2",
                                        "--latent-cache-dir", cache], metrics_log_interval=0)
        # as expected_train_launches, without the VAE encoder's GroupNorms
        # of the source and the target encode
        want = expected_train_launches(per_call[0][3])
        enc_gn = 2 * sum(isinstance(m, GroupNorm) for m in per_call[0][3]["vae"].encoder.modules())
        want["groupnorm_silu"] -= enc_gn
        for i, (got, plain_c, loss, _) in enumerate(per_call):
            if got != want or any(plain_c.values()) or not math.isfinite(loss):
                raise AssertionError(f"(c) step {i + 1}: launches {got} (expected {want}), plain "
                                     f"{plain_c}, loss {loss}")
        times_c = [t["step_s"] for t in tr.timings]
        print(f"[train_entry] (c) cli.precompute_latents --image-size {TRAIN_RES} --compute-dtype "
              f"bfloat16: {stats['zips']} zips, {stats['views']} views in {pre_s:.1f} s; 2 steps from "
              f"the cache: launches per step {want} (the VAE encoder's {enc_gn} GroupNorms gone), "
              f"losses {[round(c[2], 5) for c in per_call]}; s per step {[round(t, 3) for t in times_c]} "
              f"(step 2 {times_c[1]:.3f} s from the cache against {sec:.3f} s from pixels); loader "
              f"wait {[round(t['loader_wait_s'], 3) for t in tr.timings]} s")
        metrics["c"] = dict(precompute_s=pre_s, step_s=times_c, launches_per_step=want,
                            loader_wait_s=[t["loader_wait_s"] for t in tr.timings])
        del tr, per_call
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    metrics["phase_s"] = time.perf_counter() - t_phase
    print(f"[train_entry] phase 5 in {metrics['phase_s']:.1f} s")
    return metrics["a"]["launches"], metrics, traced, run_root


# phase 6: joint multi-view attention (UNetConfig.num_views), views per
# sample of the joint train step and the joint train CLI; the CLI's batch
# (samples of 2 views), the largest whose validation split of the 16-object
# corpus holds a whole batch
JOINT_TRAIN_VIEWS, JOINT_ENTRY_BATCH = 2, 2


def phase_joint_kernels():
    """6a: the hand kernels at the joint self lengths (``JOINT_ATTN_CASES``):
    K1 at each, held to its plain version on batch row 0 (the plain
    version's f32 scores take 5.4 GB a row at S 16384), and K3a/K3b at the
    2-view 768² train length, held to the plain backward head by head on
    row 0; each timed at the full batch beside SDPA (forward, and backward
    for dq and for dk/dv) and its bound."""
    import torch
    import torch.nn.functional as F

    from mvd_tpu_torch.kernels import (
        attention_packed_plain,
        flash_attention_packed_bwd,
        flash_attention_packed_bwd_dkv,
        flash_attention_packed_bwd_dq,
        flash_attention_packed_fwd,
    )
    from mvd_tpu_torch.kernels.flash_attention import _delta
    from mvd_tpu_torch.kernels.measure import (
        JOINT_ATTN_CASES,
        attn_bounds,
        bwd_bounds,
        check_attention,
        check_grad,
        plain_bwd_by_row,
        sm_clock_hz,
        time_ms,
    )

    clock = sm_clock_hz()
    gen = torch.Generator("cuda").manual_seed(8)
    randn = lambda *s: torch.randn(s, generator=gen, device="cuda").bfloat16()
    results = {"flash_attn_fwd": [], "flash_attn_bwd_dq": [], "flash_attn_bwd_dkv": []}
    D = 64
    for label, B, Sq, Sk, H in JOINT_ATTN_CASES:
        q, k, v, do = randn(B, Sq, H * D), randn(B, Sk, H * D), randn(B, Sk, H * D), randn(B, Sq, H * D)
        out, lse = flash_attention_packed_fwd(q, k, v, H)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref_out, ref_lse = attention_packed_plain(q[:1], k[:1], v[:1], H)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err, rel_rms = check_attention(out[:1], lse[:1], ref_out, ref_lse, f"K1 {label} (row 0)")
        del ref_out, ref_lse
        torch.cuda.empty_cache()
        ms = time_ms(lambda: flash_attention_packed_fwd(q, k, v, H), 5)
        split = lambda t, n: t.detach().view(B, n, H, D).transpose(1, 2)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(split(q, Sq), split(k, Sk), split(v, Sk)), 5)
        results["flash_attn_fwd"].append(dict(
            case=label, max_abs_err=err, ms=ms, plain_ms=plain_ms, plain_rows=1, library_ms=lib_ms,
            rel_rms=rel_rms, **_attn_bound_fields(attn_bounds(B, Sq, Sk, H, clock), ms)))
        print(f"[joint-kernels] K1 {label} (B {B}): row 0 within tolerance of the plain version (err "
              f"{err:.3g}, rel RMS err {rel_rms:.3g}, plain {plain_ms:.1f} ms for the row); kernel "
              f"{ms:.4f} ms, sdpa {lib_ms:.4f} ms, " + _bound_text(results["flash_attn_fwd"][-1], clock))
        if label.startswith("joint self 2x"):  # the train length: the backward too
            got = flash_attention_packed_bwd(q, k, v, out, lse, do, H)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = plain_bwd_by_row(q[:1], k[:1], v[:1], out[:1], lse[:1], do[:1], H, by_head=True)
            torch.cuda.synchronize()
            plain_bwd_ms = (time.perf_counter() - t0) * 1e3
            checks = {n: check_grad(g[:1], w, f"K3 {label} {n} (row 0)")
                      for n, g, w in zip(("dq", "dk", "dv"), got, want)}
            del got, want
            torch.cuda.empty_cache()
            delta = _delta(out, do, H)
            ms_dq = time_ms(lambda: flash_attention_packed_bwd_dq(q, k, v, do, lse, delta, H), 5)
            ms_dkv = time_ms(lambda: flash_attention_packed_bwd_dkv(q, k, v, do, lse, delta, H), 5)

            def sdpa_bwd_ms(grad_q: bool):
                leaf = lambda t: t.detach().requires_grad_()
                qh, kh, vh = split(q, Sq), split(k, Sk), split(v, Sk)
                qh, kh, vh = (leaf(qh), kh, vh) if grad_q else (qh, leaf(kh), leaf(vh))
                oh = F.scaled_dot_product_attention(qh, kh, vh)
                inputs = (qh,) if grad_q else (kh, vh)
                return time_ms(lambda: torch.autograd.grad(oh, inputs, split(do, Sq), retain_graph=True), 5)

            lib_dq, lib_dkv = sdpa_bwd_ms(True), sdpa_bwd_ms(False)
            bounds = bwd_bounds(B, Sq, Sk, H)
            for key, part, kms, lib in (("flash_attn_bwd_dq", "dq", ms_dq, lib_dq),
                                        ("flash_attn_bwd_dkv", "dkv", ms_dkv, lib_dkv)):
                e = max(checks[n][0] for n in (("dq",) if part == "dq" else ("dk", "dv")))
                results[key].append(dict(
                    case=label, max_abs_err=e, ms=kms, plain_ms=plain_bwd_ms, plain_rows=1,
                    library_ms=lib, bound_ms=bounds[part]["bound_ms"], bound_by=bounds[part]["bound_by"],
                    bound_share=bounds[part]["bound_ms"] / kms))
            print(f"[joint-kernels] K3 {label} (B {B}): row 0 within tolerance of the plain backward "
                  f"(head by head, {plain_bwd_ms:.1f} ms; " + ", ".join(
                      f"{n} rel RMS err {r:.3g}" for n, (_, _, r) in checks.items())
                  + f"); K3a {ms_dq:.4f} ms (sdpa bwd dq {lib_dq:.4f} ms, bound "
                  f"{bounds['dq']['bound_ms']:.4f}), K3b {ms_dkv:.4f} ms (sdpa bwd dk,dv {lib_dkv:.4f} "
                  f"ms, bound {bounds['dkv']['bound_ms']:.4f}), shares of bound "
                  f"{bounds['dq']['bound_ms'] / ms_dq:.3f} / {bounds['dkv']['bound_ms'] / ms_dkv:.3f}")
            del delta
        del q, k, v, do, out, lse
        torch.cuda.empty_cache()
    return results


def phase_joint_generation(call, bf16_images):
    """6b and 6c, on phase 3's pipeline and weights (joint attention adds no
    parameter): the main path's call with ``num_views=4``, the 4 views
    attending to each other at every self site, with exactly the launches
    of the pairwise call (the views of a site merge into one launch), no
    plain call, the denoise loop under the sync check and images that
    differ from phase 3's; later calls of both timed in turns and one of
    each traced for device ms; then one joint call with
    ``attention_impl="int8"``, K6 and K6q at the sites the JAX package's
    routing gives at the merged lengths. Returns (the joint launches, the
    joint int8 launches, metrics)."""
    import torch

    from mvd_tpu_torch.parallel import for_view_sharding
    from mvd_tpu_torch.pipeline import MVDPipeline
    from mvd_tpu_torch.pipeline.pipeline import build_model

    pipe, prompts, kwargs = call
    t_phase = time.perf_counter()

    def pipeline(cfg):
        with torch.device("cuda"):
            model = build_model(cfg)
        model.load_state_dict(pipe.model.state_dict())
        out = MVDPipeline(cfg, model, "cuda", pipe.tokenizer)
        out.compute_model  # cast once, outside the counted run
        return out

    jcfg = for_view_sharding(pipe.config, VIEWS, 1)
    jpipe = pipeline(jcfg)
    want = expected_launches(jpipe, STEPS)
    if want != expected_launches(pipe, STEPS):
        raise AssertionError(f"joint launches {want} differ from the pairwise call's")
    out, first_s, launches = _counted_call(lambda: jpipe(prompts, seed=0, **kwargs), want,
                                           f"[joint] {VIEWS}-view joint generation:", ("denoise_loop",), jpipe)
    images = out["images"]
    _check_images(images, "joint")
    if torch.equal(images, bf16_images):
        raise AssertionError("joint images equal phase 3's: joint attention changed nothing")
    psnr = _psnr(images, bf16_images)
    turns = {"pairwise": [], "joint": []}
    for which in ("pairwise", "joint", "joint", "pairwise"):
        turns[which].append(_timed(lambda: (pipe if which == "pairwise" else jpipe)(prompts, seed=1, **kwargs)))
    traced = {which: trace_run(lambda: p(prompts, seed=2, **kwargs), f"{which} generation", top=3)
              for which, p in (("pairwise", pipe), ("joint", jpipe))}
    print(f"[joint] images {tuple(images.shape)} in [{images.min().item():.4f}, {images.max().item():.4f}]; "
          f"PSNR against phase 3's pairwise images (same weights and noise) {psnr:.2f} dB; later calls in "
          f"turns: pairwise {turns['pairwise'][0]:.3f} / {turns['pairwise'][1]:.3f} s, joint "
          f"{turns['joint'][0]:.3f} / {turns['joint'][1]:.3f} s per call; device ms pairwise "
          f"{traced['pairwise']['device_busy_ms']:.1f}, joint {traced['joint']['device_busy_ms']:.1f}")
    metrics = dict(first_call_s=first_s, psnr_vs_pairwise_db=psnr, turns_s=turns, launches=launches,
                   device_ms={w: t["device_busy_ms"] for w, t in traced.items()},
                   idle_share={w: t["idle_share"] for w, t in traced.items()},
                   k1_device_ms={w: t["port_kernels_ms"]["K1 flash_fwd (packed)"] for w, t in traced.items()})
    del jpipe, out
    torch.cuda.empty_cache()

    icfg = dataclasses.replace(jcfg, unet=dataclasses.replace(jcfg.unet, attention_impl="int8"))
    pipe8 = pipeline(icfg)
    out8, int8_s, launches8 = _counted_call(lambda: pipe8(prompts, seed=0, **kwargs),
                                            expected_int8_launches(pipe8, STEPS), "[joint] int8 joint generation:")
    _check_images(out8["images"], "joint int8")
    psnr8 = _psnr(out8["images"], images)
    print(f"[joint] int8: K6 at {launches8['flash_attn_int8']} sites (the merged 16² self sites among "
          f"them), images against the bf16 joint call's {psnr8:.2f} dB")
    metrics.update(int8_first_call_s=int8_s, int8_psnr_vs_bf16_joint_db=psnr8, int8_launches=launches8,
                   phase_s=time.perf_counter() - t_phase)
    del pipe8, out8
    torch.cuda.empty_cache()
    return launches, launches8, metrics


def phase_joint_train_entry(corpus: str):
    """6e: ``cli.train.main --num-views 2`` on phase 5's corpus at 768²,
    batch JOINT_ENTRY_BATCH: 2 steps and the end-of-run validation (eval
    loss, the 20-step generation of one joint group); finite metrics,
    K3a/K3b exactly their per-step count twice, no plain call."""
    import shutil
    import tempfile

    import torch

    from mvd_tpu_torch.cli import train as train_cli

    t0 = time.perf_counter()
    out = tempfile.mkdtemp(prefix="mvd_joint_entry_")
    try:
        reset_counts()
        tr = train_cli.main(["--dataset-path", corpus, "--batch-size", str(JOINT_ENTRY_BATCH), "--image-size",
                             str(TRAIN_RES), "--num-views", str(JOINT_TRAIN_VIEWS), "--output-dir", out,
                             "--max-steps", "2"], metrics_log_interval=0)
        torch.cuda.synchronize()
        launches, plain = read_counts()
        per_step = expected_train_launches(tr.state.model)
        if tr.cfg.model.unet.num_views != JOINT_TRAIN_VIEWS or any(plain.values()):
            raise AssertionError(f"joint CLI: num_views {tr.cfg.model.unet.num_views}, plain calls {plain}")
        for key in ("flash_attn_bwd_dq", "flash_attn_bwd_dkv"):
            if launches[key] != per_step[key] * 2:
                raise AssertionError(f"joint CLI: {key} launched {launches[key]}, not {per_step[key]} x 2")
        recs = _records(tr.logger.jsonl_path)
        steps = {r["step"]: r["train/noise_loss"] for r in recs if "train/noise_loss" in r}
        val = [r for r in recs if "val/noise_loss" in r]
        keys = ("val/noise_loss", "val/gen_psnr", "val/gen_ssim", "val/gen_pixel_mse")
        if sorted(steps) != [1, 2] or len(val) != 1 or not all(
                math.isfinite(x) for x in list(steps.values()) + [val[0][k] for k in keys]):
            raise AssertionError(f"joint CLI: train losses {steps}, validations {val}")
        secs = time.perf_counter() - t0
        print(f"[joint-entry] cli.train.main --num-views {JOINT_TRAIN_VIEWS} --batch-size {JOINT_ENTRY_BATCH} "
              f"--max-steps 2: train/noise_loss {steps}, validation "
              f"{json.dumps({k: round(val[0][k], 5) for k in keys})}; K3a {launches['flash_attn_bwd_dq']} "
              f"and K3b {launches['flash_attn_bwd_dkv']} (2 x {per_step['flash_attn_bwd_dq']} / "
              f"{per_step['flash_attn_bwd_dkv']}), 0 plain calls; s per step "
              f"{[round(t['step_s'], 3) for t in tr.timings]}; {secs:.1f} s")
        metrics = dict(run_s=secs, step_s=[t["step_s"] for t in tr.timings], train_losses=steps,
                       validation={k: val[0][k] for k in keys}, launches=launches)
        del tr
    finally:
        shutil.rmtree(out, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches, metrics


# phase 8: the validation CLI (cli/val.py) at its defaults (768², batch 4,
# 20 DDPM steps, guidance 1.0, ref_scale 0.1) on phase 5's run dir and
# corpus, two whole batches, with all four metric towers
VAL_SAMPLES, VAL_BATCH, VAL_STEPS = 8, 4, 20
# the JAX harness's CSV columns, in its order
VAL_RESULT_COLUMNS = ["batch", "sample", "psnr", "ssim", "mse", "inference_time_s", "perceptual",
                      "lpips", "clip_score"]
VAL_OVERALL_ROWS = (["num_samples", "fid", "perceptual_mean", "lpips_mean", "clip_score_mean"]
                    + [f"{k}_{s}" for k in ("psnr", "ssim", "mse") for s in ("mean", "std", "min", "max")]
                    + ["batch_time_mean_s", "batch_time_std_s", "batch_time_min_s", "batch_time_max_s",
                       "total_inference_s", "img_per_sec"])
# a tower on the card against the same tower on the CPU, both f32: the
# perceptual, LPIPS and CLIP scores within this relative error, the
# Inception pool3 features within this relative RMS error
TOWER_RTOL = 1e-4
# the public layouts: torchvision vgg16 (config "D") and alexnet features
# (index, in, out, kernel), CLIP ViT-L/14 at 224 (torchmetrics' CLIPScore
# default)
TV_VGG16 = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512, "M"]
TV_ALEX = [(0, 3, 64, 11), (3, 64, 192, 5), (6, 192, 384, 3), (8, 384, 256, 3), (10, 256, 256, 3)]
CLIP_L14 = dict(hidden=1024, layers=24, inter=4096, proj=768, patch=14, image=224)


def write_tower_weights(directory: str) -> dict:
    """Random full-width weights of the four metric towers in their public
    state-dict layouts, written to ``directory``: torchvision ``vgg16``
    (``features.N`` and the ``classifier``, which the loader ignores), an
    lpips-alex file (the AlexNet trunk under ``net.``, ``lin0``-``lin4``),
    a transformers ``CLIPVisionModelWithProjection`` of CLIP ViT-L/14 and a
    pytorch-fid InceptionV3 (with its ``fc`` head and
    ``num_batches_tracked``). He-normal convolutions, 1/sqrt(fan_in) linear
    layers, unit norms and running variance 1, so activations stay finite.
    Returns {the val CLI's flag: path}."""
    import torch

    from mvd_tpu_torch.metrics.inception import InceptionV3Features

    gen = torch.Generator("cuda").manual_seed(0)

    def normal(shape, std):
        return (torch.randn(shape, generator=gen, device="cuda") * std).cpu()

    def he(shape):
        return normal(shape, math.sqrt(2.0 / math.prod(shape[1:])))

    def linear(sd, name, n_out, n_in, bias=True):
        sd[f"{name}.weight"] = normal((n_out, n_in), n_in**-0.5)
        if bias:
            sd[f"{name}.bias"] = torch.zeros(n_out)

    def norm(sd, name, n):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = torch.ones(n), torch.zeros(n)

    vgg, in_ch, tv = {}, 3, 0
    for c in TV_VGG16:
        if c == "M":
            tv += 1
            continue
        vgg[f"features.{tv}.weight"], vgg[f"features.{tv}.bias"] = he((c, in_ch, 3, 3)), torch.zeros(c)
        in_ch, tv = c, tv + 2
    for i, (n_out, n_in) in zip((0, 3, 6), ((4096, 512 * 7 * 7), (4096, 4096), (1000, 4096))):
        linear(vgg, f"classifier.{i}", n_out, n_in)

    alex = {}
    for i, (idx, n_in, n_out, k) in enumerate(TV_ALEX):
        alex[f"net.features.{idx}.weight"], alex[f"net.features.{idx}.bias"] = he((n_out, n_in, k, k)), torch.zeros(n_out)
        alex[f"lin{i}.model.1.weight"] = (0.1 * torch.rand((1, n_out, 1, 1), generator=gen, device="cuda")).cpu()

    D, P, inter = CLIP_L14["hidden"], CLIP_L14["patch"], CLIP_L14["inter"]
    e = "vision_model.embeddings."
    clip = {e + "class_embedding": normal((D,), 1.0), e + "patch_embedding.weight": normal((D, 3, P, P), (3 * P * P) ** -0.5),
            e + "position_embedding.weight": normal((1 + (CLIP_L14["image"] // P) ** 2, D), 0.02)}
    norm(clip, "vision_model.pre_layrnorm", D)
    norm(clip, "vision_model.post_layernorm", D)
    for i in range(CLIP_L14["layers"]):
        pre = f"vision_model.encoder.layers.{i}."
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            linear(clip, pre + "self_attn." + n, D, D)
        norm(clip, pre + "layer_norm1", D)
        norm(clip, pre + "layer_norm2", D)
        linear(clip, pre + "mlp.fc1", inter, D)
        linear(clip, pre + "mlp.fc2", D, inter)
    linear(clip, "visual_projection", CLIP_L14["proj"], D, bias=False)

    inception = {}
    for name, t in InceptionV3Features().state_dict().items():
        if name.endswith("conv.weight"):
            inception[name] = he(tuple(t.shape))
        elif name.endswith(("bn.weight", "running_var")):
            inception[name] = torch.ones(t.shape)
        else:
            inception[name] = torch.zeros(t.shape)
        if name.endswith("running_var"):
            inception[name.replace("running_var", "num_batches_tracked")] = torch.tensor(0)
    linear(inception, "fc", 1008, 2048)

    files = {}
    for flag, name, sd in (("--vgg-weights", "vgg16.pth", vgg), ("--lpips-weights", "lpips_alex.pth", alex),
                           ("--clip-vision-weights", "clip_vit_l14.bin", clip),
                           ("--inception-weights", "pt_inception.pth", inception)):
        files[flag] = os.path.join(directory, name)
        torch.save(sd, files[flag])
    return files


def _read_csv(path: str) -> list:
    import csv

    with open(path, newline="") as f:
        return list(csv.reader(f))


def phase_val(corpus: str, run_root: str, card: str):
    """Phase 8: ``python -m mvd_tpu_torch.cli.val`` through ``main(argv)`` in
    this process, at the CLI's defaults (768², batch 4, 20 DDPM steps) on
    phase 5's corpus (objects added until its test split holds two whole
    batches) and run dir, with the YAML phase 5 trained with and random
    full-width weight files of all four towers. Checks: the restored step
    is phase 5's latest and the multi-view UNet bitwise that checkpoint's;
    per batch K1 and K2 exactly ``expected_launches(pipe, 20)`` and no
    plain call; the towers launch no hand kernel; both CSVs have the JAX
    harness's columns in its order, finite values, SSIM in [-1, 1], LPIPS
    >= 0, |clip_score| <= 100; two image pairs of the last batch scored by
    each tower on the card and on the CPU agree within TOWER_RTOL (FID from
    both printed, without a bar). Returns (the launches of one batch,
    metrics)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from mvd_tpu_torch.checkpoint import CheckpointManager
    from mvd_tpu_torch.cli import val as val_cli
    from mvd_tpu_torch.data.objaverse import ObjaverseDataset
    from mvd_tpu_torch.metrics import fid as fid_mod
    from mvd_tpu_torch.metrics import load_towers as towers_mod
    from mvd_tpu_torch.metrics import towers as tw
    from mvd_tpu_torch.pipeline import MVDPipeline

    t_phase = time.perf_counter()
    added = 0
    while len(ObjaverseDataset(corpus, "test", image_size=TRAIN_RES)) < VAL_SAMPLES:
        write_corpus(corpus, seed=1 + added, first=CORPUS_OBJECTS + added, count=4)
        added += 4
    tmp = tempfile.mkdtemp(prefix="mvd_val_")
    try:
        t0 = time.perf_counter()
        weights = write_tower_weights(tmp)
        weights_s = time.perf_counter() - t0
        weight_bytes = {flag: os.path.getsize(p) for flag, p in weights.items()}
        latest = CheckpointManager(os.path.join(run_root, "checkpoints")).latest_step()
        out = os.path.join(tmp, "out")
        restored, per_batch, tower_ms, captured, last_pair = [], [], {}, {}, {}

        def on_restore(fn):
            def run(*a, **k):
                restored.append(fn(*a, **k))
                return restored[-1]
            return run

        def counted(call):
            def run(self, *a, **k):
                reset_counts()
                images = call(self, *a, **k)
                torch.cuda.synchronize()
                per_batch.append((*read_counts(), expected_launches(self, VAL_STEPS)))
                return images
            return run

        def capture(load):
            def run(*a, **k):
                captured["towers"] = load(*a, **k)
                return captured["towers"]
            return run

        def timed(name, keep=False):
            def make(fn):
                def run(*a, **k):
                    if keep:
                        last_pair["a"], last_pair["b"] = a[1], a[2]
                    before = read_counts()
                    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    start.record()
                    result = fn(*a, **k)
                    end.record()
                    torch.cuda.synchronize()
                    if read_counts() != before:
                        raise AssertionError(f"the {name} tower launched a hand kernel or a plain version")
                    tower_ms.setdefault(name, []).append(start.elapsed_time(end))
                    return result
                return run
            return make

        argv = ["--config", TRAIN_YAML, "--checkpoint", run_root, "--dataset-path", corpus,
                "--num-samples", str(VAL_SAMPLES), "--batch-size", str(VAL_BATCH),
                "--num-steps", str(VAL_STEPS), "--output-dir", out]
        argv += [x for flag_path in weights.items() for x in flag_path]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with _Hooks() as hooks:
            hooks.wrap(val_cli, "_restore_run_dir", on_restore)
            hooks.wrap(MVDPipeline, "__call__", counted)
            hooks.wrap(towers_mod, "load_towers", capture)
            hooks.wrap(tw.PerceptualLoss, "__call__", timed("perceptual", keep=True))
            hooks.wrap(tw.LPIPS, "__call__", timed("lpips"))
            hooks.wrap(tw.CLIPImageScore, "__call__", timed("clip"))
            hooks.wrap(fid_mod.FID, "update", timed("fid"))
            pipe, overall = val_cli.main(argv)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30

        # the run dir's latest step, bitwise
        if latest != 5 or restored != [latest]:
            raise AssertionError(f"restored steps {restored}, phase 5's latest is {latest}")
        saved = torch.load(os.path.join(run_root, "checkpoints", str(latest), "state.pt"),
                           map_location="cuda", weights_only=True)["params"]
        now = pipe.model["mvd"].state_dict()
        bad = [k for k, v in saved.items()
               if k not in now or now[k].dtype != v.dtype or not torch.equal(now[k], v)]
        if bad or now.keys() != saved.keys():
            raise AssertionError(f"the restored multi-view UNet differs from step {latest}: {bad[:5]}")
        n_params = len(saved)
        del saved, now

        # K1 and K2 per batch, nothing else
        n_batches = VAL_SAMPLES // VAL_BATCH
        if len(per_batch) != n_batches:
            raise AssertionError(f"{len(per_batch)} generations, expected {n_batches}")
        for i, (launches, plain, want) in enumerate(per_batch):
            if launches != want or any(plain.values()):
                raise AssertionError(f"batch {i}: launches {launches} (expected {want}), plain {plain}")
        if sorted(tower_ms) != ["clip", "fid", "lpips", "perceptual"] or any(
                len(v) != n_batches * (2 if k == "fid" else 1) for k, v in tower_ms.items()):
            raise AssertionError(f"tower calls {({k: len(v) for k, v in tower_ms.items()})}")

        # both CSVs: the JAX harness's columns, in range
        rows = _read_csv(os.path.join(out, "validation_results.csv"))
        table = _read_csv(os.path.join(out, "overall_metrics.csv"))
        if rows[0] != VAL_RESULT_COLUMNS or len(rows) != 1 + VAL_SAMPLES:
            raise AssertionError(f"validation_results.csv: columns {rows[0]}, {len(rows) - 1} rows")
        if table[0] != ["metric", "value"] or [r[0] for r in table[1:]] != VAL_OVERALL_ROWS:
            raise AssertionError(f"overall_metrics.csv rows {[r[0] for r in table]}")
        per_sample = {name: [float(r[i]) for r in rows[1:]] for i, name in enumerate(rows[0])}
        values = [v for vs in per_sample.values() for v in vs] + [float(r[1]) for r in table[1:]]
        if (not all(math.isfinite(v) for v in values)
                or not all(-1 <= v <= 1 for v in per_sample["ssim"])
                or min(per_sample["lpips"]) < 0 or max(abs(v) for v in per_sample["clip_score"]) > 100):
            raise AssertionError(f"CSV values out of range: {per_sample}")

        # two pairs of the last batch, each tower on the card and on the CPU
        towers = captured["towers"]
        a, b = last_pair["a"][:2], last_pair["b"][:2]  # generations, targets in [-1, 1]
        a01, b01 = (a + 1) / 2, (b + 1) / 2

        def score(dev):
            to = lambda t: t.to(dev)
            feats = towers["fid"].extractor(torch.cat([to(b01), to(a01)]))
            return dict(perceptual=float(towers["perceptual"](to(a), to(b))),
                        lpips=float(towers["lpips"](to(a), to(b))),
                        clip_score=float(towers["clip"](to(a01), to(b01))), feats=feats)

        t0 = time.perf_counter()
        on_card = score("cuda")
        on_cpu = score("cpu")
        cpu_s = time.perf_counter() - t0
        agree = {k: abs(on_card[k] - on_cpu[k]) / abs(on_cpu[k]) for k in ("perceptual", "lpips", "clip_score")}
        fc, fp = on_card.pop("feats").astype(np.float64), on_cpu.pop("feats").astype(np.float64)
        agree["inception_rel_rms"] = float(np.linalg.norm(fc - fp) / np.linalg.norm(fp))
        if not all(v <= TOWER_RTOL for v in agree.values()):
            raise AssertionError(f"the towers on the card and on the CPU differ: {agree} > {TOWER_RTOL}")

        def fid_of(feats):
            real, fake = fid_mod.RunningMoments(feats.shape[1]), fid_mod.RunningMoments(feats.shape[1])
            real.update(feats[:2])
            fake.update(feats[2:])
            return fid_mod.frechet_distance(real.mean, real.cov, fake.mean, fake.cov)

        fid_card, fid_cpu = fid_of(fc), fid_of(fp)
        del pipe, towers, captured, last_pair
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    ms = {k: (sum(v[-2:]) if k == "fid" else v[-1]) for k, v in tower_ms.items()}
    metrics = dict(
        run_s=run_s, sec_per_batch=overall["batch_time_mean_s"], img_per_s=overall["img_per_sec"],
        tower_ms_per_batch=ms, tower_ms_calls=tower_ms, peak_gib=peak, restored_step=latest,
        mvd_tensors_bitwise=n_params, launches_per_batch=per_batch[0][0], objects_added=added,
        overall={k: v for k, v in overall.items()}, card_vs_cpu=agree, fid_card=fid_card,
        fid_cpu=fid_cpu, card_cpu_s=cpu_s, weights_s=weights_s, weight_bytes=weight_bytes)
    metrics["phase_s"] = time.perf_counter() - t_phase
    print(f"[val] cli.val.main --config config/train_config.yaml --checkpoint <phase 5's run dir> "
          f"--num-samples {VAL_SAMPLES} --batch-size {VAL_BATCH} --num-steps {VAL_STEPS} (768²) with "
          f"all four towers: {run_s:.1f} s ({card}); restored step {latest}, {n_params} tensors of the "
          f"multi-view UNet bitwise the checkpoint's; per batch launches {per_batch[0][0]} (expected "
          f"{per_batch[0][2]}), no plain call, no launch in a tower; {added} objects added to the "
          f"corpus for two test batches")
    print(f"[val] overall_metrics.csv {json.dumps({r[0]: r[1] for r in table[1:]})}")
    print(f"[val] second batch {overall['batch_time_mean_s']:.3f} s = {overall['img_per_sec']:.3f} img/s "
          f"at 768²; tower device ms per batch of {VAL_BATCH} (CUDA events, last batch) "
          f"{json.dumps({k: round(v, 3) for k, v in ms.items()})}; peak memory {peak:.2f} GiB; "
          f"tower files {weight_bytes} bytes written in {weights_s:.1f} s ({card})")
    print(f"[val] card against CPU on two pairs of the last batch (f32): {json.dumps(agree)} (bar "
          f"{TOWER_RTOL}); FID of those 2 + 2 images from the card {fid_card:.6g}, from the CPU "
          f"{fid_cpu:.6g} (no bar: 2048-wide covariances of 2 samples); {cpu_s:.1f} s ({card})")
    print(f"[val] phase 8 in {metrics['phase_s']:.1f} s ({card})")
    return per_batch[0][0], metrics


# phase 9: the image readers on the host. The JPEG fixtures and PIL's
# digests of them (tests/fixtures/torch_port_jpeg/make_fixtures.py); the
# CO3D-layout corpus copies the two CO3D-sized frames into
# CO3D_SEQUENCES x CO3D_FRAMES frames (under 10 sequences: no val split)
JPEG_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures",
                             "torch_port_jpeg")
IMAGE_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures",
                              "torch_port_images")
CO3D_FRAMES_SRC = ("frame_a.jpg", "frame_b.jpg")
PROG_SOURCE = "frame_a_prog.jpg"  # frame_a.jpg's frame written progressive by PIL
SMOOTH_SOURCE = "frame_a_smooth.jpg"  # its pixels as a progressive JPEG libjpeg block-smooths
# its pixels as lossy WebP at quality 90, and a 512² procedural render as
# lossless RGBA WebP (exact: its own pixels) and as lossy WebP with alpha
WEBP_SOURCES = {"lossy WebP": "webp_frame_a_q90.webp", "lossless RGBA WebP (512² render)": "webp_render_lossless.webp",
                "lossy WebP with alpha (512² render)": "webp_render_alpha.webp"}
# (e): 16-bit interlaced renders; under 10 objects, so no val split
DEEP_OBJECTS, DEEP_STEPS, DECODE_TURNS = 9, 2, 5
CO3D_SEQUENCES, CO3D_FRAMES, CO3D_STEPS, NATIVE_STEPS = 9, 4, 3, 2
NATIVE_TOL = 5e-7  # the C++ reader against its numpy plain version (the tests: bitwise)
READER_TURNS, LOADER_BATCHES = 3, 4


def fixture_digests() -> dict:
    """name -> {"sha256", "shape"} of PIL's pixels of each sequential JPEG
    fixture."""
    with open(os.path.join(JPEG_FIXTURES, "pil_sha256.json")) as f:
        return json.load(f)


def image_digests() -> dict:
    """name -> PIL's mode, the sha256 and shape of its pixels (and of the
    loaders' white composite where the mode is RGBA) of each progressive,
    block-smoothed, arithmetic-coded, lossless, CMYK/YCCK and PNG fixture."""
    with open(os.path.join(IMAGE_FIXTURES, "pil_sha256.json")) as f:
        return json.load(f)


def image_fixture_script(name: str = "make_fixtures"):
    """``tests/fixtures/torch_port_images/make_fixtures.py``, whose
    ``encode_png`` (any depth, Adam7, a filter type per row) needs no PIL,
    or (``name`` "make_formats") its GIF, BMP and TIFF writers, which need
    none either."""
    spec = importlib.util.spec_from_file_location(f"torch_port_images_{name}",
                                                  os.path.join(IMAGE_FIXTURES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def codec_digests() -> dict:
    """PIL's digests of the APNG fixtures ("apng") and of phase 9d's
    TIFF-codec and APNG sources ("frames": ``frame_codec_forms`` of CO3D's
    frame and the 512² render; the fault-13 TIFF's read by path too)."""
    with open(os.path.join(IMAGE_FIXTURES, "codecs_sha256.json")) as f:
        return json.load(f)


FAULT13_SOURCE = "fault-13 TIFF (raw RGBA, orientation 6)"
# 9d's sources in PIL's small formats (``make_small_formats.py``'s
# ``frame_small_forms``): each decoded to PIL's digest and timed; these three
# are generated from, and TGA is uploaded to the server
SMALL_GENERATED = ("TGA RLE (bottom-up)", "PSD PackBits", "DDS BC7")


def small_format_digests() -> dict:
    """PIL's digests of the PPM/PGM/PBM/PFM, TGA, ICO/CUR, QOI, PCX, SGI,
    PSD and DDS fixtures ("files": mode, sha256 and shape, the white
    composite of an RGBA image, or PIL's refusal) and of 9d's sources in
    those formats ("frames")."""
    with open(os.path.join(IMAGE_FIXTURES, "small_formats_sha256.json")) as f:
        return json.load(f)


def format_digests() -> dict:
    """name -> PIL's mode and the sha256 and shape of its pixels (and of
    the white composite where the mode is RGBA), or PIL's refusal, of each
    GIF, BMP/DIB and TIFF fixture (``make_formats.py``)."""
    with open(os.path.join(IMAGE_FIXTURES, "formats_sha256.json")) as f:
        return json.load(f)


def png16_encoder(seed: int):
    """(H, W, 4) uint8 -> a 16-bit Adam7 RGBA PNG whose high bytes are the
    pixels and whose low bytes are seeded noise, a seeded filter type a row
    (the form Blender can write, interlaced)."""
    import numpy as np

    fx, rng = image_fixture_script(), np.random.default_rng(seed)

    def encode(rgba):
        samples = (rgba.astype(np.int64) << 8) | rng.integers(0, 256, rgba.shape)
        return fx.encode_png(samples, 16, 6, interlace=1, filters=rng)

    return encode


def write_co3d_corpus(root: str, seed: int = 0) -> int:
    """A CO3D-layout corpus (``<root>/teddybear/frame_annotations.jgz``,
    ``<root>/teddybear/seqNNN/images/frameNNNNNN.jpg``): the fixture frames
    copied into every sequence in turn, each frame with its own seeded
    PyTorch3D viewpoint. Returns the bytes of its frames."""
    import gzip

    import numpy as np

    rng = np.random.default_rng(seed)
    cat = os.path.join(root, "teddybear")
    anns, total = [], 0
    for s in range(CO3D_SEQUENCES):
        seq = f"seq{s:03d}"
        os.makedirs(os.path.join(cat, seq, "images"))
        for f in range(CO3D_FRAMES):
            rel = os.path.join("teddybear", seq, "images", f"frame{f + 1:06d}.jpg")
            shutil.copyfile(os.path.join(JPEG_FIXTURES, CO3D_FRAMES_SRC[(s + f) % 2]),
                            os.path.join(root, rel))
            total += os.path.getsize(os.path.join(root, rel))
            q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
            q[:, 0] *= np.sign(np.linalg.det(q))
            anns.append({"sequence_name": seq, "frame_number": f,
                         "image": {"path": rel, "size": [800, 1067]},
                         "viewpoint": {"R": q.tolist(), "T": rng.standard_normal(3).tolist(),
                                       "focal_length": [1.5, 1.5], "principal_point": [0.0, 0.0]}})
    with gzip.open(os.path.join(cat, "frame_annotations.jgz"), "wt") as f:
        json.dump(anns, f)
    return total


def _train_records(tr, steps: int, what: str) -> list:
    """The run's train/noise_loss at steps 1..steps, each finite."""
    recs = {r["step"]: r["train/noise_loss"] for r in _records(tr.logger.jsonl_path)
            if "train/noise_loss" in r}
    if sorted(recs) != list(range(1, steps + 1)) or not all(math.isfinite(v) for v in recs.values()):
        raise AssertionError(f"{what}: train/noise_loss {recs}")
    return [recs[s] for s in sorted(recs)]


def _join_loader_threads(timeout: float = 60.0) -> None:
    """Wait for the loader threads that a closed loader leaves finishing
    their batch, so that they read no file that is gone and load no later
    phase's host."""
    import threading

    for th in threading.enumerate():
        if th.name.startswith("mvd-loader"):
            th.join(timeout)


def _loader_s_per_batch(loader, batches: int = LOADER_BATCHES) -> float:
    """Seconds a batch of ``loader``: its first ``batches`` from the start
    over their count. The loader keeps ``prefetch`` (4) batches in flight,
    one a thread, so its first 4 arrive together at its steady rate."""
    t0 = time.perf_counter()
    it = iter(loader)
    try:
        for _ in range(batches):
            next(it)
        return (time.perf_counter() - t0) / batches
    finally:
        it.close()
        _join_loader_threads()


def frame_sources() -> dict:
    """CO3D's 1067x800 frame (``frame_a.jpg``) and a 512² render as phase
    9d's sources: form -> (file bytes, the sha256 its RGB decode must have,
    whose pixels those are). The progressive and block-smoothed JPEGs and
    the WebP files (``WEBP_SOURCES``) are fixtures with PIL's digests (the
    lossless WebP's RGBA decode must also be its render's own pixels); the
    arithmetic-coded (SOF9, 4:2:0, IJG quality 85) and lossless (SOF3, RGB)
    JPEGs are written here by the fixture script's ``frame_forms`` from the
    frame's pixels, as a host without PIL can: the first must decode to its
    Huffman twin's pixels (the same coefficients), the second to the
    frame's pixels. The GIF, BMP and TIFF sources are written here by
    ``make_formats.py``'s ``frame_formats`` from the frame and from the
    lossless WebP's render: each must decode to the pixels it was written
    from (a GIF or RLE8 BMP its quantized palette expanded). Its
    ``frame_codec_forms`` writes JPEG-in-TIFF (4:2:0 strips with
    JPEGTables, and tiles), LZMA, LAB, YCbCr under LZW, old-style JPEG and
    APNG sources, and the fault-13 TIFF; the zstd TIFF is the fixture
    ``frame_a_zstd.tif``, whose blocks the ``zstandard`` module compressed
    (this host has no zstd writer). Each must decode to PIL's digest of the
    same pixels (``codecs_sha256.json``; LZMA written by this host's
    liblzma). ``make_small_formats.py``'s ``frame_small_forms`` writes the
    frame as PPM P6, PFM, TGA RLE, QOI, PCX, SGI RLE, PSD PackBits, DDS BC1
    and DDS BC7 (mode 6), each to decode to PIL's digest
    (``small_formats_sha256.json``)."""
    import numpy as np

    from mvd_tpu_torch.utils.images import decode_jpeg, decode_webp

    def read(folder, name):
        with open(os.path.join(folder, name), "rb") as f:
            return f.read()

    def sha(a):
        return hashlib.sha256(a.tobytes()).hexdigest()

    pixels = decode_jpeg(read(JPEG_FIXTURES, CO3D_FRAMES_SRC[0]))
    forms = image_fixture_script().frame_forms(pixels)
    digests = image_digests()
    render = None
    sources = {
        "progressive JPEG": (read(IMAGE_FIXTURES, PROG_SOURCE), digests[PROG_SOURCE]["sha256"], "PIL's"),
        "block-smoothed progressive JPEG": (read(IMAGE_FIXTURES, SMOOTH_SOURCE), digests[SMOOTH_SOURCE]["sha256"],
                                            "PIL's"),
        "arithmetic-coded JPEG": (forms["arithmetic"], sha(decode_jpeg(forms["huffman"])), "its Huffman twin's"),
        "lossless JPEG": (forms["lossless"], sha(pixels), "its source's"),
    }
    for form, name in WEBP_SOURCES.items():
        data, want = read(IMAGE_FIXTURES, name), digests[name]
        rgba, mode = decode_webp(data)
        if mode != want["mode"] or ("source_sha256" in want and sha(rgba) != want["source_sha256"]):
            raise AssertionError(f"(d): {name} decodes in mode {mode} (PIL's {want['mode']}) or not to its source")
        sources[form] = (data, want["sha256"], "PIL's")
        if name == "webp_render_lossless.webp":
            render = rgba
    formats = image_fixture_script("make_formats")
    for form, (data, written) in formats.frame_formats(pixels, render).items():
        sources[form] = (data, sha(np.ascontiguousarray(written)), "its writer's")
    frames = codec_digests()["frames"]
    for form, data in formats.frame_codec_forms(pixels, render).items():
        sources[form] = (data, frames[form]["sha256"], "PIL's")
    sources[formats.ZSTD_FORM] = (read(IMAGE_FIXTURES, formats.ZSTD_FRAME), frames[formats.ZSTD_FORM]["sha256"],
                                  "PIL's")
    small = small_format_digests()["frames"]
    for form, data in image_fixture_script("make_small_formats").frame_small_forms(pixels).items():
        sources[form] = (data, small[form]["sha256"], "PIL's")
    return sources


def phase_reader_generation(call, sources: dict, card: str) -> dict:
    """Phase 9d, on phase 3's pipeline and weights while they are up: phase
    3's call from CO3D's frame (or the 512² render) as each of ``sources``
    (``frame_sources``: JPEG, WebP, GIF, BMP and TIFF forms, read by
    ``load_image`` at 512² as ``cli.infer --image-path`` reads it) and from
    that source's decoded pixels re-encoded as PNG: each decode the pixels
    it must be, the two sources and the two generations bitwise equal, each
    call with K1 and K2 exactly phase 3's launches and no plain call. Of the
    small formats (PPM, PFM, TGA, QOI, PCX, SGI, PSD, DDS BC1 and BC7) each
    decode is held to PIL's digest, and only ``SMALL_GENERATED`` are
    generated from: a lossless one (TGA, PSD) held to the PNG twin already
    generated from the frame's pixels, BC7 to its own. Then a request to
    the HTTP server carrying each of the progressive JPEG, the
    arithmetic-coded JPEG, the lossy WebP, the LZW TIFF, the GIF, the
    JPEG-in-TIFF and the TGA, base64-encoded, whose decodes in the server
    are those pixels (sha256) and whose launches are phase 3's. The fault-13 TIFF is
    not generated from: ``check_fault13_path_read`` holds ``load_image``'s
    read of it by path (``cli.infer``'s) to PIL's. Returns the metrics."""
    import base64
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    import numpy as np
    import torch

    from mvd_tpu_torch.cli import serve as serve_mod
    from mvd_tpu_torch.cli.serve import make_handler
    from mvd_tpu_torch.utils.images import decode_image, encode_png, load_image

    t_phase = time.perf_counter()
    pipe, prompts, kwargs = call
    want = expected_launches(pipe, STEPS)
    tmp = tempfile.mkdtemp(prefix="mvd_frames_")
    secs = {}
    twins = {}  # the sha256 of a PNG twin's pixels -> (its source, its images)
    small = tuple(small_format_digests()["frames"])
    checked = []
    try:
        for form, (jpeg, digest, whose) in sources.items():
            if form == FAULT13_SOURCE:
                continue
            pixels = decode_image(jpeg)
            if hashlib.sha256(pixels.tobytes()).hexdigest() != digest:
                raise AssertionError(f"(d): the {form} source does not decode to {whose} pixels")
            if form in small and form not in SMALL_GENERATED:
                checked.append(form)
                continue
            srcs, imgs = [], []
            ext = next((e for k, e in (("WebP", ".webp"), ("GIF", ".gif"), ("BMP", ".bmp"), ("TIFF", ".tif"),
                                       ("APNG", ".png"), ("TGA", ".tga"), ("PSD", ".psd"), ("DDS", ".dds"))
                        if k in form), ".jpg")
            calls = [(form, "source" + ext, jpeg), (f"{form}'s pixels as PNG", "source.png", encode_png(pixels))]
            if form in small and digest in twins:  # a lossless small form: its twin was generated already
                calls = calls[:1]
            for label, name, data in calls:
                path = os.path.join(tmp, name)
                with open(path, "wb") as f:
                    f.write(data)
                src = load_image(path, RES)[None]  # [-1, 1], as cli.infer reads --image-path
                run = dict(kwargs, source_images=(src + 1) / 2)
                out, secs[label], _ = _counted_call(lambda: pipe(prompts, seed=0, **run), want,
                                                    f"[readers] (d) {label} source,")
                _check_images(out["images"], f"(d) {label}")
                srcs.append(src)
                imgs.append(out["images"])
            if len(srcs) == 1:
                srcs.append(twins[digest][0])
                imgs.append(twins[digest][1])
            twins.setdefault(digest, (srcs[1], imgs[1]))
            if not np.array_equal(*srcs) or not torch.equal(*imgs):
                raise AssertionError(f"(d): the {form} source or images differ from its PNG's")
            shape = "x".join(str(n) for n in pixels.shape[1::-1])
            print(f"[readers] (d) phase 3's call ({VIEWS} views, {RES}², DDPM {STEPS}, guidance 1.0) from the "
                  f"{shape} source as {form} ({len(jpeg)} bytes; its decode {whose} pixels) and from its pixels "
                  f"as PNG: sources and images bitwise equal; launches {want} each, no plain call")
        if checked:
            print(f"[readers] (d) the frame as {', '.join(checked)} decodes to PIL's pixels (sha256, "
                  "small_formats_sha256.json)")
        if FAULT13_SOURCE in sources:
            check_fault13_path_read(sources[FAULT13_SOURCE][0], tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    srv = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(pipe, RES, threading.Lock()))
    server = threading.Thread(target=srv.serve_forever, daemon=True)
    server.start()
    decoded, latency = [], {}

    def recorded(decode):
        def run(data, *a, **k):
            img = decode(data, *a, **k)
            decoded.append(img)
            return img
        return run

    try:
        for seed, form in enumerate(("progressive JPEG", "arithmetic-coded JPEG", "lossy WebP",
                                     "LZW TIFF with predictor 2", "GIF", "JPEG-in-TIFF (YCbCr 4:2:0, strips)",
                                     "TGA RLE (bottom-up)"),
                                    start=5):
            jpeg, digest, whose = sources[form]
            payload = {"prompt": "a 3d object", "num_views": VIEWS, "num_steps": STEPS, "seed": seed,
                       "source_image_b64": base64.b64encode(jpeg).decode()}
            req = urllib.request.Request(f"http://127.0.0.1:{srv.server_address[1]}/generate",
                                         data=json.dumps(payload).encode(),
                                         headers={"Content-Type": "application/json"})
            decoded.clear()
            with _Hooks() as hooks:
                hooks.wrap(serve_mod, "decode_image", recorded)
                reset_counts()
                with urllib.request.urlopen(req, timeout=600) as r:
                    if r.status != 200:
                        raise AssertionError(f"(d): /generate answered {r.status}")
                    reply = json.loads(r.read())
                launches, plain = read_counts()
            got = [hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest() for img in decoded]
            if got != [digest] or launches != want or any(plain.values()):
                raise AssertionError(f"(d) serve, {form}: decoded {got} ({whose} {digest}), launches {launches} "
                                     f"!= {want}, plain {plain}")
            if len(reply["images_b64"]) != VIEWS:
                raise AssertionError(f"(d) serve: {len(reply['images_b64'])} images")
            for b64 in reply["images_b64"]:
                _check_png(base64.b64decode(b64), (RES, RES, 3), "(d) serve")
            latency[form] = reply["latency_s"]
            print(f"[readers] (d) serve: a /generate request with the {form} base64-encoded answered 200 with "
                  f"{VIEWS} PNGs in {reply['latency_s']:.2f} s; the server's decode is {whose} pixels (sha256 "
                  f"{got[0][:16]}...); launches {launches}, no plain call")
    finally:
        srv.shutdown()
        srv.server_close()
        server.join(timeout=60)
    metrics = dict(first_call_s=secs, serve_latency_s=latency, launches=launches,
                   phase_s=time.perf_counter() - t_phase)
    generated = len(sources) - (FAULT13_SOURCE in sources) - len(checked)
    print(f"[readers] (d) {generated} forms, {len(secs)} calls and {len(latency)} requests in "
          f"{metrics['phase_s']:.1f} s ({card})")
    return metrics


def check_fault13_path_read(data: bytes, tmp: str) -> None:
    """ROADMAP Queue 3, fault 13, on the card's host: the 1067x800 raw RGBA
    TIFF with EXIF orientation 6 written to a file and read as
    ``cli.infer --image-path`` reads it (``load_image``): the port's read by
    path is PIL's ``Image.open(path)`` (its strip memory-mapped at the
    turned size, then turned: the JAX package's source image), by sha256,
    and differs from its read of the bytes (PIL's ``BytesIO`` read); and
    ``load_image`` at 512² is that image resized."""
    import numpy as np

    from mvd_tpu_torch.utils.images import decode_image, load_image, resize

    want = codec_digests()["frames"][FAULT13_SOURCE]
    path = os.path.join(tmp, "fault13.tif")
    with open(path, "wb") as f:
        f.write(data)
    by_path, by_bytes = decode_image(data, from_path=True), decode_image(data)
    if hashlib.sha256(by_path.tobytes()).hexdigest() != want["path_sha256"]:
        raise AssertionError("(d) fault 13: the read by path is not PIL's Image.open(path)")
    if hashlib.sha256(by_bytes.tobytes()).hexdigest() != want["sha256"] or np.array_equal(by_path, by_bytes):
        raise AssertionError("(d) fault 13: the read of the bytes is not PIL's BytesIO read, or equals the path's")
    src = load_image(path, RES)
    if not np.array_equal(src, resize(by_path, RES, RES).astype(np.float32) / 255.0 * 2.0 - 1.0):
        raise AssertionError("(d) fault 13: load_image(path) is not the path read resized")
    print(f"[readers] (d) fault 13: the {by_path.shape[1]}x{by_path.shape[0]} raw RGBA TIFF at orientation 6 "
          f"read by path (cli.infer's load_image) is PIL's Image.open(path) by sha256 ({want['path_sha256'][:16]}"
          "...), the JAX package's orientation; its bytes read is PIL's BytesIO read, another image")


def check_fixture_digests() -> None:
    """Phase 9a: every JPEG, PNG, WebP, GIF, BMP/DIB and TIFF fixture
    decoded to PIL's pixels by sha256 (the white composite too where PIL
    opens it as RGBA; a WebP in PIL's mode, a lossless one with ``exact``
    to its source), each GIF, BMP and TIFF that PIL refuses refused and
    each form PIL reads and the port does not named ROADMAP item 13c, with
    the libraries phase 1 built."""
    from mvd_tpu_torch.kernels import HOST_SOURCES, _build
    from mvd_tpu_torch.utils.images import decode_image, decode_webp

    for name in HOST_SOURCES:
        if _build.build_host(name) != os.path.join(_build.BUILD_DIR, f"lib{name}.so"):
            raise AssertionError(f"{name}: not built into {_build.BUILD_DIR}")
    decoded, composites = [], 0
    for folder, digests in ((JPEG_FIXTURES, fixture_digests()), (IMAGE_FIXTURES, image_digests())):
        for name, want in sorted(digests.items()):
            with open(os.path.join(folder, name), "rb") as f:
                data = f.read()
            img = decode_image(data)
            if hashlib.sha256(img.tobytes()).hexdigest() != want["sha256"] or list(img.shape) != want["shape"]:
                raise AssertionError(f"{name}: the decode is not PIL's pixels")
            if "composite_sha256" in want:
                comp = decode_image(data, composite_alpha=True)
                if hashlib.sha256(comp.tobytes()).hexdigest() != want["composite_sha256"]:
                    raise AssertionError(f"{name}: the white composite is not PIL's")
                composites += 1
            if name.endswith(".webp"):
                rgba, mode = decode_webp(data)
                if mode != want["mode"]:
                    raise AssertionError(f"{name}: mode {mode}, PIL's {want['mode']}")
                if "source_sha256" in want and hashlib.sha256(rgba.tobytes()).hexdigest() != want["source_sha256"]:
                    raise AssertionError(f"{name}: the lossless decode is not its source")
            decoded.append(name)
    formats, refused, not_read = [], 0, 0
    for name, want in sorted(format_digests().items()):
        with open(os.path.join(IMAGE_FIXTURES, name), "rb") as f:
            data = f.read()
        if name.startswith(("bad_", "notread_")):
            try:
                decode_image(data)
            except ValueError as exc:
                if name.startswith("notread_") and "ROADMAP item 13c" not in str(exc):
                    raise AssertionError(f"{name}: the refusal does not name ROADMAP item 13c: {exc}")
                refused += name.startswith("bad_")
                not_read += name.startswith("notread_")
                continue
            raise AssertionError(f"{name}: decoded, but PIL refuses it or the port does not read its form")
        img = decode_image(data)
        if hashlib.sha256(img.tobytes()).hexdigest() != want["sha256"] or list(img.shape) != want["shape"]:
            raise AssertionError(f"{name}: the decode is not PIL's pixels")
        comp = decode_image(data, composite_alpha=True)
        if hashlib.sha256(comp.tobytes()).hexdigest() != want.get("composite_sha256", want["sha256"]):
            raise AssertionError(f"{name}: the white composite is not PIL's")
        formats.append(name)
    n_png = sum(n.endswith(".png") for n in decoded)
    n_webp = sum(n.endswith(".webp") for n in decoded)
    forms = {k: sum(n.startswith(k) for n in decoded) for k in ("smooth", "arith", "lossless", "webp_ll")}
    print(f"[readers] (a) {len(decoded) - n_png - n_webp} JPEG (sequential, progressive, CMYK, YCCK; "
          f"{forms['smooth']} block-smoothed, {forms['arith']} arithmetic-coded, {forms['lossless']} lossless), "
          f"{n_png} PNG (every colour type and depth, Adam7 or not) and {n_webp} WebP ({forms['webp_ll']} "
          f"simple lossless; lossy, ALPH, VP8X, animated) fixtures decode bitwise to PIL's pixels "
          f"(sha256; {composites} white composites of PIL's RGBA images too; each WebP in PIL's mode)")
    for name, want in sorted(codec_digests()["apng"].items()):
        with open(os.path.join(IMAGE_FIXTURES, name), "rb") as f:
            data = f.read()
        img, comp = decode_image(data), decode_image(data, composite_alpha=True)
        if (hashlib.sha256(img.tobytes()).hexdigest() != want["sha256"]
                or hashlib.sha256(comp.tobytes()).hexdigest() != want["composite_sha256"]):
            raise AssertionError(f"{name}: the decode is not PIL's first frame")
        formats.append(name)
    small, small_refused, small_not_read = [], 0, 0
    for name, want in sorted(small_format_digests()["files"].items()):
        with open(os.path.join(IMAGE_FIXTURES, name), "rb") as f:
            data = f.read()
        if name.startswith(("bad_", "notread_")):
            try:
                decode_image(data)
            except ValueError as exc:
                if name.startswith("notread_") and "ROADMAP item 13c" not in str(exc):
                    raise AssertionError(f"{name}: the refusal does not name ROADMAP item 13c: {exc}") from None
                small_refused += name.startswith("bad_")
                small_not_read += name.startswith("notread_")
                continue
            raise AssertionError(f"{name}: decoded, but PIL refuses it or the port does not read its format")
        img, comp = decode_image(data), decode_image(data, composite_alpha=True)
        if hashlib.sha256(img.tobytes()).hexdigest() != want["sha256"] or list(img.shape) != want["shape"]:
            raise AssertionError(f"{name}: the decode is not PIL's pixels")
        if hashlib.sha256(comp.tobytes()).hexdigest() != want.get("composite_sha256", want["sha256"]):
            raise AssertionError(f"{name}: the white composite is not PIL's")
        small.append(name)
    kinds = {k: sum(n.startswith(k) for n in small) for k in ("ppm", "tga", "ico", "cur", "qoi", "pcx", "sgi",
                                                               "psd", "dds")}
    print(f"[readers] (a) {len(small)} small-format fixtures ({', '.join(f'{v} {k.upper()}' for k, v in kinds.items())}"
          f") decode bitwise to PIL's pixels and white composites in PIL's plugin order; {small_refused} files PIL "
          f"refuses refused, {small_not_read} formats PIL reads named ROADMAP item 13c")
    kinds = {k: sum(n.startswith(k) for n in formats) for k in ("gif", "bmp", "dib", "tif", "apng")}
    print(f"[readers] (a) {len(formats)} GIF, BMP/DIB, TIFF and APNG fixtures ({kinds['gif']} GIF, {kinds['bmp']} "
          f"BMP, {kinds['dib']} DIB, {kinds['tif']} TIFF, {kinds['apng']} APNG) decode bitwise to PIL's pixels and "
          "white composites; "
          f"{refused} files PIL refuses refused, {not_read} forms PIL reads named ROADMAP item 13c")


def frame_decode_ms(sources: dict, card: str) -> dict:
    """The host ms to decode CO3D's 1067x800 frame in each form
    (progressive, baseline, 16-bit RGBA PNG, Adam7 PNG, and 9d's
    block-smoothed, arithmetic-coded and lossless JPEGs, lossy WebP, GIF,
    24-bit BMP, LZW, tiled deflate and 16-bit TIFF, JPEG-in-TIFF in strips
    and in tiles, zstd, LZMA, LAB, YCbCr under LZW, old-style JPEG, the
    fault-13 raw TIFF, PPM, PFM, TGA, QOI, PCX, SGI, PSD and DDS BC1 and BC7
    of ``sources``) and 9d's 512² render as lossless and
    lossy-with-alpha WebP, RLE8 BMP and APNG, in turns on one thread: the
    median, min and max of ``DECODE_TURNS`` and each file's bytes."""
    import numpy as np

    from mvd_tpu_torch.utils.images import decode_image, decode_jpeg, decode_png

    fx, frng = image_fixture_script(), np.random.default_rng(9)
    with open(os.path.join(IMAGE_FIXTURES, PROG_SOURCE), "rb") as f:
        prog = f.read()
    with open(os.path.join(JPEG_FIXTURES, CO3D_FRAMES_SRC[0]), "rb") as f:
        base_jpg = f.read()
    frame = decode_jpeg(base_jpg)
    rgba = np.dstack([frame, np.full(frame.shape[:2], 255, np.uint8)]).astype(np.int64)
    png16 = fx.encode_png((rgba << 8) | frng.integers(0, 256, rgba.shape), 16, 6, filters=frng)
    png_i = fx.encode_png(rgba, 8, 6, interlace=1, filters=frng)
    decoders = {"progressive JPEG": lambda: decode_jpeg(prog), "baseline JPEG": lambda: decode_jpeg(base_jpg),
                "16-bit RGBA PNG": lambda: decode_png(png16), "Adam7 8-bit RGBA PNG": lambda: decode_png(png_i)}
    new_forms = {k: v[0] for k, v in sources.items() if k != "progressive JPEG"}
    decoders.update({k: (lambda d=d: decode_image(d)) for k, d in new_forms.items()})
    if not (np.array_equal(decode_png(png16), frame) and np.array_equal(decode_png(png_i), frame)):
        raise AssertionError("the frame's PNGs do not decode to the frame")
    dms = {k: [] for k in decoders}
    for _ in range(DECODE_TURNS):
        for k, fn in decoders.items():
            t0 = time.perf_counter()
            fn()
            dms[k].append((time.perf_counter() - t0) * 1e3)
    decode_ms = {k: statistics.median(v) for k, v in dms.items()}
    decode_range = {k: [min(v), max(v)] for k, v in dms.items()}
    sizes = {"progressive JPEG": len(prog), "baseline JPEG": len(base_jpg), "16-bit RGBA PNG": len(png16),
             "Adam7 8-bit RGBA PNG": len(png_i), **{k: len(d) for k, d in new_forms.items()}}
    print(f"[readers] host ms to decode a 1067x800 frame (or the 512² render where named), median of "
          f"{DECODE_TURNS} in turns (one thread; PNG rows of a seeded filter type each; {card}): "
          + "; ".join(f"{k} ({sizes[k]} bytes) {v:.2f} [{decode_range[k][0]:.2f}-{decode_range[k][1]:.2f}]"
                      for k, v in decode_ms.items()))
    return dict(decode_ms=decode_ms, decode_ms_range=decode_range, decode_bytes=sizes)


def phase_readers(corpus: str, sources: dict, card: str) -> tuple:
    """Phase 9, the image readers (host C++ built from the checkout with the
    host's ``c++`` in phase 1): (a) ``check_fixture_digests``;
    (b) ``cli.train.main --dataset-format co3d`` on a CO3D-layout corpus of
    JPEG frames at the YAML's point (batch 6, 768²) for 3 steps: K1, K2,
    K3a and K3b exactly ``expected_train_launches`` per step (no validation:
    no val split), no plain call, finite losses; (c) the native reader on
    phase 5's corpus against ``load_view_plain`` on 4 views, then
    ``cli.train.main --native-loader`` for 2 steps with K3a/K3b per step;
    then ``frame_decode_ms`` of 9d's ``sources``, the host ms per 768² view
    of each reader and the loader's seconds a batch of 6 with each, in
    turns, against the step.
    Returns (the CO3D run's launches per step, metrics)."""
    import numpy as np
    import torch

    from mvd_tpu_torch.cli import train as train_cli
    from mvd_tpu_torch.data import native_loader
    from mvd_tpu_torch.data.co3d import CO3DDataset
    from mvd_tpu_torch.data.objaverse import DataLoader, ObjaverseDataset, _load_image_from_bytes
    from mvd_tpu_torch.data.tokenizer import HashTokenizer
    from mvd_tpu_torch.utils.images import decode_jpeg

    t_phase = time.perf_counter()
    base = ["--config", TRAIN_YAML, "--batch-size", str(TRAIN_BATCH), "--image-size", str(TRAIN_RES)]
    size, batch, metrics = TRAIN_RES, TRAIN_BATCH, {}

    check_fixture_digests()  # (a)

    tmp = tempfile.mkdtemp(prefix="mvd_readers_")
    try:
        # (b) the train CLI on CO3D's JPEG frames
        co3d = os.path.join(tmp, "co3d")
        co3d_bytes = write_co3d_corpus(co3d)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        tr = train_cli.main(base + ["--dataset-path", co3d, "--dataset-format", "co3d", "--max-steps",
                                    str(CO3D_STEPS), "--output-dir", os.path.join(tmp, "out_co3d")])
        torch.cuda.synchronize()
        run_b_s = time.perf_counter() - t0
        launches, plain = read_counts()
        # every kernel, the zeros of K5, K6, K6q and K4m included
        per_step = expected_train_launches(tr.state.model)
        bad = {k: launches[k] for k in launches if launches[k] != per_step[k] * CO3D_STEPS}
        if bad or set(per_step) != set(launches) or any(plain.values()) or tr.state.step != CO3D_STEPS:
            raise AssertionError(f"(b): launches {launches} != {CO3D_STEPS} x {per_step}, plain {plain}, "
                                 f"step {tr.state.step}")
        losses = _train_records(tr, CO3D_STEPS, "(b)")
        times = [t["step_s"] for t in tr.timings]
        waits = [t["loader_wait_s"] for t in tr.timings]
        co3d_step_s = statistics.mean(times[1:])
        if not isinstance(tr.train_loader.ds, CO3DDataset) or len(tr.val_loader.ds):
            raise AssertionError("(b): not a CO3D corpus without a val split")
        co3d_per_step = {k: launches[k] // CO3D_STEPS for k in launches}
        print(f"[readers] (b) cli.train.main {' '.join(base)} --dataset-format co3d --max-steps "
              f"{CO3D_STEPS} on {CO3D_SEQUENCES} sequences x {CO3D_FRAMES} JPEG frames 1067x800 "
              f"({co3d_bytes} bytes): {run_b_s:.1f} s; launches per step "
              f"{co3d_per_step} (expected {per_step}), no plain "
              f"call; noise_loss {[round(v, 5) for v in losses]}; s per step {[round(t, 3) for t in times]}; "
              f"loader wait {[round(w, 3) for w in waits]} s")
        metrics["co3d"] = dict(run_s=run_b_s, launches_per_step=co3d_per_step,
                               losses=losses, step_s=times, loader_wait_s=waits, corpus_bytes=co3d_bytes)
        co3d_loader = tr.train_loader
        del tr
        torch.cuda.empty_cache()

        # (c) the native reader: held to its plain version, then the train CLI
        zp = os.path.join(corpus, "renders_final", "obj_000.zip")
        err = 0.0
        for v in range(CORPUS_VIEWS):
            got = native_loader.load_view(zp, f"{v:03d}.png", size)
            want = native_loader.load_view_plain(zp, f"{v:03d}.png", size)
            err = max(err, float(np.abs(got - want).max()))
        if err > NATIVE_TOL:
            raise AssertionError(f"(c): the native reader is {err} from load_view_plain")
        reset_counts()
        t0 = time.perf_counter()
        tr = train_cli.main(base + ["--dataset-path", corpus, "--native-loader", "--max-steps",
                                    str(NATIVE_STEPS), "--output-dir", os.path.join(tmp, "out_native")])
        torch.cuda.synchronize()
        run_c_s = time.perf_counter() - t0
        launches_c, plain_c = read_counts()
        per_step = expected_train_launches(tr.state.model)
        for key in ("flash_attn_bwd_dq", "flash_attn_bwd_dkv"):
            if launches_c[key] != per_step[key] * NATIVE_STEPS or any(plain_c.values()):
                raise AssertionError(f"(c): {key} launched {launches_c[key]}, plain {plain_c}")
        if not (tr.train_loader.ds.use_native and tr.val_loader.ds.use_native):
            raise AssertionError("(c): the datasets do not read natively")
        native_losses = _train_records(tr, NATIVE_STEPS, "(c)")
        native_times = [t["step_s"] for t in tr.timings]
        step_s = native_times[-1]
        print(f"[readers] (c) native reader on {CORPUS_VIEWS} views of obj_000 at {size}²: max |C++ - "
              f"load_view_plain| {err:.3g} (bar {NATIVE_TOL}); cli.train.main --native-loader --max-steps "
              f"{NATIVE_STEPS}: {run_c_s:.1f} s, K3a {launches_c['flash_attn_bwd_dq']} and K3b "
              f"{launches_c['flash_attn_bwd_dkv']} ({NATIVE_STEPS} x {per_step['flash_attn_bwd_dq']} / "
              f"{per_step['flash_attn_bwd_dkv']}), noise_loss {[round(v, 5) for v in native_losses]}, "
              f"s per step {[round(t, 3) for t in native_times]}")
        native_loader_ = tr.train_loader
        del tr
        torch.cuda.empty_cache()

        # (e) the train CLI on 16-bit interlaced RGBA renders, against an
        # 8-bit corpus of the same high bytes
        c8, c16 = os.path.join(tmp, "c8"), os.path.join(tmp, "c16")
        bytes8 = write_corpus(c8, count=DEEP_OBJECTS)
        t0 = time.perf_counter()
        bytes16 = write_corpus(c16, count=DEEP_OBJECTS, encode=png16_encoder(16))
        write16_s = time.perf_counter() - t0
        reset_counts()
        t0 = time.perf_counter()
        tr = train_cli.main(base + ["--dataset-path", c16, "--max-steps", str(DEEP_STEPS), "--output-dir",
                                    os.path.join(tmp, "out_c16")])
        torch.cuda.synchronize()
        run_e_s = time.perf_counter() - t0
        launches_e, plain_e = read_counts()
        per_step = expected_train_launches(tr.state.model)
        bad = {k: launches_e[k] for k in launches_e if launches_e[k] != per_step[k] * DEEP_STEPS}
        if bad or set(per_step) != set(launches_e) or any(plain_e.values()) or tr.state.step != DEEP_STEPS:
            raise AssertionError(f"(e): launches {launches_e} != {DEEP_STEPS} x {per_step}, plain {plain_e}, "
                                 f"step {tr.state.step}")
        if len(tr.val_loader.ds):
            raise AssertionError("(e): the corpus has a val split")
        deep_losses = _train_records(tr, DEEP_STEPS, "(e)")
        deep_times = [t["step_s"] for t in tr.timings]
        # the run's first batch (a fresh iteration of its datamodule's train
        # loader: epoch 0, as the run's first) against the 8-bit corpus's
        dm8 = copy.copy(tr.dm)
        dm8.kwargs, dm8.datasets = {**tr.dm.kwargs, "data_root": c8}, {}
        firsts = []
        for dm in (tr.dm, dm8):
            it = iter(dm.loader("train"))
            try:
                firsts.append(next(it))
            finally:
                it.close()
                _join_loader_threads()
        b16, b8 = firsts
        if b16.keys() != b8.keys() or not all(np.array_equal(b16[k], b8[k]) for k in b16):
            raise AssertionError("(e): the 16-bit corpus's first batch is not the 8-bit corpus's")
        shapes = {k: tuple(v.shape) for k, v in b16.items() if k.endswith("_image")}
        per_step_e = {k: launches_e[k] // DEEP_STEPS for k in ("flash_attn_fwd", "groupnorm_silu",
                                                                 "flash_attn_bwd_dq", "flash_attn_bwd_dkv")}
        print(f"[readers] (e) cli.train.main {' '.join(base)} --max-steps {DEEP_STEPS} on {DEEP_OBJECTS} "
              f"objects x {CORPUS_VIEWS} views of 16-bit Adam7 RGBA PNG {CORPUS_RES}² ({bytes16} bytes, "
              f"written in {write16_s:.1f} s; the 8-bit corpus {bytes8}): {run_e_s:.1f} s; launches per step "
              f"{per_step_e} (every kernel the train step's), no plain call; noise_loss "
              f"{[round(v, 5) for v in deep_losses]}; s per step {[round(t, 3) for t in deep_times]}; first "
              f"batch {shapes} bitwise the 8-bit corpus's")
        metrics["deep"] = dict(run_s=run_e_s, launches=launches_e, losses=deep_losses, step_s=deep_times,
                               corpus_bytes=bytes16, write_s=write16_s)
        del tr
        torch.cuda.empty_cache()

        metrics.update(frame_decode_ms(sources, card))

        # host ms per view of each reader, in turns (one thread)
        with zipfile.ZipFile(zp) as z:
            png = z.read("000.png")
        with open(os.path.join(JPEG_FIXTURES, CO3D_FRAMES_SRC[0]), "rb") as f:
            jpg = f.read()
        readers = {
            "numpy PIL path (PNG 512² RGBA, Lanczos)": lambda: _load_image_from_bytes(png, size),
            "native reader (PNG 512² RGBA, bilinear)": lambda: native_loader.load_view(zp, "000.png", size),
            "JPEG frame 1067x800 (decode + Lanczos)": lambda: _load_image_from_bytes(jpg, size),
            "JPEG decode alone": lambda: decode_jpeg(jpg),
        }
        ms = {k: [] for k in readers}
        for _ in range(READER_TURNS):
            for k, fn in readers.items():
                t0 = time.perf_counter()
                fn()
                ms[k].append((time.perf_counter() - t0) * 1e3)
        view_ms = {k: statistics.median(v) for k, v in ms.items()}
        print(f"[readers] host ms per {size}² view, median of {READER_TURNS} in turns (one thread; "
              f"{card}): " + "; ".join(f"{k} {v:.1f}" for k, v in view_ms.items()))

        # the loader alone, a batch of 6, with each reader, in turns
        pil_loader = DataLoader(ObjaverseDataset(corpus, "train", image_size=size), HashTokenizer(),
                                batch_size=batch, num_workers=native_loader_.num_workers)
        loaders = {"numpy PIL path": pil_loader, "native reader": native_loader_,
                   "CO3D JPEG frames": co3d_loader}
        loader_s = {k: [] for k in loaders}
        for _ in range(2):
            for k, ld in loaders.items():
                loader_s[k].append(_loader_s_per_batch(ld))
        loader_s = {k: min(v) for k, v in loader_s.items()}
        print(f"[readers] the loader alone, s per batch of {batch} ({2 * batch} views; its first "
              f"{LOADER_BATCHES} batches, {native_loader_.prefetch} in flight on "
              f"{native_loader_.num_workers} threads, {os.cpu_count()} cores; the faster of 2 turns): "
              + "; ".join(f"{k} {v:.3f}" for k, v in loader_s.items())
              + f"; against {step_s:.3f} s per native-loader step and {co3d_step_s:.3f} per CO3D step "
              f"({card})")
        metrics["native"] = dict(run_s=run_c_s, max_abs_err=err, losses=native_losses, step_s=native_times,
                                 launches=launches_c)
        metrics.update(view_ms=view_ms, loader_s_per_batch=loader_s, step_s=step_s, co3d_step_s=co3d_step_s)
    finally:
        _join_loader_threads()
        shutil.rmtree(tmp, ignore_errors=True)
    metrics["phase_s"] = time.perf_counter() - t_phase
    print(f"[readers] phase 9 in {metrics['phase_s']:.1f} s ({card})")
    return metrics["co3d"]["launches_per_step"], metrics


# phase 10: the JAX package's orbax checkpoints on the H100's host
ORBAX_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures",
                              "torch_port_orbax")
ORBAX_RESUME_STEPS = 2


def _orbax_writer():
    """``tests/_torch_port_orbax_writer.py``: the JAX package's orbax layout
    written with torch, numpy and the port (no JAX, orbax or zstd)."""
    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import _torch_port_orbax_writer

    return _torch_port_orbax_writer


def orbax_export(call) -> dict:
    """Phase 10b's source, taken while phase 3's pipeline is up: its
    networks as the JAX pipeline's ``params`` (numpy f32, in the JAX
    package's names and layouts; host memory), and phase 3's call."""
    pipe, prompts, kwargs = call
    t0 = time.perf_counter()
    tree = _orbax_writer().jax_pipeline_tree(pipe.model)
    secs = time.perf_counter() - t0
    n = sum(p.numel() for p in pipe.model.parameters())
    print(f"[orbax] phase 3's {n / 1e6:.1f} M parameters exported as the JAX pipeline's tree in {secs:.1f} s "
          f"(host memory, for phase 10b)")
    return dict(tree=tree, prompts=prompts, kwargs=kwargs, config=pipe.config)


def _leaf_digests(tree, prefix=()) -> dict:
    """{"a/b/0": {"dtype", "shape", "sha256"}} of a tree ``read_tree`` gave
    (bf16 as its uint16 bits), as ``make_fixtures.py`` records the JAX
    package's."""
    import numpy as np
    import torch

    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    elif tree is None:
        return {}
    else:
        if torch.is_tensor(tree):
            data, dtype = tree.contiguous().view(torch.int16).numpy().tobytes(), "bfloat16"
        else:
            data, dtype = np.ascontiguousarray(tree).tobytes(), tree.dtype.name
        return {"/".join(map(str, prefix)): {"dtype": dtype, "shape": list(tree.shape),
                                             "sha256": hashlib.sha256(data).hexdigest()}}
    out = {}
    for k, v in items:
        out.update(_leaf_digests(v, prefix + (k,)))
    return out


def phase_orbax(export: dict, corpus: str, run_root: str, card: str) -> dict:
    """Phase 10, the JAX package's orbax checkpoints read on the host by
    the port's own readers (``checkpoint/ocdbt.py``, ``zarr.py``,
    ``orbax_read.py`` and the zstd decoder ``csrc/zstd_decode.cpp``, built
    in phase 1): (a) every committed fixture of
    ``tests/fixtures/torch_port_orbax`` read to the digests the JAX
    package's arrays gave; (b) phase 3's pipeline parameters (``export``)
    written in the JAX package's orbax layout (``save_params`` of the whole
    pipeline tree) by the tests' layout writer, loaded by
    ``load_checkpoint`` into a fresh full-width pipeline whose every
    parameter is NaN before: every parameter bitwise phase 3's, the images
    of phase 3's call bitwise phase 3's with K1 and K2 exactly its launches
    and no plain call, then ``cli.infer.main --checkpoint DIR`` in this
    process; (c) phase 5's latest Trainer state written as a JAX Trainer
    step into a fresh run dir, and ``cli.train.main --resume`` on it for 2
    steps at phase 5's point: the restored step, parameters and AdamW
    moments bitwise phase 5's, each step's launches the train step's, no
    plain call, finite losses, the JAX step dir's files unchanged (sha256).
    Prints the checkpoints' bytes and the reads' seconds and GB/s beside
    the card's name and power limit."""
    import numpy as np
    import torch

    from mvd_tpu_torch.checkpoint import export_jax_params, load_checkpoint, read_step, read_tree
    from mvd_tpu_torch.checkpoint.io import CheckpointManager
    from mvd_tpu_torch.cli import infer
    from mvd_tpu_torch.cli import train as train_cli
    from mvd_tpu_torch.kernels import _build
    from mvd_tpu_torch.pipeline import MVDPipeline
    from mvd_tpu_torch.train import loop
    from mvd_tpu_torch.train.loop import Trainer

    W = _orbax_writer()
    t_phase = time.perf_counter()
    metrics = {}

    # (a) the fixtures the JAX package wrote, to its digests
    if _build.build_host("zstd_decode") != os.path.join(_build.BUILD_DIR, "libzstd_decode.so"):
        raise AssertionError(f"zstd_decode: not built into {_build.BUILD_DIR}")
    with open(os.path.join(ORBAX_FIXTURES, "jax_sha256.json")) as f:
        want = json.load(f)
    got = _leaf_digests(read_tree(os.path.join(ORBAX_FIXTURES, "params")))
    state_tree, meta, step_metrics = read_step(os.path.join(ORBAX_FIXTURES, "run", "checkpoints", "2"))
    step_want = want["run/checkpoints/2"]
    if got != want["params"] or _leaf_digests(state_tree) != step_want["state"]:
        raise AssertionError("(a): a fixture array does not read to the JAX package's digest")
    if meta != step_want["meta"] or step_metrics != step_want["metrics"]:
        raise AssertionError(f"(a): the fixture step's meta {meta} / metrics {step_metrics}")
    print(f"[orbax] (a) {len(got)} arrays of the JAX save_params fixture and {len(step_want['state'])} "
          f"of its Trainer step read bitwise to the JAX package's digests (sha256; bf16, int32, 0-d, "
          f"inline and indirect values, optax's masked AdamW state); meta and metrics equal")

    tmp = tempfile.mkdtemp(prefix="mvd_orbax_")
    try:
        # (b) phase 3's pipeline as a JAX save_params dir
        path = os.path.join(tmp, "params")
        t0 = time.perf_counter()
        nbytes = W.write_pytree(path, export["tree"])
        write_s = time.perf_counter() - t0
        fresh = MVDPipeline.create(export["config"], seed=1, device="cuda")
        with torch.no_grad():
            for p in fresh.model.parameters():
                p.fill_(float("nan"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        load_checkpoint(fresh, path)
        torch.cuda.synchronize()
        read_s = time.perf_counter() - t0
        differ = []
        for net, module in fresh.model.items():
            mine = export_jax_params(module)
            ref = export["tree"][net]["params"]
            stack = [((), mine, ref)]
            while stack:
                pre, a, b = stack.pop()
                if a.keys() != b.keys():
                    differ.append(f"{net}/{'/'.join(pre)}: keys")
                    continue
                for k in a:
                    if isinstance(a[k], dict):
                        stack.append((pre + (k,), a[k], b[k]))
                    elif not np.array_equal(a[k], b[k]):
                        differ.append(f"{net}/{'/'.join(pre + (k,))}")
            del mine
        if differ:
            raise AssertionError(f"(b): {len(differ)} parameters differ from phase 3's: {differ[:5]}")
        export.pop("tree")
        n_params = sum(p.numel() for p in fresh.model.parameters())
        print(f"[orbax] (b) phase 3's pipeline ({n_params / 1e6:.1f} M f32 parameters) written in the JAX "
              f"package's orbax layout ({nbytes} bytes) in {write_s:.1f} s; load_checkpoint read it into a "
              f"fresh pipeline of NaNs in {read_s:.2f} s = {nbytes / read_s / 1e9:.2f} GB/s (decode, layout "
              f"and the copy to the card; the file read warm from the page cache); every parameter "
              f"bitwise phase 3's ({card})")
        prompts, kwargs = export["prompts"], export["kwargs"]
        out, first_s, launches = _counted_call(lambda: fresh(prompts, seed=0, **kwargs),
                                               expected_launches(fresh, STEPS), "[orbax] (b)",
                                               ("denoise_loop",), fresh)
        if not torch.equal(out["images"], export["images"]):
            raise AssertionError("(b): the images of the loaded pipeline differ from phase 3's")
        print(f"[orbax] (b) phase 3's call on the loaded pipeline: images bitwise phase 3's at the same "
              f"noise; K1 {launches['flash_attn_fwd']}, K2 {launches['groupnorm_silu']}, no plain call")
        del fresh, out
        torch.cuda.empty_cache()
        out_dir = os.path.join(tmp, "infer")
        t0 = time.perf_counter()
        infer.main(["--checkpoint", path, "--num-steps", "10", "--image-size", str(RES),
                    "--num-images", "1", "--output-dir", out_dir])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        names = sorted(os.listdir(out_dir))
        if names != ["comparison_00.png", "generated_00.png", "source.png"]:
            raise AssertionError(f"(b): the infer CLI wrote {names}")
        for name in names[1:]:
            with open(os.path.join(out_dir, name), "rb") as f:
                _check_png(f.read(), (RES, RES, 3), f"(b) infer CLI {name}")
        print(f"[orbax] (b) python -m mvd_tpu_torch.cli.infer --checkpoint <the orbax dir> --num-steps 10 "
              f"--image-size {RES} --num-images 1: {names}, each decoded, in {cli_s:.1f} s")
        metrics["b"] = dict(bytes=nbytes, write_s=write_s, read_s=read_s, gb_per_s=nbytes / read_s / 1e9,
                            first_call_s=first_s, launches=launches, infer_cli_s=cli_s)
        shutil.rmtree(path)
        torch.cuda.empty_cache()

        # (c) phase 5's latest state as a JAX Trainer step, resumed for 2 steps
        base = ["--config", TRAIN_YAML, "--dataset-path", corpus, "--batch-size", str(TRAIN_BATCH),
                "--image-size", str(TRAIN_RES)]
        no_val = lambda _: (lambda self, *a, **k: {})  # noqa: E731
        with _Hooks() as hooks:
            hooks.wrap(Trainer, "validate", no_val)
            tr = train_cli.main(base + ["--output-dir", os.path.join(tmp, "peek"), "--resume", run_root,
                                        "--max-steps", "5"], metrics_log_interval=0)
        if tr.state.step != 5 or tr.timings:
            raise AssertionError(f"(c): phase 5's run resumed at {tr.state.step}, took {len(tr.timings)} steps")
        snap = _state_snapshot(tr.state)
        run = os.path.join(tmp, "jax_run")
        t0 = time.perf_counter()
        step_dir = W.write_train_step(os.path.join(run, "checkpoints"), tr.state.step,
                                      W.jax_train_state_tree(tr.state),
                                      {"dataset_state": tr.dm.state_dict(), "wandb_run_id": "jax-run"},
                                      {"val/noise_loss": 0.5})
        state_write_s = time.perf_counter() - t0
        state_bytes = _dir_bytes(step_dir)
        before = {os.path.relpath(os.path.join(d, n), step_dir): hashlib.sha256(
            open(os.path.join(d, n), "rb").read()).hexdigest() for d, _, fs in os.walk(step_dir) for n in fs}
        del tr
        torch.cuda.empty_cache()
        restored, timed, per_call = [], [], []

        def resume_guard(resume):
            def run_(self, *a, **k):
                ok = resume(self, *a, **k)
                _assert_state_equal(self.state, snap, "(c) the state restored from the JAX step")
                restored.append(self.state.step)
                return ok
            return run_

        def timer(restore):
            def run_(*a, **k):
                t = time.perf_counter()
                out_ = restore(*a, **k)
                torch.cuda.synchronize()
                timed.append(time.perf_counter() - t)
                return out_
            return run_

        reset_counts()
        t0 = time.perf_counter()
        with _Hooks() as hooks:
            hooks.wrap(Trainer, "validate", no_val)
            hooks.wrap(Trainer, "resume", resume_guard)
            hooks.wrap(CheckpointManager, "restore", timer)
            hooks.wrap(loop, "make_train_step", counted_train_steps(per_call))
            tr = train_cli.main(base + ["--output-dir", os.path.join(tmp, "out"), "--resume", run,
                                        "--max-steps", str(5 + ORBAX_RESUME_STEPS)], metrics_log_interval=0)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        took = [t["step"] for t in tr.timings]
        if restored != [5] or took != [6, 7] or tr.state.step != 7 or tr.logger.run_id != "jax-run":
            raise AssertionError(f"(c): restored {restored}, took steps {took}, run id {tr.logger.run_id}")
        want_launches = expected_train_launches(per_call[0][3])
        for i, (got_, plain, loss, _) in enumerate(per_call):
            if got_ != want_launches or any(plain.values()) or not math.isfinite(loss):
                raise AssertionError(f"(c) step {i + 1}: launches {got_} (expected {want_launches}), plain "
                                     f"{plain}, loss {loss}")
        after = {os.path.relpath(os.path.join(d, n), step_dir): hashlib.sha256(
            open(os.path.join(d, n), "rb").read()).hexdigest() for d, _, fs in os.walk(step_dir) for n in fs}
        if after != before or tr.ckpt.all_steps() != [5, 7]:
            raise AssertionError(f"(c): the JAX step dir changed, or steps {tr.ckpt.all_steps()} on disk")
        losses = [round(c[2], 5) for c in per_call]
        print(f"[orbax] (c) phase 5's step-5 state written as a JAX Trainer step ({state_bytes} bytes) in "
              f"{state_write_s:.1f} s; cli.train.main --resume <that run> --max-steps 7: restored step 5 "
              f"with every parameter and the AdamW moments bitwise phase 5's in {timed[0]:.2f} s = "
              f"{state_bytes / timed[0] / 1e9:.2f} GB/s (warm page cache), steps {took} with launches per "
              f"step {want_launches}, no plain call, losses {losses}; the JAX step's {len(before)} files "
              f"unchanged (sha256), the port's step 7 saved beside it; {run_s:.1f} s ({card})")
        metrics["c"] = dict(bytes=state_bytes, write_s=state_write_s, restore_s=timed[0],
                            gb_per_s=state_bytes / timed[0] / 1e9, run_s=run_s, losses=losses,
                            launches_per_step=want_launches)
        del tr, per_call
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    metrics["phase_s"] = time.perf_counter() - t_phase
    print(f"[orbax] phase 10 in {metrics['phase_s']:.1f} s ({card})")
    return metrics


# phase 11: the evidence chain's first stages (mvd_tpu_torch/tools/): the
# procedural corpus, VAE pretraining at full width, then the chain at
# config/evidence_256.yaml through precompute_latents, train and val
EVIDENCE_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures",
                                 "torch_port_evidence")
EVIDENCE_YAML = os.path.join(os.path.dirname(os.path.abspath(__file__)), "config", "evidence_256.yaml")
EVIDENCE_OBJECTS, EVIDENCE_VIEWS, EVIDENCE_RES, EVIDENCE_SEED = 20, 8, 256, 0
EVIDENCE_WORKERS = 8  # processes rendering objects at once (threads gain 1.2x: the GIL)
# phase 11a's bar on the card host's renders against the JAX tool's zips
RENDER_MAX_DIFF, RENDER_DIFF_SHARE, CAMERA_MAX_DIFF = 1, 1e-4, 1e-6
VAE_BATCH, VAE_STEPS, VAE_VAL_EVERY = 16, 8, 4
CHAIN_VAE_STEPS, CHAIN_TRAIN_STEPS, CHAIN_VAL_SAMPLES = 4, 2, 2


def _rgba(data: bytes):
    """A PNG's 8-bit RGBA pixels, as the file stores them."""
    import numpy as np

    from mvd_tpu_torch.utils.images import png_samples

    samples, chunks = png_samples(data)
    if chunks.header[2:4] != (8, 6):
        raise AssertionError(f"not an 8-bit RGBA PNG: depth and colour type {chunks.header[2:4]}")
    return samples.astype(np.uint8)


def _hold_to_fixture(corpus: str) -> dict:
    """Phase 11a's check: each object of the fixture (the JAX tool's zips,
    seed 0) against the same object of ``corpus``, member by member: the
    same names in the same order, prompt and metadata equal, cameras and
    RGBA pixels counted where they differ."""
    import io

    import numpy as np

    fixture = os.path.join(EVIDENCE_FIXTURES, "renders_final")
    names = sorted(os.listdir(fixture))
    out = dict(objects=len(names), pixels=0, pixels_differ=0, max_diff=0, camera_max_diff=0.0)
    for name in names:
        with zipfile.ZipFile(os.path.join(fixture, name)) as want, \
                zipfile.ZipFile(os.path.join(corpus, "renders_final", name)) as got:
            if want.namelist() != got.namelist():
                raise AssertionError(f"(a) {name}: members {got.namelist()}, the JAX tool's {want.namelist()}")
            for member in want.namelist():
                a, b = want.read(member), got.read(member)
                if member.endswith(".png"):
                    pa, pb = _rgba(a).astype(np.int16), _rgba(b).astype(np.int16)
                    if pa.shape != pb.shape:
                        raise AssertionError(f"(a) {name}/{member}: {pb.shape}, the JAX tool's {pa.shape}")
                    diff = np.abs(pa - pb).max(axis=-1)
                    out["pixels"] += diff.size
                    out["pixels_differ"] += int((diff > 0).sum())
                    out["max_diff"] = max(out["max_diff"], int(diff.max()))
                elif member.endswith(".npy"):
                    ca, cb = np.load(io.BytesIO(a)), np.load(io.BytesIO(b))
                    if ca.dtype != cb.dtype or ca.shape != cb.shape:
                        raise AssertionError(f"(a) {name}/{member}: {cb.dtype} {cb.shape}, the JAX tool's "
                                             f"{ca.dtype} {ca.shape}")
                    out["camera_max_diff"] = max(out["camera_max_diff"], float(np.abs(ca - cb).max()))
                elif a != b:
                    raise AssertionError(f"(a) {name}/{member} differs from the JAX tool's")
    share = out["pixels_differ"] / out["pixels"]
    print(f"[evidence] (a) the fixture's {len(names)} objects (the JAX tool's zips, seed {EVIDENCE_SEED}): "
          f"members, prompts and metadata equal; {out['pixels_differ']} of {out['pixels']} RGBA pixels "
          f"differ (share {share:.2e}, max |diff| {out['max_diff']}); cameras max |diff| "
          f"{out['camera_max_diff']:.3g}")
    if out["max_diff"] > RENDER_MAX_DIFF or share > RENDER_DIFF_SHARE or out["camera_max_diff"] > CAMERA_MAX_DIFF:
        raise AssertionError(f"(a) the renders here are off the JAX tool's: {out}")
    return out


def _one_blas_thread() -> None:
    """A render worker's set-up, run before it imports numpy: one BLAS
    thread, so that the workers' small matrix products do not oversubscribe
    the host's cores (8 workers of 8 threads each rendered slower than one
    process on the card's host)."""
    for name in ("OPENBLAS_NUM_THREADS", "OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[name] = "1"


def write_evidence_corpus(root: str) -> dict:
    """Phase 11a: ``tools.procedural.generate_corpus`` for EVIDENCE_OBJECTS
    objects of EVIDENCE_VIEWS views at EVIDENCE_RES² (seed EVIDENCE_SEED):
    object 0 in this process (the host ms a view), the rest in
    EVIDENCE_WORKERS spawned processes of one BLAS thread each; held to the
    fixture and loaded
    through ``ObjaverseDataset`` on every split."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np

    from mvd_tpu_torch.data.objaverse import ObjaverseDataset
    from mvd_tpu_torch.tools.procedural import generate_corpus

    args = (root, 1, EVIDENCE_VIEWS, EVIDENCE_RES, EVIDENCE_SEED, 2)  # one object, supersample 2
    t0 = time.perf_counter()
    generate_corpus(*args, 0)
    ms_view = (time.perf_counter() - t0) * 1e3 / EVIDENCE_VIEWS
    t0 = time.perf_counter()
    with ProcessPoolExecutor(EVIDENCE_WORKERS, mp_context=multiprocessing.get_context("spawn"),
                             initializer=_one_blas_thread) as pool:
        for f in [pool.submit(generate_corpus, *args, i) for i in range(1, EVIDENCE_OBJECTS)]:
            f.result()
    pool_s = time.perf_counter() - t0
    views = (EVIDENCE_OBJECTS - 1) * EVIDENCE_VIEWS
    print(f"[evidence] (a) tools.procedural: {EVIDENCE_OBJECTS} objects x {EVIDENCE_VIEWS} views at "
          f"{EVIDENCE_RES}² (supersample 2): {ms_view:.1f} host ms a view in one process; the other {views} "
          f"views in {EVIDENCE_WORKERS} processes in {pool_s:.2f} s, their start included "
          f"({pool_s * 1e3 / views:.1f} ms a view)")
    held = _hold_to_fixture(root)
    splits = {}
    for split in ("train", "val", "test"):
        ds = ObjaverseDataset(root, split, image_size=EVIDENCE_RES)
        img = ds[0]["target_image"]
        if len(ds.files) < 2 or img.shape != (EVIDENCE_RES, EVIDENCE_RES, 3) or not np.isfinite(img).all():
            raise AssertionError(f"(a) {split}: {len(ds.files)} objects, target image {img.shape}")
        splits[split] = dict(objects=len(ds.files), pairs=len(ds))
    print(f"[evidence] (a) ObjaverseDataset (objects, pairs): "
          f"{ {k: (v['objects'], v['pairs']) for k, v in splits.items()} }")
    return dict(host_ms_per_view=ms_view, pool_ms_per_view=pool_s * 1e3 / views, splits=splits, **held)


def _gn_counts(vae) -> tuple:
    """The GroupNorms of an AutoencoderKL: all of them (a train or a
    validation forward) and the encoder's (the latent probe)."""
    from mvd_tpu_torch.nn.layers import GroupNorm

    count = lambda m: sum(isinstance(g, GroupNorm) for g in m.modules())
    return count(vae), count(vae.encoder)


class _VaeRun:
    """Hooks on ``tools.pretrain_vae`` for one ``main``: the launches and
    plain calls of each train step, validation and latent probe, each step's
    seconds (synchronised before and after) and loss; the non-logging steps
    under ``torch.cuda.set_sync_debug_mode("error")`` but step ``trace_at``,
    which is traced; the VAE (and its GroupNorm calls) and the state dict
    that ``main`` saves."""

    def __init__(self, trace_at: int = 0):
        self.trace_at, self.steps, self.evals, self.traced = trace_at, [], [], None
        self.vae = self.calls = self.hooks = self.saved = None

    def install(self, hooks: "_Hooks") -> None:
        from mvd_tpu_torch.tools import pretrain_vae as pv

        hooks.wrap(pv, "train_step", self._step)
        hooks.wrap(pv, "val_recon", lambda fn: self._eval("val", fn))
        hooks.wrap(pv, "latent_std", lambda fn: self._eval("probe", fn))
        hooks.wrap(pv, "make_optimizer", self._optimizer)
        hooks.wrap(pv, "vae_state_dict", self._saved)

    def _step(self, fn):
        import torch

        def run(*a, **k):
            i = len(self.steps) + 1
            checked = i != 1 and i % 100 != 0 and i != self.trace_at
            before, _ = read_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if i == self.trace_at:
                box = []
                self.traced = trace_run(lambda: box.append(fn(*a, **k)), "vae pretrain step",
                                        ops=("GroupNormSiLUBackward",))
                res = box[0]
            else:
                if checked:
                    torch.cuda.set_sync_debug_mode("error")
                try:
                    res = fn(*a, **k)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            after, plain = read_counts()
            self.steps.append(dict(launches={n: after[n] - before[n] for n in after}, plain=plain,
                                   checked=checked, s=secs, loss=res[0]))
            return res
        return run

    def _eval(self, kind, fn):
        def run(vae, batch, chunk):
            before, _ = read_counts()
            res = fn(vae, batch, chunk)
            after, plain = read_counts()
            self.evals.append(dict(kind=kind, chunks=-(-batch.shape[0] // chunk), plain=plain,
                                   launches={n: after[n] - before[n] for n in after}))
            return res
        return run

    def _optimizer(self, fn):
        def run(vae):
            self.vae = vae
            self.calls, self.hooks = record_groupnorm_calls(vae)
            return fn(vae)
        return run

    def _saved(self, fn):
        def run(vae):
            self.saved = fn(vae)
            return self.saved
        return run

    def check(self, what: str, steps: int) -> dict:
        """Every step's, validation's and probe's launches as the VAE's
        GroupNorms say, no plain call, finite losses; returns a step's."""
        import torch

        for h in self.hooks:
            h.remove()
        n_gn, n_enc = _gn_counts(self.vae)
        zero = {n: 0 for n in self.steps[0]["launches"]}
        want = {**zero, "groupnorm_silu": n_gn}
        if len(self.steps) != steps:
            raise AssertionError(f"{what}: {len(self.steps)} steps, not {steps}")
        for i, s in enumerate(self.steps):
            if s["launches"] != want or any(s["plain"].values()):
                raise AssertionError(f"{what} step {i + 1}: launches {s['launches']} (expected {want}), "
                                     f"plain calls {s['plain']}")
        for e in self.evals:
            per = n_gn if e["kind"] == "val" else n_enc
            if e["launches"] != {**zero, "groupnorm_silu": per * e["chunks"]} or any(e["plain"].values()):
                raise AssertionError(f"{what} {e['kind']}: launches {e['launches']} (expected K2 {per} x "
                                     f"{e['chunks']}), plain calls {e['plain']}")
        losses = torch.stack([s["loss"] for s in self.steps]).float().cpu()
        if not torch.isfinite(losses).all():
            raise AssertionError(f"{what}: losses {losses.tolist()}")
        return want


def phase_vae_pretrain(corpus: str, work: str, card: str, trace: bool = False) -> tuple:
    """Phase 11b: ``tools.pretrain_vae.main`` without ``--config`` (SD2.1's
    VAE, (128, 256, 512, 512)) at EVIDENCE_RES², batch VAE_BATCH, for
    VAE_STEPS steps with validation every VAE_VAL_EVERY (``_VaeRun``'s
    checks); the saved directory into a VAE of NaNs, bitwise; K2 against
    its plain version at every GroupNorm shape of the step; the GroupNorm
    backward's recompute timed at the largest, beside K2's forward; the
    host ms to make a batch. With ``trace``, the last step is traced.
    Returns (the launches of one step, metrics, the trace or None)."""
    import numpy as np
    import torch

    from mvd_tpu_torch.checkpoint import load_component
    from mvd_tpu_torch.config import VAEConfig
    from mvd_tpu_torch.data.latent_cache import corpus_zips
    from mvd_tpu_torch.data.objaverse import split_files
    from mvd_tpu_torch.kernels import groupnorm_silu, groupnorm_silu_plain, groupnorm_silu_vjp
    from mvd_tpu_torch.kernels.groupnorm_silu import FUSED, _entry, launch, launch_plan
    from mvd_tpu_torch.kernels.measure import GN_TOL, gn_bounds, max_err, time_graph_ms, time_ms
    from mvd_tpu_torch.nn.vae import AutoencoderKL
    from mvd_tpu_torch.tools import pretrain_vae as pv

    t_phase = time.perf_counter()
    out_dir = os.path.join(work, "vae_full")
    run = _VaeRun(trace_at=VAE_STEPS if trace else 0)
    argv = ["--dataset-path", corpus, "--output", out_dir, "--image-size", str(EVIDENCE_RES),
            "--batch-size", str(VAE_BATCH), "--steps", str(VAE_STEPS), "--val-every", str(VAE_VAL_EVERY)]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    with _Hooks() as hooks:
        run.install(hooks)
        meta = pv.main(argv)
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    per_step = run.check("(b)", VAE_STEPS)
    n_gn, n_enc = _gn_counts(run.vae)
    cfg = run.vae.cfg
    if cfg != VAEConfig():
        raise AssertionError(f"(b): main without --config built {cfg}, not SD2.1's VAE")
    n_params = sum(p.numel() for p in run.vae.parameters())
    timed = [s["s"] for s in run.steps[1:] if s["checked"]]
    step_ms = statistics.median(timed) * 1e3
    print(f"[evidence] (b) tools.pretrain_vae.main {' '.join(argv[4:])} (SD2.1's VAE {cfg.block_out_channels}, "
          f"{n_params / 1e6:.2f} M parameters, bf16 compute, f32 masters): {run_s:.1f} s; K2 {n_gn} a step "
          f"({n_gn - n_enc} decoder + {n_enc} encoder GroupNorms), {n_gn} a validation forward, {n_enc} a "
          f"probe encode, nothing else, no plain call; steps {[i + 1 for i, s in enumerate(run.steps) if s['checked']]} "
          f"under the sync check; logged {meta['logged']}; val {meta['val_history']}; latent std "
          f"{meta['latent_std']:.4f}")
    print(f"[evidence] (b) ms a step (steps 2-{VAE_STEPS}, synchronised): "
          f"{[round(s['s'] * 1e3, 1) for s in run.steps]}, median of the checked ones {step_ms:.1f}; "
          f"peak memory {peak:.2f} GiB ({card})")

    # the saved directory, bitwise, into a VAE of NaNs
    with torch.device("cuda"):
        fresh = AutoencoderKL(VAEConfig())
    with torch.no_grad():
        for p in fresh.parameters():
            p.fill_(float("nan"))
    load_component(fresh, out_dir, "vae")
    got = fresh.state_dict()
    differ = [k for k, v in run.saved.items() if not torch.equal(got[k].cpu(), v)]
    if differ or got.keys() != run.saved.keys():
        raise AssertionError(f"(b): {len(differ)} tensors of the saved VAE differ after the load: {differ[:5]}")
    del fresh, got

    # K2 at every GroupNorm shape of the step, the backward at the largest
    shapes = sorted(set(run.calls[:n_gn]))
    gen = torch.Generator("cuda").manual_seed(11)
    randn = lambda *s: torch.randn(s, generator=gen, device="cuda")
    cases, eps = [], 1e-6
    for B, HW, C, G, silu in shapes:
        side = int(math.isqrt(HW))
        x = (randn(B, side, side, C) * 2 + 0.5).bfloat16()
        w, b = 1 + 0.1 * randn(C), 0.1 * randn(C)
        err = max_err(groupnorm_silu(x, w, b, G, eps, silu), groupnorm_silu_plain(x, w, b, G, eps, silu),
                      GN_TOL, f"(b) K2 {(B, side, side, C)}")
        plan = launch_plan(B, HW, C, G)
        cases.append(dict(case=f"vae pretrain {B}x{side}x{side}x{C}{' silu' if silu else ''}",
                          max_abs_err=err, path="fused" if plan.path == FUSED else "two-pass"))
        del x
    B, HW, C, G, silu = max(shapes, key=lambda s: s[0] * s[1] * s[2])
    side = int(math.isqrt(HW))
    x = (randn(B, side, side, C) * 2 + 0.5).bfloat16()
    w, b, dy = 1 + 0.1 * randn(C), 0.1 * randn(C), randn(B, side, side, C).bfloat16()
    plan = launch_plan(B, HW, C, G)
    y = torch.empty_like(x)
    scratch = torch.empty(plan.scratch, device="cuda") if plan.scratch else None
    fwd_ms = time_graph_ms(lambda: launch(_entry(), x, w, b, y, scratch, G, eps, silu, plan), 10)
    bwd_ms = time_ms(lambda: groupnorm_silu_vjp(x, w, b, dy, G, eps, silu), 5, 1)
    largest = f"{B}x{side}x{side}x{C}"
    bound = gn_bounds(B, HW, C, silu)
    print(f"[evidence] (b) K2 against groupnorm_silu_plain at the step's {len(shapes)} GroupNorm shapes within "
          f"{GN_TOL} (max abs err {max(c['max_abs_err'] for c in cases):.3g}; paths "
          f"{sorted({c['path'] for c in cases})}); at the largest, {largest}: K2 {fwd_ms:.4f} ms (bound "
          f"{bound['bound_ms']:.4f}), the backward's f32 recompute {bwd_ms:.3f} ms ({card})")
    del x, y, dy, scratch
    torch.cuda.empty_cache()

    # the host's batch against the step: VAE_BATCH views decoded on one thread
    index = pv.build_image_index(split_files(corpus_zips(corpus), 42, 0.1, 0.1, "train")[0])
    t0 = time.perf_counter()
    for i in range(VAE_BATCH):
        pv.load_image(*index[i], EVIDENCE_RES)
    batch_ms = (time.perf_counter() - t0) * 1e3
    print(f"[evidence] (b) the host makes a batch of {VAE_BATCH} in {batch_ms:.1f} ms on one thread against "
          f"a step of {step_ms:.1f} ms; the saved directory loads bitwise into a VAE of NaNs; "
          f"{time.perf_counter() - t_phase:.1f} s")
    metrics = dict(run_s=run_s, step_ms=step_ms, steps_ms=[s["s"] * 1e3 for s in run.steps], peak_gib=peak,
                   host_batch_ms=batch_ms, gn_shapes=cases, gn_largest=largest, gn_fwd_ms=fwd_ms,
                   gn_bwd_recompute_ms=bwd_ms, gn_bound_ms=bound["bound_ms"], params_m=n_params / 1e6,
                   logged=meta["logged"], val_history=meta["val_history"], latent_std=meta["latent_std"],
                   phase_s=time.perf_counter() - t_phase)
    return per_step, metrics, run.traced


def phase_evidence_chain(corpus: str, work: str, card: str) -> tuple:
    """Phase 11c, the chain at ``config/evidence_256.yaml`` on phase 11a's
    corpus: ``tools.pretrain_vae.main --steps CHAIN_VAE_STEPS``,
    ``cli.precompute_latents --checkpoint <vae>``, ``cli.train.main
    --init-params <vae> --latent-cache-dir <cache>`` for CHAIN_TRAIN_STEPS
    steps and ``cli.val.main --checkpoint <run> --vae-params <vae>``. Each
    must finish; the trainer's VAE bitwise the tool's output when loaded;
    each train step's launches as the structure says, no plain call,
    finite losses. Returns (a train step's launches, metrics)."""
    import torch

    from mvd_tpu_torch.cli import precompute_latents
    from mvd_tpu_torch.cli import train as train_cli
    from mvd_tpu_torch.cli import val as val_cli
    from mvd_tpu_torch.tools import pretrain_vae as pv
    from mvd_tpu_torch.train import loop

    t_phase = time.perf_counter()
    vae_dir, cache = os.path.join(work, "vae_evidence"), os.path.join(work, "latents")
    metrics = {}
    # 1. pretrain
    run = _VaeRun()
    t0 = time.perf_counter()
    reset_counts()
    with _Hooks() as hooks:
        run.install(hooks)
        meta = pv.main(["--dataset-path", corpus, "--output", vae_dir, "--config", EVIDENCE_YAML,
                        "--steps", str(CHAIN_VAE_STEPS)])
    run.check("(c) pretrain", CHAIN_VAE_STEPS)
    metrics["pretrain_s"] = time.perf_counter() - t0
    saved = run.saved
    print(f"[evidence] (c) tools.pretrain_vae.main --config config/evidence_256.yaml --steps {CHAIN_VAE_STEPS} "
          f"(VAE {run.vae.cfg.block_out_channels}): {metrics['pretrain_s']:.1f} s, logged {meta['logged']}, "
          f"val {meta['val_history']}")
    del run
    # 2. the latent cache
    t0 = time.perf_counter()
    stats = precompute_latents.main(["--dataset-path", corpus, "--config", EVIDENCE_YAML,
                                     "--checkpoint", vae_dir, "--out", cache])
    metrics["precompute_s"] = time.perf_counter() - t0
    if stats != {"zips": EVIDENCE_OBJECTS, "views": EVIDENCE_OBJECTS * EVIDENCE_VIEWS, "skipped": 0}:
        raise AssertionError(f"(c) precompute_latents: {stats}")
    # 3. train from the cache, the VAE from the tool
    loaded, per_call = [], []

    def check_init(fn):
        def run_(pipe, path):
            fn(pipe, path)
            got = pipe.model["vae"].state_dict()
            loaded.append([k for k, v in saved.items() if not torch.equal(got[k].cpu(), v)])
        return run_

    t0 = time.perf_counter()
    reset_counts()
    with _Hooks() as hooks:
        hooks.wrap(train_cli, "_load_init_params", check_init)
        hooks.wrap(loop, "make_train_step", counted_train_steps(per_call))
        tr = train_cli.main(["--config", EVIDENCE_YAML, "--dataset-path", corpus, "--init-params", vae_dir,
                             "--latent-cache-dir", cache, "--max-steps", str(CHAIN_TRAIN_STEPS),
                             "--output-dir", os.path.join(work, "run")])
    metrics["train_s"] = time.perf_counter() - t0
    if loaded != [[]]:
        raise AssertionError(f"(c) train --init-params: the VAE differs from the tool's output at {loaded}")
    want = expected_train_launches(per_call[0][3])  # from the cache: no VAE encode
    want["groupnorm_silu"] -= 2 * _gn_counts(per_call[0][3]["vae"])[1]
    if len(per_call) != CHAIN_TRAIN_STEPS:
        raise AssertionError(f"(c) train: {len(per_call)} steps")
    for i, (got, plain, loss, _) in enumerate(per_call):
        if got != want or any(plain.values()) or not math.isfinite(loss):
            raise AssertionError(f"(c) train step {i + 1}: launches {got} (expected {want}), plain {plain}, "
                                 f"loss {loss}")
    run_root, losses = tr.dirs["root"], [c[2] for c in per_call]
    metrics["train_step_s"] = [t["step_s"] for t in tr.timings]
    del tr, per_call
    torch.cuda.empty_cache()
    print(f"[evidence] (c) cli.precompute_latents --checkpoint <vae>: {stats} in {metrics['precompute_s']:.1f} s; "
          f"cli.train.main --init-params <vae> --latent-cache-dir <cache> --max-steps {CHAIN_TRAIN_STEPS}: the "
          f"VAE bitwise the tool's output, launches a step {want}, no plain call, noise losses "
          f"{[round(v, 5) for v in losses]}, {metrics['train_s']:.1f} s")
    # 4. score the run on the test split
    t0 = time.perf_counter()
    reset_counts()
    _, overall = val_cli.main(["--config", EVIDENCE_YAML, "--checkpoint", run_root, "--vae-params", vae_dir,
                               "--image-size", str(EVIDENCE_RES), "--dataset-path", corpus,
                               "--num-samples", str(CHAIN_VAL_SAMPLES), "--batch-size", str(CHAIN_VAL_SAMPLES),
                               "--output-dir", os.path.join(work, "val")])
    metrics["val_s"] = time.perf_counter() - t0
    _, plain = read_counts()
    if (overall.get("num_samples") != CHAIN_VAL_SAMPLES or any(plain.values())
            or not all(math.isfinite(overall[k]) for k in ("psnr_mean", "ssim_mean"))):
        raise AssertionError(f"(c) val: {overall}, plain {plain}")
    metrics.update(launches_per_train_step=want, losses=losses,
                   val={k: overall[k] for k in ("num_samples", "psnr_mean", "ssim_mean")},
                   phase_s=time.perf_counter() - t_phase)
    print(f"[evidence] (c) cli.val.main --config config/evidence_256.yaml --checkpoint <run> --vae-params <vae> "
          f"--image-size {EVIDENCE_RES} --num-samples {CHAIN_VAL_SAMPLES}: {metrics['val']} in "
          f"{metrics['val_s']:.1f} s; (c) {metrics['phase_s']:.1f} s ({card})")
    return want, metrics


def phase_evidence(card: str, trace: bool = False) -> tuple:
    """Phase 11 in a temporary directory: (a) the corpus, (b) the VAE
    pretrained at full width, (c) the chain at config/evidence_256.yaml.
    Returns (a pretrain step's launches, a chain train step's, metrics,
    the trace of (b) or None)."""
    work = tempfile.mkdtemp(prefix="mvd_evidence_")
    t_phase = time.perf_counter()
    try:
        corpus = os.path.join(work, "corpus")
        metrics = dict(a=write_evidence_corpus(corpus))
        step_launches, metrics["b"], traced = phase_vae_pretrain(corpus, work, card, trace)
        chain_launches, metrics["c"] = phase_evidence_chain(corpus, work, card)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    metrics["phase_s"] = time.perf_counter() - t_phase
    print(f"[evidence] phase 11 in {metrics['phase_s']:.1f} s ({card})")
    return step_launches, chain_launches, metrics, traced


# device-kernel name patterns (regular expressions) of each port kernel in a
# torch.profiler trace
def _ring_counts_want(n: int, backward: bool) -> dict:
    """The launches of one virtual ring call over n ranks: forward K1 n²
    and K4m n(n - 1); backward K3a and K3b n² each; nothing else."""
    from mvd_tpu_torch.kernels import KERNELS

    want = dict.fromkeys(KERNELS, 0)
    if backward:
        want.update(flash_attn_bwd_dq=n * n, flash_attn_bwd_dkv=n * n)
    else:
        want.update(flash_attn_fwd=n * n, ring_merge=n * (n - 1))
    return want


def check_merge(B: int, S: int, H: int, gen) -> dict:
    """K4m against ``ring_merge_plain`` at (B, S, H), D 64, f32: every
    element within MERGE_ULPS ulp of the terms' magnitude (o: (|o| w +
    |o_i| w_i) / (w + w_i); lse: |m| + |log(w + w_i)|), the largest error
    relative to the plain result printed; two launches bitwise equal; with
    B > 1, batch 0 bitwise unchanged by NaN in all of batch 1. Timed by
    CUDA-graph replay beside the plain version and the bytes bound."""
    import torch

    from mvd_tpu_torch.kernels import ring_merge, ring_merge_plain
    from mvd_tpu_torch.kernels.measure import D, MERGE_ULPS, merge_bounds, time_graph_ms, time_ms

    HD = H * D
    o = torch.randn(B, S, HD, generator=gen, device="cuda")
    o_i = torch.randn(B, S, HD, generator=gen, device="cuda").bfloat16()
    lse, lse_i = (torch.randn(B, S, H, generator=gen, device="cuda") * 2 + 6 for _ in range(2))
    got_o, got_l = o.clone(), lse.clone()
    ring_merge(got_o, got_l, o_i, lse_i, H)
    want_o, want_l = o.clone(), lse.clone()
    ring_merge_plain(want_o, want_l, o_i, lse_i, H)
    torch.cuda.synchronize()
    m = torch.maximum(lse, lse_i)
    w, w_i = torch.exp(lse - m), torch.exp(lse_i - m)
    heads = lambda t: t.view(B, S, H, D)
    scale = ((heads(o).abs() * w[..., None] + heads(o_i.float()).abs() * w_i[..., None])
             / (w + w_i)[..., None]).view(B, S, HD)
    ulp = 2.0 ** -24
    o_ulps = ((got_o - want_o).abs() / (scale * ulp)).max().item()
    l_ulps = ((got_l - want_l).abs() / ((m.abs() + torch.log(w + w_i).abs()) * ulp)).max().item()
    rel = ((got_o - want_o).abs() / want_o.abs().clamp_min(1e-6)).max().item()
    label = f"merge B{B} S{S} H{H}"
    if not (torch.isfinite(got_o).all() and torch.isfinite(got_l).all()
            and o_ulps <= MERGE_ULPS and l_ulps <= MERGE_ULPS):
        raise AssertionError(f"K4m {label}: o off by {o_ulps:.2f} ulp, lse by {l_ulps:.2f} ulp "
                             f"(at most {MERGE_ULPS})")
    again_o, again_l = o.clone(), lse.clone()
    ring_merge(again_o, again_l, o_i, lse_i, H)
    if not (torch.equal(again_o, got_o) and torch.equal(again_l, got_l)):
        raise AssertionError(f"K4m {label}: two launches differ")
    if B > 1:
        nan_o, nan_l = o.clone(), lse.clone()
        nan_o[1], nan_l[1] = float("nan"), float("nan")
        ring_merge(nan_o, nan_l, o_i, lse_i, H)
        if not (torch.equal(nan_o[0], got_o[0]) and torch.equal(nan_l[0], got_l[0])):
            raise AssertionError(f"K4m {label}: NaN in batch 1 changed batch 0")
    err = (got_o - want_o).abs().max().item()
    ms = time_graph_ms(lambda: ring_merge(got_o, got_l, o_i, lse_i, H))
    plain_ms = time_ms(lambda: ring_merge_plain(want_o, want_l, o_i, lse_i, H), 5)
    bound = merge_bounds(B, S, H)
    print(f"[ring] K4m {label}: within {MERGE_ULPS} ulp of the plain version (o {o_ulps:.2f} ulp, lse "
          f"{l_ulps:.2f} ulp, max relative error {rel:.3g}, max abs err {err:.3g}); bitwise repeatable"
          + ("; batch 0 unchanged by NaN in batch 1" if B > 1 else "")
          + f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound['bound_ms']:.4f} ms "
          f"({bound['bytes'] / 1e6:.1f} MB, bytes): share {bound['bound_ms'] / ms:.3f}")
    return dict(case=label, max_abs_err=err, max_rel_err=rel, ulps=max(o_ulps, l_ulps), ms=ms,
                plain_ms=plain_ms, bound_ms=bound["bound_ms"], bound_by=bound["bound_by"],
                bound_share=bound["bound_ms"] / ms, library_ms=None)


def _plain_ring_fwd(qs, ks, vs, H):
    """The virtual ring's schedule with the plain version of every call."""
    from mvd_tpu_torch.kernels import attention_packed_plain, ring_merge_plain

    n = len(qs)
    for r in range(n):
        o, lse = attention_packed_plain(qs[r], ks[r], vs[r], H)
        o = o.float()
        for hop in range(1, n):
            o_i, lse_i = attention_packed_plain(qs[r], ks[(r - hop) % n], vs[(r - hop) % n], H)
            ring_merge_plain(o, lse, o_i, lse_i, H)


def _plain_ring_bwd(qs, ks, vs, outs, lses, dos, H):
    from mvd_tpu_torch.kernels import attention_packed_bwd_plain

    n = len(qs)
    for hop in range(n):
        for r in range(n):
            attention_packed_bwd_plain(qs[r], ks[(r - hop) % n], vs[(r - hop) % n], outs[r], lses[r],
                                       dos[r], H)


def check_ring(label: str, B: int, S: int, H: int, n: int, clock: float, gen) -> tuple:
    """K4, the ring of n virtual ranks (S query rows and keys each),
    forward and backward, with the counts set to 0 before each and read
    after: exactly ``_ring_counts_want``'s launches and no plain call. Held
    on every row to the unsharded K1 and K3a/K3b at the whole length n*S
    (``check_attention`` / ``check_grad``: kernel against kernel, since the
    plain versions do not fit at these lengths). Then timed in turns with
    the unsharded kernels, beside SDPA and the bounds; the plain schedule
    timed once (forward and, at B 1, backward; at B > 1 on batch row 0).
    Returns (the case, the forward's and the backward's launches)."""
    import torch
    import torch.nn.functional as F

    from mvd_tpu_torch.kernels import (
        flash_attention_packed_bwd,
        flash_attention_packed_fwd,
        ring_attention_virtual_bwd,
        ring_attention_virtual_fwd,
    )
    from mvd_tpu_torch.kernels.measure import (
        D,
        attn_bounds,
        bwd_bounds,
        check_attention,
        check_grad,
        merge_bounds,
        time_ms,
        turns,
    )

    L = n * S
    q, k, v, do = (torch.randn(B, L, H * D, generator=gen, device="cuda").bfloat16() for _ in range(4))
    split = lambda t: [c.contiguous() for c in t.split(S, dim=1)]
    qs, ks, vs, dos = map(split, (q, k, v, do))
    counted = {}
    for part, fn in (("fwd", lambda: ring_attention_virtual_fwd(qs, ks, vs, H)),
                     ("bwd", lambda: ring_attention_virtual_bwd(qs, ks, vs, outs, lses, dos, H))):
        reset_counts()
        res = fn()
        torch.cuda.synchronize()
        launches, plain = read_counts()
        want = _ring_counts_want(n, part == "bwd")
        if launches != want or any(plain.values()):
            raise AssertionError(f"K4 {label} {part}: launches {launches} != {want}, or plain calls {plain}")
        counted[part] = launches
        if part == "fwd":
            outs, lses = res
        else:
            grads = res
    ref_out, ref_lse = flash_attention_packed_fwd(q, k, v, H)
    err, rel = check_attention(torch.cat(outs, 1), torch.cat(lses, 1), ref_out, ref_lse, f"K4 {label}")
    ref_grads = flash_attention_packed_bwd(q, k, v, ref_out, ref_lse, do, H)
    checks = {name: check_grad(torch.cat(g, 1), r, f"K4 {label} {name}")
              for name, g, r in zip(("dq", "dk", "dv"), grads, ref_grads)}
    del ref_grads, grads
    fns = {"ring fwd": lambda: ring_attention_virtual_fwd(qs, ks, vs, H),
           "K1": lambda: flash_attention_packed_fwd(q, k, v, H),
           "ring bwd": lambda: ring_attention_virtual_bwd(qs, ks, vs, outs, lses, dos, H),
           "K3": lambda: flash_attention_packed_bwd(q, k, v, ref_out, ref_lse, do, H)}
    times = {key: [] for key in fns}
    for key in turns(fns, 2):
        times[key].append(time_ms(fns[key], 3, warmup=1))
    ms = {key: statistics.median(t) for key, t in times.items()}
    heads = lambda t: t.view(B, L, H, D).transpose(1, 2)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(heads(q), heads(k), heads(v)), 3, warmup=1)
    pick = lambda ts: [t[:1] for t in ts]
    plain = {}
    for part, fn, args in (("fwd", _plain_ring_fwd, (qs, ks, vs, H)),
                           ("bwd", _plain_ring_bwd, (qs, ks, vs, outs, lses, dos, H))):
        if part == "bwd" and B > 1:
            continue  # (B 1, S 9216)² f32 scores per hop, several at once: not measured
        args = args if B == 1 else tuple(pick(a) if isinstance(a, list) else a for a in args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        plain[part] = (time.perf_counter() - t0) * 1e3
    torch.cuda.empty_cache()
    fb, bb = attn_bounds(B, L, L, H, clock), bwd_bounds(B, L, L, H)
    fwd_bound = max(fb["ops_ms"], fb["bytes_ms"]) + (n - 1) * n * merge_bounds(B, S, H)["bound_ms"]
    bwd_bound = bb["dq"]["bound_ms"] + bb["dkv"]["bound_ms"]
    case = dict(case=label, B=B, S=S, H=H, ranks=n, max_abs_err=err, rel_rms=rel,
                grad_rel_rms={k_: c[2] for k_, c in checks.items()},
                fwd_ms=ms["ring fwd"], unsharded_k1_ms=ms["K1"], sdpa_fwd_ms=lib_ms,
                bwd_ms=ms["ring bwd"], unsharded_k3_ms=ms["K3"], fwd_bound_ms=fwd_bound,
                bwd_bound_ms=bwd_bound, plain_fwd_ms=plain["fwd"], plain_bwd_ms=plain.get("bwd"),
                plain_rows=1, launches_fwd=counted["fwd"], launches_bwd=counted["bwd"])
    print(f"[ring] K4 {label} (B {B}, {n} ranks x S {S}, H {H}): forward within K1's tolerance of the "
          f"unsharded K1 at {L} (err {err:.3g}, rel RMS {rel:.3g}), gradients within K3's ("
          + ", ".join(f"{k_} rel RMS {c[2]:.3g}" for k_, c in checks.items())
          + f"); launches forward {counted['fwd']}, backward {counted['bwd']}; forward {ms['ring fwd']:.3f} "
          f"ms (unsharded K1 {ms['K1']:.3f}, sdpa {lib_ms:.3f}, bound {fwd_bound:.3f}), backward "
          f"{ms['ring bwd']:.3f} ms (unsharded K3a+K3b {ms['K3']:.3f}, bound {bwd_bound:.3f}); plain "
          f"schedule forward {plain['fwd']:.1f} ms" + (f", backward {plain['bwd']:.1f} ms" if "bwd" in plain
                                                       else " on batch row 0, backward not measured"))
    del q, k, v, do, qs, ks, vs, dos, outs, lses, ref_out, ref_lse
    torch.cuda.empty_cache()
    return case, counted


def phase_ring():
    """7a: K4m at each RING_CASES rank shape, then the virtual ring (K4) at
    each RING_CASES case. Returns (K4m's cases, K4's cases, the launches of
    the counted ring calls summed)."""
    import torch

    from mvd_tpu_torch.kernels.measure import RING_CASES, sm_clock_hz

    clock = sm_clock_hz()
    gen = torch.Generator("cuda").manual_seed(11)
    merges = [check_merge(B, S, H, gen) for _, B, S, H, _ in RING_CASES]
    rings, launches = [], {}
    for label, B, S, H, n in RING_CASES:
        case, counted = check_ring(label, B, S, H, n, clock, gen)
        rings.append(case)
        for part in counted.values():
            for key, c in part.items():
                launches[key] = launches.get(key, 0) + c
    return merges, rings, launches


def phase_nccl():
    """7b: ``distributed.initialize`` from torchrun's variables (127.0.0.1,
    a free port, world 1) and ``make_mesh(data=1)``; then phase 4's train
    step (batch 6 at 768², remat on) from two equal states, 2 steps each:
    without a mesh, and through the data-parallel branch and its NCCL
    all-reduce, counted (one a step). The losses and the updated
    parameters and AdamW state must be bitwise equal. The group is
    destroyed after."""
    import socket

    import torch
    import torch.distributed as dist

    from mvd_tpu_torch import distributed
    from mvd_tpu_torch.config import ModelConfig, TrainConfig, UNetConfig
    from mvd_tpu_torch.mesh import make_mesh
    from mvd_tpu_torch.pipeline.pipeline import build_schedule
    from mvd_tpu_torch.train import make_train_step

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE="1", RANK="0", LOCAL_RANK="0")
    saved = {key: os.environ.get(key) for key in env}
    os.environ.update(env)
    t0 = time.perf_counter()
    try:
        if not distributed.initialize() or dist.get_backend() != "nccl":
            raise AssertionError("distributed.initialize did not start an NCCL group from torchrun's variables")
        mesh = make_mesh(data=1)
        plain_state, plain_step, batch, _ = train_setup()
        mesh_state, _, _, _ = train_setup()
        mcfg = ModelConfig(unet=UNetConfig(sample_size=TRAIN_RES // 8), dtype="bfloat16")
        mesh_step = make_train_step(build_schedule(mcfg).to("cuda"), TrainConfig(model=mcfg), mesh=mesh)
        reduces = []
        all_reduce = dist.all_reduce

        def counted(*args, **kwargs):
            reduces.append(args[0].numel())
            return all_reduce(*args, **kwargs)

        losses = {"plain": [], "mesh": []}
        for name, state, step in (("plain", plain_state, plain_step), ("mesh", mesh_state, mesh_step)):
            gen = torch.Generator("cuda").manual_seed(5)
            dist.all_reduce = counted
            try:
                for _ in range(2):
                    losses[name].append(step(state, batch, generator=gen)["noise_loss"])
            finally:
                dist.all_reduce = all_reduce
            torch.cuda.synchronize()
        if len(reduces) != 2:
            raise AssertionError(f"7b: {len(reduces)} all-reduces in 2 steps, not one a step")
        if not all(torch.equal(a, b) for a, b in zip(losses["plain"], losses["mesh"])):
            raise AssertionError(f"7b: losses differ: {losses}")
        _assert_state_equal(mesh_state, _state_snapshot(plain_state), "7b: the mesh step's state")
        secs = time.perf_counter() - t0
        print(f"[nccl] world 1 over NCCL ({dist.get_backend()}, process group from MASTER_ADDR/PORT, "
              f"WORLD_SIZE, RANK, LOCAL_RANK): 2 train steps through the data-parallel branch, one "
              f"all-reduce a step of {reduces[0]} f32 values (the trainable gradients and the loss "
              f"metrics), bitwise equal to 2 steps without a mesh (losses "
              f"{[float(x) for x in losses['mesh']]}, parameters and AdamW state); {secs:.1f} s")
        del plain_state, mesh_state, batch
        torch.cuda.empty_cache()
        return dict(all_reduce_values=reduces[0], losses=[float(x) for x in losses["mesh"]], secs=secs)
    finally:
        distributed.shutdown()
        for key, val in saved.items():
            if val is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = val


# phase 7c: the model axis as virtual ranks on one card (NCCL refuses two
# ranks on one card). The model-axis sizes, and the K1 sites whose heads the
# axis cuts on the main path (the 1280-wide levels, 20 heads: every
# projection there is at least min_dim 1024 wide): (label, B, Sq, Sk); the
# adapters' sites at 16² have the self shape
MODEL_AXIS_RANKS = (2, 4)
MODEL_AXIS_SITES = [
    ("self 16x16", VIEWS, 256, 256),
    ("text 16x16", VIEWS, 256, 77),
    ("self 8x8 (mid)", VIEWS, 64, 64),
    ("text 8x8 (mid)", VIEWS, 64, 77),
]
MODEL_AXIS_HEADS = 20
# one 16² Transformer2D of the sharded networks against the unsharded bf16
# block at the same input: relative RMS error (the error does not compound
# through one block)
MODEL_AXIS_BLOCK_REL_RMS = 1e-2
# one whole denoise step against the unsharded bf16 step, relative RMS: the
# bf16 step's own floor is measured in the same run (the unsharded step at
# inputs moved by MODEL_AXIS_FLOOR_EPS relative, which moves the f32 function
# by about as much, is 1.31% off itself on the H100: a rounding flip anywhere
# compounds through the random-weight UNet), and the sharded step may be
# off by 1e-2 or MODEL_AXIS_FLOOR_FACTOR times that floor, whichever is larger
MODEL_AXIS_STEP_REL_RMS = 1e-2
MODEL_AXIS_FLOOR_EPS = 1e-6
MODEL_AXIS_FLOOR_FACTOR = 1.25


def phase_model_axis_kernels(card: str) -> list:
    """7c (a): K1 at the shard's heads (H 10 at n = 2, H 5 at n = 4) at
    every MODEL_AXIS_SITES shape, held to its plain version within phase 2's
    tolerances and timed beside SDPA at the same shape and beside the
    unsharded K1 (H 20) at the site, each by CUDA-graph replay (a launch
    here takes a few microseconds, under the host's cost of a call);
    returns the cases."""
    import torch
    import torch.nn.functional as F

    from mvd_tpu_torch.kernels import attention_packed_plain, flash_attention_packed_fwd
    from mvd_tpu_torch.kernels.measure import (
        D,
        attn_bounds,
        check_attention,
        sm_clock_hz,
        time_graph_ms,
        time_ms,
    )

    clock = sm_clock_hz()
    gen = torch.Generator("cuda").manual_seed(14)
    cases = []
    for label, B, Sq, Sk in MODEL_AXIS_SITES:
        make = lambda S, H: torch.randn(B, S, H * D, generator=gen, device="cuda").bfloat16()
        whole = [make(S, MODEL_AXIS_HEADS) for S in (Sq, Sk, Sk)]
        whole_ms = time_graph_ms(lambda: flash_attention_packed_fwd(*whole, MODEL_AXIS_HEADS))
        for n in MODEL_AXIS_RANKS:
            H = MODEL_AXIS_HEADS // n
            q, k, v = make(Sq, H), make(Sk, H), make(Sk, H)
            out, lse = flash_attention_packed_fwd(q, k, v, H)
            torch.cuda.synchronize()
            ref_out, ref_lse = attention_packed_plain(q, k, v, H)
            err, rel = check_attention(out, lse, ref_out, ref_lse, f"K1 {label} H{H}")
            ms = time_graph_ms(lambda: flash_attention_packed_fwd(q, k, v, H))
            plain_ms = time_ms(lambda: attention_packed_plain(q, k, v, H), 10, 1)
            split = lambda t, S: t.view(B, S, H, D).transpose(1, 2)
            lib_ms = time_graph_ms(lambda: F.scaled_dot_product_attention(split(q, Sq), split(k, Sk), split(v, Sk)))
            case = dict(case=f"model axis {label} H{H} (n {n})", max_abs_err=err, rel_rms=rel, ms=ms,
                        plain_ms=plain_ms, library_ms=lib_ms, unsharded_h20_ms=whole_ms,
                        **_attn_bound_fields(attn_bounds(B, Sq, Sk, H, clock), ms))
            cases.append(case)
            print(f"[model] K1 {label} B{B} at the shard's H {H} (n {n}): err {err:.3g}, relative RMS "
                  f"{rel:.3g}; kernel {ms:.4f} ms (x{n} shards {n * ms:.4f}) against the unsharded "
                  f"H {MODEL_AXIS_HEADS} {whole_ms:.4f} ms; plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms; "
                  + _bound_text(case, clock) + f" ({card})")
    return cases


def phase_model_axis(call, bf16_images, card: str):
    """7c (b): phase 3's call (4 views at 512², DDPM 20, phase 3's weights
    and noise) with the networks cut over n = 2 and 4 virtual ranks by
    ``shard_params_model_parallel`` (min_dim 1024, the JAX default): K1 and
    K2 launches exactly ``expected_launches`` of the sharded networks, no
    plain call, the denoise loop under the sync check; the 16² Transformer2D
    ``down_2_attn_0`` (K1 on the shard's heads, the adapters on raw
    features, GEGLU) within MODEL_AXIS_BLOCK_REL_RMS of the unsharded bf16
    block at the same input; one denoise step (conditioning included)
    against the unsharded bf16 step at the same inputs, within the bound of
    MODEL_AXIS_STEP_REL_RMS and the measured bf16 floor; prints the images'
    PSNR against phase 3's, one traced call's device ms and idle share, and
    the parameter bytes per rank. Returns (the launches by n, metrics)."""
    import numpy as np
    import torch

    from mvd_tpu_torch.camera import orbit_cameras
    from mvd_tpu_torch.parallel import model_parallel_shardings, shard_params_model_parallel
    from mvd_tpu_torch.pipeline import MVDPipeline
    from mvd_tpu_torch.pipeline.pipeline import build_model
    from mvd_tpu_torch.tensor_parallel import rank_param_bytes, virtual_model_axis

    pipe, prompts, kwargs = call
    t_phase = time.perf_counter()
    whole_bytes = {net: rank_param_bytes(pipe.model[net]) for net in pipe.model}

    # one step's inputs: phase 3's text and source latents, a seeded noisy sample
    gen = torch.Generator("cuda").manual_seed(3)
    cams = orbit_cameras(VIEWS)
    src_cam = torch.as_tensor(np.tile(cams[:1], (VIEWS, 1, 1)), dtype=torch.float32, device="cuda")
    tgt_cam = torch.as_tensor(cams, dtype=torch.float32, device="cuda")
    lat = torch.randn(VIEWS, RES // 8, RES // 8, 4, generator=gen, device="cuda")
    src_lat = torch.randn(VIEWS, RES // 8, RES // 8, 4, generator=gen, device="cuda")
    t = torch.tensor(500, device="cuda")
    C, S = pipe.config.unet.block_out_channels[2], RES // 8 // 4
    block_in = (torch.randn(VIEWS, C, S, S, generator=gen, device="cuda").bfloat16()
                .contiguous(memory_format=torch.channels_last))
    block_ctx = torch.randn(VIEWS, 77, pipe.config.unet.cross_attention_dim, generator=gen, device="cuda")
    block_ref = torch.randn(VIEWS, S * S, C, generator=gen, device="cuda")
    rel_rms = lambda got, want: ((got - want).pow(2).mean().sqrt() / want.pow(2).mean().sqrt()).item()

    def step(p, x=lat):
        model = p.compute_model
        with torch.inference_mode():
            text = pipe.compute_model["text_encoder"](pipe._ids(prompts, 1))
            film, refs = model["mvd"].prepare_conditioning(text, src_cam, tgt_cam, src_lat, cfg_batch=VIEWS,
                                                           precompute_kv=True)
            return model["mvd"].denoise(x, t, text, film, refs, 1.0).float()

    def block(p):
        with torch.inference_mode():
            return p.compute_model["mvd"].unet.down_2_attn_0(block_in, block_ctx, block_ref, 1.0).float()

    want_step, want_block = step(pipe), block(pipe)
    moved = lat * (1 + MODEL_AXIS_FLOOR_EPS * torch.randn(lat.shape, generator=gen, device="cuda"))
    floor = rel_rms(step(pipe, moved), want_step)
    step_bar = max(MODEL_AXIS_STEP_REL_RMS, MODEL_AXIS_FLOOR_FACTOR * floor)
    print(f"[model] the unsharded bf16 step at inputs moved by {MODEL_AXIS_FLOOR_EPS} relative is off "
          f"itself by relative RMS {floor:.4g} (the bf16 floor); a sharded step may be off by "
          f"max({MODEL_AXIS_STEP_REL_RMS}, {MODEL_AXIS_FLOOR_FACTOR} x floor) = {step_bar:.4g}")
    launches, metrics = {}, {"rank_bytes_unsharded": whole_bytes, "step_floor_rel_rms": floor,
                             "step_bar": step_bar}
    for n in MODEL_AXIS_RANKS:
        t_n = time.perf_counter()
        with torch.device("cuda"):
            model = build_model(pipe.config)
        model.load_state_dict(pipe.model.state_dict())
        axis = virtual_model_axis(n)
        plan = model_parallel_shardings(model["mvd"], axis)
        mvd_params = dict(model["mvd"].named_parameters())
        marked_bytes = sum(mvd_params[name].nbytes for name in plan.marked)
        shard_params_model_parallel(model, axis)
        tp = MVDPipeline(pipe.config, model, "cuda", pipe.tokenizer)
        tp.compute_model  # cast once, outside the counted run
        rank_bytes = {net: rank_param_bytes(model[net]) for net in model}
        torch.cuda.synchronize()
        secs = {"build_shard_cast": time.perf_counter() - t_n}
        want = expected_launches(tp, STEPS)
        out, first_s, counted = _counted_call(lambda: tp(prompts, seed=0, **kwargs), want,
                                              f"[model] n {n} virtual ranks:", ("denoise_loop",), tp)
        images = out["images"]
        _check_images(images, f"model axis n {n}")
        psnr = _psnr(images, bf16_images)
        t0 = time.perf_counter()
        got_block = block(tp)
        block_rel = rel_rms(got_block, want_block)
        if not (torch.isfinite(got_block).all() and block_rel <= MODEL_AXIS_BLOCK_REL_RMS):
            raise AssertionError(f"model axis n {n}: the 16² Transformer2D off the unsharded bf16 block by "
                                 f"relative RMS {block_rel:.3g} (at most {MODEL_AXIS_BLOCK_REL_RMS})")
        got_step = step(tp)
        rel = rel_rms(got_step, want_step)
        if not (torch.isfinite(got_step).all() and rel <= step_bar):
            raise AssertionError(f"model axis n {n}: one step off the unsharded bf16 step by relative RMS "
                                 f"{rel:.3g} (at most {step_bar:.3g})")
        secs["checks"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        traced = trace_run(lambda: tp(prompts, seed=2, **kwargs), f"model axis n {n} generation", top=3,
                           cpu=False)
        secs["trace"] = time.perf_counter() - t0
        mvd_whole, mvd_rank = whole_bytes["mvd"], rank_bytes["mvd"]
        jax_rank = mvd_whole - marked_bytes * (n - 1) // n
        print(f"[model] n {n}: images PSNR against phase 3's {psnr:.2f} dB (same weights and noise); the "
              f"16² Transformer2D relative RMS {block_rel:.3g} of the unsharded bf16 block; one denoise "
              f"step {rel:.4g} of the unsharded bf16 step (floor {floor:.4g}); first call {first_s:.2f} s, "
              f"traced call device {traced['device_busy_ms']:.1f} ms, idle share {traced['idle_share']:.3f} "
              f"(the n ranks run one after another: no speed claimed); multi-view UNet f32 bytes per rank "
              f"{mvd_rank} of {mvd_whole} (-{1 - mvd_rank / mvd_whole:.4f}; the JAX rule's marked "
              f"{len(plan.marked)} tensors alone: -{1 - jax_rank / mvd_whole:.4f}), CLIP "
              f"{rank_bytes['text_encoder']} of {whole_bytes['text_encoder']}, VAE {rank_bytes['vae']} of "
              f"{whole_bytes['vae']} ({card}); s: " + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()))
        launches[n] = counted
        metrics[f"n{n}"] = dict(
            first_call_s=first_s, psnr_vs_phase3_db=psnr, block_rel_rms=block_rel, step_rel_rms=rel,
            launches=counted,
            device_ms=traced["device_busy_ms"], idle_share=traced["idle_share"], wall_ms=traced["wall_ms"],
            k1_device_ms=traced["port_kernels_ms"]["K1 flash_fwd (packed)"], rank_bytes=rank_bytes,
            mvd_marked_tensors=len(plan.marked), mvd_partner_tensors=len(plan.partners),
            mvd_rank_share=mvd_rank / mvd_whole, mvd_jax_rule_rank_share=jax_rank / mvd_whole, secs=secs)
        del tp, model, out, images
        torch.cuda.empty_cache()
    metrics["generation_s"] = time.perf_counter() - t_phase
    print(f"[model] phase 7c (b) in {metrics['generation_s']:.1f} s ({card})")
    return launches, metrics


TRACE_GROUPS = {
    "K1 flash_fwd (packed)": (r"flash_fwd_wgmma<\d+, false>",),
    "K5 flash_fwd (B, H, S, D)": (r"flash_fwd_wgmma<\d+, true>",),
    "K6 flash_fwd_int8_wgmma": ("flash_fwd_int8_wgmma",),
    "K6q k6q_stats, k6q_quantize": (r"k6q_(stats|quantize)",),
    "K3a flash_bwd_dq": (r"flash_bwd_dq_wgmma<",),
    "K3b flash_bwd_dkv": (r"flash_bwd_dkv_wgmma<",),
    "K2 gn_fused_cluster, gn_partial_*": ("gn_fused_cluster", r"gn_partial_(stats|apply)"),
}
TRACE_TOP = 25


def trace_run(fn, label: str, top: int = TRACE_TOP, cpu: bool = True, ops=()) -> dict:
    """Trace one call of ``fn`` and report where the device time goes (the
    ``top`` kernels by device time, and for each host op named in ``ops``
    the device time of the kernels it launched, its children's included);
    ``cpu=False`` records the device's activity only, which the profiler
    sums in a fraction of the time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if cpu else [ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms <= 0:
        raise AssertionError(f"the {label} trace holds no device time")
    ours = {g: [e for e in kernels if any(re.search(f, e.key) for f in frags)]
            for g, frags in TRACE_GROUPS.items()}
    shares = {g: sum(e.self_device_time_total for e in es) / 1e3 for g, es in ours.items()}
    counts = {g: sum(e.count for e in es) for g, es in ours.items()}
    rows = [dict(kernel=e.key[:120], calls=e.count, device_ms=e.self_device_time_total / 1e3)
            for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]]
    n_launch = sum(e.count for e in kernels)
    # an op's events nest (the autograd node inside its engine call): the outermost holds the rest
    op_ms = {op: max([e.device_time_total / 1e3 for e in prof.key_averages()
                      if e.device_type == DeviceType.CPU and e.key.endswith(op)], default=0.0) for op in ops}
    print(f"[trace] {label}: wall {wall_ms:.1f} ms, device kernels {busy_ms:.1f} ms, "
          f"idle share {1 - busy_ms / wall_ms:.3f}, kernel launches {n_launch}")
    for g, ms in shares.items():
        print(f"[trace]   {g}: {ms:.2f} ms ({ms / busy_ms:.3f} of device time) in {counts[g]} kernels")
    for op, ms in op_ms.items():
        print(f"[trace]   under {op}: {ms:.2f} ms ({ms / busy_ms:.3f} of device time)")
    for r in rows:
        print(f"[trace]   {r['device_ms']:9.3f} ms {r['calls']:6d}x  {r['kernel']}")
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms, idle_share=1 - busy_ms / wall_ms,
                kernel_launches=n_launch, port_kernels_ms=shares, port_kernel_counts=counts, ops_ms=op_ms,
                top=rows)


KERNEL_META = {
    "flash_attn_fwd": dict(
        name="K1 packed flash-attention forward", route="cuda",
        source="mvd_tpu_torch/csrc/flash_attn_fwd.cu",
        replaces="mvd_tpu/kernels/flash_attention.py:170", primary="self 64x64",
    ),
    "flash_attn_bwd_dq": dict(
        name="K3a flash-attention backward dq (flash_bwd_dq_wgmma)", route="cuda",
        source="mvd_tpu_torch/csrc/flash_attn_bwd.cu",
        replaces="mvd_tpu/kernels/flash_attention.py:557", primary="self 96x96",
    ),
    "flash_attn_bwd_dkv": dict(
        name="K3b flash-attention backward dk/dv (flash_bwd_dkv_wgmma)", route="cuda",
        source="mvd_tpu_torch/csrc/flash_attn_bwd.cu",
        replaces="mvd_tpu/kernels/flash_attention.py:598", primary="self 96x96",
    ),
    "groupnorm_silu": dict(
        name="K2 GroupNorm(+SiLU) forward (gn_fused_cluster; gn_partial_stats + gn_partial_apply)",
        route="cuda",
        source="mvd_tpu_torch/csrc/groupnorm_silu.cu",
        replaces="mvd_tpu/kernels/groupnorm_silu.py:77", primary="unet 64x64x320 silu",
    ),
    "flash_attn_int8": dict(
        name="K6 int8 packed flash-attention forward (flash_fwd_int8_wgmma)", route="cuda",
        source="mvd_tpu_torch/csrc/flash_attn_int8.cu",
        replaces="mvd_tpu/kernels/flash_attention.py:354", primary="self 64x64",
    ),
    "quantize_int8": dict(
        name="K6q K6's quantizers, fused (k6q_stats + k6q_quantize)", route="cuda",
        source="mvd_tpu_torch/csrc/quantize_int8.cu",
        replaces="mvd_tpu/kernels/flash_attention.py:450", primary="self 64x64",
    ),
    "flash_attn_fwd_bhsd": dict(
        name="K5 (B, H, S, D) flash-attention forward", route="cuda",
        source="mvd_tpu_torch/csrc/flash_attn_fwd.cu",
        replaces="mvd_tpu/kernels/flash_attention.py:69", primary="self 64x64",
    ),
    "ring_merge": dict(
        name="K4m ring attention's merge of a hop (ring_merge_kernel)", route="cuda",
        source="mvd_tpu_torch/csrc/ring_merge.cu",
        replaces="mvd_tpu/kernels/ring_attention.py:104", primary="merge B1 S4096 H5",
    ),
}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--trace", metavar="OUT.json", default=None,
                   help="also trace one more main-path generation and write the table here")
    args = p.parse_args(argv)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs only on the GPU", file=sys.stderr)
        return 2
    # the port beside this script, never a copy installed elsewhere
    spec = importlib.util.find_spec("mvd_tpu_torch")
    here = os.path.dirname(os.path.abspath(__file__))
    if spec is None or os.path.dirname(os.path.dirname(os.path.abspath(spec.origin))) != here:
        print("chip_smoke: mvd_tpu_torch not found beside this script; run it from "
              "the repository root", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from mvd_tpu_torch.kernels.measure import card_line

    card = card_line()
    print(f"[card] {card}")

    phase_build()
    results = phase_kernels()
    results.update(phase_int8_kernels())
    results.update(phase_k5())
    launches, main_metrics, call, images = phase_main_path()
    traces = {}
    if args.trace:
        pipe, prompts, kwargs = call
        traces = trace_run(lambda: pipe(prompts, seed=2, **kwargs), "generation")
        del pipe
        k2 = "K2 gn_fused_cluster, gn_partial_*"
        k2_ms, gn = traces["port_kernels_ms"][k2], main_metrics["groupnorm"]
        print(f"[trace] K2: {k2_ms:.2f} ms of device time in {traces['port_kernel_counts'][k2]} "
              f"kernels (the plans say {gn['device_kernels']}) against the summed bytes bound "
              f"{gn['bound_ms']:.3f} ms of its {gn['calls']} calls: share {gn['bound_ms'] / k2_ms:.3f}")
    int8_launches, int8_metrics, int8_call = phase_int8_main_path(call, images)
    if args.trace:
        pipe, prompts, kwargs = int8_call
        traces["int8_generation"] = trace_run(lambda: pipe(prompts, seed=2, **kwargs), "int8 generation")
        del pipe
    del int8_call
    torch.cuda.empty_cache()
    entry_metrics = phase_entry_points(call, images, trace=bool(args.trace))
    if args.trace:
        traces["entry_points"] = entry_metrics.pop("traces")
    joint_launches, joint_int8_launches, joint_metrics = phase_joint_generation(call, images)
    # 7c, on phase 3's pipeline and weights while they are up
    t_model = time.perf_counter()
    results["flash_attn_fwd"].extend(phase_model_axis_kernels(card))
    model_launches, model_metrics = phase_model_axis(call, images, card)
    model_metrics["phase_s"] = time.perf_counter() - t_model
    t0 = time.perf_counter()
    frames = frame_sources()
    print(f"[readers] (d) the arithmetic-coded and lossless frames written and the WebP sources checked in "
          f"{time.perf_counter() - t0:.2f} s ({card})")
    prog_metrics = phase_reader_generation(call, frames, card)  # 9d, on phase 3's pipeline while it is up
    orbax_src = orbax_export(call)  # phase 10b's source: phase 3's weights in host memory
    orbax_src["images"] = images
    del call, images  # free the generation pipelines before the train phase
    torch.cuda.empty_cache()
    results.update(phase_train_kernels())
    train_launches, train_metrics = phase_train()
    if args.trace:
        traces["train_step"] = train_metrics["remat_on"]["trace"]
    corpus_dir = tempfile.mkdtemp(prefix="mvd_corpus_")
    try:
        corpus = os.path.join(corpus_dir, "corpus")
        t0 = time.perf_counter()
        corpus_bytes = write_corpus(corpus)
        print(f"[train_entry] corpus: {CORPUS_OBJECTS} objects x {CORPUS_VIEWS} views, RGBA "
              f"{CORPUS_RES}², {corpus_bytes} bytes, written in {time.perf_counter() - t0:.1f} s")
        entry_train_launches, entry_train_metrics, entry_trace, run_root = phase_train_entry(
            corpus, corpus_bytes, corpus_dir, trace=bool(args.trace))
        if args.trace:
            traces["train_entry"] = entry_trace
        t_joint = time.perf_counter()
        for key, rows in phase_joint_kernels().items():
            results[key].extend(rows)
        _, joint_train_metrics = phase_train(views=JOINT_TRAIN_VIEWS, tag="joint-train")
        joint_train_launches = joint_train_metrics["remat_on"]["launches_per_step"]
        joint_entry_launches, joint_entry_metrics = phase_joint_train_entry(corpus)
        torch.cuda.empty_cache()
        val_launches, val_metrics = phase_val(corpus, run_root, card)
        torch.cuda.empty_cache()
        co3d_launches, reader_metrics = phase_readers(corpus, frames, card)
        reader_metrics["generation"] = prog_metrics
        torch.cuda.empty_cache()
        orbax_metrics = phase_orbax(orbax_src, corpus, run_root, card)
        del orbax_src
    finally:
        shutil.rmtree(corpus_dir, ignore_errors=True)
    joint_metrics.update(train=joint_train_metrics, train_entry=joint_entry_metrics,
                         train_phase_s=time.perf_counter() - t_joint)
    print(f"[joint] phase 6: generation parts {joint_metrics['phase_s']:.1f} s, kernels and train parts "
          f"{joint_metrics['train_phase_s']:.1f} s")
    torch.cuda.empty_cache()
    vae_step_launches, chain_launches, evidence_metrics, vae_trace = phase_evidence(card, trace=bool(args.trace))
    results["groupnorm_silu"].extend(evidence_metrics["b"]["gn_shapes"])
    if args.trace:
        traces["vae_pretrain_step"] = vae_trace
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
        with open(args.trace, "w") as f:
            json.dump(dict(card=card, **traces), f, indent=1)
    torch.cuda.empty_cache()
    t_multi = time.perf_counter()
    merges, rings, ring_launches = phase_ring()
    results["ring_merge"] = merges
    multi_metrics = dict(rings=rings, nccl=phase_nccl(), phase_s=time.perf_counter() - t_multi)
    print(f"[multi] phase 7: {multi_metrics['phase_s']:.1f} s ({card})")

    kernels = []
    for key, meta in KERNEL_META.items():
        cases = results[key]
        prim = next(c for c in cases if c["case"] == meta["primary"])
        # each kernel's launches are those of the path it serves: generation
        # for K1/K2 (their int8-generation and train-step launches beside
        # them), the int8 generation for K6 and K6q, the train steps for
        # K3a/K3b; K5 is an entry point no model path calls; K4m those of
        # phase 7a's counted ring calls
        on_train = key.startswith("flash_attn_bwd")
        path_launches = int8_launches if key in ("flash_attn_int8", "quantize_int8") else launches
        if key == "ring_merge":
            path_launches = ring_launches
        kernels.append(dict(
            name=meta["name"], route=meta["route"], source=meta["source"],
            replaces=meta["replaces"],
            launches=train_launches[key] if on_train else path_launches[key],
            max_abs_err=max(c["max_abs_err"] for c in cases),
            ms=prim["ms"], plain_ms=prim["plain_ms"], bound_ms=prim["bound_ms"],
            bound_by=prim["bound_by"], library_ms=prim["library_ms"],
            shape=meta["primary"], train_launches=train_launches[key],
            int8_generation_launches=int8_launches[key],
            train_entry_launches=entry_train_launches[key],
            joint_generation_launches=joint_launches[key],
            joint_int8_generation_launches=joint_int8_launches[key],
            joint_train_launches=joint_train_launches[key],
            joint_train_entry_launches=joint_entry_launches[key],
            val_launches_per_batch=val_launches[key],
            co3d_train_launches_per_step=co3d_launches[key],
            vae_pretrain_launches_per_step=vae_step_launches[key],
            evidence_train_launches_per_step=chain_launches[key],
            model_axis_generation_launches={str(n): c[key] for n, c in model_launches.items()},
            cases=cases,
        ))
    print(f"[main] {json.dumps(main_metrics)}")
    print(f"[int8] {json.dumps(int8_metrics)}")
    print(f"[entry] {json.dumps(entry_metrics)}")
    print(f"[train] {json.dumps(train_metrics)}")
    print(f"[train_entry] {json.dumps(entry_train_metrics)}")
    print(f"[joint] {json.dumps(joint_metrics)}")
    print(f"[multi] {json.dumps(multi_metrics)}")
    print(f"[model] {json.dumps(model_metrics)}")
    print(f"[val] {json.dumps(val_metrics)}")
    print(f"[readers] {json.dumps(reader_metrics)}")
    print(f"[orbax] {json.dumps(orbax_metrics)}")
    print(f"[evidence] {json.dumps(evidence_metrics)}")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
