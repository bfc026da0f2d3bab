#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``mvd_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Three phases; any failure exits non-zero:

1. build: compiles every kernel source under ``mvd_tpu_torch/csrc/`` (one
   ``nvcc`` each, in parallel) and prints the seconds and ptxas's report;
2. kernels: holds each kernel against its plain PyTorch version on the card,
   in bf16, at the main path's shapes, and times the kernel, the plain
   version and one PyTorch library call computing the same function (a
   yardstick the port never calls), beside the least time the card could
   take (bytes over 3.35 TB/s or operations over 989 TFLOP/s bf16 tensor /
   67 TFLOP/s f32, whichever is larger);
3. main path: ``MVDPipeline.create`` at full SD2.1 width with random weights
   from seed 0, then 4-view 512² generation, 20-step DDPM, guidance 1.0, a
   zero source image and ``orbit_cameras(4)``, in bf16. Checks the images,
   that every kernel launched exactly as often as the model structure says
   and that no plain version ran, then times a second call.

With ``--trace OUT.json`` it then traces one more generation of the same
call with ``torch.profiler`` and prints, and writes to OUT.json, the wall
time, the summed device-kernel time, the device's idle share, the share of
each port kernel and the kernels that take the most device time.

Prints the card's name and power limit, a ``{"kernels": [...]}`` line and,
last, ``{"ok": true, "device": {...}}``. Without a GPU, or outside the
repository, it exits non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_TENSOR_FLOPS = 989e12
F32_FLOPS = 67e12
STEPS, VIEWS, RES = 20, 4, 512


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip().splitlines()
        return out[0] if out else "unknown, unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown, unknown"


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_build() -> float:
    from mvd_tpu_torch.kernels import KERNEL_SOURCES, _build

    secs = _build.build_all(KERNEL_SOURCES)
    for name in KERNEL_SOURCES:
        _build.load(name)
        for line in _build.build_logs.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"[build] {name}: {line.strip()}")
    print(f"[build] {len(KERNEL_SOURCES)} kernels built in {secs:.1f} s")
    return secs


# (label, B, Sq, Sk, heads): every K1 site of the 512² main path, D = 64
ATTN_CASES = [
    ("self 64x64", 4, 4096, 4096, 5),
    ("text 64x64", 4, 4096, 77, 5),
    ("self 32x32", 4, 1024, 1024, 10),
    ("text 32x32", 4, 1024, 77, 10),
    ("self 16x16", 4, 256, 256, 20),
    ("self 8x8 (mid)", 4, 64, 64, 20),
    ("text 8x8 (mid)", 4, 64, 77, 20),
]
# (label, B, H, W, C, silu): UNet and VAE GroupNorm shapes
GN_CASES = [
    ("unet 64x64x320 silu", 4, 64, 64, 320, True),
    ("unet 64x64x320 transformer", 4, 64, 64, 320, False),
    ("unet 32x32x960 silu", 4, 32, 32, 960, True),
    ("unet 16x16x2560 silu", 4, 16, 16, 2560, True),
    ("unet 8x8x1280 silu", 4, 8, 8, 1280, True),
    ("vae 512x512x256 silu", 4, 512, 512, 256, True),
    ("vae 512x512x128 silu", 4, 512, 512, 128, True),
    ("vae 64x64x512 attn", 4, 64, 64, 512, False),
]
# K1 out: one bf16 ulp is at most 2^-7 = 0.0078 of |out|, so rtol 2e-2 covers a
# rounding step either way; atol 2e-3 is below a tenth of the smallest typical
# |out| (about 0.026 at Sk = 4096). The relative RMS error over the whole
# output catches a small error spread over every element (P rounded too
# coarsely, a wrong rescale) that stays under the elementwise bound.
ATTN_TOL = dict(atol=2e-3, rtol=2e-2)
ATTN_REL_RMS = 1e-2
LSE_TOL = dict(atol=2e-3, rtol=1e-4)
GN_TOL = dict(atol=1e-2, rtol=1e-2)  # one bf16 rounding of y (|y| up to ~5)


def _max_err(got, want, tol, what):
    import torch

    got, want = got.float(), want.float()
    err = (got - want).abs()
    bad = err > tol["atol"] + tol["rtol"] * want.abs()
    if not torch.isfinite(got).all() or bad.any():
        raise AssertionError(f"{what}: {int(bad.sum())} elements off, max abs err {err.max().item():.3g}")
    return err.max().item()


def phase_kernels():
    import torch
    import torch.nn.functional as F

    from mvd_tpu_torch.kernels import (
        attention_packed_plain,
        flash_attention_packed_fwd,
        groupnorm_silu,
        groupnorm_silu_plain,
    )

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
        err = max(_max_err(out, ref_out, ATTN_TOL, f"K1 {label} out"),
                  _max_err(lse, ref_lse, LSE_TOL, f"K1 {label} lse"))
        ref_rms = ref_out.float().pow(2).mean().sqrt().item()
        rel_rms = (out.float() - ref_out.float()).pow(2).mean().sqrt().item() / ref_rms
        print(f"[kernels] K1 {label}: typical |out| (RMS) {ref_rms:.4f}, "
              f"relative RMS error {rel_rms:.3g}")
        if not rel_rms <= ATTN_REL_RMS:
            raise AssertionError(f"K1 {label} out: relative RMS error {rel_rms:.3g} > {ATTN_REL_RMS}")
        iters = max(3, min(50, int(2e10 / (B * H * Sq * Sk * D))))
        ms = time_ms(lambda: flash_attention_packed_fwd(q, k, v, H), iters)
        plain_ms = time_ms(lambda: attention_packed_plain(q, k, v, H), max(2, iters // 4), 1)
        split = lambda t, s: t.view(B, s, H, D).transpose(1, 2)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(split(q, Sq), split(k, Sk), split(v, Sk)), iters)
        flops = 4.0 * B * H * Sq * Sk * D
        nbytes = 2.0 * (2 * B * Sq * H * D + 2 * B * Sk * H * D) + 4.0 * B * Sq * H
        t_ops, t_bytes = flops / BF16_TENSOR_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        results["flash_attn_fwd"].append(dict(
            case=label, max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
            bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes",
        ))
        print(f"[kernels] K1 {label}: err {err:.3g} kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
              f"sdpa {lib_ms:.4f} ms bound {max(t_ops, t_bytes):.4f} ms")
        del q, k, v, out, lse, ref_out, ref_lse
    for label, B, Hh, W, C, silu in GN_CASES:
        G = 32
        x = (randn(B, Hh, W, C) * 2 + 0.5).bfloat16()
        w, b = 1 + 0.1 * randn(C), 0.1 * randn(C)
        eps = 1e-6
        y = groupnorm_silu(x, w, b, G, eps, silu)
        torch.cuda.synchronize()
        err = _max_err(y, groupnorm_silu_plain(x, w, b, G, eps, silu), GN_TOL, f"K2 {label}")
        iters = max(5, min(100, int(4e9 / x.numel())))
        ms = time_ms(lambda: groupnorm_silu(x, w, b, G, eps, silu), iters)
        plain_ms = time_ms(lambda: groupnorm_silu_plain(x, w, b, G, eps, silu), max(2, iters // 4), 1)
        xn = x.permute(0, 3, 1, 2)  # NCHW view in channels_last memory
        wb, bb = w.bfloat16(), b.bfloat16()  # F.group_norm takes params in x's dtype

        def lib():
            yy = F.group_norm(xn, G, wb, bb, eps)
            return F.silu(yy) if silu else yy

        lib_ms = time_ms(lib, iters)
        nbytes = 2.0 * 2 * x.numel() + 2 * 4.0 * C
        flops = (10.0 if silu else 5.0) * x.numel()
        t_ops, t_bytes = flops / F32_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        results["groupnorm_silu"].append(dict(
            case=label, max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
            bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes",
        ))
        print(f"[kernels] K2 {label}: err {err:.3g} kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
              f"group_norm+silu {lib_ms:.4f} ms bound {max(t_ops, t_bytes):.4f} ms")
        del x, y
    torch.cuda.empty_cache()
    return results


def expected_launches(pipe, steps: int):
    """Launch counts the model structure implies for one generation with
    guidance 1.0 and image conditioning: attention sites per transformer
    block are attn1 + attn2 in the feature pass, plus both adapters in each
    denoise; every GroupNorm runs once per UNet pass (feature pass + steps)
    and once per VAE encode (one source image) and decode."""
    from mvd_tpu_torch.nn.layers import BasicTransformerBlock, GroupNorm

    mvd, vae = pipe.model["mvd"], pipe.model["vae"]
    blocks = sum(isinstance(m, BasicTransformerBlock) for m in mvd.unet.modules())
    unet_gn = sum(isinstance(m, GroupNorm) for m in mvd.unet.modules())
    vae_gn = sum(isinstance(m, GroupNorm) for m in vae.modules())
    return {
        "flash_attn_fwd": blocks * 2 + blocks * 4 * steps,
        "groupnorm_silu": unet_gn * (steps + 1) + vae_gn,
    }


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


def phase_main_path():
    import torch

    from mvd_tpu_torch.kernels import KERNEL_SOURCES

    t0 = time.perf_counter()
    pipe, prompts, kwargs = main_path_call()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in pipe.model.parameters())
    print(f"[main] created full-width pipeline ({n_params / 1e6:.1f} M params) "
          f"in {time.perf_counter() - t0:.1f} s")
    pipe.compute_model  # cast once, outside the counted run
    for fn in KERNEL_SOURCES.values():
        fn.launches = fn.plain_calls = 0
    t0 = time.perf_counter()
    images = pipe(prompts, seed=0, **kwargs)["images"]
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in KERNEL_SOURCES.items()}
    plain = {name: fn.plain_calls for name, fn in KERNEL_SOURCES.items()}
    want = expected_launches(pipe, STEPS)
    print(f"[main] first call {first_s:.2f} s; launches {launches} (expected {want}); plain calls {plain}")
    if launches != want or any(plain.values()):
        raise AssertionError(f"kernel launches {launches} != expected {want}, or plain calls {plain}")
    if tuple(images.shape) != (VIEWS, RES, RES, 3):
        raise AssertionError(f"images shape {tuple(images.shape)}")
    if not torch.isfinite(images).all() or images.min() < 0 or images.max() > 1:
        raise AssertionError("images not finite or outside [0, 1]")
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
    metrics = dict(sec_per_batch=dt, img_per_s=VIEWS / dt, peak_gib=peak, first_call_s=first_s)
    return launches, metrics, (pipe, prompts, kwargs)


# device-kernel name fragments of each port kernel in a torch.profiler trace
TRACE_GROUPS = {"K1 flash_fwd_packed": ("flash_fwd_packed",), "K2 gn_*": ("gn_stats", "gn_apply")}
TRACE_TOP = 25


def phase_trace(call, out_path: str) -> None:
    """Trace one more generation of the main path and report where the
    device time goes."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    pipe, prompts, kwargs = call
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe(prompts, seed=2, **kwargs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms <= 0:
        raise AssertionError("the trace holds no device time")
    shares = {
        g: sum(e.self_device_time_total for e in kernels if any(f in e.key for f in frags)) / 1e3
        for g, frags in TRACE_GROUPS.items()
    }
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:TRACE_TOP]
    rows = [dict(kernel=e.key[:120], calls=e.count, device_ms=e.self_device_time_total / 1e3)
            for e in top]
    n_launch = sum(e.count for e in kernels)
    print(f"[trace] wall {wall_ms:.1f} ms, device kernels {busy_ms:.1f} ms, "
          f"idle share {1 - busy_ms / wall_ms:.3f}, kernel launches {n_launch}")
    for g, ms in shares.items():
        print(f"[trace]   {g}: {ms:.2f} ms ({ms / busy_ms:.3f} of device time)")
    for r in rows:
        print(f"[trace]   {r['device_ms']:9.3f} ms {r['calls']:6d}x  {r['kernel']}")
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(dict(card=card_line(), wall_ms=wall_ms, device_busy_ms=busy_ms,
                       idle_share=1 - busy_ms / wall_ms, kernel_launches=n_launch,
                       port_kernels_ms=shares, top=rows), f, indent=1)


KERNEL_META = {
    "flash_attn_fwd": dict(
        name="K1 packed flash-attention forward", route="cuda",
        source="mvd_tpu_torch/csrc/flash_attn_fwd.cu",
        replaces="mvd_tpu/kernels/flash_attention.py:170", primary="self 64x64",
    ),
    "groupnorm_silu": dict(
        name="K2 GroupNorm(+SiLU) forward", route="cuda",
        source="mvd_tpu_torch/csrc/groupnorm_silu.cu",
        replaces="mvd_tpu/kernels/groupnorm_silu.py:77", primary="unet 64x64x320 silu",
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
    card = card_line()
    print(f"[card] {card}")

    phase_build()
    results = phase_kernels()
    launches, main_metrics, call = phase_main_path()
    if args.trace:
        phase_trace(call, args.trace)

    kernels = []
    for key, meta in KERNEL_META.items():
        cases = results[key]
        prim = next(c for c in cases if c["case"] == meta["primary"])
        kernels.append(dict(
            name=meta["name"], route=meta["route"], source=meta["source"],
            replaces=meta["replaces"], launches=launches[key],
            max_abs_err=max(c["max_abs_err"] for c in cases),
            ms=prim["ms"], plain_ms=prim["plain_ms"], bound_ms=prim["bound_ms"],
            bound_by=prim["bound_by"], library_ms=prim["library_ms"],
            shape=meta["primary"], cases=cases,
        ))
    print(f"[main] {json.dumps(main_metrics)}")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
