"""Time builds of the K1/K5 forward kernel against each other, on the GPU.

    python -m mvd_tpu_torch.cli.bench_flash_fwd \\
        [--build LABEL=PATH]... [--rounds N] [--out OUT.json]

Builds ``csrc/flash_attn_fwd.cu`` as it stands ("change") and once more for
each ``--build``, whose PATH is another ``flash_attn_fwd.cu`` with the same
C entries (for instance a parent checkout's), one ``nvcc`` each, in
parallel. Every build is held against the plain version at every site of
``ATTN_CASES`` (K1, packed), ``K5_SITE`` ((B, H, S, D)) and ``TRAIN_SITE``
(K1) with ``check_attention``, the check ``chip_smoke.py`` makes (out
``ATTN_TOL`` and ``ATTN_REL_RMS``, lse ``LSE_TOL``), then timed there in
turns (the builds in order, then in reverse, ``--rounds`` times) beside
``scaled_dot_product_attention`` on the same inputs and the site's bounds
(``attn_bounds``). Prints one line per site and build and, last, one JSON
object; the builds are called through their C entries with the outputs
allocated once, so the times hold no wrapper cost; beside them, the host's
wall time per call of 50 calls in a row (the C entry's cost on the CPU
while the card is busy). A build that disagrees with the plain version is
timed all the same, listed under "wrong", and makes the exit code 1.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import sys
import time

from mvd_tpu_torch.kernels.measure import (
    ATTN_CASES,
    D,
    attn_bounds,
    check_attention,
    sm_clock_hz,
    time_ms,
    turns,
)

K5_SITE = ("K5 self 64x64", 4, 4096, 4096, 5)
TRAIN_SITE = ("train self 96x96", 6, 9216, 9216, 5)  # K1's largest site in the 768² train step


def _builds(args) -> dict:
    """label -> (packed entry, (B, H, S, D) entry) of every build."""
    from mvd_tpu_torch.kernels import _build

    entries = {}
    for label, (dll, _) in _build.build_variants("flash_attn_fwd", args.build).items():
        pair = (dll.flash_attn_fwd_packed_bf16, dll.flash_attn_fwd_bhsd_bf16)
        for fn in pair:
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        entries[label] = pair
    return entries


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--build", action="append", default=[], metavar="LABEL=PATH",
                   help="another build: the path of a flash_attn_fwd.cu")
    p.add_argument("--rounds", type=int, default=1)
    p.add_argument("--out", default=None, metavar="OUT.json")
    args = p.parse_args(argv)
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("bench_flash_fwd: no CUDA device", file=sys.stderr)
        return 2
    from mvd_tpu_torch.kernels import attention_packed_plain, attention_plain

    entries = _builds(args)
    order = turns(entries, args.rounds)
    clock = sm_clock_hz()
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator("cuda").manual_seed(0)
    randn = lambda *s: torch.randn(s, generator=gen, device="cuda").bfloat16()
    rows, wrong = [], []
    for label, B, Sq, Sk, H in ATTN_CASES + [K5_SITE, TRAIN_SITE]:
        bhsd = label == K5_SITE[0]
        if bhsd:
            q, k, v = randn(B, H, Sq, D), randn(B, H, Sk, D), randn(B, H, Sk, D)
            ref_out, ref_lse = attention_plain(q, k, v)
            lse = torch.empty(B, H, Sq, device="cuda")
        else:
            q, k, v = randn(B, Sq, H * D), randn(B, Sk, H * D), randn(B, Sk, H * D)
            ref_out, ref_lse = attention_packed_plain(q, k, v, H)
            lse = torch.empty(B, Sq, H, device="cuda")
        out = torch.empty_like(q)
        args_of = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                   B, Sq, Sk, H, D, 1.0 / math.sqrt(D), stream)
        row = dict(case=label, B=B, Sq=Sq, Sk=Sk, heads=H, **attn_bounds(B, Sq, Sk, H, clock), ms={})
        for name, pair in entries.items():
            fn = pair[1 if bhsd else 0]
            out.zero_()
            err = fn(*args_of)
            torch.cuda.synchronize()
            if err:
                raise RuntimeError(f"{name} at {label}: error {err}")
            try:
                err, rel_rms = check_attention(out, lse, ref_out, ref_lse, f"{name} at {label}")
                row.setdefault("max_abs_err", {})[name] = err
                row.setdefault("rel_rms", {})[name] = rel_rms
            except AssertionError as e:
                wrong.append(str(e))
                print(f"[fwd] WRONG {wrong[-1]}")
        iters = max(10, min(200, int(4e10 / (B * H * Sq * Sk * D))))
        for name in order:
            fn = entries[name][1 if bhsd else 0]
            row["ms"].setdefault(name, []).append(time_ms(lambda: fn(*args_of), iters))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(50):
                fn(*args_of)
            row.setdefault("host_us", {}).setdefault(name, []).append((time.perf_counter() - t0) / 50 * 1e6)
            torch.cuda.synchronize()
        qh, kh, vh = (q, k, v) if bhsd else (
            t.view(B, s, H, D).transpose(1, 2) for t, s in ((q, Sq), (k, Sk), (v, Sk)))
        row["sdpa_ms"] = time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh), iters)
        bound = max(row["ops_ms"], row["bytes_ms"])
        for name, ms in row["ms"].items():
            mean = sum(ms) / len(ms)
            print(f"[fwd] {label}: {name} {' / '.join(f'{x:.4f}' for x in ms)} ms "
                  f"(ops bound share {row['ops_ms'] / mean:.3f}, exp bound share "
                  f"{row['exp_ms'] / mean:.3f}); host {' / '.join(f'{x:.1f}' for x in row['host_us'][name])} "
                  f"us per call")
        print(f"[fwd] {label}: sdpa {row['sdpa_ms']:.4f} ms, bound {bound:.4f} ms "
              f"(ops {row['ops_ms']:.4f}, bytes {row['bytes_ms']:.4f}, exp {row['exp_ms']:.4f} "
              f"at {clock / 1e6:.0f} MHz)")
        rows.append(row)
        del q, k, v, out, lse, ref_out, ref_lse
        torch.cuda.empty_cache()
    result = dict(card=torch.cuda.get_device_name(0), sm_clock_max_hz=clock, sites=rows, wrong=wrong)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
