"""Time builds of the K2 GroupNorm(+SiLU) kernel against each other, on the GPU.

    python -m mvd_tpu_torch.cli.bench_groupnorm \\
        [--build LABEL=PATH]... [--rounds N] [--sweep] [--out OUT.json]

Builds ``csrc/groupnorm_silu.cu`` as it stands ("change") and once more for
each ``--build``, whose PATH is another ``groupnorm_silu.cu`` (for instance a
parent checkout's), one ``nvcc`` each, in parallel. A build whose library
has ``groupnorm_silu_max_clusters`` takes ``launch_plan``'s plan; one
without it is the earlier kernel, whose C entry takes a (B, G, 2) f32
statistics buffer that it clears itself. Every build is held against
``groupnorm_silu_plain`` with ``GN_TOL`` at every shape of ``GN_CASES`` and
``TRAIN_GN_CASES``, then timed there in turns (the builds in order, then in
reverse, ``--rounds`` times) through its C entry with y and scratch
allocated once, beside ``F.group_norm`` + ``F.silu`` on the same input and
the shape's bound (``gn_bounds``). Where the change's other path can take
the shape too, that path is timed beside it (the two sides of the switch in
``launch_plan``); ``--sweep`` times every fused plan and the two-pass plan
of the change at every shape. Prints one line per shape and build and, last,
one JSON object. A build that disagrees with the plain version is timed all
the same, listed under "wrong", and makes the exit code 1.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys
import time

from mvd_tpu_torch.kernels.measure import (
    GN_CASES,
    GN_TOL,
    TRAIN_GN_CASES,
    gn_bounds,
    max_err,
    time_graph_ms,
    time_ms,
    turns,
)

G, EPS = 32, 1e-6
_P = ctypes.c_void_p


def _builds(args) -> dict:
    """label -> (C entry, takes a plan) of every build."""
    from mvd_tpu_torch.kernels import _build

    entries = {}
    for label, (dll, _) in _build.build_variants("groupnorm_silu", args.build).items():
        fn = dll.groupnorm_silu_bf16
        planned = hasattr(dll, "groupnorm_silu_max_clusters")
        if planned:
            fn.argtypes = [_P] * 5 + [ctypes.c_int] * 4 + [ctypes.c_float] + [ctypes.c_int] * 7 + [_P]
            dll.groupnorm_silu_max_clusters.argtypes = [ctypes.c_int] * 3
            dll.groupnorm_silu_max_clusters.restype = ctypes.c_int
        else:
            fn.argtypes = [_P] * 5 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int, _P]
        fn.restype = ctypes.c_int
        entries[label] = (fn, planned, dll)
    return entries


def _plan_text(plan) -> str:
    path = "fused" if plan.path == 0 else "two-pass"
    return (f"{path} cluster {plan.cluster} set {plan.set} rows {plan.rows} threads "
            f"{plan.threads} smem {plan.smem} CTAs {plan.grid[0] * plan.grid[1] * plan.grid[2]}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--build", action="append", default=[], metavar="LABEL=PATH",
                   help="another build: the path of a groupnorm_silu.cu")
    p.add_argument("--rounds", type=int, default=1)
    p.add_argument("--sweep", action="store_true",
                   help="also time every fused plan and the two-pass plan of the change")
    p.add_argument("--out", default=None, metavar="OUT.json")
    args = p.parse_args(argv)
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("bench_groupnorm: no CUDA device", file=sys.stderr)
        return 2
    from mvd_tpu_torch.kernels import _build
    from mvd_tpu_torch.kernels.groupnorm_silu import (
        FUSED,
        fused_plans,
        groupnorm_silu_plain,
        launch,
        launch_plan,
        plan_fused,
        plan_two_pass,
    )

    entries = _builds(args)
    order = turns(entries, args.rounds)
    gen = torch.Generator("cuda").manual_seed(0)
    rows, wrong = [], []
    for label, B, H, W, C, silu in GN_CASES + TRAIN_GN_CASES:
        HW = H * W
        x = (torch.randn((B, H, W, C), generator=gen, device="cuda") * 2 + 0.5).bfloat16()
        w = 1 + 0.1 * torch.randn(C, generator=gen, device="cuda")
        b = 0.1 * torch.randn(C, generator=gen, device="cuda")
        want = groupnorm_silu_plain(x, w, b, G, EPS, silu)
        y = torch.empty_like(x)
        plan = launch_plan(B, HW, C, G)
        scratch = torch.empty(max(plan.scratch, B * G * 2), device="cuda")
        calls = {}
        for name, (fn, planned, _) in entries.items():
            if planned:
                calls[name] = (lambda fn=fn, pl=plan: launch(fn, x, w, b, y, scratch, G, EPS, silu, pl))
            else:
                calls[name] = (lambda fn=fn: _build.check(fn(
                    x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), scratch.data_ptr(),
                    B, HW, C, G, EPS, int(silu), torch.cuda.current_stream().cuda_stream),
                    "groupnorm_silu_bf16"))
        row = dict(case=label, B=B, HW=HW, C=C, silu=silu, plan=_plan_text(plan),
                   **gn_bounds(B, HW, C, silu), ms={}, max_abs_err={})
        for name, call in calls.items():
            y.zero_()
            call()
            torch.cuda.synchronize()
            try:
                row["max_abs_err"][name] = max_err(y, want, GN_TOL, f"{name} at {label}")
            except AssertionError as e:
                wrong.append(str(e))
                print(f"[gn] WRONG {wrong[-1]}")
        iters = max(5, min(100, int(4e9 / x.numel())))
        for name in order:
            row["ms"].setdefault(name, []).append(time_graph_ms(calls[name], iters))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                calls[name]()
            torch.cuda.synchronize()
            row.setdefault("host_us", {}).setdefault(name, []).append((time.perf_counter() - t0) / 20 * 1e6)
        xn, wb, bb = x.permute(0, 3, 1, 2), w.bfloat16(), b.bfloat16()
        lib = lambda: F.silu(F.group_norm(xn, G, wb, bb, EPS)) if silu else F.group_norm(xn, G, wb, bb, EPS)
        row["library_ms"] = time_ms(lib, iters)
        fn_change, _, dll = entries["change"]
        row["max_clusters"] = dll.groupnorm_silu_max_clusters(plan.cluster, plan.threads, plan.smem) \
            if plan.path == FUSED else None
        # the other side of the switch, where the other path takes the shape
        other = plan_two_pass(B, HW, C, G) if plan.path == FUSED else (
            plan_fused(B, HW, C, G) or min(fused_plans(B, HW, C, G), key=lambda kp: kp[0], default=(None, None))[1])
        alternatives = [other] if other is not None else []
        if args.sweep:
            alternatives = [pl for _, pl in sorted(fused_plans(B, HW, C, G), key=lambda kp: kp[0])]
            alternatives.append(plan_two_pass(B, HW, C, G))
        row["alternatives"] = []
        for pl in alternatives:
            if pl == plan:
                continue
            scr = torch.empty(max(pl.scratch, 1), device="cuda")
            call = lambda pl=pl, scr=scr: launch(fn_change, x, w, b, y, scr, G, EPS, silu, pl)
            ms = None
            try:
                y.zero_()
                call()
                torch.cuda.synchronize()
                max_err(y, want, GN_TOL, f"change ({_plan_text(pl)}) at {label}")
                ms = time_graph_ms(call, iters)
            except AssertionError as e:
                wrong.append(str(e))
                print(f"[gn] WRONG {wrong[-1]}")
            except RuntimeError as e:  # a plan the card cannot launch
                print(f"[gn] {label}: {_plan_text(pl)} does not launch: {e}")
            row["alternatives"].append(dict(plan=_plan_text(pl), ms=ms))
        bound = row["bound_ms"]
        print(f"[gn] {label}: plan {row['plan']} (clusters resident at once "
              f"{row['max_clusters']}); bound {bound:.4f} ms ({row['bound_by']}), "
              f"group_norm+silu {row['library_ms']:.4f} ms")
        for name, ms in row["ms"].items():
            mean = sum(ms) / len(ms)
            print(f"[gn] {label}: {name} {' / '.join(f'{t:.4f}' for t in ms)} ms "
                  f"(share of bound {bound / mean:.3f}); host "
                  f"{' / '.join(f'{t:.1f}' for t in row['host_us'][name])} us per call")
        for alt in row["alternatives"]:
            ms = alt["ms"]
            print(f"[gn] {label}:   other plan {alt['plan']}: "
                  + (f"{ms:.4f} ms (share {bound / ms:.3f})" if ms else "failed"))
        rows.append(row)
        del x, y, want, scratch
        torch.cuda.empty_cache()
    result = dict(card=torch.cuda.get_device_name(0), shapes=rows, wrong=wrong)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
