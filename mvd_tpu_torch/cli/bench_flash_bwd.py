"""Time builds of the K3a/K3b backward kernels against each other, on the GPU.

    python -m mvd_tpu_torch.cli.bench_flash_bwd \\
        [--build LABEL=PATH]... [--rounds N] [--out OUT.json]

The mirror of ``bench_flash_fwd``. Builds ``csrc/flash_attn_bwd.cu`` as it
stands ("change") and once more for each ``--build``, whose PATH is another
``flash_attn_bwd.cu`` with the same C entries (for instance a parent
checkout's), one ``nvcc`` each, in parallel. A build that exports
``flash_attn_bwd_rows`` takes lse and delta as ``bwd_stats`` pads them, f32
(B, H, Sq_pad); one without it takes them as the wrappers do, (B, Sq, H)
packed and (B, H, Sq). Every build is held to ``check_grad``, the check
``chip_smoke.py`` makes, for dq, dk and dv at every site of
``TRAIN_ATTN_CASES`` in both layouts, against the plain backward one batch
row at a time. Then K3a and K3b of each build are timed at every site in the
packed layout, the train step's, in turns (the builds in order, then in
reverse, ``--rounds`` times), beside the backward of
``scaled_dot_product_attention`` on the same inputs (q's gradient alone
beside K3a, k's and v's beside K3b) and the bounds (``bwd_bounds``). The
builds are called through their C entries with the outputs allocated once,
so the times hold no wrapper cost. Prints one line per site and kernel and,
last, one JSON object. A build that disagrees with the plain version is
timed all the same, listed under "wrong", and makes the exit code 1.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import sys

from mvd_tpu_torch.kernels.measure import (
    D,
    TRAIN_ATTN_CASES,
    bwd_bounds,
    card_line,
    check_grad,
    plain_bwd_by_row,
    time_ms,
    turns,
)

LAYOUTS = ("packed", "bhsd")


def _builds(args) -> dict:
    """label -> {"dq": {layout: entry}, "dkv": {layout: entry}, "padded": bool}
    of every build."""
    from mvd_tpu_torch.kernels import _build

    builds = {}
    for label, (dll, _) in _build.build_variants("flash_attn_bwd", args.build).items():
        build = {"dq": {"packed": dll.flash_attn_bwd_dq_bf16, "bhsd": dll.flash_attn_bwd_dq_bhsd_bf16},
                 "dkv": {"packed": dll.flash_attn_bwd_dkv_bf16, "bhsd": dll.flash_attn_bwd_dkv_bhsd_bf16},
                 "padded": hasattr(dll, "flash_attn_bwd_rows")}
        for part, n_ptr in (("dq", 7), ("dkv", 8)):
            for fn in build[part].values():
                fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
                fn.restype = ctypes.c_int
        builds[label] = build
    return builds


def _inputs(B, Sq, Sk, H, layout, gen):
    """q, k, v, dO, the K1/K5 forward's out and lse, and the statistics in
    both forms: public (lse, delta) and padded (``bwd_stats``)."""
    import torch

    from mvd_tpu_torch.kernels import flash_attention_fwd, flash_attention_packed_fwd
    from mvd_tpu_torch.kernels.flash_attention import _delta, bwd_stats

    shape = (lambda S: (B, H, S, D)) if layout == "bhsd" else (lambda S: (B, S, H * D))
    randn = lambda S: torch.randn(shape(S), generator=gen, device="cuda").bfloat16()
    q, k, v, do = randn(Sq), randn(Sk), randn(Sk), randn(Sq)
    out, lse = flash_attention_fwd(q, k, v) if layout == "bhsd" else flash_attention_packed_fwd(q, k, v, H)
    stats = {False: (lse, _delta(out, do, H, layout)), True: bwd_stats(out, do, lse, H, layout)}
    return q, k, v, do, out, lse, stats


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--build", action="append", default=[], metavar="LABEL=PATH",
                   help="another build: the path of a flash_attn_bwd.cu")
    p.add_argument("--rounds", type=int, default=1)
    p.add_argument("--out", default=None, metavar="OUT.json")
    args = p.parse_args(argv)
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("bench_flash_bwd: no CUDA device", file=sys.stderr)
        return 2
    print(f"[card] {card_line()}")
    builds = _builds(args)
    order = turns(builds, args.rounds)
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator("cuda").manual_seed(0)
    scale = 1.0 / math.sqrt(D)
    rows, wrong = [], []
    for label, B, Sq, Sk, H in TRAIN_ATTN_CASES:
        row = dict(case=label, B=B, Sq=Sq, Sk=Sk, heads=H, bounds=bwd_bounds(B, Sq, Sk, H),
                   ms={"dq": {}, "dkv": {}}, max_abs_err={}, rel_rms={})
        for layout in LAYOUTS:
            q, k, v, do, out, lse, stats = _inputs(B, Sq, Sk, H, layout, gen)
            want = plain_bwd_by_row(q, k, v, out, lse, do, H, layout)
            grads = (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v))
            dims = (B, Sq, Sk, H, D, scale, stream)
            for name, build in builds.items():
                lse_in, delta_in = stats[build["padded"]]
                ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse_in.data_ptr(),
                        delta_in.data_ptr())
                for g in grads:
                    g.zero_()
                errs = (build["dq"][layout](*ptrs, grads[0].data_ptr(), *dims),
                        build["dkv"][layout](*ptrs, grads[1].data_ptr(), grads[2].data_ptr(), *dims))
                torch.cuda.synchronize()
                if any(errs):
                    raise RuntimeError(f"{name} at {label} {layout}: errors {errs}")
                for part, g, w in zip(("dq", "dk", "dv"), grads, want):
                    what = f"{name} at {label} {layout} {part}"
                    try:
                        err, _, rel = check_grad(g, w, what)
                        key = f"{name} {layout} {part}"
                        row["max_abs_err"][key], row["rel_rms"][key] = err, rel
                    except AssertionError as e:
                        wrong.append(str(e))
                        print(f"[bwd] WRONG {wrong[-1]}")
            if layout == "packed":
                timed = (q, k, v, do, stats, grads, dims)
            del want
        q, k, v, do, stats, grads, dims = timed
        iters = max(10, min(200, int(2e10 / (B * H * Sq * Sk * D))))
        for name in order:
            build = builds[name]
            lse_in, delta_in = stats[build["padded"]]
            ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse_in.data_ptr(),
                    delta_in.data_ptr())
            row["ms"]["dq"].setdefault(name, []).append(time_ms(
                lambda: build["dq"]["packed"](*ptrs, grads[0].data_ptr(), *dims), iters))
            row["ms"]["dkv"].setdefault(name, []).append(time_ms(
                lambda: build["dkv"]["packed"](*ptrs, grads[1].data_ptr(), grads[2].data_ptr(), *dims),
                iters))

        def sdpa_bwd_ms(grad_q: bool):
            split = lambda t, s: t.view(B, s, H, D).transpose(1, 2)
            leaf = lambda t: t.detach().requires_grad_()
            qh, kh, vh = split(q, Sq), split(k, Sk), split(v, Sk)
            qh, kh, vh = (leaf(qh), kh, vh) if grad_q else (qh, leaf(kh), leaf(vh))
            oh = F.scaled_dot_product_attention(qh, kh, vh)
            inputs = (qh,) if grad_q else (kh, vh)
            return time_ms(lambda: torch.autograd.grad(oh, inputs, split(do, Sq), retain_graph=True), iters)

        row["sdpa_bwd_ms"] = {"dq": sdpa_bwd_ms(True), "dkv": sdpa_bwd_ms(False)}
        for part, kernel in (("dq", "K3a"), ("dkv", "K3b")):
            bound = row["bounds"][part]
            for name, ms in row["ms"][part].items():
                mean = sum(ms) / len(ms)
                print(f"[bwd] {label}: {kernel} {name} {' / '.join(f'{x:.4f}' for x in ms)} ms "
                      f"(share of bound {bound['bound_ms'] / mean:.3f})")
            print(f"[bwd] {label}: {kernel} sdpa backward {row['sdpa_bwd_ms'][part]:.4f} ms, bound "
                  f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}; operations {bound['ops_ms']:.4f}, "
                  f"bytes {bound['bytes_ms']:.4f})")
        rows.append(row)
        del q, k, v, do, stats, grads, timed
        torch.cuda.empty_cache()
    result = dict(card=card_line(), sites=rows, wrong=wrong)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
