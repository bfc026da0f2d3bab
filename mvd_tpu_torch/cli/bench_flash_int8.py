"""Time builds of the int8 attention kernel K6 against each other, and its
quantizer K6q, on the GPU.

    python -m mvd_tpu_torch.cli.bench_flash_int8 \\
        [--build LABEL=PATH]... [--rounds N] [--sass] [--out OUT.json]

Builds ``csrc/flash_attn_int8.cu`` as it stands ("change") and once more for
each ``--build``, whose PATH is another ``flash_attn_int8.cu`` with the same
C entry ``flash_attn_fwd_int8`` (for instance a parent checkout's), one
``nvcc`` each, in parallel. At every site of ``INT8_CASES`` the operands come
from K6q (``quantize_int8``), and each build gets V8^T in the layout its C
entry takes: in K6's key order where the build says so
(``flash_attn_int8_key_order``), else in the keys' own order. Every build is
held to the plain core (``attention_int8_core_plain``) on those operands with
``check_attention`` at ``INT8_TOL`` / ``INT8_REL_RMS``, and K6q to the plain
quantizers with ``check_quantize``. Then, by CUDA-graph replay of the C
entries with their outputs allocated once, in turns (the builds in order,
then in reverse, ``--rounds`` times): K6 of each build; K6q and, by CUDA
events, the eager quantizers (the plain version on the card); K1 at the same
shape and ``scaled_dot_product_attention`` as the yardstick. Prints each
kernel's share of its operations, exponentials and bytes bounds
(``int8_bounds``, ``k6q_bounds``) and, last, one JSON object. ``--sass``
also counts the I2F, F2I and MUFU instructions of each build's kernels
(``cuobjdump -sass``) and prints where the I2F and F2I sit. A build that disagrees with
the plain core is timed all the same, listed under "wrong", and makes the
exit code 1.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import math
import os
import re
import shutil
import subprocess
import sys

from mvd_tpu_torch.kernels.measure import (
    D,
    INT8_CASES,
    INT8_REL_RMS,
    INT8_TOL,
    check_attention,
    check_quantize,
    int8_bounds,
    k6q_bounds,
    sm_clock_hz,
    time_graph_ms,
    time_ms,
    turns,
)

_P = ctypes.c_void_p


def _builds(args) -> dict:
    """label -> (C entry, takes K6's key order, library path) of every build."""
    from mvd_tpu_torch.kernels import _build

    builds = {}
    for label, (dll, lib) in _build.build_variants("flash_attn_int8", args.build).items():
        fn = dll.flash_attn_fwd_int8
        fn.argtypes = [_P] * 8 + [ctypes.c_int] * 6 + [ctypes.c_float, _P]
        fn.restype = ctypes.c_int
        keyed = hasattr(dll, "flash_attn_int8_key_order") and dll.flash_attn_int8_key_order() == 1
        builds[label] = (fn, keyed, lib)
    return builds


def sass_report(lib: str) -> dict:
    """For each kernel of a built library (by its mangled name), the counts
    of I2F*, F2I* and MUFU* instructions in its SASS, each I2F/F2I line with
    its address, and the address range of the MUFU.EX2 instructions (where
    the exponentials, and so the per-score work, sit)."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True, check=True).stdout
    funcs = {}
    for line in sass.splitlines():
        f = re.search(r"Function : (\S+)", line)
        if f:
            counts, convs, ex2 = {"I2F": 0, "F2I": 0, "MUFU": 0}, [], []
            funcs[f.group(1)] = (counts, convs, ex2)
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)(\.[A-Z0-9_.]+)?", line)
        if not m or not funcs:
            continue
        addr, op = int(m.group(1), 16), m.group(2)
        for key in counts:
            if op.startswith(key):
                counts[key] += 1
        if op.startswith(("I2F", "F2I")):
            convs.append(f"{m.group(1)} {op}{m.group(3) or ''}")
        if op == "MUFU" and (m.group(3) or "").startswith(".EX2"):
            ex2.append(addr)
    return {name: dict(counts=counts, conversions=convs, ex2_count=len(ex2),
                       ex2_range=[hex(min(ex2)), hex(max(ex2))] if ex2 else None)
            for name, (counts, convs, ex2) in funcs.items()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--build", action="append", default=[], metavar="LABEL=PATH",
                   help="another build: the path of a flash_attn_int8.cu")
    p.add_argument("--rounds", type=int, default=1)
    p.add_argument("--sass", action="store_true", help="count each build's conversions in its SASS")
    p.add_argument("--out", default=None, metavar="OUT.json")
    args = p.parse_args(argv)
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("bench_flash_int8: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    fa = importlib.import_module("mvd_tpu_torch.kernels.flash_attention")

    builds = _builds(args)
    order = turns(builds, args.rounds)
    sass = {label: sass_report(lib) for label, (_, _, lib) in builds.items()} if args.sass else {}
    for label, kernels in sass.items():
        for name, rep in kernels.items():
            print(f"[sass] {label} {name}: {rep['counts']}, MUFU.EX2 x{rep['ex2_count']} at "
                  f"{rep['ex2_range']}; I2F/F2I: {rep['conversions']}")
    clock = sm_clock_hz()
    # the stream is read at each call: a CUDA graph captures on a stream of its own
    stream = lambda: torch.cuda.current_stream().cuda_stream
    quantize = fa._quantize_entry()[0]
    k1 = fa._fwd_entries()[fa.PACKED]
    gen = torch.Generator("cuda").manual_seed(0)
    randn = lambda *s: torch.randn(s, generator=gen, device="cuda").bfloat16()
    rows, wrong = [], []
    for label, B, Sq, Sk, H in INT8_CASES:
        HD, scale = H * D, 1.0 / math.sqrt(D)
        q, k, v = randn(B, Sq, HD), randn(B, Sk, HD), randn(B, Sk, HD)
        ops = fa.quantize_int8(q, k, v, H)
        torch.cuda.synchronize()
        try:
            qcheck = check_quantize(ops, fa.quantize_int8_plain(q, k, v, H), f"K6q at {label}")
        except AssertionError as e:
            wrong.append(str(e))
            print(f"[int8] WRONG {wrong[-1]}")
            qcheck = None
        q8, k8, v8t, sq, sk, sv = ops
        v8t_own = fa.v8_from_key_order(v8t).transpose(1, 2).contiguous()
        ref_out, ref_lse = fa.attention_int8_core_plain(ops, H)
        out = torch.empty(B, Sq, HD, dtype=torch.bfloat16, device="cuda")
        lse = torch.empty(B, Sq, H, device="cuda")
        group = min(fa.INT8_BLOCK_K, Sk)
        call = {name: (lambda fn=fn, vt=(v8t if keyed else v8t_own): fn(
            q8.data_ptr(), k8.data_ptr(), vt.data_ptr(), sq.data_ptr(), sk.data_ptr(), sv.data_ptr(),
            out.data_ptr(), lse.data_ptr(), B, Sq, Sk, H, D, group, scale, stream()))
            for name, (fn, keyed, _) in builds.items()}
        row = dict(case=label, B=B, Sq=Sq, Sk=Sk, heads=H, **int8_bounds(B, Sq, Sk, H, clock),
                   k6q=dict(**k6q_bounds(B, Sq, Sk, H), check=qcheck), ms={})
        for name, fn in call.items():
            out.zero_()
            err = fn()
            torch.cuda.synchronize()
            if err:
                raise RuntimeError(f"{name} at {label}: error {err}")
            try:
                err, rel_rms = check_attention(out, lse, ref_out, ref_lse, f"{name} at {label}",
                                               INT8_TOL, INT8_REL_RMS)
                row.setdefault("max_abs_err", {})[name] = err
                row.setdefault("rel_rms", {})[name] = rel_rms
            except AssertionError as e:
                wrong.append(str(e))
                print(f"[int8] WRONG {wrong[-1]}")
        for name in order:
            row["ms"].setdefault(name, []).append(time_graph_ms(call[name]))
        qouts = [torch.empty_like(t) for t in ops]
        scratch = fa.quantize_scratch(B, Sk, HD, "cuda")
        qargs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), qouts[0].data_ptr(), qouts[3].data_ptr(),
                 qouts[1].data_ptr(), qouts[4].data_ptr(), qouts[2].data_ptr(), qouts[5].data_ptr(),
                 scratch.data_ptr(), B, Sq, Sk, H, D)
        row["k6q"]["ms"] = time_graph_ms(lambda: quantize(*qargs, stream()))
        row["k6q"]["eager_ms"] = time_ms(lambda: fa.quantize_int8_plain(q, k, v, H), 10)
        k1_out = torch.empty_like(q)
        k1_args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), k1_out.data_ptr(), lse.data_ptr(),
                   B, Sq, Sk, H, D, scale)
        row["k1_ms"] = time_graph_ms(lambda: k1(*k1_args, stream()))
        split = lambda t, s: t.view(B, s, H, D).transpose(1, 2)
        row["sdpa_ms"] = time_graph_ms(
            lambda: F.scaled_dot_product_attention(split(q, Sq), split(k, Sk), split(v, Sk)))
        for name, ms in row["ms"].items():
            mean = sum(ms) / len(ms)
            print(f"[int8] {label}: K6 {name} {' / '.join(f'{x:.4f}' for x in ms)} ms (share of the "
                  f"operations bound {row['ops_ms'] / mean:.3f}, exponentials {row['exp_ms'] / mean:.3f}, "
                  f"bytes {row['bytes_ms'] / mean:.3f})")
        kq = row["k6q"]
        print(f"[int8] {label}: K6q {kq['ms']:.4f} ms (bytes bound {kq['bytes_ms']:.4f}, share "
              f"{kq['bytes_ms'] / kq['ms']:.3f}; with k, v read twice {kq['two_read_ms']:.4f}), eager "
              f"quantizers {kq['eager_ms']:.4f} ms; K1 {row['k1_ms']:.4f} ms, sdpa {row['sdpa_ms']:.4f} "
              f"ms; K6 bound {row['bound_ms']:.4f} ms (ops {row['ops_ms']:.4f}, exp {row['exp_ms']:.4f} "
              f"at {clock / 1e6:.0f} MHz, bytes {row['bytes_ms']:.4f})")
        rows.append(row)
        del q, k, v, ops, q8, k8, v8t, sq, sk, sv, v8t_own, qouts, scratch, out, lse, k1_out
        torch.cuda.empty_cache()
    result = dict(card=torch.cuda.get_device_name(0), sm_clock_max_hz=clock, sites=rows, sass=sass,
                  wrong=wrong)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
