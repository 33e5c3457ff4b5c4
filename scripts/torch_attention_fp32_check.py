#!/usr/bin/env python3
"""Check and time the fp32 attention routes on one CUDA card.

    PYTHONPATH=src python3 scripts/torch_attention_fp32_check.py \
        [--src DIR] [--out FILE] [--time]

Holds ``flash_attention`` and ``flash_attention_bwd`` on fp32 CUDA tensors
(``csrc/flash_attention.cu``, ``csrc/flash_attention_bwd.cu``) to a
float64 evaluation and to their plain versions at every case of
``chip_smoke.FP32_FWD_CASES`` and ``FP32_BWD_CASES``, on the inputs
``chip_smoke.fp32_case`` makes (one seed a case; the backward gets the
float64 forward's output and log-sum-exp rounded to fp32, so that it sees
the same operands whatever forward a tree has).  It prints ptxas's
registers and spills and the SASS counts (HMMA, LDGSTS, FFMA, LDL, STL) of
the fp32 attention kernels, then one ``[check]`` line a case and, with
``--out``, writes every max abs error against float64 as JSON.
``chip_smoke.py`` holds the kernels to ``SPLIT_OVER_SIMT`` times the
``SIMT_FP32_ERRS`` that this script measured on the SIMT kernels.

``--src DIR``: import ``repro_torch`` from DIR (the ``src`` of another tree,
say an older commit unpacked by ``git archive`` under ``build/``), which
builds its own kernels under its own root; run once per tree in one chip
call to compare kernels on the same inputs and card.  ``--time``: device ms
(CUDA events) of each route at ``chip_smoke``'s timed shapes, the
forward at qwen3-8b's prefill (q [2, 4096, 32, 128], k/v [2, 4096, 8,
128], causal) and the backward at [1, 1024, 32, 128], beside SDPA's fp32
forward and autograd backward and the split-TF32 bound.  Exits non-zero
where a kernel gives a non-finite value or misses the 1e-5 (forward) /
1e-4 (backward) scaled error that ``chip_smoke.py`` asks of it.
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def log(*a):
    print(*a, flush=True)


def build_report(common):
    """ptxas's lines and the SASS counts of the fp32 attention kernels."""
    for src, text in common.build_logs().items():
        if src not in ("flash_attention", "flash_attention_bwd"):
            continue
        fn = None
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                fn = m.group(1)
            elif fn and ("registers" in line or "spill" in line):
                log(f"[build] {src}: {fn}: {line.strip()}")
            elif "warning" in line or "error" in line:
                log(f"[build] {src}: {line.strip()}")
    cuobjdump = Path(common._nvcc()).with_name("cuobjdump")
    if not cuobjdump.exists():
        log("[build] SASS counts: not available (no cuobjdump)")
        return
    sass = subprocess.run([str(cuobjdump), "-sass",
                           str(common.build_library())],
                          capture_output=True, text=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = collections.Counter()
        elif fn:
            for op in ("HMMA", "LDGSTS", "FFMA", "LDL", "STL"):
                if re.search(rf"\b{op}\b", line):
                    counts[fn][op] += 1
    for fn, c in counts.items():
        if ("fa_fwd_kernel" in fn or "fa_bwd_" in fn) and "_tc_" not in fn:
            log(f"[build] SASS {fn}: " + ", ".join(
                f"{k} {c[k]}" for k in ("HMMA", "LDGSTS", "FFMA", "LDL",
                                        "STL")))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory whose repro_torch to run")
    ap.add_argument("--out", help="write the errors here as JSON")
    ap.add_argument("--time", action="store_true",
                    help="also time both routes beside SDPA")
    args = ap.parse_args()
    # its module puts this tree's src first on the path; --src goes before
    from torch_attention_bwd_check import event_ms, kernel_ms
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("torch_attention_fp32_check: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import common
    from repro_torch.kernels import flash_attention as fa

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; repro_torch "
        f"from {Path(fa.__file__).resolve().parents[2]}")
    common.fp32_strict()
    common.load_library()
    build_report(common)

    dev = torch.device("cuda")
    errs, ok = {"forward": {}, "backward": {}}, True
    for i, (label, shape, Sk, window) in enumerate(cs.FP32_FWD_CASES):
        q, k, v = cs.fp32_case(torch, dev, i, shape, Sk)
        got = fa.flash_attention(q, k, v, causal=True, window=window)
        plain = fa.flash_attention_plain(q, k, v, causal=True, window=window)
        exact, _ = cs.attention64(torch, q, k, v, True, window)
        torch.cuda.synchronize()
        k_err, k_scaled = cs.scaled_err(got, exact)
        p_err = cs.scaled_err(plain, exact)[0]
        good = bool(torch.isfinite(got).all()) and k_scaled <= 1e-5
        errs["forward"][label] = {"out": k_err}
        log(f"[check] forward {label}: q {tuple(q.shape)} k "
            f"{tuple(k.shape)} window {window}: against float64 "
            f"{k_err:.4e} (scaled {k_scaled:.3e}), plain {p_err:.4e}, "
            f"against plain {cs.scaled_err(got, plain)[0]:.4e}: "
            f"{'ok' if good else 'FAIL'}")
        ok = ok and good
        del q, k, v, got, plain, exact
    for i, (label, shape, Sk, window) in enumerate(cs.FP32_BWD_CASES):
        q, k, v, dout = cs.fp32_case(torch, dev, 100 + i, shape, Sk,
                                     with_dout=True)
        out64, lse64 = cs.attention64(torch, q, k, v, True, window)
        out, lse = out64.float(), lse64.float()
        got = fa.flash_attention_bwd(q, k, v, out, lse, dout, window=window)
        plain = fa.flash_attention_bwd_plain(q, k, v, out, lse, dout,
                                             window=window)
        exact = cs.attention_grad64(torch, q, k, v, dout, True, window)
        torch.cuda.synchronize()
        parts, row = [], {}
        for name, g, p, e in zip(("dq", "dk", "dv"), got, plain, exact):
            k_err, k_scaled = cs.scaled_err(g, e)
            row[name] = k_err
            good = bool(torch.isfinite(g).all()) and k_scaled <= 1e-4
            ok = ok and good
            parts.append(f"{name} {k_err:.4e} (scaled {k_scaled:.3e}), "
                         f"plain {cs.scaled_err(p, e)[0]:.4e}"
                         f"{'' if good else ' FAIL'}")
        errs["backward"][label] = row
        log(f"[check] backward {label}: q {tuple(q.shape)} k "
            f"{tuple(k.shape)} window {window}: against float64 "
            + "; ".join(parts))
        del q, k, v, dout, out, lse, got, plain, exact
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(errs, indent=1))
    if not args.time:
        return 0 if ok else 1

    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    B, Sq, H, KH, D = cs.ATTN_CASES[0][1]
    q = torch.randn((B, Sq, H, D), generator=gen, device=dev)
    k, v = (torch.randn((B, Sq, KH, D), generator=gen, device=dev)
            for _ in range(2))
    flops = cs.attention_flops(B, Sq, Sq, H, D, causal=True, window=0)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    for _ in range(2):
        ms = event_ms(torch, lambda: fa.flash_attention(q, k, v), 5)
        sd = event_ms(torch, lambda: torch.nn.functional.
                      scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                   enable_gqa=True), 3)
        log(f"[time] forward fp32 q {tuple(q.shape)} k {tuple(k.shape)} "
            f"causal: {ms:.5f} ms; SDPA fp32 {sd:.5f} ms; bound "
            f"{3 * flops / cs.TF32_FLOPS_PER_S * 1e3:.6f} ms (split TF32), "
            f"{flops / cs.FP32_FLOPS_PER_S * 1e3:.6f} ms (fp32 FMAs)")
    del q, k, v, qt, kt, vt
    label, (B, Sq, H, KH, D), _, _ = cs.TRAIN_ATTN_CASES[1]
    q = torch.randn((B, Sq, H, D), generator=gen, device=dev)
    k, v = (torch.randn((B, Sq, KH, D), generator=gen, device=dev)
            for _ in range(2))
    dout = torch.randn((B, Sq, H, D), generator=gen, device=dev)
    out, lse = fa._forward(q, k, v, True, 0, True)
    flops = 2.5 * cs.attention_flops(B, Sq, Sq, H, D, causal=True, window=0)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    ot = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True)
    gt = dout.transpose(1, 2)
    by_kernel = kernel_ms(torch, lambda: fa.flash_attention_bwd(
        q, k, v, out, lse, dout), 10)
    log("[time] backward fp32 by kernel: " + ", ".join(
        f"{n.split('(')[0].replace('void ', '')} {t:.5f} ms"
        for n, t in by_kernel.items()))
    for _ in range(2):
        ms = event_ms(torch, lambda: fa.flash_attention_bwd(q, k, v, out, lse,
                                                            dout), 10)
        sd = event_ms(torch, lambda: torch.autograd.grad(
            ot, (qt, kt, vt), gt, retain_graph=True), 10)
        log(f"[time] backward fp32 {label} q {tuple(q.shape)} k "
            f"{tuple(k.shape)} causal: {ms:.5f} ms; SDPA fp32 autograd "
            f"backward {sd:.5f} ms; bound "
            f"{3 * flops / cs.TF32_FLOPS_PER_S * 1e3:.6f} ms (split TF32), "
            f"{flops / cs.FP32_FLOPS_PER_S * 1e3:.6f} ms (fp32 FMAs)")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
