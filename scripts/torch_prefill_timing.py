#!/usr/bin/env python3
"""Time the port's qwen3-8b bf16 prefill (36 layers, B = 2, S = 4,096, the
attention kernel in every layer), its decode steps after it, and the host
time of one call of the attention and ``ssd_scan`` wrappers, for the
package under ``--src``.

    python3 scripts/torch_prefill_timing.py [--src DIR] [--reps N] \\
        [--decode N]

One CUDA GPU.  To compare two trees, run it on each in turn on the same
card (the older one unpacked under ``build/``, ``--src
build/<tree>/src``), alternating.  Prints one JSON line: the prefill
walls in ms (two warm-up calls first), their median and minimum, the wall
of each of ``--decode`` greedy decode steps into a cache of S + N
positions and their median (the first step warms up), the host µs per
wrapper
call (``calls`` calls queued back to back, timed without waiting for the
card, then the mean), and the card as ``nvidia-smi`` names it.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def host_us(torch, fn, calls):
    """Mean host µs of ``fn()`` over ``calls`` queued calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host / calls * 1e6


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--calls", type=int, default=200)
    ap.add_argument("--decode", type=int, default=16)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import common
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as scan
    from repro_torch.launch.steps import (HParams, build_prefill_step,
                                          build_serve_step)
    from repro_torch.models import zoo
    from repro_torch.models.template import init_params

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    common.load_library()
    cfg = get_config("qwen3-8b")
    hp = HParams()
    params = init_params(zoo.model_template(cfg), 0, device=dev,
                         dtype=hp.serve_dtype)
    gen = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 4096),
                                     generator=gen).to(dev)}
    prefill = build_prefill_step(cfg, hp)
    walls = []
    for _ in range(args.reps + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(params, batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        del logits, cache
    logits, cache = prefill(params, batch, cache_len=4096 + args.decode)
    serve = build_serve_step(cfg, hp)
    tok = torch.argmax(logits, -1).to(torch.int32)
    steps = []
    for pos in range(4096, 4096 + args.decode):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tok, cache = serve(params, cache, tok, pos)
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0) * 1e3)
    del logits, cache, params
    torch.cuda.empty_cache()
    g = torch.Generator(device=dev).manual_seed(2)
    q = torch.randn(2, 4096, 32, 128, generator=g, device=dev).bfloat16()
    k = torch.randn(2, 4096, 8, 128, generator=g, device=dev).bfloat16()
    v = torch.randn(2, 4096, 8, 128, generator=g, device=dev).bfloat16()
    st = torch.randn(160, 32, 64, 128, generator=g, device=dev)
    dec = torch.rand(160, 32, generator=g, device=dev)
    timed = walls[2:]
    print(json.dumps({
        "src": args.src, "prefill_ms": timed,
        "prefill_median_ms": statistics.median(timed),
        "prefill_min_ms": min(timed), "warmup_ms": walls[:2],
        "decode_ms": steps,
        "decode_median_ms": statistics.median(steps[1:]) if steps[1:]
        else None,
        "flash_attention_host_us": host_us(
            torch, lambda: fa.flash_attention(q, k, v), args.calls),
        "ssd_scan_host_us": host_us(
            torch, lambda: scan.ssd_scan(st, dec), args.calls),
        "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
