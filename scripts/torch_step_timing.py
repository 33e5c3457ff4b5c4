#!/usr/bin/env python3
"""Time, for the package under ``--src``, qwen3-8b's unsharded bf16 decode
and the train step of ``chip_smoke.py`` phase 12, unsharded and on a 1 x 1
mesh.

    python3 scripts/torch_step_timing.py [--src DIR] [--rounds N]

One CUDA GPU.  Decode: the full model (36 layers, random bf16 weights from
seed 0), a prefill of B = 2 rows of 4,096 tokens, its cache padded for 16
greedy steps, each step timed alone (wall to ``torch.cuda.synchronize()``).
Training: qwen3-8b cut to 4 layers, B = 1, S = 4,096, remat "dots",
cast_once, as phase 12: one warm-up step, then ``--rounds`` rounds of the
first step of a freshly built unsharded step and of a sharded one on a
1 x 1 ("data", "model") mesh of a one-rank NCCL group (fresh state each),
then 3 more steps of each.  To compare two trees, run it on each in turn on
the same card (the older one unpacked under ``build/``, ``--src
build/<tree>/src``), alternating.  Prints one JSON line with every wall in
ms and the card as ``nvidia-smi`` names it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def wall_ms(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def decode_walls(torch, np, steps=16, seq=4096):
    from repro_torch.configs import get_config
    from repro_torch.launch import steps as S
    from repro_torch.models import zoo
    from repro_torch.models.template import init_params
    cfg = get_config("qwen3-8b")
    hp = S.HParams()
    params = S.serving_params(cfg, hp, init_params(
        zoo.model_template(cfg), 0, device="cuda"))
    batch = {"tokens": torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, seq))).cuda()}
    logits, cache = S.build_prefill_step(cfg, hp)(params, batch)
    cache = {"layers": {k: torch.nn.functional.pad(a, (0, 0, 0, 0, 0, steps))
                        for k, a in cache["layers"].items()}}
    serve = S.build_serve_step(cfg, hp)
    tok = logits.argmax(-1).to(torch.int32)
    walls = []
    for pos in range(seq, seq + steps):
        (tok, _), ms = wall_ms(torch, lambda: serve(params, cache, tok, pos))
        walls.append(ms)
    del params, cache
    torch.cuda.empty_cache()
    return walls


def train_walls(torch, rounds):
    import torch.distributed as dist
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.distributed.sharding import ShardingPolicy, make_mesh
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import init_process_group
    from repro_torch.optim import adam
    cfg = dataclasses.replace(get_config("qwen3-8b"), n_layers=4)
    hp = S.HParams(remat="dots", cast_once=True, optimizer=adam.AdamWConfig(
        lr=1e-4, warmup_steps=2, total_steps=5))
    shape = ShapeConfig("t", "train", 4096, 1)
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, shape.seq_len,
                                    shape.global_batch, seed=0))
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in pipe.batch_at(0).items()}
    out = {"first": {"unsharded": [], "sharded": []},
           "later": {"unsharded": [], "sharded": []}}
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        init_process_group(str(Path(d) / "store"), 0, 1, timeout_s=300)
        try:
            policy = ShardingPolicy(make_mesh((1, 1), ("data", "model")))

            def run(pol, later=0):
                state = S.init_state(cfg, 0, device="cuda")
                if pol is not None:
                    state = S.place_state(state, cfg, pol)
                step = S.build_train_step(cfg, hp, pol)
                walls = [wall_ms(torch, lambda: step(state, batch))[1]
                         for _ in range(1 + later)]
                del state, step
                torch.cuda.empty_cache()
                return walls

            run(None)                                   # warm-up
            for _ in range(rounds):
                for label, pol in (("unsharded", None), ("sharded", policy)):
                    out["first"][label] += run(pol)
            for label, pol in (("unsharded", None), ("sharded", policy)):
                out["later"][label] = run(pol, later=3)[1:]
        finally:
            dist.destroy_process_group()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dec = decode_walls(torch, np)
    train = train_walls(torch, args.rounds)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({
        "src": args.src, "decode_ms": dec,
        "decode_median_ms": statistics.median(dec[1:]),
        "train_first_ms": train["first"], "train_later_ms": train["later"],
        "card": card.strip()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
