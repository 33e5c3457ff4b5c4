#!/usr/bin/env python3
"""The sharded prefill and greedy decode of every architecture at full
width, cut to a few layers (a hybrid period, a VLM period, else 2), in
bf16 on a 1 x 1 ("data", "model") mesh of a one-rank group, against the
unsharded steps on the same random weights: the last logits, every
decode step's tokens and the cache after the steps ``torch.equal``.

    python3 scripts/torch_decode_one_rank.py [--device cuda] [--out F]

Prints one line per architecture and writes ``{arch: {"layers",
"equal", "tokens"}}`` to ``--out``; exits 1 unless every one is equal.
On the CPU it runs the reduced configurations (``--device cpu``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import shutil
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cpu", "cuda"])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint.ckpt import tree_items
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.distributed.sharding import ShardingPolicy, make_mesh
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import init_process_group
    from repro_torch.models import zoo
    from repro_torch.models.template import init_params

    dev = torch.device(args.device)
    store = Path(tempfile.mkdtemp())
    init_process_group(str(store / "store"), 0, 1, timeout_s=300)
    results = {}
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        pol = ShardingPolicy(mesh)
        for arch in ARCH_IDS:
            base = get_config(arch)
            if dev.type == "cpu":
                base = base.reduced()
            n = base.attn_period if base.family == "hybrid" else \
                base.cross_attn_period if base.family == "vlm" else 2
            cfg = dataclasses.replace(base, n_layers=n)
            hp = steps.HParams(attn_impl="flash")
            params = steps.serving_params(cfg, hp, init_params(
                zoo.model_template(cfg), 0, device=dev))
            placed = steps.place(params, steps.param_specs(cfg, pol), mesh)
            prompt = {k: v for k, v in zoo.make_inputs(
                cfg, 2, 0, seq=32, device=dev).items() if k != "labels"}
            want_l, want_c = steps.build_prefill_step(cfg, hp)(
                params, prompt, cache_len=36)
            got_l, got_c = steps.build_prefill_step(cfg, hp, pol)(
                placed, prompt, cache_len=36)
            equal = torch.equal(want_l, got_l)
            one = steps.build_serve_step(cfg, hp)
            sharded = steps.build_serve_step(cfg, hp, pol)
            t1 = t2 = want_l.argmax(-1).to(torch.int32)
            tokens = []
            for pos in range(32, 36):
                t1, _ = one(params, want_c, t1, pos)
                t2, _ = sharded(placed, got_c, t2, pos)
                equal = equal and torch.equal(t1, t2)
                tokens.append(t1.tolist())
            equal = equal and all(
                torch.equal(a, b.to_local()) for (_, a), (_, b) in
                zip(tree_items(want_c), tree_items(got_c)))
            results[arch] = {"layers": n, "equal": bool(equal),
                             "tokens": tokens}
            print(arch, n, "layers, torch.equal", equal, flush=True)
            del params, placed, want_c, got_c
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(results, indent=1))
    return 0 if all(r["equal"] for r in results.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
