"""Where one full-width LM layer of the port spends device time.

Runs one layer of each kind that the SSM, MoE and hybrid families add, at
full width in bf16 on the card (weights drawn in bf16 from a seeded
generator, B = 2, S = 4,096 by default), under ``torch.profiler``:

  * ``mamba_layer`` prefill (``return_state=True``) of mamba2-2.7b and of
    jamba-v0.1-52b;
  * ``moe_ffn`` of deepseek-moe-16b and of jamba-v0.1-52b.

For each it prints the device ms of one call (the profiler's kernel time
over ``--iters`` calls) and the ops that took the most of it, by op and
input shape.  ``--out`` also writes the numbers as JSON, with the card's
name and power limit.

  PYTHONPATH=src python scripts/torch_lm_layer_profile.py \\
      [--batch B] [--seq S] [--iters N] [--top K] [--out F]

Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.kernels import common
from repro_torch.models import layers, zoo
from repro_torch.models.template import init_params

# (label, arch, template builder, call)
_CASES = [
    ("mamba_layer", "mamba2-2.7b", zoo.mamba_template,
     lambda cfg, p, x: layers.mamba_layer(cfg, p, x, return_state=True)),
    ("mamba_layer", "jamba-v0.1-52b", zoo.mamba_template,
     lambda cfg, p, x: layers.mamba_layer(cfg, p, x, return_state=True)),
    ("moe_ffn", "deepseek-moe-16b", zoo.moe_template, layers.moe_ffn),
    ("moe_ffn", "jamba-v0.1-52b", zoo.moe_template, layers.moe_ffn),
]


def _profile(fn, iters: int, top: int) -> tuple[float, list]:
    """(device ms of one call, the ``top`` ops by device time per call)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        # the profiler can drop a session's first kernel records: spin first
        for _ in range(16):
            torch.cuda._sleep(1000)
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ops, total = [], 0.0
    for ev in prof.key_averages(group_by_input_shape=True):
        ms = (getattr(ev, "self_device_time_total", None)
              or getattr(ev, "self_cuda_time_total", 0.0)) / iters / 1e3
        if ev.device_type == DeviceType.CUDA:           # a kernel record
            if "spin_kernel" not in ev.key:
                total += ms
        elif ev.key.startswith("aten::") and ms > 0:    # the op launching it
            ops.append((ev.key, str(ev.input_shapes), ms))
    ops.sort(key=lambda o: -o[2])
    return total, ops[:top]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_lm_layer_profile: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card)
    common.load_library()
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = []
    for label, arch, template, call in _CASES:
        cfg = get_config(arch)
        p = init_params(template(cfg), 0, device="cuda", dtype="bfloat16")
        x = torch.randn((args.batch, args.seq, cfg.d_model), generator=gen,
                        device="cuda").to(torch.bfloat16)
        with torch.no_grad():
            ms, ops = _profile(lambda: call(cfg, p, x), args.iters, args.top)
        print(f"{label} {arch} bf16 B={args.batch} S={args.seq}: {ms:.3f} "
              f"device ms per call; top ops (ms per call):")
        for name, shapes, t in ops:
            print(f"  {t:8.3f}  {name} {shapes}")
        results.append({"layer": label, "arch": arch, "device_ms": ms,
                        "top_ops": [{"op": n, "shapes": s, "ms": t}
                                    for n, s, t in ops]})
        del p, x
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"meta": {"card": card, "torch": torch.__version__,
                                "batch": args.batch, "seq": args.seq},
                       "layers": results}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
