"""Calibrate the port's dataflow oracle per-op row costs on the card.

``repro_torch.core.dataflow.OP_ROW_COST`` is ANALYTIC: elementwise ops cost
1 row-cycle, transcendentals 2, an MM ``ceil(K / parallelism)``.  This
script measures the same table on the CUDA card, with the op set, the MM
scale and the host-to-device hop of the reference's
``scripts/row_cost_calibrate.py``:

  * every elementwise / transcendental op is timed on a ``[rows, cols]``
    float32 tensor (one torch call, one kernel; the ops whose domain is
    positive read ``|x| + 1``); its row cost is its per-row time over an
    ``Add`` on the same tensor (the II=1 unit), rounded to an int >= 1;
  * the MM is timed as ``[rows, K] @ [K, N]`` (TF32 off); its calibration
    is the continuous scale ``mm_row_cost_per_k`` (per-row-per-K time over
    the Add unit), which ``dataflow.segment_row_cost`` multiplies into
    ``ceil(K * scale / parallelism)``;
  * the host -> device hop is timed as a copy of a pageable host tensor of
    the same shape to the card; its per-row time over the Add unit becomes
    ``xshard_row_cost``.

Each time is the median over ``--iters`` samples, after warm-up, of one
sample's 20 back-to-back calls between two CUDA events on the
current stream, queued behind a spin kernel (device time, not the host's
launch rate).  The JSON goes to ``results/torch_op_row_cost.json`` (the
reference's ``results/op_row_cost.json`` is a CPU calibration of the
reference and stays as it is), with the card's name and power limit and
the torch version in ``meta``; ``dataflow.load_op_row_cost(path)`` loads it
(explicitly: nothing loads it at import) and ``reset_op_row_cost()``
restores the analytic table.

  PYTHONPATH=src python scripts/torch_row_cost_calibrate.py \\
      [--rows N] [--out F]

Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

# the ops the oracle distinguishes: (operand, one torch call on it); the
# operand is x in [-1, 1] or its positive shift |x| + 1
_OPS = {
    "Add": ("x", lambda x: x + x),
    "Mul": ("x", lambda x: x * x),
    "Sin": ("x", torch.sin),
    "Cos": ("x", torch.cos),
    "Exp": ("x", torch.exp),
    "Log": ("pos", torch.log),
    "Tanh": ("x", torch.tanh),
    "Sigmoid": ("x", torch.sigmoid),
    "Erf": ("x", torch.erf),
    "Rsqrt": ("pos", torch.rsqrt),
    "Sqrt": ("pos", torch.sqrt),
    "Pow": ("pos", lambda x: torch.pow(x, 2.5)),
    "IntPow": ("x", lambda x: torch.pow(x, 3)),
}


# clock cycles of the spin kernel queued ahead of a sample (~0.5 ms on an
# H100): longer than the host takes to enqueue the sample's calls
_SPIN_CYCLES = 1_000_000
_REPS = 20          # calls per sample


def _median_time(fn, *, warmup: int, iters: int) -> float:
    """Seconds per call: the median over ``iters`` samples of ``_REPS``
    back-to-back calls between two CUDA events.  A spin kernel runs ahead
    of each sample, so the calls are queued before the card reaches them
    and the events bracket device time, not the host's launch rate."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(_SPIN_CYCLES)
        start.record()
        for _ in range(_REPS):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / 1e3 / _REPS)
    return statistics.median(samples)


def _card() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0].strip()


def calibrate(rows: int = 4096, cols: int = 256, k: int = 256,
              warmup: int = 3, iters: int = 7) -> dict:
    from repro_torch.kernels.common import fp32_strict

    fp32_strict()
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    x = (torch.rand(rows, cols, generator=gen) * 2 - 1).to(dev)
    operands = {"x": x, "pos": x.abs() + 1.0}
    per_op_s = {name: _median_time(lambda: fn(operands[arg]), warmup=warmup,
                                   iters=iters)
                for name, (arg, fn) in _OPS.items()}

    unit = per_op_s["Add"] / rows          # seconds per row of the II=1 op
    table = {name: max(1, round((t / rows) / unit))
             for name, t in per_op_s.items() if name != "Add"}

    # MM: per-row-per-K time over the Add unit
    a = torch.rand(rows, k, generator=gen).to(dev)
    w = torch.rand(k, cols, generator=gen).to(dev)
    mm_s = _median_time(lambda: a @ w, warmup=warmup, iters=iters)
    mm_row_cost_per_k = max(1e-6, (mm_s / rows / k) / unit)

    # host -> device hop: a pageable host tensor copied to the card
    host = x.cpu()
    hop_s = _median_time(lambda: host.to(dev), warmup=warmup, iters=iters)
    xshard_row_cost = max(1, round((hop_s / rows) / unit))

    return {
        "meta": {"backend": torch.cuda.get_device_name(dev),
                 "card": _card(), "torch": torch.__version__,
                 "cuda": torch.version.cuda, "rows": rows, "cols": cols,
                 "k": k, "iters": iters, "reps": _REPS,
                 "unit_s_per_row": unit,
                 "per_op_s": per_op_s, "mm_s": mm_s, "h2d_s": hop_s},
        "op_row_cost": table,
        "mm_row_cost_per_k": mm_row_cost_per_k,
        "xshard_row_cost": xshard_row_cost,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=4096)
    ap.add_argument("--cols", type=int, default=256)
    ap.add_argument("--k", type=int, default=256)
    ap.add_argument("--iters", type=int, default=7)
    ap.add_argument("--out", default="results/torch_op_row_cost.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_row_cost_calibrate: no CUDA device", file=sys.stderr)
        return 2

    result = calibrate(rows=args.rows, cols=args.cols, k=args.k,
                       iters=args.iters)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=2, sort_keys=True) + "\n")

    # round-trip through the loader so the emitted file is known-good
    from repro_torch.core import dataflow
    loaded = dataflow.load_op_row_cost(out)
    dataflow.reset_op_row_cost()
    costs = " ".join(f"{k_}={v}" for k_, v in
                     sorted(result["op_row_cost"].items()))
    print(f"row costs [{result['meta']['card']}]: {costs} "
          f"mm_per_k={result['mm_row_cost_per_k']:.3g} "
          f"xshard={result['xshard_row_cost']} -> {out} "
          f"({len(loaded)} ops active after load)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
