"""Readings for a cell's limits: the compared numbers over many seeds in
one process, of the program (``--side program``, the lower readings), of
its control (``--side control``: the plain reference in the program's
place, in the precision next below the configuration's), or of the
program with a fault planted (``--side fault-half``: a fit step over half
of its rows, the mean taken over them), at the cell's own sizes and load,
with a short window.

    python3 inrbench/control.py --workload <cell> --side control \
        --seeds 11,12,13 --seconds 2

Prints one JSON line per seed, then a summary line.  The benchmark's own
runs never run this.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# one host thread for PyTorch's CPU work: a pool of them contends with the
# thread that feeds the card (on an H100 host of 8 cores, a fit cell's
# set-up took 21-26 s with the pool and 11-15 s without it)
os.environ["OMP_NUM_THREADS"] = "1"

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--side", choices=("program", "control", "fault-half"),
                    default="control")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)

    from inrbench import harness
    harness.environment(ROOT)
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    device = "cuda:0"
    cell = harness.find_cell(ROOT, args.workload)
    if args.side == "fault-half":
        plant_half_batch(cell.model.FitProgram)
    worst: dict[str, list] = {}
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        out = harness.run_cell(
            ROOT, args.workload, seed, args.seconds, False, device=device,
            control=args.side == "control", t_start=t, cell=cell,
            log=lambda m: print(m, file=sys.stderr, flush=True))
        vals = {k: v for k, (v, _) in out["checks"].items()}
        for k, v in vals.items():
            worst.setdefault(k, []).append(v)
        print(json.dumps({"workload": args.workload, "side": args.side,
                          "seed": seed, "readings": vals,
                          "correct": out["result"]["correct"]}), flush=True)
    print(json.dumps({"workload": args.workload, "side": args.side,
                      "max": {k: max(v) for k, v in worst.items()},
                      "min": {k: min(v) for k, v in worst.items()}}),
          flush=True)
    return 0


def plant_half_batch(cls) -> None:
    """Every step of ``cls`` sees the second half of its rows only."""
    step = cls.step

    def half(self):
        x, t = self.coords, self.target
        n = x.shape[0] // 2
        self.coords, self.target = x[n:], t[n:]
        try:
            return step(self)
        finally:
            self.coords, self.target = x, t

    cls.step = half


if __name__ == "__main__":
    sys.exit(main())
