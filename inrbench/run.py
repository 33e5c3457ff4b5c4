"""One benchmark run of one cell on one CUDA card.

    python3 inrbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout.  Prints progress and the compared
numbers on standard error and, as the last line of standard output, one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` a ``breakdown``, ``setup_parts`` (the
set-up's seconds by phase), and ``checks`` last.
Exits non-zero without a result when there is no CUDA card, when the cell
asks for more cards than there are, and when a module of JAX or of the
JAX package is loaded.
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


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from inrbench import guard, harness
    harness.environment(ROOT)
    import torch

    cell = harness.find_cell(ROOT, args.workload)
    need = int(cell.workload["chips"])
    if not torch.cuda.is_available():
        log("inrbench: no CUDA card; the benchmark runs on CUDA only")
        return 2
    if torch.cuda.device_count() < need:
        log(f"inrbench: {args.workload} asks for {need} cards, "
            f"{torch.cuda.device_count()} present")
        return 2
    log(f"[inrbench] card: {harness.card_line()}")
    try:
        out = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                               bool(args.trace), t_start=T_START, log=log,
                               cell=cell)
    except ImportError as e:
        if guard.forbidden_modules():
            log(f"inrbench: {e}")
            return 3
        raise
    for k, (v, lim) in out["checks"].items():
        log(f"check {k}: {v!r} (limit {lim!r}) "
            f"{'ok' if v <= lim else 'FAILED'}")
    print(json.dumps(out["result"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
