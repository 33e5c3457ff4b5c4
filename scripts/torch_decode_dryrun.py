#!/usr/bin/env python3
"""Every architecture's ``decode_32k`` cell on the single pod's 16 x 16
mesh through the dry-run CLI (``python -m repro_torch.launch.dryrun``,
fake tensors), for this tree and, with ``--parent``, for another tree's
package beside it; one process a cell, ``--jobs`` at a time.

    python3 scripts/torch_decode_dryrun.py --out build/decode_dry \\
        [--parent OTHER/src] [--device cuda] [--jobs 8]

Writes each cell's record to ``<out>/<tree>_<arch>.json`` (``tree``:
``change`` for this tree, ``parent`` for ``--parent``) and prints one
JSON line per cell: per-rank collective operand bytes by kind (count,
bytes), their total, the collectives that carry a parameter block, the
arguments and the peak.  deepseek-moe-16b runs with ``--remat full``,
as the reference's test cell does.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--parent", default=None)
    ap.add_argument("--device", default="cuda", choices=["cpu", "cuda"])
    ap.add_argument("--jobs", type=int, default=8)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import ARCH_IDS
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    trees = {"change": str(ROOT / "src")}
    if args.parent:
        trees["parent"] = str(Path(args.parent).resolve())

    def run(job):
        tree, arch = job
        dst = out / f"{tree}_{arch}.json"
        dst.unlink(missing_ok=True)
        extra = ["--remat", "full"] if arch == "deepseek-moe-16b" else []
        with open(out / f"{tree}_{arch}.log", "w") as log:
            rc = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                 arch, "--shape", "decode_32k", "--mesh", "single",
                 "--device", args.device, *extra, "--out", str(dst)],
                env=dict(os.environ, PYTHONPATH=trees[tree]), stdout=log,
                stderr=subprocess.STDOUT, timeout=900).returncode
        if rc:
            return {"tree": tree, "arch": arch, "rc": rc}
        rec, = json.loads(dst.read_text())
        cost = rec["hlo_cost"]
        return {"tree": tree, "arch": arch, "collectives": {
            k: [int(v["count"]), int(v["bytes"])]
            for k, v in cost["collectives"].items() if v["count"]},
            "total": int(cost["collective_bytes"]),
            "param_collectives": rec.get("param_collectives"),
            "arguments": rec["memory"]["argument_size_in_bytes"],
            "peak": rec["memory"]["peak_memory_in_bytes"],
            "flops": cost["flops"]}

    jobs = [(t, a) for a in ARCH_IDS for t in trees]
    failed = 0
    with ThreadPoolExecutor(args.jobs) as ex:
        for rec in ex.map(run, jobs):
            failed += "rc" in rec
            print(json.dumps(rec), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
