#!/usr/bin/env python3
"""A dry-run cell's per-rank memory and collective bytes at full width,
extrapolated from cuts of its depth, for the package under ``--src``.

    python3 scripts/torch_dryrun_layers.py --arch qwen3-8b --shape train_4k \\
        [--remat dots] [--seq-parallel] [--layers 1,2] [--src DIR] \\
        [--device cpu]

Each cut (``n_layers`` set to each of ``--layers``) runs one step of the
cell as ``launch/dryrun.py::lower_cell`` does: on fake tensors, as rank 0
of a fake group of 256 ranks on the single pod's 16 x 16 mesh, so nothing
is allocated or computed and a cut takes seconds.  Every per-rank figure
of a step grows by the same amount a layer, so the first two cuts give the
figures at the architecture's own depth: f(L) = f(a) + (L - a) (f(b) -
f(a)) / (b - a).  Prints one JSON line: each cut's memory record (GB),
collective bytes by kind (GB) and FLOPs (``tflop``, 1e12), and the
extrapolation.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--remat", default="dots")
    ap.add_argument("--seq-parallel", action="store_true")
    ap.add_argument("--layers", default="1,2")
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--device", default="cpu", choices=["cpu", "cuda"])
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun, mesh as meshlib, steps

    base = get_config(args.arch)
    cuts = {}
    for n in (int(x) for x in args.layers.split(",")):
        cfg = dataclasses.replace(base, n_layers=n)
        with dryrun.fake_process_group(meshlib.CHIPS_PER_POD):
            mesh = meshlib.make_production_mesh(multi_pod=False,
                                                device_type=args.device)
            rec = dryrun.lower_cell(args.arch, args.shape, mesh,
                                    steps.HParams(
                                        remat=args.remat,
                                        seq_parallel=args.seq_parallel),
                                    device=args.device, cfg=cfg)
        figures = {k: v / 1e9 for k, v in rec["memory"].items()}
        figures.update({k: v["bytes"] / 1e9 for k, v in
                        rec["hlo_cost"]["collectives"].items()
                        if v["count"]})
        figures["tflop"] = rec["hlo_cost"]["flops"] / 1e12
        cuts[n] = figures
    (a, fa), (b, fb) = list(cuts.items())[:2]
    L = base.n_layers
    full = {k: fa[k] + (L - a) * (fb[k] - fa[k]) / (b - a)
            for k in fa if k in fb}
    print(json.dumps({"arch": args.arch, "shape": args.shape,
                      "remat": args.remat,
                      "seq_parallel": args.seq_parallel, "src": args.src,
                      "cuts_GB": cuts, "per_layer_GB": {
                          k: (fb[k] - fa[k]) / (b - a) for k in full},
                      f"at_{L}_layers_GB": full}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
