"""Counts the model work per row of a configuration from the program's
deduplicated gradient graph, once, for its file.  The harness never runs
this: it reads only the numbers frozen in the configuration's file.

    PYTHONPATH=src python3 inrbench/tools/freeze_work.py

Rule: over the graph's streamed nodes (not the weights nor anything
computed from them alone), a matrix product ``[rows, K] @ [K, N]`` counts
``2 K N`` FLOPs per row; every elementwise or transcendental op counts one
FLOP per output element; transposes, broadcasts and reshapes count none.
Bytes per row: each input and output column read or written once, 4 bytes.
Bytes per call: the weights read once.  A fit step counts forward plus
backward: 3x the forward's FLOPs (a product's input and weight gradients
at 2 K N each, two FLOPs per element for each elementwise pullback), its
bytes per row the coordinates and the target, per call the weights and
AdamW's moments read, and the gradient, moments and weights written.
Runs on the CPU.
"""

from __future__ import annotations

import collections
import json
import math
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

MOVES = {"Input", "Const", "Broadcast", "T", "Reshape", "Permute",
         "Transpose", "Slice", "Concat"}


def count(cg) -> dict:
    g, plan = cg.graph, cg.plan
    mm = other = 0
    ops = collections.Counter()
    for n in g.nodes.values():
        if n.id in plan.resident or n.op in MOVES:
            continue
        per_row = math.prod(n.shape[1:])
        ops[n.op] += 1
        if n.op == "Mm":
            a = g.nodes[n.inputs[0]]
            mm += 2 * a.shape[-1] * per_row
        else:
            other += per_row
    cols_in = sum(math.prod(g.nodes[i].shape[1:]) for i in plan.inputs)
    cols_out = sum(math.prod(g.nodes[o].shape[1:]) for o in g.outputs)
    return {"mm_flops": mm, "other_flops": other,
            "bytes": 4 * (cols_in + cols_out), "ops": dict(ops)}


def main() -> None:
    from inrbench.models import insp_bank, siren
    from repro_torch.core.pipeline import compile_bank, compile_gradient
    from repro_torch.inr.insp import insp_head

    out = {}
    for name in ("siren-256x3", "insp-bank4"):
        config = json.loads((ROOT / "inrbench" / "configs"
                             / f"{name}.json").read_text())
        g = torch.Generator().manual_seed(0)
        x = torch.zeros(64, config["in_features"])
        if config["harness"] == "siren":
            p = siren.weights(config, g, "cpu")[0]
            n_par = sum(v.numel() for layer in p for v in layer.values())
            serve = {}
            for order in config["orders"]:
                cg = compile_gradient(siren._fn(config, p), order, x,
                                      device="cpu")
                serve[str(order)] = count(cg)
                serve[str(order)]["bytes_per_call"] = 4 * n_par
            f2 = serve["2"]
            fit = {"2": {"mm_flops": 3 * f2["mm_flops"],
                         "other_flops": 3 * f2["other_flops"],
                         "bytes": 4 * (config["in_features"]
                                       + config["out_features"]),
                         "bytes_per_call": 7 * 4 * n_par}}
            out[name] = {"serve": serve, "fit": fit, "parameters": n_par}
        else:
            inr, heads = insp_bank.weights(config, g, "cpu")[0]
            n_par = sum(v.numel() for layer in inr for v in layer.values())
            n_par += sum(v.numel() for psi in heads for layer in psi
                         for v in layer.values())
            bank = compile_bank(siren._fn(config, inr),
                                [insp_head(psi) for psi in heads],
                                config["order"], x, device="cpu")
            c = count(bank.cg)
            c["bytes_per_call"] = 4 * n_par
            out[name] = {"serve": {str(config["order"]): c},
                         "parameters": n_par,
                         "region_steps": [len(r.spec.steps) for k, r in
                                          bank.cg.region_plan.units()
                                          if k == "region"]}
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
