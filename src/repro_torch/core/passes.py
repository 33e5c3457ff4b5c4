"""The port's own copy of ``repro.core.passes`` (the port imports nothing of the
JAX package); keep the two in step.

Lossless graph optimization passes (paper Sec. 3.2.2, Table III).

Four passes exactly as the paper orders them:
  1. dedupe_common_subtrees — hash-cons bottom-up; removes the chain-rule
     redundancy introduced by repeated differentiation (-92% nodes in the
     paper's 2nd-order SIREN graph).
  2. permute_to_transpose — "Permute" that swaps the axes of a 2-D tensor is
     a "T" (transpose) node.
  3. remove_transpose_pairs — contiguous T chains collapse mod 2.
  4. dedupe_common_transposes — multiple Ts of the same producer collapse to
     one canonical T (a special case of 1, kept separate for the ablation).
"""

from __future__ import annotations

from dataclasses import replace

from repro_torch.core.graph import ComputeGraph


def dedupe_common_subtrees(g: ComputeGraph) -> int:
    """Hash-cons: nodes with identical (op, params, canonical inputs) merge.
    Returns number of nodes removed."""
    before = len(g.nodes)
    canon: dict[int, int] = {}
    seen: dict[tuple, int] = {}
    for nid in g.topo_order():
        n = g.nodes[nid]
        k = n.key(canon)
        if k in seen:
            canon[nid] = seen[k]
        else:
            seen[k] = nid
    mapping = {a: b for a, b in canon.items() if a != b}
    g.rewrite_inputs(mapping)
    g.prune_dead()
    return before - len(g.nodes)


def permute_to_transpose(g: ComputeGraph) -> int:
    """Permute([1,0]) on a 2-D tensor -> T."""
    count = 0
    for nid, n in list(g.nodes.items()):
        if n.op != "Permute":
            continue
        perm = dict(n.params).get("permutation")
        if perm is not None and tuple(perm) == (1, 0) and len(n.shape) == 2:
            g.nodes[nid] = replace(n, op="T", params=())
            count += 1
    return count


def remove_transpose_pairs(g: ComputeGraph) -> int:
    """T(T(x)) -> x, applied along contiguous T chains (pairs cancel)."""
    before = len(g.nodes)
    mapping: dict[int, int] = {}
    for nid in g.topo_order():
        n = g.nodes[nid]
        if n.op != "T":
            continue
        src = n.inputs[0]
        src = mapping.get(src, src)
        src_n = g.nodes[src]
        if src_n.op == "T":
            # T(T(x)) == x
            mapping[nid] = src_n.inputs[0]
    # resolve chains through the map
    g.rewrite_inputs(mapping)
    g.prune_dead()
    return before - len(g.nodes)


def dedupe_common_transposes(g: ComputeGraph) -> int:
    """Multiple T nodes with the same input: keep one canonical."""
    before = len(g.nodes)
    by_src: dict[int, int] = {}
    mapping: dict[int, int] = {}
    for nid in g.topo_order():
        n = g.nodes[nid]
        if n.op != "T":
            continue
        src = n.inputs[0]
        if src in by_src:
            mapping[nid] = by_src[src]
        else:
            by_src[src] = nid
    g.rewrite_inputs(mapping)
    g.prune_dead()
    return before - len(g.nodes)


PASSES = [
    ("dedupe_common_subtrees", dedupe_common_subtrees),
    ("permute_to_T", permute_to_transpose),
    ("remove_T_pairs", remove_transpose_pairs),
    ("dedupe_common_Ts", dedupe_common_transposes),
]


def optimize(g: ComputeGraph, record=None) -> ComputeGraph:
    """Run all four passes in paper order; optionally record Table-III-style
    stats into `record` (a list)."""
    if record is not None:
        record.append(("original", g.stats()))
    for name, p in PASSES:
        p(g)
        if record is not None:
            record.append((name, g.stats()))
    g.validate()
    return g
