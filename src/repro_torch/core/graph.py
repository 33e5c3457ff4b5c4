"""The port's own copy of ``repro.core.graph`` (the port imports nothing of the
JAX package); keep the two in step.

ComputeGraph IR — the paper's representation of an n-th order gradient
computation.

Nodes are primitive ops (Mm, Sin, Cos, Mul, Add, T, Permute, ...); edges are
tensors.  The IR is deliberately close to the paper's PyTorch-autograd graph
(Sec. 3.2.2) so the four optimization passes and the dataflow mapping read
like the paper.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field, replace
from typing import Iterable, Optional

import numpy as np


@dataclass
class Node:
    id: int
    op: str                         # "Mm" | "T" | "Permute" | "Sin" | ...
    shape: tuple[int, ...]
    dtype: str
    inputs: tuple[int, ...] = ()    # ordered producer node ids
    params: tuple = ()              # static attributes (perm, dims, ...)
    const: Optional[np.ndarray] = None   # for op == "Const"

    @property
    def size(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    def key(self, canon: dict[int, int]) -> tuple:
        """Structural hash key under an id-canonicalization map."""
        if self.op == "Const":
            h = hashlib.sha1(np.ascontiguousarray(self.const).tobytes()).hexdigest()
            return ("Const", self.shape, self.dtype, h)
        if self.op == "Input":
            return ("Input", self.params, self.shape, self.dtype)
        return (self.op, self.params, self.shape, self.dtype,
                tuple(canon.get(i, i) for i in self.inputs))


class ComputeGraph:
    """A DAG of Nodes.  Node ids are stable; deletion is by dropping from
    `nodes` and rewriting consumers."""

    def __init__(self):
        self.nodes: dict[int, Node] = {}
        self.outputs: list[int] = []
        self._next = 0

    # -- construction ------------------------------------------------------
    def add(self, op: str, shape, dtype, inputs=(), params=(), const=None) -> int:
        nid = self._next
        self._next += 1
        self.nodes[nid] = Node(nid, op, tuple(shape), str(dtype),
                               tuple(inputs), tuple(params), const)
        return nid

    # -- queries -----------------------------------------------------------
    def __len__(self):
        return len(self.nodes)

    @property
    def n_edges(self) -> int:
        return sum(len(n.inputs) for n in self.nodes.values())

    def consumers(self) -> dict[int, list[int]]:
        out: dict[int, list[int]] = {i: [] for i in self.nodes}
        for n in self.nodes.values():
            for i in n.inputs:
                out[i].append(n.id)
        return out

    def counts_by_op(self) -> dict[str, int]:
        c: dict[str, int] = {}
        for n in self.nodes.values():
            c[n.op] = c.get(n.op, 0) + 1
        return c

    def topo_order(self) -> list[int]:
        state: dict[int, int] = {}
        order: list[int] = []
        stack: list[tuple[int, bool]] = [(o, False) for o in reversed(self.outputs)]
        while stack:
            nid, done = stack.pop()
            if done:
                order.append(nid)
                state[nid] = 2
                continue
            if state.get(nid):
                continue
            state[nid] = 1
            stack.append((nid, True))
            for i in reversed(self.nodes[nid].inputs):
                if not state.get(i):
                    stack.append((i, False))
        return order

    def live_nodes(self) -> set[int]:
        return set(self.topo_order())

    def prune_dead(self) -> int:
        live = self.live_nodes()
        dead = [i for i in self.nodes if i not in live]
        for i in dead:
            del self.nodes[i]
        return len(dead)

    def rewrite_inputs(self, mapping: dict[int, int]):
        """Redirect every edge i->j to mapping[i]->j (non-recursive map)."""
        if not mapping:
            return
        # resolve chains
        def resolve(i):
            seen = []
            while i in mapping:
                seen.append(i)
                i = mapping[i]
            return i
        for n in list(self.nodes.values()):
            new_in = tuple(resolve(i) for i in n.inputs)
            if new_in != n.inputs:
                self.nodes[n.id] = replace(n, inputs=new_in)
        self.outputs = [resolve(o) for o in self.outputs]

    def stats(self) -> dict:
        c = self.counts_by_op()
        return {"nodes": len(self.nodes), "edges": self.n_edges,
                "T": c.get("T", 0), "Permute": c.get("Permute", 0),
                "Mm": c.get("Mm", 0), "other": len(self.nodes)
                - c.get("T", 0) - c.get("Permute", 0)}

    def validate(self):
        for n in self.nodes.values():
            for i in n.inputs:
                assert i in self.nodes, f"dangling edge {i}->{n.id}"
        for o in self.outputs:
            assert o in self.nodes, f"dangling output {o}"
        # acyclic check via topo
        order = self.topo_order()
        pos = {nid: k for k, nid in enumerate(order)}
        for n in self.nodes.values():
            if n.id not in pos:
                continue
            for i in n.inputs:
                assert pos[i] < pos[n.id], f"cycle through {i}->{n.id}"
        return True


def merge_graphs(graphs: Iterable["ComputeGraph"]):
    """Graft several graphs into ONE multi-output graph (the filter-bank
    merge, DESIGN.md §9).

    Each input graph's live nodes are copied with fresh ids and its outputs
    appended to the merged ``outputs`` list — nothing is shared yet; the
    result is the disjoint union.  Running ``passes.dedupe_common_subtrees``
    on the merged graph is what collapses the shared structure: Input nodes
    with identical (params, shape, dtype) and Consts with identical content
    hash to the same key, so a feature prefix common to every filter
    CSE-merges into a single computation feeding every head.

    Returns ``(merged, slices)`` where ``slices[j] = (start, stop)`` is the
    half-open range of ``merged.outputs`` owned by input graph ``j`` —
    stable across the optimization passes, which rewrite output IDS but
    never reorder or drop output POSITIONS."""
    merged = ComputeGraph()
    slices: list[tuple[int, int]] = []
    for g in graphs:
        remap: dict[int, int] = {}
        for nid in g.topo_order():          # live nodes only, topo order
            n = g.nodes[nid]
            remap[nid] = merged.add(n.op, n.shape, n.dtype,
                                    tuple(remap[i] for i in n.inputs),
                                    n.params, n.const)
        start = len(merged.outputs)
        merged.outputs.extend(remap[o] for o in g.outputs)
        slices.append((start, len(merged.outputs)))
    return merged, slices
