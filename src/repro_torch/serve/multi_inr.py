"""Multi-INR batched serving: many weight sets through ONE compiled plan
(port of ``repro.serve.multi_inr``).

A CompiledGradient's plan, dispatch decisions and block geometry are
WEIGHT-INDEPENDENT — only the resident environment (the Const leaves and
everything derived from them) changes between two INRs of the same
architecture.  So K INRs share one artifact: per-INR residents are
recomputed once at construction (a handful of small matmuls per weight set,
never a re-trace), stacked on a leading [K] axis on the device, and served
through the base artifact's block pipeline.

Two serving paths, as in the reference:

  * the PER-LANE path (the reference's ``vmap`` path): a loop over lanes
    and chunks that calls ``base.resident_block_fn()`` with lane k's
    residents on a chunk's ``chunk_blocks · block`` rows at a time, so
    every region runs as one ``region_call`` and every singleton as one
    ``fused_chain`` per lane and chunk.  ``torch.func.vmap`` cannot go
    through the ctypes launch of a hand-written kernel, hence the loop.
  * the STACKED path (the reference's ``resident_double_buffer=True``,
    DESIGN.md §7): when the whole pipeline is fused regions, each region
    runs as ONE ``kernels.region.region_call_stacked`` launch over all K
    lanes and all rows of the call.  Lane k is bit for bit the per-lane
    path's result on the card (both run the region kernel's arithmetic on
    8-row tiles).

The stacked path serves whenever the plan allows it (no non-region units,
no streamed-broadcast extras, one input); the per-lane path serves the
rest.  There is no switch: the reference's flag trades TPU VMEM for
prefetching, a trade the port does not have.  ``.double_buffered``
reports which path serves.

Weight payloads map Const node id -> array.  ``bind_weights`` derives a new
INR's payload from a params tree WITHOUT compiling it, by matching the base
artifact's Const values against the template params (random init makes the
match unique; shared literals — w0 scalars, reverse-mode seeds — match
nothing and stay shared).

K-axis sharding (the reference's ``sharding=``) is not ported yet (ROADMAP
Queue 1 item 12).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.checkpoint.ckpt import host_array, tree_items
from repro_torch.core.executor import ResidentEnv, _eval_node, torch_dtype


def pad_rows(c, n_pad: int):
    """Pad [N, ...] query rows out to ``n_pad`` by replicating the edge row
    (zeros when N == 0 — there is no edge to replicate; either way the
    padding never reaches a caller, outputs are sliced back to N)."""
    n = c.shape[0]
    if n >= n_pad:
        return c
    if n == 0:
        return c.new_zeros((n_pad,) + tuple(c.shape[1:]))
    edge = c[-1:].expand((n_pad - n,) + tuple(c.shape[1:]))
    return torch.cat([c, edge])


def const_payload(cg) -> dict[int, np.ndarray]:
    """The artifact's weight payload: every Const node's value, keyed by
    node id (the same keying the ArtifactStore persists)."""
    return {nid: np.asarray(n.const)
            for nid, n in cg.graph.nodes.items() if n.op == "Const"}


def bind_weights(cg, template_params, new_params) -> dict[int, np.ndarray]:
    """Payload for a NEW weight set of ``cg``'s architecture, derived from a
    params tree (the port's ``list[dict]`` of tensors) — no trace, no
    compile.

    ``template_params`` must be the exact params ``cg`` was compiled from
    (its leaves appear verbatim as Const nodes); ``new_params`` must share
    its structure and leaf shapes/dtypes.  Each Const node is matched to the
    template leaf it equals and replaced by the corresponding new leaf;
    Consts matching no leaf (w0 scalars, cotangent seeds, literals) are
    architecture constants and stay shared.  Ambiguous matches (two equal
    template leaves whose new values differ) raise rather than guess."""
    t_items = list(tree_items(template_params))
    n_items = list(tree_items(new_params))
    t_paths, n_paths = [p for p, _ in t_items], [p for p, _ in n_items]
    if t_paths != n_paths:
        raise ValueError(f"new_params leaves {n_paths} != template "
                         f"{t_paths}")
    t_arrs = [host_array(v) for _, v in t_items]
    n_arrs = [host_array(v) for _, v in n_items]
    for i, (a, b) in enumerate(zip(t_arrs, n_arrs)):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise ValueError(f"leaf {i}: new {b.shape}/{b.dtype} != "
                             f"template {a.shape}/{a.dtype}")

    payload: dict[int, np.ndarray] = {}
    for nid, n in cg.graph.nodes.items():
        if n.op != "Const":
            continue
        c = np.asarray(n.const)
        matches = [i for i, a in enumerate(t_arrs)
                   if a.shape == c.shape and a.dtype == c.dtype
                   and np.array_equal(a, c)]
        if not matches:
            payload[nid] = c                      # shared literal
            continue
        cands = {n_arrs[i].tobytes() for i in matches}
        if len(cands) > 1:
            raise ValueError(
                f"Const node {nid} matches {len(matches)} template leaves "
                f"with differing replacement values — weight binding is "
                f"ambiguous (identical template leaves)")
        payload[nid] = n_arrs[matches[0]]
    return payload


class MultiINRArtifact:
    """K INRs of one architecture served through one compiled artifact.

    ``base`` supplies the plan/config/dispatch (and the graph's shared
    literals); ``payloads`` is one {Const node id: array} weight payload per
    INR (see ``bind_weights`` / ``ArtifactStore.load_weights``).  Residents
    are recomputed per payload on the base's device and stacked on a leading
    [K] axis.
    """

    def __init__(self, base, payloads, inr_ids=None, *, sharding=None):
        if sharding is not None:
            raise NotImplementedError(
                "K-axis sharding of multi-INR serving is not ported yet "
                "(ROADMAP Queue 1 item 12)")
        if not payloads:
            raise ValueError("need at least one weight payload")
        self.base = base
        self.device = base.device
        self.inr_ids = (list(inr_ids) if inr_ids is not None
                        else list(range(len(payloads))))
        if len(self.inr_ids) != len(payloads):
            raise ValueError("inr_ids and payloads disagree in length")
        g, plan = base.graph, base.plan
        const_ids = {nid for nid, n in g.nodes.items() if n.op == "Const"}

        per_inr: list[dict] = []
        for payload in payloads:
            missing = const_ids - {int(k) for k in payload}
            if missing:
                raise ValueError(f"payload missing Const nodes "
                                 f"{sorted(missing)}")
            res: dict[int, torch.Tensor] = {}
            for nid in plan.resident_order():
                n = g.nodes[nid]
                if n.op == "Const":
                    res[nid] = torch.as_tensor(
                        host_array(payload[nid]), device=self.device).to(
                            torch_dtype(n.dtype))
                else:
                    res[nid] = _eval_node(n, [res[i] for i in n.inputs],
                                          device=self.device)
            per_inr.append(res)
        # stack: resident leaves gain the [K] axis; lane k's environment is
        # a view of each stack (contiguous, as the kernels require)
        self.residents = {nid: torch.stack([r[nid] for r in per_inr])
                          .contiguous() for nid in per_inr[0]}
        self._lane_res = [ResidentEnv({nid: v[k] for nid, v in
                                       self.residents.items()})
                          for k in range(self.n_inrs)]
        self.double_buffered = self._stacked_applicable()
        self._serve = (self._make_serve_stacked() if self.double_buffered
                       else self._make_serve())

    @property
    def n_inrs(self) -> int:
        return len(self.inr_ids)

    def streamed_outputs(self) -> list[int]:
        return [o for o in self.base.graph.outputs
                if o not in self.base.plan.resident]

    def _make_serve(self):
        """The per-lane path: ``x`` is [K, rows, ...] (rows a block
        multiple); each lane's rows stream through the base pipeline with
        that lane's residents, one pass (one launch per unit) for each
        chunk of ``chunk_blocks`` blocks and one for the remainder.
        Returns [K, rows, ...] per streamed output."""
        block_fn = self.base.resident_block_fn()
        chunk = self.base.config.chunk_blocks * self.base.config.block

        def serve(x):
            lanes = []
            for k, res in enumerate(self._lane_res):
                passes = [block_fn(res, x[k, i:i + chunk])
                          for i in range(0, x.shape[1], chunk)]
                lanes.append([torch.cat(col) if len(col) > 1 else col[0]
                              for col in zip(*passes)])
            return tuple(torch.stack(col) for col in zip(*lanes))
        return serve

    def _stacked_applicable(self) -> bool:
        """True when the whole pipeline can serve through the K-stacked
        region kernel: every unit a fused region with no streamed-broadcast
        extras, single coordinate input, kernel dispatch on."""
        base = self.base
        rp = base.region_plan
        if (rp is None or not base.config.use_pallas
                or len(base.plan.inputs) != 1):
            return False
        units = rp.units()
        return bool(units) and all(
            kind == "region" and not u.broadcast_inputs
            for kind, u in units)

    def _make_serve_stacked(self):
        """The stacked path: each region is ONE ``region_call_stacked``
        launch over all K lanes and all rows.  Row-constant extras and
        residents are weight-dependent only, so their stacked operands are
        built once here."""
        from repro_torch.kernels.region import region_call_stacked
        base = self.base
        g, plan = base.graph, base.plan
        K, B = self.n_inrs, plan.batch
        residents = self.residents
        input_id = plan.inputs[0]
        streamed = self.streamed_outputs()

        def stacked_row(nid):
            # one [K, 1, C] row per row-const extra (cf. executor's
            # per-lane [1, C] conversion)
            a = residents[nid]                     # [K, ...per-lane]
            if nid in plan.rowconst and a.dim() >= 2 and a.shape[1:2] == (B,):
                a = a[:, :1]
            if a.dim() >= 3:
                return a[:, :1].reshape(K, 1, a.shape[-1]).contiguous()
            if a.dim() == 2:
                return a[:, None, :].contiguous()
            return a.reshape(K, 1, 1).contiguous()

        self.stacked_calls = calls = []   # (region, rows, residents, out_info)
        for _, region in base.region_plan.units():
            spec = region.spec
            bias_ids = {s[4] for s in spec.steps
                        if s[0] == "mm" and s[4] is not None}
            res_args = []
            for nid in region.resident_inputs:
                a = residents[nid]
                if nid in bias_ids and a.dim() == 3:
                    a = a[:, 0].contiguous()  # per-lane (1,N)/(B,N) -> (N,)
                res_args.append(a)
            calls.append((region, [stacked_row(nid)
                                   for nid, _ in region.bcast_rows],
                          res_args,
                          tuple((g.nodes[o].shape[-1], g.nodes[o].dtype)
                                for o in region.outputs)))

        def serve(x):                  # [K, rows, ...features]
            env = {input_id: x.contiguous()}
            for region, rows, res_args, out_info in calls:
                outs = region_call_stacked(
                    region.spec, [env[nid] for nid in region.stream_inputs],
                    rows, res_args, out_info)
                for nid, o in zip(region.outputs, outs):
                    env[nid] = o       # [K, rows, C]
            return tuple(env[o] for o in streamed)
        return serve

    def apply_chunk(self, xb):
        """One chunk step over an already-blocked batch: ``xb`` is
        [n_blocks, K, block, ...features]; returns the streamed outputs,
        each [n_blocks, K, block, ...] (the multi-INR analogue of
        ``CompiledGradient.apply_chunk``)."""
        nb, K, block = xb.shape[:3]
        x = xb.movedim(1, 0).reshape(K, nb * block, *xb.shape[3:])
        return tuple(o.reshape(K, nb, block, *o.shape[2:]).movedim(0, 1)
                     for o in self._serve(x))

    def apply_batched(self, coords):
        """Serve every INR's queries in one batched pass.

        ``coords`` is [K, N, ...features] (row k for INR k) or
        [N, ...features] (the same queries broadcast to all K).  N is padded
        to a block multiple (edge rows replicated; padding never reaches the
        caller).  Returns the same output tuple as ``base.apply_batched``
        with a leading [K] axis."""
        base = self.base
        if len(base.plan.inputs) != 1:
            raise ValueError("multi-INR serving supports single-input "
                             "(coordinate) pipelines")
        coords = torch.as_tensor(coords, device=self.device)
        feat_rank = len(base.graph.nodes[base.plan.inputs[0]].shape) - 1
        if coords.dim() == 1 + feat_rank:          # [N, ...] -> broadcast
            coords = coords[None].expand((self.n_inrs,) + tuple(coords.shape))
        K, n = coords.shape[0], coords.shape[1]
        if K != self.n_inrs:
            raise ValueError(f"coords carry {K} INRs, artifact has "
                             f"{self.n_inrs}")
        if n == 0:
            return tuple(
                self._resident_output(o, 0) if o in base.plan.resident
                else torch.zeros((K, 0) + tuple(base.graph.nodes[o].shape[1:]),
                                 dtype=torch_dtype(base.graph.nodes[o].dtype),
                                 device=self.device)
                for o in base.graph.outputs)
        pad = (-n) % base.config.block
        if pad:
            edge = coords[:, -1:].expand((K, pad) + tuple(coords.shape[2:]))
            coords = torch.cat([coords, edge], dim=1)
        streamed = iter(o[:, :n] for o in self._serve(coords))
        return tuple(self._resident_output(o, n) if o in base.plan.resident
                     else next(streamed) for o in base.graph.outputs)

    def _resident_output(self, o: int, n: int):
        v = self.residents[o]                # [K, ...]
        B = self.base.plan.batch
        if (o in self.base.plan.rowconst and v.dim() > 1
                and v.shape[1:2] == (B,)):
            # row-constant resident output: one row serves any batch size
            v = v[:, :1].expand((v.shape[0], n) + tuple(v.shape[2:]))
        return v

    @classmethod
    def from_store(cls, store, signature: str, inr_ids, *, sharding=None,
                   device=None):
        """Build from persisted weight sets: one ``load`` for the base
        artifact (no trace) plus one weight-payload read per INR."""
        inr_ids = list(inr_ids)
        if not inr_ids:
            raise ValueError("need at least one inr_id")
        base = store.load(signature, inr_id=inr_ids[0], device=device)
        payloads = [store.load_weights(signature, i) for i in inr_ids]
        return cls(base, payloads, inr_ids, sharding=sharding)

    def describe(self) -> str:
        dbuf = (", resident double-buffered (stacked region lanes)"
                if self.double_buffered else "")
        return (f"MultiINRArtifact: {self.n_inrs} INRs x "
                f"[{self.base.config.describe()}], "
                f"{len(self.residents)} stacked residents{dbuf}, "
                f"signature {self.base.signature}")
