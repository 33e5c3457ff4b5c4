"""ArtifactStore — CompiledGradient persistence without re-tracing (port of
``repro.serve.store``; the on-disk layout is the reference's, DESIGN.md §6).

The expensive half of the compiler front door is the TRACE.  Everything the
trace produces is plain data — the optimized ComputeGraph, the resolved
HardwareConfig and the Const leaf values (the INR's weights) — so this
module writes that data to disk and rebuilds the artifact from it:
restore = read + ``compile_from_graph`` (plan partitioning, residents on
the device), never a tracer invocation.

Keys.  The store's canonical key is the ARCHITECTURE SIGNATURE: a hash of
the optimized graph's structure (Const nodes contribute shape/dtype but NOT
values), the gradient order, and the resolved HardwareConfig.  Two INRs of
the same architecture with different weights share one signature, and the
weight payloads live in per-INR entries under it:

    <root>/index.json                 request-key -> {signature, weights}
    <root>/<signature>/meta.json      order, config, plan record, autoconfig
    <root>/<signature>/graph.json     structural graph (no Const values)
    <root>/<signature>/weights/<id>/  one checkpoint dir per weight set
                                      (``checkpoint.ckpt``: manifest +
                                      per-leaf .npy with sha1 checksums)

The port writes no ``source.py`` (it has no codegen yet); entries the
reference wrote load all the same, ignoring it, and keep their autoconfig
record.

``compile_gradient(..., store=...)`` is a three-level lookup: in-process
cache -> this store (via ``index.json``, keyed by a cross-process
fingerprint of fn + order + shapes + config) -> trace, compile and persist.
The fingerprint hashes the function's code and every array, tensor and
``nn.Module`` state reachable from it (the weights), so a replica that
rebuilds the same INR from the same checkpoint derives the same request key
and restores without ever tracing.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import itertools
import json
import os
import re
import time
import types

import numpy as np
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.core.config import HardwareConfig
from repro_torch.core.graph import ComputeGraph, Node
from repro_torch.obs.metrics import MetricsView, counter as _obs_counter

FORMAT_VERSION = 1

# store phase counters live on the process-global metrics registry (one
# timeseries per store instance via the ``store=`` label)
_STORE_SEQ = itertools.count()
_STORE_METRICS = {
    "puts": ("store_puts", "architecture entries written"),
    "weight_puts": ("store_weight_puts", "weight payloads written"),
    "loads": ("store_loads", "artifacts restored from disk"),
    "index_hits": ("store_index_hits", "request-index lookups that hit"),
    "index_misses": ("store_index_misses", "request-index lookups that missed"),
}


def _store_stats() -> MetricsView:
    view = MetricsView({k: _obs_counter(name, help)
                        for k, (name, help) in _STORE_METRICS.items()},
                       store=f"s{next(_STORE_SEQ)}")
    view.reset()
    return view


_ID_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,63}$")


# ---------------------------------------------------------------------------
# the architecture signature (weight-independent) and the weights key
# ---------------------------------------------------------------------------

def _structural_items(g: ComputeGraph) -> list:
    """Canonical, id-independent description of the graph's STRUCTURE.
    Const nodes contribute shape/dtype only — the signature must be shared
    by every weight set of one architecture."""
    order = g.topo_order()
    canon = {nid: k for k, nid in enumerate(order)}
    items = []
    for nid in order:
        n = g.nodes[nid]
        if n.op == "Const":
            items.append(("Const", n.shape, n.dtype))
        else:
            items.append((n.op, n.params, n.shape, n.dtype,
                          tuple(canon[i] for i in n.inputs)))
    items.append(("outputs", tuple(canon[o] for o in g.outputs)))
    return items


def arch_signature(g: ComputeGraph, order: int | None,
                   config: HardwareConfig | None) -> str:
    """The store's canonical key: graph structure + gradient order + resolved
    HardwareConfig."""
    cfg = sorted(config.as_dict().items()) if config is not None else None
    payload = repr((FORMAT_VERSION, _structural_items(g),
                    "order", order, "config", cfg))
    return "inr-" + hashlib.sha256(payload.encode()).hexdigest()[:20]


def weights_key(g: ComputeGraph) -> str:
    """Content hash of the Const leaf values — identifies one weight set
    within an architecture (the default per-INR entry name).  Memoized on
    the graph object (graphs are frozen once compiled)."""
    cached = getattr(g, "_weights_key", None)
    if cached is not None:
        return cached
    h = hashlib.sha1()
    for nid in g.topo_order():
        n = g.nodes[nid]
        if n.op == "Const":
            arr = np.ascontiguousarray(n.const)
            h.update(str((n.shape, n.dtype)).encode())
            h.update(arr.tobytes())
    key = "w-" + h.hexdigest()[:16]
    g._weights_key = key
    return key


# ---------------------------------------------------------------------------
# cross-process fn fingerprint (best-effort; None = skip the disk level)
# ---------------------------------------------------------------------------

class _Unstable(Exception):
    """Raised when fn reaches something we cannot fingerprint stably."""


def _feed_tensor(h, t: torch.Tensor) -> None:
    t = t.detach().cpu().contiguous()
    h.update(str((tuple(t.shape), str(t.dtype))).encode())
    h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())


def _feed_module(h, m: torch.nn.Module, seen: dict, depth: int) -> None:
    """A module is its classes' code, its plain attributes and its state:
    every submodule's class and ``forward``, every public attribute that is
    not a submodule or tensor, then ``state_dict`` (parameters, buffers)."""
    for name, sub in m.named_modules():
        h.update(b"module:" + name.encode())
        _feed(h, type(sub), seen, depth + 1)
        _feed(h, type(sub).forward, seen, depth + 1)
        _feed(h, {k: v for k, v in vars(sub).items()
                  if not k.startswith("_")}, seen, depth + 1)
    _feed(h, dict(m.state_dict(keep_vars=True)), seen, depth + 1)


def _feed(h, obj, seen: dict, depth: int = 0) -> None:
    if depth > 24:
        raise _Unstable("closure nesting too deep")
    explicit = getattr(obj, "__inr_arch_key__", None)
    if isinstance(explicit, str):
        h.update(b"key:" + explicit.encode())
        return
    if obj is None or isinstance(obj, (bool, int, float, complex, str,
                                       bytes)):
        h.update(repr(obj).encode())
        return
    if isinstance(obj, (np.ndarray, np.generic)):
        arr = np.asarray(obj)
        h.update(str((arr.shape, str(arr.dtype))).encode())
        h.update(np.ascontiguousarray(arr).tobytes())
        return
    if isinstance(obj, torch.Tensor):
        _feed_tensor(h, obj)
        return
    if isinstance(obj, (torch.dtype, torch.device)):
        h.update(b"torch:" + str(obj).encode())
        return
    if isinstance(obj, types.ModuleType):
        h.update(b"mod:" + obj.__name__.encode())
        return
    if isinstance(obj, type):
        h.update(b"cls:" + f"{obj.__module__}.{obj.__qualname__}".encode())
        return
    if id(obj) in seen:
        h.update(b"<cycle>")
        return
    # seen maps id -> obj, HOLDING the reference: a freed temporary's
    # address could otherwise be reused by a later object, which would
    # short-circuit as a bogus <cycle> and skip its contents
    seen[id(obj)] = obj
    if isinstance(obj, torch.nn.Module):
        _feed_module(h, obj, seen, depth + 1)
        return
    if isinstance(obj, types.FunctionType):
        h.update(f"{obj.__module__}.{obj.__qualname__}".encode())
        _feed_code(h, obj.__code__, obj.__globals__, seen, depth + 1)
        for d in obj.__defaults__ or ():
            _feed(h, d, seen, depth + 1)
        for cell in obj.__closure__ or ():
            _feed(h, cell.cell_contents, seen, depth + 1)
        return
    if isinstance(obj, types.MethodType):
        _feed(h, obj.__func__, seen, depth + 1)
        _feed(h, obj.__self__, seen, depth + 1)
        return
    if isinstance(obj, functools.partial):
        _feed(h, obj.func, seen, depth + 1)
        _feed(h, tuple(obj.args), seen, depth + 1)
        _feed(h, dict(obj.keywords), seen, depth + 1)
        return
    if isinstance(obj, (tuple, list)):
        h.update(b"seq%d:" % len(obj))
        for x in obj:
            _feed(h, x, seen, depth + 1)
        return
    if isinstance(obj, dict):
        h.update(b"map%d:" % len(obj))
        for k in sorted(obj, key=repr):
            _feed(h, k, seen, depth + 1)
            _feed(h, obj[k], seen, depth + 1)
        return
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        h.update(type(obj).__qualname__.encode())
        for f in dataclasses.fields(obj):
            h.update(f.name.encode())
            _feed(h, getattr(obj, f.name), seen, depth + 1)
        return
    raise _Unstable(f"cannot fingerprint {type(obj).__name__}")


def _feed_code(h, code, globs: dict, seen: dict, depth: int) -> None:
    """Hash a code object INCLUDING the module-level state it references:
    bytecode, nested code objects, and every global named in ``co_names``
    that resolves in the function's module (a changed module-level constant
    or helper must change the fingerprint, or a replica would restore a
    stale artifact with wrong numerics)."""
    if depth > 24:
        raise _Unstable("code nesting too deep")
    h.update(code.co_code)
    for c in code.co_consts:
        if isinstance(c, types.CodeType):
            _feed_code(h, c, globs, seen, depth + 1)
        else:
            _feed(h, c, seen, depth + 1)
    for name in code.co_names:
        if name in globs:
            h.update(b"g:" + name.encode())
            _feed(h, globs[name], seen, depth + 1)


def fn_fingerprint(fn) -> str | None:
    """Stable cross-process fingerprint of an INR fn (a function or an
    ``nn.Module``): code identity, every array or tensor reachable from it
    (the weights), and the globals its code names.  Set
    ``fn.__inr_arch_key__`` to override with an explicit stable name.
    Returns None when fn holds something unfingerprintable — the caller
    then skips the disk-index level."""
    h = hashlib.sha1()
    try:
        _feed(h, fn, {})
    except _Unstable:
        return None
    return h.hexdigest()


def request_key(fn, order: int, trace_shape, dtype: str,
                config: HardwareConfig, *, mode: str = "explicit") -> str | None:
    """The disk-index key for a compile_gradient request: fn fingerprint +
    the same (order, block-rounded shape, dtype, resolved config) tuple the
    in-process cache keys on.  ``mode="auto"`` keys an autoconfig request
    (config = the search's BASE, the resolved winner lives in the entry)."""
    fp = fn_fingerprint(fn)
    if fp is None:
        return None
    payload = repr((fp, int(order), tuple(trace_shape), str(dtype), mode,
                    sorted(config.as_dict().items())))
    return hashlib.sha1(payload.encode()).hexdigest()


def bank_request_key(fn, heads, order: int, trace_shape, dtype: str,
                     config: HardwareConfig, *,
                     mode: str = "explicit") -> str | None:
    """The disk-index key for a ``compile_bank`` request: the INR fn's
    fingerprint plus one fingerprint PER HEAD (head closures hold the filter
    weights, tensors included, which ``fn_fingerprint`` hashes), the
    gradient order, trace shape/dtype, and the resolved config.  None when
    any participant has no stable cross-process fingerprint — the disk level
    is then skipped."""
    fps = [fn_fingerprint(fn)] + [fn_fingerprint(h) for h in heads]
    if any(fp is None for fp in fps):
        return None
    payload = repr(("bank", fps, int(order), tuple(trace_shape), str(dtype),
                    mode, sorted(config.as_dict().items())))
    return hashlib.sha1(payload.encode()).hexdigest()


# ---------------------------------------------------------------------------
# graph (de)serialization — structure in JSON, Const values in checkpoints
# ---------------------------------------------------------------------------

def _jsonable(v):
    if isinstance(v, tuple):
        return [_jsonable(x) for x in v]
    return v


def _tupled(v):
    if isinstance(v, list):
        return tuple(_tupled(x) for x in v)
    return v


def graph_to_json(g: ComputeGraph) -> dict:
    nodes = []
    for nid in sorted(g.nodes):
        n = g.nodes[nid]
        nodes.append({
            "id": n.id, "op": n.op, "shape": list(n.shape),
            "dtype": n.dtype, "inputs": list(n.inputs),
            "params": _jsonable(n.params),
        })
    return {"format": FORMAT_VERSION, "nodes": nodes,
            "outputs": list(g.outputs), "next": g._next}


def graph_from_json(doc: dict, consts: dict[int, np.ndarray]) -> ComputeGraph:
    """Rebuild a ComputeGraph; ``consts`` supplies Const node values (keyed
    by node id).  Node ids are preserved exactly, so segment ids and
    weight-payload keys stay stable across the round-trip."""
    if doc.get("format") != FORMAT_VERSION:
        raise ValueError(f"unsupported graph format {doc.get('format')!r}")
    g = ComputeGraph()
    for rec in doc["nodes"]:
        nid = int(rec["id"])
        const = None
        if rec["op"] == "Const":
            const = np.asarray(consts[nid])
            if tuple(const.shape) != tuple(rec["shape"]) or \
                    str(const.dtype) != rec["dtype"]:
                raise IOError(f"weight payload for node {nid} has "
                              f"{const.shape}/{const.dtype}, graph expects "
                              f"{tuple(rec['shape'])}/{rec['dtype']}")
        g.nodes[nid] = Node(nid, rec["op"], tuple(rec["shape"]), rec["dtype"],
                            tuple(int(i) for i in rec["inputs"]),
                            _tupled(rec["params"]), const)
    g.outputs = [int(o) for o in doc["outputs"]]
    g._next = int(doc["next"])
    g.validate()
    return g


def _const_ids(doc: dict) -> list[int]:
    return [int(r["id"]) for r in doc["nodes"] if r["op"] == "Const"]


def _atomic_write(path: str, text: str) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------

class ArtifactStore:
    """Persistent artifact store rooted at one directory (see module doc for
    the layout).  Weight payloads go through ``checkpoint.ckpt``;
    ``put_async`` hands the payload to a background ``AsyncCheckpointer``."""

    def __init__(self, root: str):
        self.root = str(root)
        os.makedirs(self.root, exist_ok=True)
        self._graph_docs: dict[str, dict] = {}     # signature -> graph.json
        self._writer: ckpt.AsyncCheckpointer | None = None
        self.stats = _store_stats()

    # -- paths -------------------------------------------------------------

    def _entry(self, signature: str) -> str:
        if not _ID_RE.match(signature.replace("inr-", "x", 1)):
            raise ValueError(f"malformed signature {signature!r}")
        return os.path.join(self.root, signature)

    def _weights_dir(self, signature: str, weight_id: str) -> str:
        if not _ID_RE.match(weight_id):
            raise ValueError(f"weight/INR id must match {_ID_RE.pattern}, "
                             f"got {weight_id!r}")
        return os.path.join(self._entry(signature), "weights", weight_id)

    # -- queries -----------------------------------------------------------

    def has(self, signature: str, weight_id: str | None = None) -> bool:
        entry = self._entry(signature)
        if not os.path.isfile(os.path.join(entry, "meta.json")):
            return False
        if weight_id is None:
            return True
        return os.path.isdir(self._weights_dir(signature, weight_id))

    def signatures(self) -> list[str]:
        return sorted(d for d in os.listdir(self.root)
                      if os.path.isfile(os.path.join(self.root, d,
                                                     "meta.json")))

    def weight_ids(self, signature: str) -> list[str]:
        wroot = os.path.join(self._entry(signature), "weights")
        if not os.path.isdir(wroot):
            return []
        return sorted(d for d in os.listdir(wroot)
                      if os.path.isfile(os.path.join(wroot, d,
                                                     "manifest.json")))

    def meta(self, signature: str) -> dict:
        with open(os.path.join(self._entry(signature), "meta.json")) as f:
            return json.load(f)

    def info(self) -> dict:
        sigs = self.signatures()
        return {"root": self.root, "entries": len(sigs),
                "weight_sets": sum(len(self.weight_ids(s)) for s in sigs),
                **self.stats}

    # -- persist -----------------------------------------------------------

    def _put_arch(self, cg, default_weights: str) -> str:
        """Write the per-signature architecture data (graph, config, plan
        record, autoconfig) once; idempotent."""
        signature = cg.signature
        entry = self._entry(signature)
        if self.has(signature):
            return signature
        os.makedirs(entry, exist_ok=True)
        autoconfig = None
        if cg.autoconfig is not None:
            from repro_torch.core.autoconfig import result_as_dict
            autoconfig = result_as_dict(cg.autoconfig)
        meta = {
            "format": FORMAT_VERSION,
            "signature": signature,
            "order": cg.order,
            "config": cg.config.as_dict(),
            "default_weights": default_weights,
            "plan": {
                "batch": cg.plan.batch,
                "segments": [[s.kind, list(s.nodes)]
                             for s in cg.plan.segments],
                "n_residents": len(cg.plan.resident),
            },
            "autoconfig": autoconfig,
            "created": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
        }
        _atomic_write(os.path.join(entry, "graph.json"),
                      json.dumps(graph_to_json(cg.graph)) + "\n")
        _atomic_write(os.path.join(entry, "meta.json"),
                      json.dumps(meta, indent=1) + "\n")
        self.stats["puts"] += 1
        return signature

    @staticmethod
    def _const_payload(cg) -> dict:
        return {f"n{nid}": np.asarray(n.const)
                for nid, n in cg.graph.nodes.items() if n.op == "Const"}

    def put(self, cg, *, inr_id: str | None = None,
            request_key: str | None = None) -> str:
        """Persist a CompiledGradient.  Architecture data is written once
        per signature; the weight payload goes under ``inr_id`` (default: a
        content hash of the weights).  Idempotent.  Returns the signature."""
        wid = inr_id or weights_key(cg.graph)
        signature = self._put_arch(cg, wid)
        if not self.has(signature, wid):
            ckpt.save(self._const_payload(cg),
                      self._weights_dir(signature, wid))
            self.stats["weight_puts"] += 1
        if request_key is not None:
            self.bind(request_key, signature, wid)
        return signature

    def put_weights(self, signature: str, inr_id: str, payload: dict) -> str:
        """Add one more INR's weight set to an existing architecture entry
        WITHOUT compiling it: ``payload`` maps Const node id -> array (see
        ``multi_inr.bind_weights``)."""
        doc = self._graph_doc(signature)
        want = set(_const_ids(doc))
        got = {int(k) for k in payload}
        if got != want:
            raise ValueError(f"payload const ids {sorted(got)} != graph "
                             f"const ids {sorted(want)}")
        flat = {f"n{int(nid)}": ckpt.host_array(v)
                for nid, v in payload.items()}
        ckpt.save(flat, self._weights_dir(signature, inr_id))
        self.stats["weight_puts"] += 1
        return inr_id

    def put_async(self, cg, *, inr_id: str | None = None,
                  request_key: str | None = None) -> str:
        """Like ``put`` but the weight payload is written by a background
        ``AsyncCheckpointer``; call ``wait()`` before reading it back.
        Architecture metadata is written synchronously — it is tiny, and the
        index binding must point at a valid entry."""
        wid = inr_id or weights_key(cg.graph)
        signature = self._put_arch(cg, wid)
        if not self.has(signature, wid):
            if self._writer is None:
                self._writer = ckpt.AsyncCheckpointer()
            self._writer.submit(self._const_payload(cg),
                                self._weights_dir(signature, wid), 0)
            self.stats["weight_puts"] += 1
        if request_key is not None:
            self.bind(request_key, signature, wid)
        return signature

    def wait(self) -> None:
        if self._writer is not None:
            self._writer.wait()

    # -- restore -----------------------------------------------------------

    def _graph_doc(self, signature: str) -> dict:
        doc = self._graph_docs.get(signature)
        if doc is None:
            with open(os.path.join(self._entry(signature),
                                   "graph.json")) as f:
                doc = json.load(f)
            self._graph_docs[signature] = doc
        return doc

    def load_weights(self, signature: str,
                     weight_id: str) -> dict[int, np.ndarray]:
        """One weight set as a {Const node id: array} payload (checksums
        verified by the checkpoint layer)."""
        doc = self._graph_doc(signature)
        template = {f"n{nid}": 0 for nid in _const_ids(doc)}
        flat, _ = ckpt.restore(template, self._weights_dir(signature,
                                                           weight_id))
        return {int(k[1:]): np.asarray(v) for k, v in flat.items()}

    def load(self, signature: str, *, inr_id: str | None = None,
             device=None):
        """Restore a CompiledGradient on ``device`` (CUDA unless the caller
        passes "cpu").  Rebuilds the graph from structure + weight payload
        and runs the BACK half of the compiler (``compile_from_graph``) —
        the tracer is never invoked.  The restored plan is verified against
        the persisted plan record; a persisted autoconfig record rides on
        the artifact again."""
        from repro_torch.core.autoconfig import result_from_dict
        from repro_torch.core.pipeline import compile_from_graph

        meta = self.meta(signature)
        if meta.get("format") != FORMAT_VERSION:
            raise ValueError(f"unsupported store format "
                             f"{meta.get('format')!r}")
        wid = inr_id or meta["default_weights"]
        consts = self.load_weights(signature, wid)
        g = graph_from_json(self._graph_doc(signature), consts)
        cfg = HardwareConfig.from_dict(meta["config"])
        cg = compile_from_graph(g, config=cfg, order=meta["order"],
                                device=device)
        got = [[s.kind, list(s.nodes)] for s in cg.plan.segments]
        if got != meta["plan"]["segments"]:
            raise IOError(f"restored plan disagrees with persisted plan "
                          f"record for {signature} — store entry is stale "
                          f"or the planner changed incompatibly")
        if meta.get("autoconfig"):
            cg.autoconfig = result_from_dict(meta["autoconfig"])
        cg.provenance = "store"
        cg._signature = signature
        cg._stored_in.add(self.root)
        self.stats["loads"] += 1
        return cg

    # -- the request index (pre-trace lookup) ------------------------------

    def _index_path(self) -> str:
        return os.path.join(self.root, "index.json")

    def _read_index(self) -> dict:
        try:
            with open(self._index_path()) as f:
                return json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return {}

    def bind(self, request_key: str, signature: str, weight_id: str) -> None:
        idx = self._read_index()
        idx[request_key] = {"signature": signature, "weights": weight_id}
        _atomic_write(self._index_path(), json.dumps(idx, indent=1) + "\n")

    def lookup(self, request_key: str | None):
        """index hit -> (signature, weight_id), else None."""
        if request_key is None:
            return None
        rec = self._read_index().get(request_key)
        if rec is None or not self.has(rec["signature"], rec["weights"]):
            self.stats["index_misses"] += 1
            return None
        self.stats["index_hits"] += 1
        return rec["signature"], rec["weights"]

    def restore_request(self, request_key: str | None, *, device=None):
        """The disk level of the three-level lookup: index -> load, or None."""
        hit = self.lookup(request_key)
        if hit is None:
            return None
        signature, weight_id = hit
        return self.load(signature, inr_id=weight_id, device=device)

    def ensure(self, cg, *, request_key: str | None = None) -> str:
        """Persist-if-missing: used on in-process cache hits so a store
        passed late still ends up populated, without rewriting payloads."""
        if not self.has(cg.signature, weights_key(cg.graph)):
            return self.put(cg, request_key=request_key)
        if request_key is not None and self.lookup(request_key) is None:
            self.bind(request_key, cg.signature, weights_key(cg.graph))
        return cg.signature


def as_store(store) -> "ArtifactStore | None":
    """Normalize a ``store=`` argument: an ArtifactStore passes through, a
    path becomes a store rooted there, None stays None."""
    if store is None or isinstance(store, ArtifactStore):
        return store
    if isinstance(store, (str, os.PathLike)):
        return ArtifactStore(os.fspath(store))
    raise TypeError(f"store must be an ArtifactStore or a path, got "
                    f"{type(store).__name__}")
