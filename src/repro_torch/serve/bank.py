"""BankArtifact: a filter bank as one persistent serving artifact (port of
``repro.serve.bank``).

``core.pipeline.compile_bank`` merges F filter graphs over one INR into a
single multi-output CompiledGradient (DESIGN.md §9): the shared
feature-extraction prefix is computed once and every filter head streams
off it, one fused region emitting all F outputs per chunk.  This module is
the serving-side wrapper:

  * the merged artifact persists through the ordinary ``ArtifactStore``
    under its architecture signature: a bank restores like any other
    CompiledGradient (read + rebuild, no re-trace);
  * ``filter_ids`` names the bank's outputs IN ORDER: filter ``j`` of the
    bank is output ``j`` of the merged graph (``compile_bank`` enforces
    one output per head);
  * ``ServingEngine.register_bank`` routes each filter id to its
    ``(signature, output index)``: grouped filter requests then run as ONE
    pass of the merged graph instead of F per-filter passes.
"""

from __future__ import annotations


class BankArtifact:
    """A compiled filter bank bound to its filter names.

    ``cg`` is the merged multi-output CompiledGradient (a ``CompiledBank``
    is unwrapped); ``filter_ids`` has one name per graph output, in output
    order."""

    def __init__(self, cg, filter_ids):
        cg = getattr(cg, "cg", cg)          # CompiledBank -> CompiledGradient
        filter_ids = tuple(filter_ids)
        if len(filter_ids) != len(cg.graph.outputs):
            raise ValueError(
                f"bank has {len(cg.graph.outputs)} outputs but "
                f"{len(filter_ids)} filter ids")
        if len(set(filter_ids)) != len(filter_ids):
            raise ValueError("filter ids must be unique")
        self.cg = cg
        self.filter_ids = filter_ids

    @classmethod
    def from_store(cls, store, signature: str, filter_ids, *,
                   device=None) -> "BankArtifact":
        """Restore a persisted bank on ``device`` (CUDA unless the caller
        passes "cpu"): the merged artifact rebuilds from its plan record
        (never re-traces), then binds to ``filter_ids``."""
        return cls(store.load(signature, device=device), filter_ids)

    @property
    def signature(self) -> str:
        return self.cg.signature

    @property
    def n_filters(self) -> int:
        return len(self.filter_ids)

    def index_of(self, filter_id: str) -> int:
        return self.filter_ids.index(filter_id)

    def apply_batched(self, coords):
        """One pass over ``coords``; returns the tuple of all ``n_filters``
        outputs (output ``j`` belongs to ``filter_ids[j]``)."""
        return self.cg.apply_batched(coords)

    def describe(self) -> str:
        return (f"BankArtifact({self.n_filters} filters: "
                f"{', '.join(self.filter_ids)})\n  {self.cg.describe()}")
