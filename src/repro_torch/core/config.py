"""The port's own copy of ``repro.core.config`` (the port imports nothing of the
JAX package); keep the two in step.

HardwareConfig — every hardware knob of the pipeline in one frozen object.

INR-Arch's compiler "automatically configures hardware parameters such as
latency and stream depths" (paper Sec. 3.2.3-4); before this module those
parameters were scattered kwargs — ``block=8`` at compile time,
``dataflow_block=64`` / ``mm_parallel=16`` on the dataflow side,
``chunk_blocks`` on the serving path, ``use_pallas`` on dispatch — each
hand-threaded and hand-tuned per call site.  ``HardwareConfig`` is the single
source of truth that every layer reads:

    compile_gradient / compile_from_graph   -> cache key + artifact identity
    segment.build_segment_plan              -> MM segments carry mm_parallel
    executor._run_segment                   -> kernel tile hints
    codegen.emit_python                     -> emitted source records it
    dataflow.map_to_dataflow / fifo_opt     -> FIFO granule, MM ii, alpha
    CompiledGradient.apply_batched          -> serving chunk size

The object is frozen and hashable, so it IS the compile-cache key: two
artifacts differ exactly when their resolved configs (or graphs) differ.
``core.autoconfig.resolve_config`` searches this space automatically — the
paper's automatic hardware-parameter configuration.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class HardwareConfig:
    """All hardware parameters of one compiled pipeline.

    * ``block``            — rows per pipeline step: the batch dim is split
                             into blocks of this many rows for the streaming
                             executor and the serving path (DESIGN.md §2).
    * ``chunk_blocks``     — serving granule: ``apply_batched`` streams full
                             chunks of this many blocks through one jitted
                             ``lax.map``; the remainder goes block-by-block.
    * ``dataflow_block``   — FIFO granule (elements per block) of the
                             dataflow model: ``Stream.n_blocks`` and the
                             deadlock/latency analysis count in these units.
    * ``mm_parallel``      — default MM kernel parallelism: the dataflow MM
                             initiation interval is ``ceil(K / mm_parallel)``
                             and the Pallas matmul reduction tile follows it.
    * ``mm_parallel_per_segment`` — ``((segment_id, parallelism), ...)``
                             overrides: each MatMul / FusedMmAct segment can
                             carry its own factor (what autoconfig searches).
    * ``use_pallas``       — Pallas kernel dispatch; ``None`` = auto (TPU).
    * ``fifo_alpha``       — FIFO-depth optimization latency budget (the
                             paper's 1%).
    * ``bm`` / ``bn``      — Pallas tile shape: rows / columns per kernel
                             grid step (the MXU/VPU tile the stream kernels
                             and the region megakernel block on); part of
                             the autoconfig search space.
    * ``fuse_regions``     — enable the region scheduler: adjacent
                             expressible segments merge into FusedRegions
                             executed as one Pallas megakernel with
                             intermediates held in VMEM (DESIGN.md §7).
    * ``vmem_budget``      — VMEM bytes a fused region's working set may
                             occupy (inputs + weights + live intermediates
                             + outputs at the ``bm`` tile); region growth
                             stops at this budget.
    * ``region_packing``   — how the region scheduler sizes a region's
                             working set against ``vmem_budget``: ``"live"``
                             (default) charges intermediates only while live
                             (freed at last use, so regions grow longer) and
                             column-tiles wide layers at ``bn`` when that is
                             what makes them fit; ``"sum"`` keeps every step
                             output charged for the whole region (the PR 5
                             estimator — the conservative floor autoconfig
                             scores against).
    * ``region_cuts``      — segment ids after which a region is forced to
                             end — explicit cut points (what autoconfig
                             searches on top of the greedy scheduler).
    * ``n_shards``         — devices the serving batch is split across.  At
                             ``> 1`` the dataflow model inserts one CROSS-
                             SHARD stream per pipeline input (the host ->
                             shard interconnect hop), so the latency oracle
                             and the deadlock check stay honest under a
                             sharded mesh (DESIGN.md §8).
    * ``xshard_row_cost``  — calibrated row-cycles one streamed row charges
                             crossing the interconnect (host DMA + ICI hop);
                             2 ≈ a transcendental, matching the measured
                             device_put-per-row overhead of the CPU/TPU
                             streams the serve benchmarks time.
    """

    block: int = 8
    chunk_blocks: int = 64
    dataflow_block: int = 64
    mm_parallel: int = 16
    mm_parallel_per_segment: tuple[tuple[int, int], ...] = ()
    use_pallas: bool | None = None
    fifo_alpha: float = 0.01
    bm: int = 128
    bn: int = 128
    fuse_regions: bool = True
    vmem_budget: int = 8 * 1024 * 1024
    region_packing: str = "live"
    region_cuts: tuple[int, ...] = ()
    n_shards: int = 1
    xshard_row_cost: int = 2

    def __post_init__(self):
        for name in ("block", "chunk_blocks", "dataflow_block", "mm_parallel",
                     "bm", "bn", "vmem_budget", "n_shards", "xshard_row_cost"):
            v = getattr(self, name)
            if not isinstance(v, int) or v <= 0:
                raise ValueError(f"HardwareConfig.{name} must be a positive "
                                 f"int, got {v!r}")
        if not 0.0 <= self.fifo_alpha:
            raise ValueError(f"fifo_alpha must be >= 0, got {self.fifo_alpha}")
        if self.region_packing not in ("live", "sum"):
            raise ValueError(f"region_packing must be 'live' or 'sum', "
                             f"got {self.region_packing!r}")
        # normalize overrides to a sorted tuple of int pairs so that equal
        # configs hash equal regardless of construction order
        norm = tuple(sorted((int(s), int(p))
                            for s, p in self.mm_parallel_per_segment))
        for s, p in norm:
            if p <= 0:
                raise ValueError(f"mm_parallel override for segment {s} must "
                                 f"be positive, got {p}")
        object.__setattr__(self, "mm_parallel_per_segment", norm)
        cuts = tuple(sorted({int(s) for s in self.region_cuts}))
        if any(s < 0 for s in cuts):
            raise ValueError(f"region_cuts must be segment ids, got {cuts}")
        object.__setattr__(self, "region_cuts", cuts)

    # -- queries -----------------------------------------------------------

    def mm_parallel_for(self, segment_id: int) -> int:
        """MM parallelism for one segment: override if present, else global."""
        for s, p in self.mm_parallel_per_segment:
            if s == segment_id:
                return p
        return self.mm_parallel

    @property
    def pallas_resolved(self) -> bool:
        if self.use_pallas is None:
            raise ValueError("use_pallas not resolved; call .resolved() first")
        return self.use_pallas

    # -- derivation --------------------------------------------------------

    def replace(self, **kw) -> "HardwareConfig":
        return dataclasses.replace(self, **kw)

    def resolved(self) -> "HardwareConfig":
        """Concretize ``use_pallas``.  In the port it means "dispatch to the
        port's kernels" and 'auto' resolves to True: every wrapper runs its
        CUDA kernel on CUDA tensors and its plain version on CPU tensors.
        Resolved configs are what cache keys and artifacts carry, so 'auto'
        and an explicit True share one compile-cache entry."""
        if self.use_pallas is not None:
            return self
        return self.replace(use_pallas=True)

    def clamped(self, batch: int) -> "HardwareConfig":
        """Clamp ``block`` to the plan batch (a block never exceeds it)."""
        if self.block <= batch:
            return self
        return self.replace(block=batch)

    # -- serialization -----------------------------------------------------

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["mm_parallel_per_segment"] = list(
            list(x) for x in self.mm_parallel_per_segment)
        d["region_cuts"] = list(self.region_cuts)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "HardwareConfig":
        """Inverse of ``as_dict`` — the config <-> dict round trip the
        artifact store relies on.  Unknown keys are ignored (forward
        compatibility with store entries written by newer code)."""
        fields = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in fields}
        if kw.get("mm_parallel_per_segment") is not None:
            kw["mm_parallel_per_segment"] = tuple(
                (int(s), int(p)) for s, p in kw["mm_parallel_per_segment"])
        if kw.get("region_cuts") is not None:
            kw["region_cuts"] = tuple(int(s) for s in kw["region_cuts"])
        return cls(**kw)

    def describe(self) -> str:
        ov = (f" +{len(self.mm_parallel_per_segment)} per-segment"
              if self.mm_parallel_per_segment else "")
        cuts = f" cuts={list(self.region_cuts)}" if self.region_cuts else ""
        shards = (f" n_shards={self.n_shards}"
                  f" xshard_row_cost={self.xshard_row_cost}"
                  if self.n_shards > 1 else "")
        return (f"block={self.block} chunk_blocks={self.chunk_blocks} "
                f"dataflow_block={self.dataflow_block} "
                f"mm_parallel={self.mm_parallel}{ov} "
                f"use_pallas={self.use_pallas} fifo_alpha={self.fifo_alpha} "
                f"bm={self.bm} bn={self.bn} "
                f"fuse_regions={self.fuse_regions} "
                f"region_packing={self.region_packing}{cuts}{shards}")


DEFAULT_CONFIG = HardwareConfig()


def as_hardware_config(config: "HardwareConfig | None" = None, *,
                       block: int | None = None,
                       use_pallas: bool | None = None,
                       chunk_blocks: int | None = None) -> HardwareConfig:
    """Merge a config with legacy per-knob kwargs into one HardwareConfig.

    ``config=None`` starts from DEFAULT_CONFIG; explicit kwargs (the old
    scattered-knob API, kept as conveniences) override the config's fields.
    """
    cfg = config if config is not None else DEFAULT_CONFIG
    if not isinstance(cfg, HardwareConfig):
        raise TypeError(f"config must be a HardwareConfig or None, got "
                        f"{type(cfg).__name__} (for 'auto', use "
                        f"compile_gradient(config='auto'))")
    kw = {}
    if block is not None:
        kw["block"] = int(block)
    if use_pallas is not None:
        kw["use_pallas"] = bool(use_pallas)
    if chunk_blocks is not None:
        kw["chunk_blocks"] = int(chunk_blocks)
    return cfg.replace(**kw) if kw else cfg
