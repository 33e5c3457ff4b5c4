"""The port's own copy of ``repro.data.pipeline`` (the port imports nothing
of the JAX package); keep the two in step.  numpy only: its batches are
bit for bit the reference's.

Deterministic, sharded, checkpointable data pipeline.

Every batch is a pure function of (seed, step, host), so:
  * restarts replay exactly (fault tolerance requirement);
  * hosts never exchange data (each computes its own shard);
  * elastic re-scale re-partitions deterministically: the GLOBAL batch for a
    step is identical regardless of host count, hosts just own different
    slices of it.

Synthetic corpora: "zipf" token streams (LM-plausible marginals) or "copy"
(induction-head-friendly) tasks.  The same interface would wrap a real
tokenized corpus; the framework only sees `batch_at(step)`.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    kind: str = "zipf"          # zipf | copy
    zipf_a: float = 1.2


class TokenPipeline:
    """Stateless-per-step pipeline; `state` is just the step counter."""

    def __init__(self, cfg: DataConfig, n_hosts: int = 1, host_id: int = 0):
        if cfg.global_batch % n_hosts:
            raise ValueError(f"global batch {cfg.global_batch} is not a "
                             f"multiple of {n_hosts} hosts")
        self.cfg = cfg
        self.n_hosts = n_hosts
        self.host_id = host_id
        self.host_batch = cfg.global_batch // n_hosts
        self.step = 0

    # -- determinism core -------------------------------------------------
    def _rng_for(self, step: int, row: int) -> np.random.Generator:
        key = f"{self.cfg.seed}:{step}:{row}".encode()
        seed = int.from_bytes(hashlib.sha256(key).digest()[:8], "little")
        return np.random.default_rng(seed)

    def _row(self, step: int, row: int) -> np.ndarray:
        cfg = self.cfg
        rng = self._rng_for(step, row)
        if cfg.kind == "zipf":
            t = rng.zipf(cfg.zipf_a, size=cfg.seq_len + 1)
            return np.minimum(t - 1, cfg.vocab_size - 1).astype(np.int32)
        if cfg.kind == "copy":
            half = (cfg.seq_len + 1) // 2
            pat = rng.integers(0, cfg.vocab_size, size=half)
            row_t = np.concatenate([pat, pat])[:cfg.seq_len + 1]
            return row_t.astype(np.int32)
        raise ValueError(cfg.kind)

    # -- public API --------------------------------------------------------
    def batch_at(self, step: int) -> dict:
        """This host's shard of the global batch for `step`."""
        rows = range(self.host_id * self.host_batch,
                     (self.host_id + 1) * self.host_batch)
        toks = np.stack([self._row(step, r) for r in rows])
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __next__(self):
        b = self.batch_at(self.step)
        self.step += 1
        return b

    def __iter__(self):
        return self

    # -- checkpointable state ----------------------------------------------
    def state_dict(self) -> dict:
        return {"step": self.step}

    def load_state_dict(self, s: dict):
        self.step = int(s["step"])


def pipeline_for(cfg: ModelConfig, shape: ShapeConfig, seed=0, n_hosts=1,
                 host_id=0, kind="zipf") -> TokenPipeline:
    return TokenPipeline(
        DataConfig(cfg.vocab_size, shape.seq_len, shape.global_batch,
                   seed=seed, kind=kind),
        n_hosts=n_hosts, host_id=host_id)
