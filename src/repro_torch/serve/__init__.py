"""repro_torch.serve — persistent artifacts + multi-INR batched serving
(port of ``repro.serve``, DESIGN.md §6-7).

  * ``store``     — ArtifactStore: a CompiledGradient serialized to disk
                    under a weight-independent ARCHITECTURE SIGNATURE and
                    restored without re-tracing;
  * ``multi_inr`` — MultiINRArtifact: many INRs of one architecture (same
                    plan, different weights) through ONE compiled artifact,
                    residents stacked on a leading [K] axis, served by the
                    stacked region kernel where the plan is all regions;
  * ``bank``      — BankArtifact: a compiled filter bank (one merged
                    multi-output artifact) bound to its filter names;
  * ``engine``    — ServingEngine: the synchronous request-level front
                    door — (inr_id, coords) queries grouped by artifact and
                    padded through ``apply_batched``, filter requests
                    grouped by bank.

Not ported yet: the async engine (ROADMAP Queue 1 item 7).
"""

from repro_torch.serve.bank import BankArtifact
from repro_torch.serve.engine import ServingEngine
from repro_torch.serve.multi_inr import (MultiINRArtifact, bind_weights,
                                         const_payload, pad_rows)
from repro_torch.serve.store import (ArtifactStore, arch_signature,
                                     fn_fingerprint)

__all__ = [
    "ArtifactStore", "arch_signature", "fn_fingerprint", "BankArtifact",
    "MultiINRArtifact", "bind_weights", "const_payload", "pad_rows",
    "ServingEngine",
]
