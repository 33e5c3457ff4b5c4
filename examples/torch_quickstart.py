"""Quickstart for the PyTorch/CUDA port: the INR-Arch pipeline in ~50 lines.

  PYTHONPATH=src python examples/torch_quickstart.py [--store DIR] [--device cpu]

The front door is ``repro_torch.core.pipeline.compile_gradient``: ONE call
takes a SIREN INR and a gradient order and runs the paper's compiler
(extract the nth-order gradient graph, optimize it, partition it into
segments and fused regions, compute the residents on the device),
returning a CompiledGradient artifact.  The FIFO-optimized dataflow
analysis derives lazily from the same plan.  Compile once, then repeat
compilations are cache hits, and ``apply_batched`` serves any number of
query points through the port's CUDA kernels (their plain PyTorch versions
with ``--device cpu``).

With ``--store DIR`` the artifact also persists to an ArtifactStore: run
the script twice and the second run's "cold" compile is a restore from
disk, the tracer never invoked.
"""

import argparse
import time

import torch

from repro_torch.configs.siren import SirenConfig
from repro_torch.core.pipeline import compile_cache_info, compile_gradient
from repro_torch.inr.gradnet import paper_gradients
from repro_torch.inr.siren import siren_fn, siren_init

ap = argparse.ArgumentParser()
ap.add_argument("--store", default=None, metavar="DIR",
                help="persist/restore compiled artifacts under DIR "
                     "(second run warm-starts from disk)")
ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
args = ap.parse_args()
store, dev = args.store, torch.device(args.device)

# 1. an INR (SIREN) and a batch of query coordinates
cfg = SirenConfig()
gen = torch.Generator().manual_seed(0)
f = siren_fn(cfg, siren_init(cfg, gen, device=dev))
x = (torch.rand(cfg.batch, cfg.in_features, generator=gen) * 2 - 1).to(dev)

# 2. compile once (with --store: in-process cache -> disk store ->
# trace + compile + persist)
t0 = time.perf_counter()
cg = compile_gradient(f, order=2, example_coords=x, store=store, device=dev)
print(f"cold compile: {time.perf_counter() - t0:.2f}s — "
      f"{len(cg.graph.nodes)} nodes, {len(cg.plan.segments)} segments, "
      f"{len(cg.residents)} residents, dispatch "
      f"{[k for _, _, k in cg.dispatch]} [provenance: {cg.provenance}]")

# ... and never again: the same request is a cache hit (same object)
t0 = time.perf_counter()
assert compile_gradient(f, order=2, example_coords=x, store=store,
                        device=dev) is cg
print(f"cache hit: {(time.perf_counter() - t0) * 1e6:.0f}us "
      f"({compile_cache_info()})")
if store is not None:
    print(f"artifact store: signature {cg.signature} under {store!r} — "
          f"rerun this script and the cold compile becomes a disk restore")

# 3. the dataflow side, from the same plan: deadlock-free FIFO sizing
# (dataflow-model outputs: block steps and FIFO depths in blocks)
print(f"hardware config: {cg.config.describe()}")
s = cg.dataflow_summary()
print(f"FIFO depths: {s['sum_depths_before']} -> {s['sum_depths_after']} "
      f"blocks ({100 * s['depth_reduction']:.0f}% less memory, "
      f"{100 * s['latency_overhead']:+.2f}% latency)")

# 3b. or let the compiler PICK the config: config="auto" searches with the
# dataflow latency oracle (and, on CUDA, times the candidates' real
# serving); shown on a smaller SIREN, since the search grows with the graph
small = SirenConfig(hidden_features=32, hidden_layers=2)
fs = siren_fn(small, siren_init(small, torch.Generator().manual_seed(0),
                                device=dev))
t0 = time.perf_counter()
auto = compile_gradient(fs, order=2, example_coords=x, config="auto",
                        store=store, device=dev)
print(f"autoconfig ({time.perf_counter() - t0:.1f}s): "
      f"{auto.autoconfig.describe()} [provenance: {auto.provenance}]")

# 4. serve: any batch size, one launch per unit per chunk
q = (torch.rand(1001, cfg.in_features, generator=gen) * 2 - 1).to(dev)
outs = cg.apply_batched(q)                        # not a block multiple
want = paper_gradients(f, 2, cfg.out_features, cfg.in_features,
                       batch=q.shape[0], device=dev)(q)
err = max(float((a.detach() - b).abs().max()) for a, b in zip(want, outs))
print(f"served {q.shape[0]} queries on {dev}; max |err| vs direct "
      f"torch.autograd: {err:.2e}")
