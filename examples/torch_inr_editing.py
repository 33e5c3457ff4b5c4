"""End-to-end INR editing on the PyTorch/CUDA port (paper Fig. 1B): encode
an image as a SIREN, train an INSP-Net head to blur it IN WEIGHT SPACE, and
serve the edited INR through the compiled pipeline.

  PYTHONPATH=src python examples/torch_inr_editing.py [--store DIR] [--device cpu]

The gradient features are compiled ONCE: training streams the full
coordinate grid through the compiled pipeline up front, and evaluation
serves every pixel through the same artifact.  The edited INR itself (the
features and the trained head) compiles as a one-head filter bank, and the
curated filter library serves five closed-form edits from one merged bank
through the ServingEngine.  With ``--store DIR`` the compiled pipelines
persist to an ArtifactStore, so a re-run restores them from disk.
"""

import argparse

import torch

from repro_torch.configs.siren import InspConfig, SirenConfig
from repro_torch.core.config import HardwareConfig
from repro_torch.core.executor import (buffered_total_bytes,
                                       streaming_peak_bytes)
from repro_torch.inr.editing import (edited_bank, edited_inr, gaussian_blur,
                                     train_insp_head)
from repro_torch.inr.encode import encode_inr, image_coords, synthetic_image
from repro_torch.inr.filters import filter_bank
from repro_torch.inr.gradnet import compiled_feature_vector
from repro_torch.inr.siren import siren_fn
from repro_torch.serve import ServingEngine

ap = argparse.ArgumentParser()
ap.add_argument("--store", default=None, metavar="DIR",
                help="persist/restore the compiled pipelines under DIR "
                     "(repeat edits skip re-compilation)")
ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
args = ap.parse_args()
STORE, dev = args.store, torch.device(args.device)

RES = 32
scfg = SirenConfig(hidden_features=128, hidden_layers=3)
icfg = InspConfig(hidden=64, layers=3, grad_order=2)

print("1) encoding image as SIREN INR ...")
img = synthetic_image(RES, device=dev)
params, mse = encode_inr(scfg, img, steps=600, lr=3e-4, device=dev)
print(f"   encode mse = {mse:.6f}")

print("2) training INSP-Net head for Gaussian blur (weight-space edit) ...")
target = gaussian_blur(img, 1.0)
coords = image_coords(RES, device=dev)
# one HardwareConfig threads every layer below
hw = HardwareConfig(block=8, dataflow_block=64, mm_parallel=16)
_, cg = compiled_feature_vector(siren_fn(scfg, params), icfg.grad_order,
                                coords, config=hw, store=STORE,
                                device=dev)     # compiled ONCE, used twice
psi, emse = train_insp_head(scfg, icfg, params, target, steps=600, lr=2e-3,
                            compiled=cg, device=dev)
print(f"   edit-head mse = {emse:.6f}"
      + (f"  [feature pipeline provenance: {cg.provenance}]"
         if STORE else ""))

print("3) compiling the edited INR (features + head) as a one-head bank ...")
bank, fns = edited_bank(scfg, icfg, params, {"blur": psi},
                        coords[:scfg.batch], config=hw, store=STORE,
                        device=dev)
graph, plan = bank.cg.graph, bank.cg.plan
s = bank.cg.dataflow_summary()
eager = buffered_total_bytes(graph)
stream = streaming_peak_bytes(graph, s["design"], s["fifo"].depths_after,
                              plan=plan)
print(f"   graph {len(graph.nodes)} nodes, dispatch "
      f"{[k for _, _, k in bank.cg.dispatch]}; FIFO depths "
      f"{s['sum_depths_before']} -> {s['sum_depths_after']}")
print(f"   memory (model): eager {eager / 1e6:.2f} MB vs dataflow "
      f"{stream / 1e6:.2f} MB ({eager / stream:.1f}x less)  "
      f"[paper Table I: 1.7-8.9x]")

print("4) serving the edited INR through the compiled pipelines ...")
served = edited_inr(scfg, icfg, params, psi, compiled=cg, device=dev)
out = served(coords).reshape(RES, RES)
mae = float((out - target).abs().mean())
via_bank = float((fns["blur"](coords).reshape(RES, RES) - out).abs().max())
print(f"   edited-vs-blurred MAE over all pixels: {mae:.4f} (served "
      f"{coords.shape[0]} queries via apply_batched); bank vs features + "
      f"head: max |diff| {via_bank:.2e}")

print("5) curated filter library: closed-form edits as one served bank ...")
names = ["identity", "blur", "edge", "laplacian", "sharpen"]
# heat-flow time for a 1-pixel Gaussian on a RES grid over [-1, 1]:
# t = sigma^2 / 2 with sigma = 2 / RES in coordinate units
alpha = (2.0 / RES) ** 2 / 2.0
library = filter_bank(siren_fn(scfg, params), names, coords, alpha=alpha,
                      config=hw, store=STORE, device=dev)
engine = ServingEngine(STORE, device=dev)
engine.register_bank(names, library)
fouts = engine.serve([(n, coords) for n in names])
blur_img = fouts[1][0].reshape(RES, RES)
print(f"   one bank pass served {len(names)} filters "
      f"({engine.stats['bank_groups']} bank group); closed-form blur vs "
      f"Gaussian target MAE {float((blur_img - target).abs().mean()):.4f}")
