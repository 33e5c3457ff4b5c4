"""End-to-end LM training on the PyTorch/CUDA port: deterministic data
pipeline -> train step -> async checkpointing -> watchdog, for any of the
10 architectures (reduced config), through
``repro_torch.launch.train.train_loop``.

  PYTHONPATH=src python examples/torch_train_lm.py --arch jamba-v0.1-52b \
      --steps 40 [--device cpu]

On the card (the default) every attention layer runs the port's
attention kernels and every mamba layer its ``ssd_scan`` kernels; with
``--device cpu`` their plain PyTorch versions.  Checkpoints go under
``--ckpt-dir`` (by default a directory in the system's temporary
directory); a second run resumes from the last one.
"""

import argparse
import os
import tempfile
import time

from repro_torch.configs.base import ShapeConfig, get_config
from repro_torch.launch import steps as steplib
from repro_torch.launch.train import train_loop
from repro_torch.optim import adam


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-moe-16b")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    ckpt_dir = args.ckpt_dir or os.path.join(tempfile.gettempdir(),
                                             "repro_torch_ckpt")

    cfg = get_config(args.arch).reduced()
    print(f"[example] {args.arch} (reduced: {cfg.n_layers}L d={cfg.d_model}) "
          f"on {args.batch}x{args.seq} tokens/step, {args.device}")
    shape = ShapeConfig("example", "train", args.seq, args.batch)
    hp = steplib.HParams(
        remat="none",
        optimizer=adam.AdamWConfig(lr=2e-3, total_steps=args.steps,
                                   warmup_steps=max(2, args.steps // 10)))
    t0 = time.time()
    _, hist = train_loop(cfg, shape, hp, steps=args.steps,
                         ckpt_dir=ckpt_dir,
                         ckpt_every=max(1, args.steps // 2), log_every=5,
                         data_kind="copy", device=args.device)
    dt = time.time() - t0
    if not hist:
        print(f"[example] the checkpoint in {ckpt_dir} is at step "
              f"{args.steps} already")
        return hist
    print(f"[example] {len(hist)} steps in {dt:.1f}s "
          f"({len(hist) * args.batch * args.seq / dt:.0f} tok/s); "
          f"loss {hist[0]:.3f} -> {hist[-1]:.3f}; "
          f"checkpoints in {ckpt_dir}")
    return hist


if __name__ == "__main__":
    main()
