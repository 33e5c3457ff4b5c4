"""The training loop: data pipeline -> train step -> checkpoint / watchdog
(port of ``repro.launch.train``).

Runs REAL steps on the card (CUDA unless ``device="cpu"``):

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b \
      --steps 5 --batch 8 --seq 64 --ckpt-dir /tmp/ckpt --ckpt-every 2

``--reduced`` is the default, as in the reference; ``--full`` trains the
full-size config.  Fault tolerance: deterministic pipeline replay, atomic
async checkpoints and a step watchdog (straggler events logged; a restart
resumes from the last checkpoint and replays exactly).  One device: the
port builds no mesh yet (ROADMAP Queue 1 item 12).
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from repro_torch.checkpoint import ckpt as ckptlib
from repro_torch.configs.base import ShapeConfig, get_config
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.distributed.fault_tolerance import StepWatchdog
from repro_torch.kernels.common import resolve_device
from repro_torch.launch import steps as steplib
from repro_torch.models.template import tree_map
from repro_torch.obs.log import get_logger
from repro_torch.optim import adam

_log = get_logger("train")


def make_mesh_if_possible(min_devices: int = 2, device=None):
    """None where ``device`` has fewer than ``min_devices`` devices (the CPU,
    or one card); a mesh over more is not ported yet (item 12)."""
    dev = resolve_device(device)
    n = torch.cuda.device_count() if dev.type == "cuda" else 1
    if n < min_devices:
        return None
    raise NotImplementedError(f"{n} devices: meshes and sharded training "
                              f"are not ported yet, ROADMAP Queue 1 item 12")


def _restore(state, path, device):
    """``state``'s tensors replaced by the checkpoint at ``path``."""
    host, _ = ckptlib.restore(state, path)
    params = tree_map(lambda a: torch.from_numpy(a).to(device),
                      {"params": host["params"], "opt": host["opt"]})
    return {**params, "step": torch.tensor(int(host["step"]),
                                           dtype=torch.int32)}


def train_loop(cfg, shape: ShapeConfig, hp: steplib.HParams, *, steps: int,
               ckpt_dir: str | None = None, ckpt_every: int = 0,
               seed: int = 0, log_every: int = 10, resume: bool = True,
               data_kind: str = "zipf", device=None, on_step=None):
    """``steps`` train steps from a fresh state (or the last checkpoint
    under ``ckpt_dir``) -> (state, the loss of each step run).
    ``on_step(step, metrics, seconds)`` is called after each step with its
    metrics as floats and its wall time (ending in a synchronisation on
    the card).  The reference's ``compress`` flag, whose wrapper passes the
    step through unchanged, is left out."""
    dev = resolve_device(device)
    make_mesh_if_possible(device=dev)             # None, or raises
    step_fn = steplib.build_train_step(cfg, hp)
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, shape.seq_len,
                                    shape.global_batch, seed=seed,
                                    kind=data_kind))
    state = steplib.init_state(cfg, seed, device=dev)
    start = 0
    ck = ckptlib.AsyncCheckpointer() if ckpt_dir else None
    if ckpt_dir and resume:
        last = ckptlib.latest_step(ckpt_dir)
        if last is not None:
            state = _restore(state, os.path.join(ckpt_dir, f"step_{last}"),
                             dev)
            start = last
            pipe.load_state_dict({"step": last})
            _log.info("resumed", step=last)

    wd = StepWatchdog()
    history = []
    try:
        for step in range(start, steps):
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in pipe.batch_at(step).items()}
            wd.start_step(step)
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            metrics = {k: float(v) for k, v in metrics.items()}
            seconds = time.perf_counter() - t0
            ev = wd.end_step()
            history.append(metrics["loss"])
            if on_step is not None:
                on_step(step, metrics, seconds)
            if ev is not None:
                _log.warn("straggler", step=ev.step, duration_s=ev.duration,
                          ratio=ev.ratio)
            if log_every and step % log_every == 0:
                _log.info("step", step=step, loss=metrics["loss"],
                          gnorm=metrics["grad_norm"], lr=metrics["lr"])
            if ck and ckpt_every and (step + 1) % ckpt_every == 0:
                ck.submit(state, os.path.join(ckpt_dir, f"step_{step + 1}"),
                          step + 1)
    finally:
        if ck:
            ck.close()
    return state, history


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--remat", default="dots")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--data", default="zipf", choices=["zipf", "copy"])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    shape = ShapeConfig("cli", "train", args.seq, args.batch)
    hp = steplib.HParams(
        remat=args.remat,
        optimizer=adam.AdamWConfig(lr=args.lr, total_steps=args.steps,
                                   warmup_steps=min(20, args.steps // 5)))
    t0 = time.time()
    _, hist = train_loop(cfg, shape, hp, steps=args.steps,
                         ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                         seed=args.seed, data_kind=args.data,
                         device=args.device)
    _log.info("done", steps=args.steps, wall_s=time.time() - t0,
              loss_first=hist[0], loss_last=hist[-1])


if __name__ == "__main__":
    main()
