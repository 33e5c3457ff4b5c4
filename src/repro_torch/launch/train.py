"""The training loop: data pipeline -> train step -> checkpoint / watchdog
(port of ``repro.launch.train``).

Runs REAL steps on the card (CUDA unless ``device="cpu"``):

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b \
      --steps 5 --batch 8 --seq 64 --ckpt-dir /tmp/ckpt --ckpt-every 2

``--reduced`` is the default, as in the reference; ``--full`` trains the
full-size config.  Fault tolerance: deterministic pipeline replay, atomic
async checkpoints and a step watchdog (straggler events logged; a restart
resumes from the last checkpoint and replays exactly).

Sharded: with a process group up (one process a rank;
``launch/mesh.py::init_process_group``, or the CLI's ``--world-size n
--rank r --pg-store PATH``, a ``FileStore`` path every rank can reach),
``train_loop`` builds the reference's ``(n // model, model)`` mesh and
keeps the state at ``steps.state_specs`` (``launch/steps.py`` says how a
sharded step runs); rank 0 writes the checkpoints.
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
from repro_torch.distributed.sharding import ShardingPolicy, make_mesh
from repro_torch.kernels.common import resolve_device
from repro_torch.launch import steps as steplib
from repro_torch.models.template import tree_map
from repro_torch.obs.log import get_logger
from repro_torch.optim import adam

_log = get_logger("train")


def make_mesh_if_possible(min_devices: int = 2, device=None):
    """The reference's ``(n // model, model)`` ("data", "model") mesh over
    the n ranks of the process group that is up (``model`` = 2 where n is
    even); None with fewer than ``min_devices`` ranks or no group (one
    process: the CPU, or one card).  ``device`` is checked as every entry
    point checks it."""
    import torch.distributed as dist
    resolve_device(device)
    n = dist.get_world_size() if dist.is_initialized() else 1
    if n < min_devices:
        return None
    model = 2 if n % 2 == 0 else 1
    return make_mesh((n // model, model), ("data", "model"))


def _restore(state, path, device, shardings=None):
    """``state``'s tensors replaced by the checkpoint at ``path`` (DTensors
    at ``shardings`` where given)."""
    host, _ = ckptlib.restore(state, path, shardings=shardings)
    params = {"params": host["params"], "opt": host["opt"]}
    if shardings is None:
        params = tree_map(lambda a: torch.from_numpy(a).to(device), params)
    step = host["step"]
    step = int(step.full_tensor() if hasattr(step, "full_tensor") else step)
    return {**params, "step": torch.tensor(step, dtype=torch.int32)}


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
    mesh = make_mesh_if_possible(device=dev)
    policy = (ShardingPolicy(mesh, seq_parallel=hp.seq_parallel)
              if mesh else None)
    step_fn = steplib.build_train_step(cfg, hp, policy)
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, shape.seq_len,
                                    shape.global_batch, seed=seed,
                                    kind=data_kind))
    state = steplib.init_state(cfg, seed, device=dev)
    shardings = None
    if policy is not None:
        state = steplib.place_state(state, cfg, policy)
        shardings = steplib._to_shardings(mesh,
                                          steplib.state_specs(cfg, policy))
    start = 0
    ck = ckptlib.AsyncCheckpointer() if ckpt_dir else None
    if ckpt_dir and resume:
        last = ckptlib.latest_step(ckpt_dir)
        if last is not None:
            state = _restore(state, os.path.join(ckpt_dir, f"step_{last}"),
                             dev, shardings)
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
    ap.add_argument("--world-size", type=int, default=1,
                    help="ranks, one process each")
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--pg-store", default=None,
                    help="FileStore path of the process group (ranks > 1)")
    args = ap.parse_args(argv)
    if args.world_size > 1:
        import torch.distributed as dist
        from repro_torch.launch.mesh import init_process_group
        if args.pg_store is None:
            ap.error("--world-size > 1 needs --pg-store")
        init_process_group(args.pg_store, args.rank, args.world_size,
                           backend="gloo" if args.device == "cpu" else None)

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
    if args.world_size > 1:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
