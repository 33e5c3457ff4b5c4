"""Runs one cell: finds its configuration, traffic and metrics by name,
sets up, measures a window, checks the outputs and builds the result.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own under ``inrbench/``, found by the name that
``BENCHMARK.json`` gives it:

* a configuration: the JSON file its entry names, whose ``harness`` key
  names the module under ``inrbench/models/`` that drives the program
  (and the control) for it;
* a traffic mix: ``inrbench/traffic/<traffic>.json``;
* a cell's limits: ``inrbench/cells/<workload>.json``;
* a per-layer metric: ``inrbench/metrics/<name>.py``, whose ``read(ctx)``
  returns a number, or None when the run holds nothing to read.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from inrbench import guard, stats
from inrbench.loops import LOOPS
from inrbench.trace import Spans

PKG = Path(__file__).resolve().parent


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not Path(path).is_file():
        raise FileNotFoundError(f"no module at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """A workload of ``BENCHMARK.json`` with everything it names."""
    name: str
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    model: object
    end_to_end: list
    per_layer: list


def find_cell(root: Path, name: str, pkg: Path = PKG) -> Cell:
    spec = load_json(root / "BENCHMARK.json")
    wl = {w["name"]: w for w in spec["workloads"]}.get(name)
    if wl is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = {c["name"]: c for c in spec["configs"]}[wl["config"]]
    config = load_json(root / entry["file"])
    traffic = load_json(pkg / "traffic" / f"{wl['traffic']}.json")
    limits = load_json(pkg / "cells" / f"{name}.json")["limits"]
    model = load_module(pkg / "models" / f"{config['harness']}.py",
                        f"inrbench.models.{config['harness']}")

    def mine(m):
        return name in m.get("workloads", [name])

    e2e = [m for m in spec["end_to_end"] if mine(m)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in reported)]
    return Cell(name, wl, config, traffic, limits, model, e2e, layer)


@dataclass
class RunContext:
    """What a loop and a metric reader see of the run."""
    cell: str
    config: dict
    traffic: dict
    model: object
    device: torch.device
    seed: int
    seconds: float
    spans: Spans
    control: bool = False
    log: object = print
    # filled by the run
    window: object = None
    trace: object = None           # TraceReport (``--trace 1``)
    least_s: float | None = None   # least time of the window's work
    launches: dict = field(default_factory=dict)
    marks: list = field(default_factory=list)   # (set-up phase, its end)

    def mark(self, phase: str) -> None:
        """Ends the set-up phase ``phase`` now."""
        self.marks.append((phase, time.perf_counter()))


def card(device: torch.device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu",
            "kind": torch.cuda.get_device_name(device),
            "count": 1}


def run_cell(root: Path, name: str, seed: int, seconds: float, trace: bool,
             *, device=None, control: bool = False, t_start: float,
             log=print, pkg: Path = PKG, cell: Cell | None = None) -> dict:
    """One run; returns ``{"result": last line, "checks": {name: (value,
    limit)}}``.  ``device`` defaults to the first CUDA card."""
    from repro_torch.kernels import common

    cell = cell or find_cell(root, name, pkg)
    device = torch.device(device or "cuda:0")
    ctx = RunContext(name, cell.config, cell.traffic, cell.model, device,
                     seed, seconds, Spans(trace), control, log,
                     marks=[("start", t_start)])
    ctx.mark("imports")
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.zeros(1, device=device)
        ctx.mark("cuda")
        # the kernel library: built here in a checkout's first run only
        common.load_library()
        ctx.mark("library")
    common.fp32_strict()
    loop = LOOPS[cell.traffic["loop"]](ctx)
    loop.warm()
    # set-up's objects (torch's modules, the compiled graph: some 300,000)
    # go to the permanent generation; else each full collection in the
    # window scans them all, a 0.1-0.2 s pause with the card idle that
    # came a few times a window at random and spread the rate
    gc.collect()
    gc.freeze()
    ctx.mark("warm")
    guard.check("after set-up")
    common.reset_launches()
    setup_s = time.perf_counter() - t_start
    setup_parts = {b[0]: b[1] - a[1] for a, b in zip(ctx.marks,
                                                      ctx.marks[1:])}
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CUDA]
                       if device.type == "cuda" else [ProfilerActivity.CPU])
    with prof or contextlib.nullcontext():
        win = loop.window(seconds)
    ctx.window = win
    ctx.launches = dict(common.LAUNCHES)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    dev = card(device)
    dev["memory_peak_bytes"] = int(peak)
    peaks = stats.peaks_for(dev["kind"])
    if peaks is not None and win.work is not None:
        ctx.least_s = stats.least_time_s(win.work, peaks)
    if prof is not None:
        from inrbench import trace as tr
        ctx.trace = tr.read(prof, ctx.spans.done)

    # the program's state goes before the reference runs
    gc.unfreeze()
    loop.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    got = loop.check()
    checks = {k: (v, cell.limits[k]) for k, v in got.items()}
    correct = (win.failed == 0
               and all(v <= lim for v, lim in checks.values()))

    metrics = {}
    if trace:
        for m in cell.per_layer:
            reader = load_module(pkg / "metrics" / f"{m['name']}.py",
                                 f"inrbench.metrics.{m['name']}")
            v = reader.read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if ctx.trace is not None:
            dev["busy_s"] = ctx.trace.busy_s
            dev["window_s"] = ctx.trace.window_s
    else:
        for m in cell.end_to_end:
            v = setup_s if m["name"] == "setup_s" else win.e2e[m["name"]]
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": win.attempted,
              "failed": win.failed, "metrics": metrics, "device": dev}
    if trace and ctx.trace is not None:
        result["breakdown"] = {"device_ops": ctx.trace.device_ops,
                               "idle_gaps": ctx.trace.idle_gaps}
    result["setup_parts"] = setup_parts
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    _log_run(log, cell, ctx, win, setup_s, setup_parts, dev)
    # last: the reference and the metric readers ran after the window
    guard.check("before the result")
    return {"result": result, "checks": checks}


def _log_run(log, cell, ctx, win, setup_s, setup_parts, dev) -> None:
    parts = ", ".join(f"{k} {v:.3f}" for k, v in setup_parts.items())
    log(f"[inrbench] set-up s by phase: {parts}")
    log(f"[inrbench] {cell.name}: setup {setup_s:.3f} s, window "
        f"{win.window_s:.3f} s, attempted {win.attempted}, failed "
        f"{win.failed}, rows {win.rows}, calls {win.calls}, e2e {win.e2e}, "
        f"launches {ctx.launches}, peak {dev.get('memory_peak_bytes')} B")
    if ctx.least_s is not None:
        log(f"[inrbench] least time of the window's work {ctx.least_s:.6f} s"
            f" on {dev['kind']}")
    if ctx.trace is not None:
        t = ctx.trace
        log(f"[inrbench] trace: window {t.window_s:.6f} s, busy "
            f"{t.busy_s:.6f} s, kernels {t.kernel_s:.6f} s, copies "
            f"{t.copy_s:.6f} s, {t.n_device_ops} device ops ({t.n_outside} "
            f"outside the window); idle by span "
            f"{ {k: round(v, 6) for k, v in t.idle_by_span.items()} }")


def environment(root: Path) -> None:
    """Caches inside the checkout, at fixed paths; one host thread."""
    torch.set_num_threads(1)
    build = root / "build" / "inrbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    src = str(root / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them (the
    shares of a peak assume the full limit)."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
            else f"nvidia-smi: {out.stderr.strip()[:200]}"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi not read: {e}"
