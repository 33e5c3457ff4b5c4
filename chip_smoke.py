#!/usr/bin/env python3
"""Run the PyTorch/CUDA port of the gradient pipeline on one GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA GPU

Phases (any failure exits non-zero; nothing is caught):
  1. the card: name and power limit (nvidia-smi), torch and CUDA versions;
  2. build the CUDA kernel library from ``src/repro_torch/kernels/csrc``;
  3. every kernel against its plain PyTorch version on the card, at the
     main path's shapes: fused_chain (every op, <= 1e-5 scaled),
     stream_matmul / siren_layer (<= 1e-4 scaled), region on every fused
     region the port plans for the full-width SIREN at orders 1-3 plus a
     column-tiled one (<= 1e-4 scaled); ms per launch of each;
  4. the main path: ``compile_gradient`` -> ``apply_batched`` on the
     full-width SIREN (random weights from a seeded generator) at orders
     1-3, fused on a 256 x 256 grid and unfused on a 64 x 64 grid, every
     output held to a float64 torch.autograd oracle (<= 1e-4 of max|oracle|);
  5. multi-INR serving at full width with K = 8 SIRENs (lane 0 is phase
     4's weights): region_call_stacked on the real regions of orders 1-2
     against its plain version (<= 1e-4 scaled) and, with torch.equal,
     against K single-lane region launches; MultiINRArtifact's stacked path
     (orders 1-2, broadcast and per-lane coordinates, N = 8,192 rows per
     lane and a ragged N) and per-lane path (order 3, N = 1,024), every
     lane held to its float64 oracle; the ServingEngine (order 2: grouping,
     a zero-row request, a K = 1 non-base weight id, stats) and a fresh
     engine restored from an ArtifactStore by signature alone (no tracer
     call, outputs torch.equal);
  6. the launches of every kernel on each path, counted from 0 just before
     the path and read just after it: phase 4 must launch region,
     fused_chain, stream_matmul and siren_layer, phase 5 region_stacked
     (stacked path) and region and fused_chain (per-lane path); one JSON
     line of per-kernel numbers;
  7. the last line: {"ok": true, "device": {...}}.

Times: ``ms`` is the device time of one call (torch.profiler, the sum of
the kernel records per call; for a plain version, every kernel it
launches), ``call_ms`` the time per call of back-to-back calls on the
stream (CUDA events; includes the host's launch path, so a plain version
of many small launches reads host time).  ``bound_ms`` is the larger
of bytes / 3.35 TB/s and flops / 67 TFLOP/s (H100 SXM fp32 without tensor
cores), each input and output counted once.
"""

from __future__ import annotations

import dataclasses
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
SEED = 0


def log(*a):
    print(*a, flush=True)


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def scaled_err(got, want):
    got, want = got.double(), want.double()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    scale = float(want.abs().max()) if want.numel() else 0.0
    return err, err / max(scale, 1e-30)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))

    from repro_torch.configs.siren import SirenConfig
    from repro_torch.core.config import HardwareConfig
    from repro_torch.core.executor import (_run_region, _run_segment,
                                           region_operands)
    from repro_torch.core.pipeline import compile_gradient
    from repro_torch.inr.siren import siren_fn, siren_init
    from repro_torch.kernels import common
    from repro_torch.kernels.fused_chain import BINARY, eval_chain, fused_chain
    from repro_torch.kernels.region import (RegionKernelSpec, lower,
                                           region_call, region_call_plain,
                                           region_call_stacked,
                                           region_call_stacked_plain)
    from repro_torch.kernels.siren_layer import siren_layer, siren_layer_plain
    from repro_torch.kernels.stream_matmul import (stream_matmul,
                                                   stream_matmul_plain)

    # -- 1. the card ---------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    card = smi[0].strip()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)}")
    common.fp32_strict()
    dev = torch.device("cuda")

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    common.load_library()
    log(f"[build] kernel library ready in {time.perf_counter() - t0:.1f} s")
    for src, text in common.build_logs().items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {src}: {line.strip()}")

    gen = torch.Generator().manual_seed(SEED)

    def rand(*shape, lo=-1.0, hi=1.0):
        return (torch.rand(*shape, generator=gen) * (hi - lo) + lo).to(dev)

    def call_ms(fn, iters=200, warmup=10):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(iters):
            fn()
        e.record()
        e.synchronize()
        return s.elapsed_time(e) / iters

    def device_ms(fn, iters=50):
        """Kernel time per call from torch.profiler; None if it saw none.

        Once many launches have run unprofiled, the profiler leaves out the
        first few kernel records of a session (on the H100, a stacked
        kernel read far below its CUDA-event time).  Each session starts
        with spin kernels that take that loss and are not counted; a
        session that kept none of them may have lost a measured record and
        is run again."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        for _ in range(3):
            try:
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    for _ in range(16):
                        torch.cuda._sleep(1000)
                    for _ in range(iters):
                        fn()
                    torch.cuda.synchronize()
            except RuntimeError as exc:  # no CUPTI: fall back to events
                log(f"[timing] torch.profiler unavailable: {exc}")
                return None
            recs = [ev for ev in prof.key_averages()
                    if ev.device_type == DeviceType.CUDA]
            if any("spin_kernel" in ev.key for ev in recs):
                break
        else:
            log("[timing] the profiler lost the leading records 3 times")
            return None
        total = sum(getattr(ev, "self_device_time_total", None)
                    or getattr(ev, "self_cuda_time_total", 0.0)
                    for ev in recs if "spin_kernel" not in ev.key)
        return total / iters / 1e3 if total > 0 else None

    def timing(fn, iters=50, call_iters=200):
        dms, cms = device_ms(fn, iters), call_ms(fn, call_iters)
        return (dms if dms is not None else cms), cms

    kernels = {}

    def record(name, source, replaces, errs, t_k, t_p, nbytes, flops,
               library_ms=None):
        b, by = bound_ms(nbytes, flops)
        kernels[name] = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0,
            "max_abs_err": max(e for e, _ in errs),
            "ms": t_k[0], "plain_ms": t_p[0], "bound_ms": b, "bound_by": by,
            "library_ms": library_ms,
            "call_ms": t_k[1], "plain_call_ms": t_p[1],
            "max_scaled_err": max(s for _, s in errs)}
        log(f"[kernel] {name}: max err {kernels[name]['max_abs_err']:.3e} "
            f"(scaled {kernels[name]['max_scaled_err']:.3e}); "
            f"{t_k[0]:.5f} ms/launch on the device ({t_k[1]:.5f} ms/call), "
            f"plain {t_p[0]:.5f} ms ({t_p[1]:.5f} ms/call), "
            f"bound {b:.6f} ms by {by}"
            + (f", library {library_ms:.5f} ms" if library_ms else ""))

    # -- 3a. fused_chain -----------------------------------------------------
    chains = [[(op, None) for op in ("sin", "cos", "exp", "tanh", "neg",
                                      "abs", "relu", "sigmoid", "silu",
                                      "square")],
              [("scale", 0.5), ("mul", None), ("offset", -0.25),
               ("add", None), ("sub", None), ("div", None)],
              [("max", None), ("cos", None), ("min", None), ("scale", 30.0),
               ("sin", None)]]
    errs = []
    for shape in [(8, 256), (8, 2), (8, 1), (13, 256)]:
        for chain in chains:
            x = rand(*shape)
            ex = [rand(*shape, lo=0.5, hi=1.5)
                  for op, _ in chain if op in BINARY]
            got = fused_chain(x, chain, ex)
            torch.cuda.synchronize()
            errs.append(scaled_err(got, eval_chain(x, chain, ex)))
        # broadcast operands, as the executor passes row-constant extras
        x, row, col = rand(*shape), rand(1, shape[1]), rand(shape[0], 1)
        got = fused_chain(x, [("mul", None), ("add", None)], [row, col])
        errs.append(scaled_err(got, x * row + col))
    worst = max(s for _, s in errs)
    if worst > 1e-5:
        raise AssertionError(f"fused_chain disagrees: scaled err {worst:.3e}")
    chain = [("cos", None), ("mul", None), ("scale", 30.0)]  # the path's
    x, e1 = rand(8, 256), rand(8, 256)
    record("fused_chain", "src/repro_torch/kernels/csrc/fused_chain.cu",
           "src/repro/kernels/fused_chain.py:81", errs,
           timing(lambda: fused_chain(x, chain, [e1])),
           timing(lambda: eval_chain(x, chain, [e1])),
           4 * 8 * 256 * 3, 3 * 8 * 256)

    # -- 3b. stream_matmul / siren_layer -------------------------------------
    mm_errs = {"stream_matmul": [], "siren_layer": []}
    for m, k, n in [(8, 256, 256), (8, 2, 256), (8, 1, 256), (8, 256, 2),
                    (8, 256, 1), (13, 37, 5)]:
        a, w = rand(m, k), rand(k, n) / k ** 0.5
        b = rand(n)
        got = stream_matmul(a, w, mm_parallel=16)
        mm_errs["stream_matmul"].append(scaled_err(got,
                                                   stream_matmul_plain(a, w)))
        for sin in (True, False):
            got = siren_layer(a, w, b, w0=30.0, apply_sin=sin, mm_parallel=16)
            mm_errs["siren_layer"].append(scaled_err(
                got, siren_layer_plain(a, w, b, w0=30.0, apply_sin=sin)))
    torch.cuda.synchronize()
    for name, e in mm_errs.items():
        worst = max(s for _, s in e)
        if worst > 1e-4:
            raise AssertionError(f"{name} disagrees: scaled err {worst:.3e}")
    a, w, b = rand(8, 256), rand(256, 256) / 16.0, rand(256)
    mm_bytes = 4 * (8 * 256 + 256 * 256 + 8 * 256)
    lib_ms = timing(lambda: torch.mm(a, w))[0]
    record("stream_matmul", "src/repro_torch/kernels/csrc/matmul.cu",
           "src/repro/kernels/stream_matmul.py:46", mm_errs["stream_matmul"],
           timing(lambda: stream_matmul(a, w, mm_parallel=16)),
           timing(lambda: stream_matmul_plain(a, w)),
           mm_bytes, 2 * 8 * 256 * 256, library_ms=lib_ms)
    record("siren_layer", "src/repro_torch/kernels/csrc/matmul.cu",
           "src/repro/kernels/siren_layer.py:38", mm_errs["siren_layer"],
           timing(lambda: siren_layer(a, w, b, w0=30.0, mm_parallel=16)),
           timing(lambda: siren_layer_plain(a, w, b, w0=30.0)),
           mm_bytes + 4 * 256, 2 * 8 * 256 * 256 + 3 * 8 * 256)

    # -- 3c. region, on the operands the main path hands it ------------------
    cfg = SirenConfig()
    params = siren_init(cfg, gen, device=dev)
    f = siren_fn(cfg, params)
    grid = torch.linspace(-1, 1, 256)
    coords = torch.stack(torch.meshgrid(grid, grid, indexing="ij"),
                         -1).reshape(-1, 2).to(dev)
    small = torch.linspace(-1, 1, 64)
    coords_small = torch.stack(torch.meshgrid(small, small, indexing="ij"),
                               -1).reshape(-1, 2).to(dev)
    fused_cfg = HardwareConfig(use_pallas=True)
    unfused_cfg = HardwareConfig(use_pallas=True, fuse_regions=False)
    tiled_cfg = HardwareConfig(use_pallas=True, bn=64, vmem_budget=1 << 20)

    def walk_block(cg, xblk, on_region):
        """Run one block unit by unit, calling on_region before each region."""
        plan, block, B = cg.plan, cg.config.block, cg.plan.batch
        env = {plan.inputs[0]: xblk}
        for kind, u in cg.region_plan.units():
            if kind == "region":
                on_region(u, region_operands(plan, u, env, cg.residents,
                                             block, B))
                _run_region(plan, u, env, cg.residents, block, B)
            else:
                env[u.output] = _run_segment(plan, u, cg._decisions[u.id],
                                             env, cg.residents, block, B)

    region_errs, region_shapes = [], []
    timed_region = None
    for order, conf in [(1, fused_cfg), (2, fused_cfg), (3, fused_cfg),
                        (1, tiled_cfg)]:
        t0 = time.perf_counter()
        cg = compile_gradient(f, order, coords[:cfg.batch], config=conf,
                              device="cuda")
        log(f"[compile] order {order} {conf.describe()}: "
            f"{time.perf_counter() - t0:.2f} s, {len(cg.graph.nodes)} nodes, "
            f"{len(cg.plan.segments)} segments, {cg.region_plan.counts()}")
        if conf is tiled_cfg and not any(r.spec.tile_groups for r in
                                         cg.region_plan.fused_regions()):
            raise AssertionError("the tight budget planned no tile group")

        def check(region, ops, order=order, conf=conf):
            nonlocal timed_region
            got = region_call(region.spec, *ops)
            want = region_call_plain(region.spec, *ops)
            torch.cuda.synchronize()
            for a, b in zip(got, want):
                region_errs.append(scaled_err(a, b))
            region_shapes.append((order, len(region.spec.steps),
                                  len(region.spec.tile_groups)))
            kinds = [st[0] for st in region.spec.steps]
            log(f"[region] order {order} bn={conf.bn}: {len(kinds)} steps "
                f"({kinds.count('mm')} mm, {kinds.count('chain')} chain), "
                f"{len(region.spec.tile_groups)} tile groups: "
                f"{device_ms(lambda: region_call(region.spec, *ops), 20)} "
                f"ms/launch on the device")
            if order == 2 and conf is fused_cfg and timed_region is None:
                timed_region = (region.spec, ops)

        walk_block(cg, coords[1000:1000 + cg.config.block], check)
    worst = max(s for _, s in region_errs)
    log(f"[region] {len(region_shapes)} regions checked "
        f"(order, steps, tile groups): {region_shapes}")
    if worst > 1e-4:
        raise AssertionError(f"region disagrees: scaled err {worst:.3e}")
    # the cost of one step inside a launch: 16 chained mm steps
    # ([8,256]@[256,256]) and 16 chained cos-mul-scale chain steps ([8,256])
    x, w, e1 = rand(8, 256), rand(256, 256) / 16.0, rand(8, 256)
    for label, steps, stream, res in [
            ("mm", tuple(("mm", i + 1, i, 100, None, 1.0, False)
                         for i in range(16)), [x], [w]),
            ("chain", tuple(("chain", i + 1, i, tuple(chain), (101,))
                            for i in range(16)), [x, e1], [])]:
        one = RegionKernelSpec(steps=steps[:1],
                               stream_inputs=(0, 101)[:len(stream)],
                               residents=(100,)[:len(res)], outputs=(1,))
        many = dataclasses.replace(one, steps=steps, outputs=(16,))
        t1 = device_ms(lambda: region_call(one, stream, [], res,
                                           ((256, "float32"),)), 20)
        t16 = device_ms(lambda: region_call(many, stream, [], res,
                                            ((256, "float32"),)), 20)
        log(f"[region] one {label} step [8,256]: {t1} ms/launch; 16 steps: "
            f"{t16} ms/launch")
    spec, ops = timed_region
    stream, rows, res, out_info = ops
    elems = sum(t.numel() for t in (*stream, *rows, *res)) \
        + sum(8 * c for c, _ in out_info)
    flops = lower(spec, tuple(t.shape[1] for t in stream),
                  tuple(t.shape[1] for t in rows),
                  tuple(tuple(t.shape) for t in res)).flops(8)
    record("region", "src/repro_torch/kernels/csrc/region.cu",
           "src/repro/kernels/region.py:241", region_errs,
           timing(lambda: region_call(spec, *ops)),
           timing(lambda: region_call_plain(spec, *ops)),
           4 * elems, flops)

    # -- 4. the main path ----------------------------------------------------
    def oracle(x, order, weights=params, chunk=4096):
        """float64 nth-order input gradients by nested torch.autograd."""
        p64 = [{k: v.double() for k, v in p.items()} for p in weights]
        cols = None
        for i in range(0, x.shape[0], chunk):
            xx = x[i:i + chunk].double().clone().requires_grad_(True)
            y = xx
            for li, p in enumerate(p64):
                y = y @ p["w"] + p["b"]
                if li < len(p64) - 1:
                    y = torch.sin(cfg.w0 * y)
            outs = [y]
            level = [y[:, c].sum() for c in range(y.shape[1])]
            for _ in range(order):
                grads = [torch.autograd.grad(s, xx, create_graph=True)[0]
                         for s in level]
                outs += grads
                level = [gr[:, j].sum() for gr in grads
                         for j in range(xx.shape[1])]
            outs = [o.detach() for o in outs]
            cols = [[o] for o in outs] if cols is None else \
                [c + [o] for c, o in zip(cols, outs)]
        return [torch.cat(c) for c in cols]

    common.reset_launches()
    for conf, xs, label in [(fused_cfg, coords, "fused"),
                            (unfused_cfg, coords_small, "unfused")]:
        for order in (1, 2, 3):
            cg = compile_gradient(f, order, xs[:cfg.batch], config=conf,
                                  device="cuda")
            before = dict(common.LAUNCHES)
            cg.apply_batched(xs[:cg.config.block])          # warm-up block
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs = cg.apply_batched(xs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            want = oracle(xs, order)
            if len(outs) != len(want):
                raise AssertionError(f"{len(outs)} outputs, want {len(want)}")
            errs = []
            for o, w in zip(outs, want):
                if tuple(o.shape) != tuple(w.shape) or \
                        not bool(torch.isfinite(o).all()):
                    raise AssertionError(f"bad output {tuple(o.shape)}")
                errs.append(scaled_err(o, w)[1])
            # device busy share: the profiler's kernel time for one chunk,
            # scaled to N rows, over the wall time of the timed run
            rows = cg.config.chunk_blocks * cg.config.block
            xc = xs[:rows].reshape(cg.config.chunk_blocks, cg.config.block,
                                   -1)
            chunk_ms = device_ms(lambda: cg.apply_chunk(xc), 2)
            busy = (f"{chunk_ms * xs.shape[0] / rows / (wall * 1e3):.3f}"
                    if chunk_ms is not None else "not measured")
            launches = {k: v - before.get(k, 0)
                        for k, v in common.LAUNCHES.items()
                        if v - before.get(k, 0)}
            rp = cg.region_plan
            log(f"[main] {label} order {order}: N={xs.shape[0]} "
                f"nodes={len(cg.graph.nodes)} "
                f"segments={len(cg.plan.segments)} "
                f"regions={len(rp.regions) if rp else 0} "
                f"fused={len(rp.fused_regions()) if rp else 0} "
                f"wall={wall * 1e3:.1f} ms "
                f"us_per_row={wall * 1e6 / xs.shape[0]:.3f} "
                f"device_busy_share={busy} "
                f"max_scaled_err={max(errs):.3e} launches={launches}")
            if max(errs) > 1e-4:
                raise AssertionError(f"{label} order {order}: scaled err "
                                     f"{max(errs):.3e} > 1e-4")
            need = (["region"] + (["fused_chain"] if order == 3 else [])
                    if conf is fused_cfg else
                    ["fused_chain", "siren_layer", "stream_matmul"])
            if not all(launches.get(k) for k in need):
                raise AssertionError(f"{label} order {order} launched "
                                     f"{launches}, needs {need}")
    launches_main = dict(common.LAUNCHES)
    log(f"[launches] phase 4 (compile_gradient -> apply_batched): "
        f"{launches_main}")

    # -- 5. multi-INR serving ------------------------------------------------
    launches_multi = multi_inr_phase(
        log, torch, dev, cfg, f, params, coords, fused_cfg, oracle,
        scaled_err, device_ms, timing, record)

    # -- 6. launches ---------------------------------------------------------
    # ``launches`` counts the path a kernel was ported for (phase 4's for
    # PR 11's kernels, phase 5's for region_stacked); ``launches_by_path``
    # gives every path's own count.
    paths = {"compile_gradient": launches_main, "multi_inr": launches_multi}
    for name, rec in kernels.items():
        rec["launches_by_path"] = {p: c.get(name, 0) for p, c in paths.items()}
        rec["launches"] = rec["launches_by_path"][
            "multi_inr" if name == "region_stacked" else "compile_gradient"]
    log(f"[launches] by path: "
        f"{ {k: kernels[k]['launches_by_path'] for k in kernels} }")
    missing = [k for k in kernels if kernels[k]["launches"] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on their path: "
                             f"{missing}")
    log(json.dumps({"kernels": list(kernels.values())}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def multi_inr_phase(log, torch, dev, cfg, f, params, coords, fused_cfg,
                    oracle, scaled_err, device_ms, timing, record):
    """Phase 5; returns the launches made while it drove the multi-INR
    paths (the kernel checks before it are not counted)."""
    from repro_torch.core import trace
    from repro_torch.core.pipeline import compile_gradient
    from repro_torch.inr.siren import siren_fn, siren_init
    from repro_torch.kernels import common
    from repro_torch.kernels.region import (lower, region_call,
                                           region_call_stacked,
                                           region_call_stacked_plain)
    from repro_torch.serve import (ArtifactStore, MultiINRArtifact,
                                   ServingEngine, bind_weights)

    K, N, N_LANE3 = 8, 8192, 1024
    weights = [params] + [siren_init(cfg, torch.Generator().manual_seed(k),
                                     device=dev) for k in range(1, K)]
    fns = [f] + [siren_fn(cfg, w) for w in weights[1:]]
    gen = torch.Generator().manual_seed(K)
    lane_coords = (torch.rand(K, N, 2, generator=gen) * 2 - 1).to(dev)
    shared = coords[:N]
    ragged = N - 3

    def artifact(order):
        base = compile_gradient(f, order, coords[:cfg.batch],
                                config=fused_cfg, device="cuda")
        payloads = [bind_weights(base, params, w) for w in weights]
        return MultiINRArtifact(base, payloads)

    # -- 5a. the stacked kernel on the real regions' operands ---------------
    stacked_errs = []
    timed = None
    for order in (1, 2):
        m = artifact(order)
        (region, rows, res, out_info), = m.stacked_calls
        if tuple(region.stream_inputs) != (m.base.plan.inputs[0],):
            raise AssertionError(f"order {order}: region streams "
                                 f"{region.stream_inputs}")
        ops = ([lane_coords], rows, res, out_info)
        got = region_call_stacked(region.spec, *ops)
        want = region_call_stacked_plain(region.spec, *ops)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            stacked_errs.append(scaled_err(a, b))
        for k in range(K):
            lane = region_call(region.spec, [lane_coords[k]],
                               [r[k] for r in rows], [r[k] for r in res],
                               out_info)
            if not all(torch.equal(a[k], b) for a, b in zip(got, lane)):
                raise AssertionError(f"order {order}: stacked lane {k} != "
                                     f"region_call on its operands")
        t = device_ms(lambda: region_call_stacked(region.spec, *ops), 5)
        prog = lower(region.spec, tuple(a.shape[2] for a in ops[0]),
                     tuple(r.shape[2] for r in rows),
                     tuple(tuple(r.shape[1:]) for r in res))
        log(f"[multi] kernel order {order}: K={K} R={N} "
            f"{len(region.spec.steps)} steps, {prog.flops(1)} flops/row, "
            f"{sum(r[0].numel() * 4 for r in res)} resident bytes/lane, "
            f"{4 * (common.ABI['region_red_floats'] + prog.ws_floats)} "
            f"bytes of shared memory/CTA: {t} ms/launch on the device; "
            f"lanes bit-equal to {K} region_call launches; scaled err "
            f"{max(s for _, s in stacked_errs[-len(got):]):.3e}")
        if order == 2:
            timed = (region.spec, ops)
    worst = max(s for _, s in stacked_errs)
    if worst > 1e-4:
        raise AssertionError(f"region_stacked disagrees: scaled err "
                             f"{worst:.3e}")
    spec, ops = timed
    stream, rows, res, out_info = ops
    elems = sum(t.numel() for t in (*stream, *rows, *res)) \
        + sum(K * N * c for c, _ in out_info)
    flops = K * lower(spec, tuple(t.shape[2] for t in stream),
                      tuple(t.shape[2] for t in rows),
                      tuple(tuple(t.shape[1:]) for t in res)).flops(N)
    record("region_stacked", "src/repro_torch/kernels/csrc/region.cu",
           "src/repro/kernels/region.py:290", stacked_errs,
           timing(lambda: region_call_stacked(spec, *ops), 10, 10),
           timing(lambda: region_call_stacked_plain(spec, *ops), 10, 10),
           4 * elems, flops)

    # -- 5b. the multi-INR paths, counted ------------------------------------
    common.reset_launches()

    def serve_check(m, order, x, label):
        """Serve x ([N, 2] broadcast or [K, N, 2]) through m; every lane
        against its float64 oracle."""
        m.apply_batched(x[..., :m.base.config.block, :])     # warm-up
        torch.cuda.synchronize()
        before = dict(common.LAUNCHES)
        t0 = time.perf_counter()
        outs = m.apply_batched(x)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v - before.get(k, 0)
                    for k, v in common.LAUNCHES.items()
                    if v - before.get(k, 0)}
        n = x.shape[-2]
        errs = []
        for k in range(K):
            xk = x if x.dim() == 2 else x[k]
            want = oracle(xk, order, weights[k])
            if len(outs) != len(want):
                raise AssertionError(f"{len(outs)} outputs, want "
                                     f"{len(want)}")
            for o, w in zip(outs, want):
                if tuple(o[k].shape) != tuple(w.shape) or \
                        not bool(torch.isfinite(o[k]).all()):
                    raise AssertionError(f"bad output {tuple(o.shape)}")
                errs.append(scaled_err(o[k], w)[1])
        # device busy share: profiler kernel time over the wall, of the
        # whole call on the stacked path, of 8 blocks scaled to the call's
        # rows on the per-lane path (as in phase 4)
        if m.double_buffered:
            busy_ms = device_ms(lambda: m.apply_batched(x), 2)
        else:
            rows = 8 * m.base.config.block
            part = x[..., :rows, :]
            part_ms = device_ms(lambda: m.apply_batched(part), 2)
            busy_ms = part_ms * n / rows if part_ms is not None else None
        busy = (f"{busy_ms / (wall * 1e3):.3f}" if busy_ms is not None
                else "not measured")
        path = "stacked" if m.double_buffered else "per-lane"
        log(f"[multi] K={K} order {order} path={path} {label} "
            f"N={n} per lane: wall={wall * 1e3:.1f} ms "
            f"us_per_row={wall * 1e6 / (K * n):.4f} "
            f"device_busy_share={busy} max_scaled_err={max(errs):.3e} "
            f"launches={launches}")
        if max(errs) > 1e-4:
            raise AssertionError(f"multi order {order} {label}: scaled err "
                                 f"{max(errs):.3e} > 1e-4")
        need = (["region_stacked"] if m.double_buffered
                else ["region", "fused_chain"])
        if not all(launches.get(k) for k in need) or (
                m.double_buffered and set(launches) != {"region_stacked"}):
            raise AssertionError(f"multi order {order} {label} ({path}) "
                                 f"launched {launches}, needs {need}")
        return outs

    for order in (1, 2):
        m = artifact(order)
        if not m.double_buffered:
            raise AssertionError(f"order {order}: stacked path not taken")
        serve_check(m, order, shared, "broadcast")
        serve_check(m, order, lane_coords, "per-lane")
        serve_check(m, order, lane_coords[:, :ragged], "per-lane ragged")
    m3 = artifact(3)
    if m3.double_buffered:
        raise AssertionError("order 3: the plan has non-region units, the "
                             "stacked path must not be taken")
    serve_check(m3, 3, lane_coords[:, :N_LANE3], "per-lane")

    # the engine: one signature group of 3 INRs (one named twice), a
    # zero-row request, then a K = 1 group with a non-base weight id
    store_dir = ROOT / "build" / "chip_smoke_store"
    shutil.rmtree(store_dir, ignore_errors=True)
    engine = ServingEngine(store_dir)
    cgs = [compile_gradient(fns[k], 2, coords[:cfg.batch], config=fused_cfg,
                            device="cuda") for k in range(3)]
    for k in range(3):
        engine.register(f"inr{k}", cgs[k])
    q = lane_coords[0, :1000]
    reqs = [("inr1", q[:300]), ("inr0", q), ("inr2", q[:0]),
            ("inr1", q[300:777]), ("inr2", q[:333])]
    t0 = time.perf_counter()
    results = engine.serve(reqs) + engine.serve([("inr2", q[:101])])
    wall = time.perf_counter() - t0
    reqs.append(("inr2", q[:101]))
    for (inr_id, c), out in zip(reqs, results):
        want = cgs[int(inr_id[3:])].apply_batched(c)
        for a, b in zip(want, out):
            err = scaled_err(b, a)[1] if a.numel() else 0.0
            if tuple(a.shape) != tuple(b.shape) or err > 1e-5:
                raise AssertionError(f"engine {inr_id}: {tuple(b.shape)} "
                                     f"vs {tuple(a.shape)}, err {err:.3e}")
    st = engine.stats
    want_st = {"groups": 2, "multi_groups": 1, "requests": 6,
               "rows": 300 + 1000 + 0 + 477 + 333 + 101,
               "padded_rows": 3 * 1000 - (300 + 477 + 1000 + 333) + 3}
    got_st = {k: st[k] for k in want_st}
    if got_st != want_st:
        raise AssertionError(f"engine stats {got_st} != {want_st}")
    log(f"[multi] engine order 2: {len(reqs)} requests, 2 serve calls in "
        f"{wall * 1e3:.1f} ms; stats {got_st}; outputs match per-INR "
        f"apply_batched")
    # a fresh engine restores from the store by signature alone
    sig = cgs[0].signature
    traces = trace.TRACE_CALLS
    fresh = ServingEngine(ArtifactStore(store_dir))
    for k in range(3):
        fresh.register(f"inr{k}", signature=sig, weight_id=f"inr{k}")
    again = fresh.serve(reqs[:-1]) + fresh.serve(reqs[-1:])
    if trace.TRACE_CALLS != traces:
        raise AssertionError("the store restore called the tracer")
    for a, b in zip(results, again):
        if not all(torch.equal(u, v) for u, v in zip(a, b)):
            raise AssertionError("restored engine outputs differ")
    log(f"[multi] store: fresh engine restored {sig} with 0 tracer calls, "
        f"{fresh.stats['restores']} restore, outputs torch.equal")
    shutil.rmtree(store_dir, ignore_errors=True)
    launches = dict(common.LAUNCHES)
    log(f"[launches] phase 5 (multi-INR serving): {launches}")
    return launches


if __name__ == "__main__":
    sys.exit(main())
