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
  5. the launches of every kernel during phase 4 (each must be > 0), and
     one JSON line of per-kernel numbers;
  6. the last line: {"ok": true, "device": {...}}.

Times: ``ms`` is the device time of one launch (torch.profiler, kernels
only), ``call_ms`` the time per call of back-to-back calls on the stream
(CUDA events; includes the host's launch path).  ``bound_ms`` is the larger
of bytes / 3.35 TB/s and flops / 67 TFLOP/s (H100 SXM fp32 without tensor
cores), each input and output counted once.
"""

from __future__ import annotations

import dataclasses
import json
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
                                           region_call, region_call_plain)
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

    def call_ms(fn, iters=200):
        for _ in range(10):
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
        """Kernel time per call from torch.profiler; None if it saw none."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
        except RuntimeError as exc:      # no CUPTI: fall back to events
            log(f"[timing] torch.profiler unavailable: {exc}")
            return None
        total = 0.0
        for ev in prof.key_averages():
            if ev.device_type == DeviceType.CUDA:
                total += getattr(ev, "self_device_time_total", None) or \
                    getattr(ev, "self_cuda_time_total", 0.0)
        return total / iters / 1e3 if total > 0 else None

    def timing(fn):
        dms, cms = device_ms(fn), call_ms(fn)
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
    p64 = [{k: v.double() for k, v in p.items()} for p in params]

    def oracle(x, order, chunk=4096):
        """float64 nth-order input gradients by nested torch.autograd."""
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

    # -- 5. launches ---------------------------------------------------------
    for name in kernels:
        kernels[name]["launches"] = common.LAUNCHES[name]
    log(f"[launches] main path: "
        f"{ {k: kernels[k]['launches'] for k in kernels} }")
    missing = [k for k in kernels if kernels[k]["launches"] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    log(json.dumps({"kernels": list(kernels.values())}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
