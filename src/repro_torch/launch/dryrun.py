"""Multi-pod dry run on fake tensors (port of ``repro.launch.dryrun``).

For every (architecture x input shape x mesh) cell, one step of the port
(``launch/steps.py``: the train step, prefill or decode) runs under
``FakeTensorMode`` in this one process, as rank 0 of a fake process group
of 256 ranks (single pod, 16 x 16) or 512 (multi pod, 2 x 16 x 16):
shapes, dtypes and collectives go through, nothing is computed, nothing
is allocated and no kernel is launched (the attention and ``ssd_scan``
kernels are custom ops with fake kernels and flop formulas).  Each cell
records:

  * memory    -> bytes per rank from ``MemTracker``: the inputs
                 (``argument_size_in_bytes``), the outputs, the peak and the
                 temporaries at the peak; whether the peak fits one H100
  * hlo_cost  -> FLOPs, bytes and collective bytes per rank, counted from
                 the dispatcher (``distributed/hlo_cost.py``)
  * roofline  -> the three terms on the H100 constants of ``launch/mesh.py``
  * kernel_calls, kernel_shapes -> the custom ops' calls and the distinct
                 shapes of their first operand (the heads a rank's
                 attention or ``ssd_scan`` kernel would run)
  * param_collectives -> the collectives whose operand is a parameter
                 block or a copy of one, and their operand bytes (none in
                 a sharded decode step, which is weight-stationary)

Two private torch modules carry it: the fake process group
(``torch.testing._internal.distributed.fake_pg``) and the memory tracker
(``torch.distributed._tools.mem_tracker``); torch has no public
counterpart of either.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k
  python -m repro_torch.launch.dryrun --all --mesh both --device cpu
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import math
import os
import sys
import time
import traceback

import torch

from repro_torch.configs.base import ARCH_IDS, SHAPES, get_config
from repro_torch.distributed import hlo_cost
from repro_torch.distributed.sharding import ShardingPolicy
from repro_torch.kernels import common
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import steps as steplib
from repro_torch.models import zoo
from repro_torch.obs.log import get_logger

_log = get_logger("dryrun")


@contextlib.contextmanager
def fake_process_group(world_size: int):
    """The default process group as rank 0 of ``world_size`` fake ranks in
    this process: collectives return at once and move nothing.  Taken
    down on exit."""
    import torch.distributed as dist
    # private module: torch has no public fake process group
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _tensors(tree) -> list:
    from torch.utils._pytree import tree_leaves
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _batch(cfg, shape, policy, device):
    """The cell's inputs: train and prefill leaves as DTensors at
    ``batch_specs`` (a rank holds its rows; whole without a policy);
    decode's tokens whole (the serve step splits them) and its position a
    Python int."""
    structs = zoo.input_structs(cfg, shape)
    full = {k: torch.empty(v.shape, dtype=v.dtype, device=device)
            for k, v in structs.items() if k != "pos"}
    if shape.kind == "decode":
        return full["tokens"], shape.seq_len - 1
    if policy is None:
        return full
    return steplib.place(full, {k: v for k, v in steplib.batch_specs(
        cfg, shape, policy).items() if k in full}, policy.mesh)


def _local(t):
    """A DTensor's local tensor (the one its ops run on), a tensor as it
    is."""
    from torch.distributed.tensor import DTensor
    return t._local_tensor if isinstance(t, DTensor) else t


def _storages(tensors) -> dict:
    """Distinct untyped storages of ``tensors`` (a DTensor's local one) by
    identity -> bytes."""
    from torch.distributed.tensor import DTensor
    out = {}
    for t in tensors:
        if isinstance(t, DTensor):
            t = t.to_local()
        st = t.untyped_storage()
        out[id(st)] = st.nbytes()
    return out


def lower_cell(arch: str, shape_name: str, mesh, hp: steplib.HParams, *,
               device=None, cfg=None, shape=None) -> dict:
    """Trace one cell's step on fake tensors over ``mesh`` (a mesh of the
    fake process group that is up; None traces the unsharded step);
    returns its record.  ``device``: the device the fake tensors stand on
    (CUDA unless ``"cpu"``); ``cfg`` / ``shape`` replace ``arch``'s
    configuration and ``SHAPES[shape_name]`` (a cut-down cell)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    # private module: torch has no public memory tracker of this kind
    from torch.distributed._tools.mem_tracker import MemTracker
    cfg = cfg if cfg is not None else get_config(arch)
    shape = shape if shape is not None else SHAPES[shape_name]
    if not cfg.supports_shape(shape):
        return {"arch": arch, "shape": shape_name, "skipped":
                "long_500k needs sub-quadratic attention"}
    device = common.resolve_device(device)
    policy = None if mesh is None else ShardingPolicy(
        mesh, seq_parallel=hp.seq_parallel, extra_rules=hp.extra_rules)
    launches = collections.Counter(common.LAUNCHES)
    allocated = torch.cuda.memory_allocated() \
        if torch.cuda.is_available() else 0
    t0 = time.time()
    with FakeTensorMode(allow_non_fake_inputs=True):
        if shape.kind == "train":
            step = steplib.build_train_step(cfg, hp, policy)
            state = steplib.abstract_state(cfg, device)
            if policy is not None:
                state = steplib.place_state(state, cfg, policy)
            args = (state, _batch(cfg, shape, policy, device))
        else:
            params = steplib.serving_params_struct(cfg, hp, device)
            if policy is not None:
                params = steplib.place(
                    params, steplib.param_specs(cfg, policy), mesh)
            if shape.kind == "prefill":
                step = steplib.build_prefill_step(cfg, hp, policy)
                args = (params, _batch(cfg, shape, policy, device))
            else:
                step = steplib.build_serve_step(cfg, hp, policy)
                cache = zoo.init_cache(cfg, shape.global_batch,
                                       shape.seq_len, device=device)
                if policy is not None:
                    cache = steplib.place(cache, steplib.cache_specs(
                        cfg, policy, cache), mesh)
                tokens, pos = _batch(cfg, shape, policy, device)
                args = (params, cache, tokens, pos)
        inputs = _tensors(list(args))
        tracker = MemTracker()
        tracker.track_external(*inputs)
        before = _total(tracker, "current")
        blocks = args[0]["params"] if shape.kind == "train" else args[0]
        counter = hlo_cost.CostMode(watch=[_local(t)
                                           for t in _tensors(blocks)])
        with tracker:
            with counter:
                out = step(*args)
            after = _total(tracker, "current")
            peak = _total(tracker, "peak")
        arg_st = _storages(inputs)
        out_st = _storages(_tensors(list(out)))
        aliased = sum(b for k, b in out_st.items() if k in arg_st)
        del out, args, inputs
    t_lower = time.time() - t0
    cost = counter.cost()
    if collections.Counter(common.LAUNCHES) != launches or (
            torch.cuda.is_available()
            and torch.cuda.memory_allocated() != allocated):
        raise RuntimeError(f"dry run of {arch} x {shape_name} launched "
                           f"{collections.Counter(common.LAUNCHES) - launches}"
                           f" or allocated on the card")
    n_dev = 1 if mesh is None else math.prod(mesh.shape.values())
    # the inputs; what the step left allocated (its new outputs) plus the
    # outputs that are inputs updated in place; the peak over the inputs
    # and outputs held after it
    memory = {"argument_size_in_bytes": before,
              "output_size_in_bytes": after - before + aliased,
              "temp_size_in_bytes": peak - after,
              "peak_memory_in_bytes": peak}
    return {
        "arch": arch,
        "shape": shape_name,
        "kind": shape.kind,
        "mesh": {} if mesh is None else dict(mesh.shape),
        "n_devices": n_dev,
        "device": device.type,
        "params": cfg.count_params(),
        "active_params": cfg.count_active_params(),
        "tokens": shape.global_batch * (shape.seq_len
                                        if shape.kind != "decode" else 1),
        "hp": {"remat": hp.remat, "seq_parallel": hp.seq_parallel,
               "vocab_chunk": hp.vocab_chunk, "attn_impl": hp.attn_impl,
               "accum": hp.accum, "cast_once": hp.cast_once},
        "memory": memory,
        "fits_hbm": peak <= meshlib.HBM_BYTES,
        "hlo_cost": cost.as_dict(),
        "dot_flops": cost.dot_flops,
        "kernel_calls": dict(cost.kernel_calls),
        "kernel_shapes": {k: sorted(list(s) for s in v)
                          for k, v in cost.kernel_shapes.items()},
        "param_collectives": dict(cost.param_collectives),
        "lower_s": round(t_lower, 2),
    }


def _total(tracker, kind: str) -> int:
    """The tracker's total bytes over every device but ``meta``, whose
    tensors (a cache's shapes) hold no memory (``kind``: "current" or
    "peak")."""
    return sum(snap["Total"] for dev, snap in
               tracker.get_tracker_snapshot(kind).items()
               if torch.device(dev).type != "meta")


def roofline_terms(rec: dict) -> dict:
    """Three roofline terms (seconds) from a dry-run record.

    ``hlo_cost`` is per rank, so the terms are per-card seconds directly:
    FLOPs over the H100's dense bf16 peak, streamed bytes over its HBM
    rate, and collective bytes (operand bytes per rank, summed over every
    collective) over ONE NVLink 4 direction (``NVLINK_BW``, 450 GB/s): a
    conservative serialized bound.  It assumes every collective stays
    inside an NVLink domain; the data axes of a 256- or 512-card mesh
    cross the network between nodes, which is slower, so the collective
    term is a lower bound there.
    """
    cost = rec.get("hlo_cost", {})
    flops = cost.get("flops", 0.0)
    byts = cost.get("bytes_streamed", 0.0)
    coll = cost.get("collective_bytes", 0.0)
    t_compute = flops / meshlib.PEAK_FLOPS_BF16
    t_memory = byts / meshlib.HBM_BW
    t_coll = coll / meshlib.NVLINK_BW
    terms = {"t_compute": t_compute, "t_memory": t_memory,
             "t_collective": t_coll}
    dom = max(terms, key=terms.get)
    n = rec.get("active_params", rec.get("params", 0))
    d = rec.get("tokens", 0)
    model_flops = (6 if rec.get("kind") == "train" else 2) * n * d
    model_flops_per_dev = model_flops / max(rec.get("n_devices", 1), 1)
    terms.update({
        "dominant": dom,
        "model_flops_per_dev": model_flops_per_dev,
        "useful_ratio": model_flops_per_dev / flops if flops else 0.0,
        "roofline_bound_s": max(terms["t_compute"], terms["t_memory"],
                                terms["t_collective"]),
        "ideal_compute_s": model_flops_per_dev / meshlib.PEAK_FLOPS_BF16,
    })
    return terms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/torch_dryrun.json")
    ap.add_argument("--remat", default="dots")
    ap.add_argument("--seq-parallel", action="store_true")
    ap.add_argument("--vocab-chunk", type=int, default=0)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--attn-impl", default="pallas",
                    choices=["flash", "flash_cvjp", "pallas"])
    ap.add_argument("--cast-once", action="store_true")
    ap.add_argument("--constrain-proj", action="store_true")
    ap.add_argument("--grad-cast", action="store_true")
    ap.add_argument("--no-attn-tp", action="store_true",
                    help="replicate attention params over the model axis "
                         "(for head counts that do not divide it)")
    ap.add_argument("--no-donate", action="store_true",
                    help="accepted for the reference's command lines; the "
                         "port's steps always update in place")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="the device the fake tensors stand on (default "
                         "cuda; without CUDA, pass cpu)")
    args = ap.parse_args(argv)

    extra = ({"q_dim": (), "kv_dim": (), "o_in": ()}
             if args.no_attn_tp else None)
    hp = steplib.HParams(remat=args.remat, seq_parallel=args.seq_parallel,
                         vocab_chunk=args.vocab_chunk, accum=args.accum,
                         attn_impl=args.attn_impl,
                         cast_once=args.cast_once,
                         constrain_proj=args.constrain_proj,
                         grad_cast=args.grad_cast,
                         extra_rules=extra)
    device = common.resolve_device(args.device)

    cells = []
    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    for mp in meshes:
        for a in archs:
            for s in shapes:
                cells.append((a, s, mp))

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r.get("arch"), r.get("shape"), r.get("multi_pod"), r.get("tag"))
            for r in results}

    for mp in meshes:
        todo = [c for c in cells if c[2] == mp
                and (c[0], c[1], mp, args.tag) not in done]
        for cell in cells:
            if cell[2] == mp and cell not in todo:
                _log.info("skip-done", cell=(*cell, args.tag))
        if not todo:
            continue
        with fake_process_group(2 * meshlib.CHIPS_PER_POD if mp
                                else meshlib.CHIPS_PER_POD):
            mesh = meshlib.make_production_mesh(multi_pod=mp,
                                                device_type=device.type)
            for arch, shape_name, _ in todo:
                label = (f"{arch} x {shape_name} x "
                         f"{'multi' if mp else 'single'}-pod")
                _log.info(f"{label} ...")
                try:
                    rec = lower_cell(arch, shape_name, mesh, hp,
                                     device=device)
                    rec["multi_pod"] = mp
                    rec["tag"] = args.tag
                    if "skipped" in rec:
                        _log.info("skipped", reason=rec["skipped"])
                    else:
                        rec["roofline"] = roofline_terms(rec)
                        mem, cost = rec["memory"], rec["hlo_cost"]
                        _log.info(
                            "ok", lower_s=rec["lower_s"],
                            flops_dev=f"{cost['flops']:.3e}",
                            coll_B=f"{cost['collective_bytes']:.3e}",
                            arg_GB=mem["argument_size_in_bytes"] / 1e9,
                            peak_GB=mem["peak_memory_in_bytes"] / 1e9,
                            fits_hbm=rec["fits_hbm"],
                            dom=rec["roofline"]["dominant"])
                except Exception as e:
                    rec = {"arch": arch, "shape": shape_name,
                           "multi_pod": mp, "tag": args.tag,
                           "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-2000:]}
                    _log.error("FAIL", error=rec["error"])
                results.append(rec)
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)
    n_err = sum(1 for r in results if "error" in r)
    _log.info(f"wrote {args.out}", records=len(results), errors=n_err)
    return 1 if n_err else 0


if __name__ == "__main__":
    sys.exit(main())
