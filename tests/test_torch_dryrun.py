"""The port's dry run (``repro_torch.launch.dryrun``): one step of a cell
on fake tensors over a fake process group, its collective bytes against
the port's design counted by hand, its argument bytes against the
rank-local state, the CLI on the reference's test cell, the roofline
terms, and imports free of jax and the reference."""

import collections
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

from repro.configs import get_config as jget_config
from repro_torch.checkpoint.ckpt import tree_items
from repro_torch.configs import SHAPES, get_config
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import common
from repro_torch.launch import dryrun, mesh as meshlib, steps

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
MESH = (4, 4)
# the reference's arguments per device of deepseek-moe-16b x decode_32k x
# single pod, remat full: ``argument_size_in_bytes`` of the record its
# system test writes (``tests/test_system.py``: results/dryrun_testcell.json)
REFERENCE_ARG_BYTES = 3_890_630_692
# the same record's collectives per device: all-gather operand bytes, and
# the operand bytes of every collective (all-gather 14,233,192, all-reduce
# 38,313,984, all-to-all 3,735,552, collective-permute 917,536)
REFERENCE_ALL_GATHER_BYTES = 14_233_192
REFERENCE_COLLECTIVE_BYTES = 57_200_264


def _local_bytes(t, spec, mesh) -> int:
    """Bytes of a rank's block of ``t`` at ``spec``."""
    block = shd.local_shard(torch.empty(t.shape, device="meta"), spec, mesh)
    return block.numel() * t.dtype.itemsize


def _gather_bytes(shape, dtype, spec, mesh) -> int:
    """Operand bytes of gathering a leaf whole: one all-gather per mesh
    axis it is sharded over, each on what the ones before it gathered."""
    return _moved(shape, dtype, spec, mesh,
                  shd.sharded_axes(spec, mesh), ())[0]


def _moved(shape, dtype, spec, mesh, gathered, summed) -> tuple:
    """(all-gather, reduce-scatter, all-reduce) operand bytes of a leaf at
    ``spec`` gathered over the axes ``gathered`` and whose gradient is
    summed over ``summed``, by the design: the forward all-gathers the
    rank's block over each gathered axis in turn; the backward slices the
    whole gradient over the gathered axes not summed, reduce-scatters it
    over the gathered axes summed, then all-reduces the block over the
    summed axes the spec does not shard."""
    size = torch.Size(shape).numel() * dtype.itemsize
    for a in shd.sharded_axes(spec, mesh):
        size //= mesh.shape[a]
    ag = rs = ar = 0
    for a in gathered:
        ag += size
        size *= mesh.shape[a]
    for a in gathered:
        if a not in summed:
            size //= mesh.shape[a]
    for a in gathered:
        if a in summed:
            rs += size
            size //= mesh.shape[a]
    for a in summed:
        if a not in shd.sharded_axes(spec, mesh):
            ar += size
    return ag, rs, ar


def _param_leaves(cfg, policy, dtype=None):
    """(path, shape, dtype, spec) of every parameter leaf."""
    from repro_torch.models import zoo
    specs = steps._spec_leaves(steps.param_specs(cfg, policy))
    out = []
    for (path, ps), spec in zip(tree_items(zoo.model_template(cfg)), specs):
        dt = getattr(torch, ps.dtype)
        if dtype is not None and dt == torch.float32:
            dt = dtype
        out.append((path, ps.shape, dt, spec))
    return out


def _cell(arch, shape_name, **hp):
    """A reduced config's cell on a fake (4, 4) mesh."""
    before = collections.Counter(common.LAUNCHES)
    with dryrun.fake_process_group(16):
        mesh = shd.make_mesh(MESH, ("data", "model"))
        rec = dryrun.lower_cell(arch, shape_name, mesh,
                                steps.HParams(**hp), device="cpu",
                                cfg=get_config(arch).reduced())
    assert collections.Counter(common.LAUNCHES) == before
    return rec, get_config(arch).reduced(), shd.ShardingPolicy(mesh), mesh


def _rank_rows(arch, shape_name, **hp) -> dict:
    """The memory record of the unsharded step on one rank's rows of the
    batch: its peak over its arguments is the activations (and whole
    gradients) the sharded step's bound allows."""
    cfg = get_config(arch).reduced()
    shape = SHAPES[shape_name]
    rows = dataclasses.replace(shape,
                               global_batch=shape.global_batch // MESH[0])
    return dryrun.lower_cell(arch, shape_name, None, steps.HParams(**hp),
                             device="cpu", cfg=cfg, shape=rows)["memory"]


def _layer_bytes(cfg, dtype=None) -> int:
    """Bytes of one layer's parameters whole (the largest layer)."""
    from repro_torch.models import zoo
    per = collections.Counter()
    for path, ps in tree_items(zoo.model_template(cfg)):
        dt = getattr(torch, ps.dtype)
        if dtype is not None and dt == torch.float32:
            dt = dtype
        n = torch.Size(ps.shape).numel() * dt.itemsize
        if ps.logical[:1] == ("stack",):
            per[path[0]] += n // ps.shape[0]
    return max(per.values())


def _batch_local(cfg, shape, policy, mesh) -> int:
    from repro_torch.models import zoo
    specs = steps.batch_specs(cfg, shape, policy)
    return sum(_local_bytes(v, specs[k], mesh)
               for k, v in zoo.input_structs(cfg, shape).items()
               if k != "pos")


# the tensor-parallel split on the (4, 4) mesh: the leaves whose "model"
# block is the rank's split block are gathered over "data" alone; qwen3
# (one q head a rank, its one kv head replicated) sums the gradients of k
# and v (a kv head spans four "model" blocks) and of the q / k norms a
# split block uses whole over "model" too; deepseek-moe's four kv heads
# split, one a rank; mamba2's 8 heads split, 2 a rank: its projections of
# the rank's heads are its own, the leaves it uses whole (B, C, the conv)
# or narrows to its heads (the per-head scalars, the norm) sum their
# gradients over "model"
_MAMBA = ("wb", "wc", "conv", "a_log", "d", "dt_bias", "norm")
_SPLIT = {"qwen3-8b": {("attn", "q"), ("attn", "o"), ("mlp", "wi"),
                       ("mlp", "wg"), ("mlp", "wo")},
          "deepseek-moe-16b": {("attn", "q"), ("attn", "k"), ("attn", "v"),
                               ("attn", "o")},
          "mamba2-2.7b": {("mamba", k) for k in ("wz", "wx", "wdt", "wo")}}
_SUM_MODEL = {"qwen3-8b": {("attn", "k"), ("attn", "v"), ("attn", "qn"),
                           ("attn", "kn")},
              "deepseek-moe-16b": set(),
              "mamba2-2.7b": {("mamba", k) for k in _MAMBA}}


def _model_block(path) -> bool:
    """A leaf every sharded step keeps the rank's block of over "model"
    where its spec shards it (the reduced vocab of 128, 4 experts and 48
    shared-expert units divide 4): the embedding, the head, the experts
    and the shared experts."""
    return path in (("embed",), ("lm_head",)) or (
        "moe" in path and path[-1] in ("wi", "wg", "wo"))


@pytest.mark.parametrize("arch,remat,tp_reduces", [
    ("mamba2-2.7b", "dots", 0), ("qwen3-8b", "none", 4),
    ("qwen3-8b", "dots", 5), ("deepseek-moe-16b", "dots", 4)])
def test_train_cell(arch, remat, tp_reduces):
    """The train step's collectives, counted by hand for the step that
    holds shards (``_moved``): each layer's blocks all-gathered in the
    layer's function (again in the recompute under remat "dots"), the
    embedding and head where they are used, over "data" alone (their
    vocab splits over "model"), as are the experts; in the backward each
    gradient reduce-scattered into its block over "data" (sliced over
    "model" where its ranks computed the same), a replicated leaf's
    all-reduced; the loss and the norm's group sums all-reduced.  No whole
    gradient is all-reduced.  Over "model", the vocab-parallel embedding's
    output and the head's input gradient (bf16 activations), the
    log-sum-exp's max and sum and the label's logit (float32, a token
    each).  With the tensor-parallel split (qwen3, deepseek-moe) also,
    per layer, each split block's output all-reduced over "model" in the
    forward and its input's gradient in the backward (qwen3: attention
    and MLP, 4; deepseek-moe: the attention's 2 and the MoE input's
    gradient); under remat "dots" the recompute adds the attention
    block's (the non-reentrant checkpoint stops once it has what the
    backward saved, before the MLP's or the MoE's output).  A MoE layer
    also all-reduces its float32 partial output in the forward, its
    gates' gradient [T, K] in the backward, and its expert counts and
    gate sums (2 E floats) over "data" in the forward, the recompute and
    the backward.  A mamba layer split by heads (mamba2) all-reduces
    over "model" its output in the forward, its input's gradient in the
    backward, and its gated norm's float32 sum of squares (a float a
    token) in the forward, the recompute and the backward.  Arguments:
    the rank-local params and moments, the
    step, the rank's rows of the batch.  Peak: at most the arguments,
    plus one layer gathered whole, plus the activations: the peak over
    its arguments of the unsharded step on one rank's rows
    (``_rank_rows``)."""
    rec, cfg, policy, mesh = _cell(arch, "train_4k", remat=remat)
    shape = SHAPES["train_4k"]
    leaves = _param_leaves(cfg, policy)
    ag = rs = ar = 0
    for path, s, dt, sp in leaves:
        live = shd.sharded_axes(sp, mesh)
        if _model_block(path) or path[-2:] in _SPLIT[arch]:
            gathered, summed = [a for a in live if a != "model"], ("data",)
        elif path[-2:] in _SUM_MODEL[arch]:
            gathered, summed = live, ("data", "model")
        else:
            gathered, summed = live, ("data",)
        g, r, a = _moved(s, dt, sp, mesh, gathered, summed)
        again = remat != "none" and path[0] == "layers"
        ag, rs, ar = ag + (2 if again else 1) * g, rs + r, ar + a
    groups = {tuple(shd.sharded_axes(sp, mesh)) for *_, sp in leaves}
    ar += 4 + 4 * len(groups) * len(mesh.shape)
    tokens = shape.global_batch // MESH[0] * shape.seq_len
    act = tokens * cfg.d_model * torch.bfloat16.itemsize
    ar += (2 + tp_reduces * cfg.n_layers) * act + 3 * tokens * 4
    if cfg.ssm_state:
        norm = (3 if remat == "dots" else 2) * tokens * 4
        ar += cfg.n_layers * (2 * act + norm)
    if cfg.n_experts:
        aux = (3 if remat == "dots" else 2) * 2 * cfg.n_experts * 4
        ar += cfg.n_layers * (2 * act + tokens * cfg.top_k * 4 + aux)
    c = rec["hlo_cost"]["collectives"]
    assert c["all-gather"]["bytes"] == ag
    assert c["reduce-scatter"]["bytes"] == rs
    assert c["all-reduce"]["bytes"] == ar
    assert rec["hlo_cost"]["collective_bytes"] == ag + rs + ar
    state = 3 * sum(_local_bytes(torch.empty(s, device="meta"), sp, mesh)
                    for _, s, _, sp in leaves)
    assert rec["memory"]["argument_size_in_bytes"] == \
        state + 4 + _batch_local(cfg, shape, policy, mesh)
    kernel = "ssd_scan" if cfg.family == "ssm" else "flash_attention_fwd"
    # remat "dots" runs each layer's kernel forward twice
    assert rec["kernel_calls"][kernel] == \
        (2 if remat == "dots" else 1) * cfg.n_layers
    assert rec["n_devices"] == 16 and rec["mesh"] == {"data": 4, "model": 4}
    # the step returns the state it updated in place (a new step tensor)
    mem = rec["memory"]
    assert mem["peak_memory_in_bytes"] == (
        mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
        + mem["output_size_in_bytes"] - state)
    one = _rank_rows(arch, "train_4k", remat=remat)
    assert mem["peak_memory_in_bytes"] <= mem["argument_size_in_bytes"] + \
        _layer_bytes(cfg) + one["peak_memory_in_bytes"] \
        - one["argument_size_in_bytes"]


def test_seq_parallel_train_cell():
    """The train step under ``seq_parallel`` (reduced qwen3, remat
    "none"): each rank holds its rows and a quarter of the sequence
    between the blocks.  Its parameters move as without the flag, but
    the norms, which a rank now applies to its own tokens, have their
    gradients summed over "model" too.  Over "model", for each layer's
    two split blocks, the input's sequence is all-gathered (a quarter of
    the tokens an operand) and the partial output reduce-scattered in the
    forward, and the reverse in the backward; the embedding all-gathers
    the int32 tokens and reduce-scatters its partial rows (its gradient
    all-gathered), the head all-gathers its input (its gradient
    reduce-scattered) and the cross entropy the int32 labels, then
    all-reduces its log-sum-exp's max and sum and the label's logit (a
    float a token) as without the flag.  The attention kernel runs on the
    whole sequence; the FLOPs are within 2% of the cell without the flag
    and the peak at or below its."""
    rec, cfg, policy, mesh = _cell("qwen3-8b", "train_4k", remat="none",
                                   seq_parallel=True)
    base, *_ = _cell("qwen3-8b", "train_4k", remat="none")
    shape = SHAPES["train_4k"]
    leaves = _param_leaves(cfg, policy)
    norms = {("ln1",), ("ln2",), ("final_norm",)}
    ag = rs = ar = 0
    for path, s, dt, sp in leaves:
        live = shd.sharded_axes(sp, mesh)
        if _model_block(path) or path[-2:] in _SPLIT["qwen3-8b"]:
            gathered, summed = [a for a in live if a != "model"], ("data",)
        elif path[-2:] in _SUM_MODEL["qwen3-8b"] or path[-1:] in norms:
            gathered, summed = live, ("data", "model")
        else:
            gathered, summed = live, ("data",)
        g, r, a = _moved(s, dt, sp, mesh, gathered, summed)
        ag, rs, ar = ag + g, rs + r, ar + a
    groups = {tuple(shd.sharded_axes(sp, mesh)) for *_, sp in leaves}
    ar += 4 + 4 * len(groups) * len(mesh.shape)
    tokens = shape.global_batch // MESH[0] * shape.seq_len
    act = tokens * cfg.d_model * torch.bfloat16.itemsize
    block = act // MESH[1]
    ag += (cfg.n_layers * 2 * 2 + 2) * block + 2 * tokens // MESH[1] * 4
    rs += cfg.n_layers * 2 * 2 * act + 2 * act
    ar += 3 * tokens * 4
    c = rec["hlo_cost"]["collectives"]
    assert c["all-gather"]["bytes"] == ag
    assert c["reduce-scatter"]["bytes"] == rs
    assert c["all-reduce"]["bytes"] == ar
    q = rec["kernel_shapes"]["flash_attention_fwd"]
    assert {tuple(s[:2]) for s in q} == {(shape.global_batch // MESH[0],
                                          shape.seq_len)}, q
    flops, was = rec["hlo_cost"]["flops"], base["hlo_cost"]["flops"]
    assert abs(flops / was - 1) <= 0.02, (flops, was)
    assert rec["memory"]["peak_memory_in_bytes"] <= \
        base["memory"]["peak_memory_in_bytes"]


def test_prefill_and_decode_cells():
    """Serving holds the cache at ``cache_specs`` (reduced qwen3: one kv
    head, so its sequence splits over "model").  Prefill gathers each
    layer's blocks whole (bf16) where it runs, the embedding, the head and
    the MLPs over "data" alone (the vocab and ``d_ff`` split over
    "model"), the last logits' columns over "model" and their rows over
    "data", and no cache leaf; it all-reduces the vocab-parallel
    embedding's output and each layer's partial MLP output over "model".
    Its parameter gathers are the dry run's ``param_collectives``.

    Decode is weight-stationary: no collective carries a parameter block.
    The residual stream is every row of the rank's quarter of
    ``d_model``.  Over "data": each norm's float32 sum of squares, q, k
    and v's float32 partial sums reduce-scattered to the rank's rows in
    one op a layer, the MLP's ``wi`` / ``wg`` partial sums all-reduced in
    one, the head's partial logits (float32) all-reduced, and the
    attention output's rank rows of ``o``'s columns all-gathered (bf16).
    Over "model": the embedding's lookups (bf16), each layer's q / k / v
    columns of the rank's rows all-gathered in one op (the attention runs
    whole: one kv head), the lse merge's max and weighted sums (float32),
    ``o``'s and the MLP's partial outputs (bf16), and each row's largest
    logit and its index (the merged argmax); no cache block moves.
    Arguments: parameter blocks plus, for decode, cache blocks (and the
    whole tokens).  Peak: at most the
    arguments, plus one layer gathered whole, plus the activations of the
    unsharded step on one rank's rows."""
    rec, cfg, policy, mesh = _cell("qwen3-8b", "prefill_32k")
    leaves = _param_leaves(cfg, policy, torch.bfloat16)
    mlp = {("mlp", k) for k in ("wi", "wg", "wo")}
    gathers = sum(_moved(s, dt, sp, mesh, [a for a in shd.sharded_axes(
        sp, mesh) if a != "model" or not (
            _model_block(path) or path[-2:] in mlp)], ())[0]
        for path, s, dt, sp in leaves)
    shape = SHAPES["prefill_32k"]
    rows = shape.global_batch // MESH[0]
    logits = rows * cfg.vocab_size * 4
    c = rec["hlo_cost"]["collectives"]
    assert c["all-gather"]["bytes"] == gathers + logits // MESH[1] + logits
    assert c["all-reduce"]["bytes"] == \
        (1 + cfg.n_layers) * rows * shape.seq_len * cfg.d_model * 2
    assert c["reduce-scatter"]["count"] == 0
    assert rec["param_collectives"]["bytes"] == gathers > 0
    params = sum(_local_bytes(torch.empty(s, dtype=dt, device="meta"), sp,
                              mesh) for _, s, dt, sp in leaves)
    mem = rec["memory"]
    assert mem["argument_size_in_bytes"] == \
        params + _batch_local(cfg, shape, policy, mesh)
    kv = cfg.n_layers * rows * shape.seq_len * cfg.n_kv_heads \
        * cfg.head_dim * 2
    # the rank's blocks of the new cache (rows over "data", the sequence
    # over "model") and the whole logits
    assert mem["output_size_in_bytes"] == \
        2 * kv // MESH[1] + shape.global_batch * cfg.vocab_size * 4
    one = _rank_rows("qwen3-8b", "prefill_32k")
    layer = _layer_bytes(cfg, torch.bfloat16)
    assert mem["peak_memory_in_bytes"] <= mem["argument_size_in_bytes"] + \
        layer + one["peak_memory_in_bytes"] - one["argument_size_in_bytes"]
    assert rec["kernel_calls"] == {"flash_attention_fwd": cfg.n_layers}

    rec, *_ = _cell("qwen3-8b", "decode_32k")
    shape = SHAPES["decode_32k"]
    B, L, (dp, m) = shape.global_batch, cfg.n_layers, MESH
    rows = B // dp
    kv = L * rows * shape.seq_len * cfg.n_kv_heads * cfg.head_dim * 2
    # the rank's blocks: of d_model over "data", of the q, kv, hidden
    # unit and vocab columns over "model"
    d, q, k, f, v = (n // w for n, w in (
        (cfg.d_model, dp), (cfg.q_dim, m), (cfg.kv_dim, m), (cfg.d_ff, m),
        (cfg.vocab_size, m)))
    f32, bf16 = 4, 2
    c = rec["hlo_cost"]["collectives"]
    assert rec["param_collectives"] == {"count": 0, "bytes": 0}
    assert c["reduce-scatter"] == {"count": L,
                                   "bytes": L * B * (q + 2 * k) * f32}
    assert c["all-gather"] == {
        "count": 2 * L + 1,
        "bytes": L * rows * (q + 2 * k + q) * bf16 + 2 * B * f32}
    heads = rows * cfg.n_heads
    # float32: two norms, the MLP's hidden units, the lse merge's max and
    # sums; bf16: o's and the MLP's outputs (elements)
    per_layer = [B, B, B * 2 * f, heads, heads * cfg.head_dim + heads]
    assert c["all-reduce"] == {
        "count": L * (len(per_layer) + 2) + 3,
        "bytes": L * (f32 * sum(per_layer) + 2 * B * d * bf16)
        + B * d * bf16 + B * f32 + B * v * f32}
    mem = rec["memory"]
    assert mem["argument_size_in_bytes"] == \
        params + 2 * kv // MESH[1] + 4 * shape.global_batch
    one = _rank_rows("qwen3-8b", "decode_32k")
    assert mem["peak_memory_in_bytes"] <= mem["argument_size_in_bytes"] + \
        layer + one["peak_memory_in_bytes"] - one["argument_size_in_bytes"]
    assert rec["kernel_calls"] == {} and rec["tokens"] == shape.global_batch


def test_unsharded_cell():
    """Without a mesh the unsharded step is traced: no collectives, the
    whole state as arguments, one kernel call per layer and direction
    (remat "none")."""
    cfg = get_config("qwen3-8b").reduced()
    shape = SHAPES["train_4k"]
    rec = dryrun.lower_cell("qwen3-8b", "train_4k", None,
                            steps.HParams(remat="none"), device="cpu",
                            cfg=cfg)
    assert rec["hlo_cost"]["collective_bytes"] == 0 and rec["mesh"] == {}
    n = sum(torch.Size(s).numel() for _, s, _, _ in _param_leaves(
        cfg, shd.ShardingPolicy(_OneAxis())))
    tokens = 2 * shape.global_batch * shape.seq_len * 4
    assert rec["memory"]["argument_size_in_bytes"] == 12 * n + 4 + tokens
    assert rec["kernel_calls"] == {"flash_attention_fwd": cfg.n_layers,
                                   "flash_attention_bwd": cfg.n_layers}


class _OneAxis:
    shape = {"data": 1}
    axis_names = ("data",)


def test_skipped_shape():
    with dryrun.fake_process_group(16):
        mesh = shd.make_mesh(MESH, ("data", "model"))
        rec = dryrun.lower_cell("qwen3-8b", "long_500k", mesh,
                                steps.HParams(), device="cpu")
    assert "skipped" in rec


def test_roofline_terms():
    rec = {"kind": "train", "n_devices": 4, "active_params": 10,
           "params": 20, "tokens": 100,
           "hlo_cost": {"flops": meshlib.PEAK_FLOPS_BF16,
                        "bytes_streamed": 2 * meshlib.HBM_BW,
                        "collective_bytes": 3 * meshlib.NVLINK_BW}}
    t = dryrun.roofline_terms(rec)
    assert (t["t_compute"], t["t_memory"], t["t_collective"]) == pytest.approx(
        (1.0, 2.0, 3.0))
    assert t["dominant"] == "t_collective"
    assert t["roofline_bound_s"] == pytest.approx(3.0)
    assert t["model_flops_per_dev"] == 6 * 10 * 100 / 4
    assert t["useful_ratio"] == pytest.approx(1500 / meshlib.PEAK_FLOPS_BF16)
    assert t["ideal_compute_s"] == pytest.approx(
        1500 / meshlib.PEAK_FLOPS_BF16)
    rec["kind"] = "decode"
    assert dryrun.roofline_terms(rec)["model_flops_per_dev"] == 500


def test_cli_on_the_references_test_cell(tmp_path):
    """deepseek-moe-16b x decode_32k x single pod, remat full: the
    reference's record keys (less XLA's ``cost`` and ``compile_s``), 256
    ranks, its parameter and token counts; the weight-stationary decode
    moves no parameter block, all-gathers at most the reference's bytes
    and moves at most its collective bytes in all."""
    out = tmp_path / "dryrun.json"
    env = dict(os.environ, PYTHONPATH=SRC, REPRO_LOG_LEVEL="info")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "deepseek-moe-16b", "--shape", "decode_32k", "--mesh", "single",
         "--remat", "full", "--device", "cpu", "--out", str(out)],
        capture_output=True, text=True, env=env, timeout=300, cwd=REPO)
    assert r.returncode == 0, r.stdout + r.stderr
    rec, = json.loads(out.read_text())
    assert "error" not in rec
    want_keys = {"arch", "shape", "kind", "mesh", "n_devices", "params",
                 "active_params", "tokens", "hp", "memory", "hlo_cost",
                 "lower_s", "multi_pod", "tag", "roofline"}
    assert want_keys <= set(rec) and not {"cost", "compile_s"} & set(rec)
    assert set(rec["memory"]) == {
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "peak_memory_in_bytes"}
    assert rec["n_devices"] == 256 and rec["hlo_cost"]["flops"] > 0
    assert rec["roofline"]["dominant"] in ("t_compute", "t_memory",
                                           "t_collective")
    jcfg = jget_config("deepseek-moe-16b")
    assert (rec["params"], rec["active_params"], rec["tokens"]) == (
        jcfg.count_params(), jcfg.count_active_params(), 128)
    assert rec["hp"]["remat"] == "full" and rec["hp"]["attn_impl"] == \
        "pallas"
    # the cache split 256 ways and a parameter shard, as the reference's
    # own record of the cell (``REFERENCE_ARG_BYTES``)
    got = rec["memory"]["argument_size_in_bytes"]
    assert abs(got / REFERENCE_ARG_BYTES - 1) <= 0.05
    cost = rec["hlo_cost"]
    assert rec["param_collectives"] == {"count": 0, "bytes": 0}
    assert cost["collectives"]["all-gather"]["bytes"] <= \
        REFERENCE_ALL_GATHER_BYTES
    assert cost["collective_bytes"] <= REFERENCE_COLLECTIVE_BYTES
    assert rec["fits_hbm"] is True
    assert "[dryrun]" in r.stderr + r.stdout


def test_imports_no_jax():
    """The dry run and the cost model load and trace a cell in a fresh
    interpreter that never imports jax, jaxlib or the reference."""
    code = """
import sys
from repro_torch.configs import get_config
from repro_torch.distributed import hlo_cost, sharding as shd
from repro_torch.launch import dryrun, steps
with dryrun.fake_process_group(4):
    mesh = shd.make_mesh((2, 2), ("data", "model"))
    rec = dryrun.lower_cell("qwen3-8b", "decode_32k", mesh, steps.HParams(),
                            device="cpu", cfg=get_config("qwen3-8b").reduced())
assert rec["hlo_cost"]["flops"] > 0, rec
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=180)
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), \
        r.stdout + r.stderr
