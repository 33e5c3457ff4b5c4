"""The port's cost model (``repro_torch.distributed.hlo_cost``): exact
counts of small functions, the collectives' operand bytes under a fake
process group, the custom ops' fake kernels and flop formulas, the
matrix products of every family's steps against ``FlopCounterMode``, and
the FLOPs of whole steps against the reference's HLO analysis.

The reference counts optimized HLO, the port counts aten ops as they
reach the dispatcher; both apply the same rules (dots 2·|result|·K,
transcendental elementwise ops 4·|result|, other elementwise ops
|result|, reductions the input's elements; bytes: operands and results,
less the elementwise ops with one consumer).  The dense and audio
steps' dots agree exactly (mamba2's within 1%: XLA turns a few small
einsums into a multiply and a reduce).  Their totals differ where XLA
materializes what torch keeps as a view (broadcasts, slices, transposes
count |result| each in HLO) and where the two packages run different
algorithms (the reference dispatches MoE tokens with one-hot einsums, the
port moves rows by index), so the whole-step comparison takes the dense
and audio families, where those gaps are smallest, at 10%.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import get_config as jget_config
from repro.configs.base import ShapeConfig as JShape
from repro.distributed import hlo_cost as jcost
from repro.launch import steps as jsteps
from repro.models import zoo as jzoo
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.distributed import hlo_cost
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as scan
from repro_torch.launch import dryrun, steps
from repro_torch.models import zoo

F32 = 4


def _cost(fn, *shapes, dtype=torch.float32):
    with FakeTensorMode():
        args = [torch.empty(s, dtype=dtype) for s in shapes]
        return hlo_cost.analyze_cost(fn, *args)[0]


# ---------------------------------------------------------------------------
# exact counts of small functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,fn,shapes,M,N,K", [
    ("mm", lambda a, b: a @ b, [(8, 5), (5, 3)], 8, 3, 5),
    ("addmm", lambda c, a, b: torch.addmm(c, a, b), [(3,), (8, 5), (5, 3)],
     8, 3, 5),
    ("bmm", lambda a, b: torch.bmm(a, b), [(4, 8, 5), (4, 5, 3)], 32, 3, 5),
    ("baddbmm", lambda c, a, b: torch.baddbmm(c, a, b),
     [(4, 8, 3), (4, 8, 5), (4, 5, 3)], 32, 3, 5),
])
def test_dot_flops_and_bytes(name, fn, shapes, M, N, K):
    c = _cost(fn, *shapes)
    operand = sum(F32 * torch.Size(s).numel() for s in shapes)
    assert c.flops == c.dot_flops == 2 * M * N * K
    assert c.bytes_raw == c.bytes_streamed == operand + F32 * M * N
    assert c.by_kind == {"dot": operand + F32 * M * N}
    assert c.transcendentals == 0 and c.n_ops == 1


@pytest.mark.parametrize("op", ["sin", "cos", "exp", "log", "tanh", "rsqrt",
                                "sqrt", "sigmoid", "erf"])
def test_transcendental_ops(op):
    c = _cost(getattr(torch, op), (6, 7))
    assert c.flops == 4 * 42 and c.transcendentals == 42
    assert c.bytes_raw == 2 * F32 * 42
    # no consumer: it streams
    assert c.bytes_streamed == 0


def test_transcendental_backward_ops():
    """silu, pow and their backward ops count 4 per element."""
    def f(x):
        x = x.detach().requires_grad_()
        y = torch.nn.functional.silu(x)
        y.backward(torch.ones_like(y))
        return torch.pow(x, 3)
    with FakeTensorMode():
        m = hlo_cost.CostMode()
        with m:
            f(torch.empty(5, 4))
    kinds = {op.kind: op for op in m.ops}
    for k in ("silu", "silu_backward", "pow"):
        assert kinds[k].flops == 4 * 20 and kinds[k].transcendentals == 20


def test_elementwise_and_reduction():
    c = _cost(lambda x, y: x + y, (6, 7), (6, 7))
    assert (c.flops, c.transcendentals, c.bytes_raw) == (42, 0, 3 * F32 * 42)
    c = _cost(lambda x: x.sum(-1), (6, 7))
    assert c.flops == 42 and c.bytes_raw == F32 * (42 + 6)
    assert c.bytes_streamed == c.bytes_raw and c.by_kind == {
        "reduce": F32 * 48}
    c = _cost(lambda x: x.amax(), (6, 7))
    assert c.flops == 42


def test_broadcast_operand_counted_once():
    """A stride-0 (expanded) operand is read once: a row added to every
    row of a matrix reads the row's bytes, not the matrix's."""
    c = _cost(lambda x, b: x + b, (6, 7), (7,))
    assert c.bytes_raw == F32 * (42 + 7 + 42)
    c = _cost(lambda x, b: x + b.expand(6, 7), (6, 7), (7,))
    assert c.bytes_raw == F32 * (42 + 7 + 42)


def test_views_are_free():
    c = _cost(lambda x: (x.t(), x.view(7, 6), x[1:], x.permute(1, 0),
                         x.unsqueeze(0).expand(3, 6, 7), x.select(0, 2),
                         x.detach(), x.reshape(42)), (6, 7))
    assert c.n_ops == 0 and c.flops == 0 and c.bytes_raw == 0


def test_single_consumer_elementwise_ops_stream():
    """x*2 -> exp -> @w: each elementwise result has one consumer and
    streams; only the product moves bytes."""
    c = _cost(lambda x, w: torch.exp(x * 2) @ w, (8, 5), (5, 3))
    dot = F32 * (40 + 15 + 24)
    assert c.bytes_streamed == dot and c.by_kind == {"dot": dot}
    assert c.bytes_raw == dot + 2 * (2 * F32 * 40)
    assert c.flops == 2 * 8 * 3 * 5 + 40 + 4 * 40
    # a view between producer and consumer keeps the one consumer
    c = _cost(lambda x, w: (x * 2).t() @ w, (5, 8), (5, 3))
    assert c.bytes_streamed == F32 * (40 + 15 + 24)


def test_two_consumers_do_not_stream():
    """a = x*2 is read twice: its traffic counts; a+1 and a*3 have no
    consumer and stream."""
    c = _cost(lambda x: (lambda a: (a + 1, a * 3))(x * 2), (6, 7))
    assert c.bytes_streamed == 2 * F32 * 42
    assert c.by_kind == {"ew:mul": 2 * F32 * 42}
    assert c.bytes_raw == 3 * 2 * F32 * 42 and c.flops == 3 * 42


def test_in_place_and_update_ops():
    """An in-place op is its result's producer; a copy into a view is the
    reference's dynamic-update-slice (read the update, write it)."""
    def f(x, y):
        x.mul_(2)
        x[1:3].copy_(y)
        return x @ x.t()
    c = _cost(f, (6, 7), (2, 7))
    assert c.by_kind["dus"] == 2 * F32 * 14
    # mul_ (x read and written) has consumers: the copy's view and the
    # product's two operands, so its traffic counts
    assert c.by_kind["ew:mul"] == 2 * F32 * 42


def test_type_bytes():
    assert hlo_cost.type_bytes(torch.bfloat16, (3, 4)) == 24
    assert hlo_cost.type_bytes(torch.float32) == 4
    assert hlo_cost.type_bytes(torch.int64, (5,)) == 40
    assert hlo_cost.type_bytes(torch.bool, (7,)) == 7


def test_keys_are_the_references():
    """``analyze`` returns exactly the reference's ``Cost.as_dict()``
    keys, collectives and all."""
    want = jcost.analyze(jax.jit(lambda a, b: jnp.sin(a @ b)).lower(
        jax.ShapeDtypeStruct((4, 4), jnp.float32),
        jax.ShapeDtypeStruct((4, 4), jnp.float32)).compile().as_text())
    with FakeTensorMode():
        got = hlo_cost.analyze(lambda a, b: torch.sin(a @ b),
                               torch.empty(4, 4), torch.empty(4, 4))
    assert set(got) == set(want)
    assert set(got["collectives"]) == set(want["collectives"])
    assert hlo_cost.COLLECTIVES == jcost.COLLECTIVES
    for v in got["collectives"].values():
        assert set(v) == {"count", "bytes"}


# ---------------------------------------------------------------------------
# collectives under a fake process group
# ---------------------------------------------------------------------------

@pytest.fixture
def fake_group():
    if dist.is_initialized():
        pytest.fail("a process group is already up")
    with dryrun.fake_process_group(8):
        yield dist.group.WORLD


def _collectives(fn):
    with FakeTensorMode():
        return hlo_cost.analyze_cost(fn)[0].collectives


def test_c10d_collectives(fake_group):
    def run():
        t = torch.empty(6, 4)
        dist.all_reduce(t)
        dist.all_gather([torch.empty(6, 4) for _ in range(8)],
                        torch.empty(6, 4))
        dist.all_gather_into_tensor(torch.empty(48, 4), torch.empty(6, 4))
        dist.reduce_scatter_tensor(torch.empty(6, 4), torch.empty(48, 4))
        dist.reduce_scatter(torch.empty(6, 4),
                            [torch.empty(6, 4) for _ in range(8)])
        dist.all_to_all_single(torch.empty(16, 4), torch.empty(16, 4))
        dist.all_to_all([torch.empty(2, 4) for _ in range(8)],
                        [torch.empty(2, 4) for _ in range(8)])
    c = _collectives(run)
    row = F32 * 24
    assert c["all-reduce"] == {"count": 1, "bytes": row}
    assert c["all-gather"] == {"count": 2, "bytes": 2 * row}
    assert c["reduce-scatter"] == {"count": 2, "bytes": 2 * 8 * row}
    assert c["all-to-all"] == {"count": 2, "bytes": 2 * F32 * 64}
    assert c["collective-permute"]["count"] == 0


def test_functional_collectives(fake_group):
    import torch.distributed._functional_collectives as funcol

    def run():
        t = torch.empty(6, 4)
        funcol.all_reduce(t, "sum", fake_group)
        funcol.all_gather_tensor(t, 0, fake_group)
        funcol.reduce_scatter_tensor(torch.empty(48, 4), "sum", 0,
                                     fake_group)
        funcol.all_to_all_single(torch.empty(16, 4), None, None,
                                 fake_group)
    c = _collectives(run)
    row = F32 * 24
    assert c["all-reduce"] == {"count": 1, "bytes": row}
    assert c["all-gather"] == {"count": 1, "bytes": row}
    assert c["reduce-scatter"] == {"count": 1, "bytes": 8 * row}
    assert c["all-to-all"] == {"count": 1, "bytes": F32 * 64}


def test_param_collectives_follow_the_watched_blocks(fake_group):
    """``CostMode(watch=...)`` counts apart the collectives whose operand
    is a watched tensor (a step's parameter block), a view, cast or copy
    of one, or the result of a collective of one; a collective of a
    product of one (an activation) is not counted."""
    fc = torch.ops._c10d_functional
    name = fake_group.group_name

    def run(w, x):
        fc.wait_tensor(fc.all_gather_into_tensor(w.t().contiguous(), 8,
                                                 name))
        g = fc.wait_tensor(fc.all_reduce(w[:2].to(torch.bfloat16), "sum",
                                         name))
        fc.wait_tensor(fc.all_reduce(g, "sum", name))
        fc.wait_tensor(fc.all_reduce(x @ w, "sum", name))

    with FakeTensorMode():
        w, x = torch.empty(8, 4), torch.empty(2, 8)
        with hlo_cost.CostMode(watch=[w]) as mode:
            run(w, x)
    c = mode.cost()
    assert c.param_collectives == {"count": 3, "bytes": F32 * 32 + 2 * 16}
    assert c.collectives["all-reduce"] == {"count": 3,
                                           "bytes": 2 * 16 + F32 * 8}


def test_dtensor_gather_counts_the_local_block(fake_group):
    """A DTensor's ``full_tensor`` is counted as the all-gather DTensor
    runs on the rank's block."""
    from repro_torch.distributed import sharding as shd
    mesh = shd.make_mesh((2, 4), ("data", "model"))
    # the mesh's rank table is a real tensor
    with FakeTensorMode(allow_non_fake_inputs=True):
        d = shd.distribute(torch.empty(8, 16), shd.P("data", "model"), mesh)
        c, full = hlo_cost.analyze_cost(shd.full_tensor, d)
    assert tuple(full.shape) == (8, 16)
    block = F32 * 4 * 4
    # one gather per sharded mesh dim: the block, then the gathered rows
    assert c.collectives["all-gather"]["count"] == 2
    assert sorted([block, 4 * block]) == sorted(
        [block, c.collectives["all-gather"]["bytes"] - block])


# ---------------------------------------------------------------------------
# the custom ops: fake kernels and flop formulas
# ---------------------------------------------------------------------------

ATTN = [((2, 40, 4, 16), 40, True, 0), ((2, 40, 4, 16), 40, True, 8),
        ((1, 10, 4, 16), 50, True, 0), ((1, 30, 2, 16), 30, False, 0),
        ((1, 30, 2, 16), 30, False, 7)]


@pytest.mark.parametrize("qshape,Sk,causal,window", ATTN)
def test_attention_flop_formula(qshape, Sk, causal, window):
    B, Sq, H, D = qshape
    pairs = int(fa._mask(Sq, Sk, causal, window, "cpu").sum())
    want = 4 * D * pairs * B * H
    assert fa.visible_pairs(Sq, Sk, causal, window) == pairs
    assert fa.attention_flops(B, Sq, Sk, H, D, causal=causal,
                              window=window) == want
    with FakeTensorMode():
        q = torch.empty(qshape)
        k = v = torch.empty(B, Sk, 2, D)
        with FlopCounterMode(display=False) as fc:
            out, lse = fa._forward(q, k, v, causal, window, True)
        assert fc.get_total_flops() == want
        assert (tuple(out.shape), out.dtype) == (qshape, torch.float32)
        assert (tuple(lse.shape), lse.dtype) == ((B, Sq, H), torch.float32)
        assert fa._forward(q, k, v, causal, window, False)[1] is None
        with FlopCounterMode(display=False) as fc:
            dq, dk, dv = fa.flash_attention_bwd(q, k, v, out, lse, out,
                                                causal=causal, window=window)
        assert fc.get_total_flops() == 10 * D * pairs * B * H
        assert [tuple(t.shape) for t in (dq, dk, dv)] == [
            qshape, (B, Sk, 2, D), (B, Sk, 2, D)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_fake_dtypes(dtype):
    """bf16: out in bf16, lse in float32; the backward's gradients in the
    inputs' dtype; the cost model counts one call of each op."""
    with FakeTensorMode():
        q = torch.empty(1, 32, 4, 16, dtype=dtype, requires_grad=True)
        k = torch.empty(1, 32, 2, 16, dtype=dtype, requires_grad=True)
        v = torch.empty(1, 32, 2, 16, dtype=dtype, requires_grad=True)

        def step():
            o = fa.flash_attention(q, k, v)
            assert o.dtype == dtype
            g = torch.autograd.grad(o.float().sum(), (q, k, v))
            assert all(t.dtype == dtype for t in g)
        c, _ = hlo_cost.analyze_cost(step)
    assert dict(c.kernel_calls) == {"flash_attention_fwd": 1,
                                    "flash_attention_bwd": 1}
    assert c.kernel_shapes["flash_attention_fwd"] == {(1, 32, 4, 16)}
    pairs = fa.visible_pairs(32, 32, True, 0)
    assert c.dot_flops == 14 * 16 * pairs * 4


def _plain_arithmetic(fn, *args):
    """FLOPs of the plain version's multiplies, adds and sums, counted by
    the cost model on real tensors."""
    m = hlo_cost.CostMode()
    with m:
        fn(*args)
    return sum(op.flops for op in m.ops if op.kind in ("mul", "add", "reduce"))


@pytest.mark.parametrize("shape", [(3, 5, 7, 9), (2, 1, 4, 4), (4, 8, 2, 3)])
def test_ssd_scan_flop_formula(shape):
    BH, NC, P, N = shape
    g = torch.Generator().manual_seed(0)
    st = torch.randn(shape, generator=g)
    dec = torch.rand(shape[:2], generator=g)
    dprev = torch.randn(shape, generator=g)
    with FlopCounterMode(display=False) as fc:
        prev = scan.ssd_scan(st, dec)
    assert fc.get_total_flops() == scan.scan_flops(shape) == 2 * st.numel()
    assert fc.get_total_flops() == _plain_arithmetic(scan.ssd_scan_plain,
                                                     st, dec)
    with FlopCounterMode(display=False) as fc:
        scan.ssd_scan_bwd(dprev, prev, dec)
    assert fc.get_total_flops() == scan.scan_bwd_flops(shape) == \
        _plain_arithmetic(scan.ssd_scan_bwd_plain, dprev, prev, dec)
    with FakeTensorMode():
        fst = torch.empty(shape, dtype=torch.bfloat16)
        fdec = torch.empty(shape[:2])
        fprev = scan.ssd_scan(fst, fdec)
        assert (tuple(fprev.shape), fprev.dtype) == (shape, torch.float32)
        ds, dd = scan.ssd_scan_bwd(fprev, fprev, fdec, torch.bfloat16)
        assert (tuple(ds.shape), ds.dtype) == (shape, torch.bfloat16)
        assert (tuple(dd.shape), dd.dtype) == (shape[:2], torch.float32)


def test_custom_ops_registered():
    """Each kernel entry point is a ``repro_torch`` custom op with a flop
    formula."""
    from torch.utils.flop_counter import flop_registry
    for name in ("flash_attention_fwd", "flash_attention_bwd", "ssd_scan",
                 "ssd_scan_bwd"):
        assert getattr(torch.ops.repro_torch, name) in flop_registry


# ---------------------------------------------------------------------------
# whole steps
# ---------------------------------------------------------------------------

FAMILIES = ["qwen3-8b", "musicgen-medium", "deepseek-moe-16b",
            "mamba2-2.7b", "jamba-v0.1-52b", "llama-3.2-vision-90b"]
B, S = 2, 24


def _port_step(arch, kind, attn_impl="pallas", seq=S, dtype=None):
    """(step, args) of a reduced config on fake CPU tensors (call inside
    a FakeTensorMode)."""
    cfg = get_config(arch).reduced()
    if dtype:
        cfg = dataclasses.replace(cfg, compute_dtype=dtype)
    hp = steps.HParams(attn_impl=attn_impl)
    shape = ShapeConfig("t", kind, seq, B)
    if kind == "train":
        return steps.build_train_step(cfg, hp), (
            steps.abstract_state(cfg, "cpu"), _inputs(cfg, shape))
    params = steps.serving_params_struct(cfg, hp, "cpu")
    if kind == "prefill":
        return steps.build_prefill_step(cfg, hp), (params,
                                                   _inputs(cfg, shape))
    cache = zoo.init_cache(cfg, B, seq, device="cpu")
    return steps.build_serve_step(cfg, hp), (
        params, cache, torch.zeros(B, dtype=torch.int32), seq - 1)


def _inputs(cfg, shape):
    return {k: torch.zeros(v.shape, dtype=v.dtype)
            for k, v in zoo.input_structs(cfg, shape).items()}


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_dot_flops_equal_flop_counter(arch, kind):
    """The matrix products and custom ops of each family's steps count
    exactly what ``FlopCounterMode`` counts."""
    with FakeTensorMode(allow_non_fake_inputs=True):
        step, args = _port_step(arch, kind)
        c, _ = hlo_cost.analyze_cost(step, *args)
        step, args = _port_step(arch, kind)
        with FlopCounterMode(display=False) as fc:
            step(*args)
    assert c.dot_flops == fc.get_total_flops() > 0
    assert c.flops > c.dot_flops
    if kind == "train":
        assert c.kernel_calls["flash_attention_fwd"] + \
            c.kernel_calls["ssd_scan"] > 0


def _reference_hlo(arch, kind, seq):
    cfg = dataclasses.replace(jget_config(arch).reduced(),
                              compute_dtype="float32")
    hp = jsteps.HParams(remat="dots", attn_impl="flash")
    structs = jzoo.input_structs(cfg, JShape("t", kind, seq, B))
    state = jsteps.abstract_state(cfg)
    if kind == "train":
        f, args = jsteps.build_train_step(cfg, hp), (state, structs)
    else:
        f, args = jsteps.build_prefill_step(cfg, hp), (state["params"],
                                                       structs)
    return jax.jit(f).lower(*args).compile().as_text()


def _reference_dot_flops(hlo: str) -> float:
    """2·|result|·K of every dot in the reference's HLO, each while body
    multiplied by its trip count, as ``repro.distributed.hlo_cost``
    counts them."""
    comps = jcost.parse_computations(hlo)
    entry = re.search(r"^ENTRY\s+%?([\w.\-]+)", hlo, re.M).group(1)

    def walk(name):
        total = 0.0
        for op in comps[name].ops:
            mult = 1
            if op.kind == "while":
                tm = jcost._TRIP_RE.search(op.line)
                mult = int(tm.group(1)) if tm else 1
            for called in re.findall(r"(?:calls|to_apply|body)=%?([\w.\-]+)",
                                     op.line):
                if called in comps:
                    total += mult * walk(called)
            if op.kind in ("dot", "dot-general"):
                lhs = comps[name].types.get(op.operands[0], "")
                dims = [int(d) for d in jcost._SHAPE_RE.search(lhs).group(2)
                        .split(",") if d]
                cd = re.search(r"lhs_contracting_dims=\{([\d,]*)\}", op.line)
                k = 1
                for i in (cd.group(1).split(",") if cd else []):
                    if i:
                        k *= dims[int(i)]
                total += 2.0 * jcost.type_elems(op.result_type) * k
        return total
    return walk(entry)


def _port_cost(arch, kind, seq):
    with FakeTensorMode(allow_non_fake_inputs=True):
        step, args = _port_step(arch, kind, "flash", seq, "float32")
        return hlo_cost.analyze_cost(step, *args)[0]


@pytest.mark.parametrize("kind", ["prefill", "train"])
@pytest.mark.parametrize("arch", ["qwen3-8b", "musicgen-medium"])
def test_flops_match_reference(arch, kind):
    """The whole step's FLOPs within 10% of the reference's scan-aware
    HLO count (same reduced config, float32, unsharded, blockwise
    attention on both sides), and its dots equal."""
    hlo = _reference_hlo(arch, kind, 64)
    want = jcost.analyze(hlo)
    got = _port_cost(arch, kind, 64)
    assert abs(got.flops - want["flops"]) <= 0.10 * want["flops"], \
        (got.flops, want["flops"])
    assert got.dot_flops == _reference_dot_flops(hlo)


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_ssm_dots_match_reference(kind):
    """mamba2: the dots within 1% of the reference's (XLA rewrites a few
    of the SSD's small einsums as a multiply and a reduce); the total is
    below the reference's by the broadcasts, slices and transposes XLA
    materializes (each |result| flops in HLO, views in torch)."""
    hlo = _reference_hlo("mamba2-2.7b", kind, 64)
    got = _port_cost("mamba2-2.7b", kind, 64)
    want = _reference_dot_flops(hlo)
    assert abs(got.dot_flops - want) <= 0.01 * want, (got.dot_flops, want)
    assert got.flops < jcost.analyze(hlo)["flops"]
