"""The fused_chain kernel's tile map and launch path, checked on the CPU.

``csrc/fused_chain.cu`` runs one CTA per tile of ``chain_rows`` x
``chain_cols`` elements, a thread each.  A thread loads its x value straight
into a register and copies its element of every extra, through the extra's
own strides (0 where it broadcasts), with cp.async into its own slot of
shared memory (extra e at slot ``e * threads + thread``).  It waits once and
evaluates the chain reading only the slots it filled, so the CTA needs no
barrier.  ``_emulate`` below runs that map CTA by CTA and thread by thread
on the operands ``launch_args`` packs: shared memory starts as NaN, every
read stays inside its operand's storage, a thread reads only slots it
filled itself, and every output element is written exactly once.  The
values the threads read, gathered into tensors, must give ``eval_chain``'s
result with ``torch.equal``.

The launch path encodes a plan segment's chain once (``ChainSpec.program``,
made by ``chain_program``) and packs only a call's tensors (``launch_args``);
the encoding must be ``encode_chain``'s, chains with different constants must
not share it, the executor must pass it, and the wrapper's checks must raise
as they always have.  The SIREN plans' chains at order 3 take only extras of
x's shape, the case ``chip_smoke.py`` times.
"""

import math
import struct

import numpy as np
import pytest
import torch

from repro_torch.kernels import common
from repro_torch.kernels import fused_chain as tfc

ROWS = common.ABI["chain_rows"]
COLS = common.ABI["chain_cols"]
THREADS = ROWS * COLS
INT_MAX = 2 ** 31 - 1

# operand kinds cycled through a chain's extras
KINDS = ("full", "row", "col")


def _storage(t: torch.Tensor) -> np.ndarray:
    """The float32 storage under ``t``, flat."""
    flat = torch.empty(0, dtype=torch.float32).set_(t.untyped_storage())
    return flat.numpy()


def _emulate(chain, x, extras):
    """Run the kernel's tile map on CPU tensors; returns the output, the
    storage elements each operand was read from and the values the chain
    read, gathered."""
    prog = tfc.chain_program(chain)
    args = tfc.launch_args(prog, x, extras, -1)
    R, C = args[2], args[3]
    views = [x] + [e.expand(x.shape) for e in extras]
    operands = [(args[0], C, 1)] + [tuple(args[4 + 3 * k:7 + 3 * k])
                                    for k in range(len(extras))]
    mems = []
    for v, (ptr, rs, cs) in zip(views, operands):
        assert (ptr, rs, cs) == (v.data_ptr(), *v.stride())
        assert (R - 1) * rs + (C - 1) * cs <= INT_MAX
        mems.append((_storage(v), v.storage_offset()))
    tiles_c = -(-C // COLS)
    writes = np.zeros((R, C), np.int64)
    gathered = [torch.full((R, C), math.nan) for _ in operands]
    sources = [set() for _ in operands]

    def read(k, r, c):
        (flat, base), (_, rs, cs) = mems[k], operands[k]
        i = base + r * rs + c * cs
        assert 0 <= i < flat.size
        sources[k].add(i)
        return flat[i]

    for b in range(-(-R // ROWS) * tiles_c):
        tr = b // tiles_c
        r0, c0 = tr * ROWS, (b - tr * tiles_c) * COLS
        smem = np.full(len(extras) * THREADS, np.nan, np.float32)
        owner = np.full(smem.size, -1)
        for t in range(THREADS):
            r, c = r0 + t // COLS, c0 + t % COLS
            if r >= R or c >= C:
                continue
            h = read(0, r, c)                     # into a register
            for k in range(1, len(operands)):     # cp.async to its slot
                slot = (k - 1) * THREADS + t
                assert owner[slot] == -1
                owner[slot], smem[slot] = t, read(k, r, c)
            # one wait; then only the thread's own slots are read
            gathered[0][r, c] = float(h)
            for k in range(1, len(operands)):
                slot = (k - 1) * THREADS + t
                assert owner[slot] == t, "a slot another thread filled"
                assert not np.isnan(smem[slot]), "read of an unstaged value"
                gathered[k][r, c] = float(smem[slot])
            writes[r, c] += 1
    assert (writes == 1).all(), "every element written exactly once"
    out = tfc.eval_chain(gathered[0], chain, gathered[1:])
    return out, sources, gathered


def _operand(rng, kind, R, C, offset):
    """A float32 extra of ``kind`` for an [R, C] x: contiguous ("full"),
    row-broadcast [1, C], column-broadcast [R, 1]; with ``offset``, a view
    4 bytes off its storage's start (odd row stride where it has rows)."""
    shape = {"full": (R, C), "row": (1, C), "col": (R, 1)}[kind]
    if not offset:
        return torch.from_numpy(rng.uniform(0.5, 1.5, shape)
                                .astype(np.float32))
    wide = rng.uniform(0.5, 1.5, (shape[0], shape[1] + 1)).astype(np.float32)
    return torch.from_numpy(wide)[:, 1:]


def _chain(n_extra):
    """A chain with ``n_extra`` binary steps, every binary op in turn,
    between unary steps and baked constants."""
    ops = ["mul", "add", "sub", "max", "min", "div"]
    chain = [("sin", None), ("scale", 30.0)]
    for k in range(n_extra):
        chain.append((ops[k % len(ops)], None))
        if k % 4 == 3:
            chain.append(("cos", None))
    chain.append(("offset", -0.25))
    return chain


SHAPES = [(8, 256), (8, 1), (8, 2), (13, 256), (13, 255), "offset"]


@pytest.mark.parametrize("n_extra", [0, 1, 5, 16])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_tile_map_stages_and_writes_every_element_once(shape, n_extra):
    offset = shape == "offset"
    R, C = (8, 256) if offset else shape
    rng = np.random.default_rng(R * 1000 + C + n_extra)
    if offset:                    # contiguous, 4 bytes off 16-byte alignment
        x = torch.from_numpy(rng.uniform(-1, 1, R * C + 1)
                             .astype(np.float32))[1:].view(R, C)
    else:
        x = torch.from_numpy(rng.uniform(-1, 1, (R, C)).astype(np.float32))
    extras = [_operand(rng, KINDS[k % 3], R, C, offset)
              for k in range(n_extra)]
    chain = _chain(n_extra)
    got, _, gathered = _emulate(chain, x, extras)
    want = tfc.eval_chain(x, chain, extras)
    assert torch.equal(got, want)
    for k, e in enumerate([x] + extras):
        assert torch.equal(gathered[k], e.expand(R, C))


@pytest.mark.parametrize("kind,offset,shape", [
    ("full", False, (8, 256)),
    ("full", False, (13, 255)),
    ("full", True, (8, 256)),     # 4 bytes off alignment, odd row stride
    ("row", False, (8, 256)),     # row broadcast: row stride 0
    ("row", True, (8, 256)),
    ("col", False, (13, 255)),    # column broadcast: column stride 0
    ("scalar", False, (8, 256)),  # both strides 0
    ("scalar", False, (8, 1)),    # a 0-d extra where x has a size-1 dim
    ("scalar", False, (1, 256)),
    ("vector", False, (8, 256)),  # a 1-d extra: row broadcast
    ("vector", False, (1, 1)),
])
def test_broadcast_extra_is_read_through_stride_zero(kind, offset, shape):
    """Each thread copies its own element of an extra through the extra's
    strides, so a broadcast extra is read from its one row, one column or
    one element, and nothing else of its storage is touched."""
    R, C = shape
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32))
    if kind == "scalar":
        e = torch.from_numpy(rng.uniform(0.5, 1.5, ()).astype(np.float32))
    elif kind == "vector":
        e = torch.from_numpy(rng.uniform(0.5, 1.5, C).astype(np.float32))
    else:
        e = _operand(rng, kind, R, C, offset)
    got, sources, _ = _emulate([("mul", None)], x, [e])
    assert torch.equal(got, x * e)
    base, st = e.storage_offset(), e.stride()
    if kind == "full":
        want = {base + r * st[0] + c * st[1] for r in range(R)
                for c in range(C)}
    elif kind in ("row", "vector"):
        want = {base + c * st[-1] for c in range(C)}
    elif kind == "col":
        want = {base + r * st[0] for r in range(R)}
    else:
        want = {base}
    assert sources[1] == want


def _unpack(blob):
    fields = struct.unpack(f"<ii{common.ABI['max_chain']}i"
                           f"{common.ABI['max_chain']}f", blob)
    n_ops, n_bin = fields[:2]
    m = common.ABI["max_chain"]
    return n_ops, n_bin, list(fields[2:2 + n_ops]), \
        list(fields[2 + m:2 + m + n_ops])


@pytest.mark.parametrize("chain", [
    (("cos", None), ("mul", None), ("scale", 30.0)),
    (("mul", None), ("neg", None), ("mul", None)),
    (("mul", None), ("mul", None), ("add", None), ("add", None),
     ("add", None), ("scale", 0.5)),
    (("sin", None), ("offset", -0.25), ("max", None), ("min", None),
     ("div", None), ("sub", None), ("silu", None)),
    tuple((op, None) for op in tfc.OPCODES if op not in ("scale", "offset")),
])
def test_chain_program_is_encode_chain(chain):
    prog = tfc.chain_program(chain)
    ops, vals = tfc.encode_chain(chain)
    n_ops, n_bin, got_ops, got_vals = _unpack(prog.blob)
    assert (n_ops, got_ops) == (len(ops), ops)
    assert got_vals == [float(np.float32(v)) for v in vals]
    assert n_bin == prog.n_bin == sum(op in tfc.BINARY for op, _ in chain)
    assert prog.steps == chain
    spec = tfc.ChainSpec(x=0, steps=chain, extras=tuple(range(n_bin)))
    assert spec.program is spec.program                # encoded once
    assert spec.program == prog


def _spec(*steps):
    return tfc.ChainSpec(x=0, steps=steps, extras=())


def test_chain_program_keeps_constants_apart():
    a, b = _spec(("scale", 30.0)), _spec(("scale", 0.5))
    assert _unpack(a.program.blob)[3] == [30.0]
    assert _unpack(b.program.blob)[3] == [0.5]
    # specs equal as values (0.0 == -0.0) keep programs of their own
    pos, neg = _spec(("scale", 0.0)), _spec(("scale", -0.0))
    assert pos == neg
    assert math.copysign(1, _unpack(neg.program.blob)[3][0]) == -1
    assert math.copysign(1, _unpack(pos.program.blob)[3][0]) == 1
    nan = _spec(("offset", math.nan))
    assert math.isnan(_unpack(nan.program.blob)[3][0])
    assert nan.program is nan.program


def test_chain_of_lists_encodes_as_tuples():
    """A chain given as a list, or a tuple of lists, encodes as its tuple
    and runs as it on the CPU."""
    chain = (("cos", None), ("mul", None), ("scale", 30.0))
    lists = tuple(list(step) for step in chain)
    for c in (lists, list(lists)):
        prog = tfc.chain_program(c)
        assert prog == tfc.chain_program(chain) and prog.steps == chain
    rng = np.random.default_rng(3)
    x, e = (torch.from_numpy(rng.uniform(-1, 1, (8, 16)).astype(np.float32))
            for _ in range(2))
    want = tfc.eval_chain(x, chain, [e])
    for c in (lists, list(lists), tfc.chain_program(chain)):
        assert torch.equal(tfc.fused_chain(x, c, [e]), want)


@pytest.mark.parametrize("chain", [
    (("tan", None),),
    (("sin", None),) * (common.ABI["max_chain"] + 1),
])
def test_chain_program_raises_as_encode_chain(chain):
    with pytest.raises(ValueError):
        tfc.encode_chain(chain)
    with pytest.raises(ValueError):
        tfc.chain_program(chain)


def _f32(*shape):
    return torch.zeros(shape, dtype=torch.float32)


@pytest.mark.parametrize("case,exc,match", [
    ("arity", ValueError, "1 binary steps, 0 extras"),
    ("rank", ValueError, r"x must be \[R, C\]"),
    ("extras", ValueError, "17 extras exceed the kernel's 16"),
    ("device", ValueError, "current device is cuda:0"),
    ("dtype", TypeError, "x must be float32"),
    ("contiguity", ValueError, "x must be contiguous"),
    ("extra dtype", TypeError, "extra 0 must be float32"),
])
def test_launch_args_checks_as_the_wrapper_did(case, exc, match):
    """The checks a CUDA launch makes, run on CPU tensors with the current
    device given as -1 (a CPU tensor's ``get_device()``), or 0 where the
    device check itself is under test."""
    x, device, chain, extras = _f32(8, 16), -1, (("mul", None),), [_f32(8, 16)]
    if case == "arity":
        extras = []
    elif case == "rank":
        x = _f32(2, 8, 16)
    elif case == "extras":
        chain, extras = (("mul", None),) * 17, [_f32(8, 16)] * 17
    elif case == "device":
        device = 0
    elif case == "dtype":
        x = x.double()
    elif case == "contiguity":
        x = _f32(16, 8).t()
    else:
        extras = [extras[0].double()]
    with pytest.raises(exc, match=match):
        tfc.launch_args(tfc.chain_program(chain), x, extras, device)


def test_wrapper_errors_on_the_cpu_path():
    x = _f32(8, 16)
    with pytest.raises(ValueError, match="1 binary steps, 0 extras"):
        tfc.fused_chain(x, [("mul", None)], [])
    with pytest.raises(ValueError, match="unsupported device"):
        tfc.fused_chain(x.to("meta"), [("sin", None)])
    with pytest.raises(ValueError, match="unknown op"):
        tfc.fused_chain(x, [("tan", None)])


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
def test_order3_plan_passes_programs_and_full_block_extras(fuse,
                                                          monkeypatch):
    """The full-width SIREN at order 3: the executor passes each segment's
    ``ChainSpec.program``, and every extra is a contiguous tensor of x's
    [8, 256] block, so the chains ``chip_smoke.py`` times at [8,256] with
    full extras are the path's own (fused: ``mul·neg·mul``, ``mul·mul``;
    unfused also ``mul·mul·add·add·add·scale``)."""
    from repro_torch.configs.siren import SirenConfig
    from repro_torch.core.config import HardwareConfig
    from repro_torch.core.pipeline import compile_gradient
    from repro_torch.inr.siren import siren_fn, siren_init

    seen = {}
    run = tfc.fused_chain

    def spy(x, chain, extras=()):
        assert type(chain) is tfc.ChainProgram
        assert x.shape == (8, 256) and x.is_contiguous()
        for e in extras:
            assert e.shape == x.shape and e.is_contiguous()
        name = "·".join(op for op, _ in chain.steps)
        seen[name] = len(extras)
        return run(x, chain, extras)

    monkeypatch.setattr(tfc, "fused_chain", spy)
    cfg = SirenConfig()
    f = siren_fn(cfg, siren_init(cfg, torch.Generator().manual_seed(0),
                                 device="cpu"))
    coords = torch.from_numpy(np.random.default_rng(0).uniform(
        -1, 1, (cfg.batch, 2)).astype(np.float32))
    cg = compile_gradient(f, 3, coords, device="cpu",
                          config=HardwareConfig(use_pallas=True,
                                                fuse_regions=fuse))
    cg.apply_batched(coords[:8])
    assert seen["mul·neg·mul"] == seen["mul·mul"] == 2
    if not fuse:
        assert seen["mul·mul·add·add·add·scale"] == 5
        assert max(seen.values()) == 5
