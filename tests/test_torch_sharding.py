"""The port's sharding policy, its specs and its meshes against the
reference's (``tests/test_sharding.py``), and the rank launcher the sharded
tests share.

The reference's ``ShardingPolicy`` only reads ``mesh.shape``, so both
packages' policies get the same plain mesh stand-in (axis name -> size)
and no device is forced: the port's specs (``spec`` / ``act_spec``,
``param_specs``, ``state_specs``, ``batch_specs`` for every supported
shape, ``cache_specs``) must equal the reference's, as tuples, on every
arch's full-size template for four meshes, with and without
``seq_parallel`` and ``extra_rules``.

``run_ranks`` starts n processes, each a rank of a gloo group on a
``FileStore`` in a temporary directory (no network), with a deadline for
all of them; ``one_rank_mesh`` brings up a one-rank gloo group in this
process for the entry points' one-rank checks.
"""

import contextlib
import os
import subprocess
import sys
import tempfile
import textwrap
import time

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCH_IDS
from repro.configs import get_config as jget_config
from repro.configs.base import cells as jcells
from repro.distributed.sharding import ShardingPolicy as JPolicy
from repro.launch import steps as jsteps
from repro.models import zoo as jzoo
from repro_torch.configs import get_config
from repro_torch.configs.base import cells
from repro_torch.distributed import sharding as shd
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps
from repro_torch.models import zoo

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")

# ---------------------------------------------------------------------------
# ranks
# ---------------------------------------------------------------------------

_PRELUDE = """
import os, sys
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from repro_torch.launch.mesh import init_process_group
RANK, WORLD = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
init_process_group(os.environ["RANK_STORE"], RANK, WORLD, backend="gloo",
                   timeout_s=90)
"""

_POSTLUDE = """
dist.barrier()
dist.destroy_process_group()
"""


def run_ranks(code: str, n: int, timeout: float = 120.0) -> list[str]:
    """Run ``code`` in ``n`` fresh interpreters, rank r of an n-rank gloo
    group each (``RANK`` and ``WORLD`` defined, the group up); returns
    each rank's stdout.  Every rank must exit 0 within ``timeout`` seconds
    in all; a rank still running then is killed and the test fails."""
    body = _PRELUDE + textwrap.dedent(code) + _POSTLUDE
    with tempfile.TemporaryDirectory() as d:
        env = dict(os.environ, PYTHONPATH=SRC, WORLD_SIZE=str(n),
                   RANK_STORE=os.path.join(d, "store"), OMP_NUM_THREADS="1")
        procs = [subprocess.Popen([sys.executable, "-c", body],
                                  env=dict(env, RANK=str(r)),
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for r in range(n)]
        deadline = time.monotonic() + timeout
        results = []
        try:
            for p in procs:
                left = max(1.0, deadline - time.monotonic())
                results.append(p.communicate(timeout=left))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
    for r, (p, (out, err)) in enumerate(zip(procs, results)):
        assert p.returncode == 0, (f"rank {r} exited {p.returncode}\n"
                                   f"stdout:\n{out}\nstderr:\n{err}")
    return [out for out, _ in results]


@contextlib.contextmanager
def one_rank_mesh(shape=(1, 1), names=("data", "model")):
    """A ``Mesh`` over a one-rank gloo group in this process (the group
    is brought up here, and taken down after, unless one is up)."""
    import torch.distributed as dist
    own = not dist.is_initialized()
    with tempfile.TemporaryDirectory() as d:
        if own:
            tmesh.init_process_group(os.path.join(d, "store"), 0, 1,
                                     backend="gloo", timeout_s=60)
        try:
            yield shd.make_mesh(shape, names)
        finally:
            if own:
                dist.destroy_process_group()


# ---------------------------------------------------------------------------
# specs against the reference
# ---------------------------------------------------------------------------

class FakeMesh:
    """What a policy reads of a mesh: axis name -> size, in order."""

    def __init__(self, shape: dict):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


MESHES = {"2x4": {"data": 2, "model": 4}, "4x2": {"data": 4, "model": 2},
          "1x8": {"data": 1, "model": 8},
          "2x2x2": {"pod": 2, "data": 2, "model": 2}}
VARIANTS = {"plain": {}, "seq_parallel": {"seq_parallel": True},
            "extra_rules": {"extra_rules": {
                "embed": ("model",), "ff": ("fsdp", "model"),
                "batch": ("fsdp", "model"), "kv_dim": ()}}}


def _flat_ref(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {"|".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): tuple(leaf) for path, leaf in leaves}


def _flat_port(tree, prefix=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_port(v, prefix + (str(k),)))
        return out
    assert isinstance(tree, shd.PartitionSpec)
    return {"|".join(prefix): tuple(tree)}


def _policies(mesh: str, variant: str):
    m = FakeMesh(MESHES[mesh])
    kw = VARIANTS[variant]
    return JPolicy(m, **kw), shd.ShardingPolicy(m, **kw)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_match_reference(arch):
    """param / state / batch / cache specs: the reference's, on every mesh
    and variant, for every shape the arch supports."""
    jcfg, tcfg = jget_config(arch), get_config(arch)
    shapes = [s.name for s in jcells(arch)]
    assert shapes == [s.name for s in cells(arch)]
    tshapes = {s.name: s for s in cells(arch)}
    jshapes = {s.name: s for s in jcells(arch)}
    caches = {name: (jzoo.init_cache(jcfg, s.global_batch, s.seq_len,
                                     abstract=True),
                     zoo.init_cache(tcfg, s.global_batch, s.seq_len,
                                    abstract=True))
              for name, s in jshapes.items() if s.kind == "decode"}
    n = 0
    for mesh in MESHES:
        for variant in VARIANTS:
            jp, tp = _policies(mesh, variant)
            want = _flat_ref(jsteps.state_specs(jcfg, jp))
            assert _flat_port(steps.state_specs(tcfg, tp)) == want
            assert _flat_port(steps.param_specs(tcfg, tp)) == \
                _flat_ref(jsteps.param_specs(jcfg, jp))
            for name in shapes:
                assert _flat_port(steps.batch_specs(
                    tcfg, tshapes[name], tp)) == _flat_ref(
                        jsteps.batch_specs(jcfg, jshapes[name], jp)), name
            for name, (jc, tc) in caches.items():
                got = _flat_port(steps.cache_specs(tcfg, tp, tc))
                assert got == _flat_ref(jsteps.cache_specs(jcfg, jp, jc))
                assert set(got) == {k for k, _ in
                                    _flat_port_leaves(tc)}, name
            n += len(want)
    assert n > 0


def _flat_port_leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat_port_leaves(v, prefix + (str(k),))
    else:
        yield "|".join(prefix), tree


@pytest.mark.parametrize("mesh", list(MESHES))
def test_act_spec_matches_reference(mesh):
    """The activation axes, the K axis of a fleet and the rows of a
    serving batch over sizes that do and do not divide."""
    names = ("batch", "inr", "seq", "act_embed", "act_heads",
             "act_kv_heads", "act_vocab", "seq_shard", "ssm_conv", None)
    for variant in VARIANTS:
        jp, tp = _policies(mesh, variant)
        for size in (1, 2, 3, 4, 6, 8, 12, 16, 24):
            for a in names:
                for b in names:
                    shape, logical = (size, 2 * size), (a, b)
                    assert tuple(tp.act_spec(shape, logical)) == \
                        tuple(jp.act_spec(shape, logical)), (shape, logical)
                    assert tuple(tp.spec(shape, logical)) == \
                        tuple(jp.spec(shape, logical)), (shape, logical)


def test_policy_divisibility_fallback():
    """``tests/test_sharding.py``'s cases, without forced devices."""
    pol = shd.ShardingPolicy(FakeMesh({"data": 2, "model": 4}))
    P = shd.PartitionSpec
    # divisible: shard
    assert pol.spec((16, 64), ("attn_fsdp", "q_dim")) == P("data", "model")
    # not divisible by model=4: replicate that dim
    assert pol.spec((16, 6), ("attn_fsdp", "q_dim")) == P("data")
    # same mesh axis never used twice
    assert pol.spec((8, 8), ("ff", "q_dim")) == P("model",)
    # stacked leading dim never sharded
    assert pol.spec((12, 16, 64), ("stack", "attn_fsdp", "ff"))[0] is None
    assert pol.spec((3, 5), ("ff", "embed")) == P() == ()
    assert repr(P("data")) == "PartitionSpec('data',)"


def test_placements_follow_the_mesh_dims():
    """One placement per mesh dim, outer first; a dim split over (pod,
    data) is ``Shard`` on both."""
    from torch.distributed.tensor import Replicate, Shard
    m = FakeMesh({"pod": 2, "data": 2, "model": 2})
    P = shd.PartitionSpec
    assert shd.placements(P(("pod", "data"), "model"), m) == \
        [Shard(0), Shard(0), Shard(1)]
    assert shd.placements(P(None, "data"), m) == \
        [Replicate(), Shard(1), Replicate()]
    assert shd.placements(P(), m) == [Replicate()] * 3
    assert shd.spec_dims(P(("pod", "data"), None, "model")) == \
        {"pod": 0, "data": 0, "model": 2}
    pol = shd.ShardingPolicy(m)
    assert shd.placements(pol.spec((8, 8), ("embed", "ff")), m) == \
        [Shard(0), Shard(0), Shard(1)]


def test_meshes_and_h100_constants():
    """``make_production_mesh`` keeps the reference's shapes and raises
    with fewer ranks; the roofline constants are the H100's."""
    import torch.distributed as dist
    assert not dist.is_initialized()
    for multi in (False, True):
        with pytest.raises(RuntimeError, match="needs"):
            tmesh.make_production_mesh(multi_pod=multi)
    with pytest.raises(RuntimeError, match="process group"):
        shd.make_mesh((1, 1), ("data", "model"))
    assert (tmesh.PEAK_FLOPS_BF16, tmesh.HBM_BW, tmesh.NVLINK_BW) == \
        (989e12, 3.35e12, 450e9)
    assert tmesh.CHIPS_PER_POD == 256
    with one_rank_mesh() as mesh:
        assert mesh.shape == {"data": 1, "model": 1}
        assert mesh.coordinate() == {"data": 0, "model": 0}
        assert tmesh.make_debug_mesh(1, 1).shape == mesh.shape
        with pytest.raises(RuntimeError, match="needs 256"):
            tmesh.make_production_mesh()
    assert not dist.is_initialized()


def test_one_rank_layouts_are_the_tensor_itself():
    """On a 1 x 1 mesh a placed tensor's block is the tensor (no copy),
    ``full_tensor`` hands the block back and ``gather`` is the identity."""
    from torch.distributed.tensor import DTensor
    t = torch.arange(24.0).reshape(4, 6)
    with one_rank_mesh() as mesh:
        spec = shd.PartitionSpec("data", "model")
        d = shd.distribute(t, spec, mesh)
        assert isinstance(d, DTensor)
        assert d.to_local().data_ptr() == t.data_ptr()
        assert shd.full_tensor(d).data_ptr() == t.data_ptr()
        assert torch.equal(d.full_tensor(), t)
        assert shd.local_shard(t, spec, mesh) is t
        assert shd.gather(t, spec, mesh) is t
        s = shd.NamedSharding(mesh, spec)
        assert s.device == torch.device("cpu")
        assert torch.equal(s.place(t).to_local(), t)


def test_kernel_wrappers_refuse_dtensors():
    """Every kernel wrapper raises ``TypeError`` on a DTensor operand
    instead of gathering it or running the plain version."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as scan
    from repro_torch.kernels.fused_chain import fused_chain
    from repro_torch.kernels.region import (region_bwd_call, region_call,
                                           region_call_stacked)
    from repro_torch.kernels.siren_layer import siren_layer
    from repro_torch.kernels.stream_matmul import stream_matmul
    q = torch.zeros(1, 4, 2, 8)
    st, dec = torch.zeros(2, 3, 4, 5), torch.ones(2, 3)
    with one_rank_mesh() as mesh:
        dt = lambda t: shd.distribute(t, shd.PartitionSpec(), mesh)
        calls = {
            "fused_chain": lambda: fused_chain(dt(torch.zeros(8, 4)),
                                               [("sin", None)]),
            "stream_matmul": lambda: stream_matmul(dt(torch.zeros(8, 4)),
                                                   torch.zeros(4, 4)),
            "siren_layer": lambda: siren_layer(torch.zeros(8, 4),
                                               dt(torch.zeros(4, 4)), None),
            "region": lambda: region_call(None, [dt(torch.zeros(8, 4))],
                                          [], [], []),
            "region_stacked": lambda: region_call_stacked(
                None, [dt(torch.zeros(2, 8, 4))], [], [], []),
            "region_bwd": lambda: region_bwd_call(
                None, [torch.zeros(8, 4)], [], [dt(torch.zeros(4))], []),
            "flash_attention": lambda: fa.flash_attention(dt(q), q, q),
            "flash_attention_bwd": lambda: fa.flash_attention_bwd(
                q, q, q, q, torch.zeros(1, 2, 4), dt(q)),
            "ssd_scan": lambda: scan.ssd_scan(dt(st), dec),
            "ssd_scan_bwd": lambda: scan.ssd_scan_bwd(st, st, dt(dec)),
        }
        for name, call in calls.items():
            with pytest.raises(TypeError, match=f"{name}: got a DTensor"):
                call()
