"""The whole slice: the port's compile_gradient -> apply_batched on the CPU
against the reference's compile_gradient, plus the port's import and device
rules.

Both packages get the same SIREN (``params_from_jax`` on the reference's
``siren_init`` weights) and the same coordinates, made with numpy.  On the
CPU the port's wrappers run their plain versions, so this checks the
tracer, the planner copy, the executor and the serving loop end to end;
the kernels themselves are held to the plain versions on the card by
``chip_smoke.py``.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pipeline as jpipeline
from repro_torch.core import pipeline as tpipeline
from repro_torch.core.config import HardwareConfig
from repro_torch.inr.siren import params_from_jax, siren_fn
from repro_torch.kernels import common

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")


@pytest.fixture(scope="module")
def both(siren_setup):
    """(reference fn, port fn, coords [1000, 2]) for one SIREN."""
    cfg, params, f, _ = siren_setup
    from repro_torch.configs.siren import SirenConfig
    tcfg = SirenConfig(hidden_features=cfg.hidden_features,
                       hidden_layers=cfg.hidden_layers)
    tf = siren_fn(tcfg, params_from_jax(
        [{k: np.asarray(v) for k, v in p.items()} for p in params]))
    coords = np.random.default_rng(5).uniform(
        -1, 1, (1000, cfg.in_features)).astype(np.float32)
    return f, tf, coords


def _close_scaled(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = float(np.abs(want).max(initial=0.0))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale)


@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("fuse", [True, False])
def test_compile_gradient_matches_reference(both, order, fuse):
    f, tf, coords = both
    ref = jpipeline.compile_gradient(f, order, jnp.asarray(coords[:64]))
    cg = tpipeline.compile_gradient(
        tf, order, torch.from_numpy(coords[:64]),
        config=HardwareConfig(use_pallas=True, fuse_regions=fuse),
        device="cpu")
    if fuse:
        assert cg.region_plan.fused_regions()
        assert all(k.startswith("region") for _, _, k in cg.dispatch)
    for n in (1, 63, 64, 1000):
        want = ref.apply_batched(jnp.asarray(coords[:n]))
        got = cg.apply_batched(torch.from_numpy(coords[:n]))
        assert len(got) == len(want) == 2 ** order     # y, dy, d2y, ...
        for a, b in zip(got, want):
            _close_scaled(a, b)


def test_traced_graph_has_the_reference_shape(both):
    """The make_fx trace gives the planner what the jaxpr trace gives it:
    SIREN layers become FusedMmAct segments with their bias, w0 is baked
    into chains, no Identity survives, every chain is a kernel chain."""
    _, tf, coords = both
    cg = tpipeline.compile_gradient(tf, 2, torch.from_numpy(coords[:64]),
                                    config=HardwareConfig(use_pallas=True),
                                    device="cpu")
    ops = {n.op for n in cg.graph.nodes.values()}
    assert "Identity" not in ops and "Permute" not in ops
    kinds = cg.plan.counts_by_kind()
    assert kinds["FusedMmAct"] == 3                      # 2 hidden + output
    segs = [s for s in cg.plan.segments if s.kind == "FusedMmAct"]
    assert all(s.meta["bias"] is not None for s in segs)
    chains = [s for s in cg.plan.segments if s.kind == "StreamChain"]
    assert all(s.meta["chain"] is not None for s in chains)
    assert any(("scale", 30.0) in s.meta["chain"].steps for s in chains)
    assert len(cg.region_plan.regions) == 1


def test_apply_batched_zero_rows_and_cache(both):
    _, tf, coords = both
    x = torch.from_numpy(coords[:64])
    cg = tpipeline.compile_gradient(tf, 1, x, device="cpu")
    from repro_torch.core import trace
    traces = trace.TRACE_CALLS
    assert tpipeline.compile_gradient(tf, 1, x[:60], device="cpu") is cg
    assert trace.TRACE_CALLS == traces
    outs = cg.apply_batched(x[:0])
    assert [tuple(o.shape) for o in outs] == [(0, 1), (0, 2)]


def test_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert common.resolve_device(None) == torch.device("cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        common.resolve_device(None)
    with pytest.raises(RuntimeError):
        common.resolve_device("cuda")
    assert common.resolve_device("cpu") == torch.device("cpu")


def test_entry_point_raises_without_cuda(monkeypatch, both):
    _, tf, coords = both
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tpipeline.compile_gradient(tf, 1, torch.from_numpy(coords[:8]))


def test_port_imports_no_jax():
    """Compile and serve through the port in a fresh interpreter, with its
    serving, telemetry and checkpoint packages loaded: neither JAX nor the
    reference package may be imported."""
    code = """
import sys, torch
from repro_torch.configs.siren import SirenConfig
from repro_torch.core.pipeline import compile_gradient
from repro_torch.inr.siren import siren_fn, siren_init
import repro_torch.kernels.region, repro_torch.kernels.siren_layer
import repro_torch.kernels.stream_matmul, repro_torch.kernels.fused_chain
import repro_torch.serve, repro_torch.obs, repro_torch.checkpoint.ckpt
cfg = SirenConfig(hidden_features=16, hidden_layers=1)
f = siren_fn(cfg, siren_init(cfg, torch.Generator().manual_seed(0)))
cg = compile_gradient(f, 2, torch.zeros(16, 2), device="cpu")
outs = cg.apply_batched(torch.rand(20, 2))
assert [tuple(o.shape) for o in outs] == [(20, 1), (20, 2), (20, 2), (20, 2)]
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr
