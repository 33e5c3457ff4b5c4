"""The import guard, and what a run does without a card."""

from __future__ import annotations

import shutil
import subprocess
import sys
import time
import types

import pytest

from inrbench import guard

from conftest import ROOT, run_small, small_cell


def test_top_level_names_compared_whole():
    assert guard.forbidden_modules(["repro_torch", "repro_torch.core",
                                    "jaxtyping", "reprox", "torch"]) == []
    assert guard.forbidden_modules(["repro", "repro.core.graph", "jax",
                                    "jaxlib.xla_client", "flax.linen",
                                    "numpy"]) == [
        "flax.linen", "jax", "jaxlib.xla_client", "repro",
        "repro.core.graph"]


def test_the_program_loads_neither(monkeypatch):
    out = run_small("siren-256x3.edit-o2")
    assert out["result"]["correct"] is True
    assert guard.forbidden_modules() == []


def test_a_run_stops_on_a_forbidden_module(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("x"))
    with pytest.raises(ImportError, match="repro.core"):
        run_small("siren-256x3.edit-o2")


@pytest.mark.parametrize("where", ["metric", "reference"])
def test_a_module_loaded_after_the_window_stops_the_run(tmp_path,
                                                         monkeypatch, where):
    """A per-layer metric's reader or the reference that imports the JAX
    package once the window has closed leaves no result."""
    from inrbench import harness
    stub = tmp_path / "stub" / "repro"
    stub.mkdir(parents=True)
    (stub / "__init__.py").write_text("")
    monkeypatch.syspath_prepend(str(tmp_path / "stub"))
    name = "siren-256x3.edit-o2"
    cell = small_cell(name)
    pkg = harness.PKG
    if where == "metric":
        pkg = tmp_path / "bench"
        shutil.copytree(harness.PKG / "metrics", pkg / "metrics")
        (pkg / "metrics" / "mfu.edit.py").write_text(
            "import repro  # noqa: F401\n\n\ndef read(ctx):\n"
            "    return 1.0\n")
    else:
        ref = cell.model.closed_reference

        def loads_repro(*a, f=ref):
            import repro  # noqa: F401
            return f(*a)

        monkeypatch.setattr(cell.model, "closed_reference", loads_repro)
    try:
        with pytest.raises(ImportError, match="before the result"):
            harness.run_cell(ROOT, name, 3, 0.2, where == "metric",
                             device="cpu", t_start=time.perf_counter(),
                             pkg=pkg, cell=cell, log=lambda m: None)
        assert "repro" in sys.modules
    finally:
        sys.modules.pop("repro", None)


def test_no_card_no_result(tmp_path):
    """Without CUDA the command exits non-zero and prints no result."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    p = subprocess.run([sys.executable, "inrbench/run.py", "--workload",
                        "siren-256x3.edit-o2", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr
