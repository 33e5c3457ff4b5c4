"""What decides ``correct``: the control (the plain reference in the
program's place, in TF32) and planted faults must each come out not
correct; the program must come out correct.  Runs the rest of a run on
the CPU at a small size (TF32 emulated), skipping the look for a card.

The control at each cell's own size runs on the card:
``python3 inrbench/control.py --workload <cell> --side control --seeds
...`` (see PERF.md for its readings); ``test_control_at_cell_size`` does
one seed of it where there is a card."""

from __future__ import annotations

import time

import pytest
import torch

from conftest import ROOT, run_small, small_cell

SERVED = ["siren-256x3.edit-o2", "insp-bank4.edit-o2"]
ALL = SERVED + ["siren-256x3.fit-lap"]


@pytest.mark.parametrize("name", ALL)
def test_program_is_correct(name):
    out = run_small(name)
    assert out["result"]["correct"] is True, out["checks"]


@pytest.mark.parametrize("name", ALL)
def test_control_is_not_correct(name):
    out = run_small(name, control=True)
    assert out["result"]["correct"] is False, out["checks"]


def _altered(outs):
    """One answer changed where it is produced."""
    outs = [o.clone() for o in outs]
    outs[-1].view(-1)[outs[-1].numel() // 2] += 1e-2 * float(
        outs[-1].abs().max())
    return tuple(outs)


def test_closed_answer_altered(monkeypatch):
    for name in SERVED:
        cell = small_cell(name)
        serve = cell.model.ClosedProgram.serve
        monkeypatch.setattr(cell.model.ClosedProgram, "serve",
                            lambda self, x, f=serve: _altered(f(self, x)))
        out = run_small(name, cell=cell)
        assert out["result"]["correct"] is False


def test_fit_state_unchanged(monkeypatch):
    cell = small_cell("siren-256x3.fit-lap")
    step = cell.model.FitProgram.step

    def unchanged(self, f=step):
        leaves, opt, i = self.leaves, self.opt, self.i
        loss = f(self)
        self.leaves, self.opt, self.i = leaves, opt, i
        return loss

    monkeypatch.setattr(cell.model.FitProgram, "step", unchanged)
    out = run_small(cell.name, cell=cell)
    assert out["result"]["correct"] is False
    assert out["checks"]["change3_gap"][0] == pytest.approx(1.0)


def test_fit_half_the_batch(monkeypatch):
    from inrbench.control import plant_half_batch
    cell = small_cell("siren-256x3.fit-lap")
    monkeypatch.setattr(cell.model.FitProgram, "step",
                        cell.model.FitProgram.step)
    plant_half_batch(cell.model.FitProgram)
    out = run_small(cell.name, cell=cell)
    assert out["result"]["correct"] is False


@pytest.mark.parametrize("name", ALL)
def test_control_at_cell_size(name, cuda_card):
    from inrbench import harness
    out = harness.run_cell(ROOT, name, 2**31 + 11, 2.0, False,
                           device=cuda_card, control=True,
                           t_start=time.perf_counter(),
                           log=lambda m: None)
    assert out["result"]["correct"] is False
    assert torch.cuda.is_available()
