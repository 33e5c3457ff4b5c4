"""The two ways a cell offers work, each with its set-up, its measured
window and the check that follows the window.

* ``closed``: one client sends a request (a shifted pixel grid) and waits
  for its outputs before sending the next.
* ``fit``: back-to-back optimizer steps of one training object.

A window runs whole requests (steps) until ``seconds`` have passed and
ends when the last one completes; every rate is over all of its work and
all of its time.  What the check compares is kept from the window itself:
a seeded sample of the closed loop's requests, and the first steps of the training object, which set-up took
through the same call the window uses.
"""

from __future__ import annotations

import math
import random
import time
from dataclasses import dataclass, field

import torch

from inrbench import stats, traffic as gen


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def inputs_made(device) -> None:
    """The benchmark's own inputs are made: the peak from here on is the
    program's."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)


@dataclass
class Window:
    attempted: int = 0
    failed: int = 0
    rows: int = 0                  # rows whose outputs completed
    calls: int = 0                 # calls into the program
    window_s: float = 0.0
    e2e: dict = field(default_factory=dict)      # end-to-end values
    work: dict | None = None       # the window's model work (counts)


def _scaled_errs(outs, refs) -> list[tuple[float, float]]:
    """Per output: (max |out - ref|, max |ref|); a missing, misshapen or
    non-finite output gives an infinite difference."""
    if outs is None or len(outs) != len(refs):
        return [(math.inf, 1.0)]
    errs = []
    for o, r in zip(outs, refs):
        if tuple(o.shape) != tuple(r.shape):
            errs.append((math.inf, 1.0))
            continue
        d = (o.double() - r).abs()
        errs.append((float(d.max()) if torch.isfinite(d).all()
                     else math.inf, float(r.abs().max())))
    return errs


def worst_scaled(pairs) -> float:
    """The widest gap, each output's over its largest reference value."""
    by_out: dict[int, list[float]] = {}
    for i, (d, m) in pairs:
        acc = by_out.setdefault(i, [0.0, 0.0])
        acc[0], acc[1] = max(acc[0], d), max(acc[1], m)
    return max((d / m if m > 0 else (0.0 if d == 0 else math.inf))
               for d, m in by_out.values())


def _blocked_errs(ref_fn, coords, outs, block: int) -> list:
    """``(output index, (max diff, max ref))`` over ``coords`` in blocks."""
    pairs = []
    for s in range(0, coords.shape[0], block):
        refs = ref_fn(coords[s:s + block])
        part = None if outs is None else [o[s:s + block] for o in outs]
        pairs += list(enumerate(_scaled_errs(part, refs)))
    return pairs


class Reservoir:
    """A uniform sample of ``k`` items of a stream, drawn from ``seed``."""

    def __init__(self, k: int, seed: int):
        self.k, self.rnd, self.items, self.seen = k, random.Random(seed), \
            [], 0

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self.rnd.randrange(self.seen + 1)
            if j < self.k:
                self.items[j] = item
        self.seen += 1


# -- closed loop ------------------------------------------------------------

class Closed:
    def __init__(self, ctx):
        self.ctx = ctx
        c, t, dev = ctx.config, ctx.traffic, ctx.device
        h, w = t["grid"]
        self.base = gen.grid(h, w, dev)
        self.shifts = gen.subpixel_shifts(ctx.seed, t["max_requests"], h, w,
                                          dev)
        g = gen.generator(ctx.seed, dev)
        self.params = ctx.model.weights(c, g, dev)[0]
        inputs_made(dev)
        ctx.mark("inputs")
        cls = (ctx.model.ClosedControl if ctx.control
               else ctx.model.ClosedProgram)
        self.program = cls(c, t, self.params, dev)
        ctx.mark("compile")
        self.keep = Reservoir(t["check_requests"], ctx.seed)

    def warm(self) -> None:
        for i in range(self.ctx.traffic["warm_requests"]):
            self.program.serve(self.base + self.shifts[-1 - i])
        sync(self.ctx.device)

    def window(self, seconds: float) -> Window:
        ctx, spans = self.ctx, self.ctx.spans
        n = self.base.shape[0]
        res = Window()
        t0 = time.perf_counter()
        with spans("bench.window"):
            while True:
                if res.attempted >= self.shifts.shape[0] - \
                        ctx.traffic["warm_requests"]:
                    raise RuntimeError("max_requests too small for the "
                                       "window")
                coords = self.base + self.shifts[res.attempted]
                with spans("bench.request"):
                    outs = self.program.serve(coords)
                with spans("bench.sync"):
                    sync(ctx.device)
                res.attempted += 1
                res.calls += 1
                res.rows += n
                self.keep.offer((coords, outs))
                if time.perf_counter() - t0 >= seconds:
                    break
        res.window_s = time.perf_counter() - t0
        res.e2e["rows_per_s"] = res.rows / res.window_s
        per_row = ctx.config["work"]["serve"][str(ctx.traffic["order"])]
        res.work = stats.scale_work(per_row, res.rows, res.calls)
        return res

    def release(self) -> None:
        self.program = None

    def check(self) -> dict:
        ctx = self.ctx
        pairs = []
        for coords, outs in self.keep.items:
            pairs += _blocked_errs(
                lambda x: ctx.model.closed_reference(ctx.config, ctx.traffic,
                                                     self.params, x),
                coords, outs, ctx.traffic["check_block"])
        return {"max_scaled_err": worst_scaled(pairs)}


# -- fit --------------------------------------------------------------------

class Fit:
    def __init__(self, ctx):
        self.ctx = ctx
        c, t, dev = ctx.config, ctx.traffic, ctx.device
        h, w = t["grid"]
        self.coords = gen.grid(h, w, dev)
        g = gen.generator(ctx.seed, dev)
        teacher, self.p0 = ctx.model.weights(c, g, dev, 2)
        self.target = ctx.model.fit_target(c, teacher, self.coords)
        inputs_made(dev)
        ctx.mark("inputs")
        cls = ctx.model.FitControl if ctx.control else ctx.model.FitProgram
        self.program = cls(c, t, self.p0, self.coords, self.target, dev)
        ctx.mark("compile")
        self.setup_losses: list[float] = []

    def warm(self) -> None:
        """The first steps, through the window's own call; what the check
        reads of them is copied as they pass."""
        from inrbench.reference import fit as ref_fit
        self.leaves0 = [v.detach().clone() for v in ref_fit.flat(self.p0)]
        for i in range(self.ctx.traffic["setup_steps"]):
            with self.ctx.spans("bench.fit_call"):
                self.setup_losses.append(self.program.step())
            if i == 0:
                self.mu1 = self.program.first_moments()
        self.leaves3 = self.program.leaves_now()
        sync(self.ctx.device)

    def window(self, seconds: float) -> Window:
        ctx, spans = self.ctx, self.ctx.spans
        n = self.coords.shape[0]
        res = Window()
        t0 = time.perf_counter()
        steps = []
        with spans("bench.window"):
            while True:
                t1 = time.perf_counter()
                with spans("bench.fit_call"):
                    loss = self.program.step()
                steps.append(time.perf_counter() - t1)
                res.attempted += 1
                res.calls += 1
                if not math.isfinite(loss):
                    res.failed += 1
                else:
                    res.rows += n
                if time.perf_counter() - t0 >= seconds:
                    break
        res.window_s = time.perf_counter() - t0
        res.e2e["fit_rows_per_s"] = res.rows / res.window_s
        ctx.log(f"[inrbench] step s: min {min(steps):.6f}, median "
                f"{sorted(steps)[len(steps) // 2]:.6f}, max {max(steps):.6f}")
        per_row = ctx.config["work"]["fit"][str(ctx.traffic["order"])]
        res.work = stats.scale_work(per_row, res.rows, res.calls)
        return res

    def release(self) -> None:
        self.program = None

    def check(self) -> dict:
        """Gaps against the float64 reference over the first three steps:
        the first step's loss, the first gradient by leaf as the optimizer
        took it (AdamW's first moment over ``1 - b1``), and each leaf's
        change over the three steps, leaves whose reference gradient is
        under a thousandth of the median leaf's left out of the change.
        The later steps' losses are logged, not compared: AdamW's first
        step moves every weight by the rate whatever its gradient's size,
        so a gradient that rounding turns round moves the later losses by
        up to 4e-5 on some seeds (see PERF.md)."""
        ctx = self.ctx
        steps = ctx.traffic["setup_steps"]
        want = ctx.model.fit_reference(ctx.config, ctx.traffic, self.p0,
                                       self.coords, self.target, steps)
        b1 = ctx.traffic["adamw"]["b1"]
        gaps = [abs(a - b) / abs(b) if b else math.inf
                for a, b in zip(self.setup_losses, want["losses"])]
        ctx.log(f"[inrbench] loss gap by step {gaps}")
        g_ref = [float(g.norm()) for g in want["grad1"]]
        g_got = [float((m / (1 - b1)).double().norm()) for m in self.mu1]
        med = sorted(g_ref)[len(g_ref) // 2]
        grad_gap = max(abs(a - b) / max(b, med)
                       for a, b in zip(g_got, g_ref))
        d_ref = [float((a - b.double()).norm())
                 for a, b in zip(want["leaves"], self.leaves0)]
        d_got = [float((a.double() - b.double()).norm())
                 for a, b in zip(self.leaves3, self.leaves0)]
        keep = [i for i, g in enumerate(g_ref) if g >= 1e-3 * med]
        dmed = sorted(d_ref[i] for i in keep)[len(keep) // 2]
        change_gap = max(abs(d_got[i] - d_ref[i]) / max(d_ref[i], dmed)
                         for i in keep)
        return {"loss1_gap": gaps[0], "grad1_gap": grad_gap,
                "change3_gap": change_gap}


LOOPS = {"closed": Closed, "fit": Fit}
