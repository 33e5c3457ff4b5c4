"""The port's own copy of ``repro.distributed.fault_tolerance`` (the port
imports nothing of the JAX package); keep the two in step.  Pure Python;
the checks the reference asserts raise ``RuntimeError`` / ``ValueError``.

Fault tolerance: step watchdog, straggler mitigation, elastic re-meshing.

At thousand-node scale the framework must (a) notice that a step is slow or
a host is gone, (b) decide what to do, and (c) restart from the last
checkpoint on whatever healthy topology remains.  This module implements the
control-plane logic; the data plane (checkpoint resharding, deterministic
data replay) lives in checkpoint/ and data/.
"""

from __future__ import annotations

import statistics
import time
from dataclasses import dataclass, field


@dataclass
class StragglerEvent:
    step: int
    duration: float
    median: float
    ratio: float


class StepWatchdog:
    """Tracks step durations; flags stragglers and hangs.

    * straggler: step > `straggler_ratio` x rolling median -> recorded, and
      after `demote_after` consecutive flags the watchdog recommends
      excluding the slow host (advisory `plan()`).
    * hang: `check_hang()` returns True if the current step has been running
      longer than `hang_timeout` x median — callers should checkpoint-restart.
    """

    def __init__(self, straggler_ratio: float = 2.0, window: int = 16,
                 demote_after: int = 3, hang_timeout: float = 10.0):
        self.ratio = straggler_ratio
        self.window = window
        self.demote_after = demote_after
        self.hang_timeout = hang_timeout
        self.durations: list[float] = []
        self.events: list[StragglerEvent] = []
        self._consecutive = 0
        self._started: float | None = None
        self._step = 0

    def start_step(self, step: int):
        self._step = step
        self._started = time.monotonic()

    def end_step(self) -> StragglerEvent | None:
        if self._started is None:
            raise RuntimeError("end_step() without start_step()")
        dur = time.monotonic() - self._started
        self._started = None
        med = (statistics.median(self.durations[-self.window:])
               if self.durations else dur)
        self.durations.append(dur)
        if self.durations and dur > self.ratio * med and len(self.durations) > 3:
            ev = StragglerEvent(self._step, dur, med, dur / med)
            self.events.append(ev)
            self._consecutive += 1
            return ev
        self._consecutive = 0
        return None

    def check_hang(self) -> bool:
        if self._started is None or len(self.durations) < 3:
            return False
        med = statistics.median(self.durations[-self.window:])
        return (time.monotonic() - self._started) > self.hang_timeout * med

    def should_remesh(self) -> bool:
        return self._consecutive >= self.demote_after

    def plan(self, n_hosts: int) -> dict:
        """Advisory elastic plan: drop the slowest host, shrink the data axis."""
        return {
            "action": "remesh" if self.should_remesh() else "continue",
            "healthy_hosts": n_hosts - (1 if self.should_remesh() else 0),
            "events": len(self.events),
        }


def elastic_data_axis(n_devices: int, model_axis: int) -> int:
    """Largest data-parallel axis that fits the surviving devices (the model
    axis is preserved; data/pod shrink)."""
    if n_devices < model_axis:
        raise ValueError(f"{n_devices} devices cannot hold a model axis of "
                         f"{model_axis}")
    return n_devices // model_axis


@dataclass
class RestartLog:
    """Bookkeeping for checkpoint-restart cycles (tested in integration)."""
    restarts: list[dict] = field(default_factory=list)

    def record(self, *, step: int, reason: str, old_devices: int,
               new_devices: int):
        self.restarts.append({"step": step, "reason": reason,
                              "old": old_devices, "new": new_devices,
                              "t": time.time()})
