"""The port's own copy of ``repro.obs.log`` (the port imports nothing of the
JAX package); keep the two in step.

Level-controlled structured logger for launch-path telemetry.

Messages carry a component tag and key=value fields::

    log = get_logger("train")
    log.info("step", step=i, loss=float(loss))
    # -> [train] step step=120 loss=0.0031

Levels: debug < info < warn < error.  The default level is "info",
except under pytest (detected via ``PYTEST_CURRENT_TEST``) where it is
"error" — launch helpers called from tests stay quiet.  The
``REPRO_LOG_LEVEL`` environment variable overrides both (including
forcing output back on under pytest), and ``set_level()`` overrides
everything at runtime.
"""

from __future__ import annotations

import os
import sys

LEVELS = {"debug": 10, "info": 20, "warn": 30, "error": 40, "off": 100}

_forced_level: str | None = None


def _default_level() -> str:
    env = os.environ.get("REPRO_LOG_LEVEL", "").strip().lower()
    if env in LEVELS:
        return env
    if "PYTEST_CURRENT_TEST" in os.environ:
        return "error"
    return "info"


def set_level(level: str | None) -> None:
    """Force a level for the whole process; ``None`` restores defaults."""
    global _forced_level
    if level is not None and level not in LEVELS:
        raise ValueError(f"unknown log level {level!r}; "
                         f"one of {sorted(LEVELS)}")
    _forced_level = level


def current_level() -> str:
    return _forced_level if _forced_level is not None else _default_level()


def _fmt_value(v) -> str:
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)


class Logger:
    """One per component; cheap enough to create at call sites."""

    __slots__ = ("component",)

    def __init__(self, component: str):
        self.component = component

    def enabled_for(self, level: str) -> bool:
        return LEVELS[level] >= LEVELS[current_level()]

    def _emit(self, level: str, msg: str, fields: dict) -> None:
        if not self.enabled_for(level):
            return
        parts = [f"[{self.component}]", msg]
        parts += [f"{k}={_fmt_value(v)}" for k, v in fields.items()]
        stream = sys.stderr if LEVELS[level] >= LEVELS["warn"] else sys.stdout
        print(" ".join(parts), file=stream, flush=True)

    def debug(self, msg: str, **fields) -> None:
        self._emit("debug", msg, fields)

    def info(self, msg: str, **fields) -> None:
        self._emit("info", msg, fields)

    def warn(self, msg: str, **fields) -> None:
        self._emit("warn", msg, fields)

    def error(self, msg: str, **fields) -> None:
        self._emit("error", msg, fields)


def get_logger(component: str) -> Logger:
    return Logger(component)
