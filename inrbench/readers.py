"""Shared arithmetic of the per-layer metric readers (``metrics/*.py``).
Each returns None where the run holds nothing to read; a share of a peak
or a roofline is never made up as 0."""

from __future__ import annotations


def launches_per_krow(ctx):
    rows = ctx.window.rows
    if not rows or not ctx.launches:
        return None
    return sum(ctx.launches.values()) / (rows / 1000.0)


def kernel_roofline(ctx):
    """Least time of the window's model work over the summed device time
    of its kernels, in %."""
    t = ctx.trace
    if t is None or ctx.least_s is None or not t.kernel_s:
        return None
    return 100.0 * ctx.least_s / t.kernel_s


def mfu(ctx):
    """Least time of the window's model work over the traced window, in %."""
    t = ctx.trace
    if t is None or ctx.least_s is None or not t.window_s:
        return None
    return 100.0 * ctx.least_s / t.window_s


def idle_share(ctx):
    """Share of the traced window in which no kernel or copy ran, in %."""
    t = ctx.trace
    return None if t is None or not t.window_s else 100.0 * t.idle_share
