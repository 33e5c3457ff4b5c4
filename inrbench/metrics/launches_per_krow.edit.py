"""Kernel launches per 1,000 served rows over the window (serving loop and executor; program counter kernels.common.LAUNCHES)."""

from inrbench.readers import launches_per_krow as read  # noqa: F401
