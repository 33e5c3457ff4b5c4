"""Kernel launches per 1,000 supervision rows over the window (fit compiler; program counter kernels.common.LAUNCHES)."""

from inrbench.readers import launches_per_krow as read  # noqa: F401
