"""The kernels' share of their roofline: least time of the window's fit work over summed kernel time, in %."""

from inrbench.readers import kernel_roofline as read  # noqa: F401
