"""Whole steps' share of the card's peak: least time of the window's fit work over the traced window, in %."""

from inrbench.readers import mfu as read  # noqa: F401
