"""Whole requests' share of the card's peak: least time of the window's served work over the traced window, in %."""

from inrbench.readers import mfu as read  # noqa: F401
