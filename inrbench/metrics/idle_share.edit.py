"""Share of the traced window with no kernel or copy on the card, in %."""

from inrbench.readers import idle_share as read  # noqa: F401
