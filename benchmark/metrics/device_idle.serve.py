"""Share (%) of the traced window with no kernel, copy or set on the card
(``--trace 1``'s window of the serving loop)."""

from harness.readers import idle_percent


def read(rec):
    return idle_percent(rec)
