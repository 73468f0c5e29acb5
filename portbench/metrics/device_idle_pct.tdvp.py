"""Share of the traced window of TDVP steps in which no device operation ran."""

from harness.readers import idle_pct


def read(probe):
    return idle_pct(probe)
