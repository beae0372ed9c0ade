"""Share of the traced window in which no operation ran on the device."""

from bench.core.trace import idle_share


def read(t):
    return idle_share(t)
