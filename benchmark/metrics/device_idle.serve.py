"""The share of the traced slice's wall time in which no operation ran on
the card: 1 minus the union of the device operations' intervals."""

from benchmark.metrics._shares import idle


def read(run):
    return idle(run)
