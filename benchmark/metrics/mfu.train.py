"""The whole window's products (the plain reference's count, ``yardsticks``)
over its host-clock seconds, as a share of the card's bf16 peak."""

from benchmark.metrics._shares import mfu


def read(run):
    return mfu(run)
