"""The whole window's products (the plain reference's count over the
text-to-image cell's U-Net steps and decodes, ``yardsticks_sd``) over its
host-clock seconds, as a share of the card's bf16 peak."""

from benchmark.metrics._shares import mfu


def read(run):
    return mfu(run)
