"""``fused_adam_ema.cu``'s share of its roofline: 36 bytes a parameter at
3.35 TB/s for every traced step over the device time of the kernel named
``fused_adam_ema``."""

from benchmark.metrics._shares import adam_ema_roofline


def read(run):
    return adam_ema_roofline(run)
