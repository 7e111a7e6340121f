"""The softmax attention's share of its roofline in the traced batch: the
frozen bound of every self- and cross-attention site of the U-Net
(``yardsticks_sd.attention_bound_s`` at the fused 2B) for every traced
sampler step, over the device time of the attention kernels, whose names
hold one of :data:`KERNELS` (PyTorch's flash kernels and cuDNN's fused
attention).  None where the run set no sites or the trace holds no such
kernel."""

from benchmark.yardsticks_sd import sites_bound_s

KERNELS = ("flash_fwd", "fmha", "_sdpa_")


def read(run):
    tr = run.trace
    sites = getattr(run, "sdpa_sites", None)
    if tr is None or not sites:
        return None
    seconds = tr.seconds(*KERNELS)
    if seconds <= 0:
        return None
    return 100.0 * tr.units * sites_bound_s(run.sdpa_batch, sites) / seconds
