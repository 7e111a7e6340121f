"""``linear_attention_fwd.cu``'s share of its roofline: the frozen
``la_bound`` (forward) at each site's (2B, N, C) for every traced sampler
step over the device time of the kernels named ``lin_attn_fwd``."""

from benchmark.metrics._shares import attention_roofline


def read(run):
    return attention_roofline(run, "lin_attn_fwd", backward=False)
