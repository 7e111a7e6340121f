"""``linear_attention_bwd.cu``'s share of its roofline: the frozen
``la_bound`` (backward) of every site of every traced step over the device
time of the kernels named ``lin_attn_bwd`` in the slice."""

from benchmark.metrics._shares import attention_roofline


def read(run):
    return attention_roofline(run, "lin_attn_bwd", backward=True)
