"""Perf probes of the port's kernels on the card (counterparts of the JAX
package's ``perf/probe*.py``), each run as ``python -m
ldm_tpu_torch.perf.<probe>``; importing one runs nothing."""
